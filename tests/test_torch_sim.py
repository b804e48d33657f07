"""Port vs JAX package and upstream goldens: the per-restart unitary, the
batch-last unitary, the HS-test loss and the gradient of the regularized
objective (cpflow_tpu_torch.sim against cpflow_tpu.sim)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu.api import LossSpec as JLossSpec
from cpflow_tpu.ops.penalty import cp_penalty_linear as j_penalty
from cpflow_tpu.sim import ansatz_kernel as jak
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch.api import LossSpec
from cpflow_tpu_torch.ops.gates import multi_controlled_x, u_ccz3
from cpflow_tpu_torch.ops.penalty import LinearPenalty
from cpflow_tpu_torch.sim import ansatz_kernel as tak
from cpflow_tpu_torch.sim import batched as tbt
from cpflow_tpu_torch.sim.apply import inverse_leg_permutation
from cpflow_tpu_torch.topology import chain_layer, connected_layer, fill_layers

torch.set_num_threads(1)

PEN = (np.pi / 2, 2.0, 0.05, 0.05, 0.05)
GOLDEN = np.load(os.path.join(os.path.dirname(__file__), 'golden',
                              'reference_goldens.npz'))
GOLDEN_CONFIGS = [
    ('3q_chain_cp_xyz_k4', 3, chain_layer(3), 'cp', 'xyz', 4),
    ('3q_conn_cp_xz_k5', 3, connected_layer(3), 'cp', 'xz', 5),
    ('4q_chain_cz_xyz_k6', 4, chain_layer(4), 'cz', 'xyz', 6),
    ('5q_chain_cp_xyz_k8', 5, chain_layer(5), 'cp', 'xyz', 8),
]
# (n, layer, rotations, k, target): 3q chain xyz k=12 has complete layers
# only in part (12 = 6 x 2); 4q connected xz k=7 has a free block
BATCHED_CONFIGS = [
    (3, chain_layer(3), 'xyz', 12, u_ccz3),
    (4, connected_layer(4), 'xz', 7, multi_controlled_x(4)),
]


def _num_angles(n, ent, rot, k):
    return 3 * n + tak.num_block_angles(ent, rot) * k


def _cp_mask(n, rot, k):
    nba = tak.num_block_angles('cp', rot)
    m = np.zeros(_num_angles(n, 'cp', rot, k), dtype=np.float32)
    m[tak.cp_angle_indices(n, nba, k)] = 1
    return m


@pytest.mark.parametrize('n,layer,ent,rot,k', [
    (3, chain_layer(3), 'cp', 'xyz', 5),
    (4, connected_layer(4), 'cp', 'xz', 7),
    (3, chain_layer(3), 'cz', 'xyz', 4),
])
def test_build_unitary_matches_jax(n, layer, ent, rot, k):
    placements = fill_layers(layer, k)
    a = np.random.default_rng(k).uniform(
        -np.pi, 3 * np.pi, _num_angles(n, ent, rot, k)).astype(np.float32)
    ours = tak.build_unitary(n, ent, rot, placements, torch.tensor(a))
    ref = jax.jit(lambda x: jak.build_unitary(
        n, ent, rot, placements, x))(jnp.asarray(a))
    # atol 1e-5: float32 chains of ~k 4x4 products in both packages
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize('tag,n,layer,ent,rot,k', GOLDEN_CONFIGS)
def test_unitaries_match_upstream_goldens(tag, n, layer, ent, rot, k):
    angles = GOLDEN[f'{tag}/angles']
    ref_u = GOLDEN[f'{tag}/unitary']
    placements = fill_layers(layer, k)
    ours = tak.build_unitary(n, ent, rot, placements, torch.tensor(angles))
    np.testing.assert_allclose(ours.numpy().reshape(ref_u.shape), ref_u,
                               atol=2e-5)
    ub = tbt.build_unitary_batched(n, ent, rot, placements,
                                   torch.tensor(angles)[:, None])
    np.testing.assert_allclose(ub[..., 0].numpy().reshape(ref_u.shape),
                               ref_u, atol=2e-5)


@pytest.mark.parametrize('n,layer,rot,k,target', BATCHED_CONFIGS)
def test_batched_unitary_and_hst_match_jax(n, layer, rot, k, target):
    placements = fill_layers(layer, k)
    a = np.random.default_rng(n).uniform(
        0, 2 * np.pi, (_num_angles(n, 'cp', rot, k), 5)).astype(np.float32)
    u = tbt.build_unitary_batched(n, 'cp', rot, placements, torch.tensor(a))
    ju = jax.jit(lambda x: jbt.build_unitary_batched(
        n, 'cp', rot, placements, x))(jnp.asarray(a))
    assert tuple(u.shape) == tuple(ju.shape) == (2,) * n + (2 ** n, 5)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-5)
    np.testing.assert_allclose(tbt.batched_cost_hst(u, target).numpy(),
                               np.asarray(jbt.batched_cost_hst(ju, target)),
                               atol=1e-6)


@pytest.mark.parametrize('n,layer,rot,k,target', [
    BATCHED_CONFIGS[0], (4, chain_layer(4), 'xz', 4, multi_controlled_x(4))])
def test_regloss_gradient_matches_jax(n, layer, rot, k, target):
    """Torch autograd through the batch-last builder against jax.grad of
    the JAX package's reversible (hand-written backward) objective."""
    placements = fill_layers(layer, k)
    cp_mask = _cp_mask(n, rot, k)
    r = 0.002
    a = np.random.default_rng(10 + n).uniform(
        0, 2 * np.pi, (len(cp_mask), 6)).astype(np.float32)
    obj = tbt.make_batched_regloss(
        n, 'cp', rot, placements, LossSpec('hst', target=target),
        cp_mask=cp_mask, regularization_func=LinearPenalty(*PEN), r=r)
    t = torch.tensor(a, requires_grad=True)
    regloss, loss = obj(t)
    regloss.sum().backward()

    jf = jbt.make_batched_regloss(
        n, 'cp', rot, placements, JLossSpec('hst', target=target),
        cp_mask=jnp.asarray(cp_mask),
        regularization_func=lambda v: j_penalty(v, *PEN), r=r,
        reversible=True)
    (_, (jreg, jloss)), jgrad = jax.jit(jax.value_and_grad(
        lambda p: (jf(p)[0].sum(), jf(p)), has_aux=True))(jnp.asarray(a))
    np.testing.assert_allclose(regloss.detach().numpy(), np.asarray(jreg),
                               atol=1e-6)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), atol=1e-5)


def test_split_angles_and_block_matrix_match_jax():
    n, nba, k = 3, 7, 5
    a = np.random.default_rng(5).uniform(0, 2 * np.pi, 3 * n + nba * k) \
        .astype(np.float32)
    ours = tak.split_angles(torch.tensor(a), n, nba, 2, 2)
    ref = jak.split_angles(jnp.asarray(a), n, nba, 2, 2)
    for key in ('surface angles', 'block angles', 'layers angles',
                'free block angles'):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]))
    assert tak.cp_angle_indices(n, nba, k) == jak.cp_angle_indices(n, nba, k)
    for ent, rot in [('cp', 'xyz'), ('cz', 'xy'), ('cx', 'z')]:
        m = tak.num_block_angles(ent, rot)
        assert m == jak.num_block_angles(ent, rot)
        np.testing.assert_allclose(
            tak.block_matrix(ent, rot, torch.tensor(a[:m])).numpy(),
            np.asarray(jak.block_matrix(ent, rot, jnp.asarray(a[:m]))),
            atol=1e-6)


def test_angles_carry_between_packages():
    from cpflow_tpu import api as japi
    from cpflow_tpu_torch import api as tapi
    from cpflow_tpu_torch.params import angles_from_jax, angles_to_jax
    placements = fill_layers(chain_layer(3), 5)
    janz = japi.Ansatz(3, 'cp', placements)
    a = np.random.default_rng(6).uniform(0, 6, (4, janz.num_angles)) \
        .astype(np.float32)
    t = angles_from_jax(a, janz, 'cpu')
    assert t.shape == (janz.num_angles, 4) and t.dtype == torch.float32
    np.testing.assert_array_equal(angles_to_jax(t), a)
    # the port's ansatz renders the same unitary from the carried angles
    tanz = tapi.Ansatz(3, 'cp', fill_layers(chain_layer(3), 5))
    np.testing.assert_allclose(
        tanz.unitary(t[:, 0]).numpy(),
        np.asarray(jax.jit(janz.unitary)(jnp.asarray(a[0]))), atol=1e-5)
    with pytest.raises(ValueError):
        angles_from_jax(a[:, :-1], janz, 'cpu')


def test_inverse_leg_permutation_examples():
    """The examples of tests/test_sim.py (the reference's layout-restoring
    permutations, circuit_assembly.py:16-19)."""
    assert inverse_leg_permutation(6, [1, 3]) == [2, 0, 3, 1, 4, 5]
    assert inverse_leg_permutation(6, [3, 1]) == [2, 1, 3, 0, 4, 5]


def test_inverse_leg_permutation_matches_jax_on_random_placements():
    """Placements drawn by both packages from the same keys (ops/prng.py),
    the inverse permutations equal; apply_gate_to_tensor restores the leg
    layout with it, as the JAX package does."""
    from cpflow_tpu.sim.apply import apply_gate_to_tensor as j_apply
    from cpflow_tpu.sim.apply import inverse_leg_permutation as j_inverse
    from cpflow_tpu_torch.ops import prng
    from cpflow_tpu_torch.sim.apply import apply_gate_to_tensor
    from cpflow_tpu_torch.topology import random_placements
    rng = np.random.default_rng(4)
    for n in (2, 3, 5, 7):
        for p in random_placements(n, 6, key=prng.PRNGKey(n, 'cpu')):
            assert inverse_leg_permutation(n, p) == j_inverse(n, p)
        p = random_placements(n, 1, key=prng.PRNGKey(n, 'cpu'))[0]
        gate = (rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
                ).astype(np.complex64)
        tensor = (rng.normal(size=(2,) * (2 * n)) + 1j *
                  rng.normal(size=(2,) * (2 * n))).astype(np.complex64)
        ours = apply_gate_to_tensor(torch.as_tensor(gate),
                                    torch.as_tensor(tensor), p)
        ref = np.asarray(j_apply(jnp.asarray(gate), jnp.asarray(tensor), p))
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)

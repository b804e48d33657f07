"""The port against upstream cpflow's recorded outputs, with no JAX:
tests/golden/reference_goldens.npz holds what the reference implementation
computed (tests/golden/make_goldens.py), and tests/test_golden_reference.py
holds the JAX package to it. This file holds the port to the same record
through its own functions: the initial angles of four seeded draws bit for
bit (ops/prng.py), the HS-test and disc losses of the recorded unitaries,
and 60 Adam steps from a recorded start, through the engine's chain on the
CPU and through the sweep kernel on the card."""

import os

import numpy as np
import pytest
import torch

from cpflow_tpu_torch.ops import losses, prng
from cpflow_tpu_torch.optimize import engine
from cpflow_tpu_torch.optimize.candidates import random_cp_angles
from cpflow_tpu_torch.sim.ansatz_kernel import (build_unitary,
                                                cp_angle_indices,
                                                num_block_angles)
from cpflow_tpu_torch.topology import chain_layer, connected_layer, fill_layers

torch.set_num_threads(1)

_PATH = os.path.join(os.path.dirname(__file__), 'golden',
                     'reference_goldens.npz')
G = np.load(_PATH)

CONFIGS = [
    ('3q_chain_cp_xyz_k4', 3, chain_layer(3), 'cp', 'xyz', 4, 7),
    ('3q_conn_cp_xz_k5', 3, connected_layer(3), 'cp', 'xz', 5, 11),
    ('4q_chain_cz_xyz_k6', 4, chain_layer(4), 'cz', 'xyz', 6, 3),
    ('5q_chain_cp_xyz_k8', 5, chain_layer(5), 'cp', 'xyz', 8, 42),
]

ADAM_STEPS, ADAM_LR = 60, 0.1


def _cp_mask(tag, n, ent, rot, k):
    mask = np.zeros(len(G[f'{tag}/angles']), dtype=np.float32)
    if ent == 'cp':
        mask[cp_angle_indices(n, num_block_angles(ent, rot), k)] = 1
    return mask


@pytest.mark.parametrize('tag,n,layer,ent,rot,k,seed', CONFIGS)
def test_prng_tree_matches_reference(tag, n, layer, ent, rot, k, seed):
    """The same seed gives upstream's initial angles, bit for bit."""
    mask = _cp_mask(tag, n, ent, rot, k)
    ours = random_cp_angles(len(mask), mask, cp_dist='uniform',
                            key=prng.PRNGKey(seed, 'cpu'))
    np.testing.assert_array_equal(ours.numpy(), G[f'{tag}/angles'])


@pytest.mark.parametrize('tag,n,layer,ent,rot,k,seed', CONFIGS)
def test_losses_match_reference(tag, n, layer, ent, rot, k, seed):
    """cost_HST and disc of the recorded unitary against a diagonal target,
    within the JAX test's 1e-5."""
    u = torch.as_tensor(G[f'{tag}/unitary'])
    d = u.shape[0]
    tgt = torch.as_tensor(np.diag(np.exp(1j * np.linspace(0, 1, d)))
                          .astype(np.complex64))
    assert float(losses.cost_HST(u, tgt)) == pytest.approx(
        float(G[f'{tag}/cost_hst']), abs=1e-5)
    assert float(losses.disc(u, tgt)) == pytest.approx(
        float(G[f'{tag}/disc']), abs=1e-5)


def _adam_problem():
    """The recorded Adam run's problem: 3q chain, cp, 'xyz', k=4, HS test
    against the CX on the last two qubits."""
    tag, n, layer, ent, rot, k, _ = CONFIGS[0]
    d = 2 ** n
    tgt = np.eye(d, dtype=np.complex64)
    tgt[d - 2, d - 2] = tgt[d - 1, d - 1] = 0
    tgt[d - 2, d - 1] = tgt[d - 1, d - 2] = 1
    return n, ent, rot, fill_layers(layer, k), tgt


def test_adam_trajectory_matches_reference():
    """60 Adam steps of engine.adam_chain from the recorded start: the loss
    history within 5e-4 and the final parameters within 5e-3, as the JAX
    test holds the JAX package."""
    n, ent, rot, placements, tgt = _adam_problem()
    d = 2 ** n
    target = torch.as_tensor(tgt)

    def loss_and_grad(a):
        a = a.detach().requires_grad_(True)
        u = build_unitary(n, ent, rot, placements, a).reshape(d, d)
        loss = losses.cost_HST(u, target)
        grad, = torch.autograd.grad(loss, a)
        return loss.detach(), grad

    init = torch.as_tensor(G['adam/initial'], dtype=torch.float32)
    params_hist, loss_hist = engine.adam_chain(
        loss_and_grad, init, learning_rate=ADAM_LR,
        num_iterations=ADAM_STEPS, keep_history=True)
    np.testing.assert_allclose(loss_hist.numpy(), G['adam/loss_history'],
                               atol=5e-4)
    np.testing.assert_allclose(params_hist[-1].numpy(),
                               G['adam/final_params'], atol=5e-3)


@pytest.mark.cuda
def test_sweep_kernel_adam_matches_reference():
    """The same start through the fused sweep kernel (B=1, r=0): its best
    loss within 5e-4 of the recorded history's minimum, and where that
    minimum is the history's last entry, its best angles within 5e-3 of
    the recorded final parameters."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the sweep kernel has no CPU mode)')
    from cpflow_tpu_torch.api import LossSpec
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.sim.batched import make_batched_regloss
    n, ent, rot, placements, tgt = _adam_problem()
    objective = make_batched_regloss(n, ent, rot, placements,
                                     LossSpec('hst', target=tgt))
    init = torch.as_tensor(G['adam/initial'], dtype=torch.float32,
                           device='cuda')[:, None]
    launches = sk.LAUNCHES
    res = sk.sweep(objective, init, learning_rate=ADAM_LR,
                   num_iterations=ADAM_STEPS)
    assert sk.LAUNCHES == launches + 1
    history = G['adam/loss_history']
    assert abs(float(res.best_loss[0]) - float(history.min())) <= 5e-4
    if int(history.argmin()) == len(history) - 1:
        np.testing.assert_allclose(res.best_params[:, 0].cpu().numpy(),
                                   G['adam/final_params'], atol=5e-3)

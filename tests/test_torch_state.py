"""The state-preparation objective (LossSpec('state'), target_state=...):
the port's objective, its autograd gradient and its column build against
the JAX package, and Synthesize(..., target_state=...).static on a GHZ-3
chain against the JAX package's pipeline on the same initial angles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import api as japi
from cpflow_tpu.ops import losses as jlosses
from cpflow_tpu.optimize import candidates as jcand
from cpflow_tpu.optimize import engine as jengine
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch.ops import losses as tlosses
from cpflow_tpu_torch.ops.gates import u_ccz3
from cpflow_tpu_torch.ops.penalty import LinearPenalty
from cpflow_tpu_torch.sim import batched as tbt
from cpflow_tpu_torch.topology import chain_layer, fill_layers

torch.set_num_threads(1)

PEN = (np.pi / 2, 2.0, 0.05, 0.05, 0.05)


def ghz(n):
    t = np.zeros(2 ** n, dtype=np.complex64)
    t[0] = t[-1] = 2 ** -0.5
    return t


def _setup(n, k, B, seed):
    anz = tapi.Ansatz(n, 'cp', fill_layers(chain_layer(n), k))
    rng = np.random.default_rng(seed)
    angles = rng.uniform(0, 2 * np.pi, (anz.num_angles, B)).astype(np.float32)
    return anz, angles


@pytest.mark.parametrize('n,k', [(3, 3), (4, 4)])
def test_state_objective_and_gradient_match_jax(n, k):
    anz, angles = _setup(n, k, 9, seed=n)
    spec_t = tapi.LossSpec('state', target=ghz(n))
    spec_j = japi.LossSpec('state', target=ghz(n))
    f_t = tbt.make_batched_regloss(n, 'cp', 'xyz', anz.placements, spec_t,
                                   cp_mask=anz.cp_mask,
                                   regularization_func=LinearPenalty(*PEN),
                                   r=0.001)
    f_j = jbt.make_batched_regloss(
        n, 'cp', 'xyz', anz.placements, spec_j, cp_mask=anz.cp_mask,
        regularization_func=japi.make_regularization_function(
            japi.RegularizationOptions), r=0.001, reversible=True)

    def total(a):
        reg, loss = f_j(a)
        return reg.sum(), (reg, loss)

    (_, (reg_j, loss_j)), g_j = jax.jit(jax.value_and_grad(
        total, has_aux=True))(jnp.asarray(angles))
    a_t = torch.tensor(angles, requires_grad=True)
    reg_t, loss_t = f_t(a_t)
    np.testing.assert_allclose(loss_t.detach().numpy(), np.asarray(loss_j),
                               atol=1e-5)
    np.testing.assert_allclose(reg_t.detach().numpy(), np.asarray(reg_j),
                               atol=1e-5)
    (g_t,) = torch.autograd.grad(reg_t.sum(), a_t)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-4)


def test_column_build_is_column_zero_of_the_full_build():
    anz, angles = _setup(4, 4, 5, seed=1)
    a = torch.tensor(angles)
    full = tbt.build_unitary_batched(4, 'cp', 'xyz', anz.placements, a)
    col = tbt.build_unitary_batched(4, 'cp', 'xyz', anz.placements, a,
                                    columns=[0])
    assert col.shape == (2, 2, 2, 2, 1, 5)
    # float32 rounding only: the column count reorders the einsum's sums
    torch.testing.assert_close(col, full[..., 0:1, :], atol=1e-6, rtol=0)
    # and the JAX package's column build
    jcol = jax.jit(lambda a: jbt.build_unitary_batched(
        4, 'cp', 'xyz', anz.placements, a, columns=[0]))(jnp.asarray(angles))
    np.testing.assert_allclose(col.numpy(), np.asarray(jcol), atol=1e-5)


def test_per_unitary_losses_match_jax():
    rng = np.random.default_rng(4)
    u, _ = np.linalg.qr(rng.normal(size=(8, 8)) + 1j * rng.normal(size=(8, 8)))
    u = u.astype(np.complex64)
    ut = torch.tensor(u)
    assert tlosses.theoretical_lower_bound(4) == \
        jlosses.theoretical_lower_bound(4) == 61
    for t_fn, j_fn, target in [
            (tlosses.cost_HST, jlosses.cost_HST, u_ccz3),
            (tlosses.disc, jlosses.disc, u_ccz3),
            (tlosses.state_prep_loss, jlosses.state_prep_loss, ghz(3))]:
        assert float(t_fn(ut, target)) == pytest.approx(
            float(j_fn(jnp.asarray(u), jnp.asarray(target))), abs=1e-6)


N, K, SAMPLES = 3, 4, 16
INITS = np.random.default_rng(5).uniform(
    0, 2 * np.pi, (SAMPLES, 3 * N + 7 * K)).astype(np.float32)
OPTIONS = dict(num_cp_gates=K, num_samples=SAMPLES, accepted_num_cz_gates=2,
               r=0.001, num_gd_iterations=300,
               num_gd_iterations_at_verification=1000)


def test_ghz3_static_gives_two_cz_in_both_packages():
    """GHZ_n needs n - 1 CZ on a chain."""
    synth = tapi.Synthesize(chain_layer(N), target_state=ghz(N), device='cpu')
    options = tapi.StaticOptions(**OPTIONS)
    results = synth.static(options, save_results=False, verbose=False,
                           initial_angles_array=INITS)
    decs = results.decompositions
    assert decs and {d.cz_count for d in decs} == {2}
    spec = japi.LossSpec('state', target=ghz(N))
    for d in decs:
        u = d.circuit.unitary()
        # float32 device loss against the float64 host loss, as in the
        # static CCZ test
        assert spec.numpy(u) <= options.target_loss + 4e-6
        assert d.loss == pytest.approx(spec.numpy(u), abs=1e-12)

    # the JAX package's pipeline on the same initial angles
    janz = japi.Ansatz(N, 'cp', fill_layers(chain_layer(N), K))
    f = jbt.make_batched_regloss(
        N, 'cp', 'xyz', janz.placements, spec, cp_mask=janz.cp_mask,
        regularization_func=japi.make_regularization_function(
            japi.RegularizationOptions), r=0.001, reversible=True)
    raw = jengine.minimize_fused(f, INITS, learning_rate=0.1,
                                 num_iterations=300)
    jev = jcand.evaluate_raw_batch(raw, janz.cp_mask, 0.2)
    pros = jcand.filter_prospective(jev, 2, 1e-3)
    assert len(pros)
    batch = jev.angles[pros]
    batch = np.concatenate([batch, np.repeat(batch[:1], 8 - len(batch), 0)]) \
        if len(batch) < 8 else batch
    jver = jcand.verify_candidates_batch(
        spec, janz.unitary, batch, janz.cp_mask, learning_rate=0.01,
        num_iterations=1000, target_loss=1e-6, anz=janz)
    jcz = {int(jver.cz[i]) for i in range(len(pros)) if jver.success[i]}
    assert jcz == {2}

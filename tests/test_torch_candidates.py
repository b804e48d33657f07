"""Port vs JAX package: CZ counting, projection, candidate evaluation and
filtering, and batched verification (cpflow_tpu_torch.optimize.candidates
against cpflow_tpu.optimize.candidates)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import api as japi
from cpflow_tpu.optimize import candidates as jcand
from cpflow_tpu.optimize import engine as jengine
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch.optimize import candidates as tcand
from cpflow_tpu_torch.optimize import engine as tengine
from cpflow_tpu_torch.ops.gates import u_ccz3
from cpflow_tpu_torch.topology import chain_layer, fill_layers

torch.set_num_threads(1)


def _edge_angles():
    """Angles of both signs, with points on either side of every threshold
    of cz_value / project_cp_angles (0.2 and 1e-2 around 0, pi, 2pi)."""
    base = np.array([0.0, np.pi, 2 * np.pi, -np.pi, -2 * np.pi])
    offs = np.array([-0.25, -0.199, -0.15, -0.011, -0.009, 0.0, 0.009,
                     0.011, 0.15, 0.199, 0.25])
    grid = (base[:, None] + offs[None, :]).ravel()
    rnd = np.random.default_rng(0).uniform(-7, 7, 200)
    return np.concatenate([grid, rnd]).astype(np.float32)


@pytest.mark.parametrize('threshold', [1e-2, 0.2])
def test_cz_value_and_projection_match_jax(threshold):
    a = _edge_angles()
    ours = tcand.cz_value(torch.tensor(a), threshold=threshold).numpy()
    ref = np.asarray(jcand.cz_value(jnp.asarray(a), threshold=threshold))
    np.testing.assert_array_equal(ours, ref)
    proj = tcand.project_cp_angles(torch.tensor(a), threshold=threshold)
    jproj = jcand.project_cp_angles(jnp.asarray(a), threshold=threshold)
    np.testing.assert_array_equal(proj.numpy(), np.asarray(jproj))
    two_d = a[:200].reshape(8, 25)
    np.testing.assert_array_equal(
        tcand.count_cz(torch.tensor(two_d), threshold=threshold).numpy(),
        [int(jcand.count_cz(jnp.asarray(row), threshold=threshold))
         for row in two_d])


def test_evaluate_raw_batch_and_filter_match_jax():
    rng = np.random.default_rng(1)
    B, P = 12, 30
    cp_mask = (rng.uniform(size=P) > 0.6).astype(np.float32)
    params = rng.uniform(-7, 7, (B, 2, P)).astype(np.float32)
    params[:, 1, cp_mask == 1] = np.where(
        rng.uniform(size=(B, int(cp_mask.sum()))) > 0.5, np.pi, 0.05)
    regloss = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    regloss[3, 1] = regloss[3, 0]  # a tie: the first index wins in both
    loss = regloss - 1e-3
    raw = tengine.RawResult(torch.tensor(params), torch.tensor(regloss),
                            torch.tensor(loss))
    jraw = jengine.RawResult(jnp.asarray(params), jnp.asarray(regloss),
                             jnp.asarray(loss))
    ev = tcand.evaluate_raw_batch(raw, cp_mask, threshold=0.2)
    jev = jcand.evaluate_raw_batch(jraw, jnp.asarray(cp_mask), threshold=0.2)
    np.testing.assert_array_equal(ev.cz, jev.cz)
    np.testing.assert_array_equal(ev.loss, jev.loss)
    np.testing.assert_array_equal(ev.angles, jev.angles)
    for cz_max, loss_max in [(4, 0.5), (100, 1.0), (0, 0.0)]:
        np.testing.assert_array_equal(
            tcand.filter_prospective(ev, cz_max, loss_max),
            jcand.filter_prospective(jev, cz_max, loss_max))


@pytest.mark.parametrize('cp_dist', ['uniform', '0', 'normal'])
def test_generate_initial_angles_batch(cp_dist):
    cp_mask = np.zeros(20, dtype=np.float32)
    cp_mask[[6, 13]] = 1
    draw = lambda: tcand.generate_initial_angles_batch(
        torch.Generator().manual_seed(5), 20, cp_mask, cp_dist=cp_dist,
        batch_size=7, device='cpu')
    a = draw()
    assert a.shape == (7, 20) and a.dtype == torch.float32
    assert torch.equal(a, draw())  # same seed, same angles
    free = a[:, cp_mask == 0]
    assert float(free.min()) >= 0 and float(free.max()) < 2 * math.pi
    if cp_dist == '0':
        assert float(a[:, cp_mask == 1].abs().max()) == 0.0


def test_verify_candidates_batch_matches_jax():
    """Same candidate angles in both packages: frozen masks and CZ counts
    exactly equal, best losses within 1e-5 (float32 over 100 steps at the
    verification learning rate 0.01), same success flags."""
    n, k = 3, 12
    janz = japi.Ansatz(n, 'cp', fill_layers(chain_layer(n), k))
    tanz = tapi.Ansatz(n, 'cp', fill_layers(chain_layer(n), k))
    rng = np.random.default_rng(2)
    cand = rng.uniform(0, 2 * np.pi, (8, janz.num_angles)).astype(np.float32)
    cp_idx = np.nonzero(tanz.cp_mask)[0]
    # CP angles near 0, pi and 2pi (projected and frozen) and some free
    snap = rng.choice([0.0, np.pi, 2 * np.pi, -np.pi], size=(8, len(cp_idx)))
    near = snap + rng.uniform(-0.15, 0.15, size=snap.shape)
    free = rng.uniform(size=snap.shape) > 0.7
    cand[:, cp_idx] = np.where(free, cand[:, cp_idx], near).astype(np.float32)
    target_loss = 0.2
    ver = tcand.verify_candidates_batch(
        tapi.LossSpec('hst', target=u_ccz3), tanz, cand, threshold_cp=0.2,
        learning_rate=0.01, num_iterations=100, target_loss=target_loss,
        device='cpu')
    jver = jcand.verify_candidates_batch(
        japi.LossSpec('hst', target=u_ccz3), janz.unitary, cand,
        janz.cp_mask, threshold_cp=0.2, learning_rate=0.01,
        num_iterations=100, target_loss=target_loss, anz=janz)
    np.testing.assert_array_equal(ver.frozen, jver.frozen)
    np.testing.assert_array_equal(ver.cz, jver.cz)
    assert ver.success.any() and not ver.success.all()
    np.testing.assert_array_equal(ver.success, jver.success)
    np.testing.assert_allclose(ver.best_loss, jver.best_loss, atol=1e-5)
    frozen = ver.frozen
    np.testing.assert_array_equal(ver.best_angles[frozen],
                                  np.asarray(jver.best_angles)[frozen])

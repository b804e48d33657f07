"""The port's fused sweep (kernels/sweep.py) against the JAX package's
engine.minimize_fused(reversible=True).

Tolerances are those of tests/test_pallas_sweep.py: the regularized loss at
the initial angles within 1e-5, the best regularized loss and its loss
within 1e-4 after T = 60 steps."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu.api import LossSpec as JLossSpec
from cpflow_tpu.experimental import pallas_sweep as jps
from cpflow_tpu.ops.penalty import cp_penalty_linear as j_penalty
from cpflow_tpu.optimize import engine as jengine
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch.api import LossSpec
from cpflow_tpu_torch.ops.gates import cz_mat, u_ccz3
from cpflow_tpu_torch.ops.penalty import LinearPenalty
from cpflow_tpu_torch.optimize import engine
from cpflow_tpu_torch.sim.ansatz_kernel import cp_angle_indices, num_block_angles
from cpflow_tpu_torch.sim.batched import make_batched_regloss
from cpflow_tpu_torch.topology import chain_layer, fill_layers

torch.set_num_threads(1)

PEN = (math.pi / 2, 2.0, 0.05, 0.05, 0.05)
T = 60


def _problem(n, k, rot, target, r, B, seed):
    placements = fill_layers(chain_layer(n), k)
    nba = num_block_angles('cp', rot)
    P = 3 * n + nba * k
    cp_mask = np.zeros(P, dtype=np.float32)
    cp_mask[cp_angle_indices(n, nba, k)] = 1
    rng = np.random.default_rng(seed)
    inits = rng.uniform(0, 2 * np.pi, (B, P)).astype(np.float32)
    obj = make_batched_regloss(
        n, 'cp', rot, placements, LossSpec('hst', target=target),
        cp_mask=cp_mask, regularization_func=LinearPenalty(*PEN), r=r)
    jf = jbt.make_batched_regloss(
        n, 'cp', rot, placements, JLossSpec('hst', target=target),
        cp_mask=jnp.asarray(cp_mask),
        regularization_func=lambda a: j_penalty(a, *PEN), r=r,
        reversible=True)
    return obj, jf, inits, rng


def _assert_close(raw, jraw):
    np.testing.assert_allclose(raw.regloss[:, 0].numpy(),
                               np.asarray(jraw.regloss[:, 0]), atol=1e-5)
    np.testing.assert_allclose(raw.regloss[:, 1].numpy(),
                               np.asarray(jraw.regloss[:, 1]), atol=1e-4)
    np.testing.assert_allclose(raw.loss.numpy(), np.asarray(jraw.loss),
                               atol=1e-4)


@pytest.mark.parametrize('masked,r,target_loss', [
    (False, 0.002, None),
    (True, 0.002, None),
    (False, 0.0, None),
    (True, 0.0, 0.33),
])
def test_plain_sweep_matches_jax_engine(masked, r, target_loss):
    obj, jf, inits, rng = _problem(3, 4, 'xyz', u_ccz3, r, 8, seed=1)
    mask = (rng.uniform(size=inits.shape) > 0.3).astype(np.float32) \
        if masked else None
    raw = engine.minimize_fused(
        obj, torch.tensor(inits), learning_rate=0.1, num_iterations=T,
        grad_mask=None if mask is None else torch.tensor(mask),
        target_loss=target_loss)
    jraw = jengine.minimize_fused(jf, inits, learning_rate=0.1,
                                  num_iterations=T, grad_mask=mask,
                                  target_loss=target_loss)
    assert raw.params.shape == (8, 2, inits.shape[1])
    np.testing.assert_array_equal(raw.params[:, 0].numpy(), inits)
    _assert_close(raw, jraw)
    if mask is not None:  # frozen coordinates never move
        frozen = mask == 0
        np.testing.assert_array_equal(raw.params[:, 1].numpy()[frozen],
                                      inits[frozen])
    if target_loss is not None:
        ours = raw.loss[:, 1].numpy() <= target_loss
        ref = np.asarray(jraw.loss[:, 1]) <= target_loss
        assert ours.any() and not ours.all()
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.slow
def test_plain_sweep_matches_pallas_kernel_interpret():
    """Against the Pallas kernel itself, at test_pallas_sweep.py's shape."""
    obj, _, inits, _ = _problem(2, 2, 'xz', cz_mat, 0.002, jps.LANES, seed=0)
    nba = num_block_angles('cp', 'xz')
    cp_mask = np.zeros(6 + 2 * nba, dtype=np.float32)
    cp_mask[cp_angle_indices(2, nba, 2)] = 1
    jraw = jps.pallas_minimize_fused(2, 'xz', fill_layers(chain_layer(2), 2),
                                     np.asarray(cz_mat), cp_mask, 0.002, T,
                                     jnp.asarray(inits), interpret=True)
    raw = engine.minimize_fused(obj, torch.tensor(inits), learning_rate=0.1,
                                num_iterations=T)
    _assert_close(raw, jraw)

"""The port's sweep on the templates and losses beyond the CP/'xyz'/HS-test
default: other rotation strings against the TPU kernel itself
(pallas_minimize_fused in interpret mode), and the fixed 'cz'/'cx'
entanglers, rotation strings, disc and the modulo-identity/diagonal losses
against the JAX package's engine.minimize_fused(reversible=True), on
numpy-drawn initial angles.

Tolerances are those of tests/test_pallas_sweep.py: the regularized loss at
the initial angles within 1e-5, the best regularized loss and its loss
within 1e-4 after the sweep."""

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
from cpflow_tpu_torch.api import Ansatz, LossSpec
from cpflow_tpu_torch.ops.gates import multi_controlled_x, u_ccz3
from cpflow_tpu_torch.ops.penalty import LinearPenalty
from cpflow_tpu_torch.optimize import engine
from cpflow_tpu_torch.sim.batched import make_batched_regloss
from cpflow_tpu_torch.topology import chain_layer, fill_layers

torch.set_num_threads(1)

PEN = (math.pi / 2, 2.0, 0.05, 0.05, 0.05)
N, K = 3, 4


def _assert_close(raw, jraw):
    np.testing.assert_allclose(raw.regloss[:, 0].numpy(),
                               np.asarray(jraw.regloss[:, 0]), atol=1e-5)
    np.testing.assert_allclose(raw.regloss[:, 1].numpy(),
                               np.asarray(jraw.regloss[:, 1]), atol=1e-4)
    np.testing.assert_allclose(raw.loss.numpy(), np.asarray(jraw.loss),
                               atol=1e-4)


@pytest.mark.parametrize('rot', ['xz', 'z'])
def test_plain_sweep_matches_pallas_kernel(rot):
    """sweep_reference against the TPU kernel, run as tests/test_pallas_sweep
    runs it on the CPU: 3q chain CCZ, k=4, B=128, T=20."""
    anz = Ansatz(N, 'cp', fill_layers(chain_layer(N), K), rot)
    inits = np.random.default_rng(4).uniform(
        0, 2 * np.pi, (jps.LANES, anz.num_angles)).astype(np.float32)
    jraw = jps.pallas_minimize_fused(N, rot, anz.placements,
                                     np.asarray(u_ccz3), anz.cp_mask, 0.002,
                                     20, jnp.asarray(inits), interpret=True)
    obj = make_batched_regloss(N, 'cp', rot, anz.placements,
                               LossSpec('hst', target=u_ccz3),
                               cp_mask=anz.cp_mask,
                               regularization_func=LinearPenalty(*PEN),
                               r=0.002)
    raw = engine.minimize_fused(obj, torch.tensor(inits), learning_rate=0.1,
                                num_iterations=20)
    _assert_close(raw, jraw)


TOFF3 = multi_controlled_x(3)
# (entangler, rotations, loss kind, target, wires)
CASES = {
    'cz-xyz-hst': ('cz', 'xyz', 'hst', u_ccz3, None),
    'cx-xz-hst': ('cx', 'xz', 'hst', TOFF3, None),
    'cp-xz-hst': ('cp', 'xz', 'hst', TOFF3, None),
    'cp-yzx-hst': ('cp', 'yzx', 'hst', u_ccz3, None),
    'cp-xz-disc': ('cp', 'xz', 'disc', u_ccz3, None),
    'cp-xyz-modulo_identity-02': ('cp', 'xyz', 'modulo_identity', TOFF3,
                                  [0, 2]),
    'cp-xz-modulo_diagonal-all': ('cp', 'xz', 'modulo_diagonal', TOFF3,
                                  [0, 1, 2]),
    'cz-xz-modulo_diagonal-1': ('cz', 'xz', 'modulo_diagonal', TOFF3, [1]),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_sweep_matches_jax_engine(case):
    ent, rot, kind, target, wires = CASES[case]
    anz = Ansatz(N, ent, fill_layers(chain_layer(N), K), rot)
    kw = dict(target=target)
    if wires is not None:
        kw.update(num_qubits=N, wires=wires)
    pen = jpen = {}  # 'cz'/'cx' blocks have no CP angle to penalise
    if ent == 'cp':
        pen = dict(cp_mask=anz.cp_mask, r=0.002,
                   regularization_func=LinearPenalty(*PEN))
        jpen = dict(cp_mask=jnp.asarray(anz.cp_mask), r=0.002,
                    regularization_func=lambda a: j_penalty(a, *PEN))
    obj = make_batched_regloss(N, ent, rot, anz.placements,
                               LossSpec(kind, **kw), **pen)
    jf = jbt.make_batched_regloss(N, ent, rot, anz.placements,
                                  JLossSpec(kind, **kw), reversible=True,
                                  **jpen)
    inits = np.random.default_rng(len(case)).uniform(
        0, 2 * np.pi, (8, anz.num_angles)).astype(np.float32)
    raw = engine.minimize_fused(obj, torch.tensor(inits), learning_rate=0.1,
                                num_iterations=60)
    jraw = jengine.minimize_fused(jf, inits, learning_rate=0.1,
                                  num_iterations=60)
    assert raw.params.shape == (8, 2, anz.num_angles)
    _assert_close(raw, jraw)
    assert np.isfinite(raw.loss.numpy()).all()

"""Seven and eight qubits: the port's sweep on the whole unitary against the
JAX package's engine.minimize_fused(reversible=True), the plan that splits a
restart's columns over a cluster of thread blocks on the card, and the
Toffoli-7 warm-start batch of chip_smoke.py against the JAX package's
warm-start benchmark script.

On a CPU tensor ``kernels.sweep.sweep`` is the plain version, so the sweep
cases hold the port's arithmetic at 7 and 8 qubits against the JAX
package's on the same numpy inputs: the regularized loss at the initial
angles within 1e-5 and the best regularized loss and its loss within 1e-4
after T steps, each scaled by max(1, |loss|) (the modulo losses start near
the off-block weight, up to d = 128). The kernel itself runs only on a card:
chip_smoke.py phase 15 holds it against this plain version there."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu.api import LossSpec as JLossSpec
from cpflow_tpu.ops.penalty import cp_penalty_linear as j_penalty
from cpflow_tpu.optimize import engine as jengine
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch.api import LossSpec
from cpflow_tpu_torch.kernels import sweep as sk
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.ops.gates import multi_controlled_x
from cpflow_tpu_torch.ops.penalty import LinearPenalty
from cpflow_tpu_torch.optimize import engine
from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                cp_angle_indices,
                                                num_block_angles)
from cpflow_tpu_torch.sim.batched import make_batched_regloss
from cpflow_tpu_torch.topology import chain_layer, fill_layers

import chip_smoke

torch.set_num_threads(1)

PEN = (math.pi / 2, 2.0, 0.05, 0.05, 0.05)
WHOLE = ('hst', 'disc', 'modulo_identity', 'modulo_diagonal')
WIRES = {'modulo_identity': [6, 1], 'modulo_diagonal': [2, 5, 0]}


def _specs(kind, n, target):
    if kind.startswith('modulo'):
        kw = dict(target=target, num_qubits=n, wires=WIRES[kind])
    else:
        kw = dict(target=target)
    return LossSpec(kind, **kw), JLossSpec(kind, **kw)


def _sweep_both(n, k, kind, B, T, seed):
    """(port RawResult, JAX RawResult) of one sweep on the n-qubit chain
    with k blocks, target the n-qubit Toffoli, from the same numpy
    angles."""
    placements = fill_layers(chain_layer(n), k)
    nba = num_block_angles('cp', 'xyz')
    P = 3 * n + nba * k
    cp_mask = np.zeros(P, dtype=np.float32)
    cp_mask[cp_angle_indices(n, nba, k)] = 1
    inits = np.random.default_rng(seed).uniform(0, 2 * np.pi, (B, P)) \
        .astype(np.float32)
    spec, jspec = _specs(kind, n, multi_controlled_x(n))
    obj = make_batched_regloss(n, 'cp', 'xyz', placements, spec,
                               cp_mask=cp_mask,
                               regularization_func=LinearPenalty(*PEN),
                               r=0.002)
    jf = jbt.make_batched_regloss(
        n, 'cp', 'xyz', placements, jspec, cp_mask=jnp.asarray(cp_mask),
        regularization_func=lambda a: j_penalty(a, *PEN), r=0.002,
        reversible=True)
    before = sk.LAUNCHES
    raw = engine.minimize_fused(obj, torch.tensor(inits), learning_rate=0.1,
                                num_iterations=T, device='cpu')
    assert sk.LAUNCHES == before  # the plain version on a CPU tensor
    jraw = jengine.minimize_fused(jf, inits, learning_rate=0.1,
                                  num_iterations=T)
    return raw, jraw


def _assert_close(raw, jraw):
    ref0 = np.asarray(jraw.regloss[:, 0])
    scale = max(1.0, float(np.abs(ref0).max()))
    np.testing.assert_allclose(raw.regloss[:, 0].numpy(), ref0,
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(raw.regloss[:, 1].numpy(),
                               np.asarray(jraw.regloss[:, 1]),
                               atol=1e-4 * scale, rtol=0)
    np.testing.assert_allclose(raw.loss.numpy(), np.asarray(jraw.loss),
                               atol=1e-4 * scale, rtol=0)


@pytest.mark.parametrize('kind', WHOLE)
def test_seven_qubit_sweep_matches_jax_engine(kind):
    raw, jraw = _sweep_both(7, 3, kind, B=2, T=8, seed=70)
    _assert_close(raw, jraw)
    # the sweep moved every restart
    assert (raw.regloss[:, 1] < raw.regloss[:, 0]).all()


def test_eight_qubit_sweep_matches_jax_engine():
    raw, jraw = _sweep_both(8, 2, 'hst', B=1, T=4, seed=80)
    _assert_close(raw, jraw)


def _nb_nba(s):
    pl = s.get('placements') or fill_layers(
        s.get('layer') or chain_layer(s['n']),
        max(s['ks']) if 'ks' in s else s['k'])
    pl = {'layers': [[], 0], **pl}  # a shape may give free placements only
    return (len(all_placements(pl)),
            num_block_angles(s.get('ent', 'cp'), s.get('rot', 'xyz')))


def test_cluster_plan_keeps_one_block_where_one_fits():
    """Every shape chip_smoke.py phases 3 and 5 run, and every template of
    phase 12 up to 6 qubits, runs a restart on one block, as before the
    split; the per-block bytes mirror the kernels' layouts."""
    timing = [dict(n=3, k=12), dict(n=5, k=20)]
    for s in chip_smoke.compare_shapes() + timing:
        nb, nba = _nb_nba(s)
        kind = s.get('kind', 'hst')
        assert sk.cluster_plan(s['n'], nb, nba, kind) == 1, s.get('name')
        assert sk.smem_bytes(s['n'], nb, nba, kind) <= 232448
    for s in chip_smoke.unitary_shapes():
        if s['n'] > 6 and not s.get('columns'):
            continue
        nb = len(all_placements(s['placements']))
        nba = num_block_angles(s['ent'], s['rot'])
        log_c = 0 if s.get('columns') else s['n']
        for vjp in (False, True):
            assert uk.cluster_plan(s['n'], nb, nba, log_c, vjp) == 1
    # the layout of csrc/sweep.cu at the 3q static shape, term by term:
    # A and M, gates and their cotangents, two buffers of one warp's
    # partials, 5 angle arrays and cos/sin of P = 93 angles, 16 scalars
    assert sk.smem_bytes(3, 12, 7, 'hst') == \
        2 * 8 * 64 + 2 * 128 * 15 + 2 * 32 * 4 + 7 * 4 * 93 + 64


def test_cluster_plan_splits_seven_and_eight_qubits():
    assert sk.cluster_plan(7, 144, 7, 'hst') == 2
    assert sk.smem_bytes(7, 144, 7, 'hst', 2) == 200652
    assert sk.cluster_plan(7, 214, 7, 'hst') == 2
    assert sk.cluster_plan(7, 220, 7, 'hst') == 4
    assert sk.cluster_plan(8, 16, 7, 'hst') == 8
    assert sk.cluster_plan(8, 16, 4, 'modulo_diagonal') == 8
    assert sk.cluster_plan(12, 36, 7, 'state') == 1
    # a state's one column is split by rows past one block (row tiles)
    assert sk.cluster_plan(14, 2, 7, 'state') == 2
    assert sk.cluster_plan(18, 2, 7, 'state') is None
    assert sk.cluster_plan(9, 2, 7, 'hst') is None
    for s in chip_smoke.seven_shapes():
        nb, nba = _nb_nba(s)
        assert sk.cluster_plan(s['n'], nb, nba, s.get('kind', 'hst')) == \
            s['cluster'], s['name']
    # the unitary kernels: the forward pass holds A alone
    assert uk.cluster_plan(7, 144, 7, 7, False) == 1
    assert uk.cluster_plan(7, 144, 7, 7, True) == 2
    assert uk.cluster_plan(8, 16, 4, 8, False) == 4
    assert uk.cluster_plan(8, 16, 4, 8, True) == 8
    assert uk.cluster_plan(12, 36, 7, 0, True) == 1
    assert uk.cluster_plan(9, 2, 7, 9, True) is None
    # where no cluster holds the whole unitary, the column tiles do
    assert uk.plan(9, 2, 7, 9, True)['design'] == 'tiles'


def _objective(n, kind):
    """The check reads the template and the loss's wires, never the
    target: past 9 qubits a placeholder stands for the 2^n x 2^n one."""
    eye = np.eye(2 ** n if n <= 9 else 2, dtype=np.complex64)
    spec = LossSpec(kind, target=eye) if not kind.startswith('modulo') \
        else LossSpec(kind, target=eye, num_qubits=n, wires=[0, n - 1])
    return make_batched_regloss(n, 'cp', 'xz', fill_layers(chain_layer(n), 2),
                                spec, plain=True)


@pytest.mark.parametrize('kind', WHOLE)
def test_check_objective_takes_seven_and_eight_qubits_and_refuses_nine(kind):
    """7 and 8 qubits on clusters. Past them the HS test and disc take the
    column tiles to their limit, 13 qubits in float32, and refuse 14; the
    modulo losses, which read V across columns and take no tiles, still
    refuse 9 (ROADMAP A.16b)."""
    for n in (7, 8):
        sk._check_objective(_objective(n, kind))
    if kind.startswith('modulo'):
        with pytest.raises(ValueError, match='2 to 8 qubits.*cluster of 16 '
                           'blocks.*no modulo loss.*A.16b'):
            sk._check_objective(_objective(9, kind))
        return
    assert sk.MAX_QUBITS[torch.float32][kind] == 13
    for n in (9, 13):
        sk._check_objective(_objective(n, kind))
    with pytest.raises(ValueError, match='2 to 13 qubits.*got 14.*even on '
                       'column tiles of one column each'):
        sk._check_objective(_objective(14, kind))


def test_warm_batch_is_the_warm_start_scripts_bit_for_bit():
    """chip_smoke.build_warm_batch is a copy of
    benchmarks/warmstart6q.py:build_warm_batch (the port imports nothing of
    the JAX package's tree); on the Toffoli-7 embedding both give the same
    bits."""
    from benchmarks.warmstart6q import build_warm_batch
    qc, meta, placements, angles = chip_smoke.toffoli7_program()
    assert meta['cz_count'] == len(placements) == 144
    assert angles.shape == (21 + 7 * 144,)
    cp_mask = np.zeros(angles.shape[0])
    cp_mask[cp_angle_indices(7, 7, 144)] = 1
    for batch, seed in [(64, 0), (10, 3)]:
        ours = chip_smoke.build_warm_batch(angles.astype(np.float32),
                                           cp_mask, batch, seed)
        ref = build_warm_batch(angles.astype(np.float32), cp_mask, batch,
                               seed)
        for a, b in zip(ours, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

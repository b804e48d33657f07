"""Double precision: the port under config.set_precision(True) against the
JAX package under jax.enable_x64 and its own set_precision(True), on the
CPU (float32 restored in `finally` by the `double` context).

  * convert_cp_to_cz snaps CP angles to 0 and pi in float64 as in float32;
  * the tiny static CCZ gives the JAX package's decompositions in float64;
  * the plain fused sweep in float64 against the JAX package's fused sweep
    at 60 steps, over the losses and templates the kernel takes;
  * the bucketed stage and a small bucketed adaptive run in float64;
  * the double builds' shared-memory plans (sweep and unitary kernels),
    worked out from the layouts of csrc/sweep.cu, unitary.cu, columns.cuh;
  * the sweep kernel's checks and routing: float32 and float64 objectives
    taken, float16 refused, a penalty other than the piecewise-linear one
    sent to the unitary kernels on the card; the static CCZ with
    cp_penalty_L1 against the JAX package.

The kernels themselves (float64 builds against the plain float64 version)
are held on the card by the `cuda` cases at the end and by chip_smoke.py
phase 18."""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import api as japi
from cpflow_tpu import config as jconfig
from cpflow_tpu.ops import penalty as jpenalty
from cpflow_tpu.optimize import candidates as jcand
from cpflow_tpu.optimize import engine as jengine
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch import config as tconfig
from cpflow_tpu_torch.kernels import sweep as sk
from cpflow_tpu_torch.kernels import tiles as tk
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.ops import penalty as tpenalty
from cpflow_tpu_torch.ops.gates import cz_mat, u_ccz3, u_toff3
from cpflow_tpu_torch.optimize import candidates as tcand
from cpflow_tpu_torch.sim import batched as tbt
from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
from cpflow_tpu_torch.topology import chain_layer, connected_layer, \
    fill_layers

torch.set_num_threads(1)

F64 = torch.float64


@contextlib.contextmanager
def double(on: bool = True):
    """Both packages in double precision (the JAX one under x64), float32
    restored whatever happens."""
    with jax.enable_x64(on):
        jconfig.set_precision(on)
        tconfig.set_precision(on)
        try:
            yield
        finally:
            jconfig.set_precision(False)
            tconfig.set_precision(False)


# --------------------------------------------------------------- repairs

@pytest.mark.parametrize('on', [False, True], ids=['float32', 'float64'])
def test_convert_cp_to_cz_snaps_like_jax(on):
    """A 2q chain with k=2 and 'xz' whose CP angles are pi - 0.05 and 0.03:
    both snap (to pi and 0), so 14 of the 16 angles stay free, in either
    precision and in both packages. The port used to compare the projected
    float64 angles with np.float32(pi) and left the pi one free (15)."""
    n, k = 2, 2
    layer = fill_layers(chain_layer(n), k)
    tanz = tapi.Ansatz(n, 'cp', layer, 'xz')
    angles = np.random.default_rng(4).uniform(0, 2 * np.pi, tanz.num_angles)
    cp = np.nonzero(tanz.cp_mask)[0]
    angles[cp] = [np.pi - 0.05, 0.03]
    with double(on):
        janz = japi.Ansatz(n, 'cp', layer, 'xz')
        jcirc, ju, jfree = jcand.convert_cp_to_cz(janz, angles)
        tcirc, tu, tfree = tcand.convert_cp_to_cz(tanz, angles, device='cpu')
        dtype = np.float64 if on else np.float32
        assert np.asarray(jfree).dtype == dtype
        assert tfree.dtype == (F64 if on else torch.float32)
        assert len(jfree) == len(tfree) == tanz.num_angles - 2
        np.testing.assert_array_equal(tfree.numpy(), np.asarray(jfree))
        ju_m = np.asarray(ju(jfree))
        tu_m = tu(tfree).detach().numpy().reshape(ju_m.shape)
        np.testing.assert_allclose(tu_m, ju_m, atol=1e-12 if on else 1e-6)
        jq, tq = jcirc(np.asarray(jfree)), tcirc(tfree.numpy())
        assert _gates(jq) == _gates(tq)
        cps = [sorted(g.param for g in q.instructions if g.name == 'cp')
               for q in (jq, tq)]
        assert cps[0] == cps[1] == [0.0, float(dtype(np.pi))]


def _gates(qc):
    return [(g.name, tuple(g.qubits)) for g in qc.instructions]


def _params(qc):
    return [g.param for g in qc.instructions if g.param is not None]


STATIC = dict(num_cp_gates=12, num_samples=16, accepted_num_cz_gates=10,
              num_gd_iterations=400, num_gd_iterations_at_verification=400,
              random_seed=0)


def test_tiny_static_ccz_in_float64_gives_the_jax_decompositions():
    """3q chain CCZ, k=12, 16 samples, 400 + 400 steps, seed 0, accepted at
    10 CZ, in float64: the JAX package and the port verify the same
    decompositions (CZ counts, gates and qubits in order), with host losses
    within 1e-10 and angles within 1e-6.

    The two host losses differ (9.441047964520166e-07 against
    9.441006808552643e-07) by roundoff that Adam amplifies, not by a
    difference of arithmetic: the draws are bit-equal, the sweeps agree to
    1e-10 on their losses after 60 steps
    (test_plain_sweep_in_float64_matches_jax), and a perturbation of the
    port's own initial angles by one ulp moves its result as far
    (test_float64_drift_is_amplified_roundoff)."""
    with double():
        jres = japi.Synthesize(chain_layer(3), target_unitary=u_ccz3,
                               mesh=None).static(
            japi.StaticOptions(**STATIC), save_results=False, verbose=False)
        tres = tapi.Synthesize(chain_layer(3), target_unitary=u_ccz3,
                               device='cpu').static(
            tapi.StaticOptions(**STATIC), save_results=False, verbose=False)
    jd, td = jres.decompositions, tres.decompositions
    assert len(jd) == len(td) >= 1
    for a, b in zip(jd, td):
        assert a.cz_count == b.cz_count <= 10
        assert _gates(a.circuit) == _gates(b.circuit)
        assert abs(a.loss - b.loss) <= 1e-10
        assert b.loss <= 1e-6
        np.testing.assert_allclose(_params(b.circuit), _params(a.circuit),
                                   atol=1e-6)


def test_float64_drift_is_amplified_roundoff():
    """Why the float64 static CCZ agrees with the JAX package only to
    1e-10: the sampling stage (400 Adam steps) amplifies a one-ulp change
    of the initial angles more than 1e5-fold, to the size of the gap
    between the two packages (both under 1e-6)."""
    opts = tapi.StaticOptions(**STATIC)
    with double():
        synth = tapi.Synthesize(chain_layer(3), target_unitary=u_ccz3,
                                device='cpu')
        anz = synth._ansatz(opts)
        inits = tcand.generate_initial_angles_batch(
            tcand.prng.PRNGKey(0, 'cpu'), anz.num_angles, anz.cp_mask,
            batch_size=16).numpy()
        ulp = inits * (1 + 2.0 ** -52 * np.random.default_rng(1).choice(
            [-1, 1], inits.shape))
        ev = synth._raw_and_evaluate(opts, inits)
        moved = synth._raw_and_evaluate(opts, ulp)
        jev = japi.Synthesize(chain_layer(3), target_unitary=u_ccz3,
                              mesh=None)._raw_and_evaluate(
            japi.StaticOptions(**STATIC))
    start = np.abs(ulp - inits).max()
    drift = np.abs(moved.angles - ev.angles).max()
    gap = np.abs(jev.angles - ev.angles).max()
    print(f'one ulp ({start:.1e}) moves the angles by {drift:.2e}; the JAX '
          f'package differs by {gap:.2e}')
    assert 0 < start < 1e-14
    assert drift > 1e5 * start
    assert gap < 1e-6 and drift < 1e-6
    np.testing.assert_array_equal(jev.cz, ev.cz)


# --------------------------------------------------------------- the sweep

PEN = (math.pi / 2, 2.0, 0.05, 0.05, 0.05)


def _ghz(n):
    t = np.zeros(2 ** n, dtype=np.complex128)
    t[0] = t[-1] = 2 ** -0.5
    return t


# (name, n, layer, k, rot, ent, kind, target, wires, r)
SWEEPS = [
    ('hst_ccz', 3, chain_layer(3), 12, 'xyz', 'cp', 'hst', u_ccz3, None,
     0.00055),
    ('state_ghz4', 4, chain_layer(4), 6, 'xyz', 'cp', 'state', _ghz(4), None,
     0.001),
    ('modulo_diagonal', 3, connected_layer(3), 6, 'xyz', 'cp',
     'modulo_diagonal', u_toff3, [0, 1, 2], 0.002),
    ('disc_xz', 3, chain_layer(3), 8, 'xz', 'cp', 'disc', u_ccz3, None,
     0.0005),
    ('cz_xz', 2, chain_layer(2), 3, 'xz', 'cz', 'hst', cz_mat, None, 0.0),
]


def _spec(mod, kind, target, wires, n):
    if wires is None:
        return mod.LossSpec(kind, target=target)
    return mod.LossSpec(kind, target=target, num_qubits=n, wires=wires)


@pytest.mark.parametrize('case', SWEEPS, ids=[c[0] for c in SWEEPS])
def test_plain_sweep_in_float64_matches_jax(case):
    """The port's sweep (sweep_reference on the CPU) in float64 against the
    JAX package's fused Adam sweep under x64, 60 steps from the same
    angles: best regularized losses and losses within 1e-10, best angles
    within 1e-6. The angles' bound is loose because Adam amplifies roundoff
    along directions where the gradient nearly vanishes (the state and
    modulo losses leave many): the port's own sweep from initial angles one
    ulp away lands as far from it, which is checked here too."""
    _, n, layer, k, rot, ent, kind, target, wires, r = case
    placements = fill_layers(layer, k)
    with double():
        tanz = tapi.Ansatz(n, ent, placements, rot)
        pen = {}
        jpen = {}
        if ent == 'cp':
            pen = dict(cp_mask=tanz.cp_mask, r=r,
                       regularization_func=tpenalty.LinearPenalty(*PEN))
            jpen = dict(cp_mask=tanz.cp_mask, r=r,
                        regularization_func=lambda a: jpenalty
                        .cp_penalty_linear(a, *PEN))
        obj = tbt.make_batched_regloss(n, ent, rot, placements,
                                       _spec(tapi, kind, target, wires, n),
                                       **pen)
        assert obj.dtype == F64
        jf = jbt.make_batched_regloss(n, ent, rot, placements,
                                      _spec(japi, kind, target, wires, n),
                                      reversible=True, **jpen)
        inits = np.random.default_rng(5).uniform(
            0, 2 * np.pi, (tanz.num_angles, 8))
        res = sk.sweep(obj, torch.tensor(inits), 0.1, 60)
        moved = sk.sweep(obj, torch.tensor(inits * (1 + 2.0 ** -52)), 0.1,
                         60)
        jp, jreg, jloss = jengine.fused_adam_sweep(
            jf, jnp.asarray(inits), learning_rate=0.1, num_iterations=60)
    assert res.best_params.dtype == F64 and np.asarray(jp).dtype == np.float64
    np.testing.assert_allclose(res.best_reg.numpy(), np.asarray(jreg),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.best_loss.numpy(), np.asarray(jloss),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.best_params.numpy(), np.asarray(jp),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(moved.best_loss.numpy(),
                               res.best_loss.numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(moved.best_params.numpy(),
                               res.best_params.numpy(), rtol=0, atol=1e-6)


ADAPTIVE = dict(min_num_cp_gates=2, max_num_cp_gates=6, num_samples=8,
                num_gd_iterations=60)


def test_bucketed_stage_in_float64_matches_jax():
    """The bucketed stage from seeds (two trials, k = 3 and 6) in float64:
    the same draws, CZ counts equal, losses within 1e-10 after 60 steps.
    The JAX package passes each trial's r as a float32 scalar even under
    x64 (cpflow_tpu/api.py, _staged_run's callers), so r is rounded to
    float32 before it meets the float64 penalty; the port rounds it the
    same way (candidates.run_bucketed_stage) to match."""
    seeds, rs, ks = [11, 12], [0.00055, 0.002], [3, 6]
    with double():
        jsynth = japi.Synthesize(chain_layer(3), target_unitary=u_ccz3,
                                 mesh=None)
        fn, janz = jsynth._bucketed_stage(japi.AdaptiveOptions(**ADAPTIVE),
                                          vmapped=True)
        actives = np.zeros((2, janz.num_angles), dtype=np.float32)
        for j, k in enumerate(ks):
            actives[j, :9 + 7 * k] = 1
        unused = np.zeros((2, 8, janz.num_angles))
        jcz, jloss, jang = (np.asarray(x) for x in fn(
            jnp.asarray(seeds, dtype=jnp.uint32),
            jnp.asarray(rs, jnp.float32), jnp.asarray(actives),
            jnp.asarray(unused), jnp.float32(0.0)))
        synth = tapi.Synthesize(chain_layer(3), target_unitary=u_ccz3,
                                device='cpu')
        objective, anz = synth._bucketed_stage(
            tapi.AdaptiveOptions(**ADAPTIVE))
        cz, loss, ang = tcand.run_bucketed_stage(
            objective, seeds, rs, actives, 8, anz.cp_mask, learning_rate=0.1,
            num_iterations=60, device='cpu')
    assert ang.dtype == jang.dtype == np.float64
    np.testing.assert_array_equal(cz, jcz)
    np.testing.assert_allclose(loss, jloss, rtol=0, atol=1e-10)
    np.testing.assert_allclose(ang, jang, rtol=0, atol=1e-9)


def test_bucketed_adaptive_run_in_float64_matches_jax():
    """Synthesize.adaptive, bucketed, two parallel trials, four evaluations
    on the 2q chain for CZ, in float64 in both packages: the same trials
    (k, r and the CZ counts of each), the same verified decompositions."""
    opts = dict(min_num_cp_gates=1, max_num_cp_gates=3, num_samples=8,
                num_gd_iterations=60, num_gd_iterations_at_verification=200,
                max_evals=4, bucketed=True, parallel_trials=2)
    with double():
        jres = japi.Synthesize(chain_layer(2), target_unitary=cz_mat,
                               mesh=None).adaptive(
            japi.AdaptiveOptions(**opts), save_results=False, verbose=False)
        tres = tapi.Synthesize(chain_layer(2), target_unitary=cz_mat,
                               device='cpu').adaptive(
            tapi.AdaptiveOptions(**opts), save_results=False, verbose=False)
    jt, tt = jres.trials.results, tres.trials.results
    assert len(jt) == len(tt) == 4
    for a, b in zip(jt, tt):
        assert a['num_cp_gates'] == b['num_cp_gates']
        assert a['r'] == b['r']
        np.testing.assert_array_equal(np.sort(a['cz_counts']),
                                      np.sort(b['cz_counts']))
    assert [d.cz_count for d in jres.decompositions] == \
        [d.cz_count for d in tres.decompositions]
    for a, b in zip(jres.decompositions, tres.decompositions):
        assert abs(a.loss - b.loss) <= 1e-10


# --------------------------------------------------------------- the plans

# (n, k, rot, kind, float32 blocks, float64 blocks): the sweep's layout is
# all reals and complex numbers, so a double block takes twice the bytes
# (32 an amplitude pair of A and M): 6 qubits stay on one block, 7 qubits
# need 4 (on 2 blocks A and M alone take 256 KB a block) and 8 from
# k = 103, where the gates and angles, which every block holds whole, have
# grown; above k = 176 7 qubits take a (non-portable) cluster of 16 and
# above k = 214 none holds them (None); 8 qubits take 16 blocks; a state
# stays on one block up to 12 qubits.
SWEEP_PLANS = [
    (3, 12, 'xyz', 'hst', 1, 1),
    (6, 40, 'xz', 'modulo_diagonal', 1, 1),
    (7, 24, 'xyz', 'hst', 2, 4),
    (7, 102, 'xyz', 'hst', 2, 4),
    (7, 103, 'xyz', 'hst', 2, 8),
    (7, 176, 'xyz', 'hst', 2, 8),
    (7, 177, 'xyz', 'hst', 2, 16),
    (7, 220, 'xyz', 'hst', 4, None),
    (8, 16, 'xz', 'hst', 8, 16),
    (12, 60, 'xyz', 'state', 1, 1),
]


@pytest.mark.parametrize('n,k,rot,kind,c32,c64', SWEEP_PLANS)
def test_sweep_plan_in_float64(n, k, rot, kind, c32, c64):
    nba = num_block_angles('cp', rot)
    assert sk.cluster_plan(n, k, nba, kind) == c32
    assert sk.cluster_plan(n, k, nba, kind, dtype=F64) == c64
    for c in sk.CLUSTERS:
        assert sk.smem_bytes(n, k, nba, kind, c, F64) == \
            2 * sk.smem_bytes(n, k, nba, kind, c)
    if c64 is not None:
        assert sk.smem_bytes(n, k, nba, kind, c64, F64) <= 232448


# (n, k, log_c, vjp, float64 plan as (design, restarts a block, blocks a
# restart) or None)
UNITARY_PLANS = [
    (3, 12, 3, True, ('columns', 2, 1)),
    (5, 20, 5, True, ('columns', 2, 1)),
    (6, 40, 6, True, ('columns', 1, 1)),
    (7, 24, 7, False, ('tiles', 1, 2)),
    (7, 24, 7, True, ('rows', 1, 4)),
    (8, 16, 8, False, ('tiles', 1, 8)),
    (8, 16, 8, True, ('rows', 1, 16)),
    (8, 126, 8, True, ('tiles', 1, 32)),
    (12, 36, 0, True, ('rows', 1, 1)),
]


@pytest.mark.parametrize('n,k,log_c,vjp,want', UNITARY_PLANS)
def test_unitary_plan_in_float64(n, k, log_c, vjp, want):
    """The double build's plan from the layouts of csrc/unitary.cu and
    columns.cuh: every real and complex value twice the bytes, the gate
    codes (int32) not."""
    nba = num_block_angles('cp', 'xyz')
    got = uk.plan(n, k, nba, log_c, vjp, dtype=F64)
    if want is None:
        assert got is None
        assert uk.plan(n, k, nba, log_c, vjp) is not None  # float32 fits
        return
    assert (got['design'], got['restarts_per_block'],
            got['blocks_per_restart']) == want
    assert got['smem_bytes'] <= 232448
    if got['design'] == 'columns':
        G = n + k
        r = got['restarts_per_block']
        assert got['smem_bytes'] == 2 * (
            uk.column_smem_bytes(n, k, nba, vjp, r) - 4 * G) + 4 * G
    else:
        c = got['blocks_per_restart']
        assert uk.smem_bytes(n, k, nba, log_c, vjp, c, F64) == \
            2 * uk.smem_bytes(n, k, nba, log_c, vjp, c)
        if got['design'] == 'tiles' and vjp:  # tiles.cuh's tile kernel
            assert got['smem_bytes'] == tk.tile_smem_bytes(
                n, k, (1 << n) // c, F64)
        elif 'ring' in got:  # the forward pass's tiles and the vjp on a
            assert got['smem_bytes'] == tk.warp_smem_bytes(  # cluster
                n, k, nba, (1 << n) // c, vjp, got['ring'], F64)
        else:  # one column on rows.cuh's warps, one block or a cluster
            rows = uk.rows_launch(n, k, nba, log_c, vjp, F64)
            assert got['smem_bytes'] == rows['smem_bytes']


# ----------------------------------------------------- checks and routing

def _ccz_objective(dtype=None, regularization_func=None, loss=None,
                   plain=False):
    anz = tapi.Ansatz(3, 'cp', fill_layers(chain_layer(3), 4))
    return tbt.make_batched_regloss(
        3, 'cp', 'xyz', anz.placements,
        loss or tapi.LossSpec('hst', target=u_ccz3), cp_mask=anz.cp_mask,
        regularization_func=regularization_func or tpenalty.LinearPenalty(
            *PEN), r=0.001, dtype=dtype, plain=plain)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_check_objective_takes_float32_and_float64(dtype):
    sk._check_objective(_ccz_objective(dtype))


def test_check_objective_refuses_float16():
    with pytest.raises(ValueError, match='float32 or float64'):
        sk._check_objective(_ccz_objective(torch.float16))


@pytest.mark.parametrize('what,device,want', [
    ('linear', 'cpu', 'plain'),
    ('L1', 'cpu', 'plain'),
    ('linear', 'cuda', 'fused'),
    ('L1', 'cuda', 'unitary'),
    ('custom', 'cuda', 'unitary'),
])
def test_route(what, device, want):
    """A built-in loss with the piecewise-linear penalty takes the fused
    kernel on the card; any other penalty (as the JAX package's
    cp_regularization_func allows) or a custom loss takes the Adam loop over
    the unitary kernels; the CPU always the plain version."""
    if what == 'custom':
        obj = _ccz_objective(loss=tapi.LossSpec(
            'custom', fn=lambda u: 1 - abs(torch.trace(u)) / 8))
    else:
        obj = _ccz_objective(regularization_func=None if what == 'linear'
                             else tpenalty.cp_penalty_L1)
    assert sk.route(obj, device) == want
    if what == 'L1':  # the fused kernel itself refuses it
        with pytest.raises(NotImplementedError, match='piecewise-linear'):
            sk._check_objective(obj)


def test_route_refuses_a_plain_objective_that_needs_the_unitary_kernels():
    obj = _ccz_objective(regularization_func=tpenalty.cp_penalty_L1,
                         plain=True)
    with pytest.raises(ValueError, match='plain=True'):
        sk.route(obj, 'cuda')
    with pytest.raises(ValueError, match='no sweep for device'):
        sk.route(obj, 'meta')


def test_static_ccz_with_cp_penalty_l1_matches_jax():
    """Synthesize(..., cp_regularization_func=cp_penalty_L1).static on the
    3q chain CCZ (k=12, 16 samples, 300 + 300 steps, r 0.00055, accepted at
    24 CZ, since L1 pulls CP angles to 0 but not to pi, and a CP angle left
    free counts 2 CZ): the JAX package traces the L1 penalty into its fused sweep; the
    port's plain sweep takes it as it is (on the card, through the unitary
    kernels). Compared in float64: the same sampling CZ counts, losses
    within 1e-10, the same verified decompositions, host losses within
    1e-10. In float32 the L1 penalty's constant slope keeps Adam hopping
    across 0, so float32 roundoff grows within 300 steps to differences in
    the sampling losses and CZ counts, between the two packages as between
    two runs of either from initial angles one ulp apart."""
    opts = dict(num_cp_gates=12, num_samples=16, accepted_num_cz_gates=24,
                num_gd_iterations=300, num_gd_iterations_at_verification=300,
                random_seed=1)
    with double():
        jsynth = japi.Synthesize(
            chain_layer(3), target_unitary=u_ccz3, mesh=None,
            cp_regularization_func=jpenalty.cp_penalty_L1)
        tsynth = tapi.Synthesize(
            chain_layer(3), target_unitary=u_ccz3, device='cpu',
            cp_regularization_func=tpenalty.cp_penalty_L1)
        jev = jsynth._raw_and_evaluate(japi.StaticOptions(**opts))
        tev = tsynth._raw_and_evaluate(tapi.StaticOptions(**opts))
        jres = jsynth.static(japi.StaticOptions(**opts), save_results=False,
                             verbose=False)
        tres = tsynth.static(tapi.StaticOptions(**opts), save_results=False,
                             verbose=False)
    np.testing.assert_allclose(tev.loss, jev.loss, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(tev.cz, jev.cz)
    assert len(tres.decompositions) >= 1
    assert [d.cz_count for d in tres.decompositions] == \
        [d.cz_count for d in jres.decompositions]
    for a, b in zip(jres.decompositions, tres.decompositions):
        assert _gates(a.circuit) == _gates(b.circuit)
        assert abs(a.loss - b.loss) <= 1e-10


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize('case', SWEEPS, ids=[c[0] for c in SWEEPS])
def test_kernel_in_float64_matches_plain(case):
    """The sweep kernel's double build against the plain float64 version on
    the card, 60 steps: best losses within 1e-9 (no drift rule is needed in
    float64)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the double build runs only there')
    _, n, layer, k, rot, ent, kind, target, wires, r = case
    placements = fill_layers(layer, k)
    tanz = tapi.Ansatz(n, ent, placements, rot)
    pen = dict(cp_mask=tanz.cp_mask, r=r,
               regularization_func=tpenalty.LinearPenalty(*PEN)) \
        if ent == 'cp' else {}
    obj = tbt.make_batched_regloss(n, ent, rot, placements,
                                   _spec(tapi, kind, target, wires, n),
                                   dtype=F64, plain=True, **pen)
    inits = torch.tensor(np.random.default_rng(5).uniform(
        0, 2 * np.pi, (tanz.num_angles, 64)), device='cuda')
    before = sk.F64_LAUNCHES
    got = sk.sweep(obj, inits, 0.1, 60)
    want = sk.sweep_reference(obj, inits, 0.1, 60)
    assert sk.F64_LAUNCHES == before + 1
    assert got.best_loss.dtype == F64
    torch.testing.assert_close(got.best_loss, want.best_loss, rtol=0,
                               atol=1e-9)


@pytest.mark.cuda
# design None: each pass in its plan's (at 7 qubits the forward pass on the
# column tiles, the vjp on a cluster)
@pytest.mark.parametrize('n,k,design', [(3, 12, 'columns'), (3, 12, 'rows'),
                                        (5, 20, 'columns'), (7, 24, None)])
def test_unitary_kernels_in_float64_match_plain(n, k, design):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the double build runs only there')
    anz = tapi.Ansatz(n, 'cp', fill_layers(chain_layer(n), k))
    a = torch.tensor(np.random.default_rng(2).uniform(
        0, 2 * np.pi, (anz.num_angles, 16)), device='cuda')
    u = uk.ansatz_forward(n, 'cp', 'xyz', anz.placements, a, design=design)
    ap = a.clone().requires_grad_(True)
    up = tbt.build_unitary_batched(n, 'cp', 'xyz', anz.placements, ap,
                                   dtype=F64)
    up = up.reshape(2 ** n, 2 ** n, 16).permute(2, 0, 1)
    assert u.dtype == torch.complex128
    torch.testing.assert_close(u, up.detach(), rtol=0, atol=1e-12)
    g = torch.randn(u.shape, dtype=u.dtype, device='cuda')
    (want,) = torch.autograd.grad((up * g.conj()).real.sum(), ap)
    got = uk.ansatz_vjp(n, 'cp', 'xyz', anz.placements, a, u, g,
                        design=design)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-11)

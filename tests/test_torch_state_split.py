"""States past one block: a state's one column split by rows over a cluster
of 2 to 16 thread blocks, so that the port's kernels take states of up to
17 qubits in float32 and 16 in float64.

  * the plans: the sweep's and the unitary kernels' split a state (one
    column) at 14-17 qubits in float32 and 13-16 in float64, each the
    smallest cluster whose tiles fit, every edge named by the bytes of one
    block; every plan that held a shape before row tiles is unchanged
    (tests/test_torch_sixteen.py holds the rest of that);
  * the plain path at those widths on the CPU: the |0...0> column of
    sim.batched at 17 qubits (without the 2^n x 2^n identity) against
    Circuit.state, a state-target Decomposition at 14 and 17 qubits;
  * parity with the JAX package on the CPU: the plain fused sweep on GHZ-14
    in float32 and GHZ-13 in float64, and Synthesize.static for GHZ-14 in
    both packages from the same warm rows.

The kernels themselves run only on a card: chip_smoke.py phase 20 holds the
row-tile builds against their plain versions there."""

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
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.ops import penalty as tpenalty
from cpflow_tpu_torch.sim import batched as tbt
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles
from cpflow_tpu_torch.topology import chain_layer, fill_layers

import chip_smoke

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
LIMIT = 232448  # shared memory one block may use on sm_90
PEN = (math.pi / 2, 2.0, 0.05, 0.05, 0.05)
NBA = num_block_angles('cp', 'xyz')


@contextlib.contextmanager
def double():
    """Both packages in double precision (the JAX one under x64), float32
    restored whatever happens."""
    with jax.enable_x64(True):
        jconfig.set_precision(True)
        tconfig.set_precision(True)
        try:
            yield
        finally:
            jconfig.set_precision(False)
            tconfig.set_precision(False)


# --------------------------------------------------------------- the plans

# (qubits, blocks a restart) of a state on the chain at k = 2n, the depth
# chip_smoke.py phase 20 holds against the plain version
SPLITS = {F32: [(13, 1), (14, 2), (15, 4), (16, 8), (17, 16)],
          F64: [(12, 1), (13, 2), (14, 4), (15, 8), (16, 16)]}


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_state_plans_split_by_rows(dtype):
    """The sweep's plan and both unitary kernels' plans for one column take
    the smallest cluster whose row tiles fit: one block up to 13 qubits in
    float32 (12 in float64), then 2, 4, 8 and 16 blocks a qubit apart; the
    vjp (A and M) splits a qubit before the forward pass (A alone)."""
    for n, c in SPLITS[dtype]:
        k = 2 * n
        assert sk.cluster_plan(n, k, NBA, 'state', dtype) == c, (n, dtype)
        assert uk.cluster_plan(n, k, NBA, 0, True, dtype) == c, (n, dtype)
        assert uk.cluster_plan(n, k, NBA, 0, False, dtype) == max(c // 2, 1)
        for plan in (sk.smem_bytes(n, k, NBA, 'state', c, dtype),
                     uk.smem_bytes(n, k, NBA, 0, True, c, dtype)):
            assert plan <= LIMIT
        if c > 1:  # and the next smaller cluster does not fit
            assert sk.smem_bytes(n, k, NBA, 'state', c // 2, dtype) > LIMIT
        p = uk.plan(n, k, NBA, 0, True, dtype)
        assert p['design'] == 'rows' and p['blocks_per_restart'] == c
        # on one block or split by rows, the vjp's blocks take the row
        # tiles' warps (kernels/rows.py): 16 in float32, 8 in float64
        threads = 512 if dtype == F32 else 256
        assert p['threads'] == threads and \
            p['threads_per_restart'] == threads * c


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_row_tiles_keep_every_state_plan(dtype):
    """The warps' design of the row tiles (kernels/rows.py) changes no
    plan: at k = 2n the sweep's blocks a restart for a state are one block
    up to 13 qubits in float32 (12 in float64), then 2, 4, 8 and 16 a qubit
    apart, none past; at k = n, 2n and 4n the vjp's plan agrees with the
    sweep's, and each split's launch of the row tiles fits a block with
    the plan's blocks."""
    top = 17 if dtype == F32 else 16
    for n in range(2, top + 2):
        for k in (2 * n, n, 4 * n):
            c = sk.cluster_plan(n, k, NBA, 'state', dtype)
            if k == 2 * n:
                assert c == (None if n > top else 1 if n <= top - 4 else
                             {top - 3: 2, top - 2: 4, top - 1: 8,
                              top: 16}[n])
            assert uk.cluster_plan(n, k, NBA, 0, True, dtype) == c
            for row in (sk.row_plan(n, k, NBA, dtype),
                        uk.row_plan(n, k, NBA, dtype)):
                assert (row is None) == (c is None or c == 1)
                if row is not None:
                    assert row['cluster'] == c and \
                        row['smem_bytes'] <= LIMIT


def test_row_tiles_have_at_least_four_rows():
    """A state is never split into tiles of fewer than 4 rows, and a
    template too deep for one block is not taken by row tiles, which split
    the amplitudes and not the gates: at 10 qubits and k = 650 no plan
    holds it, as before row tiles."""
    for n in range(2, 19):
        for k in (0, 200, 400, 800):
            for dtype in (F32, F64):
                c = sk.cluster_plan(n, k, NBA, 'state', dtype)
                assert c is None or c <= max(1, 1 << (n - 2)), (n, k)
                c = uk.cluster_plan(n, k, NBA, 0, True, dtype)
                assert c is None or c <= max(1, 1 << (n - 2)), (n, k)
    assert sk.smem_bytes(10, 650, NBA, 'state') > LIMIT
    assert sk.cluster_plan(10, 650, NBA, 'state') is None
    assert uk.cluster_plan(10, 650, NBA, 0, True) is None


def _parent_sweep_plan(n, k, nba, kind, dtype):
    """The sweep's plan before row tiles: clusters of up to 16 blocks, never
    a split of a state's one column."""
    for c in sk.CLUSTERS:
        if c > 1 and (kind == 'state' or c > 1 << n):
            break
        if sk.smem_bytes(n, k, nba, kind, c, dtype) <= LIMIT:
            return c
    return None


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_state_plans_keep_every_one_block_plan(dtype):
    """For a state at n = 2..18 and k = 0..120: wherever one block held it,
    the plan is one block as before; elsewhere it is the smallest row split
    that fits, or None."""
    for n in range(2, 19):
        for k in range(0, 121, 3):
            old = _parent_sweep_plan(n, k, NBA, 'state', dtype)
            new = sk.cluster_plan(n, k, NBA, 'state', dtype)
            if old is not None:
                assert new == old == 1, (n, k)
                continue
            fits = [c for c in sk.CLUSTERS[1:] if c <= 1 << (n - 2) and
                    sk.smem_bytes(n, k, NBA, 'state', c, dtype) <= LIMIT]
            assert new == (fits[0] if fits else None), (n, k)


# (what, plan call, blocks a restart, bytes of one block there)
EDGES = [
    ('state float32 17q k=34', lambda: sk.cluster_plan(17, 34, NBA, 'state'),
     16, lambda: sk.smem_bytes(17, 34, NBA, 'state', 16)),
    ('state float32 18q k=0', lambda: sk.cluster_plan(18, 0, 0, 'state'),
     None, lambda: sk.smem_bytes(18, 0, 0, 'state', 16)),
    ('state float64 16q k=32', lambda: sk.cluster_plan(
        16, 32, NBA, 'state', F64), 16, lambda: sk.smem_bytes(
        16, 32, NBA, 'state', 16, F64)),
    ('state float64 17q k=0', lambda: sk.cluster_plan(17, 0, 0, 'state', F64),
     None, lambda: sk.smem_bytes(17, 0, 0, 'state', 16, F64)),
    ('vjp float32 17q column k=34', lambda: uk.cluster_plan(
        17, 34, NBA, 0, True), 16, lambda: uk.smem_bytes(
        17, 34, NBA, 0, True, 16)),
    ('vjp float32 18q column k=0', lambda: uk.cluster_plan(18, 0, 0, 0, True),
     None, lambda: uk.smem_bytes(18, 0, 0, 0, True, 16)),
    ('forward float32 18q column k=36', lambda: uk.cluster_plan(
        18, 36, NBA, 0, False), 16, lambda: uk.smem_bytes(
        18, 36, NBA, 0, False, 16)),
    ('vjp float64 16q column k=32', lambda: uk.cluster_plan(
        16, 32, NBA, 0, True, F64), 16, lambda: uk.smem_bytes(
        16, 32, NBA, 0, True, 16, F64)),
    ('vjp float64 17q column k=0', lambda: uk.cluster_plan(
        17, 0, 0, 0, True, F64), None, lambda: uk.smem_bytes(
        17, 0, 0, 0, True, 16, F64)),
]
# the bytes of one block at each edge, from the layouts of csrc/sweep.cu and
# csrc/unitary.cu: the A and M tiles (2^n / 16 rows each), the gates, their
# cotangents, the partials and the angles
EDGE_BYTES = [154332, 270376, 175104, 277928, 150800, 269664, 141656,
              168448, 276576]


@pytest.mark.parametrize('edge,nbytes', zip(EDGES, EDGE_BYTES),
                         ids=[e[0] for e in EDGES])
def test_state_plan_edges(edge, nbytes):
    _, plan, want, size = edge
    assert plan() == want
    assert size() == nbytes
    assert (nbytes <= LIMIT) == (want is not None)


def test_max_qubits_of_a_state():
    """What the plans hold with no blocks: a state's one column to 17
    qubits in float32 and 16 in float64, split by rows over 16 blocks; the
    whole unitary to 13 and 12 on the column tiles (the HS test and disc),
    the modulo losses to 8 as before; the unitary kernels take one column
    further, on the global row tiles, to 24 and 23."""
    for dtype, state, whole, column in ((F32, 17, 13, 24), (F64, 16, 12, 23)):
        assert sk.MAX_QUBITS[dtype]['state'] == state
        assert uk.MAX_QUBITS[dtype] == {'unitary': whole, 'column': column}
        assert sk.MAX_QUBITS[dtype]['hst'] == whole
        assert sk.MAX_QUBITS[dtype]['modulo_diagonal'] == 8


def _objective(n, dtype=None):
    return chip_smoke.make_objective(n, 2, chip_smoke.ghz(n), 0.0,
                                     kind='state', dtype=dtype)[0]


def test_sweep_takes_states_to_the_new_edges():
    sk._check_objective(_objective(17))
    sk._check_objective(_objective(14))
    sk._check_objective(_objective(16, F64))
    sk._check_objective(_objective(13, F64))


def test_row_tile_kernel_names():
    """A cluster of one column runs the row tiles' kernels, whose names
    follow the library's order."""
    assert uk.kernel_name('rows', False, 15, 2, column=True) == \
        'ansatz_forward_row_tiles' == uk.KERNELS[16]
    assert uk.kernel_name('rows', True, 17, 16, column=True) == \
        'ansatz_vjp_row_tiles' == uk.KERNELS[17]
    assert uk.kernel_name('rows', True, 13, 1, column=True) == 'ansatz_vjp'
    assert uk.kernel_name('rows', True, 8, 16) == 'ansatz_vjp_cluster'


# ------------------------------------------------ the plain path, host side

def test_plain_state_column_at_17_qubits():
    """sim.batched's |0...0> column at 17 qubits (the row tiles' widest
    float32 state) on the CPU, built without the 2^17 x 2^17 identity,
    equals Circuit.state of the same angles to float32 roundoff."""
    n, k = 17, 4
    placements = fill_layers(chain_layer(n), k)
    anz = tapi.Ansatz(n, 'cp', placements, 'xyz')
    angles = np.random.default_rng(17).uniform(0, 2 * np.pi,
                                               (anz.num_angles, 2))
    u = tbt.build_unitary_batched(n, 'cp', 'xyz', placements,
                                  torch.tensor(angles, dtype=F32),
                                  columns=[0])
    assert tuple(u.shape) == (2,) * n + (1, 2)
    col = u.reshape(2 ** n, 2).numpy()
    for b in range(2):
        psi = anz.circuit(list(angles[:, b])).state()
        np.testing.assert_allclose(col[:, b], psi, rtol=0, atol=2e-6)


@pytest.mark.parametrize('n', [14, 17])
def test_ghz_decomposition_past_one_block(n):
    """The (n - 1)-CZ GHZ ladder (chip_smoke.ghz_program), embedded exactly
    in the chain template at k = n - 1, becomes a Decomposition of n - 1 CZ
    at host loss within 1e-6 of 0, scored on the circuit's state with no
    unitary built (at 17 qubits it would be 2^17 x 2^17)."""
    placements, exact = chip_smoke.ghz_program(n)
    anz = tapi.Ansatz(n, 'cp', fill_layers(chain_layer(n), n - 1), 'xyz')
    assert [list(p) for p in all_placements(anz.placements)] == placements
    d = tapi.Decomposition._from_cp_circuit(
        tapi.LossSpec('state', target=chip_smoke.ghz(n)), anz, exact)
    assert d.cz_count == n - 1 and abs(d.loss) <= 1e-6
    assert d.__dict__['unitary'] is None
    assert chip_smoke.ghz_host_loss(d) <= 1e-12


# ------------------------------------------------- parity with the JAX package

def _sweeps(n, k, target, B, T, seed, r):
    """(port SweepResult, JAX (best angles, best regloss, best loss), the
    port's regularized losses at the initial angles from its objective) of
    the plain state sweep from the same numpy angles, in the current
    precision."""
    placements = fill_layers(chain_layer(n), k)
    tanz = tapi.Ansatz(n, 'cp', placements, 'xyz')
    obj = tbt.make_batched_regloss(
        n, 'cp', 'xyz', placements, tapi.LossSpec('state', target=target),
        cp_mask=tanz.cp_mask, r=r,
        regularization_func=tpenalty.LinearPenalty(*PEN))
    jf = jbt.make_batched_regloss(
        n, 'cp', 'xyz', placements, japi.LossSpec('state', target=target),
        reversible=True, cp_mask=tanz.cp_mask, r=r,
        regularization_func=lambda a: jpenalty.cp_penalty_linear(a, *PEN))
    inits = np.random.default_rng(seed).uniform(0, 2 * np.pi,
                                                (tanz.num_angles, B))
    if obj.dtype == F32:
        inits = inits.astype(np.float32)
    before = sk.LAUNCHES
    res = sk.sweep(obj, torch.tensor(inits), 0.1, T)
    assert sk.LAUNCHES == before  # the plain version on a CPU tensor
    jres = jengine.fused_adam_sweep(jf, jnp.asarray(inits), learning_rate=0.1,
                                    num_iterations=T)
    jreg0, _ = jf(jnp.asarray(inits))
    return res, [np.asarray(x) for x in jres], np.asarray(jreg0)


def test_fourteen_qubit_state_sweep_matches_jax():
    """The GHZ-14 state loss on the 14q chain (two row tiles on the card),
    k=4, B=2, 10 steps in float32: the regularized losses at the initial
    angles within 1e-5 of the JAX package's and the best ones and their
    losses within 1e-4 (two float32 derivations of one objective over
    16384 amplitudes)."""
    res, (jp, jreg, jloss), jreg0 = _sweeps(14, 4, chip_smoke.ghz(14), 2, 10,
                                            14, 0.001)
    assert res.best_params.dtype == F32
    np.testing.assert_allclose(res.regloss0.numpy(), jreg0, rtol=0, atol=1e-5)
    np.testing.assert_allclose(res.best_reg.numpy(), jreg, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.best_loss.numpy(), jloss, rtol=0,
                               atol=1e-4)
    assert (res.best_reg <= res.regloss0).all()


def test_thirteen_qubit_state_sweep_in_float64_matches_jax():
    """GHZ-13 on the 13q chain in float64 (two row tiles on the card), k=4,
    B=2, 10 steps: the regularized losses at the initial angles within
    1e-10 of the JAX package's under x64, the best ones and their losses
    within 1e-10, the best angles within 1e-6 (Adam amplifies roundoff
    along nearly flat directions)."""
    with double():
        res, (jp, jreg, jloss), jreg0 = _sweeps(13, 4, chip_smoke.ghz(13), 2,
                                                10, 13, 0.001)
    assert res.best_params.dtype == F64 and jp.dtype == np.float64
    np.testing.assert_allclose(res.regloss0.numpy(), jreg0, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(res.best_reg.numpy(), jreg, rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.best_loss.numpy(), jloss, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(res.best_params.numpy(), jp, rtol=0, atol=1e-6)


GHZ14 = dict(num_cp_gates=13, num_gd_iterations=40, learning_rate=0.01,
             r=1e-4, num_gd_iterations_at_verification=300,
             accepted_num_cz_gates=13)


def test_ghz14_static_matches_jax(monkeypatch):
    """Synthesize.static for GHZ-14 on the 14q chain at k = 13 in both
    packages from the same warm rows (chip_smoke.build_warm_batch around the
    exact 13-CZ embedding, its rows at noise 0.003, 0.01 and 0.03; the JAX
    package's seeded draw replaced by them). The JAX package runs its
    sampling, filter and verification; its Decomposition, which builds the
    2^14 x 2^14 unitary, is replaced by the port's of the same verified
    angles. The sampling stage's losses within 1e-5 of each other (float32
    over 16384 amplitudes) and its CZ counts equal; then the same
    decompositions (13 CZ, gates in order), each at host loss <= 1e-6 in
    both. Their losses are not held to each other: verification stops at
    the first step under 1e-6, which float32 Adam in two packages reaches
    at different angles (up to 9.8e-7 and 1.1e-7 on one row)."""
    n = 14
    placements, exact = chip_smoke.ghz_program(n)
    anz = tapi.Ansatz(n, 'cp', fill_layers(chain_layer(n), n - 1), 'xyz')
    warm, sigma = chip_smoke.build_warm_batch(
        exact.astype(np.float32), np.asarray(anz.cp_mask, dtype=np.float64),
        8, 0)
    rows = warm[1:4]
    assert list(sigma[1:4]) == [0.003, 0.01, 0.03]
    options = dict(GHZ14, num_samples=len(rows))
    spec = tapi.LossSpec('state', target=chip_smoke.ghz(n))
    monkeypatch.setattr(
        jcand, 'generate_initial_angles_batch',
        lambda key, num_angles, cp_mask, cp_dist='uniform', batch_size=1:
        jnp.asarray(rows))
    jsynth = japi.Synthesize(chain_layer(n), target_state=spec.target,
                             mesh=None)
    jsynth._make_decomposition = \
        lambda janz, angles, static_options=None: \
        tapi.Decomposition._from_cp_circuit(spec, anz, np.asarray(angles))
    tsynth = tapi.Synthesize(chain_layer(n), target_state=spec.target,
                             device='cpu')
    evs = []  # each package's sampling stage, as its static ran it
    for synth in (jsynth, tsynth):
        stage = synth._raw_and_evaluate
        synth._raw_and_evaluate = \
            lambda *a, stage=stage: evs.append(stage(*a)) or evs[-1]
    jres = jsynth.static(japi.StaticOptions(**options), save_results=False,
                         verbose=False)
    tres = tsynth.static(tapi.StaticOptions(**options), save_results=False,
                         verbose=False, initial_angles_array=rows)
    (jev, tev) = evs
    np.testing.assert_allclose(np.asarray(tev.loss), np.asarray(jev.loss),
                               rtol=0, atol=1e-5)
    assert list(np.asarray(tev.cz)) == list(np.asarray(jev.cz))
    jd, td = jres.decompositions, tres.decompositions
    print(f'GHZ-14 static from {len(rows)} warm rows: JAX package '
          f'{[(d.cz_count, d.loss) for d in jd]}, port '
          f'{[(d.cz_count, d.loss) for d in td]}')
    assert len(jd) == len(td) == len(rows)
    for a, b in zip(jd, td):
        assert a.cz_count == b.cz_count == n - 1
        assert [(g.name, tuple(g.qubits)) for g in a.circuit.instructions] \
            == [(g.name, tuple(g.qubits)) for g in b.circuit.instructions]
        assert max(a.loss, b.loss) <= 1e-6
        assert chip_smoke.ghz_host_loss(b) <= 1e-6

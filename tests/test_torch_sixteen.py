"""Clusters of 16 blocks and 13-qubit states: the plans that decide what the
port's kernels take on the card, and the port's plain path at the new sizes
against the JAX package on the CPU.

  * the sweep's and the unitary kernels' plans with clusters of up to 16
    blocks keep every plan that clusters of up to 8 gave, and take 16
    only where no cluster of 8 held the shape (every n from 2 to 8, k up
    to 300, both rotation strings, both dtypes), but for a state (one
    column), which since row tiles splits by rows where one block does not
    hold it (tests/test_torch_state_split.py);
  * the new edges, each named by the bytes of one block;
  * the limits: a state of 13 qubits in float32 and 12 in float64 on one
    block; no state of 18 qubits in float32 or 17 in float64, and no whole
    unitary of 9, each refused with its reason;
  * the plain fused sweep at 8 qubits in float64 and on a 13-qubit state
    in float32 against the JAX package's fused sweep, and a tiny static
    CX ladder in float64 through both packages (at 7 qubits: the JAX
    package's compilation at 8 qubits under x64 takes the test past its
    time);
  * a state target at 13 qubits on the host: Circuit.state, the passes'
    checks on the state, a Decomposition scored on the state (as the JAX
    package's at 4 qubits, and at 13 without the 2^13 x 2^13 unitary), and
    the GHZ-13 search's stall at loss 0.5 in both packages on the same
    seeds.

The kernels themselves run only on a card: chip_smoke.py phase 19 holds
the 16-block shapes and the 13-qubit state against their plain versions
there."""

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
from cpflow_tpu.optimize import engine as jengine
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch import config as tconfig
from cpflow_tpu_torch.kernels import sweep as sk
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.ops import penalty as tpenalty
from cpflow_tpu_torch.ops.gates import multi_controlled_x
from cpflow_tpu_torch.sim import batched as tbt
from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
from cpflow_tpu_torch.topology import chain_layer, fill_layers

import chip_smoke

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
LIMIT = 232448  # shared memory one block may use on sm_90
PEN = (math.pi / 2, 2.0, 0.05, 0.05, 0.05)
KINDS = ('hst', 'disc', 'modulo_identity', 'modulo_diagonal', 'state')


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

def _old_sweep_plan(n, k, nba, kind, dtype):
    """The sweep's plan as clusters of at most 8 blocks gave it, before row
    tiles split a state."""
    for c in (1, 2, 4, 8):
        if c > 1 and (kind == 'state' or c > 1 << n):
            break
        if sk.smem_bytes(n, k, nba, kind, c, dtype) <= LIMIT:
            return c
    return None


def _old_unitary_plan(n, k, nba, log_c, vjp, dtype):
    """The unitary kernels' row-split plan as clusters of at most 8 gave
    it, before row tiles split one column."""
    for c in (1, 2, 4, 8):
        if c > 1 << log_c:
            break
        if uk.smem_bytes(n, k, nba, log_c, vjp, c, dtype) <= LIMIT:
            return c
    return None


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
@pytest.mark.parametrize('rot', ['xyz', 'xz'])
def test_sweep_plan_keeps_every_old_plan(rot, dtype):
    """For n = 2..8 and k = 0..300 at every loss: where a cluster of at
    most 8 held the shape, the plan is the old one; where none did, it is
    16 blocks or None, and 16 blocks fit; a state that one block did not
    hold takes the smallest row split that fits."""
    nba = num_block_angles('cp', rot)
    taken = 0
    for n in range(2, 9):
        for kind in KINDS:
            for k in range(301):
                old = _old_sweep_plan(n, k, nba, kind, dtype)
                new = sk.cluster_plan(n, k, nba, kind, dtype)
                if old is not None:
                    assert new == old, (n, k, kind)
                elif kind == 'state':
                    fits = [c for c in sk.CLUSTERS[1:] if c <= 1 << (n - 2)
                            and sk.smem_bytes(n, k, nba, kind, c,
                                              dtype) <= LIMIT]
                    assert new == (fits[0] if fits else None), (n, k)
                else:
                    assert new in (16, None), (n, k, kind)
                    if new == 16:
                        taken += 1
                        assert sk.smem_bytes(n, k, nba, kind, 16,
                                             dtype) <= LIMIT
    assert taken > 0  # clusters of 16 take shapes no cluster of 8 held


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
@pytest.mark.parametrize('rot', ['xyz', 'xz'])
def test_unitary_plan_keeps_every_old_plan(rot, dtype):
    """The same for the unitary kernels' row-split plan, the forward pass
    and the vjp, the whole unitary and one column (which, where one block
    did not hold it, takes the smallest row split that fits)."""
    nba = num_block_angles('cp', rot)
    taken = 0
    for n in range(2, 9):
        for log_c in (0, n):
            for vjp in (False, True):
                for k in range(301):
                    old = _old_unitary_plan(n, k, nba, log_c, vjp, dtype)
                    new = uk.cluster_plan(n, k, nba, log_c, vjp, dtype)
                    if old is not None:
                        assert new == old, (n, k, log_c, vjp)
                    elif log_c == 0:
                        fits = [c for c in uk.CLUSTERS[1:]
                                if c <= 1 << (n - 2) and uk.smem_bytes(
                                    n, k, nba, 0, vjp, c, dtype) <= LIMIT]
                        assert new == (fits[0] if fits else None), (n, k)
                    else:
                        assert new in (16, None), (n, k, log_c, vjp)
                        taken += new == 16
    assert taken > 0


# (what, kernel's plan call, blocks a restart, bytes of one block there)
EDGES = [
    ('sweep float64 8q xyz k=101', lambda: sk.cluster_plan(
        8, 101, 7, 'hst', F64), 16, lambda: sk.smem_bytes(
        8, 101, 7, 'hst', 16, F64)),
    ('sweep float64 8q xyz k=102', lambda: sk.cluster_plan(
        8, 102, 7, 'hst', F64), None, lambda: sk.smem_bytes(
        8, 102, 7, 'hst', 16, F64)),
    ('sweep float64 8q xz k=16', lambda: sk.cluster_plan(
        8, 16, 5, 'hst', F64), 16, lambda: sk.smem_bytes(
        8, 16, 5, 'hst', 16, F64)),
    ('sweep float32 8q xyz k=213', lambda: sk.cluster_plan(
        8, 213, 7, 'hst'), 8, lambda: sk.smem_bytes(8, 213, 7, 'hst', 8)),
    ('sweep float32 8q xyz k=358', lambda: sk.cluster_plan(
        8, 358, 7, 'hst'), 16, lambda: sk.smem_bytes(8, 358, 7, 'hst', 16)),
    ('sweep float32 8q xyz k=359', lambda: sk.cluster_plan(
        8, 359, 7, 'hst'), None, lambda: sk.smem_bytes(8, 359, 7, 'hst',
                                                       16)),
    ('sweep float64 7q xyz k=214', lambda: sk.cluster_plan(
        7, 214, 7, 'hst', F64), 16, lambda: sk.smem_bytes(
        7, 214, 7, 'hst', 16, F64)),
    ('sweep float64 7q xyz k=215', lambda: sk.cluster_plan(
        7, 215, 7, 'hst', F64), None, lambda: sk.smem_bytes(
        7, 215, 7, 'hst', 16, F64)),
    ('vjp float64 8q xyz k=125', lambda: uk.cluster_plan(
        8, 125, 7, 8, True, F64), 16, lambda: uk.smem_bytes(
        8, 125, 7, 8, True, 16, F64)),
    ('vjp float64 8q xyz k=126', lambda: uk.cluster_plan(
        8, 126, 7, 8, True, F64), None, lambda: uk.smem_bytes(
        8, 126, 7, 8, True, 16, F64)),
    ('vjp float64 8q xz k=16', lambda: uk.cluster_plan(
        8, 16, 5, 8, True, F64), 16, lambda: uk.smem_bytes(
        8, 16, 5, 8, True, 16, F64)),
    ('state float32 13q xyz k=48', lambda: sk.cluster_plan(
        13, 48, 7, 'state'), 1, lambda: sk.smem_bytes(13, 48, 7, 'state')),
    ('vjp float32 13q column k=48', lambda: uk.cluster_plan(
        13, 48, 7, 0, True), 1, lambda: uk.smem_bytes(13, 48, 7, 0, True)),
    ('forward float32 13q column k=48', lambda: uk.cluster_plan(
        13, 48, 7, 0, False), 1, lambda: uk.smem_bytes(13, 48, 7, 0,
                                                      False)),
]
# the bytes of one block at each edge, from the layouts of csrc/sweep.cu and
# csrc/unitary.cu (A and M tiles, gates, their cotangents, partials, the
# angles): a shape is taken exactly where they are at most 232,448
EDGE_BYTES = [232040, 232944, 153408, 232180, 232184, 232636, 232136,
              233040, 232032, 232768, 150784, 159300, 154736, 77844]


@pytest.mark.parametrize('edge,nbytes', zip(EDGES, EDGE_BYTES),
                         ids=[e[0] for e in EDGES])
def test_plan_edges(edge, nbytes):
    _, plan, want, size = edge
    assert plan() == want
    assert size() == nbytes
    assert (nbytes <= LIMIT) == (want is not None)


# ------------------------------------------------------------- the limits

def test_max_qubits_by_dtype():
    """What the plans hold with no blocks: the whole unitary to 8 qubits in
    both builds on 16 blocks for the modulo losses, and on the column tiles
    to 13 in float32 and 12 in float64 for the HS test and disc; a state's
    one column to 13 qubits in float32 and to 12 in float64, whose every
    amplitude takes twice the bytes, on one block, and split by rows over
    16 blocks to 17 and 16; the unitary kernels take one column further,
    on the global row tiles, to 24 and 23."""
    for dtype, state, whole, column in ((F32, 17, 13, 24), (F64, 16, 12, 23)):
        assert sk.MAX_QUBITS[dtype] == {
            'hst': whole, 'state': state, 'disc': whole,
            'modulo_identity': 8, 'modulo_diagonal': 8}
        assert uk.MAX_QUBITS[dtype] == {'unitary': whole, 'column': column}
    assert sk.smem_bytes(14, 0, 7, 'state') > LIMIT
    assert sk.smem_bytes(13, 0, 7, 'state', dtype=F64) > LIMIT
    assert sk.smem_bytes(18, 0, 7, 'state', 16) > LIMIT
    assert sk.smem_bytes(17, 0, 7, 'state', 16, F64) > LIMIT
    assert sk.smem_bytes(9, 0, 7, 'hst', 16) > LIMIT


def _objective(n, kind, dtype=None):
    """The check reads the template and the loss's wires, never the target:
    past 9 qubits a placeholder stands for the 2^n x 2^n one."""
    target = chip_smoke.ghz(n) if kind == 'state' else \
        np.eye(2 ** n if n <= 9 else 2, dtype=np.complex64)
    wires = [0, n - 1] if kind.startswith('modulo') else None
    return chip_smoke.make_objective(n, 2, target, 0.0, kind=kind,
                                     wires=wires, dtype=dtype)[0]


def test_sweep_takes_a_13_qubit_state_in_float32():
    sk._check_objective(_objective(13, 'state'))
    sk._check_objective(_objective(12, 'state', F64))


@pytest.mark.parametrize('n,kind,dtype,reason', [
    (18, 'state', F32, r"2 to 17 qubits for a 'state' loss in "
     r"torch.float32, got 18: .*a cluster of 16 blocks, the largest Hopper "
     r"launches, even split by rows; sweep\(\) takes it to the unitary "
     r"kernels, whose global row tiles hold one column to 24 qubits$"),
    (17, 'state', F64, r"2 to 16 qubits for a 'state' loss in "
     r"torch.float64, got 17: .*even split by rows \(float64 doubles their "
     r"bytes\)"),
    (9, 'modulo_diagonal', F32, r"2 to 8 qubits for a 'modulo_diagonal' "
     r"loss in torch.float32, got 9: .*a cluster of 16 blocks, the largest "
     r"Hopper launches, and the column tiles take no modulo loss.*A.16b"),
    (9, 'modulo_identity', F64, r"2 to 8 qubits .* torch.float64, got 9: "
     r".*A.16b"),
    (14, 'hst', F32, r"2 to 13 qubits for a 'hst' loss in torch.float32, got "
     r"14: above 13 one column of the state and cotangent exceeds the shared "
     r"memory of a block, even on column tiles of one column each$"),
    (13, 'disc', F64, r"2 to 12 qubits for a 'disc' loss in torch.float64, "
     r"got 13: .*even on column tiles of one column each \(float64 doubles "
     r"their bytes\)"),
], ids=['state18', 'state17_float64', 'whole9', 'whole9_float64', 'whole14',
        'whole13_float64'])
def test_sweep_refuses_beyond_its_plans(n, kind, dtype, reason):
    with pytest.raises(ValueError, match=reason):
        sk._check_objective(_objective(n, kind, dtype))


@pytest.mark.parametrize('n,columns,dtype,reason', [
    (25, [0], F32, r'2 to 24 qubits for one column in torch.float32, got '
     r'25: above that past the global row tiles\' cap'),
    (24, [0], F64, r'2 to 23 qubits for one column in torch.float64, got '
     r'24'),
    (14, None, F32, r'2 to 13 qubits for the whole unitary in torch.float32, '
     r'got 14: .*even on column tiles of one column each'),
    (13, None, F64, r'2 to 12 qubits for the whole unitary in torch.float64, '
     r'got 13'),
# (the first two ids are the names these cases had when they refused 18
# and 17 qubits; the names stay, and the widths they refuse now are 25 and
# 24, one past the global row tiles' cap)
], ids=['column18', 'column17_float64', 'whole14', 'whole13_float64'])
def test_unitary_kernels_refuse_beyond_their_plans(monkeypatch, n, columns,
                                                   dtype, reason):
    """The unitary kernels' shape check on a card (its capability check
    answered as a Hopper's): it refuses before it loads or builds
    anything."""
    monkeypatch.setattr(torch.cuda, 'get_device_capability',
                        lambda device=None: (9, 0))
    with pytest.raises(ValueError, match=reason):
        uk._Shape(n, 'cp', 'xyz', ((0, 1),), columns, 2,
                  torch.device('cuda'), True, dtype)


# ------------------------------------------------- parity with the JAX package

def _sweeps(n, k, rot, spec_kind, target, B, T, seed, r):
    """(port SweepResult, JAX (best angles, best regloss, best loss)) of the
    plain sweep from the same numpy angles, in the current precision."""
    placements = fill_layers(chain_layer(n), k)
    tanz = tapi.Ansatz(n, 'cp', placements, rot)
    obj = tbt.make_batched_regloss(
        n, 'cp', rot, placements, tapi.LossSpec(spec_kind, target=target),
        cp_mask=tanz.cp_mask, r=r,
        regularization_func=tpenalty.LinearPenalty(*PEN))
    jf = jbt.make_batched_regloss(
        n, 'cp', rot, placements, japi.LossSpec(spec_kind, target=target),
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
    return res, [np.asarray(x) for x in jres]


def test_eight_qubit_sweep_in_float64_matches_jax():
    """8q chain Toffoli-8, 'xz', k=4, B=4, 20 steps in float64 (the shape
    the card runs on 16 blocks): best regularized losses and losses within
    1e-10 of the JAX package's under x64, best angles within 1e-6 (Adam
    amplifies roundoff along nearly flat directions, as
    tests/test_torch_double.py shows)."""
    with double():
        res, (jp, jreg, jloss) = _sweeps(8, 4, 'xz', 'hst',
                                         multi_controlled_x(8), 4, 20, 8,
                                         0.002)
    assert res.best_params.dtype == F64 and jp.dtype == np.float64
    np.testing.assert_allclose(res.best_reg.numpy(), jreg, rtol=0, atol=1e-10)
    np.testing.assert_allclose(res.best_loss.numpy(), jloss, rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(res.best_params.numpy(), jp, rtol=0, atol=1e-6)
    assert (res.best_loss < res.loss0).all()


def test_thirteen_qubit_state_sweep_matches_jax():
    """The GHZ-13 state loss on the 13q chain, k=4, B=2, 10 steps in
    float32: the regularized losses at the initial angles within 1e-5 and
    the best ones and their losses within 1e-4 (two float32 derivations of
    one objective over 8192 amplitudes; 10 Adam steps leave them far from
    any flat stretch where float32 drift grows)."""
    res, (jp, jreg, jloss) = _sweeps(13, 4, 'xyz', 'state',
                                     chip_smoke.ghz(13), 2, 10, 13, 0.001)
    assert res.best_params.dtype == F32
    np.testing.assert_allclose(res.best_reg.numpy(), jreg, rtol=0, atol=1e-4)
    np.testing.assert_allclose(res.best_loss.numpy(), jloss, rtol=0,
                               atol=1e-4)
    with torch.no_grad():
        placements = fill_layers(chain_layer(13), 4)
        tanz = tapi.Ansatz(13, 'cp', placements, 'xyz')
        obj = tbt.make_batched_regloss(
            13, 'cp', 'xyz', placements,
            tapi.LossSpec('state', target=chip_smoke.ghz(13)),
            cp_mask=tanz.cp_mask, r=0.001,
            regularization_func=tpenalty.LinearPenalty(*PEN))
        inits = np.random.default_rng(13).uniform(
            0, 2 * np.pi, (tanz.num_angles, 2)).astype(np.float32)
        reg0, _ = obj(torch.tensor(inits))
    np.testing.assert_allclose(res.regloss0.numpy(), reg0.numpy(), rtol=0,
                               atol=1e-5)
    assert (res.best_reg <= res.regloss0).all()


LADDER = dict(num_cp_gates=6, num_samples=4, accepted_num_cz_gates=6,
              num_gd_iterations=200, num_gd_iterations_at_verification=200,
              random_seed=0)


def test_tiny_static_ladder_in_float64_matches_jax():
    """Synthesize.static on the 7q chain for the CX ladder (6 CZ) in float64
    through both packages, 4 samples, 200 + 200 steps, seed 0: the same
    decompositions (CZ counts, gates in order), host losses within 1e-10.
    7 qubits, not chip_smoke.py phase 19's 8: the JAX package compiles the
    8q stages under x64 for some 30 s on this CPU, which takes the test
    past its time."""
    ladder = chip_smoke.cx_ladder(7)
    with double():
        jres = japi.Synthesize(chain_layer(7), target_unitary=ladder,
                               mesh=None).static(
            japi.StaticOptions(**LADDER), save_results=False, verbose=False)
        tres = tapi.Synthesize(chain_layer(7), target_unitary=ladder,
                               device='cpu').static(
            tapi.StaticOptions(**LADDER), save_results=False, verbose=False)
    jd, td = jres.decompositions, tres.decompositions
    assert len(jd) == len(td) >= 1
    for a, b in zip(jd, td):
        assert a.cz_count == b.cz_count == 6
        assert [(g.name, tuple(g.qubits)) for g in a.circuit.instructions] \
            == [(g.name, tuple(g.qubits)) for g in b.circuit.instructions]
        assert abs(a.loss - b.loss) <= 1e-10
        assert b.loss <= 1e-6


def _random_circuit(n, k, seed):
    placements = fill_layers(chain_layer(n), k)
    anz = tapi.Ansatz(n, 'cp', placements, 'xyz')
    angles = np.random.default_rng(seed).uniform(0, 2 * np.pi, anz.num_angles)
    return anz.circuit(list(angles))


@pytest.mark.parametrize('n', [2, 4, 6])
def test_circuit_state_is_the_unitarys_first_column(n):
    """Circuit.state (the circuit on |0...0>, no 2^n x 2^n matrix) equals
    the first column of Circuit.unitary and of the JAX package's circuit
    unitary, to float64 roundoff."""
    from cpflow_tpu.circuits import ir as jir
    qc = _random_circuit(n, 2 * n, n)
    jqc = jir.Circuit(n)
    for g in qc.instructions:
        jqc.append(g.name, g.qubits, g.param)
    psi = qc.state()
    assert psi.shape == (2 ** n,) and psi.dtype == np.complex128
    np.testing.assert_allclose(psi, qc.unitary()[:, 0], rtol=0, atol=1e-13)
    np.testing.assert_allclose(psi, jqc.unitary()[:, 0], rtol=0, atol=1e-13)


def test_check_approximation_on_the_state():
    """With state=True two circuits are held to the same state, not the same
    unitary: a CZ on |00> leaves the state as it is, so the state check
    passes where the unitary check raises."""
    from cpflow_tpu_torch.circuits.passes import check_approximation
    from cpflow_tpu_torch.circuits.ir import Circuit, Instruction
    qc = _random_circuit(4, 6, 1)
    changed = Circuit(4, [Instruction('cz', (0, 1))] +
                      [g.copy() for g in qc.instructions])
    check_approximation(qc, changed, state=True)
    with pytest.raises(ValueError, match='above threshold'):
        check_approximation(qc, changed)
    flipped = Circuit(4, [Instruction('x', (0,))] +
                      [g.copy() for g in qc.instructions])
    with pytest.raises(ValueError, match='above threshold'):
        check_approximation(qc, flipped, state=True)


def test_state_decomposition_matches_jax():
    """A state target's Decomposition is checked and scored on the circuit's
    state: at 4 qubits (GHZ-4 on the chain, random angles with CP angles
    snapped to 0 or pi, as a verification leaves them) the same circuit,
    CZ count and depth as the JAX package's, which builds the unitary, and
    host losses within 1e-12; the unitary is built only when read."""
    n, k = 4, 6
    placements = fill_layers(chain_layer(n), k)
    tanz = tapi.Ansatz(n, 'cp', placements, 'xyz')
    janz = japi.Ansatz(n, 'cp', placements, 'xyz')
    rng = np.random.default_rng(4)
    angles = rng.uniform(0, 2 * np.pi, tanz.num_angles)
    cp = np.nonzero(tanz.cp_mask)[0]
    angles[cp] = np.pi * rng.integers(0, 2, len(cp))
    target = chip_smoke.ghz(n)
    d = tapi.Decomposition._from_cp_circuit(
        tapi.LossSpec('state', target=target), tanz, angles)
    jd = japi.Decomposition._from_cp_circuit(
        japi.LossSpec('state', target=target), janz, angles)
    assert d.__dict__['unitary'] is None
    assert (d.cz_count, d.cz_depth) == (jd.cz_count, jd.cz_depth)
    assert [(g.name, tuple(g.qubits)) for g in d.circuit.instructions] == \
        [(g.name, tuple(g.qubits)) for g in jd.circuit.instructions]
    assert abs(d.loss - jd.loss) <= 1e-12
    np.testing.assert_allclose(d.unitary, np.asarray(jd.unitary), rtol=0,
                               atol=1e-12)


def test_ghz13_decomposition_on_the_state():
    """The 12-CZ GHZ-13 ladder (chip_smoke.ghz_program), embedded exactly
    in the 13q chain template at k = 12, becomes a Decomposition of 12 CZ
    at host loss within 1e-6 of 0 in well under a second: it never builds
    the 2^13 x 2^13 unitary, which took 1404 s on an H100 machine's host
    (chip_smoke.py phase 19 (d))."""
    import time
    placements, exact = chip_smoke.ghz_program(13)
    anz = tapi.Ansatz(13, 'cp', fill_layers(chain_layer(13), 12), 'xyz')
    from cpflow_tpu_torch.sim.ansatz_kernel import all_placements
    assert [list(p) for p in all_placements(anz.placements)] == placements
    start = time.perf_counter()
    d = tapi.Decomposition._from_cp_circuit(
        tapi.LossSpec('state', target=chip_smoke.ghz(13)), anz, exact)
    assert time.perf_counter() - start < 5
    assert d.cz_count == 12 and abs(d.loss) <= 1e-6
    assert d.__dict__['unitary'] is None
    assert chip_smoke.ghz_host_loss(d) <= 1e-12


GHZ13_SEARCH = dict(num_cp_gates=14, num_samples=2, num_gd_iterations=40,
                    r=0.001, accepted_num_cz_gates=12, random_seed=0)


def test_ghz13_search_stalls_in_both_packages():
    """The GHZ-13 static search of chip_smoke.py phase 19 (d), k = 14 on the
    13q chain, at 2 restarts of 40 steps from seed 0 through both packages'
    sampling stage on the CPU: the same restarts (the port draws the JAX
    package's angles), the same losses within 1e-5 (float32 over 8192
    amplitudes), and in both every restart at the product-state plateau
    (loss near 0.5), so neither passes a candidate to verification. The
    stall that phase 19 (d) sees at 1024 restarts of 2000 steps on the card
    is the JAX package's too, not the port's."""
    from cpflow_tpu.optimize import candidates as jcand
    from cpflow_tpu_torch.optimize import candidates as tcand
    target = chip_smoke.ghz(13)
    jev = japi.Synthesize(chain_layer(13), target_state=target, mesh=None) \
        ._raw_and_evaluate(japi.StaticOptions(**GHZ13_SEARCH))
    tev = tapi.Synthesize(chain_layer(13), target_state=target,
                          device='cpu') \
        ._raw_and_evaluate(tapi.StaticOptions(**GHZ13_SEARCH))
    jloss, tloss = np.asarray(jev.loss), np.asarray(tev.loss)
    print(f'GHZ-13, k=14, 2 restarts, 40 steps: JAX package {jloss}, port '
          f'{tloss}')
    np.testing.assert_allclose(tloss, jloss, rtol=0, atol=1e-5)
    assert ((jloss > 0.49) & (jloss < 0.51)).all()
    for cand, ev in ((jcand, jev), (tcand, tev)):
        assert len(cand.filter_prospective(ev, 12, 1e-3)) == 0

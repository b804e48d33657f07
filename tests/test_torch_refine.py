"""Clifford+T synthesis and the refine state machine of the port
(cpflow_tpu_torch/circuits/clifford_t.py, refine.py, and
api.Decomposition.refine) against the JAX package's on the same circuits.
Both are deterministic float64 numpy on the host: the outcome of every
pipeline (type, CZ count, T count, T depth, instruction names and qubits) is
equal, parameters and losses agree within 1e-12."""

import json
import math
import os

import numpy as np
import pytest

from cpflow_tpu import api as japi
from cpflow_tpu.circuits import clifford_t as jct
from cpflow_tpu.circuits import refine as jrefine
from cpflow_tpu.circuits.ir import Circuit as JCircuit
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch import params
from cpflow_tpu_torch.circuits import clifford_t as tct
from cpflow_tpu_torch.circuits import passes
from cpflow_tpu_torch.circuits import refine as trefine
from cpflow_tpu_torch.circuits.ir import FIXED_GATES, Circuit
from cpflow_tpu_torch.ops.gates import u_toff3
from test_torch_ir import assert_same_circuit

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'golden',
                      'tdepth3_toffoli3_chain.json')


def word_matrix(word):
    m = np.eye(2, dtype=complex)
    for g in word:  # application order
        m = FIXED_GATES[g] @ m
    return m


def rz_np(a):
    return np.diag([np.exp(-1j * a / 2), np.exp(1j * a / 2)])


def rx_np(a):
    c, s = math.cos(a / 2), math.sin(a / 2)
    return np.array([[c, -1j * s], [-1j * s, c]])


def golden_circuit():
    qc = Circuit(3)
    for r in json.load(open(GOLDEN)):
        qc.append(r['name'], tuple(r['qubits']), r.get('param'))
    return qc


@pytest.fixture(scope='module')
def tables():
    """The basic-approximation tables, built once: (port, JAX package)."""
    return tct.SolovayKitaev(basic_depth=7), jct.SolovayKitaev(basic_depth=7)


# ------------------------------------------------------------- exact words

@pytest.mark.parametrize('axis,k', [('rz', k) for k in range(-8, 9)] +
                         [('rx', k) for k in (-3, -1, 0, 1, 2, 3, 4, 5)])
def test_exact_words(axis, k):
    a = k * math.pi / 4
    word = getattr(tct, f'exact_{axis}_word')(a)
    assert word is not None
    assert word == getattr(jct, f'exact_{axis}_word')(a)
    target = rz_np(a) if axis == 'rz' else rx_np(a)
    assert passes.hst_distance(word_matrix(word), target) < 1e-12


def test_exact_word_rejects_irrational():
    assert tct.exact_rz_word(1.1) is None and jct.exact_rz_word(1.1) is None
    assert tct.exact_rx_word(0.3) is None and jct.exact_rx_word(0.3) is None


# --------------------------------------- the table and Solovay-Kitaev

def test_basic_approximations_lookup(tables):
    table, jtable = tables[0].table, tables[1].table
    assert len(table.words) > 50 and table.words == jtable.words
    t_gate = np.diag([1, np.exp(1j * np.pi / 4)])
    word, mat = table.nearest(t_gate)
    assert word == jtable.nearest(t_gate)[0]
    assert passes.hst_distance(word_matrix(word), t_gate) < 1e-12
    assert passes.hst_distance(mat, t_gate) < 1e-12
    small = tct.BasicApproximations(depth=3, max_size=20)
    assert len(small.words) == 20


def test_sk_improves_with_recursion(tables):
    sk, jsk = tables
    target = rz_np(0.42)
    w0, m0 = sk.decompose(target, recursion_degree=0)
    w1, m1 = sk.decompose(target, recursion_degree=1)
    jw1, jm1 = jsk.decompose(target, recursion_degree=1)
    assert w0 == jsk.decompose(target, recursion_degree=0)[0] and w1 == jw1
    np.testing.assert_allclose(m1, jm1, atol=1e-12)
    d0 = passes.hst_distance(word_matrix(w0), target)
    d1 = passes.hst_distance(word_matrix(w1), target)
    assert d1 < d0 and d1 < 0.03
    # the returned matrix is the returned word's
    assert passes.hst_distance(word_matrix(w1), m1) < 1e-9


def test_solovay_kitaev_circuit():
    for rows in ([('rz', 0, math.pi / 4), ('rx', 1, -math.pi / 2),
                  ('cz', (0, 1), None), ('rz', 0, math.pi)],
                 [('rz', 0, 0.7), ('h', 1, None), ('cz', (0, 1), None),
                  ('rx', 1, 1.9), ('ry', 0, -0.4), ('rz', 1, math.pi / 2)]):
        c, jc = Circuit(2), JCircuit(2)
        for row in rows:
            c.append(*row)
            jc.append(*row)
        qc, jqc = tct.solovay_kitaev(c), jct.solovay_kitaev(jc)
        assert_same_circuit(qc, jqc)
        assert set(qc.count_ops()) <= {'h', 't', 'tdg', 's', 'sdg', 'z', 'x',
                                       'cz'}
        assert passes.hst_distance(qc.unitary(), c.unitary()) < 1e-9


# ------------------------------------- greedy reduction and the polish

def test_reduce_all_1q_angles_zeroes_redundant():
    # rz(a) rz(-a) on one wire: both removable by merging
    c = Circuit(1)
    c.rz(0.7, 0).rx(0.0, 0).rz(-0.7, 0)
    target = np.eye(2, dtype=complex)
    loss = lambda u: passes.hst_distance(u, target)
    angles, wires = np.array(c.parameters), c.rotation_wires
    loss_of = trefine._circuit_loss_of_angles(c, loss)
    reduced = trefine.reduce_all_1q_angles(loss_of, angles, wires, 1e-7)
    assert loss_of(reduced) < 1e-7
    assert reduced[0] == 0.0
    jc = params.circuit_to_jax(c, JCircuit)
    jreduced = jrefine.reduce_all_1q_angles(
        jrefine._circuit_loss_of_angles(jc, loss), angles, wires, 1e-7)
    np.testing.assert_array_equal(reduced, jreduced)


def test_polish_angles_restores_precision():
    c = Circuit(2)
    c.rz(math.pi / 4, 0).cz(0, 1).rx(math.pi / 2, 1)
    target = c.unitary()
    loss = lambda u: passes.hst_distance(u, target)
    perturbed = Circuit(2)
    perturbed.rz(math.pi / 4 + 3e-3, 0).cz(0, 1).rx(math.pi / 2 - 2e-3, 1)
    loss_of = trefine._circuit_loss_of_angles(perturbed, loss)
    angles = np.array(perturbed.parameters)
    assert loss_of(angles) > 1e-6
    polished = trefine.polish_angles(loss_of, angles)
    assert loss_of(polished) < 1e-12
    np.testing.assert_allclose(polished, [math.pi / 4, math.pi / 2],
                               atol=1e-6)
    jloss_of = jrefine._circuit_loss_of_angles(
        params.circuit_to_jax(perturbed, JCircuit), loss)
    np.testing.assert_allclose(polished, jrefine.polish_angles(jloss_of,
                                                               angles),
                               atol=1e-12)
    # a frozen angle stays where it is
    frozen = trefine.polish_angles(loss_of, angles,
                                   frozen=np.array([True, False]))
    assert frozen[0] == angles[0]


# ------------------------------------------------ the refine pipelines

def _ccz_like():
    """Exact CZ + 1q with pi/4 angles; the rotations cancel through the CZ."""
    c = Circuit(2)
    c.rz(math.pi / 4 + 1e-7, 0).cz(0, 1).rz(-math.pi / 4 - 1e-7, 0)
    return c, c.unitary()


def _irrational():
    c = Circuit(2)
    c.rz(1.113, 0).cz(0, 1).rx(0.456, 1)
    return c, c.unitary()


def _noisy():
    """Angles nearly pi/4 multiples, as a converged-but-not-exact
    verification leaves them."""
    c = Circuit(2)
    c.rz(math.pi / 4 + 2e-4, 0).cz(0, 1).rx(-math.pi / 2 + 1e-4, 1)
    c.rz(math.pi + 3e-4, 1)
    exact = Circuit(2)
    exact.rz(math.pi / 4, 0).cz(0, 1).rx(-math.pi / 2, 1).rz(math.pi, 1)
    return c, exact.unitary()


def _with_cp():
    """CP gates near pi and 0 with rotations to merge across a wire."""
    c = Circuit(3)
    c.rz(0.3, 0).rx(math.pi / 2, 1).cp(math.pi - 1e-5, 0, 1).rz(-0.3, 0)
    c.cp(2e-5, 1, 2).rx(math.pi / 4 + 1e-6, 2).cz(1, 2).rz(math.pi / 8, 1)
    exact = Circuit(3)
    exact.rx(math.pi / 2, 1).cz(0, 1).rx(math.pi / 4, 2).cz(1, 2)
    exact.rz(math.pi / 8, 1)
    return c, exact.unitary()


def _golden_as_rotations():
    return passes.convert_to_zxz(golden_circuit()), \
        u_toff3.astype(np.complex128)


def _far_from_target():
    """A circuit whose loss is above every threshold: the first stage fails
    its guard and the circuit comes back as it was."""
    c = Circuit(2)
    c.rz(0.4, 0).cz(0, 1)
    return c, np.eye(4, dtype=complex)


PIPELINES = {
    'ccz_like': (_ccz_like, {}, ('Clifford+T', 0, 1e-9)),
    'irrational': (_irrational, {}, ('Clifford+T', None, 1e-5)),
    'noisy': (_noisy, {}, ('Clifford+T', 1, 1e-10)),
    'with_cp': (_with_cp, {}, ('Clifford+T', None, 1e-9)),
    'with_cp_denominator_4': (_with_cp, {'max_denominator': 4},
                              ('Clifford+T', None, 1e-5)),
    'golden_zxz': (_golden_as_rotations, {}, ('Clifford+T', 7, 1e-12)),
    'golden_zxz_api_threshold': (_golden_as_rotations,
                                 {'angle_threshold': 0.01},
                                 ('Clifford+T', 7, 1e-12)),
    'far_from_target': (_far_from_target, {}, ('Approximate', None, 1.0)),
}


@pytest.mark.parametrize('case', sorted(PIPELINES))
def test_refine_pipeline_matches_jax(case):
    build, kw, (want_type, want_t, max_loss) = PIPELINES[case]
    c, target = build()
    loss = lambda u: passes.hst_distance(u, target)
    qc, rtype, t_count, t_depth = trefine.refine(c, loss, **kw)
    jqc, jtype, jt_count, jt_depth = jrefine.refine(
        params.circuit_to_jax(c, JCircuit), loss, **kw)
    assert (rtype, t_count, t_depth) == (jtype, jt_count, jt_depth)
    assert_same_circuit(qc, jqc)
    assert abs(loss(qc.unitary()) - loss(jqc.unitary())) <= 1e-12
    assert qc.gates_count(['cz']) == jqc.gates_count(['cz'])
    assert rtype == want_type
    assert loss(qc.unitary()) <= max_loss
    if want_t is not None:
        assert t_count == want_t
    elif rtype == 'Clifford+T':
        assert t_count > 0 and 0 < t_depth <= t_count


def test_refine_keeps_the_input_and_reports_failures(capsys):
    c, target = _far_from_target()
    before = params.circuit_rows(c)
    loss = lambda u: passes.hst_distance(u, target)
    qc, rtype, t_count, t_depth = trefine.refine(c, loss, verbose=True)
    assert (rtype, t_count, t_depth) == ('Approximate', None, None)
    assert 'above threshold' in capsys.readouterr().out
    assert params.circuit_rows(c) == before
    assert params.circuit_rows(qc) == before


def test_squeeze_to_dyadic_matches_jax():
    """A planted cross-wire pair: rx(theta) on q0 before a SWAP and
    rx(pi/8 - theta) on q1 after it is rx(pi/8) on q1 times SWAP for any
    theta; the same-wire reducer cannot fold them."""
    theta = 0.3
    rows = [('rx', 0, theta), ('cx', (0, 1), None), ('cx', (1, 0), None),
            ('cx', (0, 1), None), ('rx', 1, math.pi / 8 - theta)]
    qc, jqc = Circuit(2), JCircuit(2)
    for row in rows:
        qc.append(*row)
        jqc.append(*row)
    target = qc.unitary()
    loss = lambda u: passes.hst_distance(u, target)
    out, all_dyadic = trefine.squeeze_to_dyadic(qc, loss, max_denominator=8)
    jout, j_dyadic = jrefine.squeeze_to_dyadic(jqc, loss, max_denominator=8)
    assert all_dyadic and j_dyadic
    assert_same_circuit(out, jout)
    assert loss(out.unitary()) < 1e-12
    assert sorted(abs(a) for a in out.parameters) == \
        pytest.approx([0.0, math.pi / 8], abs=1e-12)


# ----------------------------------------------- the golden and the API

def test_tdepth3_toffoli3_chain_golden():
    qc = golden_circuit()
    assert qc.gates_count(['cz']) == 8
    assert qc.gates_count(['t', 'tdg']) == 7
    assert qc.gates_depth(['t', 'tdg']) == 3
    for inst in qc.instructions:
        if inst.name == 'cz':      # chain-local
            assert abs(inst.qubits[0] - inst.qubits[1]) == 1
    assert passes.hst_distance(qc.unitary(),
                               u_toff3.astype(np.complex128)) < 1e-12


def _unitaries(n, count, seed):
    rng = np.random.default_rng(seed)
    d = 2 ** n
    z = rng.normal(size=(count, d, d)) + 1j * rng.normal(size=(count, d, d))
    return np.linalg.qr(z)[0]


@pytest.mark.parametrize('kind', ['hst', 'disc', 'state', 'modulo_identity',
                                  'modulo_diagonal'])
def test_loss_spec_numpy_matches_jax(kind):
    """refine decides by thresholds on these float64 numbers."""
    n = 3
    t, u, v = _unitaries(n, 3, seed=11)
    kw = dict(target=t[:, 0] if kind == 'state' else t)
    if kind.startswith('modulo'):
        kw.update(num_qubits=n, wires=[0, 2])
    spec, jspec = tapi.LossSpec(kind, **kw), japi.LossSpec(kind, **kw)
    for m in (u, v, t):
        assert abs(spec.numpy(m) - jspec.numpy(m)) <= 1e-14
        assert trefine.host_loss_adapter(spec)(m) == spec.numpy(m)
    if not kind.startswith('modulo'):   # those compose U with the target
        assert abs(spec.numpy(t)) <= 1e-12


def test_host_loss_adapter_takes_any_callable():
    (u,) = _unitaries(2, 1, seed=5)
    fn = lambda m: np.float64(abs(m[0, 0]) ** 2)
    assert trefine.host_loss_adapter(fn)(u) == float(fn(u))
    assert isinstance(trefine.host_loss_adapter(fn)(u), float)
    custom = tapi.LossSpec('custom', fn=fn)
    assert trefine.host_loss_adapter(custom)(u) == float(fn(u))


def test_decomposition_refine_with_a_custom_numpy_loss():
    c, target = _noisy()
    spec = tapi.LossSpec('custom',
                         fn=lambda u: passes.hst_distance(u, target))
    d = tapi.Decomposition(spec, c, label='noisy')
    assert d.type == 'Approximate' and d.t_count is None
    assert 'T count' not in repr(d)
    assert d.refine() == 'Refined to Clifford+T'
    assert (d.type, d.cz_count, d.cz_depth, d.t_count, d.t_depth) == \
        ('Clifford+T', 1, 1, 1, 1)
    assert d.loss < 1e-10 and d.loss == spec.numpy(d.unitary)
    np.testing.assert_array_equal(d.unitary, d.circuit.unitary())
    assert repr(d).endswith('| T count: 1 | T depth: 1 >')
    # the same circuit through the JAX package's Decomposition, HS test
    hst = passes.hst_distance
    jd = japi.Decomposition(japi.LossSpec('hst', target=target),
                            params.circuit_to_jax(c, JCircuit), label='noisy')
    assert jd.refine() == 'Refined to Clifford+T'
    assert (jd.type, jd.cz_count, jd.t_count, jd.t_depth) == \
        (d.type, d.cz_count, d.t_count, d.t_depth)
    assert_same_circuit(d.circuit, jd.circuit)
    assert abs(hst(jd.unitary, target) - d.loss) <= 1e-12


def test_decomposition_refine_signature_and_rollback():
    import inspect
    sig = inspect.signature(tapi.Decomposition.refine)
    assert str(sig) == str(inspect.signature(japi.Decomposition.refine))
    assert sig.parameters['angle_threshold'].default == 0.01
    assert inspect.signature(trefine.refine).parameters[
        'angle_threshold'].default == 1e-3
    assert str(inspect.signature(trefine.lasso_angles)).replace(
        ', *, device=None', '') == \
        str(inspect.signature(jrefine.lasso_angles))
    c, target = _far_from_target()
    d = tapi.Decomposition(tapi.LossSpec('hst', target=target), c)
    loss = d.loss
    assert d.refine() == 'Refined to Approximate'
    assert d.t_count is None and d.t_depth is None and d.loss == loss


def test_lasso_angles_matches_jax():
    """L1 re-optimization drives a redundant pair of angles toward zero
    while the loss stays under its threshold; the same circuit through both
    packages ends at the same angles within 1e-3 (10000 float32 Adam steps
    at 0.01 on a one-qubit circuit)."""
    import jax.numpy as jnp
    import torch
    from cpflow_tpu.ops.losses import cost_HST as j_hst
    from cpflow_tpu.sim.circuit_exec import circuit_to_jax_unitary
    from cpflow_tpu_torch.ops.losses import cost_HST as t_hst
    from cpflow_tpu_torch.sim.circuit_exec import circuit_to_torch_unitary

    c = Circuit(1)
    c.rz(0.4, 0).rz(-0.4, 0).rx(math.pi / 2, 0)  # the first two cancel
    target = c.unitary().astype('complex64')
    u_func, angles, wires = circuit_to_torch_unitary(c)
    assert angles == [0.4, -0.4, math.pi / 2] and wires == [0, 0, 0]
    loss = lambda angs: t_hst(u_func(angs), target)
    best = trefine.lasso_angles(loss, np.array(angles), eps=1e-4,
                                threshold_loss=1e-5, device='cpu')
    assert float(loss(best)) < 1e-5
    assert abs(float(best[0])) + abs(float(best[1])) < 0.79

    jc = params.circuit_to_jax(c, JCircuit)
    ju_func, jangles, _ = circuit_to_jax_unitary(jc)
    jloss = lambda angs: j_hst(ju_func(angs), jnp.array(target))
    jbest = jrefine.lasso_angles(jloss, np.array(jangles), eps=1e-4,
                                 threshold_loss=1e-5)
    np.testing.assert_allclose(best.numpy(), np.asarray(jbest), atol=1e-3)
    with pytest.raises(AssertionError, match='not successful'):
        trefine.lasso_angles(lambda a: t_hst(u_func(a), target) + 1.0,
                             np.array(angles), device='cpu')

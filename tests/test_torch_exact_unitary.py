"""The port's exact cyclotomic evaluation and certificates
(cpflow_tpu_torch/circuits/exact_unitary.py) against the JAX package's:
every ring entry of every matrix equal (arbitrary-precision integers), the
float snapshot within 1e-12 of the numpy unitary, and the certificates with
their negative controls."""

import math

import numpy as np
import pytest

from cpflow_tpu.circuits import exact_unitary as jex
from cpflow_tpu.circuits.ir import Circuit as JCircuit
from cpflow_tpu_torch import params
from cpflow_tpu_torch.circuits import exact_unitary as ex
from cpflow_tpu_torch.circuits.ir import (FIXED_GATES, Circuit,
                                          param_gate_matrix)
from cpflow_tpu_torch.circuits.passes import remove_zero_rgates
from cpflow_tpu_torch.circuits.refine import squeeze_to_dyadic
from test_torch_refine import golden_circuit


def assert_same_exact(u, j):
    """Entry for entry: the same integers, exponent and ring degree."""
    assert (u.e, u.m, u.dim) == (j.e, j.m, j.dim)
    assert u.entries == j.entries


def dyadic_rows(seed, n=3, length=25, q=16):
    """A random circuit whose angles are all pi p / q."""
    rng = np.random.default_rng(seed)
    fixed = ['h', 'x', 'z', 's', 'sdg', 't', 'tdg']
    rows = []
    for _ in range(length):
        kind = rng.integers(0, 4)
        w = [int(x) for x in rng.choice(n, size=2, replace=False)]
        angle = math.pi * int(rng.integers(-2 * q, 2 * q + 1)) / q
        if kind == 0:
            rows.append((['rx', 'ry', 'rz'][rng.integers(0, 3)], (w[0],),
                         angle, None))
        elif kind == 1:
            rows.append((fixed[rng.integers(0, len(fixed))], (w[0],), None,
                         None))
        elif kind == 2:
            rows.append((['cz', 'cx'][rng.integers(0, 2)], tuple(w), None,
                         None))
        else:
            rows.append(('cp', tuple(w), angle, None))
    return rows


def test_ring_roots_of_unity():
    m = 16
    assert ex._zpow(m, m)[0] == -1 and ex._zpow(2 * m, m)[0] == 1
    for k in (0, 1, 5, 11, 15):
        v = ex._zpow(k, m)
        assert v == jex._zpow(k, m)
        prod = ex._vmul(ex._vconj(v, m), v, m)
        assert prod == jex._vmul(jex._vconj(v, m), v, m)
        assert prod[0] == 1 and all(c == 0 for c in prod[1:])


@pytest.mark.parametrize('name,param', [
    ('rz', math.pi / 8), ('rz', -3 * math.pi / 4), ('rx', math.pi / 2),
    ('rx', 5 * math.pi / 8), ('ry', math.pi / 4), ('h', None), ('t', None),
    ('s', None), ('x', None), ('cz', None), ('cx', None),
    ('cp', 3 * math.pi / 8)])
def test_exact_gate(name, param):
    q = 8
    entries, e = ex.exact_gate(name, param, q)
    jentries, je = jex.exact_gate(name, param, q)
    assert entries == jentries and e == je
    got = ex.ExactMatrix(entries, e, 2 * q).to_complex()
    want = (param_gate_matrix(name, param) if param is not None
            else FIXED_GATES[name])
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize('seed', range(5))
def test_exact_unitary_of_dyadic_circuits(seed):
    rows = dyadic_rows(seed)
    qc = params.circuit_from_jax(rows, 3)
    jqc = params.circuit_to_jax(qc, JCircuit)
    u, ju = ex.exact_unitary(qc, q=16), jex.exact_unitary(jqc, q=16)
    assert_same_exact(u, ju)
    np.testing.assert_allclose(u.to_complex(), qc.unitary(), atol=1e-12)
    assert ex.hst_equal_certificate(u, u)
    assert_same_exact(ex.matmul_exact(u, u), jex.matmul_exact(ju, ju))
    doubled = ex.exact_unitary(qc.copy().compose(qc), q=16)
    assert ex.hst_equal_certificate(ex.matmul_exact(u, u), doubled)
    # one more T gate breaks the equality, however close
    other = ex.exact_unitary(qc.copy().rz(math.pi / 16, 0), q=16)
    assert not ex.hst_equal_certificate(u, other)
    assert not jex.hst_equal_certificate(ju, jex.exact_unitary(
        params.circuit_to_jax(qc.copy().rz(math.pi / 16, 0), JCircuit), 16))


def test_angle_off_grid_raises():
    for mod, cls in ((ex, Circuit), (jex, JCircuit)):
        with pytest.raises(mod.NotExactError):
            mod.exact_unitary(cls(1).rz(0.3, 0), q=32)
        assert mod.angle_fraction(math.pi * 3 / 8, 32) == \
            ex.angle_fraction(math.pi * 3 / 8, 32)


def test_golden_toffoli_proved_exact():
    qc = golden_circuit()
    u = ex.exact_unitary(qc, q=4)
    assert_same_exact(u, jex.exact_unitary(params.circuit_to_jax(qc, JCircuit),
                                           q=4))
    assert ex.toffoli_permutation(3) == jex.toffoli_permutation(3)
    t = ex.ExactMatrix.from_int_matrix(ex.toffoli_permutation(3), m=8)
    assert ex.hst_equal_certificate(u, t)
    # a hand-built CCZ between Hadamards, from cp gates
    qc2 = Circuit(3)
    qc2.h(2).cp(math.pi / 2, 1, 2).cx(0, 1).cp(-math.pi / 2, 1, 2).cx(0, 1)
    qc2.cp(math.pi / 2, 0, 2).h(2)
    assert ex.hst_equal_certificate(ex.exact_unitary(qc2, q=4), t)


def test_hst_certificate_ignores_global_phase():
    qc = Circuit(1).rz(math.pi / 4, 0).rz(-math.pi / 4, 0)
    eye = ex.ExactMatrix.from_int_matrix([[1, 0], [0, 1]], m=16)
    assert ex.hst_equal_certificate(ex.exact_unitary(qc, q=8), eye)
    near = ex.exact_unitary(Circuit(1).rz(math.pi / 16, 0), q=16)
    eye32 = ex.ExactMatrix.from_int_matrix([[1, 0], [0, 1]], m=32)
    assert not ex.hst_equal_certificate(near, eye32)


def test_diagonal_certificate():
    m = 8
    for mod in (ex, jex):
        d = mod.ExactMatrix([[mod._zpow(0, m), mod._zero(m)],
                             [mod._zero(m), mod._zpow(4, m)]], 0, m)
        assert mod.diagonal_certificate(d)
        x = mod.ExactMatrix.from_int_matrix([[0, 1], [1, 0]], m=m)
        assert not mod.diagonal_certificate(x)
        bad = mod.ExactMatrix.from_int_matrix([[1, 0], [0, 2]], m=m)
        assert not mod.diagonal_certificate(bad)


def test_controlled_sqrt_x_squares_to_toffoli():
    c = ex.controlled_sqrt_x(3, q=4)
    assert_same_exact(c, jex.controlled_sqrt_x(3, q=4))
    t = ex.ExactMatrix.from_int_matrix(ex.toffoli_permutation(3), m=8)
    assert ex.hst_equal_certificate(ex.matmul_exact(c, c), t)


def _ghz_circuit(n):
    qc = Circuit(n).h(0)
    for i in range(n - 1):
        qc.cx(i, i + 1)
    return qc


@pytest.mark.parametrize('n', [2, 3, 4])
def test_ghz_state_certificate(n):
    u = ex.exact_unitary(_ghz_circuit(n), q=2)
    assert ex.ghz_state_certificate(u)
    assert jex.ghz_state_certificate(jex.exact_unitary(
        params.circuit_to_jax(_ghz_circuit(n), JCircuit), q=2))
    # a global phase upstream changes nothing
    phased = Circuit(n).rz(math.pi / 2, 0).compose(_ghz_circuit(n))
    assert ex.ghz_state_certificate(ex.exact_unitary(phased, q=2))
    # the wrong relative sign, a product state, and a ring without sqrt 2
    assert not ex.ghz_state_certificate(
        ex.exact_unitary(_ghz_circuit(n).z(0), q=2))
    assert not ex.ghz_state_certificate(ex.exact_unitary(Circuit(n).h(0), 2))
    assert not ex.ghz_state_certificate(
        ex.exact_unitary(Circuit(2).cz(0, 1), q=1))


def test_squeezed_circuit_proved_exact():
    """squeeze_to_dyadic drives a cross-wire pair of free angles onto the
    grid; the result is then proved equal to rx(pi/8) on q1 times SWAP."""
    theta = 0.3
    qc = Circuit(2).rx(theta, 0).cx(0, 1).cx(1, 0).cx(0, 1)
    qc.rx(math.pi / 8 - theta, 1)
    target = qc.unitary()
    loss = lambda u: float(1 - abs((u * target.conj()).sum()) ** 2 / 16)
    out, all_dyadic = squeeze_to_dyadic(qc, loss, max_denominator=8)
    assert all_dyadic
    tc = Circuit(2).cx(0, 1).cx(1, 0).cx(0, 1).rx(math.pi / 8, 1)
    assert ex.hst_equal_certificate(
        ex.exact_unitary(remove_zero_rgates(out), q=8),
        ex.exact_unitary(tc, q=8))

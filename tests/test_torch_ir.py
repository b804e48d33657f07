"""The port's circuit IR (cpflow_tpu_torch/circuits/ir.py) against the JAX
package's (cpflow_tpu/circuits/ir.py) on seeded random circuits: the same
rows built in both classes must give the same instructions, unitary,
inverse, composition, parameters, depths, QASM text, parsed circuit and
drawing. Both are float64 numpy on the host, so matrices agree within 1e-12
and everything else exactly."""

import math

import numpy as np
import pytest

from cpflow_tpu.api import Ansatz as JAnsatz
from cpflow_tpu.circuits import ir as jir
from cpflow_tpu_torch import params
from cpflow_tpu_torch.api import Ansatz
from cpflow_tpu_torch.circuits import ir as tir

ROTATIONS = ['rx', 'ry', 'rz']
FIXED_1Q = ['id', 'x', 'y', 'z', 'h', 's', 'sdg', 't', 'tdg']
FIXED_2Q = ['cx', 'cz', 'swap']


def random_rows(seed, n=3, length=30, opaque=False):
    """Rows (name, qubits, param, matrix) of a random circuit drawing from
    every gate kind: rotations, cp, the fixed 1q and 2q gates and, with
    opaque=True, 1q 'u' gates that carry a matrix."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(length):
        kind = rng.integers(0, 5 if opaque else 4)
        q = [int(x) for x in rng.choice(n, size=2, replace=False)]
        if kind == 0:
            rows.append((ROTATIONS[rng.integers(0, 3)], (q[0],),
                         float(rng.uniform(-math.pi, math.pi)), None))
        elif kind == 1:
            rows.append(('cp', tuple(q),
                         float(rng.uniform(-math.pi, math.pi)), None))
        elif kind == 2:
            rows.append((FIXED_1Q[rng.integers(0, len(FIXED_1Q))], (q[0],),
                         None, None))
        elif kind == 3:
            rows.append((FIXED_2Q[rng.integers(0, len(FIXED_2Q))], tuple(q),
                         None, None))
        else:
            z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            rows.append(('u', (q[0],), None, np.linalg.qr(z)[0]))
    return rows


def both(rows, n=3):
    """The rows as (port circuit, JAX-package circuit)."""
    jc = jir.Circuit(n)
    for row in rows:
        jc.append(*row)
    return params.circuit_from_jax(rows, n), jc


def assert_same_circuit(tc, jc, atol=1e-12):
    assert tc.num_qubits == jc.num_qubits
    assert len(tc.instructions) == len(jc.instructions)
    for a, b in zip(tc.instructions, jc.instructions):
        assert a.name == b.name and a.qubits == b.qubits
        assert (a.param is None) == (b.param is None)
        if a.param is not None:
            assert abs(a.param - b.param) <= atol
        assert (a.matrix is None) == (b.matrix is None)
        if a.matrix is not None:
            np.testing.assert_allclose(a.matrix, b.matrix, atol=atol)


SEEDS = range(6)


def test_fixed_gates_and_rotations_are_the_same_tables():
    assert set(tir.FIXED_GATES) == set(jir.FIXED_GATES)
    # every gate the Clifford+T words use
    assert {'h', 's', 'sdg', 't', 'tdg', 'x', 'z'} <= set(tir.FIXED_GATES)
    for name, m in tir.FIXED_GATES.items():
        np.testing.assert_array_equal(m, jir.FIXED_GATES[name])
    assert tir.ROTATION_NAMES == jir.ROTATION_NAMES
    for name in ('rx', 'ry', 'rz', 'cp'):
        np.testing.assert_array_equal(tir.param_gate_matrix(name, 0.37),
                                      jir.param_gate_matrix(name, 0.37))
    for mod in (tir, jir):
        with pytest.raises(ValueError):
            mod.param_gate_matrix('u', 0.1)


@pytest.mark.parametrize('seed', SEEDS)
def test_unitary_counts_and_depths(seed):
    tc, jc = both(random_rows(seed, opaque=True))
    assert_same_circuit(tc, jc)
    np.testing.assert_allclose(tc.unitary(), jc.unitary(), atol=1e-12)
    assert tc.count_ops() == jc.count_ops()
    assert tc.depth() == jc.depth()
    for names in (['cz'], ['t', 'tdg'], ['cx', 'cz', 'cp', 'swap'], None):
        assert tc.gates_depth(names) == jc.gates_depth(names)
    assert tc.gates_count(['cz', 'cp']) == jc.gates_count(['cz', 'cp'])
    assert repr(tc) == repr(jc)


@pytest.mark.parametrize('seed', SEEDS)
def test_inverse(seed):
    tc, jc = both(random_rows(seed, opaque=True))
    assert_same_circuit(tc.inverse(), jc.inverse())
    u = tc.copy().compose(tc.inverse()).unitary()
    np.testing.assert_allclose(u, np.eye(8), atol=1e-12)


def test_inverse_refuses_an_unknown_gate():
    for mod in (tir, jir):
        qc = mod.Circuit(1, [mod.Instruction('mystery', (0,))])
        with pytest.raises(ValueError, match='cannot invert'):
            qc.inverse()


@pytest.mark.parametrize('seed', SEEDS)
def test_compose_with_and_without_a_qubit_map(seed):
    ta, ja = both(random_rows(seed, n=4), n=4)
    tb, jb = both(random_rows(100 + seed, n=2, length=8), n=2)
    assert_same_circuit(ta.copy().compose(ta), ja.copy().compose(ja))
    tm, jm = ta.copy().compose(tb, [3, 1]), ja.copy().compose(jb, [3, 1])
    assert_same_circuit(tm, jm)
    np.testing.assert_allclose(tm.unitary(), jm.unitary(), atol=1e-12)


@pytest.mark.parametrize('seed', SEEDS)
def test_parameters_and_with_rotation_angles(seed):
    tc, jc = both(random_rows(seed))
    assert tc.parameters == jc.parameters
    assert tc.rotation_wires == jc.rotation_wires
    assert len(tc.parameters) == tc.gates_count(list(tir.ROTATION_NAMES))
    new = np.random.default_rng(seed).uniform(-3, 3, len(tc.parameters))
    tn, jn = tc.with_rotation_angles(new), jc.with_rotation_angles(new)
    assert_same_circuit(tn, jn)
    assert tn.parameters == list(new) and tc.parameters == jc.parameters
    np.testing.assert_allclose(tn.unitary(), jn.unitary(), atol=1e-12)


@pytest.mark.parametrize('seed', SEEDS)
def test_qasm_round_trip(seed):
    tc, jc = both(random_rows(seed))
    text = tc.to_qasm()
    assert text == jc.to_qasm()
    back, jback = tir.parse_qasm(text), jir.parse_qasm(text)
    assert_same_circuit(back, jback, atol=0.0)
    # repr() of a float round-trips exactly
    assert_same_circuit(back, jc, atol=0.0)
    assert_same_circuit(tir.Circuit.from_qasm(text), jc, atol=0.0)


def test_qasm_file_expressions_registers_and_errors(tmp_path):
    text = '\n'.join([
        'OPENQASM 2.0;', 'include "qelib1.inc";', 'qreg a[2];', 'qreg b[1];',
        'creg c[3];', 'h a[0]; // a comment', 'cx a[1],b[0];',
        'rz(pi/4) b[0];', 'rx(-3*pi/8 + 0.5) a[1];', 'barrier a[0];',
        'measure a[0] -> c[0];', 'T a[0];'])
    path = tmp_path / 'c.qasm'
    path.write_text(text)
    tc = tir.Circuit.from_qasm_file(str(path))
    jc = jir.Circuit.from_qasm_file(str(path))
    assert_same_circuit(tc, jc, atol=0.0)
    assert [i.name for i in tc.instructions] == ['h', 'cx', 'rz', 'rx', 't']
    assert tc.instructions[1].qubits == (1, 2)
    assert tc.instructions[3].param == -3 * math.pi / 8 + 0.5
    for mod in (tir, jir):
        # a checked walk of the expression, never eval()
        with pytest.raises(ValueError, match='unsupported qasm expression'):
            mod.parse_qasm('qreg q[1];\nrz(os.getpid) q[0];')
        with pytest.raises(ValueError, match='unsupported qasm expression'):
            mod.parse_qasm('qreg q[1];\nrz(2**3) q[0];')
        with pytest.raises(ValueError, match='cannot parse'):
            mod.parse_qasm('qreg q[1];\n!!;')
        with pytest.raises(ValueError, match='opaque'):
            mod.Circuit(1).append('u', 0, matrix=np.eye(2)).to_qasm()


@pytest.mark.parametrize('seed', SEEDS)
def test_draw(seed):
    tc, jc = both(random_rows(seed, length=12))
    assert tc.draw() == jc.draw()
    assert tc.draw(output='mpl') == tc.draw()
    assert len(tc.draw().splitlines()) == 3


def test_draw_prints_an_ansatz_placeholders():
    placements = {'free': [[0, 1], [1, 2]]}
    text = Ansatz(3, 'cp', dict(placements)).circuit().draw()
    assert text == JAnsatz(3, 'cp', dict(placements)).circuit().draw()
    assert 'rz(a_0)' in text and 'cp(a_15)*' in text and 'cp(a_15)o' in text
    assert tir.Circuit(2).draw() == jir.Circuit(2).draw()


def test_gate_shortcuts_and_append_checks():
    tc, jc = tir.Circuit(3), jir.Circuit(3)
    for qc in (tc, jc):
        qc.rx(0.1, 0).ry(0.2, 1).rz(0.3, 2).cp(0.4, 0, 1).cz(1, 2).cx(2, 0)
        qc.h(0).x(1).z(2).s(0).sdg(1).t(2).tdg(0)
    assert_same_circuit(tc, jc, atol=0.0)
    np.testing.assert_allclose(tc.unitary(), jc.unitary(), atol=1e-12)
    for mod in (tir, jir):
        with pytest.raises(ValueError, match='out of range'):
            mod.Circuit(2).cz(0, 2)
        with pytest.raises(ValueError, match='duplicate'):
            mod.Circuit(2).cz(1, 1)


@pytest.mark.parametrize('seed', SEEDS)
def test_circuits_carried_between_the_packages(seed):
    rows = random_rows(seed, opaque=True)
    tc, jc = both(rows)
    assert_same_circuit(params.circuit_from_jax(jc), jc, atol=0.0)
    back = params.circuit_to_jax(tc, jir.Circuit)
    assert isinstance(back, jir.Circuit)
    assert_same_circuit(tc, back, atol=0.0)
    # the rows are copies: editing one circuit leaves the other as it was
    first = next(i for i in back.instructions if i.matrix is not None)
    first.matrix[0, 0] = 7.0
    assert_same_circuit(tc, jc, atol=0.0)
    assert params.circuit_rows(tc)[0][:2] == (rows[0][0], rows[0][1])

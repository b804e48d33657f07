"""The port's qiskit adapters (circuits/interop.py) against the JAX
package's. Neither machine has qiskit, so both run against a minimal mock
of the slice of qiskit's API they touch (QuantumCircuit gate methods,
.data items with .operation/.qubits, find_bit), a copy of the mock in
tests/test_interop.py: both packages must emit the same gate calls for
every committed artifact circuit, from_qiskit must round-trip them
exactly, and without qiskit both raise the same ImportError."""

import glob
import importlib
import json
import math
import os
import sys
import types

import numpy as np
import pytest

from cpflow_tpu_torch.circuits import interop
from cpflow_tpu_torch.circuits.ir import Circuit

_ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'benchmarks', 'artifacts')

try:
    import qiskit  # noqa: F401
    HAVE_QISKIT = True
except ImportError:
    HAVE_QISKIT = False


# ---------------------------------------------------------------- mock ---

class _MockBit:
    def __init__(self, index):
        self.index = index


class _MockOp:
    def __init__(self, name, params):
        self.name = name
        self.params = list(params)


class _MockItem:
    def __init__(self, op, qubits):
        self.operation = op
        self.qubits = qubits


class _MockQuantumCircuit:
    """The exact API slice the adapters touch on qiskit.QuantumCircuit."""

    def __init__(self, num_qubits):
        self.num_qubits = num_qubits
        self._bits = [_MockBit(i) for i in range(num_qubits)]
        self.data = []

    def _add(self, name, params, wires):
        self.data.append(_MockItem(_MockOp(name, params),
                                   [self._bits[w] for w in wires]))

    def find_bit(self, q):
        return types.SimpleNamespace(index=q.index)

    def __getattr__(self, name):
        if name.startswith('_'):
            raise AttributeError(name)

        def method(*args):
            params = [a for a in args if isinstance(a, float)]
            wires = [a for a in args if isinstance(a, int)]
            self._add(name, params, wires)
        return method


@pytest.fixture
def both(monkeypatch):
    """(the port's interop, the JAX package's) with qiskit importable: the
    mock module unless qiskit is installed."""
    import cpflow_tpu.circuits.interop as jax_interop
    if not HAVE_QISKIT:
        mock = types.ModuleType('qiskit')
        mock.QuantumCircuit = _MockQuantumCircuit
        monkeypatch.setitem(sys.modules, 'qiskit', mock)
        importlib.reload(jax_interop)
    yield interop, jax_interop
    if not HAVE_QISKIT:
        monkeypatch.delitem(sys.modules, 'qiskit')
        importlib.reload(jax_interop)


def _calls(qc):
    return [(item.operation.name, list(item.operation.params),
             [qc.find_bit(q).index for q in item.qubits]) for item in qc.data]


def _rows(circ):
    return [(i.name, tuple(i.qubits), i.param) for i in circ.instructions]


def _sample_circuit(cls):
    qc = cls(3)
    qc.h(0)
    qc.rz(0.25, 1)
    qc.rx(-1.5, 2)
    qc.cz(0, 1)
    qc.cx(1, 2)
    qc.cp(math.pi / 2, 0, 2)
    qc.append('t', (1,), None)
    qc.append('sdg', (2,), None)
    return qc


def _artifacts():
    from benchmarks.proof_ledger import LEDGER_FILES
    out = []
    for p in sorted(glob.glob(os.path.join(_ART, '*.json'))):
        if os.path.basename(p)[:-5] in LEDGER_FILES:
            continue
        meta = json.load(open(p))
        out.append((meta['label'], meta['num_qubits'],
                    [(r['name'], tuple(r['qubits']), r.get('param'))
                     for r in meta['instructions']]))
    return out


def test_same_calls_and_round_trip_on_the_artifacts(both):
    from cpflow_tpu.circuits.ir import Circuit as JaxCircuit
    ours, theirs = both
    cases = _artifacts()
    assert len(cases) > 10
    for label, n, rows in cases:
        circ, jcirc = Circuit(n), JaxCircuit(n)
        for name, qubits, param in rows:
            circ.append(name, qubits, param)
            jcirc.append(name, qubits, param)
        q, jq = ours.to_qiskit(circ), theirs.to_qiskit(jcirc)
        assert _calls(q) == _calls(jq), label
        assert _rows(ours.from_qiskit(q)) == _rows(circ), label
        assert _rows(ours.from_qiskit(q)) == _rows(theirs.from_qiskit(jq))


def test_round_trip_of_a_mixed_circuit(both):
    ours, theirs = both
    from cpflow_tpu.circuits.ir import Circuit as JaxCircuit
    src = _sample_circuit(Circuit)
    q = ours.to_qiskit(src)
    assert _calls(q) == _calls(theirs.to_qiskit(_sample_circuit(JaxCircuit)))
    back = ours.from_qiskit(q)
    assert back.num_qubits == 3 and _rows(back) == _rows(src)
    np.testing.assert_allclose(back.unitary(), src.unitary(), atol=0)


def test_unconvertible_gate_raises(both):
    ours, _ = both
    qc = Circuit(1)
    qc.append('u_custom', (0,), None, matrix=np.eye(2, dtype=complex))
    with pytest.raises(ValueError, match='u_custom'):
        ours.to_qiskit(qc)


def test_without_qiskit_both_raise_the_same_import_error():
    if HAVE_QISKIT:
        pytest.skip('qiskit installed here')
    import cpflow_tpu.circuits.interop as jax_interop
    from cpflow_tpu.circuits.ir import Circuit as JaxCircuit
    messages = []
    for module, circ in ((interop, Circuit(2)), (jax_interop, JaxCircuit(2))):
        with pytest.raises(ImportError) as err:
            module.to_qiskit(circ)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert 'works without it' in messages[0]
    with pytest.raises(ImportError, match='works without it'):
        interop.from_qiskit(_MockQuantumCircuit(1))

"""Optional qiskit interop (counterpart of cpflow_tpu/circuits/interop.py).

The port needs no qiskit; users who want their results as qiskit circuits
(drawing, transpiling, running) convert them here. qiskit is imported only
when a conversion is asked for, and a missing qiskit raises ImportError.
"""

from __future__ import annotations

from cpflow_tpu_torch.circuits.ir import Circuit, ROTATION_NAMES

_FIXED_1Q = ('h', 'x', 'y', 'z', 's', 'sdg', 't', 'tdg', 'id')


def _qiskit():
    try:
        import qiskit
    except ImportError:
        raise ImportError(
            'qiskit is not installed; cpflow_tpu works without it — this '
            'adapter only converts circuits for external tooling.') from None
    return qiskit


def to_qiskit(circ: Circuit):
    """IR circuit -> qiskit.QuantumCircuit (same gate order and wires).

    The endianness contract: Circuit.unitary() equals qiskit's
    Operator(qc.reverse_bits()).data for the converted circuit."""
    qc = _qiskit().QuantumCircuit(circ.num_qubits)
    for inst in circ.instructions:
        name, qs, p = inst.name, list(inst.qubits), inst.param
        if name in ROTATION_NAMES:
            getattr(qc, name)(p, qs[0])
        elif name == 'cp':
            qc.cp(p, qs[0], qs[1])
        elif name in ('cz', 'cx', 'swap'):
            getattr(qc, name)(qs[0], qs[1])
        elif name in _FIXED_1Q:
            getattr(qc, name)(qs[0])
        else:
            raise ValueError(f'cannot convert gate {name!r} to qiskit')
    return qc


def from_qiskit(qc) -> Circuit:
    """qiskit.QuantumCircuit -> IR circuit (supported gate set only)."""
    _qiskit()
    circ = Circuit(qc.num_qubits)
    for item in qc.data:
        gate = item[0] if isinstance(item, tuple) else item.operation
        qargs = item[1] if isinstance(item, tuple) else item.qubits
        wires = [qc.find_bit(q).index for q in qargs]
        param = float(gate.params[0]) if gate.params else None
        circ.append(gate.name.lower(), wires, param)
    return circ

"""Lightweight circuit IR, host numpy only.

Carried over from cpflow_tpu/circuits/ir.py: that package imports JAX on
import, and the port must run where JAX is not installed. Only what the
static path uses is here (rendering a CP ansatz, counting CZ, the float64
unitary); the QASM parser and the text drawing stay in the JAX package.

Big-endian convention throughout (qubit 0 = most significant bit);
instruction order = application order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

_SQ2 = 1.0 / math.sqrt(2.0)

# Fixed (non-parametric) gate matrices, big-endian for 2q gates.
FIXED_GATES = {
    'id': np.eye(2, dtype=complex),
    'x': np.array([[0, 1], [1, 0]], dtype=complex),
    'y': np.array([[0, -1j], [1j, 0]], dtype=complex),
    'z': np.diag([1, -1]).astype(complex),
    'h': np.array([[_SQ2, _SQ2], [_SQ2, -_SQ2]], dtype=complex),
    's': np.diag([1, 1j]).astype(complex),
    'sdg': np.diag([1, -1j]).astype(complex),
    't': np.diag([1, np.exp(1j * np.pi / 4)]).astype(complex),
    'tdg': np.diag([1, np.exp(-1j * np.pi / 4)]).astype(complex),
    'cx': np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
                   dtype=complex),
    'cz': np.diag([1, 1, 1, -1]).astype(complex),
    'swap': np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                     dtype=complex),
}

ROTATION_NAMES = ('rx', 'ry', 'rz')

_PAULIS = {
    'rx': FIXED_GATES['x'],
    'ry': FIXED_GATES['y'],
    'rz': FIXED_GATES['z'],
}


def param_gate_matrix(name: str, param: float) -> np.ndarray:
    """Matrix of a parametric gate at a concrete angle (host numpy)."""
    if name in ROTATION_NAMES:
        p = _PAULIS[name]
        return math.cos(param / 2) * np.eye(2) - 1j * math.sin(param / 2) * p
    if name == 'cp':
        return np.diag([1, 1, 1, np.exp(1j * param)]).astype(complex)
    raise ValueError(f"unknown parametric gate {name!r}")


@dataclasses.dataclass
class Instruction:
    name: str
    qubits: Tuple[int, ...]
    param: Optional[float] = None
    matrix: Optional[np.ndarray] = None  # for opaque 1q 'u' gates

    @property
    def num_qubits(self) -> int:
        return len(self.qubits)

    def gate_matrix(self) -> np.ndarray:
        if self.matrix is not None:
            return self.matrix
        if self.param is not None:
            return param_gate_matrix(self.name, self.param)
        return FIXED_GATES[self.name]

    def copy(self) -> 'Instruction':
        return Instruction(self.name, tuple(self.qubits), self.param,
                           None if self.matrix is None else self.matrix.copy())


def _embed_apply(full: np.ndarray, gate: np.ndarray, qubits: Sequence[int],
                 n: int) -> np.ndarray:
    """Left-multiply `gate` (2^k x 2^k) acting on `qubits` into `full`
    (2^n x 2^n), via tensor contraction on the output legs."""
    k = len(qubits)
    t = full.reshape([2] * n + [2 ** n])
    g = gate.reshape([2] * (2 * k))
    moved = np.tensordot(g, t, axes=[list(range(k, 2 * k)), list(qubits)])
    # result axes: gate-out legs first, then the remaining legs in order;
    # permute the gate legs back into their qubit positions.
    remaining = [q for q in range(n) if q not in qubits]
    src_axis_of = [0] * (n + 1)
    for i, q in enumerate(qubits):
        src_axis_of[q] = i
    for i, q in enumerate(remaining):
        src_axis_of[q] = k + i
    src_axis_of[n] = n
    return np.transpose(moved, axes=src_axis_of).reshape(2 ** n, 2 ** n)


class Circuit:
    """A flat list of gate instructions on `num_qubits` qubits."""

    def __init__(self, num_qubits: int,
                 instructions: Optional[Iterable[Instruction]] = None):
        self.num_qubits = num_qubits
        self.instructions: List[Instruction] = list(instructions or [])

    def append(self, name: str, qubits, param: Optional[float] = None,
               matrix: Optional[np.ndarray] = None) -> 'Circuit':
        if isinstance(qubits, int):
            qubits = (qubits,)
        qs = tuple(int(q) for q in qubits)
        if any(q < 0 or q >= self.num_qubits for q in qs):
            raise ValueError(f"qubits {qs} out of range for n={self.num_qubits}")
        if len(set(qs)) != len(qs):
            raise ValueError(f"duplicate qubits in {qs}")
        self.instructions.append(Instruction(name, qs, param, matrix))
        return self

    def copy(self) -> 'Circuit':
        return Circuit(self.num_qubits, [i.copy() for i in self.instructions])

    def unitary(self, dtype=np.complex128) -> np.ndarray:
        """2^n x 2^n matrix, big-endian, float64 on host."""
        n = self.num_qubits
        u = np.eye(2 ** n, dtype=dtype)
        for inst in self.instructions:
            u = _embed_apply(u, inst.gate_matrix().astype(dtype), inst.qubits, n)
        return u

    def count_ops(self) -> dict:
        ops: dict = {}
        for inst in self.instructions:
            ops[inst.name] = ops.get(inst.name, 0) + 1
        return ops

    def gates_count(self, names: Sequence[str]) -> int:
        """Total count of the named gates."""
        ops = self.count_ops()
        return sum(ops.get(name, 0) for name in names)

    def gates_depth(self, names: Optional[Sequence[str]] = None) -> int:
        """Circuit depth counting only the named gates (all if None)."""
        track = [0] * self.num_qubits
        for inst in self.instructions:
            counted = names is None or inst.name in names
            d = max(track[q] for q in inst.qubits) + (1 if counted else 0)
            for q in inst.qubits:
                track[q] = d
        return max(track) if track else 0

    def depth(self) -> int:
        return self.gates_depth(None)

    def __repr__(self):
        ops = ', '.join(f'{k}:{v}' for k, v in sorted(self.count_ops().items()))
        return f'<Circuit n={self.num_qubits} depth={self.depth()} [{ops}]>'

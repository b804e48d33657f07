"""Lightweight circuit IR, host numpy only (replaces the reference's qiskit
dependency; counterpart of cpflow_tpu/circuits/ir.py, kept as a copy because
that package imports JAX on import and the port must run without it).

The reference threads qiskit ``QuantumCircuit`` objects through its host-side
pipeline: Ansatz rendering (main.py:193-222), CP->CZ projection and ZXZ
conversion (exact_decompositions.py:42-190), gate counts/depths
(exact_decompositions.py:280-290), and unitary evaluation via
``Operator(qc.reverse_bits()).data``. qiskit is not available here — and a
full dependency for a list-of-gates plus a 64x64 matrix would be overkill —
so this module provides the minimal IR with identical observable semantics:

  * big-endian convention throughout (qubit 0 = most significant bit), which
    equals the reference's ``reverse_bits()`` readout;
  * instruction order = application order; ``unitary()`` is evaluated on the
    host in float64 numpy (refinement checks run at 1e-5/1e-6 thresholds,
    below what the float32 sweeps resolve).
"""

from __future__ import annotations

import dataclasses
import math
import re
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
    if name == 'u':  # generic 1q unitary stored as flattened matrix param
        raise ValueError("'u' gates carry a matrix, use inst.matrix")
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
    src_axis_of = [0] * (n + 1)   # which axis of `moved` belongs at position q
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

    # -- construction -------------------------------------------------------

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

    def rx(self, a, q): return self.append('rx', q, float(a))
    def ry(self, a, q): return self.append('ry', q, float(a))
    def rz(self, a, q): return self.append('rz', q, float(a))
    def cp(self, a, q0, q1): return self.append('cp', (q0, q1), float(a))
    def cz(self, q0, q1): return self.append('cz', (q0, q1))
    def cx(self, q0, q1): return self.append('cx', (q0, q1))
    def h(self, q): return self.append('h', q)
    def x(self, q): return self.append('x', q)
    def z(self, q): return self.append('z', q)
    def s(self, q): return self.append('s', q)
    def sdg(self, q): return self.append('sdg', q)
    def t(self, q): return self.append('t', q)
    def tdg(self, q): return self.append('tdg', q)

    def compose(self, other: 'Circuit', qubits: Optional[Sequence[int]] = None
                ) -> 'Circuit':
        """Append `other`'s instructions, optionally remapping its qubits."""
        if qubits is None:
            qubits = list(range(other.num_qubits))
        for inst in other.instructions:
            mapped = tuple(qubits[q] for q in inst.qubits)
            self.append(inst.name, mapped, inst.param, inst.matrix)
        return self

    def copy(self) -> 'Circuit':
        return Circuit(self.num_qubits, [i.copy() for i in self.instructions])

    _INVERSE_FIXED = {'h': 'h', 'x': 'x', 'y': 'y', 'z': 'z', 'cx': 'cx',
                      'cz': 'cz', 'swap': 'swap', 'id': 'id',
                      's': 'sdg', 'sdg': 's', 't': 'tdg', 'tdg': 't'}

    def inverse(self) -> 'Circuit':
        """Circuit implementing the inverse unitary: reversed instruction
        order with each gate inverted (rotations/CP negate their angle,
        s/t swap with their daggers, matrix gates conjugate-transpose)."""
        inv = Circuit(self.num_qubits)
        for inst in reversed(self.instructions):
            if inst.name in ROTATION_NAMES or inst.name == 'cp':
                inv.append(inst.name, inst.qubits, -inst.param)
            elif inst.name in self._INVERSE_FIXED:
                inv.append(self._INVERSE_FIXED[inst.name], inst.qubits)
            elif inst.matrix is not None:
                inv.append(inst.name, inst.qubits,
                           matrix=np.conj(inst.matrix).T)
            else:
                raise ValueError(f'cannot invert gate {inst.name!r}')
        return inv

    # -- analysis ------------------------------------------------------------

    def unitary(self, dtype=np.complex128) -> np.ndarray:
        """2^n x 2^n matrix, big-endian (== reference's
        Operator(qc.reverse_bits()).data readout), float64 on host."""
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
        """Total count of the named gates (reference gates_count,
        exact_decompositions.py:280-287)."""
        ops = self.count_ops()
        return sum(ops.get(name, 0) for name in names)

    def gates_depth(self, names: Optional[Sequence[str]] = None) -> int:
        """Circuit depth counting only the named gates (all if None);
        reference gates_depth, exact_decompositions.py:289-290."""
        track = [0] * self.num_qubits
        for inst in self.instructions:
            counted = names is None or inst.name in names
            d = max(track[q] for q in inst.qubits) + (1 if counted else 0)
            for q in inst.qubits:
                track[q] = d
        return max(track) if track else 0

    def depth(self) -> int:
        return self.gates_depth(None)

    @property
    def parameters(self) -> List[float]:
        """Angles of rotation gates in order (the refine pipeline's free
        parameters, exact_decompositions.py:200)."""
        return [i.param for i in self.instructions if i.name in ROTATION_NAMES]

    @property
    def rotation_wires(self) -> List[int]:
        return [i.qubits[0] for i in self.instructions if i.name in ROTATION_NAMES]

    def with_rotation_angles(self, angles: Sequence[float]) -> 'Circuit':
        """Copy with rotation angles replaced in order (reference
        replace_angles_in_circuit, exact_decompositions.py:116-130)."""
        new = self.copy()
        it = iter(angles)
        for inst in new.instructions:
            if inst.name in ROTATION_NAMES:
                inst.param = float(next(it))
        return new

    # -- io -------------------------------------------------------------------

    def to_qasm(self) -> str:
        lines = ['OPENQASM 2.0;', 'include "qelib1.inc";',
                 f'qreg q[{self.num_qubits}];']
        for inst in self.instructions:
            if inst.matrix is not None:
                raise ValueError("cannot serialize opaque 'u' gate to qasm")
            args = ','.join(f'q[{q}]' for q in inst.qubits)
            if inst.param is not None:
                lines.append(f'{inst.name}({inst.param!r}) {args};')
            else:
                lines.append(f'{inst.name} {args};')
        return '\n'.join(lines) + '\n'

    @staticmethod
    def from_qasm(text: str) -> 'Circuit':
        return parse_qasm(text)

    @staticmethod
    def from_qasm_file(path: str) -> 'Circuit':
        with open(path) as f:
            return parse_qasm(f.read())

    def draw(self, output: str = None, **kwargs) -> str:
        """Plain-text rendering, one line per qubit. The qiskit-style
        `output=` argument ('mpl', 'latex_source', ...) is accepted for
        reference-notebook compatibility and ignored — the rendering is
        always the text diagram."""
        cols: List[List[str]] = [[] for _ in range(self.num_qubits)]
        for inst in self.instructions:
            width = max(len(self._label(inst, q)) for q in inst.qubits)
            start = max(len(cols[q]) for q in inst.qubits)
            for q in range(self.num_qubits):
                if q in inst.qubits:
                    while len(cols[q]) < start:
                        cols[q].append('-' * width)
                    cols[q].append(self._label(inst, q).ljust(width, '-'))
        height = max((len(c) for c in cols), default=0)
        out = []
        for q, c in enumerate(cols):
            padded = [s for s in c] + ['-' * len(c[-1]) if c else '--'] * (height - len(c))
            out.append(f'q{q}: ' + '-'.join(padded))
        return '\n'.join(out)

    @staticmethod
    def _label(inst: Instruction, q: int) -> str:
        if inst.num_qubits == 2:
            role = '*' if q == inst.qubits[0] else 'o'
            if inst.param is not None:
                return f'{inst.name}({inst.param:.2f}){role}'
            return f'{inst.name}{role}'
        if inst.param is not None:
            return f'{inst.name}({inst.param:.2f})'
        return inst.name

    def __repr__(self):
        ops = ', '.join(f'{k}:{v}' for k, v in sorted(self.count_ops().items()))
        return f'<Circuit n={self.num_qubits} depth={self.depth()} [{ops}]>'


# --------------------------------------------------------------------------
# OpenQASM 2.0 subset parser (enough for the ibm_qx benchmark set:
# cx/h/t/tdg/x plus parametric rotations for round-tripping our own output)
# --------------------------------------------------------------------------

_QASM_GATE_RE = re.compile(
    r'^\s*([a-zA-Z][\w]*)\s*(?:\(([^)]*)\))?\s+(.+?)\s*;\s*$')
_QASM_QUBIT_RE = re.compile(r'([a-zA-Z_][\w]*)\s*\[\s*(\d+)\s*\]')


def _eval_qasm_expr(expr: str) -> float:
    """Evaluate a QASM angle expression: numeric literals, 'pi', + - * /,
    unary signs and parentheses — a checked ast walk, so anything outside
    that grammar is a clean parse error (no eval)."""
    import ast

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return float(node.value)
        if isinstance(node, ast.Name) and node.id == 'pi':
            return math.pi
        if isinstance(node, ast.BinOp) and \
                isinstance(node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div)):
            lhs, rhs = ev(node.left), ev(node.right)
            if isinstance(node.op, ast.Add):
                return lhs + rhs
            if isinstance(node.op, ast.Sub):
                return lhs - rhs
            if isinstance(node.op, ast.Mult):
                return lhs * rhs
            return lhs / rhs
        if isinstance(node, ast.UnaryOp) and \
                isinstance(node.op, (ast.UAdd, ast.USub)):
            v = ev(node.operand)
            return -v if isinstance(node.op, ast.USub) else v
        raise ValueError(f'unsupported qasm expression {expr!r}')

    try:
        tree = ast.parse(expr.strip(), mode='eval')
    except SyntaxError as e:
        raise ValueError(f'unsupported qasm expression {expr!r}') from e
    return float(ev(tree))


def parse_qasm(text: str) -> Circuit:
    num_qubits = 0
    reg_offsets: dict = {}
    instructions: List[Tuple[str, List[int], Optional[float]]] = []

    for raw_line in text.splitlines():
        line = raw_line.split('//')[0].strip()
        if not line:
            continue
        if line.startswith('OPENQASM') or line.startswith('include'):
            continue
        m = re.match(r'^qreg\s+([a-zA-Z_][\w]*)\s*\[\s*(\d+)\s*\]\s*;', line)
        if m:
            reg_offsets[m.group(1)] = num_qubits
            num_qubits += int(m.group(2))
            continue
        if line.startswith(('creg', 'barrier', 'measure')):
            continue
        m = _QASM_GATE_RE.match(line)
        if not m:
            raise ValueError(f'cannot parse qasm line: {raw_line!r}')
        name, param_str, args = m.groups()
        qubits = [reg_offsets[reg] + int(idx)
                  for reg, idx in _QASM_QUBIT_RE.findall(args)]
        param = _eval_qasm_expr(param_str) if param_str else None
        instructions.append((name.lower(), qubits, param))

    circ = Circuit(num_qubits)
    for name, qubits, param in instructions:
        circ.append(name, qubits, param)
    return circ

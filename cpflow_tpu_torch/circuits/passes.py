"""Host-side circuit transformation passes (counterpart of
cpflow_tpu/circuits/passes.py).

Parity target: reference cpflow/exact_decompositions.py (CP->CZ projection,
ZXZ conversion, zero-gate removal, rationalization, gate projection,
commutation/merge passes). All passes run in float64 numpy on the host —
the reference routes each through qiskit transpile + per-probe jit, which is
both a dependency we don't have and a host<->device chatter source
(SURVEY.md §3.4); a 2^n x 2^n float64 matmul chain on the host is exact and
microseconds-fast at n<=6.

Every transformation is guarded by check_approximation against the input
circuit (reference exact_decompositions.py:30-39), and a raised ValueError is
used as stage-failure control flow by refine().
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Optional

import numpy as np

from cpflow_tpu_torch.circuits.euler import zxz_angles
from cpflow_tpu_torch.circuits.ir import Circuit, Instruction, ROTATION_NAMES


def hst_distance(u: np.ndarray, v: np.ndarray) -> float:
    """Host float64 Hilbert-Schmidt test cost (matrix_utils.py:35-42)."""
    n = u.shape[0]
    return float(1 - abs((u * v.conj()).sum()) ** 2 / n ** 2)


def check_approximation(circuit: Circuit, new_circuit: Circuit,
                        loss: float = 1e-5) -> None:
    """Raise if the transformed circuit drifted from the original
    (exact_decompositions.py:30-33)."""
    l = hst_distance(circuit.unitary(), new_circuit.unitary())
    if not l < loss:
        raise ValueError(
            f'Difference {l} between modified and original circuit is above '
            f'threshold {loss}.')


def check_loss(circuit: Circuit, unitary_loss_func, threshold_loss=1e-5) -> None:
    """Raise if the circuit's loss is above threshold
    (exact_decompositions.py:36-39)."""
    loss = float(unitary_loss_func(circuit.unitary()))
    if not loss < threshold_loss:
        raise ValueError(
            f'Circuit loss {loss} is above threshold {threshold_loss}.')


# --------------------------------------------------------------------------
# CP -> CZ projection
# --------------------------------------------------------------------------

def _residual_cp_as_cz_rz(theta: float, q0: int, q1: int) -> List[Instruction]:
    """Exact CZ+1q realization of CP(theta) (up to global phase):
    CP(t) ~ Rz(t/2) x Rz(t/2) . CX . (I x Rz(-t/2)) . CX, with
    CX = (I x H) CZ (I x H) and H ~ Rz(pi/2) Rx(pi/2) Rz(pi/2).

    Replaces the reference's qiskit transpile to basis ['cz','rz','rx']
    (exact_decompositions.py:61-74). Costs 2 CZ, matching cz_value's charge
    for an unprojected CP gate (cp_utils.py:45-56).
    """
    half = theta / 2.0
    p2 = math.pi / 2

    def h_gates(q):
        return [Instruction('rz', (q,), p2), Instruction('rx', (q,), p2),
                Instruction('rz', (q,), p2)]

    out: List[Instruction] = []
    out += h_gates(q1)
    out.append(Instruction('cz', (q0, q1)))
    out += h_gates(q1)
    out.append(Instruction('rz', (q1,), -half))
    out += h_gates(q1)
    out.append(Instruction('cz', (q0, q1)))
    out += h_gates(q1)
    out.append(Instruction('rz', (q0,), half))
    out.append(Instruction('rz', (q1,), half))
    return out


def cp_to_cz_circuit(circuit: Circuit, cp_threshold: float = 0.2) -> Circuit:
    """Project CP gates: near-0 -> removed, near-pi -> CZ, residual ->
    explicit 2-CZ realization (reference exact_decompositions.py:42-74)."""
    new = Circuit(circuit.num_qubits)
    for inst in circuit.instructions:
        if inst.name != 'cp':
            new.instructions.append(inst.copy())
            continue
        a = inst.param
        if abs(a) <= cp_threshold:
            continue  # identity, drop
        elif abs(a - math.pi) <= cp_threshold:
            new.instructions.append(Instruction('cz', inst.qubits))
        else:
            new.instructions.extend(
                _residual_cp_as_cz_rz(a, inst.qubits[0], inst.qubits[1]))
    check_approximation(circuit, new, loss=1e-5)
    return new


# --------------------------------------------------------------------------
# ZXZ conversion
# --------------------------------------------------------------------------

def convert_to_zxz(circuit: Circuit) -> Circuit:
    """Merge maximal runs of 1q gates per wire and re-express each run as
    Rz Rx Rz (reference convert_to_U + convert_to_ZXZ,
    exact_decompositions.py:133-190)."""
    n = circuit.num_qubits
    pending: List[Optional[np.ndarray]] = [None] * n
    new = Circuit(n)

    def flush(q):
        if pending[q] is None:
            return
        z1, x1, z2 = zxz_angles(pending[q])
        new.instructions.append(Instruction('rz', (q,), z1))
        new.instructions.append(Instruction('rx', (q,), x1))
        new.instructions.append(Instruction('rz', (q,), z2))
        pending[q] = None

    for inst in circuit.instructions:
        if inst.num_qubits == 1:
            m = inst.gate_matrix()
            q = inst.qubits[0]
            pending[q] = m if pending[q] is None else m @ pending[q]
        else:
            for q in inst.qubits:
                flush(q)
            new.instructions.append(inst.copy())
    for q in range(n):
        flush(q)

    check_approximation(circuit, new)
    return new


# --------------------------------------------------------------------------
# Cleanup / rationalization
# --------------------------------------------------------------------------

def remove_zero_rgates(circuit: Circuit, threshold: float = 1e-5) -> Circuit:
    """Drop rotation gates with (near-)zero angles
    (reference exact_decompositions.py:428-445)."""
    new = Circuit(circuit.num_qubits)
    for inst in circuit.instructions:
        if inst.name in ROTATION_NAMES and abs(inst.param) < threshold:
            continue
        new.instructions.append(inst.copy())
    check_approximation(circuit, new)
    return new


def rationalize_all_rgates(circuit: Circuit, max_denominator: int = 32,
                           angle_threshold: float = 1e-3) -> Circuit:
    """Snap rotation angles to nearby rational multiples of pi
    (reference exact_decompositions.py:212-258)."""
    new = Circuit(circuit.num_qubits)
    for inst in circuit.instructions:
        c = inst.copy()
        if inst.name in ROTATION_NAMES:
            frac = Fraction(inst.param / math.pi).limit_denominator(max_denominator)
            rational = math.pi * frac
            if abs(rational - inst.param) < angle_threshold:
                c.param = rational
        new.instructions.append(c)
    check_approximation(circuit, new)
    return new


def angle_is_rational(a: float, power: int) -> bool:
    """True if a = pi*n/2^k with k <= power (exact_decompositions.py:240-245)."""
    f = Fraction(a / math.pi).limit_denominator(2 ** power)
    if abs(math.pi * f - a) < 1e-6:
        lg = math.log2(f.denominator)
        return lg.is_integer()
    return False


def all_rgates_are_rational(circuit: Circuit, power: int) -> bool:
    """All rotation angles are pi * n / 2^k (exact_decompositions.py:229-237)."""
    return all(angle_is_rational(inst.param, power)
               for inst in circuit.instructions if inst.name in ROTATION_NAMES)


# --------------------------------------------------------------------------
# Projection of rotations to named Clifford+T gates
# --------------------------------------------------------------------------

_RX_PROJECTIONS = {
    0.0: ['id'],
    math.pi: ['x'], -math.pi: ['x'],
    math.pi / 2: ['h', 's', 'h'], -math.pi / 2: ['h', 'sdg', 'h'],
    math.pi / 4: ['h', 't', 'h'], -math.pi / 4: ['h', 'tdg', 'h'],
    3 * math.pi / 4: ['x', 'h', 'tdg', 'h'],
    -3 * math.pi / 4: ['x', 'h', 't', 'h'],
}

_RZ_PROJECTIONS = {
    0.0: ['id'],
    math.pi: ['z'], -math.pi: ['z'],
    math.pi / 2: ['s'], -math.pi / 2: ['sdg'],
    math.pi / 4: ['t'], -math.pi / 4: ['tdg'],
    3 * math.pi / 4: ['s', 't'], -3 * math.pi / 4: ['sdg', 'tdg'],
}


def project_circuit(circuit: Circuit, threshold: float) -> Circuit:
    """Replace rx/rz gates whose angles sit near special values with named
    Clifford+T gates (reference exact_decompositions.py:368-425)."""
    new = Circuit(circuit.num_qubits)
    for inst in circuit.instructions:
        names = None
        if inst.name == 'rx':
            table = _RX_PROJECTIONS
        elif inst.name == 'rz':
            table = _RZ_PROJECTIONS
        else:
            table = None
        if table is not None:
            for special, replacement in table.items():
                if abs(inst.param - special) < threshold:
                    names = replacement
                    break
        if names is None:
            new.instructions.append(inst.copy())
        else:
            for name in names:
                if name != 'id':
                    new.instructions.append(Instruction(name, inst.qubits))
    check_approximation(circuit, new)
    return new


# --------------------------------------------------------------------------
# Commutation / merge passes (reference exact_decompositions.py:448-615)
# --------------------------------------------------------------------------

def _try_commute(r: Instruction, nxt: Instruction) -> Optional[Instruction]:
    """Rotation gate `r` attempting to commute past `nxt`; returns the
    (possibly transformed) rotation if the move is legal, else None.

    Rules mirror exact_decompositions.py:494-552: rz commutes with diagonal
    gates and flips sign through X, turns into rx through H; rx commutes with
    X, flips through Z, turns into rz through H, into +-ry through S/Sdg;
    ry flips through X/Z/H and maps to -+rx through S/Sdg.
    """
    disjoint = r.qubits[0] not in nxt.qubits
    name, angle = r.name, r.param

    if name == 'rz':
        if disjoint or nxt.name in ('id', 'z', 's', 't', 'sdg', 'tdg') \
                or (nxt.name in ('cz', 'cp')) \
                or (nxt.name == 'cx' and nxt.qubits[0] == r.qubits[0]):
            return Instruction('rz', r.qubits, angle)
        if nxt.name == 'x':
            return Instruction('rz', r.qubits, -angle)
        if nxt.name == 'h':
            return Instruction('rx', r.qubits, angle)
        return None

    if name == 'rx':
        if disjoint or nxt.name in ('id', 'x') \
                or (nxt.name == 'cx' and nxt.qubits[1] == r.qubits[0]):
            return Instruction('rx', r.qubits, angle)
        if nxt.name == 'z':
            return Instruction('rx', r.qubits, -angle)
        if nxt.name == 'h':
            return Instruction('rz', r.qubits, angle)
        if nxt.name == 's':
            return Instruction('ry', r.qubits, angle)
        if nxt.name == 'sdg':
            return Instruction('ry', r.qubits, -angle)
        return None

    if name == 'ry':
        if disjoint or nxt.name == 'id':
            return Instruction('ry', r.qubits, angle)
        if nxt.name in ('x', 'z', 'h'):
            return Instruction('ry', r.qubits, -angle)
        if nxt.name == 's':
            return Instruction('rx', r.qubits, -angle)
        if nxt.name == 'sdg':
            return Instruction('rx', r.qubits, angle)
        return None

    return None


def move_all_rgates(circuit: Circuit) -> Circuit:
    """Push every rotation gate as far right as it commutes, processing
    rotations right-to-left so each bubbles to its final resting place once
    (reference exact_decompositions.py:448-552, iterative not recursive)."""
    data = [i.copy() for i in circuit.instructions]
    for start in reversed(range(len(data))):
        if data[start].name not in ROTATION_NAMES:
            continue
        j = start
        while j + 1 < len(data):
            moved = _try_commute(data[j], data[j + 1])
            if moved is None:
                break
            data[j], data[j + 1] = data[j + 1], moved
            j += 1
    new = Circuit(circuit.num_qubits, data)
    check_approximation(circuit, new)
    return new


def _bracket(a: float) -> float:
    return ((a + math.pi) % (2 * math.pi)) - math.pi


def merge_all_rgates(circuit: Circuit) -> Circuit:
    """Merge adjacent same-axis rotations on the same wire
    (reference exact_decompositions.py:555-615)."""
    data = [i.copy() for i in circuit.instructions]
    merged = True
    while merged:
        merged = False
        # index of next instruction touching each qubit
        for i in range(len(data)):
            inst = data[i]
            if inst.name not in ROTATION_NAMES:
                continue
            q = inst.qubits[0]
            for j in range(i + 1, len(data)):
                if q not in data[j].qubits:
                    continue
                nxt = data[j]
                if nxt.name == inst.name:
                    data[i] = Instruction(inst.name, inst.qubits,
                                          _bracket(inst.param + nxt.param))
                    del data[j]
                    merged = True
                break
            if merged:
                break
    new = Circuit(circuit.num_qubits, data)
    check_approximation(circuit, new)
    return new

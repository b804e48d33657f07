"""Host-side circuit passes of the static path, float64 numpy (carried over
from cpflow_tpu/circuits/passes.py, which the port cannot import without
JAX): CP->CZ projection and ZXZ conversion, each guarded by
check_approximation against its input circuit."""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from cpflow_tpu_torch.circuits.euler import zxz_angles
from cpflow_tpu_torch.circuits.ir import Circuit, Instruction


def hst_distance(u: np.ndarray, v: np.ndarray) -> float:
    """Host float64 Hilbert-Schmidt test cost."""
    n = u.shape[0]
    return float(1 - abs((u * v.conj()).sum()) ** 2 / n ** 2)


def check_approximation(circuit: Circuit, new_circuit: Circuit,
                        loss: float = 1e-5) -> None:
    """Raise if the transformed circuit drifted from the original."""
    l = hst_distance(circuit.unitary(), new_circuit.unitary())
    if not l < loss:
        raise ValueError(
            f'Difference {l} between modified and original circuit is above '
            f'threshold {loss}.')


def _residual_cp_as_cz_rz(theta: float, q0: int, q1: int) -> List[Instruction]:
    """Exact CZ+1q realization of CP(theta) (up to global phase):
    CP(t) ~ Rz(t/2) x Rz(t/2) . CX . (I x Rz(-t/2)) . CX, with
    CX = (I x H) CZ (I x H) and H ~ Rz(pi/2) Rx(pi/2) Rz(pi/2). Costs 2 CZ,
    matching cz_value's charge for an unprojected CP gate."""
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
    explicit 2-CZ realization."""
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


def convert_to_zxz(circuit: Circuit) -> Circuit:
    """Merge maximal runs of 1q gates per wire and re-express each run as
    Rz Rx Rz."""
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

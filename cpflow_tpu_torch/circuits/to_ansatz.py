"""Convert a concrete circuit into cp-ansatz (placements, angles) form —
the inverse of Ansatz.circuit().

Purpose: WARM-STARTING synthesis from known-good circuits. The raw stage
explores from PRNG draws only; for hard targets (direct 6q synthesis
floors orders above entry_loss) a known circuit — e.g. a
composite construction — embedded into the ansatz template gives gradient
descent a zero-loss starting point from which the CP penalty can walk the
gate count DOWN. The reference has no equivalent (its success-ratio
experiments reuse only the PLACEMENTS of a found decomposition,
CPFlow.tex Table 3; the angles restart from scratch).

Contract (the split_angles layout, sim/ansatz_kernel.py:50-72): the
cp-ansatz with rotation_gates='xyz' applies, in order,
  * per-qubit surface Rz(a2) Rx(a1) Rz(a0)  (zxz),
  * per block at placement (i, j): CP(a_cp) then per-wire Rz Ry Rx (zyx,
    up = wire i at even indices, down = wire j at odd).
So any circuit of the form [1q-runs | cz/cp | 1q-runs | ...] maps exactly:
the leading 1q run on each wire becomes its surface zxz, the run after
each entangler becomes that block's per-wire zyx, and cz becomes
cp(pi). Global phase is unconstrained (every consumer loss is
phase-invariant).
"""

from __future__ import annotations

import cmath
import math
from typing import List, Sequence, Tuple

import numpy as np

from cpflow_tpu_torch.circuits.euler import zxz_angles
from cpflow_tpu_torch.circuits.ir import Circuit, ROTATION_NAMES


def zyx_angles(u: np.ndarray) -> Tuple[float, float, float]:
    """Return (ax, ay, az) with U ~ Rz(az) Ry(ay) Rx(ax) up to phase.

    Derivation: for V in SU(2) with x = V00, y = V10,
        x*y        = sin(b)/2 - i sin(a) cos(b)/2
        |x|^2-|y|^2 = cos(a) cos(b)
        x*conj(y)  = e^{-ic} [sin(b) cos(a)/2 + i sin(a)/2]
    (a = ax, b = ay, c = az). a = atan2(-2 Im(xy), |x|^2-|y|^2) fixes the
    cos(b) >= 0 branch; b from (sin b, cos b); c recovered from arg(x) or
    arg(y) against the reconstructed coefficients (robust at the
    poles where x*conj(y) vanishes)."""
    u = np.asarray(u, dtype=complex)
    det = u[0, 0] * u[1, 1] - u[0, 1] * u[1, 0]
    v = u / cmath.sqrt(det)
    x, y = v[0, 0], v[1, 0]

    xy = x * y
    a = math.atan2(-2.0 * xy.imag, (abs(x) ** 2 - abs(y) ** 2))
    sin_b = 2.0 * xy.real
    ca = math.cos(a)
    sa = math.sin(a)
    # cos(b) >= 0 on this branch; take the larger-magnitude estimate
    if abs(ca) >= abs(sa):
        cos_b = (abs(x) ** 2 - abs(y) ** 2) / ca if abs(ca) > 1e-12 else 0.0
    else:
        cos_b = -2.0 * xy.imag / sa
    b = math.atan2(sin_b, cos_b)

    # c from the phase of x (or y when |x| ~ 0):
    # x = e^{-ic/2}(p + i q), y = e^{ic/2}(r - i s)
    p = math.cos(b / 2) * math.cos(a / 2)
    q = math.sin(b / 2) * math.sin(a / 2)
    r = math.sin(b / 2) * math.cos(a / 2)
    s = math.cos(b / 2) * math.sin(a / 2)
    if abs(x) >= abs(y):
        c = 2.0 * (math.atan2(q, p) - cmath.phase(x))
    else:
        c = 2.0 * (cmath.phase(y) - math.atan2(-s, r))
    return a, b, c


def zyx_reconstruct(ax: float, ay: float, az: float) -> np.ndarray:
    cx_, sx_ = math.cos(ax / 2), math.sin(ax / 2)
    cy_, sy_ = math.cos(ay / 2), math.sin(ay / 2)
    rx = np.array([[cx_, -1j * sx_], [-1j * sx_, cx_]])
    ry = np.array([[cy_, -sy_], [sy_, cy_]])
    rz = np.diag([cmath.exp(-1j * az / 2), cmath.exp(1j * az / 2)])
    return rz @ ry @ rx


def circuit_to_ansatz(circ: Circuit, rotation_gates: str = 'xyz'
                      ) -> Tuple[List[Sequence[int]], np.ndarray]:
    """(placements, flat angles) reproducing `circ` through the cp-ansatz.

    Requirements: every multi-qubit gate is cz or cp (flatten cx first —
    benchmarks/composite.py cz_count_exact does exactly that), and
    rotation_gates='xyz' (two-letter bases cannot absorb arbitrary 1q
    runs). Verified round-trip: Ansatz(...).unitary(angles) equals
    circ.unitary() up to global phase (tests/test_torch_to_ansatz.py).
    """
    if rotation_gates != 'xyz':
        raise ValueError("circuit_to_ansatz needs rotation_gates='xyz' "
                         "(full per-wire SU(2) coverage after each block)")
    n = circ.num_qubits
    placements: List[Sequence[int]] = []
    cp_params: List[float] = []
    # pending[w]: accumulated 1q unitary on wire w since the last entangler
    pending = [np.eye(2, dtype=complex) for _ in range(n)]
    surface = [None] * n          # zxz of the leading run, set lazily
    block_rots: List[list] = []   # per block: [up zyx, down zyx]
    # which block's rotation slot absorbs the CURRENT pending run of wire w
    # (-1 = still in the leading run -> surface)
    slot = [-1] * n

    def flush(w: int):
        u = pending[w]
        if slot[w] < 0:
            surface[w] = zxz_angles(u)
        else:
            b, pos = block_rots[slot[w]][0], block_rots[slot[w]][1][w]
            b[pos] = zyx_angles(u)
        pending[w] = np.eye(2, dtype=complex)

    for inst in circ.instructions:
        if inst.name in ('cz', 'cp'):
            i, j = inst.qubits
            flush(i)
            flush(j)
            placements.append((i, j))
            cp_params.append(math.pi if inst.name == 'cz'
                             else float(inst.param))
            block_rots.append([[None, None], {i: 0, j: 1}])
            slot[i] = slot[j] = len(block_rots) - 1
        elif inst.num_qubits == 1:
            pending[inst.qubits[0]] = (inst.gate_matrix()
                                       @ pending[inst.qubits[0]])
        else:
            raise ValueError(
                f'cannot embed {inst.name!r} into the cp-ansatz — flatten '
                f'to cz/cp + 1q first (e.g. cx -> h cz h)')
    for w in range(n):
        flush(w)

    ident = (0.0, 0.0, 0.0)
    angles = []
    for w in range(n):
        angles.extend(surface[w] if surface[w] is not None else ident)
    for (rots, _pos), cp in zip(block_rots, cp_params):
        up = rots[0] or ident
        down = rots[1] or ident
        # per-letter interleave: x_up x_down y_up y_down z_up z_down cp
        for k in range(3):
            angles.append(up[k])
            angles.append(down[k])
        angles.append(cp)
    return placements, np.asarray(angles, dtype=np.float64)

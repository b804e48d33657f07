"""1-qubit Euler-angle decompositions, host numpy only (replaces qiskit's
OneQubitEulerDecomposer used at exact_decompositions.py:163-175; counterpart
of cpflow_tpu/circuits/euler.py).

Any U in U(2) factors, up to global phase, as Rz(z2) Rx(x1) Rz(z1) — the ZXZ
basis the reference refines into (convert_to_ZXZ). Angles are recovered in
closed form on the host in float64.
"""

from __future__ import annotations

import cmath
import math
from typing import Tuple

import numpy as np


def zxz_angles(u: np.ndarray) -> Tuple[float, float, float]:
    """Return (z1, x1, z2) with U ~ Rz(z2) @ Rx(x1) @ Rz(z1) up to phase.

    Derivation: for V in SU(2),
      V = Rz(b) Rx(g) Rz(a) =
        [[ cos(g/2) e^{-i(a+b)/2},  -i sin(g/2) e^{ i(a-b)/2}],
         [-i sin(g/2) e^{-i(a-b)/2},    cos(g/2) e^{ i(a+b)/2}]]
    so g = 2 atan2(|V10|, |V00|), a+b = -2 arg(V00), a-b = -2 arg(V10) - pi.
    """
    u = np.asarray(u, dtype=complex)
    det = u[0, 0] * u[1, 1] - u[0, 1] * u[1, 0]
    # remove global phase: V = u / sqrt(det) has det 1
    v = u / cmath.sqrt(det)

    abs00 = abs(v[0, 0])
    abs10 = abs(v[1, 0])
    g = 2.0 * math.atan2(abs10, abs00)

    if abs00 >= 1e-12 and abs10 >= 1e-12:
        apb = -2.0 * cmath.phase(v[0, 0])
        amb = -2.0 * cmath.phase(v[1, 0]) - math.pi
        a = (apb + amb) / 2.0
        b = (apb - amb) / 2.0
    elif abs10 < 1e-12:
        # diagonal: g ~ 0, only a+b matters
        a = -2.0 * cmath.phase(v[0, 0])
        b = 0.0
    else:
        # anti-diagonal: g ~ pi, only a-b matters
        a = -2.0 * cmath.phase(v[1, 0]) - math.pi
        b = 0.0
    return a, g, b


def rz_matrix(a: float) -> np.ndarray:
    return np.diag([cmath.exp(-1j * a / 2), cmath.exp(1j * a / 2)])


def rx_matrix(a: float) -> np.ndarray:
    c, s = math.cos(a / 2), math.sin(a / 2)
    return np.array([[c, -1j * s], [-1j * s, c]])


def zxz_reconstruct(z1: float, x1: float, z2: float) -> np.ndarray:
    return rz_matrix(z2) @ rx_matrix(x1) @ rz_matrix(z1)

"""Clifford+T synthesis of 1-qubit rotations: exact words for pi/4-rational
angles plus a Solovay-Kitaev fallback for generic angles.

The reference consumes SolovayKitaevDecomposition from an experimental
qiskit-terra fork that needs a Rust toolchain to build
(exact_decompositions.py:14-21, README.md:17-21) — i.e. it does not implement
this itself. We implement it natively:

  * ``exact_rz_word`` / ``exact_rx_word``: Rz(k pi/4) is exactly a word in
    {Z, S, Sdg, T, Tdg} (up to global phase); Rx = H Rz H. After the
    ``rationalize_all_rgates`` stage (max_denominator<=32 keeps only
    power-of-two fractions; the circuits that reach Clifford+T in practice
    rationalize to multiples of pi/4), this path yields minimal-T words —
    reproducing the reference's 7-T CCZ refinement (README.md:45).
  * ``SolovayKitaev``: Dawson-Nielsen recursion over a BFS-generated table of
    basic approximations (words in {H, T, Tdg, S, Sdg}), with the balanced
    group-commutator construction for SU(2).

Everything here is host-side float64 numpy: Clifford+T rounding stays on the
host.
"""

from __future__ import annotations

import cmath
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from cpflow_tpu_torch.circuits.ir import (Circuit, Instruction, FIXED_GATES,
                                          ROTATION_NAMES)

_H = FIXED_GATES['h']
_GEN = {name: FIXED_GATES[name] for name in ('h', 't', 'tdg', 's', 'sdg')}


# --------------------------------------------------------------------------
# Exact synthesis of pi/4-rational rotations
# --------------------------------------------------------------------------

_RZ_EIGHTH_WORDS = {
    0: [],
    1: ['t'],
    2: ['s'],
    3: ['s', 't'],
    4: ['z'],
    5: ['z', 't'],
    6: ['sdg'],
    7: ['tdg'],
}


def exact_rz_word(angle: float, tol: float = 1e-9) -> Optional[List[str]]:
    """Word in {z, s, sdg, t, tdg} equal to Rz(angle) up to global phase,
    or None if angle is not a multiple of pi/4 (within tol)."""
    k = angle / (math.pi / 4)
    k_round = round(k)
    if abs(k - k_round) * (math.pi / 4) > tol:
        return None
    return list(_RZ_EIGHTH_WORDS[k_round % 8])


def exact_rx_word(angle: float, tol: float = 1e-9) -> Optional[List[str]]:
    """Rx(a) = H Rz(a) H up to phase."""
    inner = exact_rz_word(angle, tol)
    if inner is None:
        return None
    if not inner:
        return []
    return ['h'] + inner + ['h']


# --------------------------------------------------------------------------
# SU(2) helpers
# --------------------------------------------------------------------------

def _to_su2(u: np.ndarray) -> np.ndarray:
    det = u[0, 0] * u[1, 1] - u[0, 1] * u[1, 0]
    return u / cmath.sqrt(det)


def _trace_dist(u: np.ndarray, v: np.ndarray) -> float:
    """Phase-invariant distance: sqrt(1 - |tr(U^dag V)| / 2)."""
    t = abs((u.conj() * v).sum()) / 2.0
    return math.sqrt(max(0.0, 1.0 - min(1.0, t)))


def _su2_axis_angle(u: np.ndarray) -> Tuple[np.ndarray, float]:
    """U = cos(t/2) I - i sin(t/2) (n . sigma); returns (n, t)."""
    u = _to_su2(u)
    c = np.real(u[0, 0] + u[1, 1]) / 2.0
    c = max(-1.0, min(1.0, c))
    t = 2.0 * math.acos(c)
    s = math.sin(t / 2.0)
    if abs(s) < 1e-12:
        return np.array([1.0, 0.0, 0.0]), 0.0
    # U = cos(t/2) I - i sin(t/2) (n.sigma):
    #   U01 = -i s nx - s ny,  U10 = -i s nx + s ny,  U00-U11 = -2 i s nz
    nx = -np.imag(u[0, 1] + u[1, 0]) / (2 * s)
    ny = np.real(u[1, 0] - u[0, 1]) / (2 * s)
    nz = -np.imag(u[0, 0] - u[1, 1]) / (2 * s)
    n = np.array([nx, ny, nz])
    norm = np.linalg.norm(n)
    if norm < 1e-12:
        return np.array([1.0, 0.0, 0.0]), t
    return n / norm, t


def _su2_from_axis_angle(n: np.ndarray, t: float) -> np.ndarray:
    sx = np.array([[0, 1], [1, 0]], dtype=complex)
    sy = np.array([[0, -1j], [1j, 0]], dtype=complex)
    sz = np.diag([1, -1]).astype(complex)
    sigma = n[0] * sx + n[1] * sy + n[2] * sz
    return math.cos(t / 2) * np.eye(2) - 1j * math.sin(t / 2) * sigma


def _rotation_to_rotation(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """SU(2) element S with S R_a S^dag = R_b for rotations about axes a, b."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    cross = np.cross(a, b)
    dot = float(np.dot(a, b))
    if np.linalg.norm(cross) < 1e-12:
        if dot > 0:
            return np.eye(2, dtype=complex)
        # opposite axes: rotate pi about any perpendicular axis
        perp = np.cross(a, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(perp) < 1e-9:
            perp = np.cross(a, np.array([0.0, 1.0, 0.0]))
        return _su2_from_axis_angle(perp / np.linalg.norm(perp), math.pi)
    axis = cross / np.linalg.norm(cross)
    angle = math.acos(max(-1.0, min(1.0, dot)))
    return _su2_from_axis_angle(axis, angle)


def _group_commutator_decompose(u: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Balanced group commutator: V, W with U = V W V^dag W^dag
    (Dawson-Nielsen construction)."""
    _, theta = _su2_axis_angle(u)
    st = math.sin(theta / 2.0)
    # sin(theta/2) = 2 sin^2(phi/2) sqrt(1 - sin^4(phi/2))
    s2 = math.sqrt(max(0.0, st / 2.0)) if st > 0 else 0.0
    # solve for sin(phi/2): st = 2 x^2 sqrt(1-x^4); invert numerically
    lo, hi = 0.0, 1.0 / math.sqrt(2.0)
    for _ in range(60):
        mid = (lo + hi) / 2
        val = 2 * mid * mid * math.sqrt(max(0.0, 1 - mid ** 4))
        if val < st:
            lo = mid
        else:
            hi = mid
    x = (lo + hi) / 2
    phi = 2.0 * math.asin(min(1.0, x))

    v = _su2_from_axis_angle(np.array([1.0, 0.0, 0.0]), phi)
    w = _su2_from_axis_angle(np.array([0.0, 1.0, 0.0]), phi)
    comm = v @ w @ v.conj().T @ w.conj().T

    n_u, _ = _su2_axis_angle(u)
    n_c, _ = _su2_axis_angle(comm)
    s = _rotation_to_rotation(n_c, n_u)
    return s @ v @ s.conj().T, s @ w @ s.conj().T


# --------------------------------------------------------------------------
# Basic-approximation table
# --------------------------------------------------------------------------

_INVERSE = {'h': 'h', 't': 'tdg', 'tdg': 't', 's': 'sdg', 'sdg': 's', 'z': 'z'}


class BasicApproximations:
    """BFS over words in {H, T, Tdg, S, Sdg} up to `depth`, deduplicated up
    to global phase. Lookup is a vectorized numpy nearest-neighbour scan."""

    def __init__(self, depth: int = 10, max_size: int = 60000):
        words: List[Tuple[str, ...]] = [()]
        mats: List[np.ndarray] = [np.eye(2, dtype=complex)]
        seen: Dict[tuple, int] = {self._key(np.eye(2, dtype=complex)): 0}

        frontier = [(np.eye(2, dtype=complex), ())]
        for _ in range(depth):
            new_frontier = []
            for mat, word in frontier:
                for gname, g in _GEN.items():
                    if word and _INVERSE[word[-1]] == gname:
                        continue  # trivially cancels
                    m = g @ mat
                    k = self._key(m)
                    if k in seen:
                        continue
                    w = word + (gname,)
                    seen[k] = len(words)
                    words.append(w)
                    mats.append(m)
                    new_frontier.append((m, w))
                    if len(words) >= max_size:
                        break
                if len(words) >= max_size:
                    break
            frontier = new_frontier
            if len(words) >= max_size:
                break

        self.words = words
        self._flat = np.stack([_to_su2(m).reshape(-1) for m in mats])  # (N,4)
        self._mats = mats

    @staticmethod
    def _key(m: np.ndarray) -> tuple:
        v = _to_su2(m).reshape(-1)
        # canonicalize global sign (SU(2) double cover): first significant
        # entry gets positive real part
        for x in v:
            if abs(x) > 1e-8:
                if x.real < -1e-12 or (abs(x.real) <= 1e-12 and x.imag < 0):
                    v = -v
                break
        return tuple(np.round(v, 8).tolist())

    def nearest(self, u: np.ndarray) -> Tuple[List[str], np.ndarray]:
        target = _to_su2(u).reshape(-1)
        overlap = np.abs(self._flat.conj() @ target)  # |tr(W^dag U)|
        i = int(np.argmax(overlap))
        return list(self.words[i]), self._mats[i]


class SolovayKitaev:
    """Dawson-Nielsen Solovay-Kitaev over the Clifford+T basis."""

    def __init__(self, basic_depth: int = 10, max_table: int = 60000):
        self.table = BasicApproximations(depth=basic_depth, max_size=max_table)

    def decompose(self, u: np.ndarray, recursion_degree: int = 0
                  ) -> Tuple[List[str], np.ndarray]:
        """Return (word, matrix) approximating u; word applies left-to-right
        in circuit order (first gate applied first)."""
        word, mat = self._sk(np.asarray(u, dtype=complex), recursion_degree)
        return word[::-1], mat  # matrix product order -> application order

    def _sk(self, u: np.ndarray, n: int) -> Tuple[List[str], np.ndarray]:
        # Internal invariant: words are in MATRIX-PRODUCT order (first element
        # = leftmost factor = applied last); decompose() reverses at the end.
        if n == 0:
            word_app, mat = self.table.nearest(u)
            return word_app[::-1], mat
        word1, u1 = self._sk(u, n - 1)
        delta = _to_su2(u) @ u1.conj().T
        v, w = _group_commutator_decompose(delta)
        vw, vm = self._sk(v, n - 1)
        ww, wm = self._sk(w, n - 1)
        vw_dag = [_INVERSE[g] for g in reversed(vw)]
        ww_dag = [_INVERSE[g] for g in reversed(ww)]
        word = vw + ww + vw_dag + ww_dag + word1
        mat = vm @ wm @ vm.conj().T @ wm.conj().T @ u1
        return word, mat


_DEFAULT_SK: Optional[SolovayKitaev] = None


def _default_sk(depth: int) -> SolovayKitaev:
    global _DEFAULT_SK
    if _DEFAULT_SK is None or _DEFAULT_SK._depth < depth:
        sk = SolovayKitaev(basic_depth=depth)
        sk._depth = depth
        _DEFAULT_SK = sk
    return _DEFAULT_SK


def generic_rotation_word(name: str, angle: float, eps: float = 1e-5
                          ) -> Optional[List[str]]:
    """Clifford+T word for a generic-angle rotation via the Ross-Selinger
    grid synthesis (circuits.gridsynth): T-count ~ 3 log2(1/eps), exact
    integer arithmetic, supported down to eps ~ 1e-7 (the float64 interval
    wall). rx/ry reduce to rz by Clifford conjugation:
    Rx = H Rz H,  Ry = (S H) Rz (S H)^dag."""
    from cpflow_tpu_torch.circuits.gridsynth import gridsynth_rz

    inner = gridsynth_rz(angle, eps=max(eps, 1e-7))
    if inner is None:
        return None
    if name == 'rz':
        return inner
    if name == 'rx':
        return ['h'] + inner + ['h']
    if name == 'ry':
        return ['sdg', 'h'] + inner + ['h', 's']
    raise ValueError(name)


def solovay_kitaev(circuit: Circuit, recursion_degree: int = 0,
                   recursion_depth: int = 5, eps: float = 1e-5) -> Circuit:
    """Rewrite every 1q rotation into Clifford+T gates
    (reference exact_decompositions.py:261-269, but self-contained).

    Exact pi/4-rational rz/rx angles take the exact minimal-word path;
    generic angles go through Ross-Selinger grid synthesis to distance
    `eps` (gridsynth.py), with the Dawson-Nielsen Solovay-Kitaev table as
    a fallback (`recursion_degree` rounds over words of length
    ~ 2*recursion_depth). The caller's check_approximation decides whether
    the result is acceptable (refine(), exact_decompositions.py:328-342).
    """
    from cpflow_tpu_torch.circuits.passes import check_approximation

    new = Circuit(circuit.num_qubits)
    sk: Optional[SolovayKitaev] = None

    for inst in circuit.instructions:
        if inst.name not in ROTATION_NAMES:
            new.instructions.append(inst.copy())
            continue
        q = inst.qubits[0]
        word: Optional[List[str]] = None
        if inst.name == 'rz':
            word = exact_rz_word(inst.param)
        elif inst.name == 'rx':
            word = exact_rx_word(inst.param)
        if word is None:
            word = generic_rotation_word(inst.name, float(inst.param), eps)
        if word is None:  # gridsynth gave up: Solovay-Kitaev fallback
            if sk is None:
                sk = _default_sk(2 * recursion_depth)
            if inst.name == 'rz':
                target = np.diag([cmath.exp(-1j * inst.param / 2),
                                  cmath.exp(1j * inst.param / 2)])
            else:
                target = inst.gate_matrix()
            word, _ = sk.decompose(target, recursion_degree=recursion_degree)
        for g in word:
            new.instructions.append(Instruction(g, (q,)))

    check_approximation(new, circuit)
    return new

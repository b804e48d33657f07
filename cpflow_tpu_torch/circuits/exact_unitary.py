"""Exact circuit evaluation over cyclotomic integers — symbolic exactness
proofs for rational-angle decompositions.

The paper verifies exactness of its toffoli decompositions *externally*, in a
Mathematica notebook, and flags integrating that check as future work
(reference paper/CPFlow.tex:430, README.md:8). This module does it natively:
when every rotation angle of a circuit is an exact rational multiple of pi
(p/q with q | Q, Q a power of two — the output of the refine pipeline's
Rational stage, reference exact_decompositions.py:212-258), every matrix
entry lies in the ring

    (1/2^e) * Z[zeta],   zeta = exp(i*pi/(2Q)),  a primitive 4Q-th root of 1,

and Z[zeta] ~= Z[x]/(x^(2Q)+1) because zeta^(2Q) = -1. Elements are integer
coefficient vectors of length M=2Q with arbitrary-precision Python ints, so
products of gate matrices are computed EXACTLY — no floating point anywhere.
The certificates below are then complete proofs, not numerical checks:

- HST: |tr(U^dag T)| = d  <=>  U = e^{i phi} T   (Cauchy-Schwarz equality
  for unitaries), checked as the exact ring identity s*conj(s) == d^2 * 4^e
  with s = sum_ij conj(U_ij) T_ij.
- modulo-diagonal (relative phase, wires = all qubits): U*T diagonal with
  unit-modulus diagonal entries, checked entrywise in the ring
  (tensor_diagonal_loss == 0 semantics, reference matrix_utils.py:179-215,
  for the self-inverse permutation targets used by the relphase artifacts).

Big-endian qubit convention throughout (qubit 0 = MSB), matching
cpflow_tpu_torch.circuits.ir.Circuit.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

__all__ = ['NotExactError', 'ExactMatrix', 'exact_unitary', 'exact_gate',
           'hst_equal_certificate', 'diagonal_certificate',
           'toffoli_permutation', 'controlled_sqrt_x', 'angle_fraction']


class NotExactError(ValueError):
    """An angle is not a rational multiple of pi with denominator | Q."""


def angle_fraction(param: float, q_max: int, tol: float = 1e-9) -> Fraction:
    """Angle -> exact Fraction p/q of pi (q <= q_max), or NotExactError."""
    fr = Fraction(param / math.pi).limit_denominator(q_max)
    if abs(param - math.pi * fr.numerator / fr.denominator) > tol:
        raise NotExactError(
            f'angle {param!r} is not pi*(p/q) with q <= {q_max} (tol {tol})')
    return fr


# --------------------------------------------------------------------------
# The ring Z[zeta] = Z[x]/(x^M + 1), zeta = exp(i*pi/M): vectors of M ints
# --------------------------------------------------------------------------

def _zero(m: int) -> List[int]:
    return [0] * m


def _zpow(k: int, m: int) -> List[int]:
    """zeta^k as a coefficient vector (zeta^M = -1)."""
    k %= 2 * m
    sign = 1
    if k >= m:
        k -= m
        sign = -1
    v = _zero(m)
    v[k] = sign
    return v


def _vadd(a: List[int], b: List[int]) -> List[int]:
    return [x + y for x, y in zip(a, b)]


def _vsub(a: List[int], b: List[int]) -> List[int]:
    return [x - y for x, y in zip(a, b)]


def _vmul(a: List[int], b: List[int], m: int) -> List[int]:
    """Negacyclic convolution; iterates only the nonzero coefficients of the
    sparser operand (gate entries are 1- or 2-term, so this is ~O(M))."""
    na = sum(1 for x in a if x)
    if na == 0:
        return _zero(m)
    nb = sum(1 for x in b if x)
    if nb == 0:
        return _zero(m)
    if nb < na:
        a, b = b, a
    out = _zero(m)
    for i, ai in enumerate(a):
        if not ai:
            continue
        for j, bj in enumerate(b):
            if not bj:
                continue
            k = i + j
            if k >= m:
                out[k - m] -= ai * bj
            else:
                out[k] += ai * bj
    return out


def _vconj(a: List[int], m: int) -> List[int]:
    """Complex conjugation: zeta^k -> zeta^{-k} = -zeta^{M-k} (k >= 1)."""
    out = _zero(m)
    out[0] = a[0]
    for k in range(1, m):
        out[m - k] = -a[k]
    return out


def _vscale_int(a: List[int], c: int) -> List[int]:
    return [c * x for x in a]


# --------------------------------------------------------------------------
# Exact matrices: entries in (1/2^e) Z[zeta]
# --------------------------------------------------------------------------

class ExactMatrix:
    """Dense matrix over (1/2^e) Z[zeta]; `entries[i][j]` are M-vectors."""

    def __init__(self, entries: List[List[List[int]]], e: int, m: int):
        self.entries = entries
        self.e = e            # denominator exponent: value = entries / 2^e
        self.m = m            # ring degree M = 2Q

    @property
    def dim(self) -> int:
        return len(self.entries)

    @classmethod
    def identity(cls, dim: int, m: int) -> 'ExactMatrix':
        one = _zpow(0, m)
        return cls([[list(one) if i == j else _zero(m) for j in range(dim)]
                    for i in range(dim)], 0, m)

    @classmethod
    def from_int_matrix(cls, rows: Sequence[Sequence[int]], m: int
                        ) -> 'ExactMatrix':
        ent = [[_vscale_int(_zpow(0, m), int(v)) for v in row] for row in rows]
        return cls(ent, 0, m)

    def to_complex(self):
        """Float snapshot (for cross-checking against numpy circuits only —
        the certificates never use this)."""
        import numpy as np
        zs = np.exp(1j * math.pi * np.arange(self.m) / self.m)
        flat = np.array([[sum(c * z for c, z in zip(v, zs))
                          for v in row] for row in self.entries])
        return flat / (2 ** self.e)

    def reduce_denominator(self) -> 'ExactMatrix':
        """Divide out common factors of 2 shared by every coefficient."""
        while self.e > 0 and all(c % 2 == 0
                                 for row in self.entries
                                 for v in row for c in v):
            self.entries = [[[c // 2 for c in v] for v in row]
                            for row in self.entries]
            self.e -= 1
        return self


# --------------------------------------------------------------------------
# Exact gate matrices
# --------------------------------------------------------------------------

def exact_gate(name: str, param: Optional[float], q: int
               ) -> Tuple[List[List[List[int]]], int]:
    """(entries, e) of a 1q/2q gate over Z[zeta], zeta = exp(i*pi/(2q)).

    Rotation angles must be exact rational multiples of pi with denominator
    dividing q; fixed pi/4-grid gates (h, s, t, ...) need 4 | 2q.
    """
    m = 2 * q
    quarter = q // 2       # zeta^{q/2} = exp(i*pi/4); valid when q is even
    z = _zpow

    def frac_r(p):
        fr = angle_fraction(p, q)
        num, den = fr.numerator, fr.denominator
        if q % den:
            raise NotExactError(f'denominator {den} does not divide Q={q}')
        return num * (q // den)    # exp(i*angle/2) = zeta^r

    if name in ('rz', 'rx', 'ry'):
        r = frac_r(param)
        if name == 'rz':
            return [[z(-r, m), _zero(m)], [_zero(m), z(r, m)]], 0
        cos2 = _vadd(z(r, m), z(-r, m))             # 2 cos(a/2)
        if name == 'rx':
            mi_sin2 = _vsub(z(-r, m), z(r, m))      # -2 i sin(a/2)
            return [[cos2, mi_sin2], [mi_sin2, cos2]], 1
        sin2 = _vsub(z(q - r, m), z(q + r, m))      # 2 sin(a/2)
        return [[cos2, _vscale_int(sin2, -1)], [sin2, cos2]], 1
    if name == 'cp':
        fr = angle_fraction(param, q)
        if q % fr.denominator:
            raise NotExactError(f'cp denominator {fr.denominator} !| Q={q}')
        k = 2 * fr.numerator * (q // fr.denominator)   # exp(i a) = zeta^k
        ent = [[_zero(m) for _ in range(4)] for _ in range(4)]
        for i in range(3):
            ent[i][i] = z(0, m)
        ent[3][3] = z(k, m)
        return ent, 0
    if name in ('h', 's', 'sdg', 't', 'tdg') and q % 2:
        raise NotExactError(f'gate {name!r} needs 4 | 2Q (Q even), Q={q}')
    if name == 'h':
        w = _vadd(z(quarter, m), z(-quarter, m))    # sqrt(2)
        return [[w, list(w)], [list(w), _vscale_int(w, -1)]], 1
    simple = {
        'id': [[1, 0], [0, 1]], 'x': [[0, 1], [1, 0]], 'z': [[1, 0], [0, -1]],
        'cx': [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]],
        'cz': [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, -1]],
        'swap': [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    }
    if name in simple:
        return ([[_vscale_int(z(0, m), v) for v in row]
                 for row in simple[name]], 0)
    if name == 'y':
        return [[_zero(m), _vscale_int(z(q, m), -1)], [z(q, m), _zero(m)]], 0
    phases = {'s': q, 'sdg': -q, 't': quarter * 2, 'tdg': -quarter * 2}
    # NB: zeta^q = i, zeta^{q/2} = exp(i pi/4); t phase = pi/4 => zeta^{q/2}.
    if name in ('s', 'sdg'):
        return [[z(0, m), _zero(m)], [_zero(m), z(phases[name], m)]], 0
    if name in ('t', 'tdg'):
        k = quarter if name == 't' else -quarter
        return [[z(0, m), _zero(m)], [_zero(m), z(k, m)]], 0
    raise NotExactError(f'gate {name!r} has no exact form here')


# --------------------------------------------------------------------------
# Exact circuit unitary
# --------------------------------------------------------------------------

def _apply_1q(u: ExactMatrix, gate, eg: int, qubit: int, n: int) -> None:
    """u <- G*u for a 1q gate on `qubit` (big-endian bit n-1-qubit)."""
    m, d = u.m, u.dim
    bit = 1 << (n - 1 - qubit)
    (g00, g01), (g10, g11) = gate
    ent = u.entries
    for i0 in range(d):
        if i0 & bit:
            continue
        i1 = i0 | bit
        r0, r1 = ent[i0], ent[i1]
        new0 = [_vadd(_vmul(g00, r0[j], m), _vmul(g01, r1[j], m))
                for j in range(d)]
        new1 = [_vadd(_vmul(g10, r0[j], m), _vmul(g11, r1[j], m))
                for j in range(d)]
        ent[i0], ent[i1] = new0, new1
    u.e += eg


def _apply_2q(u: ExactMatrix, gate, eg: int, q0: int, q1: int, n: int) -> None:
    """u <- G*u for a 2q gate on (q0, q1); row index bits (b0 b1) map to the
    gate's 4x4 basis |q0 q1>."""
    m, d = u.m, u.dim
    b0, b1 = 1 << (n - 1 - q0), 1 << (n - 1 - q1)
    ent = u.entries
    for base in range(d):
        if base & b0 or base & b1:
            continue
        idx = (base, base | b1, base | b0, base | b0 | b1)
        rows = [ent[i] for i in idx]
        for out_i, i in enumerate(idx):
            ent[i] = [
                _vadd(_vadd(_vmul(gate[out_i][0], rows[0][j], m),
                            _vmul(gate[out_i][1], rows[1][j], m)),
                      _vadd(_vmul(gate[out_i][2], rows[2][j], m),
                            _vmul(gate[out_i][3], rows[3][j], m)))
                for j in range(d)]
    u.e += eg


def exact_unitary(circuit, q: int) -> ExactMatrix:
    """Exact unitary of an ir.Circuit whose angles are all pi*(p/q'), q' | q.

    Matches ir.Circuit.unitary() semantics (instructions left-multiplied in
    order, big-endian). Raises NotExactError if any angle is not exact.
    """
    n = circuit.num_qubits
    u = ExactMatrix.identity(2 ** n, 2 * q)
    for inst in circuit.instructions:
        if inst.matrix is not None:
            raise NotExactError("opaque 'u' gates have no exact form")
        gate, eg = exact_gate(inst.name, inst.param, q)
        if inst.num_qubits == 1:
            _apply_1q(u, gate, eg, inst.qubits[0], n)
        elif inst.num_qubits == 2:
            _apply_2q(u, gate, eg, inst.qubits[0], inst.qubits[1], n)
        else:
            raise NotExactError(f'{inst.num_qubits}-qubit gate {inst.name!r}')
        if u.e and u.e % 8 == 0:
            u.reduce_denominator()
    return u.reduce_denominator()


# --------------------------------------------------------------------------
# Exact targets
# --------------------------------------------------------------------------

def toffoli_permutation(n: int) -> List[List[int]]:
    """n-qubit Toffoli (X on the last qubit, controls on the first n-1):
    integer permutation matrix, big-endian (reference gates.py:95-106)."""
    d = 2 ** n
    rows = [[0] * d for _ in range(d)]
    for i in range(d):
        j = i ^ 1 if i >= d - 2 else i
        rows[j][i] = 1
    return rows


def controlled_sqrt_x(n: int, q: int) -> ExactMatrix:
    """C^{n-1}(sqrt X): identity except the last 2x2 block = (1/2)[[1+i, 1-i],
    [1-i, 1+i]] (principal square root of X). Entries over Z[zeta], i=zeta^q."""
    m = 2 * q
    d = 2 ** n
    ent = [[_vscale_int(_zpow(0, m), 2 if i == j else 0) for j in range(d)]
           for i in range(d)]
    one, i_ = _zpow(0, m), _zpow(q, m)
    pl, mi = _vadd(one, i_), _vsub(one, i_)
    ent[d - 2][d - 2] = list(pl)
    ent[d - 2][d - 1] = list(mi)
    ent[d - 1][d - 2] = list(mi)
    ent[d - 1][d - 1] = list(pl)
    return ExactMatrix(ent, 1, m)


# --------------------------------------------------------------------------
# Certificates
# --------------------------------------------------------------------------

def _is_const(v: List[int], c: int) -> bool:
    return v[0] == c and all(x == 0 for x in v[1:])


def hst_equal_certificate(u: ExactMatrix, t: ExactMatrix) -> bool:
    """True iff u equals t up to global phase, EXACTLY: the ring identity
    s * conj(s) == d^2 * 4^(e_u + e_t) with s = sum_ij conj(u_ij) t_ij."""
    assert u.m == t.m and u.dim == t.dim
    m, d = u.m, u.dim
    s = _zero(m)
    for i in range(d):
        ur, tr = u.entries[i], t.entries[i]
        for j in range(d):
            if any(tr[j]):
                s = _vadd(s, _vmul(_vconj(ur[j], m), tr[j], m))
    want = d * d * 4 ** (u.e + t.e)
    return _is_const(_vmul(s, _vconj(s, m), m), want)


def diagonal_certificate(prod: ExactMatrix) -> bool:
    """True iff `prod` is EXACTLY diagonal with unit-modulus diagonal:
    off-diagonal vectors identically zero, and p_ii conj(p_ii) == 4^e."""
    m, d = prod.m, prod.dim
    want = 4 ** prod.e
    for i in range(d):
        row = prod.entries[i]
        for j in range(d):
            if i == j:
                if not _is_const(_vmul(row[j], _vconj(row[j], m), m), want):
                    return False
            elif any(row[j]):
                return False
    return True


def ghz_state_certificate(u: ExactMatrix) -> bool:
    """True iff column |0..0> of u EXACTLY equals the GHZ state
    (|0..0> + |1..1>)/sqrt(2) up to a global phase.

    Both vectors are exactly unit-norm (u is a product of exact unitary
    gates), so by the Cauchy-Schwarz equality case |<ghz|u e_0>| == 1 iff
    the column IS phase * ghz. With s = sqrt(2) * (conj(u_00) + conj(u_d0))
    over the ring (sqrt 2 = x^{m/4} - x^{3m/4} in Z[x]/(x^m + 1)), that is
    the integer identity s * conj(s) == 4^(e+1). The reference advertises
    state preparation but never verifies it exactly (main.py:513)."""
    m, d = u.m, u.dim
    if m % 4:
        return False  # sqrt(2) is not in Z[zeta_{2m}] unless 4 | m
    root2 = _zero(m)
    root2[m // 4] = 1
    root2[3 * m // 4] = -1
    s = _vmul(root2, _vadd(_vconj(u.entries[0][0], m),
                           _vconj(u.entries[d - 1][0], m)), m)
    return _is_const(_vmul(s, _vconj(s, m), m), 4 ** (u.e + 1))


def matmul_exact(a: ExactMatrix, b: ExactMatrix) -> ExactMatrix:
    assert a.m == b.m and a.dim == b.dim
    m, d = a.m, a.dim
    ent = [[_zero(m) for _ in range(d)] for _ in range(d)]
    for i in range(d):
        ar = a.entries[i]
        for k in range(d):
            av = ar[k]
            if not any(av):
                continue
            br = b.entries[k]
            row = ent[i]
            for j in range(d):
                if any(br[j]):
                    row[j] = _vadd(row[j], _vmul(av, br[j], m))
    return ExactMatrix(ent, a.e + b.e, m).reduce_denominator()

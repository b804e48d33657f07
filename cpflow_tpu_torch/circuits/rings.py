"""Exact arithmetic in the rings of Clifford+T synthesis.

Z[w] with w = exp(i pi/4) (the cyclotomic ring of order 8) and its real
subring Z[sqrt2]. These are the coefficient rings of single-qubit Clifford+T
unitaries: every such unitary has entries in Z[w] / sqrt2^k, and the
Ross-Selinger approximate-synthesis pipeline (gridsynth.py) reduces the
problem of synthesizing Rz(theta) to integer arithmetic here.

The reference offloads all of this to an experimental qiskit fork
(exact_decompositions.py:14-21); this module is self-contained (python ints,
so arbitrary precision for free).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple


class ZOmega:
    """a0 + a1 w + a2 w^2 + a3 w^3, w = exp(i pi/4), w^4 = -1."""

    __slots__ = ('a',)

    def __init__(self, a0=0, a1=0, a2=0, a3=0):
        self.a = (int(a0), int(a1), int(a2), int(a3))

    # -- basic ring ops ------------------------------------------------------
    def __add__(self, o):
        o = _zo(o)
        return ZOmega(*(x + y for x, y in zip(self.a, o.a)))

    def __sub__(self, o):
        o = _zo(o)
        return ZOmega(*(x - y for x, y in zip(self.a, o.a)))

    def __neg__(self):
        return ZOmega(*(-x for x in self.a))

    def __mul__(self, o):
        o = _zo(o)
        a, b = self.a, o.a
        c = [0, 0, 0, 0, 0, 0, 0]
        for i in range(4):
            if a[i]:
                for j in range(4):
                    c[i + j] += a[i] * b[j]
        # w^4 = -1
        return ZOmega(c[0] - c[4], c[1] - c[5], c[2] - c[6], c[3])

    __radd__ = __add__
    __rmul__ = __mul__

    def __rsub__(self, o):
        return _zo(o) - self

    def __pow__(self, n: int):
        r, b = ZOmega(1), self
        n = int(n)
        while n:
            if n & 1:
                r = r * b
            b = b * b
            n >>= 1
        return r

    def __eq__(self, o):
        return self.a == _zo(o).a

    def __hash__(self):
        return hash(self.a)

    def __repr__(self):
        return f'ZOmega{self.a}'

    def __bool__(self):
        return any(self.a)

    # -- involutions ---------------------------------------------------------
    def conj(self) -> 'ZOmega':
        """Complex conjugation: w -> w^-1 = -w^3."""
        a0, a1, a2, a3 = self.a
        return ZOmega(a0, -a3, -a2, -a1)

    def adj2(self) -> 'ZOmega':
        """sqrt2-conjugation (the bullet involution): w -> -w."""
        a0, a1, a2, a3 = self.a
        return ZOmega(a0, -a1, a2, -a3)

    # -- norms / embeddings --------------------------------------------------
    def norm_zrt2(self) -> 'ZRt2':
        """|z|^2 = z z^dagger as an element of Z[sqrt2]."""
        p = self * self.conj()
        a0, a1, a2, a3 = p.a
        assert a2 == 0 and a1 == -a3, f'norm not real: {p}'
        return ZRt2(a0, a1)

    def norm_int(self) -> int:
        """Rational norm N(z) = N_{Z[sqrt2]/Z}(|z|^2) (always >= 0)."""
        return self.norm_zrt2().norm_int_abs()

    def to_complex(self) -> complex:
        a0, a1, a2, a3 = self.a
        s = 1.0 / math.sqrt(2.0)
        return complex(a0 + (a1 - a3) * s, a2 + (a1 + a3) * s)

    # -- divisibility --------------------------------------------------------
    def div_sqrt2(self) -> Optional['ZOmega']:
        """self / sqrt2 if it stays in Z[w], else None.
        sqrt2 = w - w^3; z/sqrt2 = z * sqrt2 / 2."""
        p = self * _SQRT2
        if all(x % 2 == 0 for x in p.a):
            return ZOmega(*(x // 2 for x in p.a))
        return None

    def divmod_round(self, d: 'ZOmega') -> Tuple['ZOmega', 'ZOmega']:
        """Nearest-integer division: q with small remainder (Z[w] is
        norm-Euclidean, so |r| < |d| under the rational norm)."""
        # q ~= self * d.conj() * (d d^dag)^bullet / N(d), rounded coeff-wise
        dc = d.conj()
        den_rt2 = (d * dc)  # real: s + t sqrt2 as ZOmega
        den_bul = den_rt2.adj2()
        num = self * dc * den_bul
        n = d.norm_int()
        assert n != 0
        q = ZOmega(*(_iround(x, n) for x in num.a))
        return q, self - q * d

    def gcd(self, o: 'ZOmega') -> 'ZOmega':
        a, b = self, _zo(o)
        while b:
            _, r = a.divmod_round(b)
            a, b = b, r
        return a

    def divides_exactly(self, o: 'ZOmega') -> Optional['ZOmega']:
        """o / self if exact, else None."""
        q, r = o.divmod_round(self)
        return q if not r else None


def _zo(x) -> ZOmega:
    if isinstance(x, ZOmega):
        return x
    if isinstance(x, ZRt2):
        return x.to_zomega()
    if isinstance(x, int):
        return ZOmega(x)
    raise TypeError(type(x))


def _iround(num: int, den: int) -> int:
    """round(num/den) for ints, round-half-away from zero."""
    if den < 0:
        num, den = -num, -den
    if num >= 0:
        return (2 * num + den) // (2 * den)
    return -((-2 * num + den) // (2 * den))


_SQRT2 = ZOmega(0, 1, 0, -1)
OMEGA = ZOmega(0, 1, 0, 0)
I_ZO = ZOmega(0, 0, 1, 0)


class ZRt2:
    """a + b sqrt2 with integer a, b."""

    __slots__ = ('a', 'b')

    def __init__(self, a=0, b=0):
        self.a, self.b = int(a), int(b)

    def __add__(self, o):
        o = _zr(o)
        return ZRt2(self.a + o.a, self.b + o.b)

    def __sub__(self, o):
        o = _zr(o)
        return ZRt2(self.a - o.a, self.b - o.b)

    def __neg__(self):
        return ZRt2(-self.a, -self.b)

    def __mul__(self, o):
        o = _zr(o)
        return ZRt2(self.a * o.a + 2 * self.b * o.b,
                    self.a * o.b + self.b * o.a)

    __radd__ = __add__
    __rmul__ = __mul__

    def __rsub__(self, o):
        return _zr(o) - self

    def __pow__(self, n: int):
        r, b = ZRt2(1), self
        n = int(n)
        while n:
            if n & 1:
                r = r * b
            b = b * b
            n >>= 1
        return r

    def __eq__(self, o):
        o = _zr(o)
        return self.a == o.a and self.b == o.b

    def __hash__(self):
        return hash((self.a, self.b))

    def __repr__(self):
        return f'ZRt2({self.a}, {self.b})'

    def __bool__(self):
        return bool(self.a or self.b)

    def adj2(self) -> 'ZRt2':
        """sqrt2 -> -sqrt2."""
        return ZRt2(self.a, -self.b)

    def norm_int(self) -> int:
        """N(x) = x x^bullet = a^2 - 2 b^2 (can be negative)."""
        return self.a * self.a - 2 * self.b * self.b

    def norm_int_abs(self) -> int:
        return abs(self.norm_int())

    def value(self) -> float:
        return self.a + self.b * math.sqrt(2.0)

    def is_nonneg(self) -> bool:
        """Exact x >= 0 (integer arithmetic, no float rounding)."""
        a, b = self.a, self.b
        if a >= 0 and b >= 0:
            return True
        if a < 0 and b < 0:
            return False
        # signs differ: compare a^2 vs 2 b^2 with the sign of the larger part
        if a >= 0:  # b < 0: need a >= -b sqrt2 -> a^2 >= 2 b^2
            return a * a >= 2 * b * b
        return 2 * b * b >= a * a  # a < 0, b > 0

    def to_zomega(self) -> ZOmega:
        return ZOmega(self.a, self.b, 0, -self.b)

    def divmod_round(self, d: 'ZRt2') -> Tuple['ZRt2', 'ZRt2']:
        n = d.norm_int()
        assert n != 0
        num = self * d.adj2()
        q = ZRt2(_iround(num.a, n), _iround(num.b, n))
        return q, self - q * d

    def gcd(self, o: 'ZRt2') -> 'ZRt2':
        a, b = self, _zr(o)
        while b:
            _, r = a.divmod_round(b)
            a, b = b, r
        return a

    def divides_exactly(self, o: 'ZRt2') -> Optional['ZRt2']:
        q, r = o.divmod_round(self)
        return q if not r else None


def _zr(x) -> ZRt2:
    if isinstance(x, ZRt2):
        return x
    if isinstance(x, int):
        return ZRt2(x)
    raise TypeError(type(x))


LAMBDA = ZRt2(1, 1)       # 1 + sqrt2, the fundamental unit of Z[sqrt2]
SQRT2_R = ZRt2(0, 1)
DELTA = ZOmega(1, 1, 0, 0)  # 1 + w; delta^dag delta = lambda * sqrt2


# --------------------------------------------------------------------------
# Integer number theory: deterministic Miller-Rabin, Pollard rho,
# Tonelli-Shanks square roots mod p.
# --------------------------------------------------------------------------

def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _pollard_rho(n: int) -> int:
    """One nontrivial factor of composite odd n (Brent's variant)."""
    if n % 2 == 0:
        return 2
    for c in range(1, 40):
        x = y = 2
        d = 1
        while d == 1:
            x = (x * x + c) % n
            y = (y * y + c) % n
            y = (y * y + c) % n
            d = math.gcd(abs(x - y), n)
        if d != n:
            return d
    raise ArithmeticError(f'rho failed on {n}')


def factorize(n: int, effort: int = 10 ** 6) -> Optional[dict]:
    """Prime factorization {p: multiplicity}, or None if a cofactor resists
    the effort bound (the caller just tries the next grid candidate)."""
    out: dict = {}
    n = int(n)
    if n == 0:
        return None
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47):
        while n % p == 0:
            out[p] = out.get(p, 0) + 1
            n //= p
    stack = [n] if n > 1 else []
    while stack:
        m = stack.pop()
        if m == 1:
            continue
        if is_prime(m):
            out[m] = out.get(m, 0) + 1
            continue
        if m > effort ** 2 and m.bit_length() > 90:
            return None  # too hard under the effort bound
        try:
            d = _pollard_rho(m)
        except ArithmeticError:
            return None
        stack += [d, m // d]
    return out


def sqrt_mod(a: int, p: int) -> Optional[int]:
    """x with x^2 = a (mod p), p odd prime (Tonelli-Shanks)."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        t2, i = t, 0
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
            if i == m:
                return None
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t, r = t * c % p, r * b % p
    return r

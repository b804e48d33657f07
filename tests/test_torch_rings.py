"""The port's exact rings and number theory (cpflow_tpu_torch/circuits/
rings.py: Z[omega], Z[sqrt 2], primality, factoring, square roots mod p)
against the JAX package's on seeded integers. Pure Python integers, so every
result is equal, not close; the ring axioms are held against complex
arithmetic within 1e-9."""

import random

import pytest

from cpflow_tpu.circuits import rings as jr
from cpflow_tpu_torch.circuits import rings as tr


def zo_pair(rng, lo=-20, hi=20):
    a = [rng.randint(lo, hi) for _ in range(4)]
    return tr.ZOmega(*a), jr.ZOmega(*a)


def zr_pair(rng, lo=-40, hi=40):
    a = [rng.randint(lo, hi) for _ in range(2)]
    return tr.ZRt2(*a), jr.ZRt2(*a)


def same(t, j):
    """A port ring element (or None, or a tuple of them) equals the JAX
    package's: the same class name and the same integer coefficients."""
    if t is None or j is None:
        return t is None and j is None
    if isinstance(t, tuple):
        return len(t) == len(j) and all(same(a, b) for a, b in zip(t, j))
    if isinstance(t, tr.ZOmega):
        return isinstance(j, jr.ZOmega) and tuple(t.a) == tuple(j.a)
    if isinstance(t, tr.ZRt2):
        return isinstance(j, jr.ZRt2) and (t.a, t.b) == (j.a, j.b)
    return t == j


@pytest.mark.parametrize('seed', range(5))
def test_zomega_arithmetic(seed):
    rng = random.Random(seed)
    for _ in range(40):
        (x, jx), (y, jy) = zo_pair(rng), zo_pair(rng)
        assert same(x + y, jx + jy) and same(x - y, jx - jy)
        assert same(x * y, jx * jy) and same(-x, -jx)
        assert same(x * 3, jx * 3) and same(7 - x, 7 - jx)
        assert same(x ** 3, jx ** 3)
        assert same(x.conj(), jx.conj()) and same(x.adj2(), jx.adj2())
        assert same(x.norm_zrt2(), jx.norm_zrt2())
        assert x.norm_int() == jx.norm_int()
        assert x.to_complex() == jx.to_complex()
        assert same(x.div_sqrt2(), jx.div_sqrt2())
        assert bool(x) == bool(jx) and repr(x) == repr(jx)
        assert hash(x) == hash(tr.ZOmega(*x.a))
        # the ring against complex arithmetic
        assert abs((x * y).to_complex() - x.to_complex() * y.to_complex()) \
            < 1e-9
        assert abs(x.norm_zrt2().value() - abs(x.to_complex()) ** 2) < 1e-9
    assert tr.OMEGA ** 8 == tr.ZOmega(1)
    assert tr.I_ZO == tr.OMEGA ** 2
    assert (tr.DELTA.conj() * tr.DELTA) == \
        (tr.LAMBDA * tr.ZRt2(0, 1)).to_zomega()


@pytest.mark.parametrize('seed', range(5))
def test_zomega_division_and_gcd(seed):
    rng = random.Random(100 + seed)
    for _ in range(30):
        (a, ja), (d, jd) = zo_pair(rng), zo_pair(rng, -5, 5)
        if not d:
            continue
        assert same(a.divmod_round(d), ja.divmod_round(jd))
        q, r = a.divmod_round(d)
        assert q * d + r == a and r.norm_int() < d.norm_int()
        assert same(a.gcd(d), ja.gcd(jd))
        assert same(d.divides_exactly(a * d), jd.divides_exactly(ja * jd))
        assert d.divides_exactly(a * d) == a
        assert same(d.divides_exactly(a), jd.divides_exactly(ja))


@pytest.mark.parametrize('seed', range(5))
def test_zrt2_arithmetic_division_and_gcd(seed):
    rng = random.Random(200 + seed)
    for _ in range(40):
        (x, jx), (y, jy) = zr_pair(rng), zr_pair(rng, -6, 6)
        assert same(x + y, jx + jy) and same(x - y, jx - jy)
        assert same(x * y, jx * jy) and same(-x, -jx) and same(3 - x, 3 - jx)
        assert same(x ** 2, jx ** 2) and same(x.adj2(), jx.adj2())
        assert x.norm_int() == jx.norm_int()
        assert x.norm_int_abs() == jx.norm_int_abs()
        assert x.value() == jx.value()
        assert x.is_nonneg() == jx.is_nonneg() == (x.value() >= 0)
        assert same(x.to_zomega(), jx.to_zomega())
        assert repr(x) == repr(jx) and bool(x) == bool(jx)
        if y:
            assert same(x.divmod_round(y), jx.divmod_round(jy))
            assert same(x.gcd(y), jx.gcd(jy))
            assert same(y.divides_exactly(x * y), jy.divides_exactly(jx * jy))
            assert same(y.divides_exactly(x), jy.divides_exactly(jx))


@pytest.mark.parametrize('seed', range(4))
def test_number_theory_helpers(seed):
    rng = random.Random(300 + seed)
    for _ in range(60):
        n = rng.randint(2, 10 ** rng.randint(2, 12))
        assert tr.is_prime(n) == jr.is_prime(n)
        f = tr.factorize(n)
        assert f == jr.factorize(n)
        prod = 1
        for p, e in f.items():
            assert tr.is_prime(p)
            prod *= p ** e
        assert prod == n
    for p in (7, 17, 10007, 65537, 2 ** 61 - 1):
        for a in (2, 3, rng.randint(2, p - 1)):
            r = tr.sqrt_mod(a, p)
            assert r == jr.sqrt_mod(a, p)
            if r is not None:
                assert r * r % p == a % p
    assert tr.is_prime(2 ** 61 - 1) and not tr.is_prime(2 ** 67 - 1)
    assert tr.factorize(2 * 3 ** 4 * 10007) == {2: 1, 3: 4, 10007: 1}

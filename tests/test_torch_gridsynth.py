"""The port's Ross-Selinger grid synthesis (cpflow_tpu_torch/circuits/
gridsynth.py) against the JAX package's: the same Clifford+T word for the
same angle and precision (both are deterministic integer and float64
arithmetic), the word's matrix within the asked precision of Rz(theta), the
Diophantine solver and the exact word verifier entry for entry."""

import math

import numpy as np
import pytest

from cpflow_tpu.circuits import clifford_t as jct
from cpflow_tpu.circuits import gridsynth as jg
from cpflow_tpu.circuits.rings import ZRt2 as JZRt2
from cpflow_tpu_torch.circuits import clifford_t as tct
from cpflow_tpu_torch.circuits import gridsynth as tg
from cpflow_tpu_torch.circuits.ir import FIXED_GATES
from cpflow_tpu_torch.circuits.rings import ZRt2


def _rz(theta):
    return np.diag([np.exp(-1j * theta / 2), np.exp(1j * theta / 2)])


@pytest.mark.parametrize('eps', [1e-2, 1e-3, 1e-5, 1e-7])
@pytest.mark.parametrize('theta', [0.5, 2.2, -0.7, 3.9, 0.01, math.pi / 3,
                                   7.0])
def test_gridsynth_rz_same_word_within_eps(theta, eps):
    word = tg.gridsynth_rz(theta, eps)
    assert word is not None and word == jg.gridsynth_rz(theta, eps)
    assert set(word) <= {'h', 's', 'sdg', 't', 'tdg', 'x', 'z'}
    m = tg.word_matrix(word)
    np.testing.assert_array_equal(m, jg.word_matrix(word))
    d = tg.phase_invariant_distance(m, _rz(theta))
    assert d == jg.phase_invariant_distance(m, _rz(theta))
    # float64 rounds 1 - |tr|/2 at about 1e-16, several percent of eps^2 at
    # eps = 1e-7: there only the exact distance below decides
    assert d <= (eps if eps >= 1e-5 else 1.2 * eps), (theta, eps, d)
    assert 0 <= tg.word_dist2_rz(word, theta) <= eps * eps
    # T count near the information-theoretic 3 log2(1/eps)
    tc = sum(1 for g in word if g in ('t', 'tdg'))
    assert tc <= 6 * math.log2(1 / eps) + 8


@pytest.mark.parametrize('ab', [(2, 0), (2, 1), (7, 2), (4, 1), (14, 7),
                                (17, 9), (3, 0), (5, 2), (23, 4), (31, 12)])
def test_norm_equation_same_solution(ab):
    t = tg.solve_norm_equation(ZRt2(*ab))
    j = jg.solve_norm_equation(JZRt2(*ab))
    assert (t is None) == (j is None)
    if t is not None:
        assert tuple(t.a) == tuple(j.a)
        assert t.norm_zrt2() == ZRt2(*ab)
    if ab == (17, 9):      # 17 - 9 sqrt 2 < 0: no solution
        assert t is None


@pytest.mark.parametrize('name', ['rx', 'ry', 'rz'])
def test_generic_rotation_word(name):
    theta = 1.234
    word = tct.generic_rotation_word(name, theta, eps=1e-4)
    assert word == jct.generic_rotation_word(name, theta, eps=1e-4)
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    target = {'rx': np.array([[c, -1j * s], [-1j * s, c]]),
              'ry': np.array([[c, -s], [s, c]]), 'rz': _rz(theta)}[name]
    m = np.eye(2, dtype=complex)
    for g in word:
        m = FIXED_GATES[g] @ m
    assert tg.phase_invariant_distance(m, target) <= 1e-4
    with pytest.raises(ValueError):
        tct.generic_rotation_word('rw', theta)


@pytest.mark.parametrize('theta', [0.5, -0.7])
def test_exact_acceptance_at_1e10(theta):
    """eps = 1e-10: the float64 word matrix cannot resolve it; the word is
    verified over Z[omega] in 256-bit fixed point, in both packages."""
    eps = 1e-10
    word = tg.gridsynth_rz(theta, eps)
    assert word is not None and word == jg.gridsynth_rz(theta, eps)
    d2 = tg.word_dist2_rz(word, theta)
    assert d2 == jg.word_dist2_rz(word, theta)
    assert 0 <= float(d2) <= eps * eps
    (a, b), (c, d), k = tg.word_unitary_exact(word)
    (ja, jb), (jc, jd), jk = jg.word_unitary_exact(word)
    assert k == jk
    for x, y in ((a, ja), (b, jb), (c, jc), (d, jd)):
        assert tuple(x.a) == tuple(y.a)
    tc = sum(1 for g in word if g in ('t', 'tdg'))
    assert tc <= 3.6 * math.log2(1 / eps) + 12


def test_eps_floor_guard():
    for mod in (tg, jg):
        with pytest.raises(ValueError, match='enumeration floor'):
            mod.gridsynth_rz(0.5, 9e-13)

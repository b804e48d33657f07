"""The port's host passes (cpflow_tpu_torch/circuits/passes.py, euler.py)
against the JAX package's on the same seeded circuits: every pass must
return the same instructions with parameters within 1e-12, raise where the
other raises, and the Euler angles must rebuild their matrix."""

import math

import numpy as np
import pytest

from cpflow_tpu.circuits import euler as jeuler
from cpflow_tpu.circuits import passes as jpasses
from cpflow_tpu_torch.circuits import euler as teuler
from cpflow_tpu_torch.circuits import passes as tpasses
from cpflow_tpu_torch.circuits.ir import Instruction
from test_torch_ir import assert_same_circuit, both, random_rows

SEEDS = range(6)
SPECIAL = [0.0, math.pi, -math.pi, math.pi / 2, -math.pi / 2, math.pi / 4,
           -math.pi / 4, 3 * math.pi / 4, -3 * math.pi / 4]


def rotation_rows(seed, n=3, length=24, angles=None, noise=0.0):
    """A random circuit of rotations, cz, the named 1q gates, cx and cp;
    rotation angles uniform, or drawn from `angles` with uniform noise of
    that size."""
    rng = np.random.default_rng(seed)
    names_1q = ['h', 'x', 'z', 's', 'sdg', 't', 'tdg', 'id']
    rows = []
    for _ in range(length):
        kind = rng.integers(0, 4)
        q = [int(x) for x in rng.choice(n, size=2, replace=False)]
        if kind == 0:
            a = rng.uniform(-math.pi, math.pi) if angles is None else \
                angles[rng.integers(0, len(angles))] + \
                rng.uniform(-noise, noise)
            rows.append((['rx', 'ry', 'rz'][rng.integers(0, 3)], (q[0],),
                         float(a), None))
        elif kind == 1:
            rows.append(('cz', tuple(q), None, None))
        elif kind == 2:
            rows.append((names_1q[rng.integers(0, len(names_1q))], (q[0],),
                         None, None))
        elif rng.integers(0, 2):
            rows.append(('cx', tuple(q), None, None))
        else:
            rows.append(('cp', tuple(q), 0.3, None))
    return rows


def run_both(name, rows, *args, n=3, **kw):
    """pass `name` of both packages on the rows: both circuits, or both
    error messages."""
    tc, jc = both(rows, n)
    out = []
    for mod, qc in ((tpasses, tc), (jpasses, jc)):
        try:
            out.append(getattr(mod, name)(qc, *args, **kw))
        except ValueError as e:
            out.append(str(e))
    return out


def assert_same_outcome(t_out, j_out):
    if isinstance(t_out, str) or isinstance(j_out, str):
        assert t_out == j_out
    else:
        assert_same_circuit(t_out, j_out)


@pytest.mark.parametrize('seed', SEEDS)
def test_zxz_angles_and_reconstruct(seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    u = np.linalg.qr(z)[0]
    angles = teuler.zxz_angles(u)
    np.testing.assert_allclose(angles, jeuler.zxz_angles(u), atol=1e-12)
    v = teuler.zxz_reconstruct(*angles)
    np.testing.assert_allclose(v, jeuler.zxz_reconstruct(*angles), atol=1e-12)
    assert tpasses.hst_distance(u, v) < 1e-12
    a = float(rng.uniform(-4, 4))
    np.testing.assert_array_equal(teuler.rz_matrix(a), jeuler.rz_matrix(a))
    np.testing.assert_array_equal(teuler.rx_matrix(a), jeuler.rx_matrix(a))


@pytest.mark.parametrize('seed', SEEDS)
def test_cp_to_cz_and_zxz_conversion(seed):
    rng = np.random.default_rng(seed)
    rows = [(name, q, (rng.choice([0.0, math.pi, 1.1]) + rng.uniform(-1e-4, 1e-4))
             if name == 'cp' else p, m)
            for name, q, p, m in random_rows(seed, length=20)]
    t_out, j_out = run_both('cp_to_cz_circuit', rows)
    assert_same_outcome(t_out, j_out)
    assert not isinstance(t_out, str)
    assert t_out.gates_count(['cp']) == 0
    tz, jz = tpasses.convert_to_zxz(t_out), jpasses.convert_to_zxz(j_out)
    assert_same_circuit(tz, jz)
    assert set(tz.count_ops()) <= {'rz', 'rx', 'cz', 'cx', 'swap'}


@pytest.mark.parametrize('seed', SEEDS)
def test_check_loss_and_check_approximation(seed):
    tc, jc = both(random_rows(seed))
    target = tc.unitary()
    loss = lambda u: tpasses.hst_distance(u, target)
    for mod, qc in ((tpasses, tc), (jpasses, jc)):
        mod.check_loss(qc, loss)
        mod.check_approximation(qc, qc)
        other = qc.copy()
        other.rz(0.5, 0)
        with pytest.raises(ValueError, match='above threshold 1e-05'):
            mod.check_loss(other, loss)
        with pytest.raises(ValueError, match='above threshold 0.001'):
            mod.check_approximation(qc, other, loss=1e-3)
    assert tpasses.hst_distance(target, jc.unitary()) == \
        jpasses.hst_distance(target, jc.unitary())


@pytest.mark.parametrize('seed', SEEDS)
def test_remove_zero_rgates(seed):
    rows = rotation_rows(seed, angles=[0.0, 0.7, -1.9], noise=5e-6)
    t_out, j_out = run_both('remove_zero_rgates', rows)
    assert_same_outcome(t_out, j_out)
    assert all(abs(i.param) >= 1e-5 for i in t_out.instructions
               if i.name in ('rx', 'ry', 'rz'))
    # a threshold that drops real rotations fails the guard in both
    t_bad, j_bad = run_both('remove_zero_rgates', rows, threshold=1.0)
    assert isinstance(t_bad, str) and t_bad == j_bad


@pytest.mark.parametrize('seed', SEEDS)
def test_rationalize_and_rationality(seed):
    grid = [math.pi * p / q for q in (1, 2, 3, 4, 8, 16, 32)
            for p in range(-q, q + 1)]
    rows = rotation_rows(seed, angles=grid, noise=2e-4)
    t_out, j_out = run_both('rationalize_all_rgates', rows)
    assert_same_outcome(t_out, j_out)
    for power in (3, 5):
        assert tpasses.all_rgates_are_rational(t_out, power) == \
            jpasses.all_rgates_are_rational(j_out, power)
    # a tight threshold leaves the noisy angles alone, in both
    t_out, j_out = run_both('rationalize_all_rgates', rows,
                            max_denominator=8, angle_threshold=1e-6)
    assert_same_outcome(t_out, j_out)
    for a in grid + [0.3, 1e-7, 2.0]:
        for power in (2, 5):
            assert tpasses.angle_is_rational(a, power) == \
                jpasses.angle_is_rational(a, power)
    assert tpasses.angle_is_rational(math.pi / 8, 3)
    assert not tpasses.angle_is_rational(math.pi / 3, 5)


@pytest.mark.parametrize('seed', SEEDS)
def test_project_circuit(seed):
    rows = rotation_rows(seed, angles=SPECIAL + [0.9, -2.0], noise=1e-7)
    t_out, j_out = run_both('project_circuit', rows, 1e-6)
    assert_same_outcome(t_out, j_out)
    assert not isinstance(t_out, str)
    left = [i for i in t_out.instructions if i.name in ('rx', 'rz')]
    assert all(min(abs(i.param - s) for s in SPECIAL) >= 1e-6 for i in left)
    # a threshold wide enough to swallow generic angles fails the guard
    t_bad, j_bad = run_both('project_circuit', rows, 0.4)
    assert_same_outcome(t_bad, j_bad)


@pytest.mark.parametrize('seed', SEEDS)
def test_move_and_merge_all_rgates(seed):
    rows = rotation_rows(seed, length=30)
    t_out, j_out = run_both('move_all_rgates', rows)
    assert_same_outcome(t_out, j_out)
    assert not isinstance(t_out, str)
    rows_moved = [(i.name, i.qubits, i.param, None)
                  for i in t_out.instructions]
    t_m, j_m = run_both('merge_all_rgates', rows_moved)
    assert_same_outcome(t_m, j_m)
    t_m2, j_m2 = run_both('merge_all_rgates', rows)
    assert_same_outcome(t_m2, j_m2)
    assert len(t_m2.instructions) <= len(rows)


def test_try_commute_rules_are_the_same():
    nexts = [Instruction(n, (0,)) for n in
             ('id', 'x', 'y', 'z', 'h', 's', 'sdg', 't', 'tdg')]
    nexts += [Instruction(n, q) for n in ('cz', 'cx', 'cp', 'swap')
              for q in ((0, 1), (1, 0), (1, 2))]
    for name in ('rx', 'ry', 'rz'):
        r = Instruction(name, (0,), 0.6)
        for nxt in nexts:
            got = tpasses._try_commute(r, nxt)
            want = jpasses._try_commute(r, nxt)
            assert (got is None) == (want is None), (name, nxt)
            if got is not None:
                assert (got.name, got.qubits, got.param) == \
                    (want.name, want.qubits, want.param)

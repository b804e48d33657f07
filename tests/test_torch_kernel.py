"""The sweep kernel's wrapper (kernels/sweep.py): on a CPU tensor it is the
plain version, it refuses what the kernel does not compute, and on the card
the kernel agrees with the plain version.

This file imports no JAX, so the test that needs the card runs where JAX is
not installed: ``python -m pytest --noconftest tests/test_torch_kernel.py``
(tests/conftest.py configures JAX).
"""

import math

import numpy as np
import pytest
import torch

from cpflow_tpu_torch.api import LossSpec
from cpflow_tpu_torch.kernels import sweep as sk
from cpflow_tpu_torch.ops.gates import cz_mat, multi_controlled_x, u_ccz3
from cpflow_tpu_torch.ops.penalty import LinearPenalty
from cpflow_tpu_torch.sim.ansatz_kernel import cp_angle_indices, num_block_angles
from cpflow_tpu_torch.sim.batched import make_batched_regloss
from cpflow_tpu_torch.topology import chain_layer, fill_layers

torch.set_num_threads(1)

PEN = (math.pi / 2, 2.0, 0.05, 0.05, 0.05)


def _ghz(n):
    t = np.zeros(2 ** n, dtype=np.complex64)
    t[0] = t[-1] = 2 ** -0.5
    return t


def _problem(n, k, rot, target, r, B, seed, kind='hst'):
    nba = num_block_angles('cp', rot)
    P = 3 * n + nba * k
    cp_mask = np.zeros(P, dtype=np.float32)
    cp_mask[cp_angle_indices(n, nba, k)] = 1
    rng = np.random.default_rng(seed)
    inits = rng.uniform(0, 2 * np.pi, (B, P)).astype(np.float32)
    obj = make_batched_regloss(
        n, 'cp', rot, fill_layers(chain_layer(n), k),
        LossSpec(kind, target=target), cp_mask=cp_mask,
        regularization_func=LinearPenalty(*PEN), r=r)
    return obj, inits, rng


def test_sweep_on_cpu_tensor_is_the_plain_version():
    obj, inits, _ = _problem(2, 3, 'xyz', cz_mat, 0.002, 4, seed=2)
    p0 = torch.tensor(inits.T.copy())
    before = sk.LAUNCHES
    a = sk.sweep(obj, p0, 0.1, 20)
    b = sk.sweep_reference(obj, p0, 0.1, 20)
    assert sk.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_refuses_what_it_does_not_compute():
    obj, _, _ = _problem(7, 2, 'xyz', np.eye(128, dtype=np.complex64),
                            0.0, 1, seed=0)
    with pytest.raises(ValueError, match='ROADMAP B.7'):
        sk._check_objective(obj)
    obj, _, _ = _problem(13, 2, 'xyz', _ghz(13), 0.0, 1, seed=0,
                         kind='state')
    with pytest.raises(ValueError, match='ROADMAP B.7'):
        sk._check_objective(obj)
    obj, _, _ = _problem(3, 2, 'xz', u_ccz3, 0.0, 1, seed=0)
    with pytest.raises(NotImplementedError):
        sk._check_objective(obj)
    obj, _, _ = _problem(3, 2, 'xyz', u_ccz3, 0.0, 1, seed=0)
    obj.unitary_loss_func = LossSpec('disc', target=u_ccz3)
    with pytest.raises(NotImplementedError):
        sk._check_objective(obj)
    # within the limits, both losses pass
    sk._check_objective(_problem(12, 2, 'xyz', _ghz(12), 0.0, 1, seed=0,
                                 kind='state')[0])
    sk._check_objective(_problem(6, 2, 'xyz', np.eye(64, dtype=np.complex64),
                                 0.0, 1, seed=0)[0])


def test_r_per_restart_on_cpu_tensor_equals_separate_sweeps():
    obj, inits, _ = _problem(2, 3, 'xyz', cz_mat, 0.0, 6, seed=5)
    rs = np.array([0.0, 0.0, 0.002, 0.002, 0.01, 0.01], dtype=np.float32)
    obj.r = torch.tensor(rs)
    p0 = torch.tensor(inits.T.copy())
    out = sk.sweep(obj, p0, 0.1, 15)
    for value in (0.0, 0.002, 0.01):
        cols = np.nonzero(rs == np.float32(value))[0]
        one, _, _ = _problem(2, 3, 'xyz', cz_mat, float(np.float32(value)),
                             len(cols), seed=5)
        ref = sk.sweep(one, p0[:, cols], 0.1, 15)
        # float32 rounding only: another batch width reorders the sums
        for x, y in zip(out, ref):
            torch.testing.assert_close(x[..., cols], y, atol=1e-5, rtol=0)


CARD_CASES = {
    'hst': dict(n=4, k=6, target=multi_controlled_x(4), kind='hst', r=0.002),
    'hst_r_per_restart': dict(n=4, k=6, target=multi_controlled_x(4),
                               kind='hst', r='per restart'),
    'state': dict(n=4, k=6, target=_ghz(4), kind='state', r=0.001),
    'state9q_r_per_restart': dict(n=9, k=12, target=_ghz(9), kind='state',
                                    r='per restart'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CARD_CASES))
def test_kernel_matches_plain_version_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA Hopper card; chip_smoke.py runs this '
                    'comparison at the main path\'s shapes')
    c = CARD_CASES[case]
    B = 37
    obj, inits, rng = _problem(c['n'], c['k'], 'xyz', c['target'],
                               0.0 if c['r'] == 'per restart' else c['r'],
                               B, seed=3, kind=c['kind'])
    if c['r'] == 'per restart':
        obj.r = torch.tensor(rng.choice([0.0, 0.0005, 0.002, 0.01], B),
                             dtype=torch.float32, device='cuda')
    p0 = torch.tensor(inits.T.copy(), device='cuda')
    mask = torch.tensor((rng.uniform(size=p0.shape) > 0.3).astype(np.float32),
                        device='cuda')
    before = sk.LAUNCHES
    out = sk.sweep(obj, p0, 0.1, 20, mask)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == before + 1
    ref = sk.sweep_reference(obj, p0, 0.1, 20, mask)
    # 20 steps: short enough that float32 drift between the two stays small
    torch.testing.assert_close(out.regloss0, ref.regloss0, atol=1e-5, rtol=0)
    torch.testing.assert_close(out.best_reg, ref.best_reg, atol=1e-4, rtol=0)
    torch.testing.assert_close(out.best_loss, ref.best_loss, atol=1e-4,
                               rtol=0)

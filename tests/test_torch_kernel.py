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


def _problem(n, k, rot, target, r, B, seed):
    nba = num_block_angles('cp', rot)
    P = 3 * n + nba * k
    cp_mask = np.zeros(P, dtype=np.float32)
    cp_mask[cp_angle_indices(n, nba, k)] = 1
    rng = np.random.default_rng(seed)
    inits = rng.uniform(0, 2 * np.pi, (B, P)).astype(np.float32)
    obj = make_batched_regloss(
        n, 'cp', rot, fill_layers(chain_layer(n), k),
        LossSpec('hst', target=target), cp_mask=cp_mask,
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
    obj, _, _ = _problem(3, 2, 'xz', u_ccz3, 0.0, 1, seed=0)
    with pytest.raises(NotImplementedError):
        sk._check_objective(obj)
    obj, _, _ = _problem(3, 2, 'xyz', u_ccz3, 0.0, 1, seed=0)
    obj.unitary_loss_func = LossSpec('state', target=np.ones(8))
    with pytest.raises(NotImplementedError):
        sk._check_objective(obj)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA Hopper card; chip_smoke.py runs this '
                    'comparison at the main path\'s shapes')
    obj, inits, rng = _problem(4, 6, 'xyz', multi_controlled_x(4), 0.002,
                                  37, seed=3)
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

"""The port's gate derivatives (cpflow_tpu_torch/sim/adjoint.py) against the
JAX package's (cpflow_tpu/sim/adjoint.py) and against autograd.

block_vjp and surface_vjp are the factored 2x2 algebra of the sweep kernel
(csrc/sweep.cu): they must give 2 Re sum Gbar * dG/dtheta, the gradient of
the whole matrices, to float64 rounding. Inputs come from numpy seeds.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cpflow_tpu.sim import adjoint as jax_adjoint
from cpflow_tpu_torch.sim import adjoint, ansatz_kernel
from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
from cpflow_tpu_torch.sim.batched import (block_matrix_batched,
                                          surface_gate_batched)

torch.set_num_threads(1)

ENTANGLERS = ['cp', 'cz', 'cx']
ROTATIONS = ['x', 'z', 'xz', 'zx', 'xyz', 'yzy']
B = 5


def _angles(n_angles, seed):
    """(n_angles, B) float32 angles in [0, 2 pi)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 2 * np.pi, (n_angles, B)).astype(np.float32)


def _cotangent(size, seed):
    """(size, size, B) complex128 cotangent Gbar."""
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=(size, size, B)) +
                        1j * rng.normal(size=(size, size, B)))


def _contract(gbar, grads):
    """(len(grads), B) gradients 2 Re sum Gbar * dG/dtheta."""
    return torch.stack([2 * (gbar * dg).sum((0, 1)).real for dg in grads])


def _seed(ent, rot):
    return 10 * ENTANGLERS.index(ent) + ROTATIONS.index(rot)


@pytest.mark.parametrize('rot', ROTATIONS)
@pytest.mark.parametrize('ent', ENTANGLERS)
def test_block_matrix_and_grads_match_jax(ent, rot):
    a = _angles(num_block_angles(ent, rot), _seed(ent, rot))
    g_jax, grads_jax = jax_adjoint.block_matrix_and_grads(ent, rot,
                                                          jnp.asarray(a))
    g, grads = adjoint.block_matrix_and_grads(ent, rot, torch.tensor(a))
    assert g.dtype == torch.complex64 and len(grads) == len(grads_jax)
    for x, y in zip([g] + grads, [g_jax] + list(grads_jax)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_surface_matrix_and_grads_match_jax(seed):
    a = _angles(3, 100 + seed)
    g_jax, grads_jax = jax_adjoint.surface_matrix_and_grads(jnp.asarray(a))
    g, grads = adjoint.surface_matrix_and_grads(torch.tensor(a))
    for x, y in zip([g] + grads, [g_jax] + list(grads_jax)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-6)


def _autograd(build, angles, gbar):
    """d/dtheta of 2 Re sum Gbar * build(angles), batch-last: the batch
    entries are independent, so one backward of the sum gives them all."""
    a = angles.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(2 * (gbar * build(a)).sum().real, a)
    return grad


def _per_restart_autograd(build, angles, gbar):
    """The same for a build of one restart's angles, restart by restart."""
    return torch.stack([_autograd(build, angles[:, b], gbar[:, :, b])
                        for b in range(angles.shape[1])], dim=1)


@pytest.mark.parametrize('rot', ROTATIONS)
@pytest.mark.parametrize('ent', ENTANGLERS)
def test_block_vjp_matches_grads_and_autograd(ent, rot):
    seed = _seed(ent, rot)
    a64 = torch.tensor(_angles(num_block_angles(ent, rot), seed),
                       dtype=torch.float64)
    gbar = _cotangent(4, 50 + seed)
    vjp = adjoint.block_vjp(ent, rot, a64, gbar)
    assert vjp.shape == a64.shape and vjp.dtype == torch.float64
    _, grads = adjoint.block_matrix_and_grads(ent, rot, a64)
    torch.testing.assert_close(vjp, _contract(gbar, grads), rtol=0,
                               atol=1e-12)
    torch.testing.assert_close(vjp, _autograd(
        lambda x: block_matrix_batched(ent, rot, x), a64, gbar), rtol=0,
        atol=1e-12)
    # sim/ansatz_kernel.block_matrix builds one restart's block in float32
    a32, g32 = a64.float(), gbar.to(torch.complex64)
    torch.testing.assert_close(
        adjoint.block_vjp(ent, rot, a32, g32), _per_restart_autograd(
            lambda x: ansatz_kernel.block_matrix(ent, rot, x), a32, g32),
        rtol=1e-5, atol=1e-5)


def test_block_vjp_of_a_cp_block_without_rotations():
    """The kernel takes an empty rotation string: G = CP(phi)."""
    a64 = torch.tensor(_angles(1, 7), dtype=torch.float64)
    gbar = _cotangent(4, 8)
    torch.testing.assert_close(
        adjoint.block_vjp('cp', '', a64, gbar),
        _autograd(lambda x: block_matrix_batched('cp', '', x), a64, gbar),
        rtol=0, atol=1e-12)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_surface_vjp_matches_grads_and_autograd(seed):
    a64 = torch.tensor(_angles(3, 200 + seed), dtype=torch.float64)
    gbar = _cotangent(2, 300 + seed)
    vjp = adjoint.surface_vjp(a64, gbar)
    _, grads = adjoint.surface_matrix_and_grads(a64)
    torch.testing.assert_close(vjp, _contract(gbar, grads), rtol=0,
                               atol=1e-12)
    torch.testing.assert_close(vjp, _autograd(surface_gate_batched, a64,
                                              gbar), rtol=0, atol=1e-12)
    a32, g32 = a64.float(), gbar.to(torch.complex64)
    torch.testing.assert_close(
        adjoint.surface_vjp(a32, g32),
        _per_restart_autograd(ansatz_kernel.surface_gate, a32, g32),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('ent,rot,n,k', [('cp', 'xyz', 3, 5),
                                         ('cz', 'xz', 3, 4),
                                         ('cx', 'y', 2, 3),
                                         ('cp', 'zx', 4, 6)])
def test_manual_value_and_grad_matches_autograd_and_jax(ent, rot, n, k):
    """The whole-matrix adjoint walk (the derivation the kernels follow)
    against autograd through the plain builder and against the JAX
    package's walk: losses within 1e-6, gradients within 1e-5 (float32)."""
    from cpflow_tpu_torch.sim import batched as tbt
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    pl = fill_layers(chain_layer(n), k)
    rng = np.random.default_rng(n * 10 + k)
    d = 2 ** n
    target = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(
        size=(d, d)))[0].astype(np.complex64)
    a = _angles(3 * n + num_block_angles(ent, rot) * k, seed=k)
    loss, grad = adjoint.manual_value_and_grad(n, ent, rot, pl, target)(
        torch.tensor(a))
    ta = torch.tensor(a, requires_grad=True)
    ref = tbt.batched_cost_hst(tbt.build_unitary_batched(n, ent, rot, pl, ta),
                               target)
    (ref_grad,) = torch.autograd.grad(ref.sum(), ta)
    torch.testing.assert_close(loss, ref.detach(), atol=1e-6, rtol=0)
    torch.testing.assert_close(grad, ref_grad, atol=1e-5, rtol=0)
    jloss, jgrad = jax_adjoint.manual_value_and_grad(n, ent, rot, pl, target)(
        jnp.asarray(a))
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), atol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-5)
    m = adjoint.hst_output_cotangent(
        tbt.build_unitary_batched(n, ent, rot, pl, torch.tensor(a)), target)[1]
    assert tuple(m.shape) == (2,) * n + (d, B)

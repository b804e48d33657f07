"""Multi-start optimization engine
(counterpart of cpflow_tpu/optimize/engine.py).

The fused sweep is kernels/sweep.py: the CUDA kernel on a CUDA tensor for a
built-in loss, the Adam loop over the unitary kernels for a custom loss, the
plain PyTorch loop on a CPU tensor. Around it this module keeps the JAX
package's entry points: ``fused_adam_sweep`` and ``minimize_fused`` with
the [initial, best] contract or a history, and the named methods
(``minimize_chain`` for one chain, ``minimize_multistart`` for a batch):
'adam', 'natural adam', 'natural gd', 'hessian', 'angle by angle'.

Where the JAX package traces one chain and vmaps it, the chains here are
written once for parameters of shape (P,) or, batch last, (P, B): Adam and
gradient descent are elementwise, and a loss of shape (B,) selects its
restarts by broadcasting. They are explicit Python loops. What a loop
calls decides where it runs: a per-chain callable is lifted over the batch
with ``torch.func.vmap``; an ansatz objective (a sim.batched.BatchedRegloss)
is batched already and, on a CUDA tensor, builds its unitary with the
hand-written forward and vjp kernels (kernels/unitary.py). The Hessian and
natural-gradient preconditioners differentiate twice, respectively take the
Jacobian of the unitary, which no kernel of either package computes: they
are plain torch ops on the caller's device, over the plain builder.

Semantics kept from the reference, so that runs from the same initial
angles reproduce it:
  * best tracking returns ``[initial, best]`` stacks where `best` is the
    parameter vector *before* the update that produced the best loss;
  * history mode records ``num_iterations`` entries: the initial params plus
    the first ``num_iterations - 1`` updates, with ``loss[i]`` evaluated at
    ``params[i]``.

Every entry point takes ``device=None``: the device of the initial angles
if they are a tensor, else 'cuda'; it raises if that is a CUDA device and
none is visible, and never runs on the CPU unasked.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Optional

import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.kernels import sweep as sweep_kernel
from cpflow_tpu_torch.kernels.sweep import adam_step
from cpflow_tpu_torch.ops.losses import fubini_study
from cpflow_tpu_torch.ops.trig import min_angle
from cpflow_tpu_torch.sim.batched import BatchedRegloss


# --------------------------------------------------------------------------
# Chains: params (P,) with a scalar loss, or (P, B) with a loss (B,)
# --------------------------------------------------------------------------

def adam_chain(loss_and_grad: Callable, initial_params: torch.Tensor,
               learning_rate: float = 0.1, num_iterations: int = 5000,
               keep_history: bool = True,
               preconditioner: Optional[Callable] = None):
    """Adam (optax.adam arithmetic) from initial_params.

    loss_and_grad: params -> (loss, grad). Returns (params_history,
    loss_history), stacked on a new leading axis: num_iterations entries
    with keep_history, else [initial, best] (see the module docstring)."""
    params = initial_params.detach().clone()
    m, v = torch.zeros_like(params), torch.zeros_like(params)

    def update(params, m, v, t):
        loss, grads = loss_and_grad(params)
        if preconditioner is not None:
            grads = preconditioner(params, grads)
        new_params, m, v = adam_step(params, grads, m, v, t, learning_rate)
        return new_params, m, v, loss

    if keep_history:
        params_hist, loss_hist = [], []
        for t in range(1, num_iterations + 1):
            params_hist.append(params)
            params, m, v, loss = update(params, m, v, t)
            loss_hist.append(loss)
        return torch.stack(params_hist), torch.stack(loss_hist)

    initial_loss, _ = loss_and_grad(params)
    best_params, best_loss = params, initial_loss
    for t in range(1, num_iterations + 1):
        new_params, m, v, loss = update(params, m, v, t)
        improved = loss < best_loss
        best_loss = torch.where(improved, loss, best_loss)
        best_params = torch.where(improved, params, best_params)
        params = new_params
    return (torch.stack([initial_params.detach(), best_params]),
            torch.stack([initial_loss, best_loss]))


def gradient_descent_chain(loss_and_grad: Callable,
                           initial_params: torch.Tensor,
                           learning_rate: float = 0.1,
                           num_iterations: int = 5000,
                           preconditioner: Optional[Callable] = None):
    """Plain (optionally preconditioned) gradient descent, with history."""
    params = initial_params.detach().clone()
    params_hist, loss_hist = [], []
    for _ in range(num_iterations):
        loss, grads = loss_and_grad(params)
        if preconditioner is not None:
            grads = preconditioner(params, grads)
        params_hist.append(params)
        loss_hist.append(loss)
        params = params - learning_rate * grads
    return torch.stack(params_hist), torch.stack(loss_hist)


def angle_by_angle_update(f: Callable, angles: torch.Tensor) -> torch.Tensor:
    """Coordinate descent sweep: set each angle to its closed-form optimum,
    one at a time. f: angles -> loss, for (P,) or (P, B) angles."""
    angles = angles.clone()
    for i in range(angles.shape[0]):
        def probe(a, i=i):
            shifted = angles.clone()
            shifted[i] = a
            return f(shifted)
        angles[i] = min_angle(probe)
    return angles


def angle_by_angle_chain(f: Callable, initial_angles: torch.Tensor,
                         num_iterations: int = 5000):
    """Repeated coordinate-descent sweeps, with history."""
    angles = initial_angles.detach().clone()
    hist, losses = [], []
    with torch.no_grad():
        for _ in range(num_iterations):
            hist.append(angles)
            losses.append(f(angles))
            angles = angle_by_angle_update(f, angles)
    return torch.stack(hist), torch.stack(losses)


# --------------------------------------------------------------------------
# Preconditioners: per chain, params (P,) and grads (P,) -> (P,)
# --------------------------------------------------------------------------

def plain_hessian_preconditioner(cost_func, tikhonov_delta=1e-4):
    def preconditioner(params, grads):
        h = torch.func.hessian(cost_func)(params)
        reg = h + tikhonov_delta * torch.eye(params.shape[0], dtype=h.dtype,
                                             device=h.device)
        return torch.linalg.solve(reg, grads)
    return preconditioner


def _conjugate_gradient(matvec, b, tol=1e-5, maxiter=None):
    """Solve A x = b for a symmetric positive-definite A given as matvec,
    from x = 0, as jax.scipy.sparse.linalg.cg does: it stops when
    |r| <= tol |b|, after at most 10 P iterations."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = torch.dot(r, r)
    limit = float(tol * tol * torch.dot(b, b))
    for _ in range(maxiter or 10 * b.shape[0]):
        if float(rs) <= limit:
            break
        ap = matvec(p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x


def sparse_hessian_preconditioner(cost_func, tikhonov_delta=1e-4):
    def hvp(primals, tangents):
        return torch.func.jvp(torch.func.grad(cost_func), (primals,),
                              (tangents,))[1]

    def preconditioner(params, grads):
        return _conjugate_gradient(
            lambda x: hvp(params, x) + tikhonov_delta * x, grads)
    return preconditioner


def plain_natural_preconditioner(u_func, tikhonov_delta=1e-4):
    def preconditioner(params, grads):
        g = fubini_study(u_func, params)
        g = g + tikhonov_delta * torch.eye(params.shape[0], dtype=g.dtype,
                                           device=g.device)
        return torch.linalg.solve(g, grads)
    return preconditioner


def _make_preconditioner(method, loss_func, u_func):
    if method == 'natural adam' or method == 'natural gd':
        if u_func is None:
            raise ValueError(f"method {method!r} needs u_func")
        return plain_natural_preconditioner(u_func)
    if method == 'hessian':
        return plain_hessian_preconditioner(loss_func)
    return None


# --------------------------------------------------------------------------
# Results
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RawResult:
    """Stacked learning results for a whole restart batch.

    Attributes hold tensors with leading batch axis B (absent when the run
    was single-start):
      params:  (B, T, P) or (B, 2, P)
      regloss: (B, T) or (B, 2)       the minimized objective
      loss:    same shape             objective minus regularization
      reg:     same shape             regularization (None if no reg func)
    Supports the reference's list-of-dicts access pattern:
    ``raw[i]['regloss']``."""
    params: Any
    regloss: Any
    loss: Any
    reg: Any = None
    batched: bool = True

    def __len__(self):
        return self.params.shape[0] if self.batched else 1

    def __getitem__(self, i):
        if not self.batched:
            raise TypeError("single result is not indexable")
        d = {'params': self.params[i], 'regloss': self.regloss[i],
             'loss': self.loss[i]}
        if self.reg is not None:
            d['reg'] = self.reg[i]
        return d

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def as_single(self):
        d = {'params': self.params, 'regloss': self.regloss,
             'loss': self.loss}
        if self.reg is not None:
            d['reg'] = self.reg
        return d


# --------------------------------------------------------------------------
# The fused sweep
# --------------------------------------------------------------------------

def fused_adam_sweep(objective, params0: torch.Tensor,
                     learning_rate: float = 0.1, num_iterations: int = 5000,
                     grad_mask_pb: Optional[torch.Tensor] = None,
                     target_loss: Optional[float] = None):
    """params0 (P, B) -> (best_params (P, B), best_regloss (B,),
    best_loss (B,)) with best-so-far tracking. target_loss stops the sweep
    once every restart's best loss is at or under it (on the card it is
    checked every kernels.sweep.TARGET_CHECK_EVERY steps)."""
    res = sweep_kernel.sweep(objective, params0, learning_rate,
                             num_iterations, grad_mask_pb, target_loss)
    return res.best_params, res.best_reg, res.best_loss


def _objective_value_and_grad(objective, mask_pb=None):
    """params (P, B) -> ((regloss_B, loss_B), masked gradient of
    sum(regloss)) of a batched objective, under autograd: on a CUDA tensor
    through the unitary kernels."""
    def value_and_grad(params):
        p = params.detach().requires_grad_(True)
        regloss, loss = objective(p)
        (grad,) = torch.autograd.grad(regloss.sum(), p)
        if mask_pb is not None:
            grad = grad * mask_pb
        return (regloss.detach(), loss.detach()), grad
    return value_and_grad


def minimize_fused(objective, initial_params_batch,
                   learning_rate: float = 0.1, num_iterations: int = 5000,
                   keep_history: bool = False, grad_mask=None,
                   target_loss: Optional[float] = None, *,
                   device=None) -> RawResult:
    """Fused batch-last multi-start Adam from (B, P) initial angles (or
    (P,) for one chain).

    objective: f(params_PB) -> (regloss_B, loss_B), a
    sim.batched.BatchedRegloss. grad_mask: optional (B, P) 0/1 mask
    freezing coordinates. keep_history=False returns the [initial, best]
    stacks of the sweep (kernels/sweep.py routes it); keep_history=True
    records every step, params (B, T, P) and regloss, loss (B, T), with the
    objective's unitary from the unitary kernels on the card (the fused
    sweep kernel keeps no history) and without target_loss."""
    device = config.resolve_device(initial_params_batch, device)
    initial = torch.as_tensor(initial_params_batch, dtype=config.real_dtype,
                              device=device)
    batched = initial.dim() == 2
    if not batched:
        initial = initial[None]
    mask_pb = None if grad_mask is None else \
        torch.as_tensor(grad_mask, dtype=config.real_dtype,
                        device=device).reshape(initial.shape).T.contiguous()
    params0 = initial.T.contiguous()
    if keep_history:
        values = []
        value_and_grad = _objective_value_and_grad(objective, mask_pb)

        def loss_and_grad(params):
            (regloss, loss), grad = value_and_grad(params)
            values.append(loss)
            return regloss, grad

        params_hist, regloss_hist = adam_chain(
            loss_and_grad, params0.to(objective.dtype), learning_rate,
            num_iterations, keep_history=True)
        params = params_hist.permute(2, 0, 1)                  # (B, T, P)
        regloss, loss = regloss_hist.T, torch.stack(values).T  # (B, T)
    else:
        res = sweep_kernel.sweep(objective, params0, learning_rate,
                                 num_iterations, mask_pb, target_loss)
        params = torch.stack([initial, res.best_params.T], dim=1)
        regloss = torch.stack([res.regloss0, res.best_reg], dim=1)
        loss = torch.stack([res.loss0, res.best_loss], dim=1)
    reg = regloss - loss
    if not batched:
        params, regloss, loss, reg = params[0], regloss[0], loss[0], reg[0]
    return RawResult(params=params, regloss=regloss, loss=loss, reg=reg,
                     batched=batched)


# --------------------------------------------------------------------------
# Named methods
# --------------------------------------------------------------------------

def _run_method(loss_func, loss_and_grad, initial_params, method,
                learning_rate, num_iterations, keep_history, preconditioner):
    """One named method on params (P,) or (P, B); the preconditioner, if
    any, takes and returns arrays of that shape."""
    if method in ('adam', 'natural adam'):
        return adam_chain(loss_and_grad, initial_params,
                          learning_rate=learning_rate,
                          num_iterations=num_iterations,
                          keep_history=keep_history,
                          preconditioner=preconditioner)
    if method in ('natural gd', 'hessian'):
        return gradient_descent_chain(loss_and_grad, initial_params,
                                      learning_rate=learning_rate,
                                      num_iterations=num_iterations,
                                      preconditioner=preconditioner)
    if method == 'angle by angle':
        return angle_by_angle_chain(loss_func, initial_params,
                                    num_iterations=num_iterations)
    raise ValueError(f"method {method!r} not supported")


def minimize_chain(loss_func, initial_params, method: str = 'adam',
                   learning_rate: float = 0.1, num_iterations: int = 5000,
                   keep_history: bool = True, u_func=None, grad_mask=None, *,
                   device=None):
    """One minimization chain by named method: loss_func maps (P,) angles
    to a scalar. `grad_mask`, if given, freezes coordinates where mask == 0.
    Returns (params_history, loss_history) of the method's chain."""
    device = config.resolve_device(initial_params, device)
    initial = torch.as_tensor(initial_params, dtype=config.real_dtype,
                              device=device)
    mask = None if grad_mask is None else torch.as_tensor(
        grad_mask, dtype=initial.dtype, device=device)

    def loss_and_grad(params):
        p = params.detach().requires_grad_(True)
        loss = loss_func(p)
        (grad,) = torch.autograd.grad(loss, p)
        return loss.detach(), grad if mask is None else grad * mask

    precond = None if method == 'adam' else \
        _make_preconditioner(method, loss_func, u_func)
    return _run_method(loss_func, loss_and_grad, initial, method,
                       learning_rate, num_iterations, keep_history, precond)


def minimize_multistart(loss_func, initial_params_batch,
                        method: str = 'adam', learning_rate: float = 0.1,
                        num_iterations: int = 5000,
                        keep_history: bool = True, regularization_func=None,
                        u_func=None, grad_mask=None,
                        compute_losses: bool = True, sharding=None,
                        batch_axis: int = 0, *, device=None) -> RawResult:
    """Batched multi-start minimization by named method.

    initial_params_batch: (B, P) angles, or (P,) for a single chain.
    loss_func is either a per-chain callable, (P,) angles -> scalar, with
    an optional per-chain regularization_func added to it (both lifted over
    the restarts with torch.func.vmap), or a sim.batched.BatchedRegloss,
    which is batched already, carries its own penalty and, on a CUDA
    tensor, takes its unitary and its gradient from the unitary kernels.
    The preconditioned methods differentiate the plain builder (u_func, or
    a plain copy of the objective). grad_mask: (P,) for every chain, or
    (B, P). batch_axis is a TPU layout knob: accepted and ignored, results
    are batch-leading either way. sharding (the device mesh) is not ported
    and raises."""
    if sharding is not None:
        raise NotImplementedError('sharding over a device mesh is not ported')
    device = config.resolve_device(initial_params_batch, device)
    initial = torch.as_tensor(initial_params_batch, dtype=config.real_dtype,
                              device=device)
    batched = initial.dim() == 2
    if not batched:
        initial = initial[None]
    mask_pb = None
    if grad_mask is not None:
        mask = torch.as_tensor(grad_mask, dtype=initial.dtype, device=device)
        mask_pb = mask[:, None] if mask.dim() == 1 else mask.T

    is_objective = isinstance(loss_func, BatchedRegloss)
    if is_objective:
        if regularization_func is not None:
            raise ValueError('a BatchedRegloss carries its own penalty')
        value_and_grad = _objective_value_and_grad(loss_func, mask_pb)
        initial = initial.to(loss_func.dtype)

        def loss_and_grad(params):
            (regloss, _), grad = value_and_grad(params)
            return regloss, grad

        def regloss_batch(params):
            with torch.no_grad():
                return loss_func(params)[0]

        plain = copy.copy(loss_func)
        plain.plain = True
        regloss_chain = lambda p: plain(p[:, None])[0][0]
    else:
        if regularization_func is None:
            regloss_chain = loss_func
        else:
            regloss_chain = lambda p: loss_func(p) + regularization_func(p)
        grad_and_value = torch.func.vmap(
            torch.func.grad_and_value(regloss_chain), in_dims=1,
            out_dims=(1, 0))
        regloss_batch = torch.func.vmap(regloss_chain, in_dims=1)

        def loss_and_grad(params):
            grad, value = grad_and_value(params)
            return value, grad if mask_pb is None else grad * mask_pb

    precond = None
    if method != 'adam':
        chain_precond = _make_preconditioner(method, regloss_chain, u_func)
        if chain_precond is not None:
            precond = torch.func.vmap(chain_precond, in_dims=1, out_dims=1)

    params_hist, regloss_hist = _run_method(
        regloss_batch, loss_and_grad, initial.T.contiguous(), method,
        learning_rate, num_iterations, keep_history, precond)
    params_hist = params_hist.permute(2, 0, 1)                 # (B, T, P)
    regloss_hist = regloss_hist.T                              # (B, T)

    reg_hist, loss_hist = None, regloss_hist
    if is_objective and loss_func.has_penalty:
        reg_hist = loss_func.regularization(params_hist.permute(2, 1, 0)).T
    elif compute_losses and regularization_func is not None:
        reg_hist = torch.func.vmap(torch.func.vmap(regularization_func))(
            params_hist)
    if reg_hist is not None:
        loss_hist = regloss_hist - reg_hist

    if not batched:
        params_hist, regloss_hist, loss_hist = (
            params_hist[0], regloss_hist[0], loss_hist[0])
        if reg_hist is not None:
            reg_hist = reg_hist[0]
    return RawResult(params=params_hist, regloss=regloss_hist,
                     loss=loss_hist, reg=reg_hist, batched=batched)

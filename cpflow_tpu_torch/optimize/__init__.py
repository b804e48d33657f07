"""Optimization engine: batched multi-start minimization
(counterpart of cpflow_tpu/optimize/__init__.py).

The reference-compatible entry points ``mynimize``, ``mynimize_repeated``
and ``unitary_learn`` are thin wrappers over ``engine``. Each takes
``device=None`` (the initial angles' device if they are a tensor, else
'cuda'; see engine) and, in place of the JAX package's ``PRNGKey(0)``, an
explicit ``generator`` for the initial angles it draws itself: the same
seed gives other angles than the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.ops.losses import cost_HST, disc2_swap
from cpflow_tpu_torch.ops.penalty import LinearPenalty, cp_penalty_L1
from cpflow_tpu_torch.ops.trig import random_angles
from cpflow_tpu_torch.optimize.engine import (  # noqa: F401
    RawResult,
    adam_chain,
    angle_by_angle_chain,
    angle_by_angle_update,
    gradient_descent_chain,
    minimize_chain,
    minimize_fused,
    minimize_multistart,
    plain_hessian_preconditioner,
    plain_natural_preconditioner,
    sparse_hessian_preconditioner,
)
from cpflow_tpu_torch.sim.batched import make_batched_regloss


def _draw(shape, generator, device):
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return random_angles(shape, generator, device)


def mynimize(loss_func, num_params, method='adam', learning_rate=0.1,
             u_func=None, target_loss=1e-7, keep_history=True,
             initial_params=None, num_iterations=5000, *, device=None,
             generator=None, **kwargs):
    """Single-chain minimization, reference signature. Returns
    (params_history, loss_history)."""
    device = config.resolve_device(initial_params, device)
    if initial_params is None:
        initial_params = _draw((num_params,), generator, device)
    return minimize_chain(loss_func, initial_params, method=method,
                          learning_rate=learning_rate,
                          num_iterations=num_iterations,
                          keep_history=keep_history, u_func=u_func,
                          device=device)


def mynimize_repeated(loss_func, num_params, method='adam', learning_rate=0.1,
                      target_loss=1e-7, u_func=None,
                      initial_params_batch=None, num_repeats=1,
                      regularization_func=None, keep_history=True,
                      compute_losses=True, num_iterations=5000,
                      sharding=None, *, device=None, generator=None,
                      **kwargs):
    """Batched multi-start minimization, reference signature and return
    structure: a list of per-restart dicts with 'params'/'loss'
    (+'reg'/'regloss' when regularized), or a single dict when the input
    was a single vector. loss_func: a per-chain callable, or a
    sim.batched.BatchedRegloss (see engine.minimize_multistart)."""
    device = config.resolve_device(initial_params_batch, device)
    if initial_params_batch is None:
        initial_params_batch = _draw((num_repeats, num_params), generator,
                                     device)
        input_is_vector = num_repeats != 1
        if not input_is_vector:
            initial_params_batch = initial_params_batch[0]
    else:
        initial_params_batch = torch.as_tensor(
            initial_params_batch, dtype=config.real_dtype, device=device)
        input_is_vector = initial_params_batch.dim() == 2

    raw = minimize_multistart(
        loss_func, initial_params_batch, method=method,
        learning_rate=learning_rate, num_iterations=num_iterations,
        keep_history=keep_history, regularization_func=regularization_func,
        u_func=u_func, compute_losses=compute_losses, sharding=sharding,
        device=device)

    regularized = raw.reg is not None and compute_losses
    if input_is_vector:
        if regularized:
            return [{'params': p['params'], 'loss': p['loss'],
                     'reg': p['reg'], 'regloss': p['regloss']} for p in raw]
        return [{'params': p['params'], 'loss': p['regloss']} for p in raw]
    d = raw.as_single()
    if regularized:
        return {'params': d['params'], 'loss': d['loss'],
                'reg': d['reg'], 'regloss': d['regloss']}
    return {'params': d['params'], 'loss': d['regloss']}


def _penalty_function(ropts):
    if ropts['function'] == 'linear':
        plato = ropts.get('plato', 0.05)
        return LinearPenalty(ropts['xmax'], ropts['ymax'], plato, plato,
                             plato)
    if ropts['function'] == 'L1':
        return cp_penalty_L1
    raise ValueError(f"penalty function {ropts['function']!r} not supported")


def unitary_learn(u_func, u_target, num_params, method='adam',
                  learning_rate=0.1, target_loss=1e-7, disc_func=None,
                  regularization_options=None, initial_angles=None,
                  num_repeats=1, keep_history=True, *, ansatz=None, **kwargs):
    """Learn a target unitary with optional CP regularization, reference
    signature.

    u_func maps (P,) angles to a unitary and is differentiated as it is,
    lifted over the restarts. With ``ansatz`` (an api.Ansatz whose unitary
    u_func is; Ansatz.learn passes itself) the ansatz is learned as a
    batched objective instead (sim.batched.BatchedRegloss): on the card its
    unitary and gradient then come from the hand-written kernels, and
    u_func serves only the natural-gradient preconditioner."""
    u_target = np.asarray(u_target)
    num_qubits = int(math.log2(u_target.shape[0]))
    if disc_func == 'swap':
        unitary_loss = lambda u: disc2_swap(u, u_target, num_qubits)
    else:
        unitary_loss = lambda u: cost_HST(u, u_target)

    ropts = None if regularization_options is None else \
        dict(regularization_options)
    if ansatz is not None:
        pen = {} if ropts is None else dict(
            cp_mask=ropts['cp_mask'], r=ropts['r'],
            regularization_func=_penalty_function(ropts))
        loss_func = make_batched_regloss(
            ansatz.num_qubits, ansatz.entangling_gate_name,
            ansatz.rotation_gates, ansatz.placements, unitary_loss, **pen)
        regularization_func = None
    else:
        loss_func = lambda angs: unitary_loss(u_func(angs))
        regularization_func = None
        if ropts is not None:
            pf, r = _penalty_function(ropts), ropts['r']
            cp_mask = np.asarray(ropts['cp_mask'])
            regularization_func = lambda angs: r * pf(
                angs * torch.as_tensor(cp_mask, dtype=angs.dtype,
                                       device=angs.device)).sum()

    return mynimize_repeated(loss_func, num_params, method=method,
                             learning_rate=learning_rate, u_func=u_func,
                             num_repeats=num_repeats,
                             initial_params_batch=initial_angles,
                             regularization_func=regularization_func,
                             target_loss=target_loss,
                             keep_history=keep_history, **kwargs)

"""CP-template candidate pipeline: init, evaluation, projection, verification
(counterpart of cpflow_tpu/optimize/candidates.py), and the adaptive
search's bucketed raw stage (the stage closure of
cpflow_tpu/api.py:Synthesize._bucketed_stage).

PRNG: initial angles are drawn from ``torch.Generator(device)
.manual_seed(random_seed)``. The JAX package reproduces the reference's
threefry split tree, so that fixed seeds give the reference's batches; the
port does not. The same seed gives other initial angles in the two packages,
and the tests feed numpy-drawn initial angles to both.

Verification re-optimizes all prospective candidates at once: projected CP
angles are frozen in place by a gradient mask, and since CP(0) = Id and
CP(pi) = CZ, the frozen unitary is exactly the projected circuit's.
"""

from __future__ import annotations

import copy
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.optimize import engine
from cpflow_tpu_torch.ops.trig import random_angles
from cpflow_tpu_torch.sim import batched as batched_sim


# --------------------------------------------------------------------------
# Initial angles
# --------------------------------------------------------------------------

def generate_initial_angles_batch(generator: torch.Generator, num_angles: int,
                                  cp_mask, cp_dist: str = 'uniform',
                                  batch_size: int = 1, *,
                                  device) -> torch.Tensor:
    """(batch_size, num_angles) initial angles: uniform in [0, 2pi), CP angles
    optionally zeroed ('0') or drawn from N(0, 1.5^2) ('normal')."""
    rnd = random_angles((batch_size, num_angles), generator, device)
    if cp_dist == 'uniform':
        return rnd
    mask = torch.as_tensor(np.asarray(cp_mask), dtype=config.real_dtype,
                           device=device)
    if cp_dist == '0':
        return rnd * (1 - mask)
    if cp_dist == 'normal':
        normal = torch.randn((batch_size, num_angles), generator=generator,
                             device=device, dtype=config.real_dtype)
        return rnd * (1 - mask) + 1.5 * normal * mask
    raise ValueError(f"cp_dist {cp_dist!r} not supported")


# --------------------------------------------------------------------------
# Parameter-freezing helpers
# --------------------------------------------------------------------------

def insert_params(params, insertion_params, insertion_indices,
                  as_tensor: bool = True):
    """Merge `insertion_params` into `params` at `insertion_indices`:
    params=[0,1,2,3], insertion=[-1,-2,-4], indices=[0,2,4]
    -> [-1, 0, -2, 1, -4, 2, 3]. As a tensor (differentiable in params) or,
    with as_tensor=False, a numpy array."""
    insertion_indices = list(insertion_indices)
    total = len(params) + len(insertion_params)
    param_indices = [i for i in range(total) if i not in insertion_indices]
    if not as_tensor:
        res = np.zeros(total)
        res[param_indices] = np.asarray(params)
        res[insertion_indices] = np.asarray(insertion_params)
        return res
    params = torch.as_tensor(params)
    if not params.is_floating_point():
        params = params.to(config.real_dtype)
    inserted = torch.as_tensor(insertion_params, dtype=params.dtype,
                               device=params.device)
    source = np.argsort(param_indices + insertion_indices)
    return torch.cat([params, inserted])[torch.as_tensor(
        source, device=params.device)]


def constrained_function(f, fixed_params, indices, as_tensor: bool = True):
    """f with the parameters at `indices` fixed. The batched verification
    uses gradient masks instead; this form serves the single-candidate
    wrappers and ad-hoc constrained optimization."""
    def cf(free_params):
        return f(insert_params(free_params, fixed_params, indices,
                               as_tensor=as_tensor))
    return cf


# --------------------------------------------------------------------------
# CZ counting / projection
# --------------------------------------------------------------------------

def cz_value(a: torch.Tensor, threshold: float = 1e-2) -> torch.Tensor:
    """0 if a CP angle is ~0 or 2pi, 1 if ~pi, else 2 (a CP gate costs two
    CZ), elementwise."""
    a = torch.remainder(a, 2 * math.pi)
    near_zero = (a < threshold) | (torch.abs(a - 2 * math.pi) < threshold)
    near_pi = torch.abs(a - math.pi) < threshold
    two = torch.full_like(a, 2, dtype=torch.int32)
    return torch.where(near_zero, 0, torch.where(near_pi, 1, two))


def count_cz(angles: torch.Tensor, threshold: float = 0.2) -> torch.Tensor:
    """Total CZ count over the last axis of CP angles."""
    return cz_value(angles, threshold=threshold).sum(dim=-1)


def project_cp_angles(a: torch.Tensor, threshold: float = 0.2) -> torch.Tensor:
    """Snap angles near pi to pi and near 0/2pi to 0; others reduced to
    [0, 2pi) and otherwise unchanged."""
    a = torch.remainder(a, 2 * math.pi)
    near_pi = torch.abs(a - math.pi) < threshold
    near_zero = (torch.abs(a) < threshold) | \
        (torch.abs(a - 2 * math.pi) < threshold)
    return torch.where(near_pi, math.pi, torch.where(near_zero, 0.0, a))


# --------------------------------------------------------------------------
# Raw stage and its evaluation
# --------------------------------------------------------------------------

class EvaluatedBatch(NamedTuple):
    """Host-side summary of a raw multi-start run."""
    cz: np.ndarray       # (B,) int32 — CZ count of the projected circuit
    loss: np.ndarray     # (B,) f32  — loss at the best regloss iterate
    angles: np.ndarray   # (B, P) f32 — angles at the best regloss iterate


def evaluate_raw_batch(raw: engine.RawResult, cp_mask,
                       threshold: float = 0.2) -> EvaluatedBatch:
    """Best-iterate selection and CZ count for every restart."""
    best_i = torch.argmin(raw.regloss, dim=1)
    rows = torch.arange(len(raw), device=raw.regloss.device)
    loss = raw.loss[rows, best_i]
    angles = raw.params[rows, best_i]
    mask = torch.as_tensor(np.asarray(cp_mask), dtype=config.real_dtype,
                           device=angles.device)
    cz = count_cz(angles * mask, threshold=threshold).to(torch.int32)
    return EvaluatedBatch(cz=cz.cpu().numpy(), loss=loss.cpu().numpy(),
                          angles=angles.cpu().numpy())


def run_raw_stage_fused(objective, seed: int, batch_size: int,
                        num_angles: int, cp_mask, cp_dist: str = 'uniform',
                        threshold: float = 0.2, learning_rate: float = 0.1,
                        num_iterations: int = 2000, *, device,
                        initial_angles: Optional[np.ndarray] = None
                        ) -> EvaluatedBatch:
    """The raw sampling stage: initial angles (drawn from `seed`, or given
    as a (batch_size, num_angles) array), the fused Adam sweep, CZ counting
    at the best iterate, one host transfer."""
    if initial_angles is None:
        gen = torch.Generator(device=device).manual_seed(int(seed))
        inits = generate_initial_angles_batch(
            gen, num_angles, cp_mask, cp_dist=cp_dist,
            batch_size=batch_size, device=device)
    else:
        inits = torch.as_tensor(np.asarray(initial_angles),
                                dtype=config.real_dtype, device=device)
    best_params, _, best_loss = engine.fused_adam_sweep(
        objective, inits.T.contiguous(), learning_rate=learning_rate,
        num_iterations=num_iterations)
    # the best entry never exceeds the initial one, so the argmin over
    # [initial, best] always lands on it
    mask = torch.as_tensor(np.asarray(cp_mask), dtype=config.real_dtype,
                           device=device)
    cz = cz_value(best_params * mask[:, None],
                  threshold=threshold).sum(dim=0).to(torch.int32)
    return EvaluatedBatch(cz=cz.cpu().numpy(), loss=best_loss.cpu().numpy(),
                          angles=best_params.T.cpu().numpy())


def run_bucketed_stage(objective, seeds, rs, actives, num_samples: int,
                       cp_mask, cp_dist: str = 'uniform',
                       threshold: float = 0.2, learning_rate: float = 0.1,
                       num_iterations: int = 2000, *, device,
                       params_in: Optional[np.ndarray] = None):
    """The adaptive search's bucketed raw stage for N trials at once, all on
    one padded template: trial j has seed seeds[j], penalty weight rs[j] and
    the (P,) 0/1 mask actives[j] of the angles its shorter template uses.

    The trials sit side by side on the restart axis, trial j on columns
    [j * S, (j + 1) * S) with S = num_samples, and run as ONE sweep with r
    and the gradient mask given per restart. Trial j's initial angles are
    drawn from torch.Generator(device).manual_seed(seeds[j]) and multiplied
    by its mask, so the inactive tail blocks start at identity
    (CP(0) = R(0) = Id) and the mask keeps them there. params_in, an
    (N, S, P) array, resumes from earlier angles in place of the draws,
    taken as they are (a segment chained after a first one).

    objective: the padded template's sim.batched.BatchedRegloss; its r is
    ignored. Returns numpy (cz (N, S) int32, loss (N, S), angles (N, S, P))
    at each restart's best iterate."""
    actives = np.asarray(actives, dtype=np.float32)
    N, P = actives.shape
    S = int(num_samples)
    if params_in is None:
        inits = []
        for j, seed in enumerate(seeds):
            gen = torch.Generator(device=device).manual_seed(int(seed))
            batch = generate_initial_angles_batch(
                gen, P, cp_mask, cp_dist=cp_dist, batch_size=S,
                device=device)
            inits.append(batch * torch.as_tensor(actives[j], device=device))
        inits = torch.cat(inits, dim=0)
    else:
        inits = torch.as_tensor(np.asarray(params_in).reshape(N * S, P),
                                dtype=config.real_dtype, device=device)
    per_restart = torch.as_tensor(actives, device=device).repeat_interleave(
        S, dim=0)                                              # (N S, P)
    run = copy.copy(objective)
    run.r = torch.as_tensor(np.asarray(rs, dtype=np.float32),
                            device=device).repeat_interleave(S)
    best_params, _, best_loss = engine.fused_adam_sweep(
        run, inits.T.contiguous(), learning_rate=learning_rate,
        num_iterations=num_iterations,
        grad_mask_pb=per_restart.T.contiguous())
    mask = torch.as_tensor(np.asarray(cp_mask), dtype=config.real_dtype,
                           device=device)
    cz = cz_value(best_params * mask[:, None],
                  threshold=threshold).sum(dim=0).to(torch.int32)
    return (cz.reshape(N, S).cpu().numpy(),
            best_loss.reshape(N, S).cpu().numpy(),
            best_params.T.reshape(N, S, P).cpu().numpy())


def filter_prospective(ev: EvaluatedBatch, threshold_cz_count,
                       threshold_loss) -> np.ndarray:
    """Indices of candidates below both thresholds, sorted by CZ count."""
    ok = (ev.cz <= threshold_cz_count) & (ev.loss <= threshold_loss)
    idx = np.nonzero(ok)[0]
    order = np.argsort(ev.cz[idx], kind='stable')
    return idx[order]


# --------------------------------------------------------------------------
# Reference-shaped single-candidate wrappers
# --------------------------------------------------------------------------

def convert_cp_to_cz(anz, angles, threshold=0.2, *, device=None):
    """Project near-0/pi CP angles and return (circ_func, u_func,
    free_angles) with the projected angles fixed. circ_func maps free
    angles to an IR Circuit; u_func maps free angles (a tensor) to the
    unitary. free_angles lie on `device`: the angles' own device if they
    are a tensor, else the card (config.resolve_device)."""
    device = config.resolve_device(angles, device)
    angles = torch.as_tensor(angles, dtype=config.real_dtype, device=device)
    cp_indices = np.nonzero(np.asarray(anz.cp_mask) == 1)[0]
    projected_all = project_cp_angles(
        angles[torch.as_tensor(cp_indices, device=angles.device)],
        threshold=threshold).cpu().numpy()
    snapped = (projected_all == 0.0) | (projected_all == np.float32(np.pi))
    projected_values = projected_all[snapped]
    projected_indices = [int(i) for i in cp_indices[snapped]]
    free = [i for i in range(len(angles)) if i not in projected_indices]
    free_angles = angles[torch.as_tensor(free, dtype=torch.long,
                                         device=angles.device)]
    circ_func = constrained_function(
        lambda angs: anz.circuit(list(np.asarray(angs))),
        projected_values, projected_indices, as_tensor=False)
    u_func = constrained_function(anz.unitary, projected_values,
                                  projected_indices)
    return circ_func, u_func, free_angles


def evaluate_cp_result(res, cp_mask, threshold=0.2):
    """(cz, loss, angles) at the best regloss iterate of one learning
    history. Prefer evaluate_raw_batch for whole batches."""
    regloss = torch.as_tensor(res['regloss'])
    best_i = int(torch.argmin(regloss))
    loss = res['loss'][best_i]
    angles = torch.as_tensor(res['params'][best_i])
    mask = torch.as_tensor(np.asarray(cp_mask), dtype=angles.dtype,
                           device=angles.device)
    cz = int(count_cz(angles * mask, threshold=threshold))
    return cz, loss, angles


def filter_cp_results(res_list, cp_mask, threshold_cz_count, threshold_loss,
                      threshold_cp=0.2, disable_tqdm=False):
    """[[cz, res], ...] for histories passing both thresholds, sorted by CZ
    count."""
    selected = []
    for res in res_list:
        cz, loss, _ = evaluate_cp_result(res, cp_mask, threshold=threshold_cp)
        if cz <= threshold_cz_count and float(loss) <= threshold_loss:
            selected.append([cz, res])
    selected.sort(key=lambda x: x[0])
    return selected


def verify_cp_result(res, anz, unitary_loss_func, options,
                     keep_history=False, *, device=None):
    """Project one candidate and re-optimize its free angles, one chain
    differentiated as it is on `device`: that of res['params'] if it is a
    tensor, else the card (config.resolve_device). Returns (success,
    num_cz_gates, circ_func, u_func, best_angles[, histories])."""
    device = config.resolve_device(res['params'], device)
    num_cz_gates, _, angles = evaluate_cp_result(
        res, anz.cp_mask, threshold=options.threshold_cp)
    circ_func, u_func, free_angles = convert_cp_to_cz(
        anz, angles, threshold=options.threshold_cp, device=device)

    loss_fn = lambda angs: unitary_loss_func(u_func(angs))
    hist, losses = engine.minimize_chain(
        loss_fn, free_angles, method=options.method,
        learning_rate=options.learning_rate_at_verification,
        num_iterations=options.num_gd_iterations_at_verification,
        keep_history=keep_history, device=device)

    best_i = int(torch.argmin(losses))
    best_angs = hist[best_i]
    best_loss = float(losses[best_i])
    if not keep_history:
        return (best_loss <= options.target_loss, num_cz_gates, circ_func,
                u_func, best_angs)
    return (best_loss <= options.target_loss, num_cz_gates, circ_func,
            u_func, best_angs, hist, losses)


# --------------------------------------------------------------------------
# Batched verification
# --------------------------------------------------------------------------

class VerifiedBatch(NamedTuple):
    success: np.ndarray      # (C,) bool — best loss under target
    best_loss: np.ndarray    # (C,) f32
    best_angles: np.ndarray  # (C, P) f32 — full vector, projected entries frozen
    cz: np.ndarray           # (C,) int32 — CZ count of the projected circuit
    frozen: np.ndarray       # (C, P) bool — which entries were projected+frozen


def verify_candidates_batch(unitary_loss_func, anz, candidate_angles,
                            threshold_cp: float = 0.2,
                            method: str = 'adam',
                            learning_rate: float = 0.01,
                            num_iterations: int = 5000,
                            target_loss: float = 1e-6,
                            num_segments: int = 1, *,
                            device) -> VerifiedBatch:
    """Project the CP angles of every candidate (C, P) and re-optimize the
    remaining free angles, all candidates at once with the projected angles
    frozen by the gradient mask. With method 'adam' it is one fused sweep;
    num_segments > 1 chains that many sweeps, each resuming from the
    previous one's best angles with fresh Adam moments; the frozen mask and
    the CZ count always come from the original candidate's projection. Any
    other method runs engine.minimize_multistart's chains on the same
    objective (one segment, no early exit) and takes each candidate's best
    iterate."""
    cand = torch.as_tensor(np.asarray(candidate_angles),
                           dtype=config.real_dtype, device=device)
    if cand.dim() == 1:
        cand = cand[None]
    cp_mask = torch.as_tensor(np.asarray(anz.cp_mask),
                              dtype=config.real_dtype, device=device)
    projected = project_cp_angles(cand, threshold=threshold_cp)
    snapped = (projected == 0.0) | (projected == math.pi)
    frozen = (cp_mask == 1)[None, :] & snapped
    inits = torch.where(frozen, projected, cand)
    mask_pb = (1.0 - frozen.to(config.real_dtype)).T.contiguous()

    objective = batched_sim.make_batched_regloss(
        anz.num_qubits, anz.entangling_gate_name, anz.rotation_gates,
        anz.placements, unitary_loss_func)
    params = inits.T.contiguous()
    if method == 'adam':
        for _ in range(max(1, int(num_segments))):
            params, best_reg, _ = engine.fused_adam_sweep(
                objective, params, learning_rate=learning_rate,
                num_iterations=num_iterations, grad_mask_pb=mask_pb,
                target_loss=target_loss)
    else:
        raw = engine.minimize_multistart(
            objective, inits, method=method, learning_rate=learning_rate,
            num_iterations=num_iterations, keep_history=False,
            u_func=anz.unitary, grad_mask=mask_pb.T, device=device)
        best_i = torch.argmin(raw.regloss, dim=1)
        rows = torch.arange(len(raw), device=device)
        params, best_reg = raw.params[rows, best_i].T, raw.regloss[rows, best_i]
    cz = count_cz(projected * cp_mask[None, :],
                  threshold=threshold_cp).to(torch.int32)
    best_loss = best_reg.cpu().numpy()
    return VerifiedBatch(success=best_loss <= target_loss,
                         best_loss=best_loss,
                         best_angles=params.T.cpu().numpy(),
                         cz=cz.cpu().numpy(),
                         frozen=frozen.cpu().numpy())

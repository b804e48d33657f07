"""CP-template candidate pipeline: init, evaluation, projection, verification
(counterpart of cpflow_tpu/optimize/candidates.py, fused path only).

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


def filter_prospective(ev: EvaluatedBatch, threshold_cz_count,
                       threshold_loss) -> np.ndarray:
    """Indices of candidates below both thresholds, sorted by CZ count."""
    ok = (ev.cz <= threshold_cz_count) & (ev.loss <= threshold_loss)
    idx = np.nonzero(ok)[0]
    order = np.argsort(ev.cz[idx], kind='stable')
    return idx[order]


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
                            learning_rate: float = 0.01,
                            num_iterations: int = 5000,
                            target_loss: float = 1e-6,
                            num_segments: int = 1, *,
                            device) -> VerifiedBatch:
    """Project the CP angles of every candidate (C, P) and re-optimize the
    remaining free angles, all candidates in one fused sweep with the
    projected angles frozen by the gradient mask. num_segments > 1 chains
    that many sweeps, each resuming from the previous one's best angles
    with fresh Adam moments; the frozen mask and the CZ count always come
    from the original candidate's projection."""
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
    for _ in range(max(1, int(num_segments))):
        params, best_reg, _ = engine.fused_adam_sweep(
            objective, params, learning_rate=learning_rate,
            num_iterations=num_iterations, grad_mask_pb=mask_pb,
            target_loss=target_loss)
    cz = count_cz(projected * cp_mask[None, :],
                  threshold=threshold_cp).to(torch.int32)
    best_loss = best_reg.cpu().numpy()
    return VerifiedBatch(success=best_loss <= target_loss,
                         best_loss=best_loss,
                         best_angles=params.T.cpu().numpy(),
                         cz=cz.cpu().numpy(),
                         frozen=frozen.cpu().numpy())

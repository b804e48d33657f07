"""Multi-start optimization engine, the fused part
(counterpart of cpflow_tpu/optimize/engine.py).

The sweep itself is kernels/sweep.py: the CUDA kernel on a CUDA tensor, the
plain PyTorch loop on a CPU tensor. This module keeps the JAX package's
entry points around it: ``fused_adam_sweep`` and ``minimize_fused`` with the
[initial, best] RawResult contract (keep_history=False).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.kernels import sweep as sweep_kernel


@dataclasses.dataclass
class RawResult:
    """Stacked learning results for a whole restart batch (tensors):
      params:  (B, 2, P)   initial and best angles
      regloss: (B, 2)      the minimized objective
      loss:    (B, 2)      objective minus regularization
      reg:     (B, 2)      regularization"""
    params: Any
    regloss: Any
    loss: Any
    reg: Any = None

    def __len__(self):
        return self.params.shape[0]


def fused_adam_sweep(objective, params0: torch.Tensor,
                     learning_rate: float = 0.1, num_iterations: int = 5000,
                     grad_mask_pb: Optional[torch.Tensor] = None,
                     target_loss: Optional[float] = None):
    """params0 (P, B) -> (best_params (P, B), best_regloss (B,),
    best_loss (B,)) with best-so-far tracking. target_loss stops the sweep
    once every restart's best loss is at or under it (the kernel checks
    between launches of kernels.sweep.TARGET_CHECK_EVERY steps)."""
    res = sweep_kernel.sweep(objective, params0, learning_rate,
                             num_iterations, grad_mask_pb, target_loss)
    return res.best_params, res.best_reg, res.best_loss


def minimize_fused(objective, initial_params_batch: torch.Tensor,
                   learning_rate: float = 0.1, num_iterations: int = 5000,
                   grad_mask: Optional[torch.Tensor] = None,
                   target_loss: Optional[float] = None) -> RawResult:
    """Fused batch-last multi-start Adam from (B, P) initial angles on their
    tensor's device. grad_mask: optional (B, P) 0/1 mask freezing
    coordinates."""
    initial = torch.as_tensor(initial_params_batch, dtype=config.real_dtype)
    mask_pb = None if grad_mask is None else \
        torch.as_tensor(grad_mask, dtype=config.real_dtype,
                        device=initial.device).T
    res = sweep_kernel.sweep(objective, initial.T.contiguous(), learning_rate,
                             num_iterations, mask_pb, target_loss)
    params = torch.stack([initial, res.best_params.T], dim=1)
    regloss = torch.stack([res.regloss0, res.best_reg], dim=1)
    loss = torch.stack([res.loss0, res.best_loss], dim=1)
    return RawResult(params=params, regloss=regloss, loss=loss,
                     reg=regloss - loss)

"""Losses on one unitary (counterpart of cpflow_tpu/ops/losses.py, the part
the adaptive search and the per-unitary checks use). The restart-batched
losses of the hot path are in sim/batched.py."""

from __future__ import annotations

import torch

from cpflow_tpu_torch import config


def theoretical_lower_bound(n: int) -> int:
    """Min CZ count for a generic n-qubit unitary: the adaptive search's
    starting scoreboard."""
    return int((4 ** n - 3 * n - 1) / 4 + 1)


def _as(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=config.complex_dtype, device=like.device)


def disc(u: torch.Tensor, u_target) -> torch.Tensor:
    """1 - |Tr(U^dag V)| / N."""
    t = _as(u_target, u)
    return 1 - torch.abs((u.conj() * t).sum()) / t.shape[0]


def cost_HST(u: torch.Tensor, u_target) -> torch.Tensor:
    """Hilbert-Schmidt test cost 1 - |Tr(U^dag V)|^2 / N^2."""
    t = _as(u_target, u)
    return 1 - torch.abs((u * t.conj()).sum()) ** 2 / t.shape[0] ** 2


def state_prep_loss(u: torch.Tensor, target_state) -> torch.Tensor:
    """1 - |<target| U |0>|^2: infidelity of preparing target_state from
    |0...0>."""
    t = _as(target_state, u)
    return 1 - torch.abs((t.conj() * u[:, 0]).sum()) ** 2

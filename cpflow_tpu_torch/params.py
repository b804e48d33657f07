"""Angle vectors carried between the JAX package and the port.

The system has no weights: its parameters are angle vectors in the layout
of sim/ansatz_kernel.py, identical in both packages. The JAX package's
public functions take restart batches as (B, P) arrays; the port's sweep
takes (P, B) tensors, batch last.
"""

from __future__ import annotations

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.sim.ansatz_kernel import cp_angle_indices


def _check_layout(num_angles: int, ansatz) -> None:
    n, nba, k = ansatz.num_qubits, ansatz.num_block_angles, ansatz.num_blocks
    expected = 3 * n + nba * k
    if num_angles != expected:
        raise ValueError(f'{num_angles} angles, but the ansatz has '
                         f'3*{n} + {nba}*{k} = {expected}')
    if ansatz.cp_mask is not None:
        cp_idx = np.nonzero(np.asarray(ansatz.cp_mask) == 1)[0].tolist()
        if cp_idx != cp_angle_indices(n, nba, k):
            raise ValueError('the ansatz\'s CP angles are not at '
                             '3n + j*nba + (nba-1)')


def angles_from_jax(angles_np, ansatz, device) -> torch.Tensor:
    """(B, P) numpy angles -> (P, B) float32 tensor on `device`. `ansatz`
    is either package's Ansatz; its layout is checked."""
    a = np.asarray(angles_np, dtype=np.float32)
    if a.ndim == 1:
        a = a[None]
    _check_layout(a.shape[1], ansatz)
    return torch.as_tensor(a.T.copy(), dtype=config.real_dtype, device=device)


def angles_to_jax(t: torch.Tensor) -> np.ndarray:
    """(P, B) tensor -> (B, P) float32 numpy, the inverse of
    angles_from_jax."""
    return np.ascontiguousarray(t.detach().cpu().numpy().T, dtype=np.float32)

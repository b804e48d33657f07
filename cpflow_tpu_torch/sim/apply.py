"""Applying k-qubit gates to 2n-leg unitary tensors
(counterpart of cpflow_tpu/sim/apply.py).

The accumulated unitary is a [2]*2n tensor: the first n legs are the
output (row) indices, the last n the input (column) indices, qubit 0 the
most significant bit.
"""

from __future__ import annotations

import numpy as np
import torch


def inverse_leg_permutation(n_qubits, placement):
    """Inverse of the move-placement-legs-to-front permutation, restricted
    to the n row legs: position q of the result names where leg q sits
    after a contraction has left the gate's output legs (in placement
    order) at the front and the untouched legs behind them."""
    front = list(placement) + [q for q in range(n_qubits)
                               if q not in placement]
    return [int(i) for i in np.argsort(front)]


def apply_gate_to_tensor(gate: torch.Tensor, tensor: torch.Tensor,
                         placement) -> torch.Tensor:
    """Left-multiply `gate` into `tensor` at the row legs in `placement`.

    gate: any shape reshapeable to (2^k, 2^k); tensor: [2]*2n; placement:
    the k row legs the gate acts on, in gate-leg order.
    """
    n = tensor.dim() // 2
    k = len(placement)
    dim_g = 2 ** k
    front = list(placement) + [q for q in range(n) if q not in placement]
    perm = front + list(range(n, 2 * n))
    moved = tensor.permute(perm).reshape(dim_g, -1)
    out = gate.reshape(dim_g, dim_g) @ moved
    inv = inverse_leg_permutation(n, placement) + list(range(n, 2 * n))
    return out.reshape([2] * (2 * n)).permute(inv)

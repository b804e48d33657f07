"""Batch-last ansatz simulation in plain PyTorch
(counterpart of cpflow_tpu/sim/batched.py).

Every tensor keeps the restart batch as its last axis:

    angles  (P, B)
    u       (2,)*n + (2^n,) + (B,)     row legs, flat column, batch last
    gates   (4, 4, B) / (2, 2, B)
    loss    (B,)

This is the CPU path of the port and the independent reference of the sweep
kernel (kernels/sweep.py): gradients come from PyTorch autograd, a second
derivation set against the kernel's hand-written adjoint. Semantics (angle
layout, block order) are those of sim/ansatz_kernel.build_unitary.

Not ported here: ``_apply_gate_batched_slices`` (a TPU layout experiment),
the reversible custom-gradient builder, and the state-preparation and disc
losses (ROADMAP A.4).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.ops import gates as gate_mats
from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                num_block_angles)


# --------------------------------------------------------------------------
# Batched gate matrices (trailing batch axis)
# --------------------------------------------------------------------------

_PAULI = {'x': gate_mats.x_mat, 'y': gate_mats.y_mat, 'z': gate_mats.z_mat}


def _lift(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Constant matrix m shaped to broadcast against (2|4, 2|4) + like.shape."""
    t = torch.as_tensor(m, dtype=config.complex_dtype, device=like.device)
    return t.reshape(t.shape + (1,) * like.dim())


def _rot_batched(letter: str, a: torch.Tensor) -> torch.Tensor:
    """(2, 2, ...) rotation matrices cos(a/2) I - i sin(a/2) P for angles
    a: (...)."""
    if letter not in _PAULI:
        raise ValueError(f'unknown rotation {letter!r}')
    c = torch.cos(a / 2).to(config.complex_dtype)
    s = torch.sin(a / 2).to(config.complex_dtype)
    return c * _lift(np.eye(2), a) + s * _lift(-1j * _PAULI[letter], a)


def _kron_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(2,2,...) x (2,2,...) -> (4,4,...) Kronecker product, elementwise in
    the trailing axes."""
    return torch.einsum('ik...,jl...->ijkl...', a, b).reshape(
        (4, 4) + a.shape[2:])


def _matmul_batched(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m,k,...) @ (k,n,...) -> (m,n,...)."""
    return torch.einsum('mk...,kn...->mn...', a, b)


def _cp_batched(a: torch.Tensor) -> torch.Tensor:
    """(4, 4, ...) controlled-phase matrices diag(1, 1, 1, e^{ia})."""
    phase = torch.complex(torch.cos(a), torch.sin(a))
    return _lift(np.diag([1, 1, 1, 0]), a) + phase * _lift(
        np.diag([0, 0, 0, 1]), a)


def block_matrix_batched(entangling_gate_name: str, rotation_gates: str,
                         block_angles: torch.Tensor) -> torch.Tensor:
    """(4, 4, ...) block unitaries for block_angles: (nba, ...); the
    trailing axes are any batch shape, e.g. (B,) or (num_blocks, B)."""
    if entangling_gate_name == 'cp':
        u = _cp_batched(block_angles[-1])
    elif entangling_gate_name in ('cz', 'cx'):
        m = gate_mats.cz_mat if entangling_gate_name == 'cz' \
            else gate_mats.cx_mat
        u = torch.as_tensor(m, device=block_angles.device).reshape(
            (4, 4) + (1,) * (block_angles.dim() - 1)).expand(
            (4, 4) + block_angles.shape[1:])
    else:
        raise ValueError(entangling_gate_name)
    for i, letter in enumerate(rotation_gates):
        up = _rot_batched(letter, block_angles[2 * i])
        down = _rot_batched(letter, block_angles[2 * i + 1])
        u = _matmul_batched(_kron_batched(up, down), u)
    return u


def surface_gate_batched(a3: torch.Tensor) -> torch.Tensor:
    """(2, 2, ...) Rz Rx Rz surface gates for a3: (3, ...)."""
    g = _matmul_batched(_rot_batched('z', a3[2]), _rot_batched('x', a3[1]))
    return _matmul_batched(g, _rot_batched('z', a3[0]))


# --------------------------------------------------------------------------
# Batched gate application
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _apply_subscripts(placement: tuple, n: int) -> str:
    """einsum subscripts 'gate,u->out' for a gate on the row legs in
    `placement` of a (2,)*n + (cols, B) tensor."""
    legs = [chr(ord('a') + q) for q in range(n)]
    outs = [chr(ord('A') + i) for i in range(len(placement))]
    ins = [legs[q] for q in placement]
    result = list(legs)
    for i, q in enumerate(placement):
        result[q] = outs[i]
    return (''.join(outs + ins) + 'z,' + ''.join(legs) + 'yz->'
            + ''.join(result) + 'yz')


def _apply_gate_batched(gate: torch.Tensor, u: torch.Tensor,
                        placement: Sequence[int], n: int) -> torch.Tensor:
    """Left-multiply batched k-qubit gates into the batched unitary tensor.

    gate: (2^k, 2^k, B); u: (2,)*n + (cols, B); placement: k row legs, in
    gate-leg order.
    """
    k = len(placement)
    g = gate.reshape([2] * (2 * k) + [gate.shape[-1]])
    return torch.einsum(_apply_subscripts(tuple(placement), n), g, u)


def build_unitary_batched(num_qubits: int, entangling_gate_name: str,
                          rotation_gates: str, placements: dict,
                          angles: torch.Tensor) -> torch.Tensor:
    """angles: (P, B) -> batched unitary (2,)*n + (2^n, B): the surface 1q
    round, then every block in application order. All gate matrices are
    built at once; only their application is sequential."""
    nba = num_block_angles(entangling_gate_name, rotation_gates)
    n = num_qubits
    d = 2 ** n
    angles = torch.as_tensor(angles, dtype=config.real_dtype)
    B = angles.shape[-1]
    surface = surface_gate_batched(angles[:3 * n].reshape(n, 3, B)
                                   .transpose(0, 1))           # (2, 2, n, B)
    block_pl = all_placements(placements)
    blocks = block_matrix_batched(
        entangling_gate_name, rotation_gates,
        angles[3 * n:].reshape(-1, nba, B).transpose(0, 1))    # (4, 4, k, B)

    eye = torch.eye(d, dtype=config.complex_dtype, device=angles.device)
    u = eye.reshape([2] * n + [d, 1]).expand([2] * n + [d, B])
    for q in range(n):
        u = _apply_gate_batched(surface[:, :, q], u, [q], n)
    for j, p in enumerate(block_pl):
        u = _apply_gate_batched(blocks[:, :, j], u, p, n)
    return u


# --------------------------------------------------------------------------
# Batched losses and the regularized objective
# --------------------------------------------------------------------------

def batched_cost_hst(u: torch.Tensor, u_target) -> torch.Tensor:
    """(B,) HS-test losses 1 - |tr(T^dag U)|^2 / d^2; u: (2,)*n + (2^n, B),
    u_target: (2^n, 2^n)."""
    d = u_target.shape[0]
    t = torch.as_tensor(np.asarray(u_target), dtype=config.complex_dtype,
                        device=u.device).reshape(u.shape[:-1] + (1,))
    s = (u * t.conj()).reshape(-1, u.shape[-1]).sum(dim=0)
    return 1 - s.abs() ** 2 / d ** 2


def batched_unitary_loss(unitary_loss_func, u: torch.Tensor) -> torch.Tensor:
    """Evaluate a LossSpec on the batched unitary. Only the HS-test kind is
    ported; state-preparation, disc and custom losses are ROADMAP A.4."""
    kind = getattr(unitary_loss_func, 'kind', None)
    if kind == 'hst':
        return batched_cost_hst(u, unitary_loss_func.target)
    raise NotImplementedError(
        f'batched loss kind {kind!r} is not ported yet (ROADMAP A.4: '
        f'state-preparation, disc and custom losses)')


class BatchedRegloss:
    """The fused objective f(angles_PB) -> (regloss_B, loss_B), with
    regloss = loss + r * sum(penalty(cp_mask * angles)).

    Unlike the JAX package's closure, the objective keeps its parts as
    attributes: the sweep kernel reads the ansatz, the target, the mask and
    the penalty's breakpoints from them and never calls the object."""

    def __init__(self, num_qubits: int, entangling_gate_name: str,
                 rotation_gates: str, placements: dict, unitary_loss_func,
                 cp_mask=None, regularization_func=None, r: float = 0.0):
        self.num_qubits = num_qubits
        self.entangling_gate_name = entangling_gate_name
        self.rotation_gates = rotation_gates
        self.placements = placements
        self.unitary_loss_func = unitary_loss_func
        self.cp_mask = None if cp_mask is None else \
            np.asarray(cp_mask, dtype=np.float32)
        self.regularization_func = regularization_func
        self.r = float(r)

    @property
    def has_penalty(self) -> bool:
        return self.regularization_func is not None and \
            self.cp_mask is not None

    def __call__(self, angles: torch.Tensor):
        u = build_unitary_batched(self.num_qubits, self.entangling_gate_name,
                                  self.rotation_gates, self.placements,
                                  angles)
        loss = batched_unitary_loss(self.unitary_loss_func, u)
        if not self.has_penalty:
            return loss, loss
        mask = torch.as_tensor(self.cp_mask, device=angles.device)
        reg = self.r * self.regularization_func(
            angles * mask[:, None]).sum(dim=0)
        return loss + reg, loss


def make_batched_regloss(num_qubits: int, entangling_gate_name: str,
                         rotation_gates: str, placements: dict,
                         unitary_loss_func, cp_mask=None,
                         regularization_func=None,
                         r: float = 0.0) -> BatchedRegloss:
    """The fused hot-path objective (loss + r * sum(penalty(cp angles)))."""
    return BatchedRegloss(num_qubits, entangling_gate_name, rotation_gates,
                          placements, unitary_loss_func, cp_mask=cp_mask,
                          regularization_func=regularization_func, r=r)

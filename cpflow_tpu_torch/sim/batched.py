"""Batch-last ansatz simulation in plain PyTorch
(counterpart of cpflow_tpu/sim/batched.py).

Every tensor keeps the restart batch as its last axis:

    angles  (P, B)
    u       (2,)*n + (2^n,) + (B,)     row legs, flat column, batch last
    gates   (4, 4, B) / (2, 2, B)
    loss    (B,)

This is the CPU path of the port and the independent reference of the
kernels (kernels/sweep.py, kernels/unitary.py): gradients come from PyTorch
autograd, a second derivation set against the kernels' hand-written
adjoint. Semantics (angle layout, block order) are those of
sim/ansatz_kernel.build_unitary.

Losses: the HS test, disc, state preparation (which builds only the
|0...0> column of the unitary) and the modulo-identity/diagonal losses,
written directly on the batch-last tensor where the JAX package vmaps the
per-unitary callable; a custom loss, a torch callable of one (d, d) matrix,
is vmapped over the restart axis. The JAX package's reversible
custom-gradient builder (``make_reversible_builder``) is kernels/unitary.py
here: ``BatchedRegloss`` takes its unitary from there, which on a CUDA
tensor is the pair of hand-written kernels and on a CPU tensor
``build_unitary_batched`` below. Not ported: ``_apply_gate_batched_slices``
(a TPU layout experiment).
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.ops import gates as gate_mats
from cpflow_tpu_torch.ops import losses
from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                num_block_angles)


# --------------------------------------------------------------------------
# Batched gate matrices (trailing batch axis)
# --------------------------------------------------------------------------

_PAULI = {'x': gate_mats.x_mat, 'y': gate_mats.y_mat, 'z': gate_mats.z_mat}


def _lift(m: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Constant matrix m shaped to broadcast against (2|4, 2|4) + like.shape,
    in the complex dtype of the real tensor `like`."""
    t = torch.as_tensor(m, dtype=config.complex_of(like.dtype),
                        device=like.device)
    return t.reshape(t.shape + (1,) * like.dim())


def _rot_batched(letter: str, a: torch.Tensor) -> torch.Tensor:
    """(2, 2, ...) rotation matrices cos(a/2) I - i sin(a/2) P for angles
    a: (...)."""
    if letter not in _PAULI:
        raise ValueError(f'unknown rotation {letter!r}')
    c = torch.cos(a / 2).to(config.complex_of(a.dtype))
    s = torch.sin(a / 2).to(config.complex_of(a.dtype))
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
        u = torch.as_tensor(m, dtype=config.complex_of(block_angles.dtype),
                            device=block_angles.device).reshape(
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
                          angles: torch.Tensor, columns=None,
                          dtype=None) -> torch.Tensor:
    """angles: (P, B) -> batched unitary (2,)*n + (2^n, B): the surface 1q
    round, then every block in application order. All gate matrices are
    built at once; only their application is sequential.

    columns: optional list of input basis states. Gates touch only the row
    legs, so each column evolves on its own; the result is then
    (2,)*n + (len(columns), B), those columns of the unitary. dtype: the
    real dtype to compute in (default config.real_dtype); the unitary is of
    its complex counterpart."""
    nba = num_block_angles(entangling_gate_name, rotation_gates)
    n = num_qubits
    d = 2 ** n
    angles = torch.as_tensor(angles, dtype=dtype or config.real_dtype)
    B = angles.shape[-1]
    surface = surface_gate_batched(angles[:3 * n].reshape(n, 3, B)
                                   .transpose(0, 1))           # (2, 2, n, B)
    block_pl = all_placements(placements)
    blocks = block_matrix_batched(
        entangling_gate_name, rotation_gates,
        angles[3 * n:].reshape(-1, nba, B).transpose(0, 1))    # (4, 4, k, B)

    if columns is None:
        eye = torch.eye(d, dtype=config.complex_of(angles.dtype),
                        device=angles.device)
    else:  # those columns alone: the identity is 2^n x 2^n (at 17 qubits
        # 128 GiB in complex64)
        eye = torch.zeros((d, len(columns)),
                          dtype=config.complex_of(angles.dtype),
                          device=angles.device)
        eye[list(columns), torch.arange(len(columns))] = 1
    ncols = eye.shape[1]
    u = eye.reshape([2] * n + [ncols, 1]).expand([2] * n + [ncols, B])
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
    t = torch.as_tensor(np.asarray(u_target), dtype=u.dtype,
                        device=u.device).reshape(u.shape[:-1] + (1,))
    s = (u * t.conj()).reshape(-1, u.shape[-1]).sum(dim=0)
    return 1 - s.abs() ** 2 / d ** 2


def batched_state_prep(u: torch.Tensor, target_state) -> torch.Tensor:
    """(B,) state-preparation infidelities 1 - |<target|U|0>|^2 from column
    0 of u: (2,)*n + (cols, B)."""
    d = 2 ** (u.dim() - 2)
    col0 = u[..., 0, :].reshape(d, u.shape[-1])
    t = torch.as_tensor(np.asarray(target_state), dtype=u.dtype,
                        device=u.device)[:, None]
    return 1 - (t.conj() * col0).sum(dim=0).abs() ** 2


def batched_disc(u: torch.Tensor, u_target) -> torch.Tensor:
    """(B,) losses 1 - |tr(U^dag T)| / d; u: (2,)*n + (2^n, B)."""
    d = u_target.shape[0]
    t = torch.as_tensor(np.asarray(u_target), dtype=u.dtype,
                        device=u.device).reshape(u.shape[:-1] + (1,))
    s = (u.conj() * t).reshape(-1, u.shape[-1]).sum(dim=0)
    return 1 - s.abs() / d


def _batched_modulo(u: torch.Tensor, u_target, num_qubits: int, wires,
                    diagonal: bool) -> torch.Tensor:
    """ops.losses.disc_modulo_identity / _diagonal of every restart of
    u: (2,)*n + (2^n, B), on the batch-last tensor: W = (U T)^dag with its
    wires moved up, its block-diagonal part against that part
    block-shifted, plus the off-block weight."""
    n, B = num_qubits, u.shape[-1]
    d = 2 ** n
    t = torch.as_tensor(np.asarray(u_target), dtype=u.dtype, device=u.device)
    v = torch.einsum('ijb,jk->ikb', u.reshape(d, d, B), t)
    w = losses.move_wires_up(v.conj().transpose(0, 1), n, wires)
    w_diag, w_shifted, w_off = losses.block_diagonal_split(
        w, n, n - len(wires))                                 # (d, d, B)
    rows = (w_diag * w_shifted.conj()).sum(dim=1)             # (d, B)
    loss_off = (w_off.abs() ** 2).sum(dim=(0, 1))
    if diagonal:
        sp = (rows.abs() ** 2).sum(dim=0)
    else:
        sp = rows.sum(dim=0).abs()
    return 1 - sp / d + loss_off


def batched_modulo_identity(u: torch.Tensor, u_target, num_qubits: int,
                            wires) -> torch.Tensor:
    """(B,) disc_modulo_identity losses of the batched unitary."""
    return _batched_modulo(u, u_target, num_qubits, wires, diagonal=False)


def batched_modulo_diagonal(u: torch.Tensor, u_target, num_qubits: int,
                            wires) -> torch.Tensor:
    """(B,) disc_modulo_diagonal losses of the batched unitary."""
    return _batched_modulo(u, u_target, num_qubits, wires, diagonal=True)


def batched_unitary_loss(unitary_loss_func, u: torch.Tensor) -> torch.Tensor:
    """Evaluate a LossSpec on the batched unitary: the HS-test, disc,
    state-preparation and modulo-identity/diagonal kinds directly on the
    batch-last tensor; a ``LossSpec('custom', fn=...)`` or a bare callable,
    a torch function of one (d, d) complex matrix returning a real scalar,
    vmapped over the restart axis, under autograd, in u's dtype and on its
    device."""
    kind = getattr(unitary_loss_func, 'kind', None)
    target = getattr(unitary_loss_func, 'target', None)
    if kind == 'hst':
        return batched_cost_hst(u, target)
    if kind == 'disc':
        return batched_disc(u, target)
    if kind == 'state':
        return batched_state_prep(u, target)
    if kind == 'modulo_identity':
        return batched_modulo_identity(u, target, unitary_loss_func.num_qubits,
                                       unitary_loss_func.wires)
    if kind == 'modulo_diagonal':
        return batched_modulo_diagonal(u, target, unitary_loss_func.num_qubits,
                                       unitary_loss_func.wires)
    fn = unitary_loss_func.fn if kind == 'custom' else unitary_loss_func
    if kind not in (None, 'custom') or not callable(fn):
        raise ValueError(f'unknown loss {unitary_loss_func!r}')
    d = 2 ** (u.dim() - 2)
    if u.shape[-2] != d:
        raise ValueError('a custom loss takes the whole unitary, got '
                         f'{u.shape[-2]} of its {d} columns')
    return torch.func.vmap(fn, in_dims=-1)(u.reshape(d, d, u.shape[-1]))


class BatchedRegloss:
    """The fused objective f(angles_PB) -> (regloss_B, loss_B), with
    regloss = loss + r * sum(penalty(cp_mask * angles)).

    Unlike the JAX package's closure, the objective keeps its parts as
    attributes: the sweep kernel reads the ansatz, the target, the mask, r
    and the penalty's breakpoints from them and never calls the object.
    r is a float or a (B,) tensor of one weight per restart, so that one
    objective serves the restarts of several adaptive trials. A state loss
    builds only the |0...0> column (``columns``); a custom loss always
    takes the whole unitary. dtype is the real dtype the objective computes
    in (default config.real_dtype; the kernels take float32 and float64,
    each through its own build).

    Calling the objective builds the unitary with
    kernels.unitary.build_unitary: on a CUDA tensor through the forward and
    vjp kernels (differentiable, no fallback), on a CPU tensor with the
    plain build_unitary_batched. plain=True keeps the plain builder on
    either device: the kernels' reference on the card, and the float64
    arbiter."""

    def __init__(self, num_qubits: int, entangling_gate_name: str,
                 rotation_gates: str, placements: dict, unitary_loss_func,
                 cp_mask=None, regularization_func=None, r=0.0, dtype=None,
                 plain: bool = False):
        self.num_qubits = num_qubits
        self.entangling_gate_name = entangling_gate_name
        self.rotation_gates = rotation_gates
        self.placements = placements
        self.unitary_loss_func = unitary_loss_func
        self.cp_mask = None if cp_mask is None else \
            np.asarray(cp_mask, dtype=np.float32)
        self.regularization_func = regularization_func
        self.dtype = dtype or config.real_dtype
        self.r = r.to(self.dtype) if isinstance(r, torch.Tensor) \
            else float(r)
        self.columns = [0] if getattr(unitary_loss_func, 'kind', None) == \
            'state' else None
        self.plain = plain

    @property
    def has_penalty(self) -> bool:
        return self.regularization_func is not None and \
            self.cp_mask is not None

    def penalty(self, angles: torch.Tensor) -> torch.Tensor:
        """The penalty of angles (P, ...) summed over the CP angles, not yet
        weighted by r; zeros without a penalty."""
        if not self.has_penalty:
            return torch.zeros(angles.shape[1:], dtype=self.dtype,
                               device=angles.device)
        mask = torch.as_tensor(self.cp_mask, dtype=self.dtype,
                               device=angles.device)
        mask = mask.reshape((-1,) + (1,) * (angles.dim() - 1))
        return self.regularization_func(angles * mask).sum(dim=0)

    def regularization(self, angles: torch.Tensor) -> torch.Tensor:
        """r * penalty of angles (P, ..., B): what the objective adds to
        the loss."""
        return self.r * self.penalty(angles)

    def loss_and_penalty(self, angles: torch.Tensor):
        """(loss_B, penalty_B), the penalty not yet weighted by r."""
        if self.plain:
            build = build_unitary_batched
        else:
            from cpflow_tpu_torch.kernels.unitary import build_unitary as build
        u = build(self.num_qubits, self.entangling_gate_name,
                  self.rotation_gates, self.placements, angles,
                  columns=self.columns, dtype=self.dtype)
        loss = batched_unitary_loss(self.unitary_loss_func, u)
        return loss, self.penalty(angles)

    def __call__(self, angles: torch.Tensor):
        loss, pen = self.loss_and_penalty(angles)
        if not self.has_penalty:
            return loss, loss
        return loss + self.r * pen, loss


def make_batched_regloss(num_qubits: int, entangling_gate_name: str,
                         rotation_gates: str, placements: dict,
                         unitary_loss_func, cp_mask=None,
                         regularization_func=None, r=0.0,
                         dtype=None, plain: bool = False) -> BatchedRegloss:
    """The fused hot-path objective (loss + r * sum(penalty(cp angles)));
    r a float or a (B,) tensor; dtype the real dtype it computes in
    (default config.real_dtype); plain=True for the plain builder on
    either device (see BatchedRegloss)."""
    return BatchedRegloss(num_qubits, entangling_gate_name, rotation_gates,
                          placements, unitary_loss_func, cp_mask=cp_mask,
                          regularization_func=regularization_func, r=r,
                          dtype=dtype, plain=plain)


def make_batched_loss_and_penalty(num_qubits: int, entangling_gate_name: str,
                                  rotation_gates: str, placements: dict,
                                  unitary_loss_func, cp_mask,
                                  regularization_func):
    """f(angles_PB) -> (loss_B, penalty_B) with the weight r left to the
    caller, who combines loss + r * penalty."""
    return BatchedRegloss(num_qubits, entangling_gate_name, rotation_gates,
                          placements, unitary_loss_func, cp_mask=cp_mask,
                          regularization_func=regularization_func
                          ).loss_and_penalty

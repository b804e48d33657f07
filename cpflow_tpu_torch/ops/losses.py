"""Losses on one unitary (counterpart of cpflow_tpu/ops/losses.py). The
restart-batched losses of the hot path are in sim/batched.py.

The tensor-factorization losses (compile modulo identity or modulo a
diagonal on some wires) are written once and take either a torch tensor
or a numpy array, as the JAX package's ``xp=np`` path does: the host
checks evaluate them in float64 numpy, the tests in torch. Their
conventions are the JAX package's (and the reference's): the loss is of
(u @ u_target)^dag, so a circuit found against a non-Hermitian target
implements the target's inverse modulo the identity or a diagonal (see
disc_modulo_identity).
"""

from __future__ import annotations

import numpy as np
import torch

from cpflow_tpu_torch import config


def theoretical_lower_bound(n: int) -> int:
    """Min CZ count for a generic n-qubit unitary: the adaptive search's
    starting scoreboard."""
    return int((4 ** n - 3 * n - 1) / 4 + 1)


def _as(t, like: torch.Tensor) -> torch.Tensor:
    dtype = like.dtype if like.is_complex() else config.complex_dtype
    return torch.as_tensor(t, dtype=dtype, device=like.device)


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


def trace_prod(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Tr(U^dagger V) as an elementwise product and a sum."""
    return (u.conj() * v).sum()


# --- Permutation-equivalence loss --------------------------------------------

def _permutation_matrix(perm, dtype=None) -> np.ndarray:
    """Unitary permuting qubit wires: qubit i of the input goes to wire
    perm[i] (big-endian: basis index b has bit n-1-i for qubit i)."""
    n = len(perm)
    d = 2 ** n
    m = np.zeros((d, d), dtype=dtype or np.complex64)
    for b in range(d):
        bits = [(b >> (n - 1 - i)) & 1 for i in range(n)]
        new_bits = [0] * n
        for i in range(n):
            new_bits[perm[i]] = bits[i]
        nb = sum(bit << (n - 1 - i) for i, bit in enumerate(new_bits))
        m[nb, b] = 1
    return m


def permutation_matrices(n: int):
    from itertools import permutations
    return [_permutation_matrix(p) for p in permutations(range(n))]


def disc2_swap(u: torch.Tensor, u_target, num_qubits: int) -> torch.Tensor:
    """Product of HST costs over all wire permutations of u."""
    return torch.stack([cost_HST(_as(m, u) @ u, u_target)
                        for m in permutation_matrices(num_qubits)]).prod()


# --- Fubini-Study metric (natural gradient) ----------------------------------

def fubini_study(u_func, x: torch.Tensor,
                 relative_coeff: float = 1.0) -> torch.Tensor:
    """The (P, P) Fubini-Study metric of u_func at the angles x (P,):
    Re[<dU_i, dU_j> / |U|^2 - c <dU_i, U> conj(<dU_j, U>) / |U|^4].

    It needs dU/dx for every angle, which torch.func.jacfwd takes through
    u_func in forward mode (on the real and imaginary parts: jacfwd takes
    no complex output). No kernel computes it, in the JAX package or here:
    it is plain torch ops on the caller's device, so u_func is a plain
    builder (sim.ansatz_kernel.build_unitary), never the unitary kernels."""
    u = u_func(x)
    u_norm2 = torch.abs(trace_prod(u, u))
    u_jac = torch.view_as_complex(torch.func.jacfwd(
        lambda a: torch.view_as_real(u_func(a)))(x).movedim(2, -1)
        .contiguous())                                        # (d, d, P)
    dudu = torch.tensordot(u_jac, u_jac.conj(), dims=([0, 1], [0, 1]))
    udu = torch.tensordot(u_jac, u.conj(), dims=([0, 1], [0, 1]))
    gij = dudu / u_norm2 - \
        relative_coeff * torch.outer(udu.conj(), udu) / u_norm2 ** 2
    return gij.real


# --- Tensor-factorization losses (compile modulo identity / diagonal) --------

def _like(a, u, cast: bool = True):
    """a as an array of u's kind (torch tensor or numpy array): in u's dtype
    and on its device; a numpy array keeps its own dtype if not cast, so
    that a product promotes as numpy does."""
    if isinstance(u, torch.Tensor):
        return torch.as_tensor(a, dtype=u.dtype, device=u.device)
    return np.asarray(a, dtype=u.dtype if cast else None)


def _index(idx: np.ndarray, u):
    return torch.as_tensor(idx, device=u.device) \
        if isinstance(u, torch.Tensor) else idx


def reorder_wires(wires, num_qubits):
    """[1,3], n=5 -> [1,3,0,2,4]."""
    return list(wires) + [w for w in range(num_qubits) if w not in wires]


def wire_permutation(num_qubits: int, wires) -> np.ndarray:
    """Basis-index map pi of move_wires_up: (move_wires_up(u))[a, b] =
    u[pi[a], pi[b]] (big-endian, qubit 0 the most significant bit)."""
    d = 2 ** num_qubits
    return np.arange(d).reshape([2] * num_qubits).transpose(
        reorder_wires(wires, num_qubits)).reshape(d)


def move_wires_up(u, num_qubits, wires):
    """Permute the tensor legs of u (rows and columns alike) so that
    `wires` come first; axes after the first two ride along."""
    p = _index(wire_permutation(num_qubits, wires), u)
    return u[p][:, p]


def _shift_indices(dim: int, block: int) -> np.ndarray:
    """Row indices of the block-shift conjugation X u X^{-1} with
    X = shift(dim // block) (x) I_block, a pure row and column permutation:
    (X u X^T)[i*m+a, j*m+b] = u[((i+1)%k)*m+a, ((j+1)%k)*m+b]."""
    idx = np.arange(dim)
    return ((idx // block + 1) % (dim // block)) * block + idx % block


def block_diagonal_split(u, num_qubits, n):
    """Split u into its block-diagonal part (blocks of 2^n), that part with
    its blocks cyclically shifted, and the off-block-diagonal remainder.
    Axes after the first two (a batch) ride along."""
    dim, block = 2 ** num_qubits, 2 ** n
    mask = np.kron(np.eye(dim // block), np.ones((block, block)))
    mask = _like(mask.reshape(mask.shape + (1,) * (u.ndim - 2)), u)
    u_diag = mask * u
    u_off_diag = (1 - mask) * u
    src = _index(_shift_indices(dim, block), u)
    return u_diag, u_diag[src][:, src], u_off_diag


def tensor_identity_loss(u, num_qubits, wires):
    """0 iff u acts as the identity on `wires` (up to factorization), else
    positive."""
    u = move_wires_up(u, num_qubits, wires)
    u_diag, u_diag_shifted, u_off_diag = block_diagonal_split(
        u, num_qubits, num_qubits - len(wires))
    sp_total = abs((u_diag * u_diag_shifted.conj()).sum(axis=1).sum())
    loss_off = (abs(u_off_diag) ** 2).sum()
    return 1 - sp_total / 2 ** num_qubits + loss_off


def tensor_diagonal_loss(u, num_qubits, wires):
    """0 iff u acts diagonally on `wires`, else positive."""
    u = move_wires_up(u, num_qubits, wires)
    u_diag, u_diag_shifted, u_off_diag = block_diagonal_split(
        u, num_qubits, num_qubits - len(wires))
    sp_vec = abs((u_diag * u_diag_shifted.conj()).sum(axis=1))
    loss_off = (abs(u_off_diag) ** 2).sum()
    return 1 - (sp_vec ** 2).sum() / 2 ** num_qubits + loss_off


def disc_modulo_identity(u_target, u, num_qubits, wires):
    """Zero iff (u @ u_target) acts as the identity on `wires`: u == A @
    u_target^dag with A the identity on `wires` (the reference's relation,
    its docstring notwithstanding). For a Hermitian target (every
    multi-controlled X) that is u ~ u_target; for a non-Hermitian one pass
    u_target.conj().T, or use the found circuit's inverse."""
    return tensor_identity_loss((u @ _like(u_target, u, cast=False)).conj().T,
                                num_qubits, wires)


def disc_modulo_diagonal(u_target, u, num_qubits, wires):
    """Zero iff (u @ u_target) is diagonal on `wires` (with spectator
    transforms): u == D @ u_target^dag with D diagonal. As with
    disc_modulo_identity this is u ~ u_target only for a Hermitian target;
    a circuit found against a non-Hermitian one implements the target's
    inverse modulo a left diagonal, so use its inverse."""
    return tensor_diagonal_loss((u @ _like(u_target, u, cast=False)).conj().T,
                                num_qubits, wires)

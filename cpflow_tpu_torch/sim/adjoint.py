"""Hand-derived gate derivatives for the sweep kernel's adjoint walk
(counterpart of cpflow_tpu/sim/adjoint.py:41-116).

Everything is batch-last: angles (nba, ...) or (3, ...), gates (4, 4, ...)
or (2, 2, ...), and the computation follows the angles' dtype (float32
with complex64, float64 with complex128).

``block_matrix_and_grads`` and ``surface_matrix_and_grads`` return a gate
and every dG/dtheta as whole matrices, as the JAX module does.
``block_vjp`` and ``surface_vjp`` are the algebra of csrc/sweep.cu: from the
gate's cotangent Gbar = dL/dG (dL = 2 Re sum Gbar * dG) they return each
angle's gradient 2 Re sum Gbar * dG/dtheta in factored 2x2 form, with no
4x4 product. They are its plain version and specification; the sweep
itself differentiates with autograd (sim/batched.py) or runs the kernel.

The factored form. A block is G = (U (x) D) E with U = R_{m-1} ... R_0 the
up leg's rotations (angles a_0, a_2, ...), D the down leg's (a_1, a_3, ...)
and E = CP(phi), CZ or CX. With X = Gbar E^T (E acting on columns: CP
scales column 3 by e^{i phi}, CZ negates it, CX swaps columns 2 and 3),

    Y_U[p,k] = sum_{q,l} X[pq,kl] D[q,l],  Y_D[q,l] = sum_{p,k} X[pq,kl] U[p,k]

are the cotangents of the two legs, and the CP angle's gradient is
2 Re sum_pq Gbar[pq,3] (U (x) D)[pq,3] i e^{i phi}. Along a leg
U = S_i R_i P_i, with P_i the letters below i and S_i those above, and
dR_i = (-i/2) sigma_i R_i, so

    2 Re sum Y * dU/da_i = Im tr(V_i sigma_i),  V_i = S_i^dag (U Y^T) S_i,

with V_{m-1} = U Y^T and V_{i-1} = R_i^dag V_i R_i. This equals
2 Re sum (Z_i P_i^T) * dR_i with the suffix cotangents Z_i = S_i^T Y, since
S_i sigma_i P_{i+1} = (S_i sigma_i S_i^dag) U. The walk keeps one 2x2
matrix per leg live instead of every prefix P_i, whose number (the rotation
string's length) the kernel learns only at run time. The surface gate
Rz(a2) Rx(a1) Rz(a0) is one such leg, with the letters z, x, z and Y = Gbar.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from cpflow_tpu_torch.ops import gates as gate_mats
from cpflow_tpu_torch import config
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles
from cpflow_tpu_torch.sim.batched import (_PAULI, _apply_gate_batched,
                                          _cp_batched, _kron_batched, _lift,
                                          _matmul_batched, _rot_batched)


def _pauli(letter: str, like: torch.Tensor) -> torch.Tensor:
    """The 2x2 Pauli matrix of a letter in the complex dtype of `like`."""
    return torch.as_tensor(_PAULI[letter], device=like.device).to(
        like.dtype if like.is_complex() else
        torch.complex128 if like.dtype == torch.float64 else torch.complex64)


def _rot_and_deriv(letter: str, a: torch.Tensor):
    """R(a) and dR/da = (-i/2) P R(a), both (2, 2, ...)."""
    r = _rot_batched(letter, a)
    return r, -0.5j * torch.einsum('pk,kq...->pq...', _pauli(letter, r), r)


def block_matrix_and_grads(entangling_gate_name: str, rotation_gates: str,
                           block_angles: torch.Tensor
                           ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(G, [dG/dtheta_j for each block angle]), all (4, 4, ...): G =
    K_{m-1} ... K_0 E with K_i = kron(R_i(a_{2i}), R_i(a_{2i+1})) and E =
    CP(a_last), CZ or CX, by prefix and suffix products as the JAX module
    builds them."""
    phi = block_angles[-1]
    if entangling_gate_name == 'cp':
        e = _cp_batched(phi)
    elif entangling_gate_name in ('cz', 'cx'):
        mat = gate_mats.cz_mat if entangling_gate_name == 'cz' \
            else gate_mats.cx_mat
        e = _lift(mat, phi).expand((4, 4) + phi.shape)
    else:
        raise ValueError(entangling_gate_name)
    ks, dks = [], []
    for i, letter in enumerate(rotation_gates):
        up, dup = _rot_and_deriv(letter, block_angles[2 * i])
        down, ddown = _rot_and_deriv(letter, block_angles[2 * i + 1])
        ks.append(_kron_batched(up, down))
        dks.append((_kron_batched(dup, down), _kron_batched(up, ddown)))
    # suffix[i] = K_{i-1} ... K_0 E, the factors right of K_i
    suffix = [e]
    for k in ks:
        suffix.append(_matmul_batched(k, suffix[-1]))
    # prefix[i] = K_{m-1} ... K_{i+1}, the factors left of K_i
    prefix = [None] * len(ks)
    acc = _lift(np.eye(4), phi).expand(e.shape)
    for i in reversed(range(len(ks))):
        prefix[i] = acc
        acc = _matmul_batched(acc, ks[i])
    grads = [_matmul_batched(_matmul_batched(prefix[i], dk), suffix[i])
             for i, pair in enumerate(dks) for dk in pair]
    if entangling_gate_name == 'cp':  # dCP/dphi = diag(0, 0, 0, i e^{i phi})
        de = torch.zeros_like(e)
        de[3, 3] = 1j * torch.polar(torch.ones_like(phi), phi)
        grads.append(_matmul_batched(acc, de))  # acc = K_{m-1} ... K_0
    return suffix[-1], grads


def surface_matrix_and_grads(a3: torch.Tensor
                             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Surface gate Rz(a2) Rx(a1) Rz(a0) and its three derivatives, all
    (2, 2, ...)."""
    r0, d0 = _rot_and_deriv('z', a3[0])
    r1, d1 = _rot_and_deriv('x', a3[1])
    r2, d2 = _rot_and_deriv('z', a3[2])
    mm = _matmul_batched
    return mm(mm(r2, r1), r0), [mm(mm(r2, r1), d0), mm(mm(r2, d1), r0),
                                mm(mm(d2, r1), r0)]


# --------------------------------------------------------------------------
# The factored 2x2 form of csrc/sweep.cu
# --------------------------------------------------------------------------

def _mm_bt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b^T, batch-last."""
    return torch.einsum('ak...,bk...->ab...', a, b)


def _leg(letters: str, angles, like: torch.Tensor
         ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(U = R_{m-1} ... R_0, [R_i]) of one leg; angles[i] is letter i's, and
    U of no letters is the identity, batch-shaped as the real `like`."""
    rs = [_rot_batched(c, a) for c, a in zip(letters, angles)]
    u = _lift(np.eye(2), like).expand((2, 2) + like.shape)
    for r in rs:
        u = _matmul_batched(r, u)
    return u, rs


def _leg_grads(letters: str, rs: List[torch.Tensor],
               v: torch.Tensor) -> List[torch.Tensor]:
    """[Im tr(V_i sigma_i) for i = 0 .. m-1] from V_{m-1} = v, walking
    V_{i-1} = R_i^dag V_i R_i down the leg."""
    out = [None] * len(letters)
    for i in reversed(range(len(letters))):
        out[i] = torch.einsum('ab...,ba->...', v,
                              _pauli(letters[i], v)).imag
        if i:
            v = _matmul_batched(rs[i].conj().transpose(0, 1),
                                _matmul_batched(v, rs[i]))
    return out


def block_vjp(entangling_gate_name: str, rotation_gates: str,
              block_angles: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """(nba, ...) angle gradients 2 Re sum Gbar * dG/dtheta of blocks with
    angles (nba, ...) and cotangents gbar (4, 4, ...), in the kernel's
    factored form (module docstring)."""
    m, like = len(rotation_gates), gbar.real[0, 0]
    u, rs_u = _leg(rotation_gates, block_angles[0:2 * m:2], like)
    d, rs_d = _leg(rotation_gates, block_angles[1:2 * m:2], like)
    x = gbar.clone()
    if entangling_gate_name == 'cp':
        phase = torch.polar(torch.ones_like(block_angles[-1]),
                            block_angles[-1])
        x[:, 3] = x[:, 3] * phase
    elif entangling_gate_name == 'cz':
        x[:, 3] = -x[:, 3]
    elif entangling_gate_name == 'cx':
        x = x[:, [0, 1, 3, 2]]
    else:
        raise ValueError(entangling_gate_name)
    x4 = x.reshape((2, 2, 2, 2) + x.shape[2:])           # [p, q, k, l]
    y_u = torch.einsum('pqkl...,ql...->pk...', x4, d)
    y_d = torch.einsum('pqkl...,pk...->ql...', x4, u)
    grads = [None] * (2 * m)
    grads[0::2] = _leg_grads(rotation_gates, rs_u, _mm_bt(u, y_u))
    grads[1::2] = _leg_grads(rotation_gates, rs_d, _mm_bt(d, y_d))
    if entangling_gate_name == 'cp':
        w3 = (u[:, None, 1] * d[None, :, 1]).reshape((4,) + u.shape[2:])
        grads.append(2 * (1j * phase * (gbar[:, 3] * w3).sum(0)).real)
    return torch.stack(grads) if grads else like.new_zeros((0,) + like.shape)


def surface_vjp(a3: torch.Tensor, gbar: torch.Tensor) -> torch.Tensor:
    """(3, ...) angle gradients 2 Re sum Gbar * dG/da_j of surface gates
    Rz(a2) Rx(a1) Rz(a0) with cotangents gbar (2, 2, ...): one leg with the
    letters z, x, z."""
    g, rs = _leg('zxz', a3, gbar.real[0, 0])
    return torch.stack(_leg_grads('zxz', rs, _mm_bt(g, gbar)))


# --------------------------------------------------------------------------
# Adjoint walk (plain reference of the kernels' walk, whole-matrix form)
# --------------------------------------------------------------------------

def _gate_cotangent(m_cot, a_prev, placement, n):
    """Gbar[p,k,b] = sum_rest M[p,rest,b] * A_prev[k,rest,b]."""
    dim_g = 2 ** len(placement)
    placement = list(placement)
    others = [q for q in range(n) if q not in placement]
    perm = placement + others + [n, n + 1]
    B = m_cot.shape[-1]
    mt = m_cot.permute(perm).reshape(dim_g, -1, B)
    at = a_prev.permute(perm).reshape(dim_g, -1, B)
    return torch.einsum('prb,krb->pkb', mt, at)


def _apply_transpose(gate, tensor, placement, n):
    """Apply G^T (plain transpose, no conjugation) at `placement`."""
    return _apply_gate_batched(gate.transpose(0, 1), tensor, placement, n)


def _apply_dagger(gate, tensor, placement, n):
    return _apply_gate_batched(gate.transpose(0, 1).conj(), tensor,
                               placement, n)


def hst_output_cotangent(u, u_target):
    """M = dL/dU (holomorphic) of the HS-test loss; u: (2,)*n + (2^n, B).
    Returns (loss_B, M)."""
    d = u_target.shape[0]
    t = torch.as_tensor(np.asarray(u_target), dtype=u.dtype,
                        device=u.device).reshape(u.shape[:-1] + (1,))
    s = (u * t.conj()).reshape(-1, u.shape[-1]).sum(dim=0)
    loss = 1 - s.abs() ** 2 / d ** 2
    return loss, (-(s.conj() / d ** 2)) * t.conj()


def manual_value_and_grad(num_qubits: int, entangling_gate_name: str,
                          rotation_gates: str, placements: dict, u_target):
    """Returns f(angles_PB) -> (loss_B, grad_PB): hand-written reverse mode
    for the HS loss (no penalty), the derivation the kernels' walk follows,
    held against autograd by the tests. Plain torch ops, unrolled over all
    blocks."""
    block_pl = all_placements(placements)
    nba = num_block_angles(entangling_gate_name, rotation_gates)
    n = num_qubits

    def f(angles):
        angles = torch.as_tensor(angles, dtype=config.real_dtype)
        B = angles.shape[-1]
        surface = angles[:3 * n].reshape(n, 3, B)
        blocks = angles[3 * n:].reshape(-1, nba, B)

        eye = torch.eye(2 ** n, dtype=config.complex_of(angles.dtype),
                        device=angles.device)
        u = eye.reshape([2] * n + [2 ** n, 1]).expand([2] * n + [2 ** n, B])
        gates, grads, places = [], [], []
        for q in range(n):
            g, gs = surface_matrix_and_grads(surface[q])
            gates.append(g)
            grads.append(gs)
            places.append([q])
        for j, p in enumerate(block_pl):
            g, gs = block_matrix_and_grads(entangling_gate_name,
                                           rotation_gates, blocks[j])
            gates.append(g)
            grads.append(gs)
            places.append(p)
        for g, p in zip(gates, places):
            u = _apply_gate_batched(g, u, p, n)

        loss, m_cot = hst_output_cotangent(u, u_target)

        # backward walk, last gate first
        a_state = u
        d_angles = [None] * len(gates)
        for j in reversed(range(len(gates))):
            g, p = gates[j], places[j]
            a_state = _apply_dagger(g, a_state, p, n)
            gbar = _gate_cotangent(m_cot, a_state, p, n)
            d_angles[j] = torch.stack([
                2 * (gbar * dg).sum(dim=(0, 1)).real for dg in grads[j]])
            m_cot = _apply_transpose(g, m_cot, p, n)
        return loss, torch.cat(d_angles, dim=0)

    return f

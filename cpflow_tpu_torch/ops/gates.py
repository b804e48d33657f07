"""Quantum gate matrices, plus canned target unitaries.

Counterpart of cpflow_tpu/ops/gates.py. Constants and targets are numpy
arrays in the big-endian convention (qubit 0 = most significant bit);
angle-parametrized matrices are built from torch ops on the angle's device,
so they differentiate under autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from cpflow_tpu_torch import config

# --- Single-qubit Pauli matrices (host constants) ----------------------------

x_mat = np.array([[0, 1], [1, 0]], dtype=np.complex64)
y_mat = np.array([[0, -1j], [1j, 0]], dtype=np.complex64)
z_mat = np.array([[1, 0], [0, -1]], dtype=np.complex64)


def rotation_matrix(pauli: np.ndarray, a: torch.Tensor) -> torch.Tensor:
    """exp(-i a P / 2) = cos(a/2) I - i sin(a/2) P for a scalar tensor a."""
    a = torch.as_tensor(a, dtype=config.real_dtype)
    eye = torch.eye(2, dtype=config.complex_dtype, device=a.device)
    p = torch.as_tensor(pauli, device=a.device)
    return torch.cos(a / 2) * eye - 1j * torch.sin(a / 2) * p


def rx_mat(a):
    return rotation_matrix(x_mat, a)


def ry_mat(a):
    return rotation_matrix(y_mat, a)


def rz_mat(a):
    return rotation_matrix(z_mat, a)


# --- Two-qubit gates ----------------------------------------------------------

cx_mat = np.array(
    [[1, 0, 0, 0],
     [0, 1, 0, 0],
     [0, 0, 0, 1],
     [0, 0, 1, 0]], dtype=np.complex64)

cz_mat = np.array(
    [[1, 0, 0, 0],
     [0, 1, 0, 0],
     [0, 0, 1, 0],
     [0, 0, 0, -1]], dtype=np.complex64)


def cp_mat(a) -> torch.Tensor:
    """Controlled phase diag(1, 1, 1, e^{ia}): identity at a=0 or 2pi, CZ at
    a=pi."""
    a = torch.as_tensor(a, dtype=config.real_dtype)
    one = torch.ones((), dtype=config.complex_dtype, device=a.device)
    return torch.diag(torch.stack([one, one, one, torch.polar(one.real, a)]))


ROTATION_MATS = {'x': rx_mat, 'y': ry_mat, 'z': rz_mat}


# --- Canned target unitaries (big-endian: qubit 0 = MSB; host numpy) ---------

def multi_controlled_z(num_qubits: int) -> np.ndarray:
    """C^{n-1}Z: diagonal with -1 on the all-ones state."""
    d = 2 ** num_qubits
    diag = np.ones(d, dtype=np.complex64)
    diag[d - 1] = -1
    return np.diag(diag)


def multi_controlled_x(num_qubits: int) -> np.ndarray:
    """C^{n-1}X (generalized Toffoli), target = last qubit, big-endian."""
    d = 2 ** num_qubits
    u = np.eye(d, dtype=np.complex64)
    u[d - 2, d - 2] = u[d - 1, d - 1] = 0
    u[d - 2, d - 1] = u[d - 1, d - 2] = 1
    return u


def multi_controlled_sqrt_x(num_qubits: int) -> np.ndarray:
    """C^{n-1}(sqrt X): identity except the bottom 2x2 block, the principal
    square root of X."""
    return multi_controlled_x_root(num_qubits, 2)


def multi_controlled_x_root(num_qubits: int, root: int) -> np.ndarray:
    """C^{n-1}(X^(1/root)): identity except the bottom 2x2 block,
    H diag(1, e^{i pi/root}) H."""
    d = 2 ** num_qubits
    u = np.eye(d, dtype=np.complex64)
    w = np.exp(1j * np.pi / root)
    v = 0.5 * np.array([[1 + w, 1 - w], [1 - w, 1 + w]])
    u[d - 2:, d - 2:] = v.astype(np.complex64)
    return u


u_toff3 = multi_controlled_x(3)
u_toff4 = multi_controlled_x(4)
u_toff5 = multi_controlled_x(5)

u_ccz3 = multi_controlled_z(3)
u_cccz4 = multi_controlled_z(4)

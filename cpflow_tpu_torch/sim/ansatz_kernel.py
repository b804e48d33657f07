"""The ansatz forward pass for one restart: angles -> 2^n x 2^n unitary
(counterpart of cpflow_tpu/sim/ansatz_kernel.py).

The angle layout is public API and identical to the JAX package's (and the
upstream reference's): 3 surface angles per qubit (Rz, Rx, Rz), then per
block the up/down rotation angles interleaved, CP angle last.
"""

from __future__ import annotations

import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.ops import gates
from cpflow_tpu_torch.sim.apply import apply_gate_to_tensor


def num_block_angles(entangling_gate_name: str, rotation_gates: str) -> int:
    """2 rotation angles per rotation letter + 1 CP angle if applicable."""
    return 2 * len(rotation_gates) + (entangling_gate_name == 'cp')


def block_matrix(entangling_gate_name: str, rotation_gates: str, angles):
    """4x4 unitary of one entangling block. Layout of `angles` (length 2m or
    2m+1): up rotations at even indices, down rotations at odd indices, CP
    angle last."""
    angles = torch.as_tensor(angles, dtype=config.real_dtype)
    if entangling_gate_name == 'cx':
        u = torch.as_tensor(gates.cx_mat, device=angles.device)
    elif entangling_gate_name == 'cz':
        u = torch.as_tensor(gates.cz_mat, device=angles.device)
    elif entangling_gate_name == 'cp':
        u = gates.cp_mat(angles[-1])
    else:
        raise ValueError(f"Unknown entangling gate {entangling_gate_name!r}")
    for i, letter in enumerate(rotation_gates):
        rot = gates.ROTATION_MATS[letter]
        u = torch.kron(rot(angles[2 * i]), rot(angles[2 * i + 1])) @ u
    return u


def split_angles(angles, num_qubits, nba, layer_len=0, num_layers=0):
    """Slice the flat angle vector into surface / per-block groups."""
    surface_angles = angles[:3 * num_qubits].reshape(num_qubits, 3)
    block_angles = angles[3 * num_qubits:].reshape(-1, nba)
    layers_angles = block_angles[:layer_len * num_layers].reshape(
        num_layers, layer_len, nba)
    free_block_angles = block_angles[layer_len * num_layers:]
    cp_angles = [b[-1] for b in block_angles] if nba % 2 == 1 else []
    return {'surface angles': surface_angles,
            'block angles': block_angles,
            'layers angles': layers_angles,
            'free block angles': free_block_angles,
            'cp angles': cp_angles}


def cp_angle_indices(num_qubits: int, nba: int, num_blocks: int):
    """Flat indices of CP angles: 3n + j*nba + (nba-1)."""
    return [3 * num_qubits + j * nba + (nba - 1) for j in range(num_blocks)]


def surface_gate(a):
    """Initial per-qubit 1q round: Rz(a2) Rx(a1) Rz(a0)."""
    return gates.rz_mat(a[2]) @ gates.rx_mat(a[1]) @ gates.rz_mat(a[0])


def all_placements(placements: dict):
    """Block placements in application order: complete layers, then the
    free remainder."""
    layer, num_layers = placements['layers']
    return [list(p) for p in layer] * num_layers + \
        [list(p) for p in placements['free']]


def build_unitary(num_qubits, entangling_gate_name, rotation_gates,
                  placements, angles) -> torch.Tensor:
    """Assemble the full ansatz unitary, a 2^n x 2^n complex matrix
    (big-endian). placements: {'layers': [layer, num_layers], 'free': [...]}
    from topology.fill_layers."""
    nba = num_block_angles(entangling_gate_name, rotation_gates)
    angles = torch.as_tensor(angles, dtype=config.real_dtype)
    surface = angles[:3 * num_qubits].reshape(num_qubits, 3)
    blocks = angles[3 * num_qubits:].reshape(-1, nba)

    d = 2 ** num_qubits
    u = torch.eye(d, dtype=config.complex_dtype, device=angles.device)
    u = u.reshape([2] * (2 * num_qubits))
    for q in range(num_qubits):
        u = apply_gate_to_tensor(surface_gate(surface[q]), u, [q])
    for j, p in enumerate(all_placements(placements)):
        g = block_matrix(entangling_gate_name, rotation_gates, blocks[j])
        u = apply_gate_to_tensor(g, u, p)
    return u.reshape(d, d)

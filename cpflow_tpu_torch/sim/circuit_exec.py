"""Executing IR circuits as differentiable parametrized unitary functions
(counterpart of cpflow_tpu/sim/circuit_exec.py).

Turns a concrete circuit back into a function of its rotation angles, with
a conversion-correctness check. Used when a refined circuit needs its
angles re-optimized. Plain torch ops on the angles' device: a general
circuit is no two-qubit-block ansatz, and no kernel of either package
builds one.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.circuits.ir import Circuit, ROTATION_NAMES
from cpflow_tpu_torch.ops import gates
from cpflow_tpu_torch.ops.losses import cost_HST
from cpflow_tpu_torch.sim.apply import apply_gate_to_tensor


def circuit_to_torch_unitary(circ: Circuit, check: bool = True
                             ) -> Tuple[Callable, List[float], List[int]]:
    """Return (u_func, initial_angles, wires): u_func maps a tensor of
    rotation angles to the circuit unitary; initial_angles and wires list
    the circuit's rotation parameters in order.

    Supports rotation gates (parametrized) plus any fixed gate in the IR
    (cz, cx, h, s, t, ... embedded as constants) and concrete-angle cp
    gates."""
    n = circ.num_qubits
    init_angles = [float(i.param) for i in circ.instructions
                   if i.name in ROTATION_NAMES]
    wires = [i.qubits[0] for i in circ.instructions
             if i.name in ROTATION_NAMES]

    def u_func(angles):
        angles = torch.as_tensor(angles, dtype=config.real_dtype)
        u = torch.eye(2 ** n, dtype=config.complex_dtype,
                      device=angles.device).reshape([2] * (2 * n))
        i = 0
        for inst in circ.instructions:
            if inst.name in ROTATION_NAMES:
                mat = gates.ROTATION_MATS[inst.name[1]](angles[i])
                i += 1
            else:  # a constant: cp at its concrete angle, or a fixed gate
                mat = torch.as_tensor(inst.gate_matrix(),
                                      dtype=config.complex_dtype,
                                      device=angles.device)
            u = apply_gate_to_tensor(mat, u, list(inst.qubits))
        return u.reshape(2 ** n, 2 ** n)

    if check:
        cost = float(cost_HST(u_func(init_angles),
                              circ.unitary().astype(np.complex64)))
        assert cost < 1e-5, (
            f'Error converting circuit to a torch unitary: HST distance '
            f'{cost} too high.')

    return u_func, init_angles, wires

"""State carried between the JAX package and the port.

The system has no weights: its parameters are angle vectors in the layout
of sim/ansatz_kernel.py, identical in both packages. The JAX package's
public functions take restart batches as (B, P) arrays; the port's sweep
takes (P, B) tensors, batch last. An adaptive search's state is its trial
records, which ``trials_from_jax`` carries over so that a search saved by
the JAX package resumes in the port. A circuit is a list of instructions:
``circuit_from_jax`` and ``circuit_to_jax`` carry one between the two
packages' ``Circuit`` classes, so that both ``refine`` pipelines can take
the same circuit.
"""

from __future__ import annotations

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.api import Ansatz
from cpflow_tpu_torch.circuits.ir import Circuit
from cpflow_tpu_torch.search import tpe
from cpflow_tpu_torch.sim.ansatz_kernel import cp_angle_indices
from cpflow_tpu_torch.topology import fill_layers, num_qubits_from_layer


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


def trials_from_jax(results_or_trials, rotation_gates: str = 'xyz'
                    ) -> tpe.Trials:
    """The JAX package's adaptive trial records (its ``Results``, or its
    ``Results.trials``) as the port's ``tpe.Trials``: values and result
    dicts copied, numbers as Python or numpy values, and the prospective
    angles of a trial kept with keep_logs checked against the trial's
    template (rotation_gates, as the search ran) through angles_from_jax.
    The keep_logs ``attachments`` are dropped: they are dill payloads of
    the JAX package's objects. Set the result as a port ``Results.trials``
    and ``Synthesize.adaptive`` resumes from it."""
    src = results_or_trials if hasattr(results_or_trials, 'vals') else \
        results_or_trials.trials
    out = tpe.Trials()
    for values, result in zip(src.vals, src.results):
        rec = {key: value for key, value in dict(result).items()
               if key != 'attachments'}
        if 'prospective_decompositions' in rec:
            anz = Ansatz(num_qubits_from_layer(rec['layer']), 'cp',
                         fill_layers(rec['layer'], rec['num_cp_gates']),
                         rotation_gates)
            rec['prospective_decompositions'] = [
                [int(cz), angles_to_jax(angles_from_jax(a, anz, 'cpu'))[0]]
                for cz, a in rec['prospective_decompositions']]
        out.record([int(values[0]), float(values[1])], rec)
    return out


def circuit_rows(circuit) -> list:
    """Either package's ``Circuit`` as plain rows (name, qubits, param,
    matrix): param a Python float or None, matrix a numpy copy or None."""
    return [(inst.name, tuple(int(q) for q in inst.qubits),
             None if inst.param is None else float(inst.param),
             None if inst.matrix is None else np.array(inst.matrix))
            for inst in circuit.instructions]


def circuit_from_jax(circuit_or_rows, num_qubits=None) -> Circuit:
    """The JAX package's ``Circuit``, or its rows (name, qubits[, param
    [, matrix]]) with ``num_qubits``, as the port's ``Circuit``."""
    if hasattr(circuit_or_rows, 'instructions'):
        num_qubits = circuit_or_rows.num_qubits
        circuit_or_rows = circuit_rows(circuit_or_rows)
    out = Circuit(num_qubits)
    for row in circuit_or_rows:
        out.append(*row)
    return out


def circuit_to_jax(circuit: Circuit, circuit_cls):
    """The port's ``Circuit`` as an instance of ``circuit_cls``, the JAX
    package's ``Circuit`` class (passed in: this module does not import
    that package)."""
    out = circuit_cls(circuit.num_qubits)
    for row in circuit_rows(circuit):
        out.append(*row)
    return out

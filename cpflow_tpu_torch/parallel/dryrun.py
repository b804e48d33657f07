"""Entry points for a quick check of the port: the flagship objective's
forward pass, and a dry run of the restart split (counterparts of
``entry`` and ``dryrun_multichip`` in __graft_entry__.py).

    python -c "from cpflow_tpu_torch.parallel.dryrun import *; \
        print(dryrun_multichip(4))"
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.ops import prng


def _flagship_objective(num_qubits=5, num_cp_gates=20, rotation_gates='xyz'):
    """The flagship workload's fused objective: the CP-relaxed ansatz on an
    n-qubit chain, HS-test loss against the n-qubit Toffoli plus the CP
    penalty at r = 0.00055 (the hot path of Synthesize.static). Returns
    (objective, number of angles)."""
    from cpflow_tpu_torch.api import LossSpec
    from cpflow_tpu_torch.ops.gates import multi_controlled_x
    from cpflow_tpu_torch.ops.penalty import LinearPenalty
    from cpflow_tpu_torch.sim.ansatz_kernel import (cp_angle_indices,
                                                    num_block_angles)
    from cpflow_tpu_torch.sim.batched import make_batched_regloss
    from cpflow_tpu_torch.topology import chain_layer, fill_layers

    placements = fill_layers(chain_layer(num_qubits), num_cp_gates)
    nba = num_block_angles('cp', rotation_gates)
    num_angles = 3 * num_qubits + nba * num_cp_gates
    cp_mask = np.zeros(num_angles, dtype=np.float32)
    cp_mask[cp_angle_indices(num_qubits, nba, num_cp_gates)] = 1.0
    objective = make_batched_regloss(
        num_qubits, 'cp', rotation_gates, placements,
        LossSpec('hst', target=multi_controlled_x(num_qubits)),
        cp_mask=cp_mask,
        regularization_func=LinearPenalty(math.pi / 2, 2.0, 0.05, 0.05, 0.05),
        r=0.00055)
    return objective, num_angles


def entry(device=None):
    """(fn, example_args): the batched forward pass of the flagship
    objective (5q chain, k=20) on a batch of 64 restarts, angles (B, P) in,
    regularized losses (B,) out; on the card unless `device` says
    otherwise. On a CUDA device the unitary comes from the forward kernel
    (kernels/unitary.py)."""
    device = config.resolve_device(device=device)
    objective, num_angles = _flagship_objective()

    def forward(angles_bp):
        regloss, _ = objective(angles_bp.T)  # batch last: (P, B)
        return regloss

    example = prng.uniform(prng.PRNGKey(0, device), (64, num_angles), 0.0,
                           2 * math.pi, dtype=config.real_dtype)
    return forward, (example,)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The multi-start Adam sweep, then the miniature static pipeline, with
    the restarts split over a mesh of n_devices entries: the visible cards,
    repeated in turn up to n_devices where there are fewer (one card then
    runs several shards), or the CPU n_devices times with device='cpu'.
    Raises where a step fails. Returns what ran: the mesh's devices,
    whether cards were repeated, the sweep's batch and the pipeline's CZ
    counts."""
    from cpflow_tpu_torch.api import StaticOptions, Synthesize
    from cpflow_tpu_torch.ops import gates
    from cpflow_tpu_torch.optimize.engine import minimize_fused
    from cpflow_tpu_torch.parallel import mesh as mesh_lib

    device = config.resolve_device(device=device)
    if device.type == 'cuda':
        cards = torch.cuda.device_count()
        names = [f'cuda:{i % cards}' for i in range(n_devices)]
    else:
        names = ['cpu'] * n_devices
    mesh = mesh_lib.restart_mesh(names)

    # 3 qubits, 4 blocks, 'xz', 2 Adam steps over 2 restarts a shard
    objective, num_angles = _flagship_objective(num_qubits=3, num_cp_gates=4,
                                                rotation_gates='xz')
    batch = 2 * mesh.size
    inits = prng.uniform(prng.PRNGKey(0, device), (batch, num_angles), 0.0,
                         2 * math.pi, dtype=config.real_dtype)
    raw = minimize_fused(objective, inits, learning_rate=0.1,
                         num_iterations=2, sharding=mesh)
    if tuple(raw.params.shape) != (batch, 2, num_angles) or \
            not bool(torch.isfinite(raw.regloss).all()):
        raise RuntimeError(f'dry run: bad sweep result '
                           f'{tuple(raw.params.shape)}')

    # the miniature static pipeline over the same mesh: sampling split over
    # it, verification and the decompositions as always
    s = Synthesize([[0, 1]], target_unitary=np.asarray(gates.cz_mat),
                   label='dryrun_static', device=device, mesh=mesh)
    opts = StaticOptions(num_cp_gates=1, accepted_num_cz_gates=1,
                         num_samples=batch, num_gd_iterations=60,
                         rotation_gates='xz', random_seed=3,
                         num_gd_iterations_at_verification=200)
    res = s.static(opts, save_results=False, verbose=False)
    return {'mesh': [str(d) for d in mesh.devices],
            'cards_repeated': device.type == 'cuda' and
            n_devices > torch.cuda.device_count(),
            'batch': batch,
            'cz_counts': sorted(d.cz_count for d in res.decompositions)}

"""The multi-start Adam sweep: the hand-written Hopper kernel and its plain
PyTorch version.

``sweep`` replaces cpflow_tpu/experimental/pallas_sweep.py:make_pallas_sweep
(and its host wrapper ``pallas_minimize_fused``). On a CUDA tensor it
launches the CUDA kernel of csrc/sweep.cu, built for sm_90a with nvcc into
``build/`` at first use and bound with ctypes; it never falls back. On a CPU
tensor it runs ``sweep_reference``: the sim/batched.py objective under
PyTorch autograd and the same Adam loop, written out to match optax.adam.

The kernel computes what make_pallas_sweep computes, for any rotation
string of x, y, z with the CP entangler, and besides the fixed CZ and CX
entanglers and five losses: the HS test, disc and the modulo-identity and
modulo-diagonal losses on the whole 2^n x 2^n unitary, and state
preparation on its |0...0> column only. The penalty weight r is given per
restart: a float r is expanded to every restart, a (B,) tensor r (several
adaptive trials side by side) is passed as it is. It raises, and never
falls back, above MAX_QUBITS (8 qubits for the whole unitary, 12 for a
state), for float64 and for a penalty other than the piecewise-linear one.

Routing of ``sweep``, by the tensor's device and the loss:
  * CPU tensor, any loss: ``sweep_reference``, the plain version;
  * CUDA tensor, a built-in loss kind: the fused sweep kernel;
  * CUDA tensor, a custom loss (a torch callable of one unitary, which
    cannot enter a fused kernel): the Adam loop of ``sweep_reference``
    around the objective, whose unitary comes from the hand-written
    forward and vjp kernels of kernels/unitary.py (never from the plain
    builder: an objective made with ``plain=True`` is refused), with
    target_loss checked every TARGET_CHECK_EVERY steps as on the fused
    route.

What bounds the kernel on this card, and what its design does about it, is
set out at the top of csrc/sweep.cu: per-restart shared memory (the state
and cotangent, 2^n x C each) and the barriers and block reductions of the
adjoint walk (few threads per restart, a 31-shuffle warp reduction,
double-buffered cross-warp partials). A restart runs on one thread block
where its layout fits one block's shared memory (every shape up to 6
qubits, and a state up to 12); above that its columns are split over a
thread-block cluster of 2, 4 or 8 blocks, the smallest that fits
(``cluster_plan``; 7 qubits take 2, or 4 from 215 'xyz' blocks, 8 qubits
take 8). On the card the library's own plan decides
(``cpflow_sweep_cluster``); ``smem_bytes`` and ``cluster_plan`` mirror it
so that the plan can be checked without a card. Every block of a cluster
runs Adam on the same angles, and the kernel traps if the blocks end a
launch with different bits of the Adam state.

target_loss: the sweep stops once every restart's best loss is at or under
it, as engine.fused_adam_sweep of the JAX package does. The plain loop
checks before every step; the kernel runs in launches of
TARGET_CHECK_EVERY steps with the Adam state kept on the card and is
checked between them, so it may run up to TARGET_CHECK_EVERY - 1 more
steps. Success flags agree; best losses are at most the plain loop's.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.kernels import build
from cpflow_tpu_torch.ops.penalty import LinearPenalty, breakpoints
from cpflow_tpu_torch.ops.losses import _shift_indices, wire_permutation
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles

LAUNCHES = 0  # kernel launches since the last reset; the plain path adds none

# qubits the kernel takes, per loss (the whole unitary, split over at most
# 8 blocks, or one column on one block)
MAX_QUBITS = {'hst': 8, 'disc': 8, 'modulo_identity': 8,
              'modulo_diagonal': 8, 'state': 12}
LOSS_CODES = {'hst': 0, 'state': 1, 'disc': 2, 'modulo_identity': 3,
              'modulo_diagonal': 4}  # as csrc/sweep.cu numbers them
ENTANGLER_CODES = {'cp': 0, 'cz': 1, 'cx': 2}
LETTER_CODES = {'x': 0, 'y': 1, 'z': 2}
TARGET_CHECK_EVERY = 50  # kernel steps between host checks of target_loss

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_lib = None  # the bound library; set to time another build of the kernel


class SweepResult(NamedTuple):
    best_params: torch.Tensor  # (P, B) angles before the best step
    best_reg: torch.Tensor     # (B,) best regularized loss
    best_loss: torch.Tensor    # (B,) loss at that step
    regloss0: torch.Tensor     # (B,) regularized loss at the initial angles
    loss0: torch.Tensor        # (B,) loss at the initial angles


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------

def adam_step(params, grad, m, v, t: int, learning_rate: float):
    """One optax.adam update at step t (from 1): b1 0.9, b2 0.999, eps 1e-8
    outside the square root, bias correction. Returns (params, m, v)."""
    m = (1 - _B1) * grad + _B1 * m
    v = (1 - _B2) * (grad * grad) + _B2 * v
    mhat = m / (1 - _B1 ** t)
    vhat = v / (1 - _B2 ** t)
    return params - learning_rate * (mhat / (torch.sqrt(vhat) + _EPS)), m, v


def sweep_reference(objective, params0: torch.Tensor,
                    learning_rate: float = 0.1, num_iterations: int = 5000,
                    grad_mask: Optional[torch.Tensor] = None,
                    target_loss: Optional[float] = None,
                    check_every: int = 1) -> SweepResult:
    """Multi-start Adam over objective(params_PB) -> (regloss_B, loss_B).

    optax.adam arithmetic: b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, bias correction with step t from 1. grad_mask (P, B) multiplies
    the gradient before the moments, so a masked entry never moves. Best
    tracking keeps the angles *before* the update whose loss improved
    (strict <); the initial angles are the first best. With target_loss the
    loop stops once every restart's best loss is at or under it, checked
    before every check_every-th step (each check reads the card). It runs
    in the objective's dtype.
    """
    params = params0.detach().to(objective.dtype).clone()
    with torch.no_grad():
        regloss0, loss0 = objective(params)
    best_p = params.clone()
    best_reg, best_loss = regloss0.clone(), loss0.clone()
    m = torch.zeros_like(params)
    v = torch.zeros_like(params)
    for it in range(num_iterations):
        if target_loss is not None and it % check_every == 0 and \
                bool((best_loss <= target_loss).all()):
            break
        p = params.clone().requires_grad_(True)
        regloss, loss = objective(p)
        (grad,) = torch.autograd.grad(regloss.sum(), p)
        with torch.no_grad():
            if grad_mask is not None:
                grad = grad * grad_mask
            improved = regloss < best_reg
            best_reg = torch.where(improved, regloss, best_reg)
            best_loss = torch.where(improved, loss, best_loss)
            best_p = torch.where(improved[None, :], params, best_p)
            params, m, v = adam_step(params, grad, m, v, it + 1,
                                     learning_rate)
    return SweepResult(best_p, best_reg.detach(), best_loss.detach(),
                       regloss0, loss0)


# --------------------------------------------------------------------------
# Build and bind
# --------------------------------------------------------------------------

def load_library() -> ctypes.CDLL:
    """Build csrc/sweep.cu for sm_90a (once per version of csrc/) and load
    it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load('sweep')
    ptr = ctypes.c_void_p
    lib.cpflow_sweep_launch.argtypes = [ptr] * 13 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ptr]
    lib.cpflow_sweep_launch.restype = ctypes.c_int
    lib.cpflow_sweep_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.cpflow_sweep_smem_bytes.restype = ctypes.c_longlong
    lib.cpflow_sweep_cluster.argtypes = [ctypes.c_int] * 4
    lib.cpflow_sweep_cluster.restype = ctypes.c_int
    lib.cpflow_sweep_occupancy.argtypes = [ctypes.c_int] * 5 + [ptr]
    lib.cpflow_sweep_occupancy.restype = ctypes.c_int
    _lib = lib
    return lib


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
CLUSTERS = (1, 2, 4, 8)  # blocks a restart may run on


def smem_bytes(n: int, num_blocks: int, nba: int, kind: str,
               cluster: int = 1) -> int:
    """Dynamic shared memory of each block of a restart split over
    `cluster` blocks, as csrc/sweep.cu's make_layout lays it out: the tile
    of A and of M (2^n x C / cluster amplitudes each), the gates and their
    cotangents, the cross-warp partials, the modulo losses' row sums, five
    arrays of the P angles and the cos and sin of each, 16 scalars."""
    log_c = 0 if kind == 'state' else n
    log_ct = log_c - (cluster.bit_length() - 1)
    P, G = 3 * n + nba * num_blocks, n + num_blocks
    threads = min(max((1 << (n + log_ct)) // 16, 32), 256)
    rows = (8 << n) if kind.startswith('modulo') else 0
    return (16 << (n + log_ct)) + 256 * G + 8 * threads + rows + 28 * P + 64


def cluster_plan(n: int, num_blocks: int, nba: int, kind: str):
    """The blocks each restart runs on, as csrc/sweep.cu's cluster_plan
    picks them: the smallest of 1, 2, 4, 8 whose per-block layout fits one
    block's shared memory, never a split of the one column of a state, and
    no more blocks than columns. None if none fits."""
    for c in CLUSTERS:
        if c > 1 and (kind == 'state' or c > 1 << n):
            break
        if smem_bytes(n, num_blocks, nba, kind, c) <= _SMEM_LIMIT:
            return c
    return None


def modulo_tables(n: int, wires):
    """The index maps the kernel's modulo losses take: (4, 2^n) rows pi,
    pi^-1, s, s^-1 (ops.losses.wire_permutation of `wires` and the block
    shift of ops.losses._shift_indices) and log2 of the block size,
    n - len(wires)."""
    perm = wire_permutation(n, wires)
    block_log2 = n - len(wires)
    shift = _shift_indices(1 << n, 1 << block_log2)
    return np.stack([perm, np.argsort(perm), shift, np.argsort(shift)]), \
        block_log2


def _check_objective(objective):
    spec = objective.unitary_loss_func
    kind = getattr(spec, 'kind', None)
    if kind not in MAX_QUBITS:
        raise NotImplementedError(
            f'the fused sweep kernel computes the {", ".join(MAX_QUBITS)} '
            f'losses, got {kind!r}: a custom loss (a Python callable) cannot '
            f'enter it, and sweep() routes one to the unitary kernels')
    if objective.dtype != torch.float32:
        raise ValueError(f'the sweep kernel computes in float32, the '
                         f'objective in {objective.dtype}')
    n, limit = objective.num_qubits, MAX_QUBITS[kind]
    if not 2 <= n <= limit:
        where = 'one block' if kind == 'state' else \
            f'a cluster of {CLUSTERS[-1]} blocks'
        raise ValueError(
            f'the sweep kernel takes 2 to {limit} qubits for a {kind!r} '
            f'loss, got {n}: above {limit} the state and cotangent exceed the '
            f'shared memory of {where}')
    if objective.entangling_gate_name not in ENTANGLER_CODES or \
            set(objective.rotation_gates) - set(LETTER_CODES):
        raise ValueError(
            f'unknown template: entangler {objective.entangling_gate_name!r} '
            f'(cp, cz or cx), rotations {objective.rotation_gates!r} '
            f'(letters of x, y, z)')
    if kind.startswith('modulo') and (
            spec.num_qubits != n or
            sorted(set(spec.wires)) != sorted(spec.wires) or
            not set(spec.wires) <= set(range(n))):
        raise ValueError(f'a {kind!r} loss on {n} qubits needs num_qubits '
                         f'{n} and distinct wires in range({n}), got '
                         f'{spec.num_qubits} and {spec.wires}')
    if objective.has_penalty and \
            not isinstance(objective.regularization_func, LinearPenalty):
        raise NotImplementedError(
            'the sweep kernel computes the piecewise-linear penalty only')


def _launch(objective, params0, learning_rate, num_iterations, grad_mask,
            target_loss) -> SweepResult:
    _check_objective(objective)
    device = params0.device
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(f'the sweep kernel is built for sm_90a (Hopper); '
                           f'device has compute capability {major}.{minor}')
    n, spec = objective.num_qubits, objective.unitary_loss_func
    ent, rot = objective.entangling_gate_name, objective.rotation_gates
    placements = all_placements(objective.placements)
    nb = len(placements)
    nba = num_block_angles(ent, rot)
    P = 3 * n + nba * nb
    if params0.dim() != 2 or params0.shape[0] != P:
        raise ValueError(f'params0 must be (P={P}, B), got '
                         f'{tuple(params0.shape)}')
    B = params0.shape[1]
    params0 = params0.to(config.real_dtype).contiguous()
    if grad_mask is not None:
        if tuple(grad_mask.shape) != (P, B):
            raise ValueError(f'grad_mask must be ({P}, {B}), got '
                             f'{tuple(grad_mask.shape)}')
        grad_mask = grad_mask.to(device=device,
                                 dtype=config.real_dtype).contiguous()

    loss = LOSS_CODES[spec.kind]
    lib = load_library()
    cluster = lib.cpflow_sweep_cluster(n, nb, nba, loss)
    if not cluster:
        most = 1 if spec.kind == 'state' else CLUSTERS[-1]
        raise ValueError(
            f'{n} qubits with {nb} blocks need '
            f'{lib.cpflow_sweep_smem_bytes(n, nb, nba, loss, most)} bytes of '
            f'shared memory per block even on {most} blocks a restart, above '
            f'{_SMEM_LIMIT}')

    state = spec.kind == 'state'
    target = torch.as_tensor(np.asarray(spec.target),
                             dtype=config.complex_dtype)
    if tuple(target.shape) != ((1 << n,) if state else (1 << n, 1 << n)):
        raise ValueError(f'target of shape {tuple(target.shape)} for a '
                         f'{n}-qubit {spec.kind!r} loss')
    target = torch.view_as_real(target.to(device).contiguous())
    if objective.has_penalty:
        cp_mask = torch.as_tensor(objective.cp_mask, device=device)
        xs, ys = breakpoints(*objective.regularization_func.params)
        r = objective.r
    else:  # a zero mask and r = 0: any curve gives no penalty
        cp_mask = torch.zeros(P, device=device, dtype=config.real_dtype)
        xs, ys = breakpoints(np.pi / 2, 2.0, .05, .05, .05)
        r = 0.0
    if isinstance(r, torch.Tensor):
        if tuple(r.shape) != (B,):
            raise ValueError(f'r must be a float or of shape ({B},), got '
                             f'{tuple(r.shape)}')
        r = r.to(device=device, dtype=config.real_dtype).contiguous()
    else:
        r = torch.full((B,), float(r), dtype=config.real_dtype, device=device)
    pen_tab = torch.tensor(xs + ys, dtype=config.real_dtype, device=device)
    letters = torch.tensor([LETTER_CODES[c] for c in rot] or [0],
                           dtype=torch.int32, device=device)
    wire_map, block_log2 = modulo_tables(n, spec.wires) \
        if spec.kind.startswith('modulo') else (np.zeros((1, 1)), 0)
    wire_map = torch.tensor(wire_map, dtype=torch.int32, device=device)
    plc = torch.tensor(placements if nb else [[0, 0]], dtype=torch.int32,
                       device=device).contiguous()
    # the Adam state, kept on the card between launches
    params = params0.clone()
    mom1 = torch.zeros_like(params0)
    mom2 = torch.zeros_like(params0)
    best_params = params0.clone()
    summary = torch.empty((4, B), dtype=config.real_dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch(it_begin, it_end):
        global LAUNCHES
        err = lib.cpflow_sweep_launch(
            params.data_ptr(), mom1.data_ptr(), mom2.data_ptr(),
            best_params.data_ptr(), summary.data_ptr(), target.data_ptr(),
            cp_mask.data_ptr(),
            grad_mask.data_ptr() if grad_mask is not None else None,
            plc.data_ptr(), pen_tab.data_ptr(), r.data_ptr(),
            letters.data_ptr(), wire_map.data_ptr(), n, nb, len(rot),
            ENTANGLER_CODES[ent], nba, loss, block_log2, B, it_begin, it_end,
            float(learning_rate), stream)
        if err != 0:
            raise RuntimeError(
                f'sweep kernel launch failed: CUDA error {err} ({B} restarts '
                f'on {cluster} blocks each)')
        LAUNCHES += 1

    T = int(num_iterations)
    if B and target_loss is None:
        launch(0, T)
    elif B:
        launch(0, 0)  # initial losses only
        it = 0
        while it < T and not bool((summary[3] <= target_loss).all()):
            end = min(it + TARGET_CHECK_EVERY, T)
            launch(it, end)
            it = end
    return SweepResult(best_params, summary[2], summary[3], summary[0],
                       summary[1])


def occupancy(objective, batch: int) -> dict:
    """What the kernel build that a sweep of `batch` restarts of
    `objective` launches takes of one SM, from the CUDA runtime: registers
    and local memory bytes (stack and spills) per thread, threads and
    shared memory bytes per block, resident blocks per SM, the blocks a
    restart runs on (`cluster`) and the clusters of that many blocks the
    card holds at once (cudaOccupancyMaxActiveClusters; a lone block counts
    as a cluster of one)."""
    _check_objective(objective)
    n, spec = objective.num_qubits, objective.unitary_loss_func
    nb = len(all_placements(objective.placements))
    nba = num_block_angles(objective.entangling_gate_name,
                           objective.rotation_gates)
    out = (ctypes.c_int * 7)()
    err = load_library().cpflow_sweep_occupancy(
        n, nb, nba, LOSS_CODES[spec.kind], int(batch), out)
    if err != 0:
        raise RuntimeError(f'sweep kernel occupancy query failed: CUDA error '
                           f'{err}')
    return dict(zip(('registers', 'local_bytes', 'threads', 'smem_bytes',
                     'blocks_per_sm', 'cluster', 'active_clusters'), out))


def sweep(objective, params0: torch.Tensor, learning_rate: float = 0.1,
          num_iterations: int = 5000, grad_mask: Optional[torch.Tensor] = None,
          target_loss: Optional[float] = None) -> SweepResult:
    """The multi-start Adam sweep of `objective` (a
    sim.batched.BatchedRegloss) from params0 (P, B), routed as the module
    docstring says: the plain version for a CPU tensor; for a CUDA tensor
    the fused kernel (a built-in loss) or the Adam loop over the unitary
    kernels (a custom loss). Returns a SweepResult."""
    if params0.device.type == 'cuda':
        if getattr(objective.unitary_loss_func, 'kind', 'custom') != 'custom':
            return _launch(objective, params0, learning_rate, num_iterations,
                           grad_mask, target_loss)
        if objective.plain:
            raise ValueError('a custom loss on the card goes through the '
                             'unitary kernels; this objective was made with '
                             'plain=True')
        if grad_mask is not None:
            grad_mask = grad_mask.to(device=params0.device,
                                     dtype=objective.dtype)
        return sweep_reference(objective, params0, learning_rate,
                               num_iterations, grad_mask, target_loss,
                               check_every=TARGET_CHECK_EVERY)
    if params0.device.type == 'cpu':
        return sweep_reference(objective, params0, learning_rate,
                               num_iterations, grad_mask, target_loss)
    raise ValueError(f'no sweep for device {params0.device}')

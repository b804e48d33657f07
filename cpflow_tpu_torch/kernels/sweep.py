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
falls back, above MAX_QUBITS (for the HS test and disc losses 13 qubits in
float32 and 12 in float64; for the modulo losses 8, past which ``sweep``
routes them to the unitary kernels; for a state 17 in float32 and 16 in
float64, past which ``sweep`` routes it to the unitary kernels, whose global
row tiles hold one column to 24 qubits in float32 and 23 in float64), for
a template too deep for every plan
(``cluster_plan``, ``tile_plan``), and for a penalty other than the
piecewise-linear one.

Precision. The kernel computes in the objective's dtype: float32 through
the float build of csrc/sweep.cu, float64 through its double build (the
same source compiled with -DCPFLOW_DOUBLE, kernels/build.py), never one
in the other's place. In double every amplitude tile takes twice the
shared memory, so the cluster plan doubles its sizes (``smem_bytes``): 7
qubits take 4 blocks (8 from k = 103 'xyz' blocks, 16 from k = 177), 8
qubits 16 (up to k = 101 'xyz' blocks), and a state's one column fits one
block up to 12 qubits, not 13, and 16 blocks up to 16, not 17.

Routing of ``sweep``, by the tensor's device and the objective:
  * CPU tensor, any objective: ``sweep_reference``, the plain version;
  * CUDA tensor, a built-in loss kind with the piecewise-linear penalty
    (or none): the fused sweep kernel, unless no plan of it holds the
    shape and the unitary kernels' plans do (the modulo losses at 9 to 13
    qubits, 9 to 12 in float64; a state at 18 to 24 qubits, 17 to 23 in
    float64), which takes the route below;
  * CUDA tensor, a custom loss (a torch callable of one unitary, which
    cannot enter a fused kernel) or any other penalty (a torch callable
    of the CP angles, such as ops.penalty.cp_penalty_L1): the Adam loop
    of ``sweep_reference`` around the objective, whose unitary comes from
    the hand-written forward and vjp kernels of kernels/unitary.py (never
    from the plain builder: an objective made with ``plain=True`` is
    refused), with target_loss checked every TARGET_CHECK_EVERY steps as
    on the fused route.

What bounds the kernel on this card, and what its design does about it, is
set out at the top of csrc/sweep.cu: per-restart shared memory (the state
and cotangent, 2^n x C each) and the synchronisation of the adjoint walk,
which in no build has a block barrier between two gates. The builds, by
shape (``build_of`` names the one a shape runs):
  * the column build (``column_plan``, ``column_smem_bytes``;
    csrc/columns.cuh's design, as the unitary kernels' column design runs
    it): the whole unitary at 2 to 6 qubits (the HS test, disc and both
    modulo losses), a restart on one warp (four at 5 qubits, eight at 6,
    four in float64, ``sweep_warps``) and 2 restarts a block up to 4
    qubits, each warp's lanes sharing its columns with a warp barrier a
    gate;
  * the one-block build (``block_plan``; csrc/rows.cuh's warps): a restart
    on one block where cluster_plan gives it one (a state up to 13 qubits,
    12 in float64; a whole-unitary template at 2 to 6 qubits too deep for
    the column build, held column-major with whole columns a warp), each
    gate on a warp's own segment of rows, the bits a state's gate needs
    swapped in beforehand as a table says that the wrapper computes once a
    call (kernels/rows.py);
  * the cluster build (``cluster_layout``; csrc/tiles.cuh's warps): the
    whole unitary split by columns over a thread-block cluster of 2, 4, 8
    or 16 blocks, the smallest that fits (``cluster_plan``: in float32 7
    qubits take 2, or 4 from 215 'xyz' blocks, 8 qubits take 8, or 16
    from 214 'xyz' blocks up to 358), each block's columns owned by its
    warps, the gates built once a cluster and shared over distributed
    shared memory;
  * the row tiles (``row_plan``): a state's one column split by rows over
    a cluster, each block holding 2^n / c of them (at the GHZ ladder's
    depths 14, 15, 16 and 17 qubits take 2, 4, 8 and 16 blocks), on
    rows.cuh's warps with swaps across blocks; past 17 qubits (16 in
    float64) ``route`` takes a state to the unitary kernels, whose global
    row tiles keep its column in device memory (kernels/unitary.py);
  * the column tiles (``tile_plan``): where no cluster holds the whole
    unitary (9 qubits and up, and deeper templates at 7 and 8), the HS
    test and disc losses split a restart's columns into tiles on
    independent blocks, the fewest that fit, and two kernels a step, one a
    block per tile (the chain, the tile's share of the sum s and the walk
    from conj(T), each column of the tile run by its own warps,
    csrc/tiles.cuh; ``tile_threads``, ``tile_smem_bytes``) and one a block
    per restart (the shares summed in a fixed order, the gradient, Adam,
    and the next step's gate matrices), which meet through a workspace in
    global memory. Tiles of 16, 8, 4, 2 and 1 columns take a restart to 9,
    10, 11, 12 and 13 qubits in float32 (8, 4, 2 and 1 to 12 in float64).
The modulo losses read V across columns: the fused kernel takes them to 8
qubits, and past that ``route`` sends them to the unitary kernels, whose
plans hold the whole unitary to 13 qubits (12 in float64; ROADMAP A.16b).
A cluster of 16 is non-portable on Hopper: the library allows it on its
cluster builds, and a launch whose cluster the card cannot place raises.
On the card the library's own plan decides (``cpflow_sweep_cluster``);
``smem_bytes`` and ``cluster_plan`` mirror it, and ``block_plan``,
``cluster_layout``, ``row_plan`` and ``column_plan`` the launches, so that
the plans can be checked without a card. Every block of a cluster runs
Adam on the same angles, and the kernel traps if the blocks end a launch
with different bits of the Adam state.

target_loss: the sweep stops once every restart's best loss is at or under
it, as engine.fused_adam_sweep of the JAX package does. The plain loop
checks before every step; the kernel runs in launches of
TARGET_CHECK_EVERY steps with the Adam state kept on the card and is
checked between them, so it may run up to TARGET_CHECK_EVERY - 1 more
steps. Success flags agree; best losses are at most the plain loop's.
"""

from __future__ import annotations

from collections import Counter
import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.kernels import build
from cpflow_tpu_torch.kernels import rows as rk
from cpflow_tpu_torch.kernels.tiles import (  # noqa: F401 (re-exported)
    TILE_RING, TILE_THREADS, tile_smem_bytes, tile_threads)
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.ops.penalty import LinearPenalty, breakpoints
from cpflow_tpu_torch.ops.losses import _shift_indices, wire_permutation
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles

LAUNCHES = 0  # kernel launches since the last reset; the plain path adds none
F64_LAUNCHES = 0  # those of them that ran the double build
# those of them by the blocks each restart ran on (a cluster's size, 1 for
# one block, 'tiles' for the column tiles); reset with .clear()
LAUNCHES_BY_CLUSTER: Counter = Counter()
# those of them by build: 'sweep_columns' (the whole unitary at 2 to 6
# qubits on the column design, column_plan), 'sweep_block' (one block a
# restart on rows.cuh's warps, block_plan), 'sweep_cluster' (the whole
# unitary's columns over a cluster on tiles.cuh's warps, cluster_layout),
# 'sweep_row_tiles' (a state split by rows, row_plan) or
# 'sweep_column_tiles' (columns on independent blocks, tile_plan), '_f64'
# added for the double build; reset with .clear()
LAUNCHES_BY_BUILD: Counter = Counter()
# the builds by the number csrc/sweep.cu's occupancy query gives them (one
# block, the whole unitary on a cluster, a state's rows on a cluster, the
# column design)
BUILD_NAMES = ('sweep_block', 'sweep_cluster', 'sweep_row_tiles',
               'sweep_columns')

DTYPES = (torch.float32, torch.float64)  # the builds: float and double
LOSS_CODES = {'hst': 0, 'state': 1, 'disc': 2, 'modulo_identity': 3,
              'modulo_diagonal': 4}  # as csrc/sweep.cu numbers them
ENTANGLER_CODES = {'cp': 0, 'cz': 1, 'cx': 2}
LETTER_CODES = {'x': 0, 'y': 1, 'z': 2}
TILE_LOSSES = ('hst', 'disc')  # the losses the column tiles take
TARGET_CHECK_EVERY = 50  # kernel steps between host checks of target_loss

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
# dtype -> the bound library of that precision; set an entry to time
# another build of the kernel
_libs: dict = {}


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

def load_library(dtype=torch.float32) -> ctypes.CDLL:
    """Build csrc/sweep.cu for sm_90a in the precision of `dtype` (float32
    or float64; once per version of csrc/) and load it."""
    if dtype not in _libs:
        double = dtype == torch.float64
        _libs[dtype] = bind(build.load(build.name_of('sweep', double)), double)
    return _libs[dtype]


def bind(lib: ctypes.CDLL, double: bool) -> ctypes.CDLL:
    """Sets the argument and result types of the sweep library's functions
    (`double`: its double build). Returns lib."""
    ptr = ctypes.c_void_p
    common = [ptr] * 13 + [ctypes.c_int] * 10 + [
        ctypes.c_double if double else ctypes.c_float]
    lib.cpflow_sweep_launch.argtypes = common + [ptr, ptr, ctypes.c_int]
    lib.cpflow_sweep_launch.restype = ctypes.c_int
    lib.cpflow_sweep_row_plan.argtypes = [ctypes.c_int] * 3 + [ptr]
    lib.cpflow_sweep_row_plan.restype = ctypes.c_int
    lib.cpflow_sweep_block_plan.argtypes = [ctypes.c_int] * 5 + [ptr]
    lib.cpflow_sweep_block_plan.restype = ctypes.c_int
    lib.cpflow_sweep_cluster_layout.argtypes = [ctypes.c_int] * 4 + [ptr]
    lib.cpflow_sweep_cluster_layout.restype = ctypes.c_int
    lib.cpflow_sweep_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.cpflow_sweep_smem_bytes.restype = ctypes.c_longlong
    lib.cpflow_sweep_cluster.argtypes = [ctypes.c_int] * 4
    lib.cpflow_sweep_cluster.restype = ctypes.c_int
    lib.cpflow_sweep_occupancy.argtypes = [ctypes.c_int] * 5 + [ptr]
    lib.cpflow_sweep_occupancy.restype = ctypes.c_int
    lib.cpflow_sweep_column_plan.argtypes = [ctypes.c_int] * 4 + [ptr]
    lib.cpflow_sweep_column_plan.restype = ctypes.c_int
    lib.cpflow_sweep_device.argtypes = [ptr]
    lib.cpflow_sweep_device.restype = ctypes.c_int
    lib.cpflow_sweep_tiles.argtypes = [ctypes.c_int] * 4
    lib.cpflow_sweep_tiles.restype = ctypes.c_int
    lib.cpflow_sweep_tile_workspace.argtypes = [ctypes.c_int] * 5
    lib.cpflow_sweep_tile_workspace.restype = ctypes.c_longlong
    lib.cpflow_sweep_tile_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.cpflow_sweep_tile_smem_bytes.restype = ctypes.c_longlong
    lib.cpflow_sweep_tiles_launch.argtypes = common + [ptr, ptr]
    lib.cpflow_sweep_tiles_launch.restype = ctypes.c_int
    lib.cpflow_sweep_tiles_occupancy.argtypes = [ctypes.c_int] * 4 + [ptr]
    lib.cpflow_sweep_tiles_occupancy.restype = ctypes.c_int
    return lib


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
# blocks a restart may run on; 16 is a non-portable cluster on Hopper
CLUSTERS = (1, 2, 4, 8, 16)
_OUT_OF_RESOURCES = 701  # cudaErrorLaunchOutOfResources
CLUSTER_THREADS = 256  # the cluster build's threads a block at most


def smem_bytes(n: int, num_blocks: int, nba: int, kind: str,
               cluster: int = 1, dtype=torch.float32) -> int:
    """Shared memory of each block of a restart split over `cluster`
    blocks in the layout that decides the plan (``cluster_plan``), as
    csrc/sweep.cu's make_layout lays it out in the build of `dtype` (the
    builds launch with their own layouts, which keep within it:
    ``block_plan``, ``cluster_layout``, ``row_plan``): the tile of A and of
    M (2^n x C / cluster amplitudes
    each: C / cluster columns, or for a state 2^n / cluster rows of its
    one column), the gates and their cotangents, the cross-warp partials, the
    modulo losses' row sums, five arrays of the P angles and the cos and
    sin of each, 16 scalars. Every one of them is of the build's real or
    complex type, so the double build takes twice the float build's."""
    log_c = 0 if kind == 'state' else n
    log_ct = log_c - (cluster.bit_length() - 1)
    P, G = 3 * n + nba * num_blocks, n + num_blocks
    threads = min(max((1 << (n + log_ct)) // 16, 32), 256)
    rows = (8 << n) if kind.startswith('modulo') else 0
    single = (16 << (n + log_ct)) + 256 * G + 8 * threads + rows + 28 * P + 64
    return single * (2 if dtype == torch.float64 else 1)


def cluster_plan(n: int, num_blocks: int, nba: int, kind: str,
                 dtype=torch.float32):
    """The blocks each restart runs on, as csrc/sweep.cu's cluster_plan
    picks them in the build of `dtype`: the smallest of CLUSTERS whose
    per-block layout fits one block's shared memory, no more blocks than
    columns, and for a state, whose one column is split by rows, tiles of
    at least 4 rows. None if none fits."""
    for c in CLUSTERS:
        if c > (1 << (n - 2) if kind == 'state' else 1 << n):
            break
        if smem_bytes(n, num_blocks, nba, kind, c, dtype) <= _SMEM_LIMIT:
            return c
    return None


def tile_plan(n: int, num_blocks: int, nba: int, kind: str,
              dtype=torch.float32):
    """(columns a tile, tiles a restart) of the column tiles, as
    csrc/sweep.cu's tile_plan picks them in the build of `dtype`: the fewest
    tiles whose per-block layout (smem_bytes with that many blocks) fits
    one block's shared memory and whose tile kernel's layout
    (tile_smem_bytes) fits it with a warp for every column (tile_threads);
    the second test never decides today, and keeps the tile kernel from a
    launch that would not fit. None where cluster_plan holds the shape (it
    keeps its plan), for a loss other than TILE_LOSSES, and where even
    tiles of one column do not fit. A tile's A and M take 16 d w bytes
    (32 in float64), so the shallow templates take tiles of 128 KB: in
    float32 16, 8, 4, 2 and 1 columns at 9 to 13 qubits, in float64 8, 4,
    2 and 1 at 9 to 12."""
    if kind not in TILE_LOSSES or \
            cluster_plan(n, num_blocks, nba, kind, dtype) is not None:
        return None
    for j in range(n + 1):
        w = 1 << (n - j)
        if smem_bytes(n, num_blocks, nba, kind, 1 << j, dtype) \
                <= _SMEM_LIMIT and 32 * w <= TILE_THREADS[dtype] and \
                tile_smem_bytes(n, num_blocks, w, dtype) <= _SMEM_LIMIT:
            return w, 1 << j
    return None


def sweep_warps(n: int, dtype=torch.float32) -> int:
    """Warps a restart of the column build at n qubits, as csrc/sweep.cu's
    sweep_warps in the build of `dtype`: one up to 4 qubits, 4 at 5, 8 at
    6 (4 in float64). Their 32 lanes each share the restart's columns,
    32 W / 2^n lanes a column."""
    return 1 if n < 5 else 4 if n == 5 or dtype == torch.float64 else 8


def column_smem_bytes(n: int, num_blocks: int, nba: int, kind: str,
                      restarts: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of a block of `restarts` restarts of the column
    build, as csrc/sweep.cu's column_sweep_layout lays it out in the build
    of `dtype`: csrc/columns.cuh's column_layout of the vjp
    (kernels/unitary.py:column_smem_bytes's formula) with a cotangent slot
    for each of the restart's sweep_warps(n) warps, padded to 16 bytes; then
    per restart the modulo losses' d row sums, the Adam state (both moments
    and the best angles, P each) and 8 values a warp for the sums across its
    warps. All but the G gate codes (int32, once) are of the build's real
    or complex type, twice as large in float64."""
    P, G = 3 * n + nba * num_blocks, n + num_blocks
    warps = sweep_warps(n, dtype)
    scale = 2 if dtype == torch.float64 else 1
    layout = restarts * ((16 << 2 * n) + 128 * G + 128 * warps * G + 16 * P) \
        * scale + 4 * G
    rows = (8 << n) if kind.startswith('modulo') else 0
    return -(-layout // 16) * 16 + restarts * scale * (
        rows + 12 * P + 32 * warps)


def column_plan(n: int, num_blocks: int, nba: int, kind: str,
                dtype=torch.float32):
    """The column build's launch, as csrc/sweep.cu's column_sweep_restarts
    picks it in the build of `dtype` (cpflow_sweep_column_plan on the card):
    dict(restarts, threads, smem_bytes) a block: 2 restarts of one warp up
    to 4 qubits (1 where two do not fit), 1 of sweep_warps(n) warps above,
    whose layout (column_smem_bytes) fits one block. None for a state,
    outside 2 to 6 qubits and where even one restart does not fit: such a
    shape keeps the one-block and cluster builds (cluster_plan)."""
    if kind == 'state' or \
            not uk.COLUMN_QUBITS[0] <= n <= uk.COLUMN_QUBITS[1]:
        return None
    warps = sweep_warps(n, dtype)
    r = 1 if warps > 1 else uk.COLUMN_THREADS // 32
    while r >= 1:
        nbytes = column_smem_bytes(n, num_blocks, nba, kind, r, dtype)
        if nbytes <= _SMEM_LIMIT:
            return dict(restarts=r, threads=32 * warps * r, smem_bytes=nbytes)
        r //= 2
    return None


def row_plan(n: int, num_blocks: int, nba: int, dtype=torch.float32):
    """The row tiles' launch of a state that cluster_plan splits by rows
    over c > 1 blocks, as csrc/sweep.cu's row_layout lays it out in the
    build of `dtype` (cpflow_sweep_row_plan on the card): dict(cluster,
    log_rows, warps, segment, ring, threads, smem_bytes), the plan's layout
    (smem_bytes) with the warps' ring of cotangent slots in place of its
    cross-warp partials, in what the plan leaves of a block's shared memory
    (kernels/rows.py:launch). None where the state is not split by rows."""
    c = cluster_plan(n, num_blocks, nba, 'state', dtype)
    if c is None or c == 1:
        return None
    return rk.launch(c, n - (c.bit_length() - 1),
                     smem_bytes(n, num_blocks, nba, 'state', c, dtype), dtype)


def block_plan(n: int, num_blocks: int, nba: int, kind: str,
               dtype=torch.float32, warps: Optional[int] = None):
    """The one-block build's launch (a restart on one block, cluster_plan's
    1, where the column build does not hold the shape) with at most
    `warps` warps (default: as many as the plan gives), as csrc/sweep.cu's
    block_layout lays it out in the build of `dtype`: dict(cluster,
    log_rows, warps, segment, ring, threads, smem_bytes), csrc/rows.cuh's
    warps on the block's 2^log_rows amplitudes (a state's column, or the
    whole unitary's columns column-major: log_rows 2n, whole columns a
    warp), the plan's layout (smem_bytes) with the warps' ring of cotangent
    slots in place of its cross-warp partials (kernels/rows.py:launch);
    fewer warps own longer segments, with the largest ring that fits. On
    the card the library picks the warps by the batch
    (cpflow_sweep_block_plan: of this plan's warps and every smaller power
    of two, the one that keeps the most of the batch's restarts on the card
    at once, then the most warps). None elsewhere."""
    if column_plan(n, num_blocks, nba, kind, dtype) is not None or \
            cluster_plan(n, num_blocks, nba, kind, dtype) != 1:
        return None
    log_rows = n + (0 if kind == 'state' else n)
    plan_bytes = smem_bytes(n, num_blocks, nba, kind, 1, dtype)
    got = rk.launch(1, log_rows, plan_bytes, dtype)
    if warps is None or got['warps'] <= warps:
        return got
    real = 8 if dtype == torch.float64 else 4
    lw = warps.bit_length() - 1
    rest = got['smem_bytes'] - 32 * got['warps'] * got['ring'] * real
    spare = _SMEM_LIMIT - rest
    ring = rk.RING_MAX
    while ring > 1 and (32 * ring << lw) * real > spare:
        ring //= 2
    return dict(got, warps=1 << lw, segment=log_rows - lw, ring=ring,
                threads=32 << lw, smem_bytes=rest + (32 * ring << lw) * real)


def cluster_layout(n: int, num_blocks: int, nba: int, kind: str,
                   dtype=torch.float32):
    """The cluster build's launch (the whole unitary's columns split over
    the c > 1 blocks cluster_plan picks), as csrc/sweep.cu's cluster_layout
    lays it out in the build of `dtype` (cpflow_sweep_cluster_layout on the
    card): dict(cluster, columns, threads, ring, smem_bytes). A block holds
    w = 2^n / c columns of A and M column-major with a stride of 2^n + 1
    amplitudes, the gates and their cotangents, the warps' ring of
    cotangent slots (32 reals a warp and gate), the modulo losses' row
    sums, five arrays of the P angles, their cos and sin and 16 scalars;
    its threads are tile_threads (kernels/tiles.py), at most
    CLUSTER_THREADS, with the largest ring of 16, 8, 4, 2, 1 gates that
    fits a block, halved while not even a ring of one gate fits. None elsewhere, and where no launch fits (never where
    the plan holds the shape: tests/test_torch_sweep_blocks.py)."""
    if kind == 'state' or column_plan(n, num_blocks, nba, kind,
                                      dtype) is not None:
        return None
    c = cluster_plan(n, num_blocks, nba, kind, dtype)
    if c is None or c == 1:
        return None
    w, d = (1 << n) // c, 1 << n
    P, G = 3 * n + nba * num_blocks, n + num_blocks
    scale = 2 if dtype == torch.float64 else 1
    rows = 8 * d if kind.startswith('modulo') else 0
    threads = min(tile_threads(n, w, dtype), CLUSTER_THREADS)
    while threads >= 32:
        for ring in (16, 8, 4, 2, 1):
            nbytes = scale * (16 * w * (d + 1) + 256 * G +
                              128 * (threads // 32) * ring + rows + 28 * P +
                              64)
            if nbytes <= _SMEM_LIMIT:
                return dict(cluster=c, columns=w, threads=threads, ring=ring,
                            smem_bytes=nbytes)
        threads //= 2
    return None


def build_of(n: int, num_blocks: int, nba: int, kind: str,
             dtype=torch.float32):
    """The LAUNCHES_BY_BUILD name of the build that a launch of the shape
    runs in the build of `dtype` ('_f64' added in float64), as the
    library's plans pick it; None where no plan holds the shape."""
    suffix = '_f64' if dtype == torch.float64 else ''
    if column_plan(n, num_blocks, nba, kind, dtype) is not None:
        return 'sweep_columns' + suffix
    c = cluster_plan(n, num_blocks, nba, kind, dtype)
    if c is None:
        return None if tile_plan(n, num_blocks, nba, kind, dtype) is None \
            else 'sweep_column_tiles' + suffix
    return ('sweep_block' if c == 1 else 'sweep_row_tiles' if
            kind == 'state' else 'sweep_cluster') + suffix


def max_qubits(kind: str, dtype=torch.float32) -> int:
    """The most qubits the kernel takes for a loss of `kind` in the build of
    `dtype`: the largest n whose layout with no blocks a plan holds (the
    HS test and disc on column tiles of one column: 13 in float32, 12 in
    float64; the modulo losses on up to 16 blocks: 8; a state's one column
    split by rows over up to 16 blocks: 17 in float32, 16 in float64,
    whose every amplitude takes twice the bytes). A template deep enough
    may not fit even below that n. MAX_QUBITS['state'] is what the fused
    kernel takes; ``sweep`` takes a wider state to the unitary kernels
    (``route``), whose own limit is kernels/unitary.py's
    MAX_QUBITS[dtype]['column']."""
    n = 2
    while cluster_plan(n + 1, 0, 0, kind, dtype) is not None or \
            tile_plan(n + 1, 0, 0, kind, dtype) is not None:
        n += 1
    return n


# qubits the kernel takes, per build and loss
MAX_QUBITS = {dtype: {kind: max_qubits(kind, dtype) for kind in LOSS_CODES}
              for dtype in DTYPES}


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
    if kind not in LOSS_CODES:
        raise NotImplementedError(
            f'the fused sweep kernel computes the {", ".join(LOSS_CODES)} '
            f'losses, got {kind!r}: a custom loss (a Python callable) cannot '
            f'enter it, and sweep() routes one to the unitary kernels')
    if objective.dtype not in DTYPES:
        raise ValueError(f'the sweep kernel computes in float32 or float64, '
                         f'the objective in {objective.dtype}')
    n, limit = objective.num_qubits, MAX_QUBITS[objective.dtype][kind]
    if not 2 <= n <= limit:
        double = ' (float64 doubles their bytes)' if \
            objective.dtype == torch.float64 else ''
        if kind == 'state':
            cap = uk.MAX_QUBITS[objective.dtype]['column']
            why = (f'the state and cotangent exceed the shared memory of a '
                   f'cluster of {CLUSTERS[-1]} blocks, the largest Hopper '
                   f'launches, even split by rows{double}; sweep() takes it '
                   f'to the unitary kernels, whose global row tiles hold '
                   f'one column to {cap} qubits' + (
                       '' if n <= cap else
                       f', and past that cap (kernels/unitary.py\'s '
                       f'GLOBAL_MAX_QUBITS) no plan holds it'))
        elif kind in TILE_LOSSES:
            why = (f'one column of the state and cotangent exceeds the '
                   f'shared memory of a block, even on column tiles of one '
                   f'column each{double}')
        else:
            why = (f'the state and cotangent exceed the shared memory of a '
                   f'cluster of {CLUSTERS[-1]} blocks, the largest Hopper '
                   f'launches, and the column tiles take no modulo loss, '
                   f'whose sums read V across columns (ROADMAP A.16b); '
                   f'sweep() takes it to the unitary kernels, which hold '
                   f'the whole unitary to '
                   f'{uk.MAX_QUBITS[objective.dtype]["unitary"]} qubits')
        raise ValueError(
            f'the sweep kernel takes 2 to {limit} qubits for a {kind!r} '
            f'loss in {objective.dtype}, got {n}: above {limit} {why}')
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
    if not linear_penalty(objective):
        raise NotImplementedError(
            'the sweep kernel computes the piecewise-linear penalty only; '
            'sweep() routes another penalty to the unitary kernels')


def linear_penalty(objective) -> bool:
    """Whether the objective's penalty is the piecewise-linear one that the
    fused kernel computes (or it has none)."""
    return not objective.has_penalty or \
        isinstance(objective.regularization_func, LinearPenalty)


def _launch(objective, params0, learning_rate, num_iterations, grad_mask,
            target_loss) -> SweepResult:
    """The fused kernel on params0's card. The library sizes, configures
    and launches on the current device (cudaGetDevice), so that device is
    made params0's for the whole launch, whatever the caller's current
    device is."""
    with torch.cuda.device(params0.device):
        return _launch_on_current(objective, params0, learning_rate,
                                  num_iterations, grad_mask, target_loss)


def _launch_on_current(objective, params0, learning_rate, num_iterations,
                       grad_mask, target_loss) -> SweepResult:
    _check_objective(objective)
    device = params0.device
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(f'the sweep kernel is built for sm_90a (Hopper); '
                           f'device has compute capability {major}.{minor}')
    n, spec = objective.num_qubits, objective.unitary_loss_func
    ent, rot = objective.entangling_gate_name, objective.rotation_gates
    dtype = objective.dtype
    placements = all_placements(objective.placements)
    nb = len(placements)
    nba = num_block_angles(ent, rot)
    P = 3 * n + nba * nb
    if params0.dim() != 2 or params0.shape[0] != P:
        raise ValueError(f'params0 must be (P={P}, B), got '
                         f'{tuple(params0.shape)}')
    B = params0.shape[1]
    params0 = params0.to(dtype).contiguous()
    if grad_mask is not None:
        if tuple(grad_mask.shape) != (P, B):
            raise ValueError(f'grad_mask must be ({P}, {B}), got '
                             f'{tuple(grad_mask.shape)}')
        grad_mask = grad_mask.to(device=device, dtype=dtype).contiguous()

    loss = LOSS_CODES[spec.kind]
    lib = load_library(dtype)
    got = (ctypes.c_int * 3)()
    lib.cpflow_sweep_column_plan(n, nb, nba, loss, got)
    columns = got[0]  # restarts a block of the column build, or 0
    cluster = lib.cpflow_sweep_cluster(n, nb, nba, loss)
    tiles = 0 if cluster or columns else lib.cpflow_sweep_tiles(n, nb, nba,
                                                                loss)
    if not cluster and not tiles and not columns:
        most = 1 << n if spec.kind in TILE_LOSSES else CLUSTERS[-1]
        raise ValueError(
            f'{n} qubits with {nb} blocks need '
            f'{lib.cpflow_sweep_smem_bytes(n, nb, nba, loss, most)} bytes of '
            f'shared memory per block in {dtype} even on {most} '
            + ('tiles of one column' if most > CLUSTERS[-1] else 'blocks')
            + f' a restart, above {_SMEM_LIMIT}')

    state = spec.kind == 'state'
    block = cluster == 1 and not columns
    build_name = ('sweep_columns' if columns else 'sweep_column_tiles'
                  if tiles else 'sweep_block' if block else 'sweep_row_tiles'
                  if state else 'sweep_cluster') + (
        '_f64' if dtype == torch.float64 else '')
    target = torch.as_tensor(np.asarray(spec.target),
                             dtype=config.complex_of(dtype))
    if tuple(target.shape) != ((1 << n,) if state else (1 << n, 1 << n)):
        raise ValueError(f'target of shape {tuple(target.shape)} for a '
                         f'{n}-qubit {spec.kind!r} loss')
    target = torch.view_as_real(target.to(device).contiguous())
    if objective.has_penalty:
        cp_mask = torch.as_tensor(objective.cp_mask, dtype=dtype,
                                  device=device)
        xs, ys = breakpoints(*objective.regularization_func.params)
        r = objective.r
    else:  # a zero mask and r = 0: any curve gives no penalty
        cp_mask = torch.zeros(P, device=device, dtype=dtype)
        xs, ys = breakpoints(np.pi / 2, 2.0, .05, .05, .05)
        r = 0.0
    if isinstance(r, torch.Tensor):
        if tuple(r.shape) != (B,):
            raise ValueError(f'r must be a float or of shape ({B},), got '
                             f'{tuple(r.shape)}')
        r = r.to(device=device, dtype=dtype).contiguous()
    else:
        r = torch.full((B,), float(r), dtype=dtype, device=device)
    pen_tab = torch.tensor(xs + ys, dtype=dtype, device=device)
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
    summary = torch.empty((4, B), dtype=dtype, device=device)
    # the column tiles' workspace: each restart's gates, the tiles' shares
    # of each step's cotangents and sum, the segments' sums and counts (0)
    work = torch.zeros(lib.cpflow_sweep_tile_workspace(n, nb, nba, loss, B),
                       dtype=dtype, device=device) if tiles else None
    # the row schedule of a launch on rows.cuh's warps (one block, or a
    # state split by rows), for the segment of the library's plan (the
    # whole unitary's holds whole columns: its table is segment n's, with
    # no swap)
    ops = None
    if block or (state and cluster > 1):
        got = (ctypes.c_int * 6)()
        err = lib.cpflow_sweep_block_plan(n, nb, nba, loss, B, got) \
            if block else lib.cpflow_sweep_row_plan(n, nb, nba, got)
        if err != 0:
            raise RuntimeError(f'sweep kernel row plan query failed: CUDA '
                               f'error {err}')
        ops = rk.device_schedule(n, tuple(map(tuple, placements)),
                                 min(got[3], n), device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch(it_begin, it_end):
        global LAUNCHES, F64_LAUNCHES
        args = (params.data_ptr(), mom1.data_ptr(), mom2.data_ptr(),
                best_params.data_ptr(), summary.data_ptr(), target.data_ptr(),
                cp_mask.data_ptr(),
                grad_mask.data_ptr() if grad_mask is not None else None,
                plc.data_ptr(), pen_tab.data_ptr(), r.data_ptr(),
                letters.data_ptr(), wire_map.data_ptr(), n, nb, len(rot),
                ENTANGLER_CODES[ent], nba, loss, block_log2, B, it_begin,
                it_end, float(learning_rate))
        if tiles:
            err = lib.cpflow_sweep_tiles_launch(*args, work.data_ptr(),
                                                stream)
        else:
            err = lib.cpflow_sweep_launch(
                *args, stream, ops.data_ptr() if ops is not None else None,
                len(ops) if ops is not None else 0)
        if err != 0:
            raise RuntimeError(
                f'sweep kernel launch failed: CUDA error {err} ({B} restarts '
                + (f'on {tiles} column tiles each)' if tiles else
                   f'{columns} a block on the column build)' if columns else
                   f'on {cluster} blocks each)') + (
                    f': the card places no cluster of {cluster} blocks of '
                    f'{lib.cpflow_sweep_smem_bytes(n, nb, nba, loss, cluster)}'
                    f' shared bytes each' if err == _OUT_OF_RESOURCES
                    and not tiles and not columns else ''))
        LAUNCHES += 1
        F64_LAUNCHES += dtype == torch.float64
        LAUNCHES_BY_CLUSTER['tiles' if tiles else 1 if columns else
                            cluster] += 1
        LAUNCHES_BY_BUILD[build_name] += 1

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


def occupancy(objective, batch: int, device=None) -> dict:
    """What the kernel build that a sweep of `batch` restarts of
    `objective` launches on `device` (default: the current CUDA device)
    takes of one SM, from the CUDA runtime: registers
    and local memory bytes (stack and spills) per thread, threads and
    shared memory bytes per block, resident blocks and warps per SM, the
    blocks a
    restart runs on (`cluster`) and the clusters of that many blocks the
    card holds at once (cudaOccupancyMaxActiveClusters; a lone block counts
    as a cluster of one), the restarts a block (`restarts_per_block`: more
    than one on the column build) and the `build` that runs (a
    LAUNCHES_BY_BUILD name). On the column tiles (no cluster: `cluster` 1)
    the numbers are the tile kernel's, `active_clusters` its blocks resident
    on the card, and `tiles`, `columns`, `adam_registers` and
    `adam_local_bytes` are added (the second kernel's registers and local
    bytes)."""
    _check_objective(objective)
    n, spec = objective.num_qubits, objective.unitary_loss_func
    nb = len(all_placements(objective.placements))
    nba = num_block_angles(objective.entangling_gate_name,
                           objective.rotation_gates)
    lib, loss = load_library(objective.dtype), LOSS_CODES[spec.kind]
    with torch.cuda.device(device):
        plan = (ctypes.c_int * 3)()
        lib.cpflow_sweep_column_plan(n, nb, nba, loss, plan)
        tiles = not plan[0] and not lib.cpflow_sweep_cluster(
            n, nb, nba, loss) and lib.cpflow_sweep_tiles(n, nb, nba, loss)
        out = (ctypes.c_int * 9)()
        if tiles:
            err = lib.cpflow_sweep_tiles_occupancy(n, nb, nba, loss, out)
        else:
            err = lib.cpflow_sweep_occupancy(n, nb, nba, loss, int(batch),
                                             out)
    if err != 0:
        raise RuntimeError(f'sweep kernel occupancy query failed: CUDA error '
                           f'{err}')
    got = dict(zip(('registers', 'local_bytes', 'threads', 'smem_bytes',
                    'blocks_per_sm', 'cluster', 'active_clusters'), out))
    got['warps_per_sm'] = got['blocks_per_sm'] * got['threads'] // 32
    suffix = '_f64' if objective.dtype == torch.float64 else ''
    if tiles:
        got.update(cluster=1, tiles=out[5], columns=(1 << n) // out[5],
                   adam_registers=out[7], adam_local_bytes=out[8],
                   restarts_per_block=1, build='sweep_column_tiles' + suffix)
    else:
        got.update(build=BUILD_NAMES[out[7]] + suffix,
                   restarts_per_block=out[8])
    return got


def library_device(device) -> int:
    """The device index the kernel library's CUDA runtime calls current
    (cudaGetDevice) under the guard the wrappers launch under: `device`'s,
    if the library shares PyTorch's primary context."""
    out = ctypes.c_int(-1)
    with torch.cuda.device(device):
        err = load_library().cpflow_sweep_device(ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f'cudaGetDevice failed in the sweep library: CUDA '
                           f'error {err}')
    return out.value


def route(objective, device) -> str:
    """Where ``sweep`` takes the objective on a tensor of `device`, as the
    module docstring says: 'plain' (a CPU tensor: sweep_reference), 'fused'
    (the fused kernel) or 'unitary' (the Adam loop of sweep_reference over
    the unitary kernels, for a custom loss or penalty, and for a built-in
    loss that only the unitary kernels' plans hold). Raises for a device
    other than the CPU and the card, and for a plain objective that would
    need the unitary kernels."""
    kind = torch.device(device).type
    if kind == 'cpu':
        return 'plain'
    if kind != 'cuda':
        raise ValueError(f'no sweep for device {device}')
    loss = getattr(objective.unitary_loss_func, 'kind', 'custom')
    what = 'a custom loss or penalty'
    if loss != 'custom' and linear_penalty(objective):
        if not _unitary_only(objective):
            return 'fused'  # the fused kernel, or its refusal
        what = (f'a {loss!r} loss at {objective.num_qubits} qubits, which no '
                f'plan of the fused kernel holds,')
    if objective.plain:
        raise ValueError(f'{what} on the card goes through the unitary '
                         f'kernels; this objective was made with plain=True')
    return 'unitary'


def _unitary_only(objective) -> bool:
    """Whether a built-in loss with the piecewise-linear penalty is held by
    the unitary kernels' plans (forward pass and vjp) and by no plan of the
    fused kernel (cluster_plan, tile_plan): the modulo losses past 8 qubits
    (to 13 in float32, 12 in float64), which the column tiles cannot take
    because their sums read V across columns, and a state past 17 qubits
    (16 in float64) to the global row tiles' cap (24, 23)."""
    dtype, n = objective.dtype, objective.num_qubits
    ent, rot = objective.entangling_gate_name, objective.rotation_gates
    if dtype not in DTYPES or ent not in ENTANGLER_CODES or \
            set(rot) - set(LETTER_CODES):
        return False
    kind = objective.unitary_loss_func.kind
    nb = len(all_placements(objective.placements))
    nba = num_block_angles(ent, rot)
    if column_plan(n, nb, nba, kind, dtype) is not None or \
            cluster_plan(n, nb, nba, kind, dtype) is not None or \
            tile_plan(n, nb, nba, kind, dtype) is not None:
        return False
    log_c = 0 if kind == 'state' else n
    return all(uk.plan(n, nb, nba, log_c, vjp, dtype) is not None
               for vjp in (False, True))


def sweep(objective, params0: torch.Tensor, learning_rate: float = 0.1,
          num_iterations: int = 5000, grad_mask: Optional[torch.Tensor] = None,
          target_loss: Optional[float] = None) -> SweepResult:
    """The multi-start Adam sweep of `objective` (a
    sim.batched.BatchedRegloss) from params0 (P, B), routed by ``route``:
    the plain version for a CPU tensor; for a CUDA tensor the fused kernel
    (a built-in loss and the piecewise-linear penalty) or the Adam loop over
    the unitary kernels (a custom loss or penalty). Returns a
    SweepResult."""
    how = route(objective, params0.device)
    if how == 'fused':
        return _launch(objective, params0, learning_rate, num_iterations,
                       grad_mask, target_loss)
    if how == 'unitary':
        if grad_mask is not None:
            grad_mask = grad_mask.to(device=params0.device,
                                     dtype=objective.dtype)
        return sweep_reference(objective, params0, learning_rate,
                               num_iterations, grad_mask, target_loss,
                               check_every=TARGET_CHECK_EVERY)
    return sweep_reference(objective, params0, learning_rate, num_iterations,
                           grad_mask, target_loss)

"""The ansatz as a differentiable function of its angles on the card: two
hand-written Hopper kernels under one ``torch.autograd.Function``.

No TPU kernel stands behind them. They replace
cpflow_tpu/sim/batched.py:make_reversible_builder, the ``jax.custom_vjp``
whose backward rewinds the state by unitarity, which XLA fused on the TPU.
Everything that is not Adam on a built-in loss needs the ansatz in this
form: a loss given as a Python callable, a history of the optimization, the
other first-order methods.

  * ``ansatz_forward``: angles (P, B) -> U (B, d, C), C = 2^n columns
    (``columns=None``) or the |0...0> column alone (``columns=[0]``),
    complex64 from float32 angles and complex128 from float64 ones;
  * ``ansatz_vjp``: angles, that U and its cotangent -> dL/dangles (P, B),
    by the adjoint walk of the sweep kernel: nothing is stored between the
    two but U itself;
  * ``AnsatzUnitary``: the autograd.Function over the pair;
  * ``build_unitary``: the entry point. On a CUDA tensor it goes through
    ``AnsatzUnitary`` or raises (float32 or float64, sm_90 only, 2 to 13
    qubits for the whole unitary in float32 and 2 to 12 in float64, and
    for one column 2 to 24 in float32, 2 to 23 in float64:
    ``MAX_QUBITS``, past 17 and 16 on the global row tiles); it never falls
    back. On a CPU
    tensor it is the plain version, sim.batched.build_unitary_batched under
    ordinary autograd.

Both kernels are csrc/unitary.cu (built with nvcc for sm_90a at first use,
bound with ctypes); they share their gate algebra with the sweep kernel
through csrc/gates.cuh. The source builds twice (kernels/build.py): in
float for float32 angles and in double (-DCPFLOW_DOUBLE) for float64 ones,
each tensor launching the build of its own dtype and never the other. The
double build's tiles take twice the shared memory, so every size below
takes a dtype; the vjp of the whole unitary at 8 qubits takes 16 blocks a
restart in double (up to k = 125 'xyz' blocks), a non-portable cluster on
Hopper that the library allows on its cluster kernels; a launch whose
cluster the card cannot place raises.

What bounds them, and the two designs. The paths that launch them hand
over 5 to 800 restarts at 3 and 4 qubits, so the whole batch is resident at
once and a launch lasts as long as one restart's work, its prologue (the
cos and sin of its angles, its gate matrices) and its chain of n + k
dependent gates: latency, not the float32 rate and not device memory.
Every gate acts on row bits only, so in the column design (the whole
unitary at 2 to 6 qubits, csrc/columns.cuh) a lane owns one column of a
restart in the walk, which runs with no barrier and sums each gate's
cotangent over the restart's lanes by shuffles; a restart takes a warp
(two at 6 qubits), whose spare lanes share the prologue, and in the
forward pass at 2 to 4 qubits the lanes of a column share its amplitude
groups with a warp barrier after each gate. Blocks hold two restarts (one
at 6 qubits, or where the layout does not fit). One column
(``columns=[0]``, up to 17 qubits, 16 in float64) and the vjp of the
whole unitary at 7
and 8 qubits keep the row-split design's plan: one block a restart
(``ansatz_forward`` and ``ansatz_vjp``, on csrc/rows.cuh's warps,
``rows_launch``: one column, every bit a gate needs swapped in inside the
block; templates below 7 qubits too deep for the column design, the whole
unitary's columns column-major with whole columns a warp, the forward pass
on each of the plan's blocks), and where its layout exceeds one block's
shared memory the restart splits over c = 2, 4, 8 or 16 blocks
(``cluster_plan``): the whole unitary's columns, the vjp's blocks a
thread-block cluster on csrc/tiles.cuh's warps (``ansatz_vjp_cluster``:
each warp owns columns, no block barrier between gates, the gates built
once a cluster, the gates' cotangents summed over distributed shared
memory in rank order), or one column's rows, 2^n / c a block, in both
passes as a cluster (the row tiles' kernels, ``ansatz_forward_row_tiles``
and ``ansatz_vjp_row_tiles``, whose rows are owned by warps that swap in
the bits a gate needs as the wrapper's table for the pass's segment says:
kernels/rows.py, ``row_plan``). One column past what a cluster holds
(18 to 24 qubits in float32, 17 to 23 in float64; design 'global_rows',
``global_plan``) stays in device memory in natural order and runs a
launch a pass, every tile of 2^log_rows rows on a block of its own under
a permutation of its own, a gate that needs a bit outside the tile ending
the pass (kernels/rows.py:global_schedule, the blocks alone: the surface
round is a product state, which the forward pass writes and against which
the vjp's last pass contracts M; the copies by the pass's tables,
global_maps): ``ansatz_global_gates`` builds each restart's gates once a
call into a workspace, from which each block brings in its pass's by one
bulk copy; ``ansatz_forward_global_rows`` runs in place on U,
``ansatz_vjp_global_rows`` on A and M in the workspace, each tile's shares
of its pass's cotangents summed in a fixed order by
``ansatz_vjp_global_sum``; two blocks of a pass share an SM, on tiles half
as large, where that costs the template no pass (``global_per_sm``).
Before a call allocates U or that workspace it raises ValueError where the
card lacks the bytes. The forward pass of the
whole unitary from 7 qubits runs on the column tiles (``tile_plan``, design 'tiles',
``ansatz_forward_column_tiles``): a restart's columns split into tiles on
independent blocks, the fewest whose layout on tiles.cuh's warps fits,
each tile never meeting another. Where no cluster holds the vjp (9 qubits
and up, and 8 qubits in float64 past k = 125 'xyz' blocks) the column
tiles take it too: the vjp (``ansatz_vjp_column_tiles``) is three
kernels on csrc/tiles.cuh's design: a prologue that builds each
restart's gates once into a workspace, the tiles' walk, each column owned
by warps, leaving each tile's share of the gates' cotangents there, and a
last kernel that sums the shares in a fixed order and forms the angle
gradients (kernels/tiles.py mirrors their layouts). No tensor
cores: the products are 2x2 and 4x4 complex, far below a wgmma tile, and
TF32 would break the 2e-5 agreement with the plain version; no cluster
for the whole unitary below 7 qubits, where a restart fits one block. The
reasons and measurements are at the top of csrc/unitary.cu
and csrc/columns.cuh. ``plan`` mirrors the library's choice
(``cpflow_unitary_design`` and its sizes) for checks without a card; the
wrappers always launch the plan's design, and a caller may ask for the
row-split one (``design='rows'``) to compare the two where it takes the
shape (not the forward pass of the whole unitary from 7 qubits).

The cotangent convention. PyTorch hands a backward the gradient of a real L
with respect to a complex tensor as dL/dRe + i dL/dIm. The kernels' walk
takes the holomorphic partial M = dL/dU (an angle's gradient is
2 Re sum Gbar * dG/dtheta); the two are related by g = conj(2 M), and the
vjp kernel converts as it loads.

Layout. U is (B, d, C) in memory, one contiguous row-major d x C matrix
per restart (the column design copies a restart's slab 16 bytes a lane);
``build_unitary`` hands it on as the batch-last view (2,)*n + (C, B) of the
plain path, and the backward takes a cotangent of any strides.
"""

from __future__ import annotations

from collections import Counter
import ctypes
import functools

import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.kernels import build
from cpflow_tpu_torch.kernels import rows as rk
from cpflow_tpu_torch.kernels import tiles as tk
from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
from cpflow_tpu_torch.sim.batched import build_unitary_batched

FORWARD_LAUNCHES = 0  # launches of the forward kernel since the last reset
VJP_LAUNCHES = 0      # launches of the vjp kernel; the plain path adds none
COLUMN_LAUNCHES = 0   # those of the two that ran the column design
FORWARD_F64_LAUNCHES = 0  # those of the forward kernel in the double build
VJP_F64_LAUNCHES = 0      # those of the vjp kernel in the double build
# the vjp kernel's launches by the blocks each restart ran on (a cluster's
# size, 1 for one block or the column design, 'tiles' for the column
# tiles, 'global_rows' for the global row tiles); reset with .clear()
VJP_LAUNCHES_BY_CLUSTER: Counter = Counter()
# launches of both kernels by the kernel of KERNELS that ran, '_f64' added
# for the double build; reset with .clear()
LAUNCHES_BY_KERNEL: Counter = Counter()
# the global row tiles' kernel launches, a pass each, the vjp's sum and the
# prologue (ansatz_global_gates) once a call, by the kernel of KERNELS
# ('_f64' added for the double build); a wrapper call counts once in
# LAUNCHES_BY_KERNEL; reset with .clear()
GLOBAL_PASSES: Counter = Counter()

ENTANGLER_CODES = {'cp': 0, 'cz': 1, 'cx': 2}
LETTER_CODES = {'x': 0, 'y': 1, 'z': 2}
_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
# blocks a restart may run on; 16 is a non-portable cluster on Hopper
CLUSTERS = (1, 2, 4, 8, 16)
_OUT_OF_RESOURCES = 701  # cudaErrorLaunchOutOfResources
# csrc/unitary.cu's numbering
DESIGNS = {'rows': 0, 'columns': 1, 'tiles': 2, 'global_rows': 3}
# the designs a caller may ask for in place of the plan's, for comparisons;
# the global row tiles run only where the plan puts them
CALLER_DESIGNS = ('rows', 'columns', 'tiles')
DTYPES = (torch.float32, torch.float64)  # the builds: float and double
COLUMN_THREADS = 64      # threads of a column kernel's block
COLUMN_QUBITS = (2, 6)   # the column design's range of qubits
# csrc/unitary.cu's kernels, in kernel_of's order
KERNELS = ('ansatz_forward', 'ansatz_vjp', 'ansatz_vjp_cluster') + tuple(
    f'ansatz_{k}_columns_{n}q' for k in ('forward', 'vjp')
    for n in range(COLUMN_QUBITS[0], COLUMN_QUBITS[1] + 1)) + (
    'ansatz_forward_column_tiles', 'ansatz_vjp_column_tiles',
    'ansatz_vjp_tile_sum', 'ansatz_forward_row_tiles', 'ansatz_vjp_row_tiles',
    'ansatz_vjp_tile_gates', 'ansatz_forward_global_rows',
    'ansatz_vjp_global_rows', 'ansatz_vjp_global_sum', 'ansatz_global_gates')
# csrc/unitary.cu's global row tiles (one column past what a cluster
# holds): the widest column they take, by build (a column of 2^24 complex64
# or 2^23 complex128 amplitudes is 128 MiB, and the vjp holds four of them
# a restart, U, Ubar and its A and M: 512 MiB; it is the widest that
# chip_smoke.py holds against the plain version on the card); log2 of the
# fewest rows of a tile; the bytes of a pass's copy tables in a block (the
# first 1024 ints of kernels/rows.py's MAP_INTS) and its mbarrier; the
# shared memory a block may use where one or two blocks of a pass share an
# SM (two: half the SM's 233,472 bytes, less the 1,024 the runtime keeps
# for each block)
GLOBAL_MAX_QUBITS = {torch.float32: 24, torch.float64: 23}
GLOBAL_ROWS_MIN = 10
GLOBAL_MAP_BYTES = 4096 + 16
GLOBAL_SMEM = {1: _SMEM_LIMIT, 2: 115712}


def _scale(dtype) -> int:
    """The bytes of the build's real type over float32's: 1 or 2."""
    return 2 if dtype == torch.float64 else 1


def smem_bytes(n: int, num_blocks: int, nba: int, log_c: int, vjp: bool,
               cluster: int = 1, dtype=torch.float32) -> int:
    """Dynamic shared memory of each block of a restart split over
    `cluster` blocks in the row-split design, as csrc/unitary.cu's
    make_layout lays it out in the build of `dtype`: the tile of A (2^n x
    2^log_c / cluster amplitudes: 2^log_c / cluster columns, or for one
    column 2^n / cluster rows), the gates, the angles and the cos and sin
    of each; the vjp also the tile of M, the gates' cotangents, the
    cross-warp partials and the gradient. All of the build's real or
    complex type: the double build takes twice the float build's."""
    log_ct = log_c - (cluster.bit_length() - 1)
    P, G = 3 * n + nba * num_blocks, n + num_blocks
    threads = min(max((1 << (n + log_ct)) // 16, 32), 256)
    out = (8 << (n + log_ct)) + 128 * G + 12 * P
    if vjp:
        out += (8 << (n + log_ct)) + 128 * G + 8 * threads + 4 * P
    return out * _scale(dtype)


def cluster_plan(n: int, num_blocks: int, nba: int, log_c: int,
                 vjp: bool, dtype=torch.float32):
    """The blocks each restart is split over in the row-split design, as
    csrc/unitary.cu's cluster_plan picks them in the build of `dtype`: the
    smallest of CLUSTERS whose per-block layout fits one block's shared
    memory, never more than the 2^log_c columns, or for one column
    (log_c = 0) split by rows, never tiles of fewer than 4 rows; None if
    none fits."""
    for c in CLUSTERS:
        if c > (1 << log_c if log_c else 1 << (n - 2)):
            break
        if smem_bytes(n, num_blocks, nba, log_c, vjp, c,
                      dtype) <= _SMEM_LIMIT:
            return c
    return None


def forward_tiles(n: int, num_blocks: int, nba: int, dtype=torch.float32):
    """(columns a tile, tiles a restart) of the forward pass of the whole
    unitary on the column tiles, as csrc/unitary.cu's forward_tile_log
    picks them in the build of `dtype`: the fewest tiles whose layout on
    tiles.cuh's warps (kernels/tiles.py:warp_smem_bytes: A alone, padded
    by a row a column) fits one block; None if none does."""
    for j in range(n + 1):
        w = 1 << (n - j)
        if tk.warp_smem_bytes(n, num_blocks, nba, w, False, 0,
                              dtype) <= _SMEM_LIMIT:
            return w, 1 << j
    return None


def forward_on_tiles(n: int, num_blocks: int, nba: int, log_c: int,
                     dtype=torch.float32) -> bool:
    """Whether the forward pass runs on the column tiles, as csrc/
    unitary.cu's forward_on_tiles decides: the whole unitary from 7 qubits
    (and below where no split of the row-split design holds it)."""
    return log_c == n and (n >= 7 or cluster_plan(
        n, num_blocks, nba, log_c, False, dtype) is None) and \
        forward_tiles(n, num_blocks, nba, dtype) is not None


def tile_plan(n: int, num_blocks: int, nba: int, log_c: int, vjp: bool,
              dtype=torch.float32):
    """(columns a tile, tiles a restart) where the plan takes the column
    tiles, as csrc/unitary.cu picks them in the build of `dtype`; None
    elsewhere. The forward pass: the whole unitary from 7 qubits
    (forward_on_tiles), on forward_tiles. The vjp (tile_log): the whole
    unitary (log_c = n) that no cluster of up to 16 blocks holds
    (cluster_plan), split into the fewest tiles whose per-block layout
    fits one block. The vjp's tile holds A and M (16 d w bytes, 32 in
    float64), the forward pass's A alone: at k = 10 'xyz' the vjp takes
    tiles of 16, 8, 4, 2 and 1 columns at 9 to 13 qubits in float32 (8, 4,
    2, 1 at 9 to 12 in float64), the forward pass twice as wide. The vjp's
    tiles must also hold its tile kernel's own layout
    (kernels/tiles.py:tile_smem_bytes) with a warp for every column; that
    test never decides at the shapes the tests walk, so the vjp keeps the
    tiles of the first tile kernels."""
    if not vjp:
        return forward_tiles(n, num_blocks, nba, dtype) if forward_on_tiles(
            n, num_blocks, nba, log_c, dtype) else None
    if log_c != n or cluster_plan(n, num_blocks, nba, log_c, vjp,
                                  dtype) is not None:
        return None
    for j in range(n + 1):
        w = 1 << (n - j)
        if smem_bytes(n, num_blocks, nba, log_c, vjp, 1 << j,
                      dtype) <= _SMEM_LIMIT and (
                          32 * w <= tk.TILE_THREADS[dtype] and
                          tk.tile_smem_bytes(n, num_blocks, w, dtype)
                          <= _SMEM_LIMIT):
            return w, 1 << j
    return None


def rows_launch(n: int, num_blocks: int, nba: int, log_c: int, vjp: bool,
                dtype=torch.float32):
    """The launch on csrc/rows.cuh's warps of a pass in the row-split
    design, on the c blocks cluster_plan gives it, as csrc/unitary.cu's
    row_layout (forward_row_layout) lays it out in the build of `dtype`
    (cpflow_unitary_row_plan on the card): one column (log_c = 0) on one
    block or split by rows over a cluster, the whole unitary (log_c = n)
    below 7 qubits, its vjp on one block and its forward pass on each of
    the plan's blocks (2^log_rows = 2^(n + log_c) / c amplitudes a block,
    whole columns a warp). dict(cluster, log_rows, warps, segment, ring,
    threads, smem_bytes): the vjp's, the plan's layout with the warps' ring
    of cotangent slots in place of its cross-warp partials, in what the
    plan leaves of a block's shared memory; the forward pass's, the plan's
    layout with the warps and no ring (kernels/rows.py:launch). None where
    the pass does not run on rows.cuh's warps."""
    if log_c and not vjp and forward_on_tiles(n, num_blocks, nba, log_c,
                                              dtype):
        return None
    c = cluster_plan(n, num_blocks, nba, log_c, vjp, dtype)
    if c is None or (log_c and vjp and c > 1):
        return None
    return rk.launch(c, n + log_c - (c.bit_length() - 1),
                     smem_bytes(n, num_blocks, nba, log_c, vjp, c, dtype),
                     dtype, vjp)


def row_plan(n: int, num_blocks: int, nba: int, dtype=torch.float32,
             vjp: bool = True):
    """The row tiles' launch of the vjp (or with vjp=False the forward
    pass) of one column that cluster_plan splits by rows over c > 1 blocks
    for that pass (``rows_launch``); None where the column is not split by
    rows."""
    got = rows_launch(n, num_blocks, nba, 0, vjp, dtype)
    return got if got is not None and got['cluster'] > 1 else None


def max_qubits(whole: bool, dtype=torch.float32) -> int:
    """The most qubits both kernels take for the whole unitary (whole=True)
    or one column in the build of `dtype`: the largest n whose vjp layout
    with no blocks a plan holds (the whole unitary on column tiles of one
    column: 13 in float32, 12 in float64; one column on the global row
    tiles up to their cap, GLOBAL_MAX_QUBITS: 24 in float32, 23 in
    float64). A template deep enough may not fit even below that n."""
    n = 2
    while cluster_plan(n + 1, 0, 0, n + 1 if whole else 0, True,
                       dtype) is not None or \
            (whole and tile_plan(n + 1, 0, 0, n + 1, True, dtype)) or \
            (not whole and global_plan(n + 1, 0, 0, True, dtype)):
        n += 1
    return n


def row_tiles_max(dtype=torch.float32) -> int:
    """The most qubits of one column that a cluster of the row tiles holds
    with no blocks (csrc/unitary.cu's row_tiles_max): 17 in float32, 16 in
    float64."""
    n = 2
    while cluster_plan(n + 1, 0, 0, 0, True, dtype) is not None:
        n += 1
    return n


def global_layout(n: int, num_blocks: int, j: int, vjp: bool, per_sm: int,
                  dtype=torch.float32) -> dict:
    """A block of a pass of the global row tiles on 2^(n - j) rows with
    `per_sm` blocks an SM (csrc/unitary.cu's global_layout): a warp for
    every 2^7 rows up to kernels/rows.py's THREADS over per_sm threads;
    shared memory for A (and the vjp's M), the G gates (and the vjp's
    gbar, 32 reals a gate), the pass's copy tables and mbarrier, and the
    vjp's ring of cotangent slots, the most
    gates of 16, 8, ... 1 that GLOBAL_SMEM[per_sm] holds. dict(log_rows,
    warps, segment, ring, threads, smem_bytes)."""
    real = 4 * _scale(dtype)
    log_rows = n - j
    cap = rk.THREADS[dtype] // per_sm
    lw = 0
    while lw < log_rows - rk.SEGMENT_MIN and 64 << lw <= cap:
        lw += 1
    warps = 1 << lw
    nbytes = ((2 if vjp else 1) * 2 * real << log_rows) + \
        (2 if vjp else 1) * (n + num_blocks) * 32 * real + GLOBAL_MAP_BYTES
    ring = 0
    if vjp:
        ring = rk.RING_MAX
        while ring > 1 and nbytes + 32 * warps * ring * real > \
                GLOBAL_SMEM[per_sm]:
            ring //= 2
        nbytes += 32 * warps * ring * real
    return dict(log_rows=log_rows, warps=warps, segment=log_rows - lw,
                ring=ring, threads=32 * warps, smem_bytes=nbytes)


def global_log(n: int, num_blocks: int, nba: int, vjp: bool,
               dtype=torch.float32, per_sm: int = 1):
    """log2 of the tiles a restart of one column takes on the global row
    tiles with `per_sm` blocks an SM, as csrc/unitary.cu's global_log picks
    it in the build of `dtype`: past the row tiles' widest column
    (row_tiles_max) up to GLOBAL_MAX_QUBITS, where no cluster holds the
    pass, the fewest tiles whose global_layout fits GLOBAL_SMEM[per_sm],
    tiles of at least 2^GLOBAL_ROWS_MIN rows; None elsewhere."""
    if not row_tiles_max(dtype) < n <= GLOBAL_MAX_QUBITS[dtype] or \
            cluster_plan(n, num_blocks, nba, 0, vjp, dtype) is not None:
        return None
    for j in range(1, n - GLOBAL_ROWS_MIN + 1):
        if global_layout(n, num_blocks, j, vjp, per_sm, dtype)[
                'smem_bytes'] <= GLOBAL_SMEM[per_sm]:
            return j
    return None


def global_plan(n: int, num_blocks: int, nba: int, vjp: bool,
                dtype=torch.float32, per_sm=None):
    """The launch of a pass of the global row tiles with `per_sm` blocks
    an SM (csrc/unitary.cu's global_layout; cpflow_unitary_global_plan on
    the card; per_sm None: two where a tile fits so, else one):
    global_layout at global_log's tiles, dict(tiles (a restart), per_sm,
    log_rows, warps, segment, ring, threads, smem_bytes, sum_smem_bytes (the
    vjp's sum kernel), gates_smem_bytes (the gates' prologue)); None where
    global_log takes no j."""
    if per_sm is None:
        return global_plan(n, num_blocks, nba, vjp, dtype, 2) or \
            global_plan(n, num_blocks, nba, vjp, dtype, 1)
    j = global_log(n, num_blocks, nba, vjp, dtype, per_sm)
    if j is None:
        return None
    got = global_layout(n, num_blocks, j, vjp, per_sm, dtype)
    P, G = 3 * n + nba * num_blocks, n + num_blocks
    got.update(tiles=1 << j, per_sm=per_sm,
               sum_smem_bytes=(64 + 4 * P) * _scale(dtype) * 4,
               gates_smem_bytes=(64 * G + 4 * P) * _scale(dtype) * 4)
    return got


def global_work(n: int, num_blocks: int, nba: int, vjp: bool,
                dtype=torch.float32, per_sm=None):
    """The reals of a call's workspace a restart on the global row tiles
    (csrc/unitary.cu's global_work): in the vjp A and M, 2^n complex each,
    then each tile's share of every gate's cotangent, 32 reals a gate;
    then the gates (32 reals each) and the cos and sin of the angles that
    the prologue builds; a multiple of 4 reals. None where global_plan
    takes no plan."""
    p = global_plan(n, num_blocks, nba, vjp, dtype, per_sm)
    if p is None:
        return None
    G, P = n + num_blocks, 3 * n + nba * num_blocks
    used = ((4 << n) + 32 * G * p['tiles'] if vjp else 0) + 32 * G + 2 * P
    return (used + 3) // 4 * 4


def global_per_sm(n: int, placements, nba: int, vjp: bool,
                  dtype=torch.float32):
    """Blocks of a pass an SM for this template (the wrapper's choice,
    which the library takes as given): two, on tiles half as large so that
    one block's copies overlap the other's walk, where they make no more
    passes (kernels/rows.py:global_schedule) than one block an SM; else
    one. None where neither holds the shape."""
    placements = tuple(tuple(int(q) for q in p) for p in placements)
    passes = {}
    for per_sm in (2, 1):
        p = global_plan(n, len(placements), nba, vjp, dtype, per_sm)
        if p is not None:
            passes[per_sm] = len(rk.global_schedule(
                n, placements, p['segment'], p['log_rows'],
                rk.sector_bits(dtype))[2])
    if not passes:
        return None
    return 2 if passes.get(2, 1 << 30) <= passes.get(1, 1 << 30) else 1


# qubits the kernels take, per build, for the whole unitary ('unitary')
# and for one column ('column')
MAX_QUBITS = {dtype: {'unitary': max_qubits(True, dtype),
                      'column': max_qubits(False, dtype)}
              for dtype in (torch.float32, torch.float64)}


def column_lanes(n: int) -> int:
    """Lanes of one restart in the column design: a warp up to 5 qubits,
    the 64 columns at 6 (csrc/columns.cuh's column_lanes)."""
    return 32 if n < 5 else 1 << n


def column_smem_bytes(n: int, num_blocks: int, nba: int, vjp: bool,
                      restarts: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of a block of `restarts` restarts in the column
    design, as csrc/columns.cuh's column_layout lays it out in the build of
    `dtype`: per restart its d x d state A, its G gate matrices, its P
    angles and the cos and sin of each; the vjp also the state's cotangent
    M, each gate's 32-value cotangent once per warp of the restart, and the
    gradient; and the G gate codes (int32), once. All but the codes are of
    the build's real or complex type, twice as large in double."""
    P, G = 3 * n + nba * num_blocks, n + num_blocks
    slots = column_lanes(n) // 32
    out = restarts * ((8 << 2 * n) + 128 * G + 12 * P)
    if vjp:
        out += restarts * ((8 << 2 * n) + 128 * slots * G + 4 * P)
    return out * _scale(dtype) + 4 * G


def column_restarts(n: int, num_blocks: int, nba: int, log_c: int,
                    vjp: bool, dtype=torch.float32) -> int:
    """Restarts a block of the column design holds, as csrc/columns.cuh's
    column_restarts picks them in the build of `dtype`: 64 threads' worth
    (2 restarts up to 5 qubits, 1 at 6), else 1 where that layout does not
    fit; 0 where the column design does not take the shape (one column, n
    outside 2..6, or no layout fits)."""
    if log_c != n or not COLUMN_QUBITS[0] <= n <= COLUMN_QUBITS[1]:
        return 0
    r = max(COLUMN_THREADS // column_lanes(n), 1)
    while r >= 1:
        if column_smem_bytes(n, num_blocks, nba, vjp, r,
                             dtype) <= _SMEM_LIMIT:
            return r
        r //= 2
    return 0


def plan(n: int, num_blocks: int, nba: int, log_c: int, vjp: bool,
         dtype=torch.float32, placements=None):
    """The design csrc/unitary.cu launches for a shape (cpflow_unitary_design)
    in the build of `dtype`, and its sizes: dict(design 'columns', 'rows',
    'tiles' or 'global_rows', threads_per_restart, restarts_per_block,
    threads (a block), smem_bytes (a block), blocks_per_restart; for the
    kernels of the whole unitary on tiles.cuh's warps, the forward pass's
    column tiles and the vjp on a cluster, also columns_per_warp,
    warps_per_column and ring, as cpflow_unitary_warp_layout gives them;
    for the global row tiles, one column past what a cluster holds,
    blocks_per_restart the tiles a pass runs on, with per_sm, log_rows,
    warps, segment, ring, sum_smem_bytes and gates_smem_bytes, as
    global_plan gives them: with `placements` (the template's pairs) at
    global_per_sm's blocks an SM, without them at two where a tile fits
    so); None if no design holds the shape. The launches on rows.cuh's
    warps (every other of the row-split design): rows_launch, row_plan."""
    r = column_restarts(n, num_blocks, nba, log_c, vjp, dtype)
    if r:
        return dict(design='columns', threads_per_restart=column_lanes(n),
                    restarts_per_block=r, threads=r * column_lanes(n),
                    smem_bytes=column_smem_bytes(n, num_blocks, nba, vjp, r,
                                                 dtype),
                    blocks_per_restart=1)
    c = None if not vjp and forward_on_tiles(
        n, num_blocks, nba, log_c, dtype) else cluster_plan(
            n, num_blocks, nba, log_c, vjp, dtype)
    design, extra = 'rows', {}
    if c is None and not log_c:
        got = global_plan(n, num_blocks, nba, vjp, dtype, None if
                          placements is None else global_per_sm(
                              n, placements, nba, vjp, dtype))
        if got is None:
            return None
        return dict(design='global_rows',
                    threads_per_restart=got['threads'] * got['tiles'],
                    restarts_per_block=1, threads=got['threads'],
                    smem_bytes=got['smem_bytes'],
                    blocks_per_restart=got['tiles'],
                    **{k: got[k] for k in (
                        'per_sm', 'log_rows', 'warps', 'segment', 'ring',
                        'sum_smem_bytes', 'gates_smem_bytes')})
    if c is None:
        tiles = tile_plan(n, num_blocks, nba, log_c, vjp, dtype)
        if tiles is None:
            return None
        c, design = tiles[1], 'tiles'
    w = (1 << n) // c
    if design == 'rows' and not (log_c and vjp and c > 1):  # rows.cuh's
        rows = rows_launch(n, num_blocks, nba, log_c, vjp, dtype)  # warps
        threads, nbytes = rows['threads'], rows['smem_bytes']
    elif vjp and design == 'tiles':  # the vjp's tile kernel (tiles.cuh)
        threads = tk.tile_threads(n, w, dtype)
        nbytes = tk.tile_smem_bytes(n, num_blocks, w, dtype)
    else:  # on tiles.cuh's warps: the forward pass's column tiles, the
        # vjp on a cluster
        ring = tk.cluster_ring(n, num_blocks, nba, w, dtype) if vjp else 0
        threads = tk.tile_threads(n, w, dtype)
        nbytes = tk.warp_smem_bytes(n, num_blocks, nba, w, vjp, ring, dtype)
        extra = dict(columns_per_warp=tk.columns_a_warp(n, w, dtype),
                     warps_per_column=tk.warps_a_column(n, w, dtype),
                     ring=ring)
    return dict(design=design, threads_per_restart=threads * c,
                restarts_per_block=1, threads=threads, smem_bytes=nbytes,
                blocks_per_restart=c, **extra)


def kernel_name(design: str, vjp: bool, n: int, cluster: int = 1,
                column: bool = False) -> str:
    """The name in KERNELS of the kernel a launch of this design runs
    (column: one column, columns=[0])."""
    kind = 'vjp' if vjp else 'forward'
    if design == 'columns':
        return f'ansatz_{kind}_columns_{n}q'
    if design == 'tiles':
        return f'ansatz_{kind}_column_tiles'
    if design == 'global_rows':
        return f'ansatz_{kind}_global_rows'
    if column and cluster > 1:
        return f'ansatz_{kind}_row_tiles'
    return 'ansatz_vjp_cluster' if vjp and cluster > 1 else f'ansatz_{kind}'


def load_library(dtype=torch.float32) -> ctypes.CDLL:
    """Build csrc/unitary.cu in the precision of `dtype` (float32 or
    float64; once per version of csrc/) and load it."""
    lib = build.load(build.name_of('unitary', dtype == torch.float64))
    if lib.cpflow_unitary_launch.argtypes is None:
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.cpflow_unitary_launch.argtypes = [ptr] * 6 + [i] * 9 + [
            ptr, ptr, i]
        lib.cpflow_unitary_launch.restype = i
        lib.cpflow_unitary_row_plan.argtypes = [i] * 5 + [ptr]
        lib.cpflow_unitary_row_plan.restype = i
        lib.cpflow_unitary_smem_bytes.argtypes = [i] * 6
        lib.cpflow_unitary_smem_bytes.restype = ctypes.c_longlong
        lib.cpflow_unitary_cluster.argtypes = [i] * 5
        lib.cpflow_unitary_cluster.restype = i
        lib.cpflow_unitary_column_restarts.argtypes = [i] * 5
        lib.cpflow_unitary_column_restarts.restype = i
        lib.cpflow_unitary_column_smem_bytes.argtypes = [i] * 5
        lib.cpflow_unitary_column_smem_bytes.restype = ctypes.c_longlong
        lib.cpflow_unitary_design.argtypes = [i] * 5
        lib.cpflow_unitary_design.restype = i
        lib.cpflow_unitary_kernel_count.argtypes = []
        lib.cpflow_unitary_kernel_count.restype = i
        lib.cpflow_unitary_attributes.argtypes = [i, ptr]
        lib.cpflow_unitary_attributes.restype = i
        lib.cpflow_unitary_occupancy.argtypes = [i, i, ctypes.c_longlong,
                                                 ptr]
        lib.cpflow_unitary_occupancy.restype = i
        lib.cpflow_unitary_clusters.argtypes = [i, i, ctypes.c_longlong, i,
                                                ptr]
        lib.cpflow_unitary_clusters.restype = i
        lib.cpflow_unitary_tiles.argtypes = [i] * 5
        lib.cpflow_unitary_tiles.restype = i
        lib.cpflow_unitary_tile_partials.argtypes = [i] * 4
        lib.cpflow_unitary_tile_partials.restype = ctypes.c_longlong
        lib.cpflow_unitary_tile_layout.argtypes = [i] * 4 + [ptr]
        lib.cpflow_unitary_tile_layout.restype = i
        lib.cpflow_unitary_warp_layout.argtypes = [i] * 5 + [ptr]
        lib.cpflow_unitary_warp_layout.restype = i
        lib.cpflow_unitary_tiles_launch.argtypes = [ptr] * 7 + [i] * 8 + [
            ptr]
        lib.cpflow_unitary_tiles_launch.restype = i
        lib.cpflow_unitary_global_plan.argtypes = [i] * 5 + [ptr]
        lib.cpflow_unitary_global_plan.restype = i
        lib.cpflow_unitary_global_work.argtypes = [i] * 5
        lib.cpflow_unitary_global_work.restype = ctypes.c_longlong
        lib.cpflow_unitary_global_launch.argtypes = [ptr] * 7 + [i] * 8 + [
            ptr] * 5 + [i]
        lib.cpflow_unitary_global_launch.restype = i
        lib.cpflow_unitary_global_gates.argtypes = [ptr] * 3 + [i] * 8 + [
            ptr]
        lib.cpflow_unitary_global_gates.restype = i
    return lib


def registers(device, dtype=torch.float32) -> dict:
    """{kernel name: dict(registers per thread, local_bytes per thread)} of
    every kernel of csrc/unitary.cu's build of `dtype` on the CUDA
    `device`, from the CUDA runtime (KERNELS names them: the row-split
    forward and vjp, the vjp's cluster build, the column design's forward
    and vjp at 2 to 6 qubits)."""
    lib = load_library(dtype)
    out = {}
    with torch.cuda.device(device):
        if lib.cpflow_unitary_kernel_count() != len(KERNELS):
            raise RuntimeError('csrc/unitary.cu and KERNELS disagree on the '
                               'kernels')
        for which, name in enumerate(KERNELS):
            attrs = (ctypes.c_int * 2)()
            err = lib.cpflow_unitary_attributes(which, attrs)
            if err != 0:
                raise RuntimeError(f'unitary kernel attribute query failed: '
                                   f'CUDA error {err}')
            out[name] = dict(registers=attrs[0], local_bytes=attrs[1])
    return out


def occupancy(name: str, threads: int, nbytes: int, device,
              dtype=torch.float32) -> int:
    """Resident blocks per SM of the kernel `name` (of KERNELS) of the
    build of `dtype` at `threads` threads and `nbytes` of dynamic shared
    memory a block, from the CUDA runtime on `device`."""
    out = ctypes.c_int()
    with torch.cuda.device(device):
        err = load_library(dtype).cpflow_unitary_occupancy(
            KERNELS.index(name), threads, nbytes, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f'unitary kernel occupancy query failed: CUDA '
                           f'error {err}')
    return out.value


def active_clusters(threads: int, nbytes: int, cluster: int, device,
                    dtype=torch.float32, name='ansatz_vjp_cluster') -> int:
    """Clusters of `cluster` blocks (2 to 16) of the cluster kernel `name`
    (``ansatz_vjp_cluster``, ``ansatz_forward_row_tiles`` or
    ``ansatz_vjp_row_tiles``) of the build of `dtype`, at `threads` threads
    and `nbytes` of dynamic shared memory a block, that the card `device`
    holds at once (cudaOccupancyMaxActiveClusters): 0 where it places
    none."""
    out = ctypes.c_int()
    with torch.cuda.device(device):
        err = load_library(dtype).cpflow_unitary_clusters(
            KERNELS.index(name), threads, nbytes, cluster, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f'unitary kernel cluster query failed: CUDA error '
                           f'{err}')
    return out.value


@functools.lru_cache(maxsize=64)
def _tables(placements: tuple, rotation_gates: str, device: torch.device):
    """The block placements and rotation letters as int32 tensors on the
    card (never empty, so that each has an address)."""
    plc = torch.tensor([list(p) for p in placements] or [[0, 0]],
                       dtype=torch.int32, device=device).contiguous()
    letters = torch.tensor([LETTER_CODES[c] for c in rotation_gates] or [0],
                           dtype=torch.int32, device=device)
    return plc, letters


def check_width(n: int, whole: bool, dtype) -> None:
    """Raises ValueError where the kernels take no n-qubit shape of the
    whole unitary (whole=True) or of one column in the build of `dtype`
    (MAX_QUBITS), with the reason."""
    limit = MAX_QUBITS[dtype]['unitary' if whole else 'column']
    if 2 <= n <= limit:
        return
    why = ('one column of the state and its cotangent exceeds the shared '
           'memory of a block, even on column tiles of one column each'
           if whole else
           'past the global row tiles\' cap (GLOBAL_MAX_QUBITS): a column '
           f'of 2^{limit} amplitudes is 128 MiB in {dtype}, the vjp holds '
           'four of them a restart, and it is the widest column that the '
           'card\'s smoke run holds against the plain version')
    raise ValueError(
        f'the unitary kernels take 2 to {limit} qubits for '
        f'{"the whole unitary" if whole else "one column"} in {dtype}, got '
        f'{n}: above that {why}')


def check_memory(needs: int, free: int, n: int, B: int, vjp: bool) -> None:
    """Raises ValueError where a call of the global row tiles needs more
    bytes than the card has free."""
    if needs > free:
        what = "the vjp's workspace" if vjp else 'U and its workspace'
        raise ValueError(
            f'the unitary kernels need {needs} bytes of device memory for '
            f'{what} of {B} restarts at {n} qubits (one column on the '
            f'global row tiles), and the card has {free} bytes free')


class _Shape:
    """The checked shape of one template, column choice, batch, card and
    kernel: what the kernels take, what they refuse, and the plan's design.
    Made once per key (``_shape``): the capability check and the library's
    plan are queried once, not at every call."""

    def __init__(self, num_qubits, entangling_gate_name, rotation_gates,
                 placements, columns, B, device, vjp, dtype):
        n = num_qubits
        major, minor = torch.cuda.get_device_capability(device)
        if (major, minor) != (9, 0):
            raise RuntimeError(
                f'the unitary kernels are built for sm_90a (Hopper); device '
                f'has compute capability {major}.{minor}')
        if columns is not None and list(columns) != [0]:
            raise ValueError(f'the unitary kernels build every column or '
                             f'column 0 alone, got columns={columns!r}')
        check_width(n, columns is None, dtype)
        if entangling_gate_name not in ENTANGLER_CODES or \
                set(rotation_gates) - set(LETTER_CODES):
            raise ValueError(
                f'unknown template: entangler {entangling_gate_name!r} (cp, '
                f'cz or cx), rotations {rotation_gates!r} (letters of x, y, '
                f'z)')
        self.n = n
        self.ent = ENTANGLER_CODES[entangling_gate_name]
        self.rot = rotation_gates
        self.placements = tuple(placements)
        self.nb = len(self.placements)
        self.nba = num_block_angles(entangling_gate_name, rotation_gates)
        self.log_c = n if columns is None else 0
        self.P = 3 * n + self.nba * self.nb
        self.B = B
        self.udims = (B, 1 << n, 1 << self.log_c)
        self.dtype = dtype
        self.cdtype = config.complex_of(dtype)
        self.lib = load_library(dtype)
        with torch.cuda.device(device):
            args = (n, self.nb, self.nba, self.log_c, int(vjp))
            self.cluster = self.lib.cpflow_unitary_cluster(*args)
            code = self.lib.cpflow_unitary_design(*args)
            # the column tiles' count, and the reals of the workspace a
            # restart of the vjp takes on them
            self.tiles = self.lib.cpflow_unitary_tiles(*args)
            self.work = self.lib.cpflow_unitary_tile_partials(*args[:4])
        self.design = {v: k for k, v in DESIGNS.items()}[code]
        self.vjp = vjp
        self.ops = None  # the row schedule, made by row_ops when first used
        self.table = None  # the global schedule, made by global_table
        if self.design == 'global_rows':
            # blocks a pass an SM, by the template's passes (the wrapper's
            # choice, which the library takes as given)
            self.per_sm = global_per_sm(n, self.placements, self.nba, vjp,
                                        dtype)
            got = (ctypes.c_int * 9)()
            with torch.cuda.device(device):
                err = self.lib.cpflow_unitary_global_plan(
                    n, self.nb, self.nba, int(vjp), self.per_sm or 0, got)
                self.work = self.lib.cpflow_unitary_global_work(
                    n, self.nb, self.nba, int(vjp), self.per_sm or 0)
            if err != 0:
                raise RuntimeError(f'no global row plan for {n} qubits: '
                                   f'CUDA error {err}')
            self.global_plan = dict(zip(
                ('threads', 'smem_bytes', 'warps', 'segment', 'ring',
                 'log_rows', 'tiles', 'sum_smem_bytes', 'gates_smem_bytes'),
                got))
            real = 8 if dtype == torch.float64 else 4
            # what a call allocates: its workspace, and U in the forward
            # pass
            self.needs = B * (self.work * real + (0 if vjp else
                                                  2 * real << n))
        if not self.cluster and self.design not in ('tiles', 'global_rows'):
            most = 1 << n if self.log_c else min(CLUSTERS[-1], 1 << (n - 2))
            with torch.cuda.device(device):
                nbytes = self.lib.cpflow_unitary_smem_bytes(
                    n, self.nb, self.nba, self.log_c, int(vjp), most)
            raise ValueError(
                f'{n} qubits with {self.nb} blocks need {nbytes} bytes of '
                f'shared memory per block in {dtype} even on {most} '
                + ('tiles of one column' if self.log_c else 'blocks')
                + f' a restart, above {_SMEM_LIMIT}')

    def kernel(self, vjp, design) -> str:
        """The name in KERNELS of the kernel a launch runs (on the column
        tiles the vjp's walk, which its sum follows), '_f64' added for the
        double build."""
        return kernel_name(design, vjp, self.n, self.cluster,
                           self.log_c == 0) + (
            '_f64' if self.dtype == torch.float64 else '')

    def global_table(self, device):
        """(table and copy tables on `device`, offsets, ranges, passes) of
        the global row tiles' schedule of this pass (kernels/rows.py:
        global_schedule, global_maps) for the library's plan's segment and
        tile; made at the first launch."""
        if self.table is None:
            p = self.global_plan
            low = rk.sector_bits(self.dtype)
            _, offsets, ranges = rk.global_schedule(
                self.n, self.placements, p['segment'], p['log_rows'], low)
            self.table = rk.device_global_schedule(
                self.n, self.placements, p['segment'], p['log_rows'], low,
                device) + (
                (ctypes.c_int * len(offsets))(*offsets),
                (ctypes.c_int * (2 * len(ranges)))(
                    *[j for r in ranges for j in r]), len(ranges))
        return self.table

    def check_free_memory(self, device):
        """Raises ValueError, before anything is allocated or launched,
        where what a call of the global row tiles allocates (U, or the
        vjp's workspace) exceeds the card's free memory: what
        torch.cuda.mem_get_info leaves, with what PyTorch's allocator holds
        unused."""
        free = torch.cuda.mem_get_info(device)[0] + \
            torch.cuda.memory_reserved(device) - \
            torch.cuda.memory_allocated(device)
        check_memory(self.needs, free, self.n, self.B, self.vjp)

    def row_ops(self, device):
        """The row schedule of this pass on rows.cuh's warps in the
        row-split design (the plan's, or design='rows' asked for), for the
        segment of the library's plan of that pass (the whole unitary's
        segment holds whole columns: its table is for segment n, with no
        swap); made at the first launch that asks for it. None where the
        pass takes no schedule (the vjp of the whole unitary on a
        cluster)."""
        if self.ops is None:
            got = (ctypes.c_int * 6)()
            with torch.cuda.device(device):
                err = self.lib.cpflow_unitary_row_plan(
                    self.n, self.nb, self.nba, self.log_c, int(self.vjp),
                    got)
            if err == 0:
                self.ops = rk.device_schedule(self.n, self.placements,
                                              min(got[3], self.n), device,
                                              forward=not self.vjp)
        return self.ops

    def launch(self, angles, u, ubar, grad, vjp, design):
        """Launches on the angles' card: the library configures and
        launches on the current device, so that device is made theirs."""
        plc, letters = _tables(self.placements, self.rot, angles.device)
        ops = self.row_ops(angles.device) if design == 'rows' else None
        stream = torch.cuda.current_stream(angles.device).cuda_stream
        with torch.cuda.device(angles.device):
            if design == 'global_rows':
                table, maps, offsets, ranges, passes = self.global_table(
                    angles.device)
                # the gates, their cos and sin (the prologue writes them),
                # and the vjp's A, M and tiles' shares
                work = torch.empty(self.B * self.work, dtype=self.dtype,
                                   device=angles.device)
                err = self.lib.cpflow_unitary_global_launch(
                    angles.data_ptr(), u.data_ptr(),
                    ubar.data_ptr() if ubar is not None else None,
                    grad.data_ptr() if grad is not None else None,
                    work.data_ptr(), plc.data_ptr(),
                    letters.data_ptr(), self.n, self.nb, len(self.rot),
                    self.ent, self.nba, self.B, int(vjp), self.per_sm,
                    stream, table.data_ptr(), maps.data_ptr(), offsets,
                    ranges, passes)
                if err == 0:
                    name = self.kernel(vjp, design)
                    suffix = '_f64' if self.dtype == torch.float64 else ''
                    GLOBAL_PASSES[name] += passes
                    GLOBAL_PASSES['ansatz_global_gates' + suffix] += 1
                    if vjp:
                        GLOBAL_PASSES[name.replace('global_rows',
                                                   'global_sum')] += 1
            elif design == 'tiles':
                # the vjp's workspace: the gates, the tiles' shares of the
                # gates' cotangents, the segments' sums and counts (the
                # prologue sets what needs setting)
                work = torch.empty(
                    self.B * self.work, dtype=self.dtype,
                    device=angles.device) if vjp else None
                err = self.lib.cpflow_unitary_tiles_launch(
                    angles.data_ptr(), u.data_ptr(),
                    ubar.data_ptr() if ubar is not None else None,
                    grad.data_ptr() if grad is not None else None,
                    work.data_ptr() if vjp else None, plc.data_ptr(),
                    letters.data_ptr(),
                    self.n, self.nb, len(self.rot), self.ent, self.nba,
                    self.log_c, self.B, int(vjp), stream)
            else:
                err = self.lib.cpflow_unitary_launch(
                    angles.data_ptr(), u.data_ptr(),
                    ubar.data_ptr() if ubar is not None else None,
                    grad.data_ptr() if grad is not None else None,
                    plc.data_ptr(), letters.data_ptr(), self.n, self.nb,
                    len(self.rot), self.ent, self.nba, self.log_c, self.B,
                    int(vjp), DESIGNS[design], stream,
                    ops.data_ptr() if ops is not None else None,
                    len(ops) if ops is not None else 0)
        if err != 0:
            raise RuntimeError(
                f'unitary kernel launch failed: CUDA error {err} ({self.B} '
                f'restarts, {design} design)' + (
                    f': the card places no cluster of {self.cluster} blocks'
                    if err == _OUT_OF_RESOURCES else ''))


@functools.lru_cache(maxsize=256)
def _shape(num_qubits, entangling_gate_name, rotation_gates, placements,
           columns, B, device, vjp, dtype) -> _Shape:
    return _Shape(num_qubits, entangling_gate_name, rotation_gates,
                  placements, columns, B, device, vjp, dtype)


def _checked(num_qubits, entangling_gate_name, rotation_gates, placements,
             angles, columns, vjp, design) -> _Shape:
    """The cached shape of one call, after the checks of the call itself
    (device, dtype, angle count) and the design asked for."""
    if angles.device.type != 'cuda':
        raise ValueError(f'the unitary kernels run on a CUDA tensor, got '
                         f'one on {angles.device}')
    if angles.dtype not in DTYPES:
        raise ValueError(f'the unitary kernels compute in float32 or '
                         f'float64, got {angles.dtype}')
    layer, num_layers = placements['layers']
    key = tuple(tuple(p) for p in layer) * num_layers + \
        tuple(tuple(p) for p in placements['free'])
    shape = _shape(num_qubits, entangling_gate_name, rotation_gates, key,
                   None if columns is None else tuple(columns),
                   angles.shape[1] if angles.dim() == 2 else -1,
                   angles.device, vjp, angles.dtype)
    if angles.dim() != 2 or angles.shape[0] != shape.P:
        raise ValueError(f'angles must be (P={shape.P}, B), got '
                         f'{tuple(angles.shape)}')
    if design not in (None, *CALLER_DESIGNS):
        raise ValueError(f'design must be one of {sorted(CALLER_DESIGNS)}, '
                         f'got {design!r}')
    if design == 'rows' and not vjp and shape.design == 'tiles':
        raise ValueError(
            f'the forward pass of the whole unitary at {shape.n} qubits with '
            f'{shape.nb} blocks runs on the column tiles alone (from 7 '
            f'qubits, and below them where no split of the row-split design '
            f'holds it): design=\'rows\' is refused; pass design=None or '
            f'\'tiles\'')
    return shape


def ansatz_forward(num_qubits: int, entangling_gate_name: str,
                   rotation_gates: str, placements: dict,
                   angles: torch.Tensor, columns=None,
                   design=None) -> torch.Tensor:
    """angles (P, B) on the card -> the ansatz unitaries (B, d, C), one
    contiguous row-major d x C matrix per restart in the index order of
    sim.ansatz_kernel.build_unitary; C = 2^n, or 1 with columns=[0];
    complex64 from float32 angles, complex128 from float64 ones, each
    through its own build. Launches the forward kernel in the plan's design
    (or in `design`, 'rows', 'columns' or 'tiles'), or raises."""
    global FORWARD_LAUNCHES, COLUMN_LAUNCHES, FORWARD_F64_LAUNCHES
    angles = angles.detach().contiguous()
    shape = _checked(num_qubits, entangling_gate_name, rotation_gates,
                     placements, angles, columns, False, design)
    design = design or shape.design
    if design == 'global_rows':
        shape.check_free_memory(angles.device)
    u = torch.empty(shape.udims, dtype=shape.cdtype, device=angles.device)
    if shape.B:
        shape.launch(angles, u, None, None, False, design)
        LAUNCHES_BY_KERNEL[shape.kernel(False, design)] += 1
        FORWARD_LAUNCHES += 1
        COLUMN_LAUNCHES += design == 'columns'
        FORWARD_F64_LAUNCHES += shape.dtype == torch.float64
    return u


def ansatz_vjp(num_qubits: int, entangling_gate_name: str,
               rotation_gates: str, placements: dict, angles: torch.Tensor,
               u: torch.Tensor, grad_u: torch.Tensor,
               columns=None, design=None) -> torch.Tensor:
    """The gradient (P, B) of a real L with respect to the angles, from
    u = ansatz_forward(angles), (B, d, C), and grad_u, (B, d, C): the
    gradient of L with respect to u in PyTorch's convention for complex
    tensors, dL/dRe u + i dL/dIm u; both complex of the angles' precision.
    Launches the vjp kernel in the plan's design (or in `design`), or
    raises."""
    global VJP_LAUNCHES, COLUMN_LAUNCHES, VJP_F64_LAUNCHES
    angles = angles.detach().contiguous()
    shape = _checked(num_qubits, entangling_gate_name, rotation_gates,
                     placements, angles, columns, True, design)
    design = design or shape.design
    for name, t in (('u', u), ('grad_u', grad_u)):
        if tuple(t.shape) != shape.udims or t.dtype != shape.cdtype or \
                t.device != angles.device:
            raise ValueError(f'{name} must be {shape.cdtype} {shape.udims} '
                             f'on {angles.device}, got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')
    if design == 'global_rows':
        shape.check_free_memory(angles.device)
    # the column design copies each restart's slab 16 bytes at a time
    u, grad_u = (t if t.is_contiguous() and t.data_ptr() % 16 == 0 else
                 t.contiguous().clone() for t in (u, grad_u))
    grad = torch.empty_like(angles)
    if shape.B:
        shape.launch(angles, u, grad_u, grad, True, design)
        LAUNCHES_BY_KERNEL[shape.kernel(True, design)] += 1
        VJP_LAUNCHES += 1
        COLUMN_LAUNCHES += design == 'columns'
        VJP_F64_LAUNCHES += shape.dtype == torch.float64
        VJP_LAUNCHES_BY_CLUSTER[1 if design == 'columns' else design if
                                design in ('tiles', 'global_rows') else
                                shape.cluster] += 1
    return grad


def global_gates(num_qubits: int, entangling_gate_name: str,
                 rotation_gates: str, placements: dict,
                 angles: torch.Tensor) -> torch.Tensor:
    """The global row tiles' prologue alone (global_gates_kernel, which
    each of their calls launches first): angles (P, B) on the card -> every
    gate's matrix, (B, G, 16) complex, as the kernels hold them (a surface
    gate's 2x2 in its first 4 entries, a block's 4x4), for the shape whose
    forward pass of one column runs on the global row tiles; raises
    elsewhere."""
    angles = angles.detach().contiguous()
    shape = _checked(num_qubits, entangling_gate_name, rotation_gates,
                     placements, angles, [0], False, None)
    if shape.design != 'global_rows':
        raise ValueError(f'{num_qubits} qubits with {shape.nb} blocks: the '
                         f'forward pass of one column runs in the '
                         f'{shape.design!r} design, not on the global row '
                         f'tiles')
    _, letters = _tables(shape.placements, shape.rot, angles.device)
    G = shape.n + shape.nb
    work = torch.empty((shape.B, shape.work), dtype=shape.dtype,
                       device=angles.device)
    with torch.cuda.device(angles.device):
        err = shape.lib.cpflow_unitary_global_gates(
            angles.data_ptr(), work.data_ptr(), letters.data_ptr(), shape.n,
            shape.nb, len(shape.rot), shape.ent, shape.nba, shape.B, 0,
            shape.per_sm, torch.cuda.current_stream(angles.device)
            .cuda_stream)
    if err != 0:
        raise RuntimeError(f'unitary kernel launch failed: CUDA error {err} '
                           f'({shape.B} restarts, the global row tiles\' '
                           f'prologue)')
    GLOBAL_PASSES['ansatz_global_gates' + (
        '_f64' if shape.dtype == torch.float64 else '')] += 1
    return torch.view_as_complex(work[:, :32 * G].reshape(shape.B, G, 16, 2))


class AnsatzUnitary(torch.autograd.Function):
    """angles (P, B) -> the batched unitary (2,)*n + (C, B) on the card; the
    backward is the vjp kernel. Only ever applied to the whole (P, B) batch:
    it is not to be vmapped."""

    @staticmethod
    def forward(ctx, angles, num_qubits, entangling_gate_name,
                rotation_gates, placements, columns):
        u = ansatz_forward(num_qubits, entangling_gate_name, rotation_gates,
                           placements, angles, columns)
        ctx.save_for_backward(angles, u)
        ctx.template = (num_qubits, entangling_gate_name, rotation_gates,
                        placements)
        ctx.columns = columns
        return u.permute(1, 2, 0).reshape([2] * num_qubits + [u.shape[2],
                                                              u.shape[0]])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_output):
        angles, u = ctx.saved_tensors
        # any strides in; the kernel reads (B, d, C) contiguous
        grad_u = grad_output.reshape(u.shape[1], u.shape[2], u.shape[0]) \
            .permute(2, 0, 1).contiguous()
        grad = ansatz_vjp(*ctx.template, angles, u, grad_u,
                          columns=ctx.columns)
        return grad, None, None, None, None, None


def build_unitary(num_qubits: int, entangling_gate_name: str,
                  rotation_gates: str, placements: dict,
                  angles: torch.Tensor, columns=None,
                  dtype=None) -> torch.Tensor:
    """angles (P, B) -> the batched unitary (2,)*n + (cols, B),
    differentiable in the angles: through the kernels for a CUDA tensor
    (float32 through the float build, float64 through the double build; it
    raises on any other dtype and never falls back or casts), the plain
    sim.batched.build_unitary_batched for a CPU tensor."""
    angles = torch.as_tensor(angles)
    if angles.device.type == 'cpu':
        return build_unitary_batched(num_qubits, entangling_gate_name,
                                     rotation_gates, placements, angles,
                                     columns=columns, dtype=dtype)
    dtype = dtype or config.real_dtype
    if dtype not in DTYPES:
        raise ValueError(f'the unitary kernels compute in float32 or '
                         f'float64, asked for {dtype}')
    return AnsatzUnitary.apply(angles.to(dtype), num_qubits,
                               entangling_gate_name, rotation_gates,
                               placements, columns)

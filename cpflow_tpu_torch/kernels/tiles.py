"""The column tiles' host side: Python mirrors of csrc/tiles.cuh's layout
and threads, which sweep_tile_kernel (kernels/sweep.py) and unitary.cu's
vjp_tiles_kernel (kernels/unitary.py) share, of the unitary vjp's
workspace and last kernel's layout, and of the layout of unitary.cu's
kernels on the same warps (warp_layout: the forward pass's column tiles,
the vjp on a cluster).

A tile holds w columns of a restart's state and cotangent, column-major in
shared memory, each column walked by its own warps (csrc/tiles.cuh), or
where a block holds more columns than warps (the unitary kernels at 7 to
9 qubits) each warp walking w / warps columns. The mirrors let the plans
and layouts be checked without a card; on the card the libraries' own
functions decide (cpflow_sweep_tile_smem_bytes, cpflow_unitary_tile_layout,
cpflow_unitary_tile_partials, cpflow_unitary_warp_layout), and
chip_smoke.py holds the mirrors against them.
"""

from __future__ import annotations

import torch

# csrc/tiles.cuh: threads a block at most, by build; gates between two sums
# of the warps' cotangent slots; tiles one segment sum adds
TILE_THREADS = {torch.float32: 512, torch.float64: 256}
TILE_RING = 16
TILE_SEGMENT = 32
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def _real(dtype) -> int:
    return 8 if dtype == torch.float64 else 4


def tile_threads(n: int, columns: int, dtype=torch.float32) -> int:
    """Threads of a block of the tile kernels on tiles of `columns`
    columns, as csrc/tiles.cuh's tile_threads: one per 4 amplitudes, at
    least a warp a column, at most TILE_THREADS of the build."""
    return min(TILE_THREADS[dtype], max(32 * columns, columns << n >> 2))


def tile_smem_bytes(n: int, num_blocks: int, columns: int,
                    dtype=torch.float32) -> int:
    """Dynamic shared memory of a block of the tile kernels, as
    csrc/tiles.cuh's tile_layout lays it out: A and M (`columns` columns of
    2^n + 1 amplitudes), aligned to 16 bytes, the G gates, the ring of the
    warps' cotangent slots (warps x TILE_RING gates x 32 reals), each warp's
    share of s (2 reals; the sweep's), an mbarrier and a flag (16 bytes) and
    each gate's row bits (2 ints)."""
    f = _real(dtype) // 4
    G, warps = n + num_blocks, tile_threads(n, columns, dtype) // 32
    o = -(-2 * columns * ((1 << n) + 1) * 8 * f // 16) * 16
    return o + 128 * f * G + (32 * TILE_RING + 2) * warps * 4 * f + 16 + 8 * G


def vjp_workspace(n: int, num_blocks: int, nba: int, tiles: int,
                  dtype=torch.float32) -> int:
    """Reals of the unitary vjp's workspace a restart on `tiles` tiles, as
    csrc/unitary.cu's vjp_work lays it out: the gates (32 G reals), the cos
    and sin of the angles (2 P), each tile's shares (32 G), each segment's
    sums (32 G; a segment for every TILE_SEGMENT tiles past TILE_SEGMENT)
    and a 4-byte count a segment, rounded up to 16 bytes."""
    real = _real(dtype)
    G, P = n + num_blocks, 3 * n + nba * num_blocks
    segments = tiles // TILE_SEGMENT if tiles > TILE_SEGMENT else 0
    end = 32 * G + 2 * P + 32 * G * (tiles + segments) + \
        -(-4 * segments // real)
    per16 = 16 // real
    return -(-end // per16) * per16


def sum_smem_bytes(n: int, num_blocks: int, nba: int,
                   dtype=torch.float32) -> int:
    """Dynamic shared memory of a block of the unitary vjp's prologue and
    last kernel on the column tiles, as csrc/unitary.cu's sum_layout lays it
    out: the gates (16 complex each), their cotangents (32 reals each), the
    gradient, the angles and the cos and sin of each."""
    G, P = n + num_blocks, 3 * n + nba * num_blocks
    return _real(dtype) * (64 * G + 4 * P)


def columns_a_warp(n: int, columns: int, dtype=torch.float32) -> int:
    """Columns each warp owns on a block of `columns` columns of the
    unitary kernels' warps, as csrc/tiles.cuh's tile_columns_a_warp:
    columns / warps where the block holds more columns than warps (7 to 9
    qubits), else 1."""
    warps = tile_threads(n, columns, dtype) // 32
    return columns // warps if columns > warps else 1


def warps_a_column(n: int, columns: int, dtype=torch.float32) -> int:
    """Warps of a column on such a block: warps / columns where it holds
    fewer columns than warps (10 qubits and up), else 1."""
    warps = tile_threads(n, columns, dtype) // 32
    return warps // columns if columns < warps else 1


def warp_smem_bytes(n: int, num_blocks: int, nba: int, columns: int,
                    vjp: bool, ring: int = 0, dtype=torch.float32) -> int:
    """Dynamic shared memory of a block of csrc/unitary.cu's kernels on
    tiles.cuh's warps, as its warp_layout lays it out: A (and the vjp's M),
    `columns` columns of 2^n + 1 amplitudes, aligned to 16 bytes, the G
    gates (16 complex each), the vjp's gates' cotangents (32 reals each)
    and its ring of `ring` gates of each warp's slots (32 reals), the cos
    and sin of the P angles, and P reals for the angles and the vjp's
    gradient."""
    real = _real(dtype)
    G, P = n + num_blocks, 3 * n + nba * num_blocks
    warps = tile_threads(n, columns, dtype) // 32
    o = columns * ((1 << n) + 1) * 2 * real * (2 if vjp else 1)
    o = -(-o // 16) * 16 + 32 * real * G
    if vjp:
        o += 32 * real * G + warps * ring * 32 * real
    return o + 3 * P * real


def cluster_ring(n: int, num_blocks: int, nba: int, columns: int,
                 dtype=torch.float32) -> int:
    """Gates in the ring of the unitary vjp on a cluster of blocks of
    `columns` columns, as csrc/unitary.cu's cluster_ring picks them: the
    most of TILE_RING, 8, 4, 2, 1 whose warp_smem_bytes fits a block; 0 if
    none does."""
    ring = TILE_RING
    while ring and warp_smem_bytes(n, num_blocks, nba, columns, True, ring,
                                   dtype) > SMEM_LIMIT:
        ring //= 2
    return ring

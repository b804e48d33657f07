"""The row tiles' host side: the plan of a block and the schedule of bit
swaps that the wrappers of sweep_rows_kernel (kernels/sweep.py),
forward_rows_kernel and vjp_rows_kernel (kernels/unitary.py) hand to the
kernel.

A state's one column split by rows over a cluster of blocks (2^log_rows
rows a block) is owned by the block's warps, 2^segment contiguous rows each
(csrc/rows.cuh). A gate whose legs lie on the segment's bits runs on a
warp's own rows with no block or cluster barrier, so the row bits are kept
under a permutation, and before a gate that needs a bit outside the
segment that bit is swapped with a segment bit the gate does not use: the
one whose next use lies furthest ahead (Belady's rule, which makes the
fewest swaps for a known sequence of uses). The swaps depend only on the
template and the segment, so ``schedule`` computes them once, here, as a
table of ops; ``plan`` and ``launch`` mirror the kernels' choice of warps,
segment, ring and shared bytes, so that the tables and the layouts can be
checked without a card (on the card the library's own plan decides:
cpflow_sweep_row_plan, cpflow_unitary_row_plan). ``global_schedule`` does
the same for one column past what a cluster holds, kept in device memory:
its blocks cut into the fewest passes of tiles, each pass a table of its
own, and ``global_maps`` the tables by which a block copies its tile (the
global row tiles of kernels/unitary.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# csrc/rows.cuh: threads a block at most, by build; log2 of the fewest rows
# a warp owns while warps are split off; gates in the ring of cotangent
# slots at most
THREADS = {torch.float32: 512, torch.float64: 256}
SEGMENT_MIN = 7
RING_MAX = 16
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def plan(log_rows: int, spare=None, dtype=torch.float32) -> dict:
    """csrc/rows.cuh's row_plan for a tile of 2^log_rows rows whose ring may
    take `spare` bytes: dict(warps, segment (log2 of a warp's rows), ring
    (gates between two sums of the warps' slots)). A warp for every
    2^SEGMENT_MIN rows up to THREADS of the build, halved while a ring of
    one gate does not fit; the ring the largest power of two up to
    RING_MAX that fits. spare=None: no ring (ring 0; the forward pass sums
    no cotangent), the warps never halved."""
    real = 8 if dtype == torch.float64 else 4
    lw = 0
    while lw < log_rows - SEGMENT_MIN and 64 << lw <= THREADS[dtype]:
        lw += 1
    if spare is None:
        return dict(warps=1 << lw, segment=log_rows - lw, ring=0)
    while lw > 0 and (32 << lw) * real > spare:
        lw -= 1
    ring = RING_MAX
    while ring > 1 and (32 * ring << lw) * real > spare:
        ring //= 2
    return dict(warps=1 << lw, segment=log_rows - lw, ring=ring)


def launch(cluster: int, log_rows: int, plan_bytes: int, dtype,
           vjp: bool = True, reserve: int = 0) -> dict:
    """The launch of a block of the row tiles whose plan's layout takes
    `plan_bytes`. The vjp's (with its 2 x warps x 32 reals of cross-warp
    partials, the warps one per 16 rows between 1 and 8): ``plan`` in what
    that layout leaves of a block's shared memory, the partials out and the
    ring in. The forward pass's (vjp=False): ``plan`` with no ring, in the
    plan's bytes. `reserve` bytes more follow the layout (the global row
    tiles' pass maps), kept out of the ring's room. dict(cluster, log_rows,
    warps, segment, ring, threads, smem_bytes)."""
    if not vjp:
        p = plan(log_rows, None, dtype)
        return dict(cluster=cluster, log_rows=log_rows,
                    threads=32 * p['warps'],
                    smem_bytes=plan_bytes + reserve, **p)
    real = 8 if dtype == torch.float64 else 4
    partials = 2 * min(max((1 << log_rows) // 16, 32), 256) * real
    rest = plan_bytes - partials
    p = plan(log_rows, SMEM_LIMIT - reserve - rest, dtype)
    return dict(cluster=cluster, log_rows=log_rows, threads=32 * p['warps'],
                smem_bytes=rest + 32 * p['warps'] * p['ring'] * real +
                reserve, **p)


def gate_bits(n: int, placements) -> list:
    """The row bits of each of the n + len(placements) gates, as the kernels
    number them (qubit q on row bit n - 1 - q): (bit,) for the surface gate
    on each qubit, then (up leg, down leg) for each block."""
    return [(n - 1 - q,) for q in range(n)] + \
        [(n - 1 - int(a), n - 1 - int(b)) for a, b in placements]


def _belady(gates: list, order, held: list, segment: int) -> list:
    """The ops that run gates[j] for j in `order` from the permutation
    `held` (row bit -> the bit it holds; updated in place), each bit that a
    gate needs outside the segment swapped in for the segment bit, not of
    the gate, whose next use lies furthest ahead (ties: the higher bit, so
    that a float32 swap copies 16 bytes): (-1, s, b, 0) then (j, a, b, 0)
    as in ``schedule``, in the order of `order`."""
    n = len(held)
    uses = [[] for _ in range(n)]
    for t, j in enumerate(order):
        for bit in gates[j]:
            uses[bit].append(t)
    ahead = [0] * n  # the index in uses[bit] of its next use
    where = [0] * n  # bit -> the row bit it lies on
    for v, bit in enumerate(held):
        where[bit] = v
    never = len(gates)
    ops = []
    for t, j in enumerate(order):
        need = gates[j]
        for bit in range(n):
            while ahead[bit] < len(uses[bit]) and uses[bit][ahead[bit]] <= t:
                ahead[bit] += 1

        def next_use(v):
            y = held[v]
            return uses[y][ahead[y]] if ahead[y] < len(uses[y]) else never

        for bit in need:
            if where[bit] < segment:
                continue
            v = max((v for v in range(segment) if held[v] not in need),
                    key=lambda v: (next_use(v), v))
            p, y = where[bit], held[v]
            ops.append((-1, v, p, 0))
            held[v], held[p] = bit, y
            where[bit], where[y] = v, p
        ops.append((j, where[need[0]], where[need[1]] if len(need) > 1 else 0,
                    0))
    return ops


@functools.lru_cache(maxsize=64)
def schedule(n: int, placements: tuple, segment: int,
             forward: bool = False) -> np.ndarray:
    """The row schedule of a template for a segment of 2^segment rows:
    (ops, 4) int32 rows in the chain's order, (j, a, b, 0) for gate j on row
    bits a (its first leg) and b (its second; 0 for a surface gate), both
    below `segment`, and (-1, s, b, 0) for the swap of segment bit s with
    bit b > s. The table ends on the identity: the walk, which runs it
    backward, starts from the rows in natural order, and each gate meets
    its legs where the chain left them. Computed from the walk's end, the
    gates in reverse order from the identity (``_belady``).

    forward=True: the table of forward_rows_kernel, whose chain starts
    from e_0. The surface round from e_0 leaves a product state, each
    qubit's amplitudes the first column of its surface gate, so the table
    starts with n rows (-2, v, b, 0), row bit v holding the bit b (qubit
    n - 1 - b, whose surface gate is gate n - 1 - b), and runs the blocks
    alone, their schedule computed as the walk's from the identity at the
    end."""
    if segment < 2:
        raise ValueError(f'a segment of {1 << segment} rows holds no '
                         f'two-qubit gate')
    gates = gate_bits(n, placements)
    held = list(range(n))
    ops = _belady(gates, range(len(gates) - 1, n - 1 if forward else -1, -1),
                  held, segment)[::-1]
    if forward:  # where the chain starts: the walk's last permutation
        ops = [(-2, v, bit, 0) for v, bit in enumerate(held)] + ops
    table = np.array(ops, dtype=np.int32).reshape(-1, 4)
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=64)
def device_schedule(n: int, placements: tuple, segment: int,
                    device: torch.device,
                    forward: bool = False) -> torch.Tensor:
    """``schedule`` as an int32 tensor on `device`, made once a key."""
    return torch.tensor(schedule(n, placements, segment, forward),
                        dtype=torch.int32, device=device).contiguous()


# ------------------------------------------------------ global row tiles
# A column too wide for a cluster's shared memory stays in device memory in
# natural order, and a launch (a pass) runs every tile of 2^log_rows rows on
# a block of its own: the bits on row bits log_rows ... n - 1, the global
# bits, name the tile. A pass brings its tile in under a permutation of the
# row bits of its own (the addresses are the amplitudes' own indices, so
# any permutation is one load) and stores it back under the permutation its
# swaps leave, so the column is in natural order between passes whatever
# the table does. Within a pass the bits move as on one block (``schedule``:
# a gate on a warp's segment, a bit it needs swapped in from the tile), and
# a gate whose bits are not all in the tile ends the pass. Both passes
# schedule the blocks alone: the forward pass starts from the surface
# round's product state, and the vjp contracts M with it (csrc/rows.cuh).

# the tile's lowest address bits that every pass holds on its lowest row
# bits, in order, when it starts and when it ends (at most the segment's):
# a block copies 16 bytes a thread, two neighbouring amplitudes in float32,
# and eight threads' copies fall on distinct banks
FIXED_BITS = 4
# the pass's copy tables (``global_maps``): for each end of the pass, rows
# and addresses of a tile's i-th amplitude in address order by i's 7 low
# and 7 high bits (4 x 128 ints), then the tile's base address by the
# tile's 7 low and 7 high bits (2 x 128 ints)
MAP_INTS = 1536


def sector_bits(dtype) -> int:
    """The amplitude bits that every pass keeps in its tile, so that its
    loads and stores read and write whole 32-byte sectors: 2 in float32
    (four complex64), 1 in float64 (two complex128)."""
    return 1 if dtype == torch.float64 else 2


def windows(n: int, gates: list, order, log_rows: int, low: int) -> list:
    """The gates of `order` (indices into `gates`, each a tuple of bits)
    cut into the fewest passes: each pass the longest run whose bits,
    with the sector bits 0 ... low - 1, number at most log_rows (a run is
    feasible if a longer one is, so taking the longest each time is
    optimal). [(first, end)] positions in `order`."""
    order = list(order)
    out, start = [], 0
    while start < len(order):
        held = set(range(low))
        end = start
        while end < len(order) and len(held | set(gates[order[end]])) <= \
                log_rows:
            held |= set(gates[order[end]])
            end += 1
        if end == start:
            raise ValueError(f'a tile of {1 << log_rows} rows holds no gate '
                             f'beside the {low} sector bits')
        out.append((start, end))
        start = end
    return out


@functools.lru_cache(maxsize=64)
def global_schedule(n: int, placements: tuple, segment: int, log_rows: int,
                    low: int) -> tuple:
    """The schedule of the global row tiles for tiles of 2^log_rows rows and
    a segment of 2^segment rows: (table, offsets, ranges). table is (ops, 4)
    int32 of the passes one after another; pass p is table[offsets[p]:
    offsets[p + 1]]: n rows (-2, v, b, 0), row bit v holding bit b when the
    pass begins (its tile the bits on row bits below log_rows, sector bits
    0 ... low - 1 among them; the rest in increasing order, naming the
    tile), then the pass's ops as ``schedule`` writes them, every swap
    inside the tile (both bits below log_rows). ranges[p] = (first, last)
    gate of pass p; the gates of a pass are consecutive blocks. The passes
    are the fewest (``windows``); within a pass the tile's row bits start
    with its FIXED_BITS lowest address bits (at most the segment's), in
    order, then the bits used first on the segment, and Belady's rule
    swaps the rest in; swaps at the pass's end put those lowest bits back
    on the lowest row bits, so that both of its permutations keep them
    there.

    Both passes run this table of the blocks alone: the forward pass in
    order, its first pass's n rows also where row_product writes the
    surface round's product state from e_0; the vjp backward, last pass
    first, its first pass's n rows also where the walk leaves the product
    state that the surface round's cotangents contract M with."""
    if segment < 2:
        raise ValueError(f'a segment of {1 << segment} rows holds no '
                         f'two-qubit gate')
    gates = gate_bits(n, placements)
    order = list(range(n, len(gates)))
    fixed = min(FIXED_BITS, segment)
    ops, offsets, ranges = [], [0], []
    for start, end in windows(n, gates, order, log_rows, low):
        run = order[start:end]
        tile = set(range(low))
        for j in run:
            tile |= set(gates[j])
        first_use = {}
        for t, j in enumerate(run):
            for bit in gates[j]:
                first_use.setdefault(bit, t)
        # the tile: its gates' bits and the sector bits, filled up from the
        # lowest unused bits; on the row bits its lowest bits first, then
        # by first use; the rest naming the tile
        tile |= set([b for b in range(n) if b not in tile][:log_rows -
                                                             len(tile)])
        lowest = sorted(tile)[:fixed]
        local = lowest + sorted(tile - set(lowest), key=lambda b: (
            first_use.get(b, len(run)), b))
        held = local + [b for b in range(n) if b not in tile]
        head = [(-2, v, b, 0) for v, b in enumerate(held)]
        body = _belady(gates, run, held, segment)
        where = {b: v for v, b in enumerate(held)}
        for v, b in enumerate(lowest):  # the lowest bits back in place
            if held[v] != b:
                p, y = where[b], held[v]
                body.append((-1, v, p, 0))
                held[v], held[p] = b, y
                where[b], where[y] = v, p
        ops += head + body
        offsets.append(len(ops))
        ranges.append((run[0], run[-1]))
    table = np.array(ops, dtype=np.int32).reshape(-1, 4)
    table.setflags(write=False)
    return table, tuple(offsets), tuple(ranges)


def pass_ends(table, offsets) -> list:
    """[(start, end)] of each pass of a global schedule: the permutations
    (row bit -> address bit) it starts and ends with."""
    out = []
    for p in range(len(offsets) - 1):
        rows = table[offsets[p]:offsets[p + 1]]
        n = int((rows[:, 0] == -2).sum())
        held = [int(b) for b in rows[:n, 2]]
        start = list(held)
        for j, a, b, _ in rows[n:]:
            if j == -1:
                held[a], held[b] = held[b], held[a]
        out.append((start, held))
    return out


def _spread(values, count):
    """For x in 0 ... 127: the OR of values[u] over the set bits u of x,
    u < min(7, count)."""
    out = np.zeros(128, dtype=np.int64)
    for u in range(min(7, count)):
        out[(np.arange(128) >> u) & 1 == 1] |= values[u]
    return out


def global_maps(n: int, placements: tuple, segment: int, log_rows: int,
                low: int) -> np.ndarray:
    """The copy tables of each pass of ``global_schedule``: (passes,
    MAP_INTS) int32. For each end of the pass (its start permutation, then
    its end one) four tables of 128: the tile row and the address bits of
    the tile's i-th amplitude in increasing address order, as row(i) =
    rows_lo[i & 127] | rows_hi[i >> 7] and addr(i) = addr_lo[i & 127] |
    addr_hi[i >> 7]; then for each end the address bits that tile t sets,
    base(t) = base_lo[t & 127] | base_hi[t >> 7]. A block's amplitude i
    lies at base(t) | addr(i), on row row(i) of its tile."""
    table, offsets, _ = global_schedule(n, placements, segment, log_rows,
                                        low)
    out = []
    for ends in pass_ends(table, offsets):
        parts, bases = [], []
        for held in ends:
            bits = sorted(held[:log_rows])
            row = [held.index(b) for b in bits]
            for values in (1 << np.array(row), 1 << np.array(bits)):
                parts += [_spread(values, log_rows),
                          _spread(values[7:], log_rows - 7)]
            glob = 1 << np.array(held[log_rows:], dtype=np.int64)
            bases += [_spread(glob, n - log_rows),
                      _spread(glob[7:], n - log_rows - 7)]
        out.append(np.concatenate(parts + bases))
    maps = np.array(out, dtype=np.int32).reshape(-1, MAP_INTS)
    maps.setflags(write=False)
    return maps


@functools.lru_cache(maxsize=64)
def device_global_schedule(n: int, placements: tuple, segment: int,
                           log_rows: int, low: int,
                           device: torch.device) -> tuple:
    """``global_schedule``'s table and ``global_maps``' tables as int32
    tensors on `device`, made once a key."""
    table = global_schedule(n, placements, segment, log_rows, low)[0]
    maps = global_maps(n, placements, segment, log_rows, low)
    return (torch.tensor(table, dtype=torch.int32, device=device)
            .contiguous(),
            torch.tensor(maps, dtype=torch.int32, device=device)
            .contiguous())

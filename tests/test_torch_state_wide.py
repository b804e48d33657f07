"""A state wider than 17 qubits (16 in float64): the global row tiles.

forward_global_kernel and vjp_global_kernel (csrc/unitary.cu) hold one
column in device memory, in natural order, and run it a pass at a time:
every tile of 2^log_rows rows on a block of its own, loaded under the
pass's permutation and stored under the one its swaps leave, a gate that
needs a bit outside the tile ending the pass; both schedule the blocks
alone, the vjp's last launch contracting M with the surface round's
product state for the surface gates' cotangents; vjp_global_sum_kernel
adds the tiles' shares of each gate's cotangent in a fixed order. The
wrapper hands them a schedule and its copy tables computed on the host
(kernels/rows.py: global_schedule, global_maps). Here, on the CPU:

  * the schedule: every gate's legs on segment bits when it runs, every
    swap inside the tile, the sector bits in every pass's tile and the
    tile's lowest address bits on its lowest row bits at both ends of
    every pass, the passes the fewest any cut of the blocks into runs
    allows, their counts at the GHZ-20 ladder and at a deep random
    template printed and bounded; the copy tables give every pass's
    (address, row) pairs as the rule of the tiles' permutations does;
  * the schedule applied in plain torch as the kernels apply it (simulated
    tiles and passes, gathers and scatters by the passes' permutations,
    the surface round contracted tile by tile, the tiles' shares summed in
    the kernel's order) gives the plain path's column, state loss and
    angle gradients at 8-12 qubits with tiles of 2^4-2^6 rows, and the JAX
    package's objective at one shape;
  * at 18 qubits the port's plain state objective and its gradient against
    the JAX package's on the same numpy inputs;
  * the plans' Python mirrors at 18-24 qubits in float32 and 17-23 in
    float64, and every plan below them as it was; the route of a wide
    state to the unitary kernels and the refusals past the cap.

The kernels themselves run only on a card: chip_smoke.py phase 23 holds
them against their plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import api as japi
from cpflow_tpu import config as jconfig
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch.kernels import rows as rk
from cpflow_tpu_torch.kernels import sweep as sk
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.sim import adjoint
from cpflow_tpu_torch.sim import batched as tbt
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles
from cpflow_tpu_torch.topology import chain_layer, fill_layers

import chip_smoke
from test_torch_row_schedule import apply, gate_matrices, group_rows

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
LIMIT = 232448  # shared memory one block may use on sm_90
NBA = num_block_angles('cp', 'xyz')
# two derivations of one function, rounded in another order
TOL = {F32: 1e-5, F64: 1e-12}


def placements_of(n, k, layer='chain', seed=0):
    """(placements dict, tuple of pairs) on the chain, or k blocks on
    seeded random distinct qubit pairs, either leg order."""
    if layer == 'chain':
        pl = fill_layers(chain_layer(n), k)
    else:
        rng = np.random.default_rng(seed)
        pl = fill_layers([list(map(int, rng.choice(n, 2, replace=False)))
                          for _ in range(k)], k)
    return pl, tuple(tuple(p) for p in all_placements(pl))


def passes_of(table, offsets):
    """[(start permutation, ops)] of a global schedule."""
    out = []
    for p in range(len(offsets) - 1):
        rows = table[offsets[p]:offsets[p + 1]]
        n = int((rows[:, 0] == -2).sum())
        assert [int(r[0]) for r in rows[:n]] == [-2] * n
        assert [int(r[1]) for r in rows[:n]] == list(range(n))
        out.append(([int(r[2]) for r in rows[:n]], rows[n:]))
    return out


def end_of(held, ops):
    """The permutation a pass's swaps leave."""
    held = list(held)
    for j, a, b, _ in ops:
        if j == -1:
            held[a], held[b] = held[b], held[a]
    return held


def fewest_passes(gates, order, log_rows, low):
    """The fewest runs the gates of `order` cut into, each run's bits with
    the sector bits at most log_rows (by dynamic programming over the cut
    points, independent of ``rk.windows``)."""
    best = [0] + [None] * len(order)
    for end in range(1, len(order) + 1):
        bits = set(range(low))
        for start in range(end - 1, -1, -1):
            bits |= set(gates[order[start]])
            if len(bits) > log_rows:
                break
            if best[start] is not None and (best[end] is None or
                                            best[start] + 1 < best[end]):
                best[end] = best[start] + 1
    return best[-1]


# ------------------------------------------------------------- the schedule

# (qubits, blocks, layer, segment, log2 of a tile's rows, sector bits)
SCHEDULES = [(8, 16, 'chain', 2, 4, 2), (9, 18, 'random', 3, 5, 1),
             (10, 40, 'random', 2, 4, 2), (12, 24, 'chain', 3, 6, 2),
             (18, 17, 'chain', 8, 12, 1), (20, 19, 'chain', 9, 13, 2),
             (20, 40, 'random', 9, 13, 2), (24, 23, 'chain', 9, 13, 2),
             (23, 46, 'random', 9, 12, 1)]


@pytest.mark.parametrize('forward', [False, True], ids=['vjp', 'forward'])
@pytest.mark.parametrize('n,k,layer,seg,log_rows,low', SCHEDULES)
def test_global_schedule_runs_every_gate_on_the_segment(n, k, layer, seg,
                                                        log_rows, low,
                                                        forward):
    """Replayed as the forward pass runs it (each pass in order from its
    own start permutation) or as the vjp's walk does (last pass first, each
    backward from its end permutation, each swap its own inverse), the
    table meets every block once, in the template's order or in reverse,
    with its legs on segment bits where its qubits lie (both passes run the
    one table of the blocks alone: the surface round is a product state,
    written by the forward pass and contracted by the vjp); every swap
    exchanges a segment bit with a higher bit of the tile; the sector bits
    (0 ... low - 1) lie in the tile of every pass, so that its loads and
    stores read whole 32-byte sectors, and at both ends of a pass its row
    bits 0 ... min(FIXED_BITS, seg) - 1 hold the tile's lowest address bits
    in order, so that a thread copies two neighbouring amplitudes; the walk
    ends each pass where it started; each pass's gates are the range it
    names; the passes are as few as any cut of the blocks into runs whose
    bits fit a tile allows."""
    _, placements = placements_of(n, k, layer, seed=n + k)
    table, offsets, ranges = rk.global_schedule(n, placements, seg, log_rows,
                                                low)
    bits = rk.gate_bits(n, placements)
    fixed = min(rk.FIXED_BITS, seg)
    seen = []
    passes = list(zip(passes_of(table, offsets), ranges))
    for (start, ops), (jlo, jhi) in passes if forward else passes[::-1]:
        assert sorted(start) == list(range(n))
        tile = set(start[:log_rows])
        assert set(range(low)) <= tile
        held = list(start) if forward else end_of(start, ops)
        for ends in (start, held):
            assert ends[:fixed] == sorted(tile)[:fixed]
        mine = []
        for j, a, b, _ in ops if forward else ops[::-1]:
            if j < 0:
                assert j == -1 and 0 <= a < seg and a < b < log_rows
                held[a], held[b] = held[b], held[a]
                continue
            mine.append(int(j))
            legs = (a,) if j < n else (a, b)
            assert all(leg < seg for leg in legs)
            assert tuple(held[leg] for leg in legs) == bits[j]
        assert set(held[:log_rows]) == tile  # the swaps stay in the tile
        if not forward:
            assert held == start
        assert mine == list(range(jlo, jhi + 1))[::1 if forward else -1]
        seen += mine
    order = list(range(n, len(bits)))
    assert seen == (order if forward else order[::-1])
    assert len(ranges) == fewest_passes(bits, order, log_rows, low)


def test_global_schedule_pass_counts():
    """The passes at the GHZ-20 ladder (k = 19) and at a deep random
    template (20 qubits, k = 40 random pairs), on the float32 plans' tiles
    at the blocks an SM the wrapper picks for the template
    (uk.global_per_sm: two blocks an SM, on tiles of 2^12 rows in the vjp
    and 2^13 in the forward pass, where they make no more passes than one,
    on 2^13 and 2^14): printed with both choices' counts, and bounded by
    what this schedule gives. Both passes schedule the blocks alone (the
    vjp contracts the surface round), so the vjp cuts as the forward pass
    does."""
    counts, choices = {}, {}
    for name, layer, k in (('ghz20_ladder', 'chain', 19),
                           ('random_k40', 'random', 40)):
        _, placements = placements_of(20, k, layer, seed=20 + k)
        for vjp in (False, True):
            what = (name, 'vjp' if vjp else 'forward')
            p = uk.plan(20, k, NBA, 0, vjp, placements=placements)
            _, offsets, _ = rk.global_schedule(
                20, placements, p['segment'], p['log_rows'],
                rk.sector_bits(F32))
            counts[what] = len(offsets) - 1
            choices[what] = {}
            for per_sm in (1, 2):
                g = uk.global_plan(20, k, NBA, vjp, F32, per_sm)
                choices[what][per_sm] = (g['log_rows'], len(
                    rk.global_schedule(20, placements, g['segment'],
                                       g['log_rows'],
                                       rk.sector_bits(F32))[2]))
            assert counts[what] == min(c for _, c in choices[what].values())
    print('global row tiles, passes at 20 qubits in float32:', counts,
          '(log2 rows, passes) by blocks an SM:', choices)
    assert counts[('ghz20_ladder', 'forward')] <= 2
    assert counts[('ghz20_ladder', 'vjp')] <= 2
    assert counts[('random_k40', 'forward')] <= 6
    assert counts[('random_k40', 'vjp')] <= 5


def address_rule(n, log_rows, held, t, i):
    """The address and the tile row of tile t's i-th amplitude in address
    order under the permutation `held` (row bit v holding address bit
    held[v]), by the rule PR 21's kernels applied bit by bit
    (global_address, global_base): the tile's address bits in increasing
    order, each with its row bit, and the global bits held[log_rows:]
    set by t's bits. i: an array."""
    bits = sorted(held[:log_rows])
    addr = np.zeros_like(i)
    row = np.zeros_like(i)
    for u, b in enumerate(bits):
        on = (i >> u) & 1
        addr |= on << b
        row |= on << held.index(b)
    for k in range(n - log_rows):
        addr |= ((t >> k) & 1) << held[log_rows + k]
    return addr, row


def map_shapes():
    """(n, placements, segment, log_rows, low) of every pass table: PLAIN's
    shapes in both dtypes' sector bits, and GLOBAL_UNITARY's rows at the
    wrapper's plans of both passes."""
    out = []
    for n, log_rows, seg, layer, *_ in PLAIN:
        _, placements = placements_of(n, 2 * n, layer, seed=5 * n + log_rows)
        for low in (1, 2):
            out.append((n, placements, seg, log_rows, low))
    for n, k, rot, _, dname, _, _, _, *layer in chip_smoke.GLOBAL_UNITARY:
        dtype = getattr(torch, dname)
        placements = tuple(tuple(p) for p in all_placements(
            chip_smoke.shape_layers(n, k, layer)))
        for vjp in (False, True):
            p = uk.plan(n, k, num_block_angles('cp', rot), 0, vjp, dtype,
                        placements=placements)
            if p['design'] == 'global_rows':
                out.append((n, placements, p['segment'], p['log_rows'],
                            rk.sector_bits(dtype)))
    return out


def test_copy_tables_follow_the_address_rule():
    """Every pass's copy tables (kernels/rows.py:global_maps, what a block
    reads in place of the bit loop), at both ends of the pass: tile t's
    i-th amplitude lies at base(t) | addr(i) on row row(i), the pairs the
    bit-by-bit rule gives, in increasing address order; row(i) holds that
    address under the pass's permutation (the plain emulation's rule,
    ``addresses``); and i, i + 1 for even i lie on neighbouring rows and
    addresses (a thread's 16-byte copy). Every tile of the PLAIN shapes
    and of GLOBAL_UNITARY's rows with up to 256 tiles; the first, second,
    last and 16 seeded tiles of the others."""
    rng = np.random.default_rng(23)
    for n, placements, seg, log_rows, low in map_shapes():
        table, offsets, _ = rk.global_schedule(n, placements, seg, log_rows,
                                               low)
        maps = rk.global_maps(n, placements, seg, log_rows, low)
        assert maps.shape == (len(offsets) - 1, rk.MAP_INTS)
        tiles = 1 << (n - log_rows)
        some = np.arange(tiles) if tiles <= 256 else np.unique(np.concatenate(
            [[0, 1, tiles - 1], rng.integers(0, tiles, 16)]))
        i = np.arange(1 << log_rows)
        for m, ends in zip(maps.astype(np.int64),
                           rk.pass_ends(table, offsets)):
            for at, held in enumerate(ends):
                rows = m[512 * at + (i & 127)] | m[512 * at + 128 + (i >> 7)]
                addr = m[512 * at + 256 + (i & 127)] | \
                    m[512 * at + 384 + (i >> 7)]
                base = m[1024 + 256 * at + (some & 127)] | \
                    m[1024 + 256 * at + 128 + (some >> 7)]
                full = addresses(n, log_rows, held).numpy()
                assert np.all(np.diff(addr) > 0)
                assert np.all(rows[1::2] == rows[::2] + 1)
                assert np.all(addr[1::2] == addr[::2] + 1)
                for t, b in zip(some, base):
                    want_addr, want_row = address_rule(n, log_rows, held,
                                                       int(t), i)
                    assert np.array_equal(b | addr, want_addr)
                    assert np.array_equal(rows, want_row)
                    assert np.array_equal(full[(int(t) << log_rows) + rows],
                                          b | addr)


def test_global_schedule_refuses_a_tile_too_small():
    with pytest.raises(ValueError, match='holds no gate'):
        rk.global_schedule(8, placements_of(8, 4)[1], 2, 3, 2)
    with pytest.raises(ValueError, match='holds no two-qubit gate'):
        rk.global_schedule(8, placements_of(8, 4)[1], 1, 4, 2)


# ------------------------------------------------------------- plain torch

def addresses(n, log_rows, held):
    """(tiles, 2^log_rows) addresses of the rows t 2^log_rows + e under the
    permutation `held` (row bit v holds address bit held[v])."""
    rows = np.arange(1 << n)
    addr = np.zeros_like(rows)
    for v in range(n):
        addr |= ((rows >> v) & 1) << held[v]
    return torch.as_tensor(addr)


def run_ops(x, ops, gates, n, log_rows):
    """The pass's ops on the rows x (every tile at once: its swaps and
    gates lie below log_rows)."""
    for j, a, b, _ in ops:
        if j < 0:
            one = np.arange(1 << n)
            one = one[((one >> a) & 1) == 1]
            one = one[((one >> b) & 1) == 0]
            other = one ^ (1 << a) ^ (1 << b)
            x = x.clone()
            x[one], x[other] = x[other].clone(), x[one].clone()
        else:
            x = apply(x, gates[j], (a,) if j < n else (a, b))
    return x


def global_forward(n, gates, placements, seg, log_rows, low):
    """The column the forward pass's passes leave in device memory, as
    forward_global_kernel writes it: the first pass from the surface
    round's product state in its start permutation (row_product), every
    other from the column gathered by its start permutation; each pass's
    ops on every tile, then a scatter by its end permutation."""
    table, offsets, _ = rk.global_schedule(n, placements, seg, log_rows, low)
    rows = torch.arange(1 << n)
    col = None
    for p, (held, ops) in enumerate(passes_of(table, offsets)):
        if p == 0:
            x = torch.ones(1 << n, dtype=gates[0].dtype)
            for v, bit in enumerate(held):
                x = x * gates[n - 1 - bit][(rows >> v) & 1, 0]
        else:
            x = col[addresses(n, log_rows, held)]
        x = run_ops(x, ops, gates, n, log_rows)
        col = torch.empty_like(x)
        col[addresses(n, log_rows, end_of(held, ops))] = x
    return col


def tile_order_sum(shares):
    """The sum over tiles (the first axis) in vjp_global_sum_kernel's
    order: 8 runs (or as many as there are tiles) of consecutive tiles,
    each in tile order, then the runs in order."""
    tiles = shares.shape[0]
    count = min(8, tiles)
    runs = []
    for r in range(count):
        s = shares[r * tiles // count]
        for t in range(r * tiles // count + 1, (r + 1) * tiles // count):
            s = s + shares[t]
        runs.append(s)
    out = runs[0]
    for s in runs[1:]:
        out = out + s
    return out


def surface_shares(n, gates, y, held, log_rows):
    """Each tile's share of each surface gate's cotangent, (n, tiles, 2, 2),
    as vjp_global_kernel's last launch forms it (surface_contract): M's
    rows y under the first pass's start permutation `held`, the factors a_q
    = the first column of surface gate q; for qubit q on row bit v,
    Gbar_q[r][0] = c sum over the tile's rows e with e_v = r of M[e] times
    the factors of its other row bits, c the product of the global bits'
    factors at the tile's index; for qubit q on a global bit, c without
    its own factor times the whole sum, in its entry for the tile's value
    of the bit."""
    tiles = 1 << (n - log_rows)
    e = np.arange(1 << log_rows)
    w = [gates[n - 1 - held[v]][:, 0] for v in range(n)]

    def factors(skip):
        out = torch.ones(1 << log_rows, dtype=y.dtype)
        for v in range(log_rows):
            if v != skip:
                out = out * w[v][torch.as_tensor((e >> v) & 1)]
        return out

    out = torch.zeros((n, tiles, 2, 2), dtype=y.dtype)
    for t in range(tiles):
        m = y[t << log_rows:(t + 1) << log_rows]
        glob = [w[log_rows + i][(t >> i) & 1] for i in range(n - log_rows)]
        c = torch.prod(torch.stack(glob)) if glob else torch.ones(
            (), dtype=y.dtype)
        for v in range(log_rows):
            f = m * factors(v)
            for r in (0, 1):
                out[n - 1 - held[v], t, r, 0] = c * f[
                    torch.as_tensor((e >> v) & 1 == r)].sum()
        total = (m * factors(-1)).sum()
        for i in range(n - log_rows):
            others = [g for k, g in enumerate(glob) if k != i]
            ci = torch.prod(torch.stack(others)) if others else torch.ones(
                (), dtype=y.dtype)
            out[n - 1 - held[log_rows + i], t, (t >> i) & 1, 0] = ci * total
    return out


def global_vjp(n, gates, placements, u, m, seg, log_rows, low):
    """The gates' cotangents as vjp_global_kernel and vjp_global_sum_kernel
    form them: the passes last first, A and M gathered by each pass's end
    permutation, its ops backward on every tile (A rewound, M pulled back,
    each gate's cotangent sum M[p] A[k] over its groups taken tile by
    tile), A and M scattered by its start permutation, but after the first
    pass the surface round's cotangents contracted from M tile by tile
    (surface_shares); then each gate's tiles' shares summed in the
    kernel's fixed order."""
    table, offsets, _ = rk.global_schedule(n, placements, seg, log_rows, low)
    tiles = 1 << (n - log_rows)
    col_a, col_m = u, m
    gbar = [None] * len(gates)
    for p, (held, ops) in reversed(list(enumerate(passes_of(table,
                                                            offsets)))):
        at = addresses(n, log_rows, end_of(held, ops))
        x, y = col_a[at], col_m[at]
        for j, a, b, _ in ops[::-1]:
            if j < 0:
                x, y = (run_ops(z, [(j, a, b, 0)], gates, n, log_rows)
                        for z in (x, y))
                continue
            legs = (a,) if j < n else (a, b)
            G = gates[j]
            x = apply(x, G.conj().T, legs)
            rows = torch.as_tensor(group_rows(1 << n, legs))
            outer = y[rows][:, None, :] * x[rows][None, :, :]
            shares = torch.zeros((tiles,) + outer.shape[:2], dtype=x.dtype)
            shares.index_add_(0, rows[0] >> log_rows, outer.permute(2, 0, 1))
            gbar[j] = tile_order_sum(shares)
            y = apply(y, G.T, legs)
        if p == 0:
            for q, share in enumerate(surface_shares(n, gates, y, held,
                                                     log_rows)):
                gbar[q] = tile_order_sum(share)
        at = addresses(n, log_rows, held)
        col_a, col_m = torch.empty_like(x), torch.empty_like(y)
        col_a[at], col_m[at] = x, y
    return gbar


def global_state_loss_and_grad(n, ent, rot, placements, angles, target, seg,
                               log_rows, low):
    """(column, state loss, angle gradients) of one restart through the
    global row tiles' schedules in plain torch: the forward pass's column,
    the loss 1 - |<t|psi>|^2, M = -conj(s) conj(t), the vjp's cotangents,
    and the angle gradients by the factored algebra (sim/adjoint.py, the
    kernels' angle_grads)."""
    gates = gate_matrices(n, ent, rot, placements, angles)
    x = global_forward(n, gates, placements, seg, log_rows, low)
    t = torch.as_tensor(target).to(x.dtype)
    s = (t.conj() * x).sum()
    loss = 1 - s.abs() ** 2
    gbar = global_vjp(n, gates, placements, x, -s.conj() * t.conj(), seg,
                      log_rows, low)
    nba = num_block_angles(ent, rot)
    grads = [adjoint.surface_vjp(angles[3 * q:3 * q + 3], gbar[q])
             for q in range(n)]
    grads += [adjoint.block_vjp(ent, rot,
                                angles[3 * n + nba * b:3 * n + nba * (b + 1)],
                                gbar[n + b]) for b in range(len(placements))]
    return x, loss, torch.cat(grads)


def plain_state_loss_and_grad(n, ent, rot, pl, angles, target, dtype):
    """(column, loss, angle gradients) of the plain path: sim.batched's
    state column under autograd."""
    obj = tbt.make_batched_regloss(n, ent, rot, pl,
                                   tapi.LossSpec('state', target=target),
                                   dtype=dtype)
    a = angles[:, None].clone().requires_grad_(True)
    _, loss = obj(a)
    (grad,) = torch.autograd.grad(loss.sum(), a)
    u = tbt.build_unitary_batched(n, ent, rot, pl, angles[:, None].detach(),
                                  columns=[0], dtype=dtype)
    return u.reshape(-1), loss.detach()[0], grad[:, 0]


# (qubits, log2 of a tile's rows, segment, layer, entangler, rotations)
PLAIN = [(8, 4, 2, 'chain', 'cp', 'xyz'), (9, 5, 3, 'random', 'cp', 'xyz'),
         (10, 4, 2, 'random', 'cz', 'xz'), (11, 6, 3, 'chain', 'cx', 'xyz'),
         (12, 6, 4, 'random', 'cp', 'y'), (12, 5, 2, 'chain', 'cp', 'xz')]


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
@pytest.mark.parametrize('n,log_rows,seg,layer,ent,rot', PLAIN)
def test_global_schedule_in_plain_torch_matches_the_plain_path(
        n, log_rows, seg, layer, ent, rot, dtype):
    """The schedules applied as the kernels apply them give the plain
    path's column, state loss and angle gradients (seeded numpy angles and
    target, k = 2n blocks, the dtype's sector bits), within TOL of the
    dtype, the gradients scaled by max(1, |gradient|)."""
    k = 2 * n
    pl, placements = placements_of(n, k, layer, seed=5 * n + log_rows)
    rng = np.random.default_rng(200 * n + seg)
    P = 3 * n + num_block_angles(ent, rot) * k
    angles = torch.tensor(rng.uniform(0, 2 * np.pi, P), dtype=dtype)
    target = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    target /= np.linalg.norm(target)
    x, loss, grad = global_state_loss_and_grad(
        n, ent, rot, placements, angles, target, seg, log_rows,
        rk.sector_bits(dtype))
    px, ploss, pgrad = plain_state_loss_and_grad(n, ent, rot, pl, angles,
                                                 target, dtype)
    tol = TOL[dtype]
    assert (x - px).abs().max().item() <= tol
    assert abs(loss.item() - ploss.item()) <= tol
    assert ((grad - pgrad).abs() / pgrad.abs().clamp(min=1.0)).max().item() \
        <= tol


def test_global_schedule_matches_the_jax_objective():
    """One shape against the JAX package's state objective on the CPU in
    float64 (x64): 10 qubits on tiles of 2^5 rows and segments of 2^3,
    GHZ-10 (normalized in float64) on the chain at k = 20; the loss and
    every angle gradient within 1e-12."""
    n, k, seg, log_rows = 10, 20, 3, 5
    pl, placements = placements_of(n, k)
    angles = np.random.default_rng(10).uniform(0, 2 * np.pi, 3 * n + NBA * k)
    target = chip_smoke.ghz(n).astype(np.complex128)
    target /= np.linalg.norm(target)
    _, loss, grad = global_state_loss_and_grad(
        n, 'cp', 'xyz', placements, torch.tensor(angles), target, seg,
        log_rows, rk.sector_bits(F64))
    jloss, jgrad = jax_state_objective(n, pl, angles[:, None], target, True)
    assert abs(loss.item() - jloss[0]) <= 1e-12
    np.testing.assert_allclose(grad.numpy(), jgrad[:, 0], rtol=0, atol=1e-12)


def jax_state_objective(n, pl, angles, target, f64):
    """(loss (B,), gradient (P, B)) of the JAX package's state objective
    (reversible builder, column 0) on the CPU, under x64 for float64."""
    with jax.enable_x64(f64):
        jconfig.set_precision(f64)
        try:
            jf = jbt.make_batched_regloss(
                n, 'cp', 'xyz', pl, japi.LossSpec('state', target=target),
                reversible=True)
            a = jnp.asarray(angles)
            _, jloss = jf(a)
            jgrad = jax.grad(lambda v: jf(v)[1].sum())(a)
            return np.asarray(jloss), np.asarray(jgrad)
        finally:
            jconfig.set_precision(False)


# float32: both packages sum 2^18 amplitudes' products in float32, in
# their own orders (each within about 1e-6 of float64 here); float64: two
# derivations of one function
WIDE_TOL = {F32: 1e-5, F64: 1e-12}


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_plain_state_objective_at_18_qubits_matches_the_jax_package(dtype):
    """At 18 qubits, past the row tiles, the port's plain state objective
    (the path of a CPU tensor, and the reference of phase 23 on the card)
    and its gradient against the JAX package's on the same numpy inputs:
    B = 2 seeded restarts on the GHZ ladder's template (chain, k = 17),
    target GHZ-18 in the dtype's complex type; loss and gradient within
    WIDE_TOL, the gradient scaled by max(1, |gradient|)."""
    n, k = 18, 17
    pl, _ = placements_of(n, k)
    angles = np.random.default_rng(18).uniform(0, 2 * np.pi,
                                               (3 * n + NBA * k, 2))
    f64 = dtype == F64
    target = chip_smoke.ghz(n).astype(np.complex128 if f64 else np.complex64)
    obj = tbt.make_batched_regloss(n, 'cp', 'xyz', pl,
                                   tapi.LossSpec('state', target=target),
                                   dtype=dtype)
    a = torch.tensor(angles, dtype=dtype, requires_grad=True)
    _, loss = obj(a)
    (grad,) = torch.autograd.grad(loss.sum(), a)
    jloss, jgrad = jax_state_objective(n, pl, angles.astype(
        np.float64 if f64 else np.float32), target, f64)
    tol = WIDE_TOL[dtype]
    np.testing.assert_allclose(loss.detach().numpy(), jloss, rtol=0,
                               atol=tol)
    g = grad.numpy()
    assert (np.abs(g - jgrad) / np.maximum(np.abs(jgrad), 1.0)).max() <= tol


# ------------------------------------------------------------ the plans

@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_global_plans_past_the_row_tiles(dtype):
    """From one qubit past the row tiles (18 in float32, 17 in float64) to
    the cap (24, 23), at the GHZ ladder's depth and deeper: the vjp runs on
    the global row tiles, and the forward pass too wherever no cluster
    holds it (at the first width, 18 in float32 and 17 in float64, a
    cluster of 16 still does at these depths, as before); a pass's block
    fits, its tile at least 2^GLOBAL_ROWS_MIN rows
    with the sector bits, 16 warps in float32 and 8 in float64 (segments
    of 2^9 rows in the vjp), a ring of at least one gate in the vjp and
    none in the forward pass; its tiles the rest of the column."""
    first, cap = (18, 24) if dtype == F32 else (17, 23)
    assert uk.row_tiles_max(dtype) == first - 1
    assert uk.MAX_QUBITS[dtype]['column'] == cap == uk.GLOBAL_MAX_QUBITS[dtype]
    for n in range(first, cap + 1):
        for k in (n - 1, 2 * n, 120):
            for vjp in (False, True):
                p = uk.plan(n, k, NBA, 0, vjp, dtype)
                c = uk.cluster_plan(n, k, NBA, 0, vjp, dtype)
                if c is not None:
                    assert not vjp and n == first and c == 16 and \
                        p['design'] == 'rows'
                    continue
                assert p['design'] == 'global_rows'
                assert p == uk.plan(n, k, NBA, 0, vjp, dtype,
                                    placements=((0, 1),) * k)
                assert uk.kernel_name(p['design'], vjp, n,
                                      p['blocks_per_restart'], True) == \
                    ('ansatz_vjp_global_rows' if vjp else
                     'ansatz_forward_global_rows')
                for per_sm in (1, 2):
                    g = uk.global_plan(n, k, NBA, vjp, dtype, per_sm)
                    warps = (16 if dtype == F32 else 8) // per_sm
                    if per_sm == p['per_sm']:
                        assert p['smem_bytes'] == g['smem_bytes']
                        assert p['blocks_per_restart'] == g['tiles']
                    assert g['smem_bytes'] <= uk.GLOBAL_SMEM[per_sm]
                    assert g['tiles'] == 1 << (n - g['log_rows'])
                    assert g['log_rows'] >= uk.GLOBAL_ROWS_MIN
                    assert (g['warps'], g['threads']) == (warps, 32 * warps)
                    assert g['segment'] == \
                        g['log_rows'] - warps.bit_length() + 1
                    assert (g['ring'] >= 1) if vjp else (g['ring'] == 0)
                    assert g['sum_smem_bytes'] <= 48 * 1024
                    G, P = n + k, 3 * n + NBA * k
                    assert g['gates_smem_bytes'] == (64 * G + 4 * P) * (
                        8 if dtype == F64 else 4)
                    work = uk.global_work(n, k, NBA, vjp, dtype, per_sm)
                    assert work % 4 == 0 and 0 <= work - (
                        ((4 << n) + 32 * G * g['tiles'] if vjp else 0) +
                        32 * G + 2 * P) < 4
                    if vjp and k == n - 1:
                        assert g['segment'] == 9
    for vjp in (False, True):
        assert uk.plan(cap + 1, cap, NBA, 0, vjp, dtype) is None


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_global_rows_take_no_earlier_shape(dtype):
    """Every plan that held a shape before keeps it: the global row tiles
    take one column only past the row tiles' widest and where no cluster
    holds the pass; below that nothing changes (every width and depth
    walked), and the whole unitary never goes there."""
    top = uk.row_tiles_max(dtype)
    for n in range(2, top + 1):
        for k in range(0, 700, 7):
            for vjp in (False, True):
                assert uk.global_log(n, k, NBA, vjp, dtype) is None
                p = uk.plan(n, k, NBA, 0, vjp, dtype)
                assert p is None or p['design'] == 'rows'
    for n in range(top + 1, uk.GLOBAL_MAX_QUBITS[dtype] + 1):
        for k in range(0, 400, 13):
            for vjp in (False, True):
                if uk.cluster_plan(n, k, NBA, 0, vjp, dtype) is not None:
                    assert uk.global_log(n, k, NBA, vjp, dtype) is None
                assert uk.plan(min(n, 13), k, NBA, min(n, 13), vjp,
                               dtype) is None or \
                    uk.plan(min(n, 13), k, NBA, min(n, 13), vjp,
                            dtype)['design'] != 'global_rows'


def test_global_kernel_names_follow_the_library_order():
    assert uk.KERNELS[19:] == ('ansatz_forward_global_rows',
                               'ansatz_vjp_global_rows',
                               'ansatz_vjp_global_sum', 'ansatz_global_gates')
    assert uk.DESIGNS['global_rows'] == 3
    assert uk.kernel_name('global_rows', True, 20, 128, True) == \
        uk.KERNELS[20]


def test_phase_23_rows_hold_the_main_paths_shapes():
    """Every row of chip_smoke.py's GLOBAL_UNITARY runs its vjp on the
    global row tiles, on the tiles the row names; phase 23 (c)'s two main
    paths' shapes (the GHZ ladder's template, k = n - 1, at 20 qubits in
    float32 and 18 in float64, both passes on the global row tiles) are
    among the rows, so that phase 23 (a) holds both kernels at them against
    the plain builder; and the kernels that phase 23 times and counts are
    named in KERNELS."""
    held = set()
    for n, k, rot, _, dname, passes, cols, blocks, *layer in \
            chip_smoke.GLOBAL_UNITARY:
        dtype = getattr(torch, dname)
        nba = num_block_angles('cp', rot)
        assert cols == [0] and passes == (False, True)
        placements = tuple(tuple(p) for p in all_placements(
            chip_smoke.shape_layers(n, k, layer)))
        p = uk.plan(n, k, nba, 0, True, dtype, placements=placements)
        assert (p['design'], p['blocks_per_restart']) == \
            ('global_rows', blocks)
        if not layer and uk.plan(n, k, nba, 0, False,
                                 dtype)['design'] == 'global_rows':
            held.add((n, k, dname))
    assert {(20, 19, 'float32'), (18, 17, 'float64')} <= held
    for parts in chip_smoke.GLOBAL_PARTS.values():
        assert all(part in uk.KERNELS for part, _ in parts)


# ---------------------------------------------- the route and the refusals

def _state_objective(n, dtype):
    """A state objective as the API makes it (not plain) on the n-qubit
    chain at k = 2: on the card its unitary would come from the unitary
    kernels."""
    obj = chip_smoke.make_objective(n, 2, chip_smoke.ghz(n), 0.0,
                                    kind='state', dtype=dtype)[0]
    obj.plain = False
    return obj


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_route_takes_a_wide_state_to_the_unitary_kernels(dtype):
    """``route`` sends a state one qubit past the fused kernel's row tiles
    (18 qubits in float32, 17 in float64) to the unitary kernels, whose
    global row tiles hold it; the fused kernel's own check refuses it,
    naming that route. ``torch.device('cuda')`` needs no card: the route is
    chosen from the plans alone."""
    cuda = torch.device('cuda')
    n = sk.MAX_QUBITS[dtype]['state']
    assert sk.route(_state_objective(n, dtype), cuda) == 'fused'
    obj = _state_objective(n + 1, dtype)
    assert sk.route(obj, cuda) == 'unitary'
    cap = uk.MAX_QUBITS[dtype]['column']
    with pytest.raises(ValueError, match=(
            rf"2 to {n} qubits for a 'state' loss in {dtype}, got {n + 1}: "
            rf".*sweep\(\) takes it to the unitary kernels, whose global "
            rf"row tiles hold one column to {cap} qubits$")):
        sk._check_objective(obj)
    with pytest.raises(ValueError, match='no plan of the fused kernel holds'
                       '.*plain=True'):
        plain = _state_objective(n + 1, dtype)
        plain.plain = True
        sk.route(plain, cuda)


class _Wide:
    """The attributes of a state objective that ``route`` and the fused
    kernel's check read, at a width whose 2^n target is not made."""

    def __init__(self, n, dtype):
        self.num_qubits, self.dtype = n, dtype
        self.entangling_gate_name, self.rotation_gates = 'cp', 'xyz'
        self.placements = fill_layers(chain_layer(n), 2)
        self.unitary_loss_func = tapi.LossSpec('state', target=np.ones(2))
        self.has_penalty, self.plain = False, False


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_a_state_past_the_cap_is_refused(monkeypatch, dtype):
    """One qubit past the cap (25 in float32, 24 in float64): ``route``
    leaves the state to the fused kernel, whose check refuses it with the
    cap's reason, and the unitary kernels' shape check (its capability
    check answered as a Hopper's) refuses one column with its reason
    before it loads or builds anything."""
    cap = uk.MAX_QUBITS[dtype]['column']
    obj = _Wide(cap + 1, dtype)
    assert sk.route(obj, torch.device('cuda')) == 'fused'
    with pytest.raises(ValueError, match=(
            rf"got {cap + 1}: .*hold one column to {cap} qubits, and past "
            rf"that cap .*GLOBAL_MAX_QUBITS\) no plan holds it$")):
        sk._check_objective(obj)
    monkeypatch.setattr(torch.cuda, 'get_device_capability',
                        lambda device=None: (9, 0))
    with pytest.raises(ValueError, match=(
            rf'2 to {cap} qubits for one column in {dtype}, got {cap + 1}: '
            rf'above that past the global row tiles\' cap')):
        uk._Shape(cap + 1, 'cp', 'xyz', ((0, 1),), [0], 2,
                  torch.device('cuda'), True, dtype)


def test_a_call_past_free_memory_is_refused():
    """What a call of the global row tiles allocates is checked against the
    card's free bytes before anything is allocated or launched: the error
    names the bytes needed and the bytes free."""
    uk.check_memory(1 << 30, 1 << 30, 24, 8, False)
    with pytest.raises(ValueError, match=(
            r'need 137438953472 bytes of device memory for U and its '
            r'workspace of 1024 restarts at 24 qubits .* the card has '
            r'85899345920 bytes free')):
        uk.check_memory(1024 * (8 << 24), 80 << 30, 24, 1024, False)
    with pytest.raises(ValueError, match="for the vjp's workspace of 2"):
        uk.check_memory(2, 1, 20, 2, True)

"""The whole unitary's kernels on csrc/tiles.cuh's warps (csrc/unitary.cu):
the vjp on a cluster at 7 and 8 qubits (vjp_kernel) and the forward
pass on the column tiles from 7 qubits (forward_tiles_kernel), without a
card.

  * the layouts and threads (kernels/tiles.py: warp_smem_bytes,
    columns_a_warp, warps_a_column, cluster_ring) at every 7-13 qubit shape
    the plans take in both precisions: every layout fits a block, the vjp
    keeps the cluster plan's blocks, and the forward pass keeps the tiles
    the old plans gave it, apart from the listed edge shapes where the
    layout's padding (a row a column) does not fit and it takes twice as
    many;
  * the layouts term by term at the main paths' shapes;
  * the vjp's order of sums, in plain torch: each lane's share of a gate's
    cotangent over its warp's columns and its steps, then the warp's lanes
    in the butterfly's tree, then the ring's slots in warp order, then the
    cluster's blocks in rank order; the angle gradients from them by the
    factored algebra (sim/adjoint.py) against jax.vjp of the JAX package's
    builder on the CPU, at 7 and 8 qubits, k <= 4, B = 2;
  * the forward pass's tiles, in plain torch: the surface round's product
    state on each tile's columns of the identity, the blocks' chain, the
    tile held column-major with a column stride of d + 1 and stored into
    U's rows by the kernel's index map, against the JAX package's U at 7,
    8 and 9 qubits.

The kernels themselves run only on a card: chip_smoke.py phases 12, 19 and
21 hold them against the plain builder there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import config as jconfig
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch.kernels import tiles as tk
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.sim import adjoint
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles
from cpflow_tpu_torch.topology import chain_layer, fill_layers
from test_torch_vjp_tiles import apply, gate_matrices, group_rows

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
LIMIT = 232448  # shared memory one block may use on sm_90
NBA = num_block_angles('cp', 'xyz')
NBAS = sorted({num_block_angles(e, r) for e in ('cp', 'cz', 'cx')
               for r in ('xyz', 'xz', 'y')})
TOL = {F32: 1e-5, F64: 1e-12}


# ------------------------------------------------------------- the plans

def _old_blocks(n, k, nba, vjp, dtype):
    """The blocks a restart the plans gave the whole unitary before the
    warps' kernels: the fewest whose make_layout fits (a cluster of at most
    16 for the vjp, any number of tiles for the forward pass)."""
    most = n if not vjp else min(n, 4)
    for j in range(most + 1):
        if uk.smem_bytes(n, k, nba, n, vjp, 1 << j, dtype) <= LIMIT:
            return 1 << j
    return None


# forward-pass shapes at which the padded layout does not fit the old
# tiles, so the plan takes twice as many: their count at each (dtype, n)
# over the block templates of NBAS and every k a plan takes, and the first
# of them (nba, k) at each
FORWARD_EDGES = {
    (F32, 7): (65, (2, 653)), (F32, 8): (35, (2, 655)),
    (F32, 9): (16, (2, 656)), (F32, 10): (8, (2, 656)),
    (F32, 11): (3, (2, 655)), (F32, 12): (4, (2, 654)), (F32, 13): (0, None),
    (F64, 7): (31, (2, 323)), (F64, 8): (13, (2, 324)),
    (F64, 9): (9, (2, 323)), (F64, 10): (5, (2, 646)),
    (F64, 11): (2, (3, 298)), (F64, 12): (1, (3, 297))}


@pytest.mark.parametrize('n', range(7, 14))
@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_warp_layouts_fit_and_keep_the_plans_blocks(n, dtype):
    """At n qubits, every block template's angle count and every k until
    no plan holds: the forward pass runs on the column tiles, its layout
    fits, its tiles are the old plan's or, at the listed edges only, twice
    as many; the vjp on a cluster keeps the cluster plan's blocks, its ring
    of 1 to 16 gates fits; the warps own whole columns or a column whole
    warps."""
    if dtype == F64 and n == 13:
        assert uk.plan(13, 0, NBA, 13, True, F64) is None
        return
    edges = []
    for nba in NBAS:
        for k in range(4000):
            fwd = uk.plan(n, k, nba, n, False, dtype)
            vjp = uk.plan(n, k, nba, n, True, dtype)
            if fwd is None and vjp is None:
                break
            for p, is_vjp in ((fwd, False), (vjp, True)):
                if p is None or p['design'] == 'tiles' and is_vjp:
                    continue
                c = p['blocks_per_restart']
                w = (1 << n) // c
                threads, warps = p['threads'], p['threads'] // 32
                assert threads == tk.tile_threads(n, w, dtype) <= \
                    tk.TILE_THREADS[dtype]
                cw, gw = p['columns_per_warp'], p['warps_per_column']
                assert cw * warps == w if w > warps else gw * w == warps
                assert p['smem_bytes'] == tk.warp_smem_bytes(
                    n, k, nba, w, is_vjp, p['ring'], dtype) <= LIMIT
                old = _old_blocks(n, k, nba, is_vjp, dtype)
                if is_vjp:
                    assert p['design'] == 'rows' and c == old > 1
                    assert p['ring'] == tk.cluster_ring(n, k, nba, w,
                                                        dtype) >= 1
                else:
                    assert p['design'] == 'tiles' and p['ring'] == 0
                    if c != old:
                        assert c == 2 * old and tk.warp_smem_bytes(
                            n, k, nba, w * 2, False, 0, dtype) > LIMIT
                        edges.append((nba, k))
    count, first = FORWARD_EDGES[(dtype, n)]
    assert len(edges) == count and (edges[0] if edges else None) == first


# the main paths' shapes: (n, k, dtype, vjp, blocks a restart, columns a
# warp, warps a column, ring, bytes)
PATHS = [(7, 24, F32, True, 2, 4, 1, 16, 175068),    # UNITARY_TIMING 7q
         (8, 16, F32, True, 8, 2, 1, 16, 172128),    # UNITARY_TIMING 8q
         (8, 9, F64, True, 16, 2, 1, 16, 175144),    # phase 19 (c)
         (7, 24, F32, False, 1, 8, 1, 0, 138332),
         (8, 16, F32, False, 4, 4, 1, 0, 136288),
         (8, 9, F64, False, 8, 4, 1, 0, 138024),     # phase 19 (c)
         (9, 8, F64, False, 32, 2, 1, 0, 137672),    # phase 21 (d)
         (9, 4, F32, False, 16, 2, 1, 0, 133652),    # phase 21 (f)
         (10, 9, F32, False, 64, 1, 1, 0, 134748),   # phase 21 (d)
         (13, 2, F32, False, 4096, 1, 8, 0, 133644)]


@pytest.mark.parametrize('n,k,dtype,vjp,blocks,cw,gw,ring,nbytes', PATHS,
                         ids=[f'{s[0]}q-k{s[1]}-{str(s[2])[6:]}-'
                              f'{"vjp" if s[3] else "forward"}'
                              for s in PATHS])
def test_warp_layout_at_the_paths_shapes(n, k, dtype, vjp, blocks, cw, gw,
                                         ring, nbytes):
    """The plan at each main path's shape and its layout term by term: A
    (and M), w columns of 2^n + 1 amplitudes, aligned to 16 bytes; the
    gates (16 complex); the vjp's gbar (32 reals a gate) and ring (32 reals
    a warp a gate); the cos and sin (2 P reals) and P reals of angles."""
    p = uk.plan(n, k, NBA, n, vjp, dtype)
    assert p['design'] == ('rows' if vjp else 'tiles')
    assert (p['blocks_per_restart'], p['columns_per_warp'],
            p['warps_per_column'], p['ring'], p['smem_bytes']) == \
        (blocks, cw, gw, ring, nbytes)
    f = 2 if dtype == F64 else 1
    w, warps = (1 << n) // blocks, tk.TILE_THREADS[dtype] // 32
    G, P = n + k, 3 * n + NBA * k
    want = -(-w * (2 ** n + 1) * 8 * f * (2 if vjp else 1) // 16) * 16 + \
        128 * f * G + 12 * f * P
    if vjp:
        want += 128 * f * G + warps * ring * 128 * f
    assert nbytes == want <= LIMIT
    if vjp:
        assert blocks == uk.cluster_plan(n, k, NBA, n, True, dtype)


# --------------------------------------------------- the vjp, in its order

def _butterfly(x):
    """The sum over a warp's 32 lanes (the first axis of x) in the tree of
    columns.cuh's reduce_step: lanes that differ in lane bit 16 first, then
    8, 4, 2, 1."""
    for step in (16, 8, 4, 2, 1):
        lanes = np.arange(x.shape[0])
        x = x[lanes[(lanes & step) == 0]] + x[lanes[(lanes & step) != 0]]
    return x[0]


def cluster_vjp(n, ent, rot, placements, angles, u, ubar, blocks, dtype):
    """One restart's angle gradients as vjp_kernel forms them on a
    cluster of `blocks` blocks: A = U and M = conj(Ubar) / 2, the walk last
    gate first (A rewound by G^dag, M pulled back by G^T); each gate's
    cotangent share M[p] A[k] of every amplitude group of every column,
    summed by each lane over its warp's columns in order and its steps
    (group g on lane g mod 32, step g / 32), over the warp's lanes in the
    butterfly's tree, over the block's warps in warp order (the ring's
    flush), over the blocks in rank order (cluster_sum); then the angle
    gradients from each gate's cotangent by the factored algebra."""
    d = 1 << n
    w = d // blocks
    warps = tk.TILE_THREADS[dtype] // 32
    cw = tk.columns_a_warp(n, w, dtype)
    assert cw * warps == w  # every warp owns whole columns at these shapes
    gates = gate_matrices(n, ent, rot, placements, angles)
    legs = [(n - 1 - q,) for q in range(n)] + \
        [(n - 1 - a, n - 1 - b) for a, b in placements]
    A, M = u.clone(), ubar.conj() / 2
    gbar = [None] * len(gates)
    for j in range(len(gates) - 1, -1, -1):
        rows = group_rows(d, legs[j])
        D, groups = rows.shape
        A = apply(A, gates[j].conj().T, rows)
        # (columns, groups, D, D) of every group's share
        share = torch.einsum('pgc,kgc->cgpk', M[rows], A[rows])
        # (blocks, warps, cw, steps, lanes, D, D)
        share = share.reshape(blocks, warps, cw, groups // 32, 32, D, D)
        lane = torch.zeros(blocks, warps, 32, D, D, dtype=share.dtype)
        for c in range(cw):
            for step in range(groups // 32):
                lane = lane + share[:, :, c, step]
        slot = _butterfly(lane.permute(2, 0, 1, 3, 4))  # (blocks, warps)
        block = torch.zeros_like(slot[:, 0])
        for wp in range(warps):
            block = block + slot[:, wp]
        total = torch.zeros_like(block[0])
        for rank in range(blocks):
            total = total + block[rank]
        gbar[j] = total
        M = apply(M, gates[j].T, rows)
    nba = num_block_angles(ent, rot)
    grads = [adjoint.surface_vjp(angles[3 * q:3 * q + 3], gbar[q])
             for q in range(n)]
    grads += [adjoint.block_vjp(ent, rot,
                                angles[3 * n + nba * b:3 * n + nba * (b + 1)],
                                gbar[n + b]) for b in range(len(placements))]
    return torch.cat(grads)


def _jax_unitary_and_vjp(n, k, angles, g, dtype):
    """U (d, d, B) and the gradient of L = Re sum conj(g) U through the JAX
    package's builder, in dtype's precision."""
    pl = fill_layers(chain_layer(n), k)
    d, B = 1 << n, angles.shape[1]
    f64 = dtype == F64
    with jax.enable_x64(f64):
        jconfig.set_precision(f64)
        try:
            cdt = jnp.complex128 if f64 else jnp.complex64
            rdt = jnp.float64 if f64 else jnp.float32

            def loss(a):
                u = jbt.build_unitary_batched(n, 'cp', 'xyz', pl, a)
                return jnp.real(jnp.conj(jnp.asarray(g, cdt)) *
                                u.reshape(d, d, B)).sum()

            a = jnp.asarray(angles, rdt)
            u = np.asarray(jbt.build_unitary_batched(n, 'cp', 'xyz', pl, a)
                           ).reshape(d, d, B)
            grad = None
            if g is not None:
                _, pull = jax.vjp(loss, a)
                (grad,) = pull(jnp.ones((), rdt))
                grad = np.asarray(grad)
        finally:
            jconfig.set_precision(False)
    return u, grad


@pytest.mark.parametrize('n,k', [(7, 3), (8, 2)])
@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_cluster_walk_matches_jax_vjp(n, k, dtype):
    """n qubits on the chain at k 'xyz' CP blocks, B = 2, on the cluster of
    the vjp's plan (7q: 2 blocks in float32, 4 in float64; 8q: 8 and 16):
    seeded numpy angles and a complex cotangent g of U; the gradient of
    L = Re sum conj(g) U from the cluster's walk in its order of sums (on
    the JAX package's U, as the vjp loads what the forward pass stored)
    against jax.vjp of L through cpflow_tpu's builder, within TOL, scaled
    by max(1, |gradient|)."""
    B = 2
    blocks = uk.plan(n, k, NBA, n, True, dtype)['blocks_per_restart']
    assert blocks == {(7, F32): 2, (7, F64): 4, (8, F32): 8,
                      (8, F64): 16}[(n, dtype)]
    placements = tuple(map(tuple, all_placements(
        fill_layers(chain_layer(n), k))))
    d, P = 1 << n, 3 * n + NBA * k
    rng = np.random.default_rng(19 + n)
    angles = rng.uniform(0, 2 * np.pi, (P, B))
    g = rng.normal(size=(d, d, B)) + 1j * rng.normal(size=(d, d, B))
    u, jgrad = _jax_unitary_and_vjp(n, k, angles, g, dtype)
    cdtype = torch.complex128 if dtype == F64 else torch.complex64
    for b in range(B):
        grad = cluster_vjp(n, 'cp', 'xyz', placements,
                           torch.tensor(angles[:, b], dtype=dtype),
                           torch.tensor(u[:, :, b], dtype=cdtype),
                           torch.tensor(g[:, :, b], dtype=cdtype), blocks,
                           dtype)
        want = torch.tensor(jgrad[:, b], dtype=F64)
        err = ((grad.double() - want).abs() / want.abs().clamp(min=1.0))
        assert err.max().item() <= TOL[dtype], (b, err.max().item())


# ------------------------------------------ the forward pass, tile by tile

def tiled_forward(n, ent, rot, placements, angles, tiles, dtype):
    """One restart's U (d, d) as forward_tiles_kernel forms it: tile t's
    columns C = t w + c of the identity after the surface round, entry r
    the product over the qubits of G_q[r's bit, C's bit] on row bit
    n - 1 - q, the factors of the lane's own row bits (the low log2 gL of
    them, gL the lanes of a column: tiles.cuh's warp_columns) first; the
    blocks' chain on them; the tile held column-major with a column stride
    of d + 1 (entry c (d + 1) + r); and the store (tiled_store)."""
    d = 1 << n
    w = d // tiles
    S = d + 1
    gates = gate_matrices(n, ent, rot, placements, angles)
    r = np.arange(d)[:, None]
    buffers = []
    for t in range(tiles):
        C = t * w + np.arange(w)[None, :]
        x = torch.ones(d, w, dtype=gates[0].dtype)
        for s in range(n):  # the lane's own bits s < lg first, as the kernel
            x = x * gates[n - 1 - s][torch.as_tensor((r >> s) & 1),
                                     torch.as_tensor((C >> s) & 1)]
        for b, (q0, q1) in enumerate(placements):
            x = apply(x, gates[n + b], group_rows(d, (n - 1 - q0,
                                                      n - 1 - q1)))
        tile = torch.zeros(w * S, dtype=x.dtype)
        tile[(torch.arange(w)[None, :] * S + torch.arange(d)[:, None])
             .reshape(-1)] = x.reshape(-1)
        buffers.append(tile)
    return tiled_store(n, w, buffers, 16 if dtype == F64 else 8).reshape(d, d)


def tiled_store(n, w, buffers, size):
    """U (d d,) from every tile's column-major buffer as forward_tiles_kernel
    stores it, complex values of `size` bytes: each block writes the runs
    of w of each row of its tile, e -> row e >> log2 w, column e mod w;
    where w values are under a 32-byte sector, the cluster of the 2^lp
    tiles that fill one stores together, the block of rank rho writing rows
    rho d / 2^lp ... of all their columns, reading each from its tile's
    buffer (store_pairs_log). Every entry must be written once."""
    d, S, lw = 1 << n, (1 << n) + 1, w.bit_length() - 1
    lp = 0
    while (w << lp) * size < 32:
        lp += 1
    out = torch.zeros(d * d, dtype=buffers[0].dtype)
    written = torch.zeros(d * d, dtype=torch.int64)
    for t, buf in enumerate(buffers):
        rank, lr, ls = t & ((1 << lp) - 1), n - lp, lw + lp
        e = torch.arange(1 << (lr + ls))
        rr, cc = e >> ls, e & ((1 << ls) - 1)
        at = (t - rank) * w + ((rank << lr) + rr) * d + cc
        for q in range(1 << lp):  # the cluster's tile t - rank + q
            pick = (cc >> lw) == q
            out[at[pick]] = buffers[t - rank + q][
                (cc[pick] & (w - 1)) * S + (rank << lr) + rr[pick]]
            written[at[pick]] += 1
    assert bool((written == 1).all())
    return out


@pytest.mark.parametrize('n,w,size', [(5, 1, 8), (5, 2, 8), (5, 4, 8),
                                      (5, 1, 16), (5, 2, 16), (6, 16, 8)])
def test_tiled_store_writes_every_entry_once_in_whole_sectors(n, w, size):
    """The store's index map on random tile buffers: every entry of U is
    written once, with its tile's entry (column t w + c, row r at
    c (d + 1) + r), and each block's consecutive threads write runs of at
    least 32 bytes of a row (1, 2 and 4 columns in float: clusters of 4, 2
    and 1 tiles; 1 and 2 in double: 2 and 1)."""
    d, S = 1 << n, (1 << n) + 1
    rng = np.random.default_rng(n + w + size)
    buffers = [torch.as_tensor(rng.normal(size=w * S)) for _ in range(d // w)]
    got = tiled_store(n, w, buffers, size).reshape(d, d)
    for t, buf in enumerate(buffers):
        for c in range(w):
            assert torch.equal(got[:, t * w + c], buf[c * S:c * S + d])
    lp = 0
    while (w << lp) * size < 32:
        lp += 1
    assert (w << lp) * size >= 32 and (lp == 0) == (w * size >= 32)


@pytest.mark.parametrize('n,k', [(7, 4), (8, 3), (9, 2)])
@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_tiled_forward_matches_jax_unitary(n, k, dtype):
    """n qubits on the chain at k 'xyz' CP blocks, B = 2, on the forward
    pass's tiles of the plan (7q: 1 tile in float32, 2 in float64; 8q: 4
    and 8; 9q: 16 and 32): the tiles' product state, chain and store
    against the JAX package's U, within TOL in every entry."""
    B = 2
    w, tiles = uk.tile_plan(n, k, NBA, n, False, dtype)
    assert tiles == {(7, F32): 1, (7, F64): 2, (8, F32): 4, (8, F64): 8,
                     (9, F32): 16, (9, F64): 32}[(n, dtype)]
    placements = tuple(map(tuple, all_placements(
        fill_layers(chain_layer(n), k))))
    rng = np.random.default_rng(190 + n)
    angles = rng.uniform(0, 2 * np.pi, (3 * n + NBA * k, B))
    u, _ = _jax_unitary_and_vjp(n, k, angles, None, dtype)
    for b in range(B):
        got = tiled_forward(n, 'cp', 'xyz', placements,
                            torch.tensor(angles[:, b], dtype=dtype), tiles,
                            dtype)
        err = (got - torch.tensor(u[:, :, b])).abs().max().item()
        assert err <= TOL[dtype], (b, err)

"""The unitary vjp's column tiles as redesigned for Hopper (csrc/unitary.cu,
the column tiles section, on csrc/tiles.cuh): the plan, the layouts, the
workspace, and the walk by tiles and segments in plain torch.

  * the vjp's tile plan keeps its tiles a restart at every depth and
    template (the fewest whose make_layout fits, the first tile kernels'
    rule); its added test, that the tile kernel's own layout fits with a
    warp for every column, never decides; MAX_QUBITS is unchanged;
  * the tile kernel's threads and shared bytes, the prologue's and the sum
    kernel's bytes and the workspace a restart at chip_smoke.py's
    NINE_UNITARY rows, as the Python mirrors compute them (the card holds
    the mirrors against the library, chip_smoke.unitary_plan);
  * a plain-torch model of the walk as the kernels split it: A = U and
    M = conj(Ubar) / 2 rewound and pulled back gate by gate, each tile's
    share of each gate's cotangent, the shares summed in the kernels'
    order (past 32 tiles each segment's 32 in tile order, then the
    segments'; sum_fixed's four running sums), the angle gradients by the
    factored algebra (sim/adjoint.py) against jax.vjp of the JAX
    package's builder on the CPU, at 9 qubits, small k, B = 2: within 1e-5
    in float32 and 1e-12 in float64, scaled by max(1, |gradient|).

The kernels themselves run only on a card: chip_smoke.py phase 21 (b)
holds them against the plain builder there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cpflow_tpu import config as jconfig
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch.kernels import tiles as tk
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.sim import adjoint
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles
from cpflow_tpu_torch.topology import chain_layer, fill_layers

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
LIMIT = 232448  # shared memory one block may use on sm_90
NBA = num_block_angles('cp', 'xyz')
NBAS = sorted({num_block_angles(e, r) for e in ('cp', 'cz', 'cx')
               for r in ('xyz', 'xz', 'y')})
TOL = {F32: 1e-5, F64: 1e-12}


def ins0(x, s):
    return ((x >> s) << (s + 1)) | (x & ((1 << s) - 1))


# ------------------------------------------------------------- the plans

def _fewest_tiles(n, k, nba, dtype):
    """The first tile kernels' plan: the fewest tiles whose make_layout
    fits, where no cluster holds the whole unitary."""
    if uk.cluster_plan(n, k, nba, n, True, dtype) is not None:
        return None
    for j in range(n + 1):
        if uk.smem_bytes(n, k, nba, n, True, 1 << j, dtype) <= LIMIT:
            return 1 << (n - j), 1 << j
    return None


@pytest.mark.parametrize('n', range(8, 14))
@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_vjp_tile_plan_keeps_its_tiles_and_the_kernels_fit(n, dtype):
    """At n qubits, every k until no plan holds, every block template's
    angle count: the vjp's tiles are the first tile kernels' (the fewest
    whose make_layout fits); where it takes the shape the tile kernel's
    layout fits with a warp for every column (its threads a multiple of a
    warp a column), the prologue's and the sum kernel's layout fits, and
    the workspace a restart is a whole number of 16-byte units."""
    taken = 0
    for nba in NBAS:
        for k in range(3000):
            want = _fewest_tiles(n, k, nba, dtype)
            assert uk.tile_plan(n, k, nba, n, True, dtype) == want, (n, k)
            if want is None:
                if uk.cluster_plan(n, k, nba, n, True, dtype) is None:
                    break
                continue
            w, tiles = want
            threads = tk.tile_threads(n, w, dtype)
            assert 32 * w <= threads <= tk.TILE_THREADS[dtype]
            assert threads % (32 * w) == 0
            assert tk.tile_smem_bytes(n, k, w, dtype) <= LIMIT
            assert tk.sum_smem_bytes(n, k, nba, dtype) <= LIMIT
            real = 8 if dtype == F64 else 4
            assert tk.vjp_workspace(n, k, nba, tiles, dtype) * real % 16 == 0
            taken += 1
    assert (taken > 0) == (n <= (13 if dtype == F32 else 12))
    assert uk.MAX_QUBITS == {F32: {'unitary': 13, 'column': 24},
                             F64: {'unitary': 12, 'column': 23}}


# NINE_UNITARY's vjp rows: (n, k, dtype, columns a tile, tiles, threads,
# tile kernel's bytes, the prologue's and sum kernel's bytes, workspace
# reals a restart)
NINE = [(9, 10, F32, 16, 32, 512, 166824, 6416, 20260),
        (9, 10, F64, 8, 64, 256, 169256, 12832, 40932),
        (10, 12, F32, 8, 128, 512, 167104, 7456, 93864),
        (10, 12, F64, 4, 256, 256, 169920, 14912, 186792),
        (11, 12, F32, 4, 512, 512, 167176, 7760, 389596),
        (11, 12, F64, 2, 1024, 256, 170120, 15520, 778202),
        (12, 2, F64, 1, 4096, 256, 167712, 8768, 1892964),
        (13, 2, F32, 1, 8192, 512, 166040, 4688, 4055884)]


@pytest.mark.parametrize('n,k,dtype,w,tiles,threads,nbytes,sum_bytes,work',
                         NINE, ids=[f'{s[0]}q-{str(s[2])[6:]}' for s in NINE])
def test_vjp_tile_layout_at_nine_unitary_shapes(n, k, dtype, w, tiles,
                                                threads, nbytes, sum_bytes,
                                                work):
    """The vjp's launch at each NINE_UNITARY row on the tiles it names: the
    tile kernel 16 warps a block in float32 and 8 in float64, A and M
    2 w (2^n + 1) complex, the gates, the ring, s's slots, the mbarrier and
    the row bits (tiles.cuh); the prologue and the sum the gates, their
    cotangents, the gradient, the angles and their cos and sin; the
    workspace the gates, the cos and sin, the tiles' shares, the segments'
    sums and counts."""
    rows = {(s[0], s[1], s[4]): s[7] for s in chip_smoke.NINE_UNITARY}
    assert rows[(n, k, str(dtype)[6:])] == tiles
    assert uk.tile_plan(n, k, NBA, n, True, dtype) == (w, tiles)
    p = uk.plan(n, k, NBA, n, True, dtype)
    assert (p['design'], p['threads'], p['smem_bytes'],
            p['blocks_per_restart']) == ('tiles', threads, nbytes, tiles)
    assert tk.tile_threads(n, w, dtype) == threads
    assert tk.tile_smem_bytes(n, k, w, dtype) == nbytes <= LIMIT
    assert 2 * nbytes > LIMIT  # one block an SM
    f = 2 if dtype == F64 else 1
    G, P = n + k, 3 * n + NBA * k
    assert nbytes == -(-2 * w * (2 ** n + 1) * 8 * f // 16) * 16 + \
        128 * f * G + (32 * 16 + 2) * (threads // 32) * 4 * f + 16 + 8 * G
    assert tk.sum_smem_bytes(n, k, NBA, dtype) == sum_bytes == \
        4 * f * (64 * G + 4 * P)
    segments = tiles // 32 if tiles > 32 else 0
    end = 32 * G * (1 + tiles + segments) + 2 * P + -(-4 * segments //
                                                       (4 * f))
    assert tk.vjp_workspace(n, k, NBA, tiles, dtype) == work == \
        -(-end // (4 // f)) * (4 // f)


# --------------------------------------------------------- the walk, tiled

def gate_matrices(n, ent, rot, placements, angles):
    """Each gate's matrix from a (P,) angle vector, as the kernels build
    them: the surface gates' 2x2, then the blocks' 4x4."""
    nba = num_block_angles(ent, rot)
    out = [adjoint.surface_matrix_and_grads(angles[3 * q:3 * q + 3])[0]
           for q in range(n)]
    for b in range(len(placements)):
        a = angles[3 * n + nba * b:3 * n + nba * (b + 1)]
        out.append(adjoint.block_matrix_and_grads(ent, rot, a)[0])
    return out


def group_rows(d, legs):
    """(D, d / D) rows of each amplitude group of a gate on row bits legs
    (first leg the high bit of p)."""
    groups = np.arange(d >> len(legs))
    if len(legs) == 1:
        base = ins0(groups, legs[0])
        return torch.as_tensor(np.stack([base, base | 1 << legs[0]]))
    lo, hi = sorted(legs)
    base = ins0(ins0(groups, lo), hi)
    return torch.as_tensor(np.stack(
        [base | (p >> 1) << legs[0] | (p & 1) << legs[1] for p in range(4)]))


def apply(x, G, rows):
    """x <- G x on the gate's rows of every column of x (d, C)."""
    x = x.clone()
    x[rows] = torch.einsum('pk,kgc->pgc', G, x[rows])
    return x


def sum_fixed(values):
    """csrc/tiles.cuh's sum_fixed over the first axis of `values`: four
    running sums over every fourth value, then (s0 + s1) + (s2 + s3)."""
    s = [torch.zeros_like(values[0]) for _ in range(4)]
    if len(values) < 4:
        for q in range(len(values)):
            s[q] = s[q] + values[q]
    else:
        for q in range(0, len(values), 4):
            for i in range(4):
                s[i] = s[i] + values[q + i]
    return (s[0] + s[1]) + (s[2] + s[3])


def tiled_vjp(n, ent, rot, placements, angles, u, ubar, tiles):
    """One restart's angle gradients as the column tiles' kernels form
    them: A = U, M = conj(Ubar) / 2, the walk last gate first (A rewound by
    G^dag, each gate's cotangent sum M[p] A[k] over its groups, M pulled
    back by G^T), each column's share summed into its tile's, the tiles'
    shares added in the kernels' order, and the angle gradients from each
    gate's cotangent by the factored algebra."""
    d = 1 << n
    w = d // tiles
    gates = gate_matrices(n, ent, rot, placements, angles)
    legs = [(n - 1 - q,) for q in range(n)] + \
        [(n - 1 - a, n - 1 - b) for a, b in placements]
    A, M = u.clone(), ubar.conj() / 2
    gbar = [None] * len(gates)
    for j in range(len(gates) - 1, -1, -1):
        rows = group_rows(d, legs[j])
        A = apply(A, gates[j].conj().T, rows)
        per_column = torch.einsum('pgc,kgc->cpk', M[rows], A[rows])
        shares = per_column.reshape(tiles, w, *per_column.shape[1:]).sum(1)
        if tiles > tk.TILE_SEGMENT:  # the last tile of each segment's sum
            shares = torch.stack([sum_fixed(shares[s:s + tk.TILE_SEGMENT])
                                  for s in range(0, tiles, tk.TILE_SEGMENT)])
        gbar[j] = sum_fixed(shares)
        M = apply(M, gates[j].T, rows)
    nba = num_block_angles(ent, rot)
    grads = [adjoint.surface_vjp(angles[3 * q:3 * q + 3], gbar[q])
             for q in range(n)]
    grads += [adjoint.block_vjp(ent, rot,
                                angles[3 * n + nba * b:3 * n + nba * (b + 1)],
                                gbar[n + b]) for b in range(len(placements))]
    return torch.cat(grads)


# (dtype, tiles): the plans' at 9q k = 4 (32 tiles of 16 columns in
# float32, 64 of 8 in float64: two segments), and 512 tiles of one column
# (16 segments) in float32, 128 of 4 in float64
WALKS = [(F32, None), (F64, None), (F32, 512), (F64, 128)]


@pytest.mark.parametrize('dtype,tiles', WALKS,
                         ids=['float32-plan', 'float64-plan',
                              'float32-512-tiles', 'float64-128-tiles'])
def test_tiled_walk_matches_jax_vjp(dtype, tiles):
    """9 qubits on the chain at k = 4 'xyz' CP, B = 2: seeded numpy angles
    and a complex cotangent g of U; the gradient of L = Re sum conj(g) U
    from the tiled walk (on the JAX package's U, as the vjp loads what the
    forward pass stored) against jax.vjp of L through cpflow_tpu's
    builder, within TOL, scaled by max(1, |gradient|)."""
    n, k, B = 9, 4, 2
    if tiles is None:
        tiles = uk.tile_plan(n, k, NBA, n, True, dtype)[1]
        assert tiles == (32 if dtype == F32 else 64)
    pl = fill_layers(chain_layer(n), k)
    placements = tuple(map(tuple, all_placements(pl)))
    d, P = 1 << n, 3 * n + NBA * k
    rng = np.random.default_rng(18 + tiles)
    angles = rng.uniform(0, 2 * np.pi, (P, B))
    g = rng.normal(size=(d, d, B)) + 1j * rng.normal(size=(d, d, B))
    f64 = dtype == F64
    with jax.enable_x64(f64):
        jconfig.set_precision(f64)
        try:
            cdt = jnp.complex128 if f64 else jnp.complex64

            def loss(a):
                u = jbt.build_unitary_batched(n, 'cp', 'xyz', pl, a)
                return jnp.real(jnp.conj(jnp.asarray(g, cdt)) *
                                u.reshape(d, d, B)).sum()

            a = jnp.asarray(angles, jnp.float64 if f64 else jnp.float32)
            u = np.asarray(jbt.build_unitary_batched(n, 'cp', 'xyz', pl, a)
                           ).reshape(d, d, B)
            _, pull = jax.vjp(loss, a)
            (jgrad,) = pull(jnp.ones((), jnp.float64 if f64 else
                                     jnp.float32))
            jgrad = np.asarray(jgrad)
        finally:
            jconfig.set_precision(False)
    cdtype = torch.complex128 if f64 else torch.complex64
    for b in range(B):
        grad = tiled_vjp(n, 'cp', 'xyz', placements,
                         torch.tensor(angles[:, b], dtype=dtype),
                         torch.tensor(u[:, :, b], dtype=cdtype),
                         torch.tensor(g[:, :, b], dtype=cdtype), tiles)
        want = torch.tensor(jgrad[:, b], dtype=F64)
        err = ((grad.double() - want).abs() / want.abs().clamp(min=1.0))
        assert err.max().item() <= TOL[dtype], (b, err.max().item())

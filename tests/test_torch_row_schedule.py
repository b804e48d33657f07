"""The row tiles' schedule of bit swaps (kernels/rows.py, csrc/rows.cuh).

sweep_rows_kernel and vjp_rows_kernel hold a state split by rows over a
cluster of blocks, each block's rows owned by its warps, and run every gate
on a warp's own segment of rows; the wrapper hands them a table of gates
and bit swaps computed on the host. Here, on the CPU:

  * the table puts every gate's legs on segment bits when it runs, each
    swap exchanges a segment bit with a higher one, and the bits the chain
    leaves are in natural order (the table ends on the identity);
  * the table applied in plain torch, as the kernels apply it (a simulated
    cluster of 2 to 16 blocks, the tile swaps and the exchanges between
    blocks indexed as rows.cuh indexes them, the walk backward over the
    table with each gate's cotangent summed from the state before it),
    gives the plain path's state, loss and angle gradients at 8 to 10
    qubits with segments down to 4 rows: within 1e-5 in float32 and 1e-12
    in float64 (two derivations of one function, rounded in another
    order);
  * one shape against the JAX package's objective in float64, within
    1e-12;
  * the Python mirrors of the kernels' row plans (threads, warps, segment,
    ring, shared bytes) at chip_smoke.py phase 20's shapes and wherever a
    plan splits a state.

The kernels themselves run only on a card: chip_smoke.py phase 20 holds
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

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
LIMIT = 232448  # shared memory one block may use on sm_90
NBA = num_block_angles('cp', 'xyz')
TOL = {F32: 1e-5, F64: 1e-12}


def ins0(x, s):
    return ((x >> s) << (s + 1)) | (x & ((1 << s) - 1))


def placements_of(n, k, layer=None):
    pl = fill_layers(layer or chain_layer(n), k)
    return pl, tuple(tuple(p) for p in all_placements(pl))


def random_pairs(n, k, seed):
    """k blocks on random distinct qubit pairs, either leg order."""
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.choice(n, 2, replace=False))) for _ in range(k)]


# ------------------------------------------------------------- the table

def start_map(table, n):
    """Row bit -> the bit it holds when the chain begins: the table's swaps
    undone from its end, where every bit is on its own row bit."""
    held = list(range(n))
    for j, a, b, _ in table[::-1]:
        if j < 0:
            held[a], held[b] = held[b], held[a]
    return held


SCHEDULES = [(n, k, seg, layer) for n, k, seg, layer in [
    (8, 16, 2, 'chain'), (8, 16, 3, 'random'), (9, 18, 4, 'chain'),
    (9, 40, 2, 'random'), (10, 20, 5, 'chain'), (10, 30, 3, 'random'),
    (14, 28, 9, 'chain'), (17, 34, 9, 'chain'), (12, 424, 7, 'chain'),
    (13, 26, 8, 'random')]]


@pytest.mark.parametrize('n,k,seg,layer', SCHEDULES)
def test_schedule_puts_every_gate_on_the_segment(n, k, seg, layer):
    """Replayed from its start, the table meets every gate, in the
    template's order, with its legs on the segment bits where its qubits
    lie; every swap exchanges a segment bit with a higher bit of the state;
    the chain ends with every bit on its own row bit."""
    placements = tuple(map(tuple, random_pairs(n, k, n + k))) \
        if layer == 'random' else placements_of(n, k)[1]
    table = rk.schedule(n, placements, seg)
    bits = rk.gate_bits(n, placements)
    held = start_map(table, n)
    gates = []
    for j, a, b, _ in table:
        if j < 0:
            assert 0 <= a < seg and a < b < n
            held[a], held[b] = held[b], held[a]
            continue
        gates.append(j)
        legs = (a,) if j < n else (a, b)
        assert all(leg < seg for leg in legs)
        assert tuple(held[leg] for leg in legs) == bits[j]
    assert gates == list(range(len(bits)))
    assert held == list(range(n))


def test_schedule_refuses_a_segment_too_short_for_a_block():
    with pytest.raises(ValueError, match='holds no two-qubit gate'):
        rk.schedule(8, placements_of(8, 4)[1], 1)


# ------------------------------------------------------------- plain torch

def gate_matrices(n, ent, rot, placements, angles):
    """Each gate's matrix from a (P,) angle vector, as the kernels build
    them: the surface gates' 2x2, then the blocks' 4x4 (first leg on the
    high bit)."""
    nba = num_block_angles(ent, rot)
    out = [adjoint.surface_matrix_and_grads(angles[3 * q:3 * q + 3])[0]
           for q in range(n)]
    for b in range(len(placements)):
        a = angles[3 * n + nba * b:3 * n + nba * (b + 1)]
        out.append(adjoint.block_matrix_and_grads(ent, rot, a)[0])
    return out


def group_rows(d, legs):
    """(D, d / D) rows of each amplitude group of a gate on row bits legs
    (first leg the high bit of p), as gates.cuh's group_rows."""
    groups = np.arange(d >> len(legs))
    if len(legs) == 1:
        base = ins0(groups, legs[0])
        return np.stack([base, base | 1 << legs[0]])
    lo, hi = sorted(legs)
    base = ins0(ins0(groups, lo), hi)
    return np.stack([base | (p >> 1) << legs[0] | (p & 1) << legs[1]
                     for p in range(4)])


def apply(x, G, legs):
    """x <- G x on the row bits `legs` of the state x (d,)."""
    rows = torch.as_tensor(group_rows(x.shape[0], legs))
    x = x.clone()
    x[rows] = G @ x[rows]
    return x


def swap_bits(tiles, s, b, log_rows):
    """The swap of row bit s with bit b > s, as rows.cuh's row_swap indexes
    it, on the (c, 2^log_rows) tiles of a simulated cluster: inside every
    block's tile (b < log_rows), or between the blocks that differ in bit
    b - log_rows of their rank, each block taking its half of the pairs."""
    tiles = tiles.clone()
    c = tiles.shape[0]
    if b < log_rows:
        i = np.arange(1 << (log_rows - 2))
        r = ins0(ins0(i, s), b)
        one, other = torch.as_tensor(r | 1 << s), torch.as_tensor(r | 1 << b)
        tiles[:, one], tiles[:, other] = tiles[:, other].clone(), \
            tiles[:, one].clone()
        return tiles
    p, half = b - log_rows, 1 << (log_rows - 2)
    out = tiles.clone()
    for rank in range(c):
        partner, high = rank ^ 1 << p, (rank >> p) & 1
        i = np.arange(high * half, (high + 1) * half)
        r1 = ins0(i, s) | 1 << s
        r0 = r1 ^ 1 << s
        here, there = (r0, r1) if high else (r1, r0)
        out[rank, torch.as_tensor(here)] = tiles[partner,
                                                 torch.as_tensor(there)]
        out[partner, torch.as_tensor(there)] = tiles[rank,
                                                     torch.as_tensor(here)]
    return out


def scheduled_state_loss_and_grad(n, ent, rot, placements, angles, target,
                                  seg, cluster):
    """(state, loss, angle gradients) of the state loss 1 - |<t|psi>|^2 of
    one restart, the chain and the walk run over the row schedule on a
    simulated cluster of `cluster` blocks, as sweep_rows_kernel runs them:
    the chain from e_0 through the table, the loss on the rows in natural
    order, M = -conj(s) conj(t), then the table backward, each gate's
    cotangent Gbar[p, k] = sum M[p] A[k] (A rewound through the gate), and
    the angle gradients from the Gbar by the factored algebra
    (sim/adjoint.py, the kernels' angle_grads)."""
    d, log_rows = 1 << n, n - (cluster.bit_length() - 1)
    table = rk.schedule(n, placements, seg)
    gates = gate_matrices(n, ent, rot, placements, angles)
    cdtype = gates[0].dtype
    x = torch.zeros(d, dtype=cdtype)
    x[0] = 1  # e_0 is row 0 under every permutation
    for j, a, b, _ in table:
        if j < 0:
            x = swap_bits(x.reshape(cluster, -1), a, b, log_rows).reshape(-1)
        else:
            x = apply(x, gates[j], (a,) if j < n else (a, b))
    state = x
    t = torch.as_tensor(target).to(cdtype)
    s = (t.conj() * x).sum()
    loss = 1 - (s.abs() ** 2)
    m = -s.conj() * t.conj()
    gbar = [None] * len(gates)
    for j, a, b, _ in table[::-1]:
        if j < 0:
            x, m = (swap_bits(y.reshape(cluster, -1), a, b, log_rows)
                    .reshape(-1) for y in (x, m))
            continue
        legs = (a,) if j < n else (a, b)
        G = gates[j]
        x = apply(x, G.conj().T, legs)
        rows = torch.as_tensor(group_rows(d, legs))
        gbar[j] = m[rows] @ x[rows].T  # sum over groups of M[p] A[k]
        m = apply(m, G.T, legs)
    nba = num_block_angles(ent, rot)
    grads = [adjoint.surface_vjp(angles[3 * q:3 * q + 3], gbar[q])
             for q in range(n)]
    grads += [adjoint.block_vjp(ent, rot,
                                angles[3 * n + nba * b:3 * n + nba * (b + 1)],
                                gbar[n + b]) for b in range(len(placements))]
    return state, loss, torch.cat(grads)


def plain_state_loss_and_grad(n, ent, rot, pl, angles, target, dtype):
    """(state, loss, angle gradients) of the plain path: sim.batched's
    state column under autograd."""
    obj = tbt.make_batched_regloss(n, ent, rot, pl,
                                   tapi.LossSpec('state', target=target),
                                   dtype=dtype)
    a = angles[:, None].clone().requires_grad_(True)
    reg, loss = obj(a)
    (grad,) = torch.autograd.grad(reg.sum(), a)
    u = tbt.build_unitary_batched(n, ent, rot, pl, angles[:, None].detach(),
                                  columns=[0], dtype=dtype)
    return u.reshape(-1), loss.detach()[0], grad[:, 0]


PLAIN = [(8, 2, 2, 'chain', 'cp', 'xyz'), (8, 16, 2, 'random', 'cp', 'xyz'),
         (9, 4, 3, 'chain', 'cz', 'xz'), (9, 8, 4, 'random', 'cx', 'xyz'),
         (10, 16, 2, 'chain', 'cp', 'xz'), (10, 2, 7, 'random', 'cp', 'xyz'),
         (10, 4, 5, 'chain', 'cz', 'y')]


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
@pytest.mark.parametrize('n,cluster,seg,layer,ent,rot', PLAIN)
def test_schedule_in_plain_torch_matches_the_plain_path(n, cluster, seg,
                                                       layer, ent, rot,
                                                       dtype):
    """The schedule applied as the kernels apply it gives the plain path's
    state, state loss and angle gradients (seeded numpy angles and target,
    k = 2n blocks), within TOL of the dtype, the gradients scaled by
    max(1, |gradient|)."""
    k = 2 * n
    if layer == 'random':
        pl = fill_layers(random_pairs(n, k, 7 * n + cluster), k)
    else:
        pl = fill_layers(chain_layer(n), k)
    placements = tuple(map(tuple, all_placements(pl)))
    rng = np.random.default_rng(100 * n + seg)
    P = 3 * n + num_block_angles(ent, rot) * k
    angles = torch.tensor(rng.uniform(0, 2 * np.pi, P), dtype=dtype)
    target = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    target /= np.linalg.norm(target)
    x, loss, grad = scheduled_state_loss_and_grad(
        n, ent, rot, placements, angles, target, seg, cluster)
    px, ploss, pgrad = plain_state_loss_and_grad(n, ent, rot, pl, angles,
                                                 target, dtype)
    tol = TOL[dtype]
    assert (x - px).abs().max().item() <= tol
    assert abs(loss.item() - ploss.item()) <= tol
    assert ((grad - pgrad).abs() / pgrad.abs().clamp(min=1.0)).max().item() \
        <= tol


def test_schedule_matches_the_jax_objective():
    """One shape against the JAX package's state objective on the CPU in
    float64 (x64): 9 qubits on a simulated cluster of 4, segments of 8
    rows, GHZ-9 (normalized in float64) on the chain at k = 18; the loss
    and every angle gradient within 1e-12."""
    n, k, seg, cluster = 9, 18, 3, 4
    pl, placements = placements_of(n, k)
    P = 3 * n + NBA * k
    angles = np.random.default_rng(9).uniform(0, 2 * np.pi, P)
    target = chip_smoke.ghz(n).astype(np.complex128)
    target /= np.linalg.norm(target)  # as both packages hold it
    _, loss, grad = scheduled_state_loss_and_grad(
        n, 'cp', 'xyz', placements, torch.tensor(angles), target, seg,
        cluster)
    with jax.enable_x64(True):
        jconfig.set_precision(True)
        try:
            jf = jbt.make_batched_regloss(
                n, 'cp', 'xyz', pl, japi.LossSpec('state', target=target),
                reversible=True)
            a = jnp.asarray(angles[:, None])
            _, jloss = jf(a)
            jgrad = jax.grad(lambda v: jf(v)[0].sum())(a)
            jloss, jgrad = float(jloss[0]), np.asarray(jgrad)[:, 0]
        finally:
            jconfig.set_precision(False)
    assert abs(loss.item() - jloss) <= 1e-12
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=0, atol=1e-12)


# ------------------------------------------------------------ the plans

# phase 20's shapes: (qubits, blocks k, dtype, blocks a restart)
PHASE20 = [(14, 28, F32, 2), (15, 30, F32, 4), (16, 32, F32, 8),
           (17, 34, F32, 16), (13, 26, F64, 2), (16, 32, F64, 16)]


@pytest.mark.parametrize('n,k,dtype,c', PHASE20)
def test_row_plans_at_phase_20_shapes(n, k, dtype, c):
    """At the GHZ ladder's depths the sweep's and the vjp's row tiles take
    16 warps of 512 rows in float32 and 8 of 512 in float64, a ring of 16
    gates, and fit a block; the plan (the blocks a restart) is the one it
    was."""
    warps = 16 if dtype == F32 else 8
    for p, plan_bytes in (
            (sk.row_plan(n, k, NBA, dtype),
             sk.smem_bytes(n, k, NBA, 'state', c, dtype)),
            (uk.row_plan(n, k, NBA, dtype),
             uk.smem_bytes(n, k, NBA, 0, True, c, dtype))):
        assert p['cluster'] == c and p['log_rows'] == n - c.bit_length() + 1
        assert (p['warps'], p['threads'], p['segment'], p['ring']) == \
            (warps, 32 * warps, 9, 16)
        real = 8 if dtype == F64 else 4
        # the plan's bytes, its 8 warps' partials out, the ring in
        assert p['smem_bytes'] == plan_bytes - 2 * 256 * real + \
            32 * warps * 16 * real <= LIMIT
    up = uk.plan(n, k, NBA, 0, True, dtype)
    assert (up['threads'], up['blocks_per_restart']) == (32 * warps, c)


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
@pytest.mark.parametrize('n', [8, 9, 10, 11, 12, 13, 14, 17])
def test_row_plan_fits_wherever_a_state_splits(n, dtype):
    """Wherever the sweep's or the vjp's plan splits a state by rows (every
    depth k walked one by one up to the deepest any plan takes), the row
    tiles' launch fits a block, keeps the plan's blocks, holds a ring of
    at least one gate and a segment of at least 4 rows, and
    holds one warp alone where it is shorter than 2^SEGMENT_MIN rows (there
    a two-qubit gate has fewer groups, 2^(segment - 2), than a warp has
    lanes, and the lanes past them idle)."""
    for k in range(0, 700):
        for mirror, c in (
                (sk.row_plan(n, k, NBA, dtype),
                 sk.cluster_plan(n, k, NBA, 'state', dtype)),
                (uk.row_plan(n, k, NBA, dtype),
                 uk.cluster_plan(n, k, NBA, 0, True, dtype))):
            if c is None or c == 1:
                assert mirror is None
                continue
            assert mirror['cluster'] == c
            assert mirror['smem_bytes'] <= LIMIT
            assert mirror['ring'] >= 1 and mirror['segment'] >= 2
            assert mirror['threads'] == 32 * mirror['warps'] <= \
                rk.THREADS[dtype]
            if mirror['segment'] < rk.SEGMENT_MIN:
                assert mirror['warps'] == 1 and \
                    mirror['segment'] == mirror['log_rows']


@pytest.mark.parametrize('name', [s['name'] for s in
                                  chip_smoke.split_edge_shapes()])
def test_phase_20_edge_rows_run_on_the_plans_they_name(name):
    """chip_smoke.py phase 20 (a)'s edge rows: each on the blocks it names,
    with the segment and ring it names (the smallest row tiles, a lane past
    a gate's groups, a ring of one gate)."""
    s = {x['name']: x for x in chip_smoke.split_edge_shapes()}[name]
    dtype = s.get('dtype', F32)
    obj, _ = chip_smoke.shape_objective(s, dtype)
    nb = len(all_placements(obj.placements))
    nba = num_block_angles(obj.entangling_gate_name, obj.rotation_gates)
    p = sk.row_plan(s['n'], nb, nba, dtype)
    assert (p['cluster'], p['segment']) == (s['cluster'], s['segment'])
    if 'ring' in s:
        assert p['ring'] == s['ring']


# ------------------------------------------------ the forward pass's rows

# SPLIT_UNITARY's forward passes: (qubits, k, dtype, blocks, segment), the
# 14q float32 and 13q float64 forward passes on one block (no row tiles)
FORWARD_ROWS = [(14, 28, F32, 1, None), (15, 30, F32, 2, 10),
                (16, 32, F32, 4, 10), (17, 34, F32, 8, 10),
                (13, 26, F64, 1, None), (16, 32, F64, 8, 10)]


@pytest.mark.parametrize('n,k,dtype,c,seg', FORWARD_ROWS)
def test_forward_row_plan_at_split_unitary_shapes(n, k, dtype, c, seg):
    """forward_rows_kernel's launch (row_plan with vjp=False, as
    forward_row_layout lays it out) at chip_smoke.py's SPLIT_UNITARY rows:
    the forward pass on half the vjp's blocks, as before; split by rows,
    16 warps of 1024 rows in float32 and 8 of 1024 in float64, no ring,
    the plan's own layout's bytes, under a block's shared memory."""
    assert [s[:2] + (s[4],) for s in chip_smoke.SPLIT_UNITARY] == \
        [(m, kk, str(dt).split('.')[1]) for m, kk, dt, *_ in FORWARD_ROWS]
    assert uk.cluster_plan(n, k, NBA, 0, False, dtype) == c
    p = uk.row_plan(n, k, NBA, dtype, vjp=False)
    if seg is None:
        assert p is None
        return
    warps = 16 if dtype == F32 else 8
    assert (p['cluster'], p['log_rows'], p['warps'], p['segment'],
            p['ring'], p['threads']) == (c, n - c.bit_length() + 1, warps,
                                         seg, 0, 32 * warps)
    assert p['smem_bytes'] == uk.smem_bytes(n, k, NBA, 0, False, c, dtype) \
        <= LIMIT
    up = uk.plan(n, k, NBA, 0, False, dtype)
    assert (up['threads'], up['smem_bytes'], up['blocks_per_restart']) == \
        (32 * warps, p['smem_bytes'], c)


@pytest.mark.parametrize('n,dtype', [(n, F32) for n in range(8, 18)] +
                         [(n, F64) for n in range(8, 17)])
def test_forward_row_plan_fits_and_keeps_its_blocks(n, dtype):
    """At every depth k up to the deepest any plan takes, wherever the
    forward pass's plan splits a column by rows: the blocks are the
    smallest cluster whose layout (make_layout's, unchanged) fits, the
    row tiles' launch takes that layout's bytes, under a block's shared
    memory, with a warp for every 2^SEGMENT_MIN rows up to the build's
    threads, a segment of at least 4 rows and no ring."""
    for k in range(0, 700):
        c = uk.cluster_plan(n, k, NBA, 0, False, dtype)
        fits = [m for m in uk.CLUSTERS if m <= 1 << (n - 2) and
                uk.smem_bytes(n, k, NBA, 0, False, m, dtype) <= LIMIT]
        assert c == (fits[0] if fits else None)
        p = uk.row_plan(n, k, NBA, dtype, vjp=False)
        if c is None or c == 1:
            assert p is None
            continue
        log_rows = n - c.bit_length() + 1
        assert p['cluster'] == c and p['log_rows'] == log_rows
        assert p['smem_bytes'] == uk.smem_bytes(n, k, NBA, 0, False, c,
                                                dtype) <= LIMIT
        assert p['ring'] == 0 and p['segment'] >= 2
        assert p['threads'] == 32 * p['warps'] == min(
            32 << max(log_rows - rk.SEGMENT_MIN, 0), rk.THREADS[dtype])
        assert p['segment'] == log_rows - p['warps'].bit_length() + 1


@pytest.mark.parametrize('n,k,dtype,c,seg,layer',
                         [s + ('chain',) for s in FORWARD_ROWS
                          if s[4] is not None] +
                         [(10, 16, F32, 4, 3, 'random'),
                          (9, 0, F64, 2, 2, 'chain')])
def test_forward_schedule_puts_every_gate_on_the_segment(n, k, dtype, c, seg,
                                                         layer):
    """The forward pass's table (its own segment; on the chain at k = 2n,
    and on random pairs and with no blocks at all): n start rows, row bit v
    holding a permutation's bit, the first block's bits on the segment;
    then, replayed from that permutation, every block in the template's
    order with its legs on the segment bits where its qubits lie, every
    swap a segment bit with a higher one, no surface gate (the start's
    product state holds the surface round), the chain ending on the
    identity; and fewer swaps than the walk's table."""
    placements = tuple(map(tuple, random_pairs(n, k, n + k))) \
        if layer == 'random' else placements_of(n, k)[1]
    table = rk.schedule(n, placements, seg, forward=True)
    bits = rk.gate_bits(n, placements)
    assert [(int(op[0]), int(op[1]), int(op[3])) for op in table[:n]] == \
        [(-2, v, 0) for v in range(n)]
    held = [int(op[2]) for op in table[:n]]
    assert sorted(held) == list(range(n))
    if k:
        assert set(bits[n]) <= set(held[:seg])
    gates = []
    for j, a, b, _ in table[n:]:
        if j < 0:
            assert j == -1 and 0 <= a < seg and a < b < n
            held[a], held[b] = held[b], held[a]
            continue
        gates.append(j)
        assert a < seg and b < seg
        assert (held[a], held[b]) == bits[j]
    assert gates == list(range(n, len(bits)))
    assert held == list(range(n))
    swaps = int((table[:, 0] == -1).sum())
    assert swaps < int((rk.schedule(n, placements, seg)[:, 0] == -1).sum())


def scheduled_forward_column(n, ent, rot, placements, angles, seg, cluster):
    """Column 0 of the ansatz, the chain run over the forward pass's row
    schedule on a simulated cluster of `cluster` blocks as
    forward_rows_kernel runs it: the surface round's product state from e_0
    in the table's first permutation (rows.cuh's row_product: row bit v's
    factor the first column of the surface gate of the qubit it holds),
    then the table's swaps, inside the tiles or between blocks as rows.cuh
    indexes them, and blocks; the rows in natural order at the end."""
    log_rows = n - (cluster.bit_length() - 1)
    table = rk.schedule(n, placements, seg, forward=True)
    gates = gate_matrices(n, ent, rot, placements, angles)
    rows = torch.arange(1 << n)
    x = torch.ones(1 << n, dtype=gates[0].dtype)
    for v, (_, _, b, _) in enumerate(table[:n]):
        x = x * gates[n - 1 - b][(rows >> v) & 1, 0]
    for j, a, b, _ in table[n:]:
        if j < 0:
            x = swap_bits(x.reshape(cluster, -1), a, b, log_rows).reshape(-1)
        else:
            x = apply(x, gates[j], (a,) if j < n else (a, b))
    return x


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
@pytest.mark.parametrize('n,cluster,seg,layer,ent,rot', PLAIN)
def test_forward_schedule_matches_the_jax_column(n, cluster, seg, layer, ent,
                                                 rot, dtype):
    """The forward pass's chain over the schedule, as the kernel runs it,
    gives the JAX package's column 0 (cpflow_tpu.sim.batched's builder on
    the CPU, under x64 for float64) on seeded numpy angles at k = 2n,
    within TOL of the dtype."""
    k = 2 * n
    if layer == 'random':
        pl = fill_layers(random_pairs(n, k, 7 * n + cluster), k)
    else:
        pl = fill_layers(chain_layer(n), k)
    placements = tuple(map(tuple, all_placements(pl)))
    rng = np.random.default_rng(300 * n + seg)
    P = 3 * n + num_block_angles(ent, rot) * k
    angles = rng.uniform(0, 2 * np.pi, P)
    x = scheduled_forward_column(n, ent, rot, placements,
                                 torch.tensor(angles, dtype=dtype), seg,
                                 cluster)
    f64 = dtype == F64
    with jax.enable_x64(f64):
        jconfig.set_precision(f64)
        try:
            col = jbt.build_unitary_batched(
                n, ent, rot, pl, jnp.asarray(angles[:, None]), columns=[0])
            col = np.asarray(col).reshape(-1)
        finally:
            jconfig.set_precision(False)
    assert np.abs(x.numpy() - col).max() <= TOL[dtype]

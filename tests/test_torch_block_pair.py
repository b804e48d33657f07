"""The pair on one block (csrc/unitary.cu's forward_block_kernel and
vjp_block_kernel, kernel lines ansatz_forward and ansatz_vjp), without a
card.

  * the plans: at every shape where the plan runs the row-split design on
    one block (one column at 2-14 qubits in float32 and 2-13 in float64,
    every depth k until it leaves one block; the whole unitary in the
    windows past the column design's depths below 7 qubits, at every block
    template's angle count), the launch on rows.cuh's warps from the
    mirrors (threads, bytes, warps, segment and ring) fits a block, keeps
    the plan's blocks (one, or for the whole unitary's forward pass the
    plan's c), holds whole columns a warp for the whole unitary, and keeps
    its kernel line;
  * one column's chain and walk over the table of a block (rows.cuh with
    no cluster), applied in plain torch as the kernels apply it
    (tests/test_torch_row_schedule.py's emulation with a cluster of one),
    against the JAX package's state column and the angle gradients of its
    state loss at 2, 4, 7, 9 and 11 qubits;
  * the whole unitary's walk on one block in its order of sums (its
    columns column-major, whole columns a warp's segment; the lanes past a
    gate's amplitude groups idle) against jax.vjp of the JAX package's
    builder at 6q k=400 in float32, k=130 in float64 and 3q k=750, and the
    forward pass on the plan's blocks against the JAX package's U;
  * Synthesize(chain_layer(4), target_state=GHZ-4,
    cp_regularization_func=cp_penalty_L1).static on the CPU against the
    JAX package's same call and seed.

The kernels themselves run only on a card: chip_smoke.py phase 22 holds
them against the plain builder there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import api as japi
from cpflow_tpu import config as jconfig
from cpflow_tpu.ops import penalty as jpenalty
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch import config as tconfig
from cpflow_tpu_torch.kernels import rows as rk
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.ops import penalty as tpenalty
from cpflow_tpu_torch.sim import adjoint
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles
from cpflow_tpu_torch.topology import chain_layer, fill_layers
from test_torch_cluster_vjp import _butterfly
from test_torch_row_schedule import scheduled_state_loss_and_grad
from test_torch_vjp_tiles import apply, gate_matrices, group_rows

import chip_smoke

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
LIMIT = 232448  # shared memory one block may use on sm_90
NBA = num_block_angles('cp', 'xyz')
NBAS = sorted({num_block_angles(e, r) for e in ('cp', 'cz', 'cx')
               for r in ('xyz', 'xz', 'y')})
TOL = {F32: 1e-5, F64: 1e-12}


# ------------------------------------------------------------- the plans

# the qubits at which one column fits one block, by dtype and pass
ONE_BLOCK_COLUMN = {(F32, False): range(2, 15), (F32, True): range(2, 14),
                    (F64, False): range(2, 14), (F64, True): range(2, 13)}


@pytest.mark.parametrize('vjp', [False, True], ids=['forward', 'vjp'])
@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_one_column_on_one_block_fits_and_keeps_its_plan(dtype, vjp):
    """One column ('xyz' CP blocks on the chain, every k until the plan
    leaves one block): the launch on rows.cuh's warps (rows_launch) fits
    a block, with a warp for every 2^7 rows up to the build's threads (one
    warp owning the column at 7 qubits or fewer), a segment of at least 4
    rows, a ring of at least one gate in the vjp and none in the forward
    pass; plan() gives its threads and bytes on one block, the kernel line
    is the pair's, and the qubits that fit one block are the ones they
    were."""
    fits = set()
    for n in range(2, 18):
        for k in range(0, 2000):
            p = uk.plan(n, k, NBA, 0, vjp, dtype)
            if p is None or p['blocks_per_restart'] > 1:
                break
            fits.add(n)
            q = uk.rows_launch(n, k, NBA, 0, vjp, dtype)
            assert p['design'] == 'rows' and uk.row_plan(
                n, k, NBA, dtype, vjp) is None
            assert (q['cluster'], q['log_rows']) == (1, n)
            assert (p['threads'], p['smem_bytes']) == \
                (q['threads'], q['smem_bytes'])
            assert q['threads'] == 32 * q['warps'] <= rk.THREADS[dtype]
            assert q['smem_bytes'] <= LIMIT
            assert q['segment'] == n - (q['warps'].bit_length() - 1) >= 2
            if n <= rk.SEGMENT_MIN:
                assert q['warps'] == 1
            assert (q['ring'] >= 1) if vjp else (q['ring'] == 0)
            assert uk.kernel_name('rows', vjp, n, 1, column=True) == \
                ('ansatz_vjp' if vjp else 'ansatz_forward')
    assert sorted(fits) == list(ONE_BLOCK_COLUMN[(dtype, vjp)])
    assert uk.MAX_QUBITS == {F32: {'unitary': 13, 'column': 24},
                             F64: {'unitary': 12, 'column': 23}}


@pytest.mark.parametrize('n,k,dtype,warps,swaps', [
    (2, 4, F32, 1, False), (7, 14, F32, 1, False), (8, 16, F32, 2, True),
    (13, 48, F32, 16, True), (12, 24, F64, 8, True)])
def test_the_one_block_tables_swap_inside_the_block(n, k, dtype, warps,
                                                    swaps):
    """Both passes' tables for the segment of their one-block plan: every
    gate on segment bits, every swap with a bit of the block (below n, no
    cluster), none where one warp owns the column."""
    placements = tuple(map(tuple, all_placements(
        fill_layers(chain_layer(n), k))))
    for vjp in (False, True):
        q = uk.rows_launch(n, k, NBA, 0, vjp, dtype)
        assert q['warps'] == warps
        table = rk.schedule(n, placements, q['segment'], forward=not vjp)
        body = table[n:] if not vjp else table
        moves = [op for op in body if op[0] < 0]
        assert bool(moves) == swaps
        assert all(0 <= s < q['segment'] <= b < n for _, s, b, _ in moves)


@pytest.mark.parametrize('n', range(2, 7))
@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_whole_unitary_on_the_row_split_plan_fits(n, dtype):
    """The whole unitary past the column design's depths (every block
    template's angle count, every k until no plan holds): its forward pass
    on the row-split plan (on each of the plan's blocks) and its vjp on one
    block run on rows.cuh's warps (rows_launch): the launch fits a block,
    keeps the plan's blocks, gives every warp whole columns (a segment of at
    least n bits, so that the table has no swap), holds a ring of 1 to 16
    gates in the vjp, and keeps its kernel line."""
    seen = {False: 0, True: 0}
    for nba in NBAS:
        for k in range(0, 3000):
            fwd = uk.plan(n, k, nba, n, False, dtype)
            vjp = uk.plan(n, k, nba, n, True, dtype)
            if fwd is None and vjp is None:
                break
            for p, is_vjp in ((fwd, False), (vjp, True)):
                if p is None or p['design'] != 'rows':
                    continue
                c = uk.cluster_plan(n, k, nba, n, is_vjp, dtype)
                assert p['blocks_per_restart'] == c
                if is_vjp and c > 1:  # a cluster (test_torch_cluster_vjp)
                    assert uk.rows_launch(n, k, nba, n, True, dtype) is None
                    continue
                seen[is_vjp] += 1
                q = uk.rows_launch(n, k, nba, n, is_vjp, dtype)
                assert (q['cluster'], q['log_rows']) == \
                    (c, 2 * n - (c.bit_length() - 1))
                assert (p['threads'], p['smem_bytes']) == \
                    (q['threads'], q['smem_bytes'])
                assert q['threads'] == 32 * q['warps'] <= rk.THREADS[dtype]
                assert q['smem_bytes'] <= LIMIT
                assert q['segment'] == \
                    q['log_rows'] - (q['warps'].bit_length() - 1) >= n
                assert (1 <= q['ring'] <= rk.RING_MAX) if is_vjp else \
                    (q['ring'] == 0)
                assert uk.kernel_name('rows', is_vjp, n, c) == \
                    ('ansatz_vjp' if is_vjp else 'ansatz_forward')
    assert seen[False] > 0 and seen[True] > 0


def test_phase_22_rows_take_the_pair():
    """Every row of chip_smoke.py's BLOCK_UNITARY runs each of its passes
    in the row-split design on the pair's kernels, so that phase 22 (a)
    checks and times the pair: on one block, or the forward pass of the
    whole unitary on the blocks the row names (the plan's independent
    blocks); and the rows hold both rotation strings of the whole unitary
    and both of those layouts."""
    kinds = set()
    for n, k, rot, _, dname, passes, cols, blocks in chip_smoke.BLOCK_UNITARY:
        dtype = getattr(torch, dname)
        nba = num_block_angles('cp', rot)
        for vjp in passes:
            p = uk.plan(n, k, nba, 0 if cols else n, vjp, dtype)
            c = 1 if vjp or cols else blocks
            assert (p['design'], p['blocks_per_restart']) == ('rows', c)
            assert uk.kernel_name('rows', vjp, n, c, cols is not None) == \
                ('ansatz_vjp' if vjp else 'ansatz_forward')
        assert blocks == 1 or (cols is None and passes == (False,))
        if cols is None:
            kinds.add((rot, blocks > 1))
    assert kinds == {('y', False), ('xyz', False), ('y', True),
                     ('xyz', True)}


# ---------------------------------------------- one column on one block

def _jax_state_and_grad(n, k, angles, target, dtype):
    """The JAX package's state column (d,) and the loss and angle gradients
    of its state loss 1 - |<t|psi>|^2, in dtype's precision."""
    pl = fill_layers(chain_layer(n), k)
    f64 = dtype == F64
    with jax.enable_x64(f64):
        jconfig.set_precision(f64)
        try:
            rdt = jnp.float64 if f64 else jnp.float32
            a = jnp.asarray(angles[:, None], rdt)
            col = np.asarray(jbt.build_unitary_batched(
                n, 'cp', 'xyz', pl, a, columns=[0])).reshape(-1)
            jf = jbt.make_batched_regloss(
                n, 'cp', 'xyz', pl, japi.LossSpec('state', target=target),
                reversible=True)
            _, loss = jf(a)
            grad = jax.grad(lambda v: jf(v)[0].sum())(a)
            loss, grad = float(loss[0]), np.asarray(grad)[:, 0]
        finally:
            jconfig.set_precision(False)
    return col, loss, grad


def block_forward_column(n, placements, angles, segment):
    """One restart's state column as forward_block_kernel forms it on one
    block: the surface round's product state written in the forward
    table's first permutation (row bit v holds bit z of its start op, qubit
    n - 1 - z, whose surface gate's first column gives the factor), then
    the table's blocks and swaps, which end on the natural order."""
    table = rk.schedule(n, placements, segment, forward=True)
    gates = gate_matrices(n, 'cp', 'xyz', placements, angles)
    rows = np.arange(1 << n)
    x = torch.ones(1 << n, dtype=gates[0].dtype)
    for v, (_, _, z, _) in enumerate(table[:n]):
        x = x * gates[n - 1 - z][torch.as_tensor((rows >> v) & 1), 0]
    for j, a, b, _ in table[n:]:
        if j < 0:  # a swap of row bits a < b, inside the block
            one = torch.as_tensor(rows[((rows >> a) & 1) == 1])
            one = one[((one >> b) & 1) == 0]
            other = one ^ (1 << a) ^ (1 << b)
            x[one], x[other] = x[other].clone(), x[one].clone()
        else:
            x = apply(x[:, None], gates[j], group_rows(
                1 << n, (a,) if j < n else (a, b)))[:, 0]
    return x


@pytest.mark.parametrize('n', [2, 4, 7, 9, 11])
@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_one_column_on_one_block_matches_jax(n, dtype):
    """GHZ-n's state loss on the n-qubit chain at k = 2n 'xyz' CP blocks,
    seeded numpy angles: the forward table from the product state gives
    the JAX package's state column, and the walk over the vjp's table on
    one block (a cluster of one) the loss and angle gradients of the JAX
    package's state objective, within TOL of the dtype (the gradients
    scaled by max(1, |gradient|))."""
    k = 2 * n
    placements = tuple(map(tuple, all_placements(
        fill_layers(chain_layer(n), k))))
    angles = np.random.default_rng(22 + n).uniform(0, 2 * np.pi,
                                                   3 * n + NBA * k)
    target = chip_smoke.ghz(n).astype(np.complex128)
    target /= np.linalg.norm(target)  # as both packages hold it
    jcol, jloss, jgrad = _jax_state_and_grad(n, k, angles, target, dtype)
    a = torch.tensor(angles, dtype=dtype)
    fwd = uk.rows_launch(n, k, NBA, 0, False, dtype)
    col = block_forward_column(n, placements, a, fwd['segment'])
    assert (col - torch.tensor(jcol)).abs().max().item() <= TOL[dtype]
    vjp = uk.rows_launch(n, k, NBA, 0, True, dtype)
    _, loss, grad = scheduled_state_loss_and_grad(
        n, 'cp', 'xyz', placements, a, target, vjp['segment'], 1)
    assert abs(loss.item() - jloss) <= TOL[dtype]
    want = torch.tensor(jgrad, dtype=F64)
    err = (grad.double() - want).abs() / want.abs().clamp(min=1.0)
    assert err.max().item() <= TOL[dtype]


# ------------------------------------------- the whole unitary, one block

def block_vjp(n, rot, placements, angles, u, ubar, dtype):
    """One restart's angle gradients as vjp_block_kernel forms them for the
    whole unitary on one block (rows.cuh's warps): A = U and M = conj(Ubar)
    / 2 held column-major (entry c 2^n + r), the walk last gate first, each
    warp on its segment of 2^seg amplitudes (whole columns: no swap); each
    gate's cotangent share M[p] A[k] of every amplitude group of the
    segment (groups numbered as the kernels number them), summed by each
    lane over its steps (group g on lane g mod 32, step g / 32; a lane past
    the gate's groups adds nothing), over the warp's lanes in the
    butterfly's tree, over the block's warps in warp order (the ring's
    flush); the angle gradients from them by the factored algebra."""
    d, nba = 1 << n, num_block_angles('cp', rot)
    launch = uk.rows_launch(n, len(placements), nba, n, True, dtype)
    warps, seg = launch['warps'], launch['segment']
    gates = gate_matrices(n, 'cp', rot, placements, angles)
    legs = [(n - 1 - j,) for j in range(n)] + \
        [(n - 1 - a, n - 1 - b) for a, b in placements]
    A = u.T.reshape(-1, 1).clone()  # column-major
    M = ubar.T.reshape(-1, 1).conj() / 2
    gbar = [None] * len(gates)
    for j in range(len(gates) - 1, -1, -1):
        whole = group_rows(d * d, legs[j])
        A = apply(A, gates[j].conj().T, whole)
        rows = group_rows(1 << seg, legs[j])  # (D, groups) of a segment
        D, groups = rows.shape
        steps = -(-groups // 32)
        slot = []
        for wp in range(warps):
            at = (wp << seg) + rows
            share = torch.einsum('pg,kg->gpk', M[at, 0], A[at, 0])
            share = torch.cat([share, torch.zeros(
                steps * 32 - groups, D, D, dtype=share.dtype)])
            share = share.reshape(steps, 32, D, D)
            lane = torch.zeros(32, D, D, dtype=share.dtype)
            for step in range(steps):
                lane = lane + share[step]
            slot.append(_butterfly(lane))
        total = torch.zeros_like(slot[0])
        for wp in range(warps):
            total = total + slot[wp]
        gbar[j] = total
        M = apply(M, gates[j].T, whole)
    grads = [adjoint.surface_vjp(angles[3 * q:3 * q + 3], gbar[q])
             for q in range(n)]
    grads += [adjoint.block_vjp('cp', rot,
                                angles[3 * n + nba * b:3 * n + nba * (b + 1)],
                                gbar[n + b]) for b in range(len(placements))]
    return torch.cat(grads)


def rows_forward_whole(n, rot, placements, angles, blocks, dtype):
    """One restart's U (d, d) as forward_block_kernel forms it for the whole
    unitary on the plan's `blocks` blocks: block t's columns C = t w + c of
    the identity after the surface round, entry r the product over the
    qubits of G_q[r's bit, C's bit] on row bit n - 1 - q, then the blocks'
    chain on them (column by column, which the kernel's column-major tile
    and whole columns a warp make the same), stored into U's columns."""
    d = 1 << n
    w = d // blocks
    gates = gate_matrices(n, 'cp', rot, placements, angles)
    out = torch.zeros(d, d, dtype=gates[0].dtype)
    r = np.arange(d)[:, None]
    for t in range(blocks):
        C = t * w + np.arange(w)[None, :]
        x = torch.ones(d, w, dtype=gates[0].dtype)
        for s in range(n):
            x = x * gates[n - 1 - s][torch.as_tensor((r >> s) & 1),
                                     torch.as_tensor((C >> s) & 1)]
        for b, (q0, q1) in enumerate(placements):
            x = apply(x, gates[n + b], group_rows(d, (n - 1 - q0,
                                                      n - 1 - q1)))
        out[:, t * w:(t + 1) * w] = x
    return out


def _jax_unitary_and_vjp(n, k, rot, angles, g, dtype):
    """U (d, d, B) through the JAX package's builder and, where a cotangent
    g is given, the gradient of L = Re sum conj(g) U, in dtype's
    precision."""
    pl = fill_layers(chain_layer(n), k)
    d, B = 1 << n, angles.shape[1]
    f64 = dtype == F64
    with jax.enable_x64(f64):
        jconfig.set_precision(f64)
        try:
            cdt = jnp.complex128 if f64 else jnp.complex64
            rdt = jnp.float64 if f64 else jnp.float32
            a = jnp.asarray(angles, rdt)
            u = np.asarray(jbt.build_unitary_batched(n, 'cp', rot, pl, a)
                           ).reshape(d, d, B)
            grad = None
            if g is not None:
                def loss(v):
                    w = jbt.build_unitary_batched(n, 'cp', rot, pl, v)
                    return jnp.real(jnp.conj(jnp.asarray(g, cdt)) *
                                    w.reshape(d, d, B)).sum()
                _, pull = jax.vjp(loss, a)
                (grad,) = pull(jnp.ones((), rdt))
                grad = np.asarray(grad)
        finally:
            jconfig.set_precision(False)
    return u, grad


# (n, k, rotations, dtype): phase 22 (a)'s vjp rows of the whole unitary
WHOLE_VJP = [(6, 400, 'y', F32), (6, 130, 'y', F64), (3, 750, 'y', F32)]


@pytest.mark.parametrize('n,k,rot,dtype', WHOLE_VJP,
                         ids=[f'{s[0]}q-k{s[1]}-{str(s[3])[6:]}'
                              for s in WHOLE_VJP])
def test_whole_unitary_walk_on_one_block_matches_jax_vjp(n, k, rot, dtype):
    """n qubits on the chain at k CP blocks with rotations `rot`, B = 2, on
    one block (the vjp's plan): seeded numpy angles and a complex
    cotangent g of U; the gradient of L = Re sum conj(g) U from the block's
    walk in its order of sums (on the JAX package's U, as the vjp loads
    what the forward pass stored) against jax.vjp of L through cpflow_tpu's
    builder, within TOL, scaled by max(1, |gradient|). A float32 walk of
    400 to 750 gates rounds farther than that from the JAX package's
    float32 gradient, so there the JAX package's float64 gradient
    arbitrates: the walk's distance from it within TOL or within twice the
    JAX package's float32 gradient's (as chip_smoke.py's
    as_close_as_plain holds a kernel to the plain version)."""
    B = 2
    nba = num_block_angles('cp', rot)
    p = uk.plan(n, k, nba, n, True, dtype)
    assert (p['design'], p['blocks_per_restart']) == ('rows', 1)
    placements = tuple(map(tuple, all_placements(
        fill_layers(chain_layer(n), k))))
    d, P = 1 << n, 3 * n + nba * k
    rng = np.random.default_rng(22 + n + k)
    angles = rng.uniform(0, 2 * np.pi, (P, B))
    g = rng.normal(size=(d, d, B)) + 1j * rng.normal(size=(d, d, B))
    u, jgrad = _jax_unitary_and_vjp(n, k, rot, angles, g, dtype)
    arbiter = None
    if dtype == F32:
        _, arbiter = _jax_unitary_and_vjp(n, k, rot, angles, g, F64)
    cdtype = torch.complex128 if dtype == F64 else torch.complex64
    for b in range(B):
        grad = block_vjp(n, rot, placements,
                         torch.tensor(angles[:, b], dtype=dtype),
                         torch.tensor(u[:, :, b], dtype=cdtype),
                         torch.tensor(g[:, :, b], dtype=cdtype), dtype)
        want = torch.tensor(jgrad[:, b], dtype=F64)
        err = ((grad.double() - want).abs() / want.abs().clamp(min=1.0))
        err = err.max().item()
        if err > TOL[dtype] and arbiter is not None:
            exact = torch.tensor(arbiter[:, b], dtype=F64)
            scale = exact.abs().clamp(min=1.0)
            err = ((grad.double() - exact).abs() / scale).max().item()
            plain = ((want - exact).abs() / scale).max().item()
            assert err <= max(TOL[dtype], 2 * plain), (b, err, plain)
        else:
            assert err <= TOL[dtype], (b, err)


# (n, k, rotations, dtype, blocks): phase 22 (a)'s forward row of the whole
# unitary, and the plan's independent blocks of 2 columns (3q), one block
# and two in float64
WHOLE_FORWARD = [(6, 1190, 'y', F32, 1), (3, 1093, 'xyz', F32, 4),
                 (5, 650, 'y', F64, 1), (6, 600, 'y', F64, 2)]


@pytest.mark.parametrize('n,k,rot,dtype,blocks', WHOLE_FORWARD,
                         ids=[f'{s[0]}q-k{s[1]}-{str(s[3])[6:]}'
                              for s in WHOLE_FORWARD])
def test_whole_unitary_forward_on_the_plans_blocks_matches_jax(n, k, rot,
                                                              dtype, blocks):
    """The forward pass of the whole unitary on the row-split plan's blocks
    (rows_forward_whole) against the JAX package's U, within TOL."""
    nba = num_block_angles('cp', rot)
    p = uk.plan(n, k, nba, n, False, dtype)
    assert (p['design'], p['blocks_per_restart']) == ('rows', blocks)
    placements = tuple(map(tuple, all_placements(
        fill_layers(chain_layer(n), k))))
    angles = np.random.default_rng(220 + n).uniform(0, 2 * np.pi,
                                                    (3 * n + nba * k, 1))
    u, _ = _jax_unitary_and_vjp(n, k, rot, angles, None, dtype)
    got = rows_forward_whole(n, rot, placements,
                             torch.tensor(angles[:, 0], dtype=dtype), blocks,
                             dtype)
    assert (got - torch.tensor(u[:, :, 0])).abs().max().item() <= \
        TOL[dtype]


# ------------------------------------------------------------ end to end

def test_ghz4_static_with_cp_penalty_l1_matches_jax():
    """Synthesize(chain_layer(4), target_state=GHZ-4,
    cp_regularization_func=cp_penalty_L1).static on the CPU (on the card
    its sampling runs through the pair on one block: chip_smoke.py phase
    22 (c)) against the JAX package's same call and seed (k=6, 16 samples,
    500 + 500 steps, r = 0.001), in float64, as
    test_torch_double.py's L1 CCZ compares them (float32 roundoff under the
    L1 penalty's constant slope grows into different sampling outcomes):
    the same sampling CZ counts, the same verified CZ counts and circuits,
    a 3-CZ decomposition among them, and every loss of both stages within
    1e-3 of the JAX package's, relatively (in float64 too, Adam's steps
    across the penalty's kink amplify roundoff to some 1e-4 of a loss over
    500 steps, and verification starts from where sampling ended)."""
    target = chip_smoke.ghz(4).astype(np.complex128)
    opts = dict(num_cp_gates=6, num_samples=16, accepted_num_cz_gates=3,
                r=0.001, num_gd_iterations=500,
                num_gd_iterations_at_verification=500, random_seed=0)
    with jax.enable_x64(True):
        jconfig.set_precision(True)
        tconfig.set_precision(True)
        try:
            jsynth = japi.Synthesize(
                chain_layer(4), target_state=target, mesh=None,
                cp_regularization_func=jpenalty.cp_penalty_L1)
            tsynth = tapi.Synthesize(
                chain_layer(4), target_state=target, device='cpu',
                cp_regularization_func=tpenalty.cp_penalty_L1)
            jev = jsynth._raw_and_evaluate(japi.StaticOptions(**opts))
            tev = tsynth._raw_and_evaluate(tapi.StaticOptions(**opts))
            jres = jsynth.static(japi.StaticOptions(**opts),
                                 save_results=False, verbose=False)
            tres = tsynth.static(tapi.StaticOptions(**opts),
                                 save_results=False, verbose=False)
        finally:
            jconfig.set_precision(False)
            tconfig.set_precision(False)
    np.testing.assert_allclose(tev.loss, jev.loss, rtol=1e-3, atol=0)
    np.testing.assert_array_equal(tev.cz, jev.cz)
    got = [d.cz_count for d in tres.decompositions]
    assert 3 in got and got == [d.cz_count for d in jres.decompositions]
    for a, b in zip(jres.decompositions, tres.decompositions):
        assert [(x.name, tuple(x.qubits)) for x in a.circuit.instructions] \
            == [(x.name, tuple(x.qubits)) for x in b.circuit.instructions]
        assert abs(a.loss - b.loss) <= 1e-3 * abs(a.loss), (a.loss, b.loss)

"""The sweep kernel's one-block build and cluster build (kernels/sweep.py),
without a card.

csrc/sweep.cu runs one block a restart (a state up to 13 qubits, 12 in
float64, and the whole unitary at 2 to 6 qubits too deep for the column
build) on csrc/rows.cuh's warps, sweep_block_kernel, and the whole unitary
split by columns over a cluster (7 and 8 qubits) on csrc/tiles.cuh's
warps, sweep_cluster_kernel. Both keep the blocks a restart of the plan
(cluster_plan, decided by the first design's layout) and launch with their
own layouts, which ``block_plan`` and ``cluster_layout`` mirror
(cpflow_sweep_block_plan, cpflow_sweep_cluster_layout; chip_smoke.py holds
the mirrors against the library on the card). Here the mirrors are held to
the plan at every shape of chip_smoke.py's phases 3, 15 and 19 and at every
depth the plan holds; the one-block build's row schedules are run on the
host; and a numpy model of the cluster build's order of sums (each warp's
columns, then the warps in order, then the ranks in order, rank r building
gates j = r mod c) is held against the plain gradient. No JAX."""

import numpy as np
import pytest
import torch

import chip_smoke
from cpflow_tpu_torch.kernels import rows as rk
from cpflow_tpu_torch.kernels import sweep as sk
from cpflow_tpu_torch.sim import adjoint
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles
from cpflow_tpu_torch.sim.batched import _apply_gate_batched
from cpflow_tpu_torch.topology import chain_layer, fill_layers

LIMIT = 232448  # shared memory one block may use on sm_90
WHOLE = ('hst', 'disc', 'modulo_identity', 'modulo_diagonal')
DTYPES = (torch.float32, torch.float64)


def _args(s):
    """(n, blocks, angles a block, loss) of a chip_smoke shape dict."""
    pl = s.get('placements') or fill_layers(
        s.get('layer') or chain_layer(s['n']),
        max(s['ks']) if 'ks' in s else s['k'])
    pl = {'layers': [[], 0], **pl}  # a shape may give free placements only
    return (s['n'], len(all_placements(pl)),
            num_block_angles(s.get('ent', 'cp'), s.get('rot', 'xyz')),
            s.get('kind', 'hst'))


def _shapes():
    """Phases 3, 5, 15, 18 and 19's sweep shapes, by name."""
    out = chip_smoke.compare_shapes() + \
        [s for s, _, _ in chip_smoke.timing_shapes()] + \
        chip_smoke.seven_shapes() + chip_smoke.sixteen_shapes() + \
        [dict(s, dtype=torch.float64) for s in chip_smoke.double_shapes()]
    return {s['name']: s for s in out}


SHAPES = _shapes()


@pytest.mark.parametrize('dtype', DTYPES, ids=['float32', 'float64'])
@pytest.mark.parametrize('name', sorted(SHAPES))
def test_launch_layouts_keep_the_plan(name, dtype):
    """Every shape of phases 3, 15 and 19 keeps the blocks a restart the
    plan gave it (the rows that name theirs), and where the one-block or
    cluster build takes it, the build's own layout fits a block: one block
    with rows.cuh's warps on its 2^(n + log_c) amplitudes (the whole
    unitary's segment holding whole columns, so its table has no swap),
    or a cluster of tiles of 2^n / c columns with a ring of at least one
    gate."""
    s = SHAPES[name]
    dtype = s.get('dtype', dtype)
    n, nb, nba, kind = _args(s)
    c = sk.cluster_plan(n, nb, nba, kind, dtype)
    build = sk.build_of(n, nb, nba, kind, dtype)
    if 'cluster' in s and s.get('dtype', torch.float32) == dtype:
        assert c == s['cluster']
    suffix = '_f64' if dtype == torch.float64 else ''
    if build == 'sweep_block' + suffix:
        assert c == 1 and sk.column_plan(n, nb, nba, kind, dtype) is None
        p = sk.block_plan(n, nb, nba, kind, dtype)
        log_c = 0 if kind == 'state' else n
        assert p['log_rows'] == n + log_c and p['cluster'] == 1
        assert p['threads'] == 32 * p['warps'] <= rk.THREADS[dtype]
        assert p['smem_bytes'] <= LIMIT and p['ring'] >= 1
        assert p['segment'] >= (n if log_c else 2)
        assert sk.cluster_layout(n, nb, nba, kind, dtype) is None
    elif build == 'sweep_cluster' + suffix:
        assert kind in WHOLE and c > 1
        p = sk.cluster_layout(n, nb, nba, kind, dtype)
        assert p['cluster'] == c and p['columns'] * c == 1 << n
        assert p['smem_bytes'] <= LIMIT and p['ring'] >= 1
        assert 32 <= p['threads'] <= sk.CLUSTER_THREADS
        assert sk.block_plan(n, nb, nba, kind, dtype) is None
    else:
        assert build in (b + suffix for b in (
            'sweep_columns', 'sweep_row_tiles', 'sweep_column_tiles'))
        assert sk.block_plan(n, nb, nba, kind, dtype) is None
        assert sk.cluster_layout(n, nb, nba, kind, dtype) is None


@pytest.mark.parametrize('dtype', DTYPES, ids=['float32', 'float64'])
@pytest.mark.parametrize('kind', WHOLE + ('state',))
def test_new_layouts_fit_wherever_the_plan_holds(kind, dtype):
    """At every depth (every block count to the plan's last) of 2 to 8
    qubits (a state to 13), the build the plan picks holds a launch: the
    one-block layout's ring and the cluster layout's pad and ring take no
    more than the first design's cross-warp partials did, so no depth edge
    moves."""
    nba = num_block_angles('cp', 'xyz')
    for n in range(2, 14 if kind == 'state' else 9):
        for nb in range(0, 400, 3):
            c = sk.cluster_plan(n, nb, nba, kind, dtype)
            if c is None:
                break
            if c == 1:
                if sk.column_plan(n, nb, nba, kind, dtype) is None:
                    p = sk.block_plan(n, nb, nba, kind, dtype)
                    assert p is not None and p['smem_bytes'] <= LIMIT
            elif kind != 'state':
                p = sk.cluster_layout(n, nb, nba, kind, dtype)
                assert p is not None and p['smem_bytes'] <= LIMIT, (n, nb)


@pytest.mark.parametrize('dtype', DTYPES, ids=['float32', 'float64'])
def test_cluster_threads_and_ring_at_the_phase_shapes(dtype):
    """tile_threads of the block's columns, at most 256 (CLUSTER_THREADS),
    at every cluster shape of phases 15 and 19 (in float64 (x) and (I) take the
    column tiles), and the largest ring that fits: the deepest (the
    Toffoli-7 program's 144 blocks) still takes a ring of 16 gates in
    float32."""
    suffix = '_f64' if dtype == torch.float64 else ''
    for name in ('(q)', '(w)', '(x)', '(y)', '(G)', '(I)', '(K)'):
        s = next(s for s in SHAPES.values() if s['name'].startswith(name))
        n, nb, nba, kind = _args(s)
        if sk.build_of(n, nb, nba, kind, dtype) != 'sweep_cluster' + suffix:
            assert dtype == torch.float64 and name in ('(x)', '(I)')
            continue
        p = sk.cluster_layout(n, nb, nba, kind, dtype)
        assert p['threads'] == min(sk.tile_threads(n, p['columns'], dtype),
                                   sk.CLUSTER_THREADS) == 256
        assert p['ring'] in (1, 2, 4, 8, 16)
    assert sk.cluster_layout(7, 144, num_block_angles('cp', 'xyz'),
                             'hst')['ring'] == 16


def _ghz_ladder(n, k):
    """The chain template's placements at k blocks, as tuples."""
    pl = {'layers': [[], 0], **fill_layers(chain_layer(n), k)}
    return tuple(map(tuple, all_placements(pl)))


STATE_TEMPLATES = [(n, n - 1, torch.float32) for n in range(4, 14)] + \
    [(n, n - 1, torch.float64) for n in range(4, 13)] + \
    [(10, 36, torch.float32), (13, 48, torch.float32),
     (12, 36, torch.float64), (10, 4, torch.float32)]


@pytest.mark.parametrize('n,k,dtype', STATE_TEMPLATES,
                         ids=[f'{n}q-k{k}-{str(d)[6:]}'
                              for n, k, d in STATE_TEMPLATES])
def test_one_block_state_schedule_ends_on_the_identity(n, k, dtype):
    """The row schedule the one-block build runs for a state (its
    segment, block_plan's): walked from its end, where the rows lie in
    natural order, every gate meets its legs on segment bits where its op
    says, every gate runs once in the chain's order, and every swap
    exchanges a segment bit with a bit of the block's own rows (one block:
    no bit names a rank)."""
    placements = _ghz_ladder(n, k)
    nba = num_block_angles('cp', 'xyz')
    p = sk.block_plan(n, len(placements), nba, 'state', dtype)
    assert p is not None and p['log_rows'] == n
    seg = p['segment']
    table = rk.schedule(n, placements, min(seg, n))
    gates = rk.gate_bits(n, placements)
    held = list(range(n))  # row bit -> the bit it holds, at the table's end
    order = []
    for j, a, b, _ in table[::-1]:
        if j < 0:
            assert j == -1 and a < seg <= b < n
            held[a], held[b] = held[b], held[a]
            continue
        legs = gates[j]
        assert a < seg and held[a] == legs[0]
        if len(legs) > 1:
            assert b < seg and held[b] == legs[1]
        order.append(j)
    assert order[::-1] == list(range(n + len(placements)))
    if seg >= n:
        assert (table[:, 0] >= 0).all()


@pytest.mark.parametrize('n', [2, 3, 4, 5, 6])
@pytest.mark.parametrize('dtype', DTYPES, ids=['float32', 'float64'])
def test_whole_unitary_on_one_block_has_no_swap(n, dtype):
    """The whole unitary too deep for the column build runs on one block
    with whole columns a warp: its segment holds every row bit, and the
    schedule of segment n runs the gates in order with no swap. Where the
    first such depth already needs a cluster (3 qubits in float64, whose
    column build holds deeper templates than one block of the first
    design), the cluster build takes it."""
    nba = num_block_angles('cp', 'xyz')
    nb = next(nb for nb in range(0, 2000)
              if sk.column_plan(n, nb, nba, 'hst', dtype) is None)
    if sk.cluster_plan(n, nb, nba, 'hst', dtype) != 1:
        assert sk.cluster_layout(n, nb, nba, 'hst', dtype) is not None
        return
    p = sk.block_plan(n, nb, nba, 'hst', dtype)
    assert p is not None and p['segment'] >= n and p['log_rows'] == 2 * n
    placements = _ghz_ladder(n, nb)
    table = rk.schedule(n, placements, n)
    assert list(table[:, 0]) == list(range(n + nb))


def _model_gradient(n, ent, rot, placements, angles, target, c, warps):
    """The cluster build's gradient of the HS test in float64, in its order
    of sums: gates built by rank j mod c (each block then holds every
    gate), the chain on each column, M = -(conj(s) / d^2) conj(T), the walk
    on each column, each gate's cotangent summed over a warp's columns in
    column order, over the block's warps in warp order and over the ranks
    in rank order, then the factored angle gradients (sim/adjoint.py, the
    kernel's gate algebra). angles: (P,) numpy. Returns (loss, grad)."""
    d, w = 1 << n, (1 << n) // c
    nba = num_block_angles(ent, rot)
    a = torch.as_tensor(angles, dtype=torch.float64)[:, None]
    surface = a[:3 * n].reshape(n, 3, 1)
    blocks = a[3 * n:].reshape(-1, nba, 1)
    owner, gates, places = [], [], []
    for j in range(n + len(placements)):
        owner.append(j % c)
        if j < n:
            g, _ = adjoint.surface_matrix_and_grads(surface[j])
            places.append([j])
        else:
            g, _ = adjoint.block_matrix_and_grads(ent, rot, blocks[j - n])
            places.append(list(placements[j - n]))
        gates.append(g)
    assert sorted(set(owner)) == list(range(min(c, len(gates))))
    eye = torch.eye(d, dtype=torch.complex128)
    u = eye.reshape([2] * n + [d, 1])
    for g, p in zip(gates, places):
        u = _apply_gate_batched(g, u, p, n)
    t = torch.as_tensor(target, dtype=torch.complex128)
    s = (u.reshape(d, d) * t.conj()).sum()
    loss = 1 - abs(s) ** 2 / d ** 2
    m = (-(s.conj() / d ** 2) * t.conj()).reshape(u.shape)
    # each column's share of every gate's cotangent, walked on its own
    shares = []
    for col in range(d):
        x, y = u[..., col:col + 1, :], m[..., col:col + 1, :]
        mine = [None] * len(gates)
        for j in reversed(range(len(gates))):
            x = adjoint._apply_dagger(gates[j], x, places[j], n)
            mine[j] = adjoint._gate_cotangent(y, x, places[j], n)[..., 0]
            y = adjoint._apply_transpose(gates[j], y, places[j], n)
        shares.append(mine)
    cw = max(w // warps, 1)
    gbar = []
    for j in range(len(gates)):
        ranks = []
        for r in range(c):
            warp_sums = []
            for wp in range(min(warps, w)):
                cols = [r * w + wp * cw + i for i in range(cw)]
                acc = shares[cols[0]][j]
                for col in cols[1:]:
                    acc = acc + shares[col][j]
                warp_sums.append(acc)
            block = warp_sums[0]
            for x in warp_sums[1:]:
                block = block + x
            ranks.append(block)
        total = ranks[0]
        for x in ranks[1:]:
            total = total + x
        gbar.append(total)
    grad = []
    for j in range(len(gates)):
        if j < n:
            grad.append(adjoint.surface_vjp(surface[j], gbar[j][..., None]))
        else:
            grad.append(adjoint.block_vjp(ent, rot, blocks[j - n],
                                          gbar[j][..., None]))
    return float(loss), torch.cat(grad).reshape(-1).numpy()


@pytest.mark.parametrize('n,k,c,warps', [(4, 6, 2, 4), (4, 6, 4, 2),
                                         (5, 8, 2, 8), (3, 4, 2, 1)])
def test_cluster_order_of_sums_gives_the_plain_gradient(n, k, c, warps):
    """The numpy model of the cluster build's sums (warps owning several
    columns where the tile has more columns than warps, one column each
    otherwise) gives the gradient of the HS test that autograd gives
    through the plain builder, within 1e-10 in float64."""
    from cpflow_tpu_torch.ops.gates import multi_controlled_x
    from cpflow_tpu_torch.sim.batched import build_unitary_batched
    rng = np.random.default_rng(n * 100 + k)
    placements = _ghz_ladder(n, k)
    nba = num_block_angles('cp', 'xyz')
    P = 3 * n + nba * len(placements)
    angles = rng.uniform(0, 2 * np.pi, P)
    target = multi_controlled_x(n).astype(np.complex128)
    loss, grad = _model_gradient(n, 'cp', 'xyz', placements, angles, target,
                                 c, warps)
    pl = {'layers': [[], 0], 'free': [list(p) for p in placements]}
    ap = torch.tensor(angles[:, None], dtype=torch.float64,
                      requires_grad=True)
    u = build_unitary_batched(n, 'cp', 'xyz', pl, ap,
                              dtype=torch.float64).reshape(1 << n, 1 << n)
    t = torch.as_tensor(target)
    want = 1 - (u * t.conj()).sum().abs() ** 2 / (1 << n) ** 2
    (g,) = torch.autograd.grad(want, ap)
    assert abs(loss - want.item()) <= 1e-12
    np.testing.assert_allclose(grad, g[:, 0].numpy(), rtol=0, atol=1e-10)


def test_build_names():
    """The library's build numbers name the one-block, cluster, row tiles
    and column builds, and build_of names a phase shape's build as the
    plans give it."""
    assert sk.BUILD_NAMES == ('sweep_block', 'sweep_cluster',
                              'sweep_row_tiles', 'sweep_columns')
    nba = num_block_angles('cp', 'xyz')
    assert sk.build_of(7, 24, nba, 'hst') == 'sweep_cluster'
    assert sk.build_of(8, 16, 5, 'hst', torch.float64) == 'sweep_cluster_f64'
    assert sk.build_of(10, 36, nba, 'state') == 'sweep_block'
    assert sk.build_of(6, 118, nba, 'hst') == 'sweep_block'
    assert sk.build_of(14, 15, nba, 'state') == 'sweep_row_tiles'
    assert sk.build_of(3, 12, nba, 'hst') == 'sweep_columns'
    assert sk.build_of(9, 10, nba, 'hst') == 'sweep_column_tiles'


@pytest.mark.parametrize('dtype', DTYPES, ids=['float32', 'float64'])
@pytest.mark.parametrize('n,k,kind', [(10, 4, 'state'), (10, 36, 'state'),
                                      (13, 48, 'state'), (6, 118, 'hst'),
                                      (6, 118, 'modulo_identity')])
def test_one_block_warps_by_batch(n, k, kind, dtype):
    """The one-block build may take fewer warps than its plan, where the
    batch outnumbers the restarts the plan's warps leave room for (the
    library picks them by occupancy, cpflow_sweep_block_plan): each power
    of two down to one warp owns a longer segment with the largest ring
    that fits, in no more bytes than the plan's layout."""
    nba = num_block_angles('cp', 'xyz')
    nb = len(_ghz_ladder(n, k))
    if sk.cluster_plan(n, nb, nba, kind, dtype) != 1:  # float64 splits it
        assert sk.block_plan(n, nb, nba, kind, dtype, 1) is None
        return
    full = sk.block_plan(n, nb, nba, kind, dtype)
    assert sk.block_plan(n, nb, nba, kind, dtype, full['warps']) == full
    w = full['warps'] // 2
    while w >= 1:
        p = sk.block_plan(n, nb, nba, kind, dtype, w)
        assert p['warps'] == w and p['threads'] == 32 * w
        assert p['segment'] == p['log_rows'] - (w.bit_length() - 1)
        assert 1 <= p['ring'] <= 16 and p['smem_bytes'] <= LIMIT
        if kind != 'state':
            assert p['segment'] >= n  # whole columns a warp
        w //= 2

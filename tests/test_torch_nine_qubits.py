"""The whole unitary past what a cluster of 16 blocks holds: 9 to 13 qubits
on the column tiles (a restart's columns split into tiles on independent
blocks, kernels/sweep.py and kernels/unitary.py, ``tile_plan``).

  * the plans: the tiles' documented sizes, every shape that a cluster of
    at most 16 blocks held keeping its plan, the new limits, and the
    refusals beyond them, and the modulo losses routed past 8 qubits to
    the unitary kernels (ROADMAP A.16b);
  * the port's plain sweep against the JAX package's
    engine.minimize_fused(reversible=True) at 9 qubits (HS test and disc,
    float32 and float64) and at 10 and 11 (HS test), with the tolerances of
    test_torch_seven_qubits._assert_close;
  * the plain builder's unitary and vector-Jacobian product against
    jax.vjp of the JAX package's reversible builder at 9 qubits;
  * on a card (marked ``cuda``, skipped here): the sweep kernel and the
    unitary kernels on the column tiles against their plain versions.

The kernels themselves run only on a card: chip_smoke.py phase 21 holds
them against their plain versions at 9 to 13 qubits there. A tiny static
synthesis at 9 qubits through both packages is
tests/test_torch_nine_static.py (a file of its own, so that the two run
side by side under pytest-xdist)."""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import api as japi
from cpflow_tpu import config as jconfig
from cpflow_tpu.ops.penalty import cp_penalty_linear as j_penalty
from cpflow_tpu.optimize import engine as jengine
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch import config as tconfig
from cpflow_tpu_torch.kernels import sweep as sk
from cpflow_tpu_torch.kernels import tiles as tk
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.ops.gates import multi_controlled_x
from cpflow_tpu_torch.ops.penalty import LinearPenalty
from cpflow_tpu_torch.optimize import engine
from cpflow_tpu_torch.sim import batched as tbt
from cpflow_tpu_torch.sim.ansatz_kernel import (cp_angle_indices,
                                                num_block_angles)
from cpflow_tpu_torch.topology import chain_layer, fill_layers
from cpflow_tpu_torch.utils import profiling as prof

import chip_smoke
from test_torch_seven_qubits import _assert_close

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
LIMIT = 232448  # shared memory one block may use on sm_90
PEN = (math.pi / 2, 2.0, 0.05, 0.05, 0.05)
XYZ = num_block_angles('cp', 'xyz')


@contextlib.contextmanager
def double():
    """Both packages in double precision (the JAX one under x64), float32
    restored whatever happens."""
    with jax.enable_x64(True):
        jconfig.set_precision(True)
        tconfig.set_precision(True)
        try:
            yield
        finally:
            jconfig.set_precision(False)
            tconfig.set_precision(False)


# --------------------------------------------------------------- the plans

# (n, dtype, columns a tile and tiles a restart of the sweep at k = 10
# 'xyz'): 128 KB of A and M a tile, 16 d w bytes (32 in float64)
SWEEP_TILES = [(9, F32, (16, 32)), (10, F32, (8, 128)), (11, F32, (4, 512)),
               (12, F32, (2, 2048)), (13, F32, (1, 8192)),
               (9, F64, (8, 64)), (10, F64, (4, 256)), (11, F64, (2, 1024)),
               (12, F64, (1, 4096))]


@pytest.mark.parametrize('n,dtype,want', SWEEP_TILES)
def test_tile_plan_takes_a_restart_past_a_cluster(n, dtype, want):
    """The sweep's and the vjp's column tiles at k = 10 'xyz' (the same
    tiles: both hold A and M), each block's layout under a block's shared
    memory and twice as many tiles over it; no cluster holds these shapes,
    and both losses of the tiles take them."""
    assert sk.cluster_plan(n, 10, XYZ, 'hst', dtype) is None
    for kind in sk.TILE_LOSSES:
        assert sk.tile_plan(n, 10, XYZ, kind, dtype) == want
    w, tiles = want
    assert w * tiles == 2 ** n
    assert sk.smem_bytes(n, 10, XYZ, 'hst', tiles, dtype) <= LIMIT
    if tiles > 1:
        assert sk.smem_bytes(n, 10, XYZ, 'hst', tiles // 2, dtype) > LIMIT
    assert uk.tile_plan(n, 10, XYZ, n, True, dtype) == want
    p = uk.plan(n, 10, XYZ, n, True, dtype)
    assert (p['design'], p['blocks_per_restart'], p['restarts_per_block']) \
        == ('tiles', tiles, 1)
    # the plan's layout fits; the vjp launches its tile kernel's (tiles.cuh)
    assert uk.smem_bytes(n, 10, XYZ, n, True, tiles, dtype) <= LIMIT
    assert (p['threads'], p['smem_bytes']) == (
        sk.tile_threads(n, w, dtype), sk.tile_smem_bytes(n, 10, w, dtype))
    assert p['smem_bytes'] <= LIMIT


def test_the_forward_pass_takes_tiles_twice_as_wide():
    """The forward pass holds A alone: from 7 qubits it runs on the column
    tiles (at 9 qubits in float32 on the 16 tiles of the cluster's plan that
    held it before), from 10 qubits (and at 9 in float64) tiles twice as
    wide as the vjp's."""
    p = uk.plan(9, 10, XYZ, 9, False)
    assert (p['design'], p['blocks_per_restart']) == ('tiles', 16)
    assert uk.tile_plan(9, 10, XYZ, 9, False) == (32, 16)
    assert uk.tile_plan(10, 10, XYZ, 10, False) == (16, 64)
    assert uk.tile_plan(11, 10, XYZ, 11, False) == (8, 256)
    assert uk.tile_plan(9, 10, XYZ, 9, False, F64) == (16, 32)
    assert uk.kernel_name('tiles', False, 10) == 'ansatz_forward_column_tiles'
    assert uk.kernel_name('tiles', True, 10) == 'ansatz_vjp_column_tiles'
    assert uk.KERNELS[13:16] == ('ansatz_forward_column_tiles',
                                 'ansatz_vjp_column_tiles',
                                 'ansatz_vjp_tile_sum')


def test_every_shape_a_cluster_held_keeps_its_plan():
    """Wherever a cluster of at most 16 blocks (or one block) holds a shape,
    the tiles take nothing: every n from 2 to 8, k up to 400, both
    rotation strings, both dtypes, every loss, and the unitary kernels'
    plans keep their designs; past the clusters' depths at 7 and 8 qubits
    the tiles take the HS test and disc, never a modulo loss or a state."""
    taken = 0
    for dtype in (F32, F64):
        for n in range(2, 9):
            for k in range(0, 401, 9):
                for nba in (XYZ, num_block_angles('cp', 'xz')):
                    for kind in sk.LOSS_CODES:
                        c = sk.cluster_plan(n, k, nba, kind, dtype)
                        t = sk.tile_plan(n, k, nba, kind, dtype)
                        assert c is None or t is None, (n, k, kind)
                        if kind not in sk.TILE_LOSSES:
                            assert t is None
                        taken += t is not None
                    for vjp in (False, True):
                        p = uk.plan(n, k, nba, n, vjp, dtype)
                        c = uk.cluster_plan(n, k, nba, n, vjp, dtype)
                        if c is not None and (vjp or n < 7):
                            assert p['design'] in ('columns', 'rows')
                        elif p is not None:  # from 7 qubits the forward
                            assert p['design'] == 'tiles'  # pass's tiles
                            # the cluster plan's tiles, or twice as many
                            # where its padded layout does not fit
                            t = p['blocks_per_restart']
                            assert c is None or t == c or t == 2 * c and \
                                tk.warp_smem_bytes(n, k, nba, (1 << n) // c,
                                                   False, 0, dtype) > LIMIT
                        assert uk.tile_plan(n, k, nba, 0, vjp, dtype) is None
    assert taken > 0
    # the deep templates phase 19 and the float64 tests refused before
    assert sk.tile_plan(8, 359, XYZ, 'hst') == (8, 32)
    assert sk.tile_plan(7, 220, XYZ, 'hst', F64) == (4, 32)
    # every shape of chip_smoke.py's earlier phases keeps its blocks
    for s in chip_smoke.seven_shapes() + chip_smoke.sixteen_shapes():
        nb = len(tapi.Ansatz(s['n'], 'cp', s.get('placements') or
                             fill_layers(chain_layer(s['n']),
                                         max(s['ks']) if 'ks' in s else
                                         s['k'])).placements['free']) \
            if s.get('placements') else \
            (max(s['ks']) if 'ks' in s else s['k'])
        nba = num_block_angles(s.get('ent', 'cp'), s.get('rot', 'xyz'))
        dtype = s.get('dtype', F32)
        kind = s.get('kind', 'hst')
        assert sk.cluster_plan(s['n'], nb, nba, kind, dtype) == s['cluster']
        assert sk.tile_plan(s['n'], nb, nba, kind, dtype) is None


def test_the_limits_are_what_the_plans_hold():
    """The HS test and disc to 13 qubits in float32 and 12 in float64 (one
    column a tile: 128 KB of A and M), the modulo losses to 8 (no tiles),
    a state to 17 and 16 (row tiles); the unitary kernels' whole unitary to
    13 and 12, one column to 24 and 23 (the global row tiles' cap)."""
    for dtype, whole, state, column in ((F32, 13, 17, 24), (F64, 12, 16, 23)):
        assert sk.MAX_QUBITS[dtype] == {
            'hst': whole, 'state': state, 'disc': whole,
            'modulo_identity': 8, 'modulo_diagonal': 8}
        assert uk.MAX_QUBITS[dtype] == {'unitary': whole, 'column': column}
        assert sk.tile_plan(whole + 1, 0, XYZ, 'hst', dtype) is None
        assert sk.smem_bytes(whole + 1, 0, XYZ, 'hst', 2 ** (whole + 1),
                             dtype) > LIMIT
        assert sk.smem_bytes(whole, 0, XYZ, 'hst', 2 ** whole, dtype) <= LIMIT


def _objective(n, kind, dtype=None):
    """A template on the n-qubit chain for the shape checks: its target is
    a placeholder (the checks read the sizes, never the target), so that
    no 2^n x 2^n matrix is made at 14 qubits."""
    target = np.eye(2, dtype=np.complex64)
    wires = [0, n - 1] if kind.startswith('modulo') else None
    return chip_smoke.make_objective(n, 2, target, 0.0, kind=kind,
                                     wires=wires, dtype=dtype)[0]


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_sweep_takes_the_new_limit_and_refuses_one_more(dtype):
    limit = sk.MAX_QUBITS[dtype]['hst']
    for kind in sk.TILE_LOSSES:
        for n in (9, 10, 11, limit):
            sk._check_objective(_objective(n, kind, dtype))
        with pytest.raises(ValueError, match=(
                rf"2 to {limit} qubits for a '{kind}' loss in {dtype}, got "
                rf"{limit + 1}: above {limit} one column of the state and "
                rf"cotangent exceeds the shared memory of a block, even on "
                rf"column tiles of one column each")):
            sk._check_objective(_objective(limit + 1, kind, dtype))


def _routed(n, kind, dtype):
    """_objective, made as the API makes it (not plain): on the card its
    unitary would come from the unitary kernels."""
    obj = _objective(n, kind, dtype)
    obj.plain = False
    return obj


@pytest.mark.parametrize('kind', ['modulo_identity', 'modulo_diagonal'])
def test_modulo_losses_stop_at_eight_qubits(kind):
    """The fused kernel takes the modulo losses to 8 qubits (on a cluster of
    16 blocks) and no more: they read V across columns, which the column
    tiles do not share (ROADMAP A.16b). Past 8 qubits ``route`` sends them
    to the unitary kernels ('unitary': the Adam loop over their unitary,
    the modulo loss taken in torch on it), whose column tiles hold the whole
    unitary to 13 qubits in float32 and 12 in float64; one qubit past that
    no plan holds them, ``route`` leaves them to the fused kernel, and its
    check refuses them, naming both limits. ``torch.device('cuda')`` needs
    no card: the route is chosen from the plans alone."""
    cuda = torch.device('cuda')
    for dtype in (F32, F64):
        limit = uk.MAX_QUBITS[dtype]['unitary']
        sk._check_objective(_objective(8, kind, dtype))
        assert sk.route(_routed(8, kind, dtype), cuda) == 'fused'
        assert sk.tile_plan(9, 2, XYZ, kind, dtype) is None
        for n in (9, limit):
            assert sk.route(_routed(n, kind, dtype), cuda) == 'unitary'
        assert sk.route(_routed(limit + 1, kind, dtype), cuda) == 'fused'
        with pytest.raises(ValueError, match='no plan of the fused kernel '
                           'holds.*plain=True'):
            sk.route(_objective(9, kind, dtype), cuda)
        for n in (9, limit + 1):
            with pytest.raises(ValueError, match=(
                    rf"2 to 8 qubits for a '{kind}' loss in {dtype}, got "
                    rf"{n}: .*the column tiles take no modulo loss.*ROADMAP "
                    rf"A.16b\); sweep\(\) takes it to the unitary kernels, "
                    rf"which hold the whole unitary to {limit} qubits")):
                sk._check_objective(_objective(n, kind, dtype))


@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_unitary_kernels_take_the_new_limit_and_refuse_one_more(
        monkeypatch, dtype):
    """The unitary kernels' shape check on a card (its capability check
    answered as a Hopper's): it refuses one qubit past the new limit before
    it loads or builds anything."""
    monkeypatch.setattr(torch.cuda, 'get_device_capability',
                        lambda device=None: (9, 0))
    limit = uk.MAX_QUBITS[dtype]['unitary']
    with pytest.raises(ValueError, match=(
            rf'2 to {limit} qubits for the whole unitary in {dtype}, got '
            rf'{limit + 1}: above that one column of the state and its '
            rf'cotangent exceeds the shared memory of a block, even on '
            rf'column tiles of one column each')):
        uk._Shape(limit + 1, 'cp', 'xyz', ((0, 1),), None, 2,
                  torch.device('cuda'), True, dtype)


@pytest.mark.parametrize('n,k,needed', [
    (9, 10, 329267357), (10, 12, 1572881130), (11, 12, 6291473457),
    (13, 2, 18790488481)])
def test_sweep_work_at_the_tiles_shapes(n, k, needed):
    """The operations of one restart-iteration at phase 21's shapes, as
    sweep_work counts them for every design (the tiles' repeated prologue
    is not the algorithm's, nor the surface round's n gate passes: it
    counts the product state and its contraction): the (R) row's bound, 8
    restarts x 60 steps over 67 TFLOP/s, is 2.359 ms."""
    work = prof.sweep_work(n, k)
    assert work['needed'] == needed
    assert work['target'] == 4 ** n
    if n == 9:
        ms, by = prof.bound_ms(work, 8, 60)
        assert by == 'operations' and abs(ms - 2.3589303) < 1e-6


# ------------------------------------------------- parity with the JAX package

def _sweep_both(n, k, kind, B, T, seed, dtype, wires=None):
    """(port RawResult, JAX RawResult) of the plain sweep on the n-qubit
    chain with k blocks, target the n-qubit Toffoli, from the same numpy
    angles, in `dtype` (float64: both packages in double precision); a
    modulo loss on `wires`."""
    placements = fill_layers(chain_layer(n), k)
    P = 3 * n + XYZ * k
    cp_mask = np.zeros(P, dtype=np.float32)
    cp_mask[cp_angle_indices(n, XYZ, k)] = 1
    inits = np.random.default_rng(seed).uniform(0, 2 * np.pi, (B, P))
    inits = inits.astype(np.float64 if dtype == F64 else np.float32)
    target = multi_controlled_x(n)
    kw = dict(target=target) if wires is None else \
        dict(target=target, num_qubits=n, wires=wires)
    with double() if dtype == F64 else contextlib.nullcontext():
        obj = tbt.make_batched_regloss(
            n, 'cp', 'xyz', placements, tapi.LossSpec(kind, **kw),
            cp_mask=cp_mask, regularization_func=LinearPenalty(*PEN),
            r=0.002)
        jf = jbt.make_batched_regloss(
            n, 'cp', 'xyz', placements, japi.LossSpec(kind, **kw),
            cp_mask=jnp.asarray(cp_mask),
            regularization_func=lambda a: j_penalty(a, *PEN), r=0.002,
            reversible=True)
        before = sk.LAUNCHES
        raw = engine.minimize_fused(obj, torch.tensor(inits),
                                    learning_rate=0.1, num_iterations=T,
                                    device='cpu')
        assert sk.LAUNCHES == before  # the plain version on a CPU tensor
        jraw = jengine.minimize_fused(jf, inits, learning_rate=0.1,
                                      num_iterations=T)
    assert raw.regloss.dtype == dtype
    return raw, jraw


@pytest.mark.parametrize('n,kind,dtype,B', [
    (9, 'hst', F32, 2), (9, 'disc', F32, 2), (9, 'hst', F64, 1),
    (9, 'disc', F64, 1), (10, 'hst', F32, 1), (11, 'hst', F32, 1)],
    ids=['9q-hst', '9q-disc', '9q-hst-float64', '9q-disc-float64',
         '10q-hst', '11q-hst'])
def test_plain_sweep_past_a_cluster_matches_jax_engine(n, kind, dtype, B):
    raw, jraw = _sweep_both(n, 2, kind, B=B, T=4, seed=90 + n, dtype=dtype)
    _assert_close(raw, jraw)
    assert (raw.regloss[:, 1] < raw.regloss[:, 0]).all()


def test_plain_modulo_sweep_at_nine_qubits_matches_jax_engine():
    """A 9-qubit modulo_diagonal sweep, the loss that ``route`` sends to the
    unitary kernels past 8 qubits: the plain version (the loss taken in
    torch on the whole unitary, as the 'unitary' route takes it on the
    kernels' output) against the JAX engine, 2 restarts, 4 steps, wires
    (2, 7, 0). Tolerance (_assert_close): the initial regularized losses
    within 1e-5 and those after the steps within 1e-4, both scaled by
    max(1, |loss|), the modulo losses starting near d = 512."""
    raw, jraw = _sweep_both(9, 2, 'modulo_diagonal', B=2, T=4, seed=99,
                            dtype=F32, wires=[2, 7, 0])
    _assert_close(raw, jraw)
    assert (raw.regloss[:, 1] < raw.regloss[:, 0]).all()


def test_plain_builder_at_nine_qubits_matches_the_jax_reversible_builder():
    """The unitary within 1e-5, and the vector-Jacobian product of one
    random complex cotangent within 1e-5 scaled by max(1, |gradient|), as
    tests/test_torch_unitary_fn.py holds them at 2 to 8 qubits."""
    n, B = 9, 2
    pl = fill_layers(chain_layer(n), 3)
    a = np.random.default_rng(9).uniform(0, 2 * np.pi, (3 * n + XYZ * 3, B)) \
        .astype(np.float32)
    rev = jbt.make_reversible_builder(n, 'cp', 'xyz', pl)
    ju, pull = jax.vjp(rev, jnp.asarray(a))
    ta = torch.tensor(a, requires_grad=True)
    tu = uk.build_unitary(n, 'cp', 'xyz', pl, ta)
    assert tuple(tu.shape) == tuple(ju.shape) == (2,) * n + (2 ** n, B)
    np.testing.assert_allclose(tu.detach().numpy(), np.asarray(ju), atol=1e-5)
    rng = np.random.default_rng(1)
    w = (rng.normal(size=ju.shape) + 1j * rng.normal(size=ju.shape)) \
        .astype(np.complex64)
    (jg,) = pull(jnp.asarray(w).conj())
    (tg,) = torch.autograd.grad(tu, ta, grad_outputs=torch.tensor(w))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5 * max(
        1.0, float(np.abs(np.asarray(jg)).max())))


# ------------------------------------------------------------------ the card

@pytest.mark.cuda
@pytest.mark.parametrize('kind', sk.TILE_LOSSES)
def test_sweep_kernel_on_tiles_matches_the_plain_version_on_card(kind):
    """The sweep kernel on the column tiles at 9 qubits, k = 4, B = 4, 20
    steps, against its plain version on the card: the initial losses within
    1e-5, the best ones within 1e-4, every launch on the tiles, and two
    launches on the same inputs giving the same bits."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA Hopper card; chip_smoke.py phase 21 '
                    'runs this comparison at 9 to 13 qubits')
    obj, P = chip_smoke.make_objective(9, 4, multi_controlled_x(9), 0.002,
                                       kind=kind)
    init = chip_smoke.uniform_inits(P, 4, 9, 'cuda')
    before = sk.LAUNCHES_BY_CLUSTER['tiles']
    out = sk.sweep(obj, init, 0.1, 20)
    again = sk.sweep(obj, init, 0.1, 20)
    ref = sk.sweep_reference(obj, init, 0.1, 20)
    assert sk.LAUNCHES_BY_CLUSTER['tiles'] == before + 2
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    assert chip_smoke.scaled_err(out.regloss0, ref.regloss0).max() <= 1e-5
    assert chip_smoke.scaled_err(out.best_loss, ref.best_loss).max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_unitary_kernels_on_tiles_match_the_plain_version_on_card(dtype):
    """ansatz_forward and ansatz_vjp at 10 qubits (both on the column tiles)
    against the plain builder under autograd: the unitary within 2e-5, the
    gradient within 1e-4 scaled by max(1, |gradient|)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA Hopper card; chip_smoke.py phase 21 '
                    'runs this comparison at 9 to 13 qubits')
    n, B = 10, 2
    pl = fill_layers(chain_layer(n), 3)
    a = torch.tensor(np.random.default_rng(10).uniform(
        0, 2 * np.pi, (3 * n + XYZ * 3, B)), dtype=dtype, device='cuda')
    ap = a.clone().requires_grad_(True)
    up = tbt.build_unitary_batched(n, 'cp', 'xyz', pl, ap, dtype=dtype)
    up = up.reshape(2 ** n, 2 ** n, B).permute(2, 0, 1)
    g = torch.randn(up.shape, dtype=up.dtype, device='cuda')
    (gp,) = torch.autograd.grad((up * g.conj()).real.sum(), ap)
    before = uk.VJP_LAUNCHES_BY_CLUSTER['tiles']
    u = uk.ansatz_forward(n, 'cp', 'xyz', pl, a)
    gk = uk.ansatz_vjp(n, 'cp', 'xyz', pl, a, u, g)
    assert uk.VJP_LAUNCHES_BY_CLUSTER['tiles'] == before + 1
    assert (u - up.detach()).abs().max().item() <= 2e-5
    assert ((gk - gp).abs() / gp.abs().clamp(min=1.0)).max().item() <= 1e-4

"""The plan of the sweep kernel's column build (kernels/sweep.py), without a
card.

csrc/sweep.cu runs the whole unitary at 2 to 6 qubits (the HS test, disc and
both modulo losses) on its column build, sweep_columns_kernel, on
csrc/columns.cuh's design, wherever its layout fits a block; a state, 7
qubits and up, and a template too deep for that layout take the one-block
and cluster builds (tests/test_torch_sweep_blocks.py). ``column_plan`` and ``column_smem_bytes`` mirror the
library's plan (cpflow_sweep_column_plan), and chip_smoke.py phase 3 holds
the mirror against it on the card. Here the mirror is held to that rule at
every shape phases 3 and 5 run, in both precisions, and its shared-memory
layout is checked term by term. No JAX: the plain sweep at these shapes is
held against the JAX package elsewhere (tests/test_torch_kernel.py,
tests/test_torch_double.py)."""

import pytest
import torch

import chip_smoke
from cpflow_tpu_torch.kernels import sweep as sk
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles
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


def _phase_shapes():
    return chip_smoke.compare_shapes() + [
        s for s, _, _ in chip_smoke.timing_shapes()]


@pytest.mark.parametrize('dtype', DTYPES, ids=['float32', 'float64'])
@pytest.mark.parametrize('name', [s['name'] for s in _phase_shapes()
                                  if 'build' not in s])
def test_phase_shapes_take_the_column_build(name, dtype):
    """Every whole-unitary shape at 2 to 6 qubits of phases 3 and 5 takes the
    column build, in float32 and in float64; its states do not. (The rows
    that name the build they must run are held below.)"""
    s = next(s for s in _phase_shapes() if s['name'] == name)
    n, nb, nba, kind = _args(s)
    plan = sk.column_plan(n, nb, nba, kind, dtype)
    if kind in WHOLE and 2 <= n <= 6:
        assert plan is not None
        warps = sk.sweep_warps(n, dtype)
        assert plan['threads'] == 32 * warps * plan['restarts']
        assert plan['restarts'] == (2 if warps == 1 else 1)
        assert plan['smem_bytes'] == sk.column_smem_bytes(
            n, nb, nba, kind, plan['restarts'], dtype) <= LIMIT
    else:
        assert kind == 'state' and plan is None


@pytest.mark.parametrize('name', [s['name'] for s in _phase_shapes()
                                  if 'build' in s])
def test_phase_rows_off_the_column_build_keep_the_one_block_build(name):
    """Phase 3's rows that name their build run the one-block build in
    their own precision: the whole-unitary ones at 6 qubits with a template
    exactly one block deeper than the column build holds (the column build
    holds one block less), the state one (u) as every state up to 13
    qubits does."""
    s = next(s for s in _phase_shapes() if s['name'] == name)
    dtype = s.get('dtype', torch.float32)
    suffix = '_f64' if dtype == torch.float64 else ''
    assert s['build'] == 'sweep_block' + suffix
    n, nb, nba, kind = _args(s)
    assert sk.column_plan(n, nb, nba, kind, dtype) is None
    assert sk.cluster_plan(n, nb, nba, kind, dtype) == 1
    assert sk.build_of(n, nb, nba, kind, dtype) == s['build']
    if kind in WHOLE:
        assert n == 6
        assert sk.column_plan(n, nb - 1, nba, kind, dtype) is not None
    else:
        assert kind == 'state' and s['name'].startswith('(u)')


@pytest.mark.parametrize('dtype', DTYPES, ids=['float32', 'float64'])
@pytest.mark.parametrize('kind', WHOLE + ('state',))
def test_states_and_wider_shapes_keep_the_other_builds(kind, dtype):
    """A state at any width, and the whole unitary from 7 qubits, never take
    the column build; the fused kernel's other plans hold them as before."""
    for n in range(2, 8):
        plan = sk.column_plan(n, 2 * n, 7, kind, dtype)
        assert (plan is None) == (kind == 'state' or n > 6), n
    assert sk.column_plan(7, 14, 7, kind, dtype) is None
    assert sk.cluster_plan(7, 14, 7, kind, dtype) is not None


@pytest.mark.parametrize('dtype', DTYPES, ids=['float32', 'float64'])
@pytest.mark.parametrize('n', [2, 3, 4, 5, 6])
def test_a_template_too_deep_for_the_layout_keeps_the_other_builds(n, dtype):
    """The deepest template the column build holds at n qubits is one block
    short of one it does not; that one keeps the one-block and cluster
    builds, which still hold it. Up to 4 qubits two restarts a block give
    way to one before the build gives way."""
    nba = num_block_angles('cp', 'xyz')
    deepest = max(nb for nb in range(0, 2000)
                  if sk.column_plan(n, nb, nba, 'hst', dtype) is not None)
    assert sk.column_plan(n, deepest + 1, nba, 'hst', dtype) is None
    assert sk.column_plan(n, deepest, nba, 'hst', dtype)['smem_bytes'] \
        <= LIMIT < sk.column_smem_bytes(n, deepest + 1, nba, 'hst', 1, dtype)
    assert sk.cluster_plan(n, deepest + 1, nba, 'hst', dtype) is not None
    if sk.sweep_warps(n, dtype) == 1:
        two = max(nb for nb in range(0, deepest + 1)
                  if sk.column_plan(n, nb, nba, 'hst', dtype)['restarts'] == 2)
        assert sk.column_plan(n, two + 1, nba, 'hst', dtype)['restarts'] == 1
        assert sk.column_plan(n, two + 1, nba, 'hst', dtype)['threads'] == 32


@pytest.mark.parametrize('dtype', DTYPES, ids=['float32', 'float64'])
@pytest.mark.parametrize('kind', WHOLE)
@pytest.mark.parametrize('n', [2, 3, 4, 5, 6])
def test_layout_is_column_layout_plus_the_adam_state(n, kind, dtype):
    """column_smem_bytes is csrc/columns.cuh's column_layout of the vjp
    (kernels/unitary.py:column_smem_bytes) with a cotangent slot for each of
    the restart's warps, padded to 16 bytes, plus per restart the modulo
    losses' d row sums, both Adam moments and the best angles, and 8 values
    a warp for the sums across warps."""
    nb, nba = 12, num_block_angles('cp', 'xyz')
    P, G = 3 * n + nba * nb, n + nb
    scale = 2 if dtype == torch.float64 else 1
    warps = sk.sweep_warps(n, dtype)
    for restarts in (1, 2):
        layout = uk.column_smem_bytes(n, nb, nba, True, restarts, dtype) + \
            restarts * (warps - uk.column_lanes(n) // 32) * 32 * G * 4 * scale
        pad = -layout % 16
        state = restarts * scale * (
            (8 << n if kind.startswith('modulo') else 0)  # row sums
            + 3 * 4 * P                                   # moments, best
            + 8 * 4 * warps)                              # warps' sums
        assert sk.column_smem_bytes(n, nb, nba, kind, restarts, dtype) == \
            layout + pad + state


@pytest.mark.parametrize('dtype', DTYPES, ids=['float32', 'float64'])
def test_warps_and_lanes_a_column(dtype):
    """One warp a restart up to 4 qubits, 4 at 5 and 8 at 6 (4 in float64);
    a column's amplitude groups are shared by 32 W / 2^n lanes of one warp,
    so the lanes of every warp hold whole columns."""
    want = [1, 1, 1, 4, 4 if dtype == torch.float64 else 8]
    assert [sk.sweep_warps(n, dtype) for n in range(2, 7)] == want
    for n in range(2, 7):
        ways = 32 * sk.sweep_warps(n, dtype) >> n
        assert ways >= 2 and 32 % ways == 0
        assert (1 << n) // sk.sweep_warps(n, dtype) * ways == 32


def test_max_qubits_unchanged():
    """The column build takes no shape that no other plan held before:
    the kernel's qubit limits stay as they were."""
    assert sk.MAX_QUBITS == {
        torch.float32: {'hst': 13, 'state': 17, 'disc': 13,
                        'modulo_identity': 8, 'modulo_diagonal': 8},
        torch.float64: {'hst': 12, 'state': 16, 'disc': 12,
                        'modulo_identity': 8, 'modulo_diagonal': 8}}


def test_build_names_follow_the_library_numbers():
    """occupancy() names the build that cpflow_sweep_occupancy reports:
    out[7] 0 the one-block build, 1 the cluster build, 2 the row tiles, 3
    the column build; no build is held to 128 registers beside another."""
    assert sk.BUILD_NAMES == ('sweep_block', 'sweep_cluster',
                              'sweep_row_tiles', 'sweep_columns')
    assert not hasattr(sk, 'BUILD_HELD')

"""The plan of the unitary kernels (kernels/unitary.py), without a card.

csrc/unitary.cu launches the column design (csrc/columns.cuh: one lane per
column of a restart) for the whole unitary at 2 to 6 qubits, the row-split
design's plan for one column and for the vjp at 7 and 8 qubits (on a
cluster of blocks on csrc/tiles.cuh's warps), and the column tiles for the
forward pass from 7 qubits; ``plan`` mirrors that choice and its sizes for
checks without a card, and chip_smoke.py phase 12 holds the mirror against
the library's own answers on the card. Here the mirror is held to the
documented design at every template phase 12 runs, and its shared-memory
layout is checked term by term."""

import re
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from cpflow_tpu_torch.kernels import tiles as tk
from cpflow_tpu_torch.kernels import unitary as uk
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements, num_block_angles

LIMIT = 232448  # shared memory one block may use on sm_90


def _shape_args(s):
    n = s['n']
    nb = len(all_placements(s['placements']))
    return n, nb, num_block_angles(s['ent'], s['rot']), \
        0 if s.get('columns') else n


@pytest.mark.parametrize('vjp', [False, True])
def test_every_phase_12_template_gets_its_documented_design(vjp):
    for s in chip_smoke.unitary_shapes():
        n, nb, nba, log_c = _shape_args(s)
        p = uk.plan(n, nb, nba, log_c, vjp)
        if log_c == n and n <= 6:
            assert p['design'] == 'columns', s['name']
            assert p['threads_per_restart'] == (32 if n < 5 else 1 << n)
            assert p['restarts_per_block'] == (1 if n == 6 else 2), s['name']
            assert p['threads'] == 64 and p['blocks_per_restart'] == 1
            assert p['smem_bytes'] <= LIMIT
        elif log_c == n and not vjp:  # 7 and 8 qubits: the column tiles
            assert p['design'] == 'tiles', s['name']
            assert p['restarts_per_block'] == 1
            w, tiles = uk.tile_plan(n, nb, nba, log_c, vjp)
            assert p['blocks_per_restart'] == tiles == \
                uk.cluster_plan(n, nb, nba, log_c, vjp)
            assert p['smem_bytes'] == tk.warp_smem_bytes(n, nb, nba, w,
                                                         False) <= LIMIT
        else:  # one column, and the vjp at 7 and 8 qubits: the row-split
            assert p['design'] == 'rows', s['name']  # design's plan
            assert p['restarts_per_block'] == 1
            c = p['blocks_per_restart']
            assert c == uk.cluster_plan(n, nb, nba, log_c, vjp)
            if log_c and c > 1:  # a cluster on tiles.cuh's warps
                w = (1 << n) // c
                assert p['smem_bytes'] == tk.warp_smem_bytes(
                    n, nb, nba, w, True, p['ring']) <= LIMIT
                assert p['ring'] == tk.cluster_ring(n, nb, nba, w) >= 1
            else:  # one column on rows.cuh's warps, one block or a cluster
                rows = uk.rows_launch(n, nb, nba, log_c, vjp)
                assert (p['threads'], p['smem_bytes']) == (
                    rows['threads'], rows['smem_bytes'])
                assert p['smem_bytes'] <= LIMIT
    # the timing shapes of phase 12 too
    for _, n, k, _, rot, _ in chip_smoke.UNITARY_TIMING:
        p = uk.plan(n, k, num_block_angles('cp', rot), n, vjp)
        assert p['design'] == ('columns' if n <= 6 else
                               'rows' if vjp else 'tiles')


def test_the_column_layout_term_by_term():
    # 3q chain k=12 'xyz' cp: P = 93 angles, G = 15 gates, 2 restarts a
    # block; per restart A (64 amplitudes), the gates (16 complex values
    # each), the angles and their cos and sin; the gate codes once
    P, G = 93, 15
    fwd = 2 * (8 * 64 + 128 * G + 12 * P) + 4 * G
    assert uk.column_smem_bytes(3, 12, 7, False, 2) == fwd == 7156
    # the vjp adds M, one 32-float cotangent per gate and the gradient
    assert uk.column_smem_bytes(3, 12, 7, True, 2) == \
        fwd + 2 * (8 * 64 + 128 * G + 4 * P) == 12764
    # 6q connected k=40: one restart of two warps, two cotangent slots
    P, G = 18 + 7 * 40, 46
    fwd = 8 * 4096 + 128 * G + 12 * P + 4 * G
    assert uk.column_smem_bytes(6, 40, 7, False, 1) == fwd
    assert uk.column_smem_bytes(6, 40, 7, True, 1) == \
        fwd + 8 * 4096 + 2 * 128 * G + 4 * P
    p = uk.plan(6, 40, 7, 6, True)
    assert (p['threads_per_restart'], p['restarts_per_block'],
            p['smem_bytes']) == (64, 1, 88152)


def test_a_layout_too_large_takes_one_restart_then_the_row_split():
    for n in (4, 5):
        nb = next(nb for nb in range(1, 4000)
                  if uk.column_smem_bytes(n, nb, 7, True, 2) > LIMIT)
        assert uk.column_smem_bytes(n, nb, 7, True, 1) <= LIMIT
        p = uk.plan(n, nb, 7, n, True)
        assert p['design'] == 'columns' and p['restarts_per_block'] == 1
        assert p['threads'] == 32
        nb = next(nb for nb in range(nb, 8000)
                  if uk.column_smem_bytes(n, nb, 7, True, 1) > LIMIT)
        p = uk.plan(n, nb, 7, n, True)
        assert p is None or p['design'] == 'rows'


def test_the_kernel_names_follow_the_library_order():
    assert len(uk.KERNELS) == 23
    assert uk.KERNELS[13:16] == ('ansatz_forward_column_tiles',
                                 'ansatz_vjp_column_tiles',
                                 'ansatz_vjp_tile_sum')
    assert uk.KERNELS[16:19] == ('ansatz_forward_row_tiles',
                                 'ansatz_vjp_row_tiles',
                                 'ansatz_vjp_tile_gates')
    assert uk.kernel_name('rows', False, 15, 2, column=True) == \
        'ansatz_forward_row_tiles'
    assert uk.kernel_name('rows', True, 13, 1, column=True) == 'ansatz_vjp'
    assert uk.KERNELS[:3] == ('ansatz_forward', 'ansatz_vjp',
                              'ansatz_vjp_cluster')
    assert uk.kernel_name('columns', False, 2) == uk.KERNELS[3]
    assert uk.kernel_name('columns', True, 6) == uk.KERNELS[12]
    assert uk.kernel_name('rows', True, 7, 2) == 'ansatz_vjp_cluster'
    assert uk.kernel_name('rows', True, 4, 1) == 'ansatz_vjp'
    assert uk.kernel_name('rows', False, 8, 4) == 'ansatz_forward'
    assert uk.kernel_name('tiles', True, 9) == 'ansatz_vjp_column_tiles'
    assert uk.DESIGNS == {'rows': 0, 'columns': 1, 'tiles': 2,
                          'global_rows': 3}
    assert uk.KERNELS[19:] == ('ansatz_forward_global_rows',
                               'ansatz_vjp_global_rows',
                               'ansatz_vjp_global_sum', 'ansatz_global_gates')


def _column_sincos_constants():
    src = (Path(uk.__file__).resolve().parents[1] / 'csrc' /
           'columns.cuh').read_text()
    body = src[src.index('void column_sincos('):]
    body = body[:body.index('\n}\n')]
    return [np.float32(float(v)) for v in
            re.findall(r'(-?\d+\.\d+(?:e[+-]?\d+)?)f', body)]


def test_the_column_kernels_sincos_in_float32():
    """column_sincos (csrc/columns.cuh), its constants read from the source
    and its steps repeated in numpy float32 (each fmaf as one rounding of
    the exact float64 result), against float64 sin and cos: within 2 units
    in the last place of float32 in [-50, 50] (the kernels' angles are
    uniform in [0, 2 pi) at the start and move by Adam steps), the bound
    CUDA documents for sinf and cosf."""
    two_over_pi, c1, c2, c3, s0, s1, s2, q0, q1, q2, half = \
        _column_sincos_constants()
    assert half == -0.5
    f = np.float32
    x = np.linspace(-50, 50, 400001, dtype=np.float32)
    j = np.rint(x * two_over_pi).astype(np.float32)
    r = np.float32(j.astype(np.float64) * c1 + x.astype(np.float64))
    r = np.float32(j.astype(np.float64) * c2 + r)
    r = np.float32(j.astype(np.float64) * c3 + r)
    r2 = f(r * r)
    sp = f(r2.astype(np.float64) * s0 + s1)
    sp = f(r2.astype(np.float64) * sp + s2)
    sr = f(f(r * r2).astype(np.float64) * sp + r)
    cp = f(r2.astype(np.float64) * q0 + q1)
    cp = f(r2.astype(np.float64) * cp + q2)
    one = f(r2.astype(np.float64) * half + 1.0)
    cr = f(f(r2 * r2).astype(np.float64) * cp + one)
    q = j.astype(np.int64) & 3
    sv, cv = np.where(q & 1, cr, sr), np.where(q & 1, sr, cr)
    s = np.where(q & 2, -sv, sv)
    c = np.where((q + 1) & 2, -cv, cv)
    xd = x.astype(np.float64)
    for got, want in ((s, np.sin(xd)), (c, np.cos(xd))):
        ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
        assert (np.abs(got - want) / ulp).max() <= 2.0

"""The sweep's column tiles as redesigned for Hopper (csrc/tiles.cuh, the
column tiles section of csrc/sweep.cu): the plan, and the tile kernel's
layout and threads.

  * ``tile_plan`` keeps the rule it had, the fewest tiles whose
    make_layout fits a block, at every depth a template of each rotation
    string and entangler takes; its second test, that the tile kernel's own
    layout fits with a warp for every column, never decides; and below 7
    qubits it takes shapes where a gate has fewer amplitude groups than a
    column has lanes (the lanes past them idle, tiles.cuh);
  * the tile kernel's shared bytes and threads at chip_smoke.py phase 21's
    shapes, as the Python mirror computes them (the card checks the mirror
    against the library, check_plan), and every phase 21 (a) row on the
    tiles it expects.

No JAX: the kernels run only on a card (chip_smoke.py phase 21)."""

import pytest
import torch

import chip_smoke
from cpflow_tpu_torch.kernels import sweep as sk
from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles

F32, F64 = torch.float32, torch.float64
LIMIT = 232448  # shared memory one block may use on sm_90
NBAS = sorted({num_block_angles(e, r) for e in ('cp', 'cz', 'cx')
               for r in ('xyz', 'xz', 'y')})


def _fewest_tiles(n, k, nba, dtype):
    """The first tile kernel's plan: the fewest tiles whose make_layout
    fits."""
    if sk.cluster_plan(n, k, nba, 'hst', dtype) is not None:
        return None
    for j in range(n + 1):
        if sk.smem_bytes(n, k, nba, 'hst', 1 << j, dtype) <= LIMIT:
            return 1 << (n - j), 1 << j
    return None


@pytest.mark.parametrize('n', range(5, 14))
@pytest.mark.parametrize('dtype', [F32, F64], ids=['float32', 'float64'])
def test_tile_plan_keeps_its_rule_and_the_tile_kernel_fits(n, dtype):
    """At n qubits, every k from 0 until no plan holds, every block
    template's angle count: the plan is the fewest tiles that fit
    make_layout, as before the redesign; where it takes the shape, the tile
    kernel's layout fits a block and a block has a warp for every column.
    Below 7 qubits the plan takes shapes whose two-qubit gates have fewer
    amplitude groups (2^(n-2)) than a column has lanes (32 gw)."""
    taken = idle = 0
    for nba in NBAS:
        for k in range(4000):
            want = _fewest_tiles(n, k, nba, dtype)
            for kind in sk.TILE_LOSSES:
                assert sk.tile_plan(n, k, nba, kind, dtype) == want, (n, k)
            if want is None:
                if sk.cluster_plan(n, k, nba, 'hst', dtype) is None:
                    break
                continue
            w, tiles = want
            threads = sk.tile_threads(n, w, dtype)
            assert 32 * w <= threads <= sk.TILE_THREADS[dtype]
            assert threads % (32 * w) == 0
            assert sk.tile_smem_bytes(n, k, w, dtype) <= LIMIT
            taken += 1
            idle += threads // w > 2 ** (n - 2)
    if 9 <= n <= sk.MAX_QUBITS[dtype]['hst']:
        assert taken > 0
        assert sk.MAX_QUBITS[dtype]['hst'] == (13 if dtype == F32 else 12)
    assert (idle > 0) == (n < 7), (taken, idle)


# (n, k, dtype, columns a tile, tiles, threads, tile kernel's shared bytes)
# at phase 21 (a)'s rows (R)-(W) and (Z1)-(Z4); (X)-(Z) share (R)'s plan
PHASE21 = [(9, 10, F32, 16, 32, 512, 166824),
           (9, 10, F64, 8, 64, 256, 169256),
           (10, 12, F32, 8, 128, 512, 167104),
           (11, 12, F32, 4, 512, 512, 167176),
           (12, 2, F64, 1, 4096, 256, 167712),
           (13, 2, F32, 1, 8192, 512, 166040),
           (6, 500, F32, 2, 32, 64, 75024),
           (5, 508, F32, 1, 32, 32, 72368),
           (6, 243, F64, 2, 32, 64, 78136),
           (5, 251, F64, 1, 32, 32, 72768)]


@pytest.mark.parametrize('n,k,dtype,w,tiles,threads,nbytes', PHASE21,
                         ids=['R', 'S', 'T', 'U', 'V', 'W', 'Z1', 'Z2', 'Z3',
                              'Z4'])
def test_tile_kernel_layout_at_phase_21_shapes(n, k, dtype, w, tiles,
                                               threads, nbytes):
    """The plan (the first tile kernel's), 16 warps a block in float32 and
    8 in float64 (a float block held to 128 registers a thread fills an
    SM's 65,536) where a tile has the amplitudes for them, and the layout:
    A and M 2 w (2^n + 1) complex, the gates, the ring of 16 gates x 32
    reals a warp, each warp's share of s, 16 bytes of mbarrier and flag, 8
    bytes of row bits a gate. From 9 qubits one block an SM by shared memory;
    (Z1)-(Z4) have more lanes a column than a two-qubit gate has groups."""
    nba = num_block_angles('cp', 'xyz')
    assert sk.tile_plan(n, k, nba, 'hst', dtype) == (w, tiles)
    assert sk.tile_threads(n, w, dtype) == threads
    assert sk.tile_smem_bytes(n, k, w, dtype) == nbytes
    assert (2 * nbytes > LIMIT) == (n >= 9)
    assert (threads // w > 2 ** (n - 2)) == (n < 7)
    f = 2 if dtype == F64 else 1
    G, warps = n + k, threads // 32
    amps = -(-2 * w * (2 ** n + 1) * 8 * f // 16) * 16
    assert nbytes == amps + 128 * f * G + (32 * 16 + 2) * warps * 4 * f + \
        16 + 8 * G


@pytest.mark.parametrize('row', range(13))
def test_phase_21_rows_run_on_the_tiles_they_name(row):
    """Each row of chip_smoke.py phase 21 (a) runs on the column tiles, as
    many a restart as its `cluster` says, in its dtype, for every trial of
    a bucketed row: the card checks the same against the library's plan."""
    s = chip_smoke.nine_shapes()[row]
    assert len(chip_smoke.nine_shapes()) == 13
    nba = num_block_angles(s.get('ent', 'cp'), s.get('rot', 'xyz'))
    for k in s.get('ks', (s.get('k'),)):
        plan = sk.tile_plan(s['n'], k, nba, s.get('kind', 'hst'),
                            s.get('dtype', F32))
        assert plan is not None and plan[1] == s['cluster'], (s['name'], k)

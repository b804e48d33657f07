#!/usr/bin/env python3
"""Times builds of the sweep kernel against each other, in turns, on one
NVIDIA Hopper card, and profiles the column tiles' and the row tiles' steps.

Run from the root of the repository:

    python3 sweep_ab.py OLD/cpflow_tpu_torch/csrc/sweep.cu \\
        cpflow_tpu_torch/csrc/sweep.cu
    python3 sweep_ab.py --tiles OLD/.../sweep.cu cpflow_tpu_torch/csrc/sweep.cu
    python3 sweep_ab.py --rows --profile OLD/.../sweep.cu \\
        cpflow_tpu_torch/csrc/sweep.cu
    python3 sweep_ab.py --blocks [--double] OLD/.../sweep.cu \\
        cpflow_tpu_torch/csrc/sweep.cu

for example with OLD the parent commit unpacked by ``git archive`` into
``build/``. Each source must export the functions this tree's
kernels/sweep.py binds (``bind``); the parent's, from before the row
schedule, lacks cpflow_sweep_row_plan and is given a stand-in that answers
this tree's plan (kernels/sweep.py:row_plan), whose schedule its
sweep_rows_kernel never reads; one from before the column build lacks
cpflow_sweep_column_plan and is given one that answers no column plan, so
that the wrapper launches it as it was; one from before the one-block and
cluster builds on rows.cuh's and tiles.cuh's warps lacks
cpflow_sweep_block_plan and cpflow_sweep_cluster_layout, and is given ones
that answer this tree's plans (``block_plan``, ``cluster_layout``), whose
schedule its one-block build never reads. Each is built with nvcc for sm_90a into
build/ab/ (with ``--tiles`` or ``--rows`` also its double build,
-DCPFLOW_DOUBLE; all builds side by side) and its ptxas report printed.

Without ``--tiles`` every build times the kernel alone (CUDA events, the
faster of two calls after a warm-up) at chip_smoke.py's phase-5 shapes and
at the static CCZ shape with batches that put about 1, 2 and 2.75 one-warp
restarts on each SM sub-partition of an H100 (132 SMs, 4 sub-partitions
each). ``--double`` does the same with each source's double build at those
shapes (and at a 2-qubit one) in float64. With ``--tiles`` it times the column tiles' rows of chip_smoke.py
phase 21 (a) at their T, in both precisions: each call (CUDA events, the
fastest of three calls after a warm-up call), and the tile kernels alone
on the card in one call (torch.profiler, chip_smoke.device_kernels), which
leaves out the wrapper's copy of the target to the card. With ``--rows``
it does the same for the row tiles: chip_smoke.py phase 20 (a)'s sweep
rows (L)-(Q) and the GHZ-14 search's shape (phase 20 (d): 14q k=15
B=256 T=1000) in float32 and in float64, the kernel alone being
sweep_rows_kernel. With ``--blocks`` it times the shapes of the one-block
and cluster builds (``block_shapes``): chip_smoke.py phase 15's rows and
the Toffoli-7 program's sweep (its warm batch of 64 at k=144, 2000 steps)
on clusters, phase 3's (e), (f), (u), (s) and (t) and the GHZ-13 search's
shape on one block; with ``--double`` as well, those rows' float64
shapes (phase 3's (f), (s64) and (t64), phase 18's (F), phase 19's (G)
and (K)) in float64 instead. The builds run in turns (A B ... B A); it prints one
row per shape with every build's times in ms, the bound
(utils/profiling.py) and the share of the fastest call.

``--profile`` then traces one call of each tiles, rows or blocks row with
each build (chip_smoke.device_kernels): every kernel's launches, total and mean
time on the card, their sum against the call's span on the stream (CUDA
events), whose rest is the card's idle share, and the kernel's registers,
local bytes, threads, warps and resident blocks or clusters
(``sk.occupancy``).
"""

from __future__ import annotations

import ctypes
import hashlib
from pathlib import Path
import re
import subprocess
import sys


def start_build(source: Path, double: bool):
    """Starts nvcc for one build of `source`; returns (library path, job or
    None if built)."""
    from cpflow_tpu_torch.kernels import build as kb
    # a source may include headers that lie beside it: hash its directory
    digest = hashlib.sha1(b''.join(
        p.read_bytes() for p in sorted(source.parent.iterdir())
        if p.is_file())).hexdigest()[:12]
    out = Path(__file__).resolve().parent / 'build' / 'ab' / (
        f'{digest}{"_f64" if double else ""}.so')
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = ['-DCPFLOW_DOUBLE'] if double else []
    return out, subprocess.Popen(kb.command(source, out, flags),
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def finish_build(source: Path, double: bool, out: Path, proc) -> ctypes.CDLL:
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {source}:\n{err}')
    report = [line.strip() for line in err.splitlines()
              if 'registers' in line or 'spill' in line or
              'Compiling entry' in line]
    print(f'{source}{" (double)" if double else ""}:\n  ' +
          '\n  '.join(report), flush=True)
    lib = ctypes.CDLL(str(out))
    if not hasattr(lib, 'cpflow_sweep_row_plan'):  # the parent's
        def row_plan(n, nb, nba, got, dtype=(torch.float64 if double else
                                             torch.float32)):
            got[3] = sk.row_plan(n, nb, nba, dtype)['segment']
            return 0
        lib.cpflow_sweep_row_plan = row_plan
    if not hasattr(lib, 'cpflow_sweep_column_plan'):  # before the column
        def column_plan(n, nb, nba, loss, got):         # build: none
            got[0] = got[1] = got[2] = 0
            return 0
        lib.cpflow_sweep_column_plan = column_plan
    dtype = torch.float64 if double else torch.float32
    kind_of = {v: k for k, v in sk.LOSS_CODES.items()}
    if not hasattr(lib, 'cpflow_sweep_block_plan'):  # before the one-block
        def block_plan(n, nb, nba, loss, B, got):    # build on rows.cuh
            p = sk.block_plan(n, nb, nba, kind_of[loss], dtype)
            if p is None:
                return 1
            got[3] = p['segment']
            return 0
        lib.cpflow_sweep_block_plan = block_plan
    if not hasattr(lib, 'cpflow_sweep_cluster_layout'):
        lib.cpflow_sweep_cluster_layout = lambda *args: 1
    return sk.bind(lib, double)


def shapes():
    """[(label, shape dict, steps)]: phase 5's rows, then the static CCZ
    shape at batches of 528, 1056, 1452 and 2904 restarts."""
    import chip_smoke as c
    from cpflow_tpu_torch.ops.gates import multi_controlled_x, u_ccz3
    named = {s['name'][:3]: s for s in c.compare_shapes()}
    ccz = dict(n=3, k=12, target=u_ccz3, r=0.00055)
    return ([('3q CCZ k=12 B=1024', dict(ccz, B=1024), 2000),
             ('5q Toffoli k=20 B=2048', dict(n=5, k=20, r=0.00055, B=2048,
                                             target=multi_controlled_x(5)),
              500),
             ('(d) B=4x256', named['(d)'], 2000),
             ('(f) B=256', named['(f)'], 500),
             ('(g) B=256', named['(g)'], 500),
             ('(h) B=256', named['(h)'], 2000)] +
            [(f'3q CCZ k=12 B={B}', dict(ccz, B=B), 2000 if B < 2000 else 1000)
             for B in (528, 1056, 1452, 2904)])


def tile_shapes():
    """[(label, shape dict, steps)]: chip_smoke.py phase 21 (a)'s rows."""
    import chip_smoke as c
    return [(s['name'], s, s.get('T', 60)) for s in c.nine_shapes()]


def row_shapes():
    """[(label, shape dict, steps)]: chip_smoke.py phase 20 (a)'s rows, then
    the GHZ-14 search's shape (phase 20 (d)) in float32 and float64."""
    import torch
    import chip_smoke as c
    search = dict(name='(d) GHZ-14 search 14q k=15 B=256', n=14,
                  k=c.GHZ14_SEARCH['k'], target=c.ghz(14), kind='state',
                  B=c.GHZ14_SEARCH['samples'], r=0.001, lr=0.1,
                  T=c.GHZ14_SEARCH['steps'])
    return [(s['name'], s, s['T']) for s in c.split_shapes()] + [
        (search['name'], search, search['T']),
        (search['name'] + ' float64', dict(search, dtype=torch.float64),
         search['T'])]


def block_shapes(double: bool):
    """[(label, shape dict, steps)] of --blocks: float32, or with double
    the float64 rows."""
    import torch
    import chip_smoke as c
    F64 = torch.float64
    p3 = {s['name'].split()[0]: s for s in c.compare_shapes()}
    if double:
        p15 = {s['name'].split()[0]: s for s in c.sixteen_shapes()}
        p18 = {s['name'].split()[0]: s for s in c.double_shapes()}
        return [('(f) float64', dict(p3['(f)'], dtype=F64), 500),
                (p3['(s64)']['name'], p3['(s64)'], 60),
                (p3['(t64)']['name'], p3['(t64)'], 60),
                (p18['(F)']['name'] + ' float64', dict(p18['(F)'], dtype=F64),
                 60),
                (p15['(G)']['name'], p15['(G)'], 60),
                (p15['(K)']['name'], p15['(K)'], 60)]
    seven = [(s['name'], s, s.get('T', 60)) for s in c.seven_shapes()]
    _, _, placements, _ = c.toffoli7_program()
    toffoli = dict(name='Toffoli-7 program k=144 B=64', n=7, k=144,
                   target=None, placements={'free': placements}, B=64,
                   r=1e-4, lr=0.1, toffoli7=True)
    search = dict(name='GHZ-13 search 13q k=14 B=1024', n=13, k=c.GHZ13_K,
                  target=c.ghz(13), kind='state', B=c.GHZ13_SAMPLES,
                  r=0.001, lr=0.1)
    return seven + [(toffoli['name'], toffoli, 2000)] + [
        (p3[k]['name'], p3[k], 500 if k == '(f)' else 60)
        for k in ('(e)', '(f)', '(u)', '(s)', '(t)')] + [
        (search['name'], search, 200)]


def inputs(s, seed):
    """(objective, initial angles, mask) of a shape in its dtype."""
    import numpy as np
    import torch
    import chip_smoke as c
    if s.get('toffoli7'):  # the warm batch of chip_smoke.py phase 15 (b)
        from cpflow_tpu_torch.api import Ansatz
        from cpflow_tpu_torch.ops.gates import multi_controlled_x
        _, _, placements, exact = c.toffoli7_program()
        pl = {'layers': [[], 0], 'free': placements}
        obj, _ = c.make_objective(7, len(placements), multi_controlled_x(7),
                                  s['r'], placements=pl)
        warm, _ = c.build_warm_batch(
            exact.astype(np.float32),
            np.asarray(Ansatz(7, 'cp', pl, 'xyz').cp_mask, dtype=np.float64),
            s['B'], 0)
        return obj, torch.tensor(warm.T.copy(), device='cuda'), None
    obj, init, mask = c.shape_inputs(s, seed)
    dtype = s.get('dtype', torch.float32)
    if dtype != torch.float32:
        obj = c.shape_objective(s, dtype)[0]
        init = init.to(dtype)
    return obj, init, mask


def kernel_ms(call, name):
    """ms the kernels whose name holds `name` take on the card in one
    call."""
    import chip_smoke as c
    return sum(ms for key, (_, ms) in c.device_kernels(call, 1).items()
               if name in key)


def profile(rows, card):
    """--profile: one traced call of each row with the current build."""
    import chip_smoke as c
    from cpflow_tpu_torch.kernels import sweep as sk
    print(f'profile on {card} (torch.profiler, one call after a warm-up):')
    for label, (obj, init, mask, s), T in rows:
        occ = sk.occupancy(obj, s['B'])
        spans = []  # the traced call's span on the stream
        events = c.device_kernels(lambda: spans.append(c.timed(
            lambda: sk.sweep(obj, init, s['lr'], T, mask))[1]), 1)
        kernels = [(re.sub(r'\(anonymous namespace\)::', '',
                           name).split('(')[0], count, ms)
                   for name, (count, ms) in events.items() if ms > 0]
        span = spans[-1]
        busy = sum(k[2] for k in kernels)
        where = (f'{occ["tiles"]} tiles of {occ["columns"]} columns; second '
                 f'kernel {occ["adam_registers"]} registers' if 'tiles' in occ
                 else f'{occ["cluster"]} blocks a restart, '
                 f'{occ["active_clusters"]} clusters resident')
        print(f'{label} T={T}: span {span:.3f} ms, on the card (kernels '
              f'and copies) {busy:.3f} ms, '
              f'idle {max(0.0, 1 - busy / span):.1%}; kernel '
              f'{occ["registers"]} registers, {occ["local_bytes"]} local '
              f'bytes, {occ["threads"]} threads, {occ["blocks_per_sm"]} '
              f'block(s) and {occ["warps_per_sm"]} warps per SM, {where}',
              flush=True)
        for name, count, ms in sorted(kernels, key=lambda k: -k[2]):
            print(f'  {name}: {count} launches, {ms:.3f} ms, '
                  f'{ms / count * 1e3:.1f} us each, {ms / busy:.1%}',
                  flush=True)


def main(argv) -> int:
    import torch
    import chip_smoke as c
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.utils.profiling import bound_ms
    tiles = '--tiles' in argv
    split = '--rows' in argv  # the row tiles
    double = '--double' in argv  # the default shapes in float64
    blocks = '--blocks' in argv  # the one-block and cluster builds
    prof = '--profile' in argv
    sources = [Path(a) for a in argv if not a.startswith('--')]
    if not sources or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    precisions = (False, True) if tiles or split else \
        (True,) if double else (False,)
    if blocks:
        precisions = (double,)
    jobs = [(src, f64, *start_build(src, f64)) for src in sources
            for f64 in precisions]
    built = [finish_build(*job) for job in jobs]
    dtypes = [torch.float64 if f64 else torch.float32 for f64 in precisions]
    libs = [dict(zip(dtypes, built[i:i + len(precisions)]))
            for i in range(0, len(built), len(precisions))]
    card = c.card_line()
    alone_name = 'sweep_tile' if tiles else 'sweep_rows_kernel'
    if blocks:
        rows = [(label, (*inputs(s, s.get('seed', 7)), s), T)
                for label, s, T in block_shapes(double)]
        calls = 2
    elif tiles or split:
        rows = [(label, (*inputs(s, s.get('seed', 7)), s), T)
                for label, s, T in (tile_shapes() if tiles else
                                    row_shapes())]
        calls = 3
    elif double:
        from cpflow_tpu_torch.ops.gates import multi_controlled_x
        two = dict(n=2, k=4, target=multi_controlled_x(2), r=0.00055, B=1024)
        rows = [(label + ' float64', (*inputs(s, s.get('seed', 7)), s), T)
                for label, s, T in
                [('2q CNOT k=4 B=1024', two, 2000)] + shapes()
                for s in [dict(s, dtype=torch.float64)]]
        calls = 2
    else:
        rows = [(label, (*c.shape_inputs(s, s.get('seed', 7)), s), T)
                for label, s, T in shapes()]
        calls = 2
    times = [[[] for _ in rows] for _ in libs]
    alone = [[[] for _ in rows] for _ in libs]  # the kernels alone
    order = list(range(len(libs)))
    for i in order + order[::-1]:
        sk._libs.update(libs[i])
        for r, (_, (obj, init, mask, s), T) in enumerate(rows):
            lr = s.get('lr', 0.1)
            call = lambda: sk.sweep(obj, init, lr, T, mask)
            sk.sweep(obj, init, lr, 2, mask)
            times[i][r].append(min(c.timed(call)[1] for _ in range(calls)))
            if tiles or split:
                alone[i][r].append(kernel_ms(call, alone_name))
    print(card)
    for r, (label, (obj, _, _, s), T) in enumerate(rows):
        work = c.shape_work(dict(s, dtype=obj.dtype))
        b_ms, by = bound_ms(work, s['B'], T)
        best = min(min(t[r]) for t in times)
        print(f'{label} T={T}: ' + '; '.join(
            ' / '.join(f'{ms:.2f}' for ms in times[i][r])
            for i in range(len(libs))) +
            (' (kernels alone ' + '; '.join(
                ' / '.join(f'{ms:.2f}' for ms in alone[i][r])
                for i in range(len(libs))) + ')' if tiles or split else '') +
            f' (bound {b_ms:.3f} ms by {by}, fastest {b_ms / best:.2%})',
            flush=True)
    if prof and (tiles or split or blocks):
        for source, lib in zip(sources, libs):
            sk._libs.update(lib)
            print(f'{source}:')
            profile(rows, card)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

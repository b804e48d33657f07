#!/usr/bin/env python3
"""Times builds of the sweep kernel against each other, in turns, on one
NVIDIA Hopper card, and profiles the column tiles' step.

Run from the root of the repository:

    python3 sweep_ab.py OLD/cpflow_tpu_torch/csrc/sweep.cu \\
        cpflow_tpu_torch/csrc/sweep.cu
    python3 sweep_ab.py --tiles OLD/.../sweep.cu cpflow_tpu_torch/csrc/sweep.cu
    python3 sweep_ab.py --tiles --profile cpflow_tpu_torch/csrc/sweep.cu

for example with OLD an earlier commit unpacked by ``git archive`` into
``build/``. Each source must export the functions this tree's
kernels/sweep.py binds (``bind``); a source from before the cluster build,
which lacks cpflow_sweep_cluster, is given a stand-in that answers one, and
one from before the tiles' workspace (cpflow_sweep_tile_workspace, the
column tiles of an older design) one that sizes its partials alone, and
one that answers 0 for the tile kernel's shared bytes, which only
chip_smoke.py's plan check reads. Each is built with nvcc for sm_90a into
build/ab/ (with ``--tiles`` also its double build, -DCPFLOW_DOUBLE; all
builds side by side) and its ptxas report printed.

Without ``--tiles`` every build times the kernel alone (CUDA events, the
faster of two calls after a warm-up) at chip_smoke.py's phase-5 shapes and
at the static CCZ shape with batches that put about 1, 2 and 2.75 one-warp
restarts on each SM sub-partition of an H100 (132 SMs, 4 sub-partitions
each). With ``--tiles`` it times the column tiles' rows of chip_smoke.py
phase 21 (a) at their T, in both precisions: each call (CUDA events, the
fastest of three calls after a warm-up call), and the tile kernels alone
on the card in one call (torch.profiler, chip_smoke.device_kernels), which
leaves out the wrapper's copy of the target to the card. The builds run in
turns (A B ... B A); it prints one row per shape with every build's times
in ms, the bound (utils/profiling.py) and the share of the fastest call.

``--profile`` then traces one call of each tiles row with each build
(chip_smoke.device_kernels): every kernel's launches, total and mean time
on the card, their sum against the call's span on the stream (CUDA events),
whose rest is the card's idle share, and the tile kernel's registers, local
bytes and resident blocks (``sk.occupancy``).
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
    if not hasattr(lib, 'cpflow_sweep_cluster'):
        lib.cpflow_sweep_cluster = lambda *shape: 1
    if not hasattr(lib, 'cpflow_sweep_tile_workspace') and \
            hasattr(lib, 'cpflow_sweep_tile_partials'):
        partials = lib.cpflow_sweep_tile_partials
        partials.argtypes = [ctypes.c_int] * 4
        partials.restype = ctypes.c_longlong
        lib.cpflow_sweep_tile_workspace = \
            lambda n, nb, nba, loss, B: B * partials(n, nb, nba, loss)
    if not hasattr(lib, 'cpflow_sweep_tile_smem_bytes'):
        lib.cpflow_sweep_tile_smem_bytes = lambda *shape: 0
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


def inputs(s, seed):
    """(objective, initial angles, mask) of a shape in its dtype."""
    import torch
    import chip_smoke as c
    obj, init, mask = c.shape_inputs(s, seed)
    dtype = s.get('dtype', torch.float32)
    if dtype != torch.float32:
        obj = c.shape_objective(s, dtype)[0]
        init = init.to(dtype)
    return obj, init, mask


def tile_ms(call):
    """ms the column tiles' kernels take on the card in one call."""
    import chip_smoke as c
    return sum(ms for name, (_, ms) in c.device_kernels(call, 1).items()
               if 'sweep_tile' in name)


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
        print(f'{label} T={T}: span {span:.3f} ms, on the card (kernels '
              f'and copies) {busy:.3f} ms, '
              f'idle {max(0.0, 1 - busy / span):.1%}; tile kernel '
              f'{occ["registers"]} registers, {occ["local_bytes"]} local '
              f'bytes, {occ["threads"]} threads, {occ["blocks_per_sm"]} '
              f'block(s) and {occ["warps_per_sm"]} warps per SM, '
              f'{occ.get("tiles")} tiles of '
              f'{occ.get("columns")} columns; second kernel '
              f'{occ.get("adam_registers")} registers', flush=True)
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
    prof = '--profile' in argv
    sources = [Path(a) for a in argv if not a.startswith('--')]
    if not sources or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    precisions = (False, True) if tiles else (False,)
    jobs = [(src, double, *start_build(src, double)) for src in sources
            for double in precisions]
    built = [finish_build(*job) for job in jobs]
    libs = [dict(zip((torch.float32, torch.float64)[:len(precisions)],
                     built[i:i + len(precisions)]))
            for i in range(0, len(built), len(precisions))]
    card = c.card_line()
    if tiles:
        rows = [(label, (*inputs(s, s.get('seed', 7)), s), T)
                for label, s, T in tile_shapes()]
        calls = 3
    else:
        rows = [(label, (*c.shape_inputs(s, s.get('seed', 7)), s), T)
                for label, s, T in shapes()]
        calls = 2
    times = [[[] for _ in rows] for _ in libs]
    alone = [[[] for _ in rows] for _ in libs]  # --tiles: the kernels alone
    order = list(range(len(libs)))
    for i in order + order[::-1]:
        sk._libs.update(libs[i])
        for r, (_, (obj, init, mask, s), T) in enumerate(rows):
            lr = s.get('lr', 0.1)
            call = lambda: sk.sweep(obj, init, lr, T, mask)
            sk.sweep(obj, init, lr, 2, mask)
            times[i][r].append(min(c.timed(call)[1] for _ in range(calls)))
            if tiles:
                alone[i][r].append(tile_ms(call))
    print(card)
    for r, (label, (_, _, _, s), T) in enumerate(rows):
        work = c.shape_work(s) if 'dtype' not in s else \
            c.sweep_work(s['n'], s['k'], dtype=s['dtype'])
        b_ms, by = bound_ms(work, s['B'], T)
        best = min(min(t[r]) for t in times)
        print(f'{label} T={T}: ' + '; '.join(
            ' / '.join(f'{ms:.2f}' for ms in times[i][r])
            for i in range(len(libs))) +
            (' (kernels alone ' + '; '.join(
                ' / '.join(f'{ms:.2f}' for ms in alone[i][r])
                for i in range(len(libs))) + ')' if tiles else '') +
            f' (bound {b_ms:.3f} ms by {by}, fastest {b_ms / best:.2%})',
            flush=True)
    if prof and tiles:
        for source, lib in zip(sources, libs):
            sk._libs.update(lib)
            print(f'{source}:')
            profile(rows, card)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

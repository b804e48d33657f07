#!/usr/bin/env python3
"""Times builds of the unitary kernels (csrc/unitary.cu) against each other,
in turns, on one NVIDIA Hopper card.

Run from the root of the repository:

    python3 unitary_ab.py cpflow_tpu_torch/csrc/unitary.cu \\
        build/variant/unitary.cu

for example with build/variant/ a copy of cpflow_tpu_torch/csrc/ with one
change. Each source must export cpflow_unitary_launch with the arguments
of this tree's kernels/unitary.py (the design and the row schedule among
them, as the --block mode passes them); each is built with nvcc for
sm_90a into build/ab/, and its column kernels' ptxas lines at 3 and 4
qubits are printed. Then, at every shape of chip_smoke.py's
UNITARY_TIMING up to 6 qubits, the row-split design of the first build
(one block a restart, with this tree's row schedule of its segment,
kernels/unitary.py:rows_launch) and the column design of every build run
in turns (rows, each build, each build in reverse, rows), the forward pass
and the vjp 20 times each, and one torch.profiler trace of the card per
build and turn gives each kernel alone (the names of chip_smoke.py's
TRACE_NAMES). It prints one row per shape: the mean ms of each, and the
largest difference of each build's U and gradient from the row-split
design's.

    python3 unitary_ab.py --rows OLD/cpflow_tpu_torch/csrc/unitary.cu \\
        cpflow_tpu_torch/csrc/unitary.cu

times the row tiles instead (one column split by rows over a cluster): at
every row of chip_smoke.py's SPLIT_UNITARY and at the paths' shapes
(ROW_PATHS: the GHZ-15 and float64 GHZ-14 L1 runs of phase 20 (c)), in
its precision (each source is built in float and in double), the builds
in turns (A B ... B A), the vjp (vjp_rows_kernel) and the forward pass
beside it (the row tiles' forward_rows_kernel, or forward_block_kernel
where the forward pass fits one block) alone on the card, the mean over 20
launches of each by torch.profiler (chip_smoke.device_ms). Each launch
hands the kernel this tree's row schedule (kernels/rows.py) for the
segment of this tree's plan of its pass (kernels/unitary.py:rows_launch,
one block's too), which a source whose kernel does not run the schedule
never reads. It prints one row per shape: each build's ms in
turns, the bounds of both passes (chip_smoke.unitary_bound_ms) and their
shares of the fastest, and the largest difference of each build's U and
gradient from the first build's.

    python3 unitary_ab.py --tiles OLD/cpflow_tpu_torch/csrc/unitary.cu \\
        cpflow_tpu_torch/csrc/unitary.cu

times the column tiles (the whole unitary past what a cluster of 16 blocks
holds) the same way, at every row of chip_smoke.py's NINE_UNITARY and at
the paths' shapes (TILE_PATHS: phase 21 (d)'s custom losses at 9 qubits in
float64 and 10 in float32, phase 21 (f)'s 9-qubit modulo runs): the vjp's
kernels alone (its prologue where the source has one, the tiles' walk and
the sum, each and together) and the forward pass beside them, each build
with its own workspace (cpflow_unitary_tile_partials), and the bound of
the vjp. Its last path, phase 19 (c)'s custom loss at 8 qubits in float64,
runs the vjp on a cluster of 16 blocks (vjp_kernel, timed alone) beside
the forward pass.

    python3 unitary_ab.py --cluster OLD/cpflow_tpu_torch/csrc/unitary.cu \
        cpflow_tpu_torch/csrc/unitary.cu

times the kernels of the whole unitary from 7 qubits that run outside the
column design and the vjp's column tiles (CLUSTER_SHAPES: the 7q and 8q
rows of chip_smoke.py's UNITARY_TIMING and SIXTEEN_UNITARY, phase 19 (c)'s
path, every row of NINE_UNITARY and the column tiles' paths): the vjp on a
cluster (vjp_kernel) where the plan puts it there, and the forward pass at
every row, each launched as the build's own plan says
(cpflow_unitary_design: the column tiles, or the row-split plan's
independent blocks), in turns (A B ... B A), each kernel alone by
torch.profiler (the mean of 20 launches). Where cpflow_unitary_tiles_launch
also takes a cluster row, the column tiles' three-kernel vjp of each build
is timed beside it as a yardstick.

    python3 unitary_ab.py --block OLD/cpflow_tpu_torch/csrc/unitary.cu \
        cpflow_tpu_torch/csrc/unitary.cu

times the pair on one block (the row-split design's plan with no
cluster: one column, and the whole unitary past the column design's
depths) at every row of chip_smoke.py's BLOCK_UNITARY: each pass the row
drives, launched in the row-split design, every build in turns (A B ... B
A), each kernel alone by torch.profiler (the mean of 20 launches), with
the bound of each pass (chip_smoke.unitary_bound_ms). Each launch takes
this tree's row schedule for the segment of this tree's plan of the pass
on rows.cuh's warps (kernels/unitary.py:rows_launch; the whole unitary's
for segment n), which a source that does not run the schedule never
reads; a vjp row's U is this tree's forward pass of the same angles.

    python3 unitary_ab.py --global OLD/cpflow_tpu_torch/csrc/unitary.cu \
        cpflow_tpu_torch/csrc/unitary.cu

times the global row tiles (one column past what a cluster holds) at
every row of chip_smoke.py's GLOBAL_UNITARY, phase 23 (c)'s shapes among
them: each build with its own schedule and launch arguments (the
kernels/rows.py that lies beside its csrc/, its library's own plan and
workspace; a build from before the prologue has PR 21's interface), and
a build with the prologue at each number of blocks an SM its plan takes
(1 and 2, the one the wrapper picks marked), every variant in turns (A B
... B A), the forward pass and the vjp each alone on the card
(chip_smoke.traced_calls: its passes, the vjp's sum and the prologue, ms a
call), beside the bounds of chip_smoke.unitary_bound_ms and the passes of
each variant's schedule.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
from pathlib import Path
import subprocess
import sys


def build(source: Path, double: bool = False) -> ctypes.CDLL:
    from cpflow_tpu_torch.kernels import build as kb
    # a source includes the headers that lie beside it: hash its directory
    digest = hashlib.sha1(b''.join(
        p.read_bytes() for p in sorted(source.parent.iterdir())
        if p.is_file())).hexdigest()[:12]
    out = Path(__file__).resolve().parent / 'build' / 'ab' / \
        f'unitary_{digest}{"_f64" if double else ""}.so'
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(kb.command(source, out, ['-DCPFLOW_DOUBLE'] if
                                     double else []), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {source}:\n{proc.stderr}')
    entry = rows = None  # the kernel whose ptxas lines follow
    for line in proc.stderr.splitlines():
        if 'Compiling entry' in line:
            entry = line if 'column' in line and (
                'ILi3E' in line or 'ILi4E' in line) else None
            rows = line.split("'")[1] if 'rows_kernel' in line else None
        elif entry and ('stack' in line or 'registers' in line):
            name = 'forward' if 'forward' in entry else 'vjp'
            print(f'{source}: column_{name}<{entry.split("ILi")[1][0]}> '
                  f'{line.strip()}', flush=True)
        elif rows and ('stack' in line or 'registers' in line):
            print(f'{source}{" (double)" if double else ""}: {rows} '
                  f'{line.strip()}', flush=True)
    lib = ctypes.CDLL(str(out))
    ptr, i = ctypes.c_void_p, ctypes.c_int
    # the row schedule's two trailing arguments, which a source from before
    # it never reads
    lib.cpflow_unitary_launch.argtypes = [ptr] * 6 + [i] * 9 + [ptr, ptr, i]
    lib.cpflow_unitary_launch.restype = i
    return lib


# the paths' shapes of the row tiles (phase 20 (c)'s L1 runs: GHZ-n on the
# chain at k = n - 1, 32 restarts) and of the column tiles (phase 21 (d)'s
# custom losses, (f)'s modulo runs), as (n, k, rotations, B, dtype, name)
ROW_PATHS = [(15, 14, 'xyz', 32, 'float32', 'GHZ-15 L1'),
             (14, 13, 'xyz', 32, 'float64', 'GHZ-14 L1')]
TILE_PATHS = [(9, 8, 'xyz', 8, 'float64', 'custom 9q'),
              (10, 9, 'xyz', 4, 'float32', 'custom 10q'),
              (9, 4, 'xyz', 4, 'float32', 'modulo 9q'),
              (9, 4, 'xyz', 4, 'float64', 'modulo 9q'),
              (8, 9, 'xyz', 8, 'float64', 'custom 8q')]


def rows_main(sources) -> int:
    """--rows: the row tiles' vjp and forward pass of every build at
    SPLIT_UNITARY and ROW_PATHS, in turns."""
    import torch
    import chip_smoke as c
    from cpflow_tpu_torch.kernels import rows as rk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    libs = [{dt: build(s, dt == torch.float64)
             for dt in (torch.float32, torch.float64)} for s in sources]
    print(f'{c.card_line()}; builds: '
          + ', '.join(f'{k} {s}' for k, s in enumerate(sources)), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(20)
    shapes = [(n, k, rot, B, dname, '') for n, k, rot, B, dname, *_ in
              c.SPLIT_UNITARY] + ROW_PATHS
    for n, k, rot, B, dname, path in shapes:
        dtype = getattr(torch, dname)
        nba = num_block_angles('cp', rot)
        blocks = uk.row_plan(n, k, nba, dtype)['cluster']
        pl = tuple(map(tuple, all_placements(fill_layers(chain_layer(n), k))))
        plc = torch.tensor(pl, dtype=torch.int32, device='cuda')
        letters = torch.tensor([uk.LETTER_CODES[x] for x in rot],
                               dtype=torch.int32, device='cuda')
        ops = {}  # each pass's schedule, for its plan's segment (one
        # block's too: the forward pass at 14 qubits, 13 in float64)
        for vjp in (False, True):
            plan = uk.rows_launch(n, k, nba, 0, vjp, dtype)
            ops[vjp] = None if plan is None else rk.device_schedule(
                n, pl, plan['segment'], torch.device('cuda'), not vjp)
        angles = c.uniform_inits(3 * n + nba * k, B, 20, 'cuda').to(dtype)
        cdtype = torch.complex128 if dtype == torch.float64 else \
            torch.complex64
        w = torch.randn((B, 1 << n, 1), generator=gen, dtype=cdtype,
                        device='cuda')
        u = torch.empty_like(w)

        def launch(lib, vjp, grad=None):
            err = lib.cpflow_unitary_launch(
                angles.data_ptr(), u.data_ptr(),
                w.data_ptr() if vjp else None,
                grad.data_ptr() if vjp else None, plc.data_ptr(),
                letters.data_ptr(), n, k, len(rot), 0, nba, 0, B, int(vjp),
                0, torch.cuda.current_stream().cuda_stream,
                ops[vjp].data_ptr() if ops[vjp] is not None else None,
                len(ops[vjp]) if ops[vjp] is not None else 0)
            if err:
                raise RuntimeError(f'launch failed: CUDA error {err}')

        order = list(range(len(libs)))
        out = [{False: [], True: []} for _ in libs]
        first, diff = None, [(0.0, 0.0)] * len(libs)
        for i in order + order[::-1]:
            lib = libs[i][dtype]
            grad = torch.empty_like(angles)
            launch(lib, False)
            launch(lib, True, grad)
            torch.cuda.synchronize()
            if first is None:
                first = u.clone(), grad.clone()
            scale = first[1].abs().clamp(min=1.0)
            diff[i] = (max(diff[i][0], (u - first[0]).abs().max().item()),
                       max(diff[i][1],
                           ((grad - first[1]).abs() / scale).max().item()))
            out[i][False].append(c.device_ms(lambda: launch(lib, False),
                                             'forward'))
            out[i][True].append(c.device_ms(lambda: launch(lib, True, grad),
                                             'vjp_rows_kernel'))
        work = c.unitary_work(n, k, rot, log_c=0, dtype=dtype)
        bounds = {vjp: c.unitary_bound_ms(
            work['vjp' if vjp else 'forward'],
            work['vjp_bytes' if vjp else 'forward_bytes'], B, dtype=dtype)
            for vjp in (False, True)}
        best = {vjp: min(min(o[vjp]) for o in out) for vjp in (False, True)}
        print(f'{path + ": " if path else ""}{n}q chain k={k} {rot!r} B={B} '
              f'{dname}, column 0, vjp on {blocks} blocks: ' + '; '.join(
                  f'build {i} vjp ' + ' / '.join(f'{ms:.4f}' for ms in
                                                 o[True]) +
                  ' forward ' + ' / '.join(f'{ms:.4f}' for ms in o[False]) +
                  f' ms (U off build 0 by {diff[i][0]:.1e}, gradient by '
                  f'{diff[i][1]:.1e})'
                  for i, o in enumerate(out)) + ' (' + ', '.join(
                      f'{"vjp" if vjp else "forward"} bound {b:.4f} ms by '
                      f'{by}, fastest {b / best[vjp]:.2%}'
                      for vjp, (b, by) in bounds.items()) + ')',
              flush=True)
    return 0


def tiles_main(sources) -> int:
    """--tiles: the column tiles' vjp (its kernels each and together) and
    the forward pass of every build at NINE_UNITARY and TILE_PATHS, in
    turns."""
    import torch
    import chip_smoke as c
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    libs = [{dt: build(s, dt == torch.float64)
             for dt in (torch.float32, torch.float64)} for s in sources]
    for per_dtype in libs:
        for lib in per_dtype.values():
            ptr, i = ctypes.c_void_p, ctypes.c_int
            lib.cpflow_unitary_tiles_launch.argtypes = [ptr] * 7 + \
                [i] * 8 + [ptr]
            lib.cpflow_unitary_tiles_launch.restype = i
            lib.cpflow_unitary_tile_partials.argtypes = [i] * 4
            lib.cpflow_unitary_tile_partials.restype = ctypes.c_longlong
    print(f'{c.card_line()}; builds: '
          + ', '.join(f'{k} {s}' for k, s in enumerate(sources)), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(21)
    shapes = [(n, k, rot, B, dname, '') for n, k, rot, B, dname, *_ in
              c.NINE_UNITARY] + TILE_PATHS
    parts = ('vjp_tile_gates_kernel', 'vjp_tiles_kernel',
             'vjp_tile_sum_kernel')
    for n, k, rot, B, dname, path in shapes:
        dtype = getattr(torch, dname)
        cdtype = torch.complex128 if dtype == torch.float64 else \
            torch.complex64
        nba = num_block_angles('cp', rot)
        pl = tuple(map(tuple, all_placements(fill_layers(chain_layer(n), k))))
        plc = torch.tensor(pl, dtype=torch.int32, device='cuda')
        letters = torch.tensor([uk.LETTER_CODES[x] for x in rot],
                               dtype=torch.int32, device='cuda')
        angles = c.uniform_inits(3 * n + nba * k, B, 21, 'cuda').to(dtype)
        w = torch.randn((B, 1 << n, 1 << n), generator=gen, dtype=cdtype,
                        device='cuda')
        u = torch.empty_like(w)
        on_tiles = {vjp: uk.plan(n, k, nba, n, vjp, dtype)['design'] ==
                    'tiles' for vjp in (False, True)}
        blocks = uk.plan(n, k, nba, n, True, dtype)['blocks_per_restart']

        def launch(lib, vjp, grad=None, work=None):
            stream = torch.cuda.current_stream().cuda_stream
            if on_tiles[vjp]:
                err = lib.cpflow_unitary_tiles_launch(
                    angles.data_ptr(), u.data_ptr(),
                    w.data_ptr() if vjp else None,
                    grad.data_ptr() if vjp else None,
                    work.data_ptr() if vjp else None, plc.data_ptr(),
                    letters.data_ptr(), n, k, len(rot), 0, nba, n, B,
                    int(vjp), stream)
            else:  # the row-split plan: independent blocks, or a cluster
                err = lib.cpflow_unitary_launch(
                    angles.data_ptr(), u.data_ptr(),
                    w.data_ptr() if vjp else None,
                    grad.data_ptr() if vjp else None, plc.data_ptr(),
                    letters.data_ptr(), n, k, len(rot), 0, nba, n, B,
                    int(vjp), 0, stream, None, 0)
            if err:
                raise RuntimeError(f'launch failed: CUDA error {err}')

        order = list(range(len(libs)))
        out = [{'forward': [], 'vjp': [], **{p: [] for p in parts}}
               for _ in libs]
        first, diff = None, [(0.0, 0.0)] * len(libs)
        for i in order + order[::-1]:
            lib = libs[i][dtype]
            grad = torch.empty_like(angles)
            work = torch.empty(
                max(B * lib.cpflow_unitary_tile_partials(n, k, nba, n), 1),
                dtype=dtype, device='cuda')
            launch(lib, False)
            launch(lib, True, grad, work)
            torch.cuda.synchronize()
            if first is None:
                first = u.clone(), grad.clone()
            scale = first[1].abs().clamp(min=1.0)
            diff[i] = (max(diff[i][0], (u - first[0]).abs().max().item()),
                       max(diff[i][1],
                           ((grad - first[1]).abs() / scale).max().item()))
            out[i]['forward'].append(c.device_ms(lambda: launch(lib, False),
                                                 'forward'))
            events = c.device_kernels(lambda: launch(lib, True, grad, work))
            total = 0.0
            if not on_tiles[True]:  # the cluster's vjp_kernel alone
                found = [v for key, v in events.items()
                         if 'vjp_kernel' in key]
                total = sum(t for _, t in found) / sum(x for x, _ in found)
            for part in parts if on_tiles[True] else ():
                found = [v for key, v in events.items() if part in key]
                count = sum(x for x, _ in found)
                ms = sum(t for _, t in found) / count if count else 0.0
                out[i][part].append(ms)
                total += ms
            out[i]['vjp'].append(total)
            del work
        work = c.unitary_work(n, k, rot, dtype=dtype)
        b_ms, by = c.unitary_bound_ms(work['vjp'], work['vjp_bytes'], B,
                                      dtype=dtype)
        best = min(min(o['vjp']) for o in out)
        print(f'{path + ": " if path else ""}{n}q chain k={k} {rot!r} B={B} '
              f'{dname}, vjp on {blocks} ' + (
                  'tiles' if on_tiles[True] else 'blocks of a cluster') +
              ': ' + '; '.join(
                  f'build {i} vjp ' + ' / '.join(
                      f'{ms:.4f}' for ms in o['vjp']) + ' (' + ', '.join(
                      f'{part} ' + '/'.join(f'{ms:.4f}' for ms in o[part])
                      for part in parts if o[part]) + ') forward ' +
                  ' / '.join(
                      f'{ms:.4f}' for ms in o['forward']) +
                  f' ms (U off build 0 by {diff[i][0]:.1e}, gradient by '
                  f'{diff[i][1]:.1e})' for i, o in enumerate(out)) +
              f' (vjp bound {b_ms:.4f} ms by {by}, fastest {b_ms / best:.2%})',
              flush=True)
    return 0


# --cluster's shapes, (n, k, rotations, B, dtype, name): the 7q and 8q rows
# of UNITARY_TIMING and SIXTEEN_UNITARY, phase 19 (c)'s custom loss, then
# NINE_UNITARY's rows and the column tiles' paths (TILE_PATHS), whose
# forward pass the column tiles run
def cluster_shapes():
    import chip_smoke as c
    out = [(n, k, rot, B, 'float32', name)
           for name, n, k, B, rot, _ in c.UNITARY_TIMING if n >= 7]
    out += [(n, k, rot, B, dname, 'SIXTEEN_UNITARY')
            for n, k, rot, B, dname, _, cols, _ in c.SIXTEEN_UNITARY
            if cols is None]
    out += [TILE_PATHS[-1]]
    out += [(n, k, rot, B, dname, 'NINE_UNITARY')
            for n, k, rot, B, dname, *_ in c.NINE_UNITARY]
    return out + TILE_PATHS[:-1]


def cluster_main(sources) -> int:
    """--cluster: the vjp on a cluster, the forward pass of the whole
    unitary from 7 qubits and the column tiles' vjp as a yardstick, every
    build at cluster_shapes(), in turns."""
    import torch
    import chip_smoke as c
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    libs = [{dt: build(s, dt == torch.float64)
             for dt in (torch.float32, torch.float64)} for s in sources]
    for per_dtype in libs:
        for lib in per_dtype.values():
            ptr, i = ctypes.c_void_p, ctypes.c_int
            lib.cpflow_unitary_tiles_launch.argtypes = [ptr] * 7 + \
                [i] * 8 + [ptr]
            lib.cpflow_unitary_tiles_launch.restype = i
            lib.cpflow_unitary_tile_partials.argtypes = [i] * 4
            lib.cpflow_unitary_tile_partials.restype = ctypes.c_longlong
            lib.cpflow_unitary_design.argtypes = [i] * 5
            lib.cpflow_unitary_design.restype = i
            lib.cpflow_unitary_tiles.argtypes = [i] * 5
            lib.cpflow_unitary_tiles.restype = i
    print(f'{c.card_line()}; builds: '
          + ', '.join(f'{k} {s}' for k, s in enumerate(sources)), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(19)
    parts = ('vjp_tile_gates_kernel', 'vjp_tiles_kernel',
             'vjp_tile_sum_kernel')
    for n, k, rot, B, dname, path in cluster_shapes():
        dtype = getattr(torch, dname)
        cdtype = torch.complex128 if dtype == torch.float64 else \
            torch.complex64
        nba = num_block_angles('cp', rot)
        pl = tuple(map(tuple, all_placements(fill_layers(chain_layer(n), k))))
        plc = torch.tensor(pl, dtype=torch.int32, device='cuda')
        letters = torch.tensor([uk.LETTER_CODES[x] for x in rot],
                               dtype=torch.int32, device='cuda')
        angles = c.uniform_inits(3 * n + nba * k, B, 19, 'cuda').to(dtype)
        w = torch.randn((B, 1 << n, 1 << n), generator=gen, dtype=cdtype,
                        device='cuda')
        u = torch.empty_like(w)
        plans = {vjp: uk.plan(n, k, nba, n, vjp, dtype)
                 for vjp in (False, True)}
        cluster = plans[True] is not None and plans[True]['design'] == \
            'rows' and plans[True]['blocks_per_restart'] > 1
        yard = cluster and libs[-1][dtype].cpflow_unitary_tiles(
            n, k, nba, n, 1) > 0

        def launch(lib, vjp, grad=None, work=None, tiles=False):
            stream = torch.cuda.current_stream().cuda_stream
            if tiles or not vjp and lib.cpflow_unitary_design(
                    n, k, nba, n, 0) == 2:
                err = lib.cpflow_unitary_tiles_launch(
                    angles.data_ptr(), u.data_ptr(),
                    w.data_ptr() if vjp else None,
                    grad.data_ptr() if vjp else None,
                    work.data_ptr() if vjp else None, plc.data_ptr(),
                    letters.data_ptr(), n, k, len(rot), 0, nba, n, B,
                    int(vjp), stream)
            else:  # the row-split plan: independent blocks, or a cluster
                err = lib.cpflow_unitary_launch(
                    angles.data_ptr(), u.data_ptr(),
                    w.data_ptr() if vjp else None,
                    grad.data_ptr() if vjp else None, plc.data_ptr(),
                    letters.data_ptr(), n, k, len(rot), 0, nba, n, B,
                    int(vjp), 0, stream, None, 0)
            if err:
                raise RuntimeError(f'launch failed: CUDA error {err}')

        def alone(calls):
            """{key: mean ms of its kernels alone on the card} for calls,
            a list of (key, kernel names, fn), from one torch.profiler
            trace of 20 rounds of every fn in turn (traced again, at most
            twice more, where the profiler leaves a kernel out; then the
            run fails, so that every time is of the kernels alone)."""
            for _ in range(3):
                events = c.device_kernels(lambda: [fn() for _, _, fn in calls])
                got = {}
                for key, names, _ in calls:
                    total = 0.0
                    for name in names:
                        found = [v for k, v in events.items() if name in k]
                        count, ms = sum(x for x, _ in found), sum(
                            t for _, t in found)
                        if not count or ms <= 0:
                            break
                        total += ms / count
                    else:
                        got[key] = total
                if len(got) == len(calls):
                    return got
            keys = [key for key, _, _ in calls]
            raise RuntimeError(f'the profiler left out a kernel of {keys} in '
                               f'three traces at {n}q k={k} B={B} {dname}')

        order = list(range(len(libs)))
        out = [{'forward': [], 'vjp': [], 'yard': []} for _ in libs]
        first, diff = None, [(0.0, 0.0)] * len(libs)
        for i in order + order[::-1]:
            lib = libs[i][dtype]
            grad = torch.empty_like(angles)
            work = torch.empty(
                max(B * lib.cpflow_unitary_tile_partials(n, k, nba, n), 1),
                dtype=dtype, device='cuda')
            launch(lib, False)
            if cluster:
                launch(lib, True, grad)
            torch.cuda.synchronize()
            if first is None:
                first = u.clone(), grad.clone()
            scale = first[1].abs().clamp(min=1.0)
            diff[i] = (max(diff[i][0], (u - first[0]).abs().max().item()),
                       max(diff[i][1], ((grad - first[1]).abs() / scale)
                           .max().item()) if cluster else 0.0)
            calls = [('forward', ('forward',), lambda: launch(lib, False))]
            if cluster:
                calls.append(('vjp', ('vjp_kernel',),
                              lambda: launch(lib, True, grad)))
            if yard:
                calls.append(('yard', parts, lambda: launch(
                    lib, True, grad, work, tiles=True)))
            for key, ms in alone(calls).items():
                out[i][key].append(ms)
            del work
        work = c.unitary_work(n, k, rot, dtype=dtype)
        bounds = {vjp: c.unitary_bound_ms(
            work['vjp' if vjp else 'forward'],
            work['vjp_bytes' if vjp else 'forward_bytes'], B, dtype=dtype)
            for vjp in (False, True)}
        best = {key: min(min(o[key]) for o in out)
                for key in ('forward', 'vjp') if out[0][key]}
        print(f'{path}: {n}q chain k={k} {rot!r} B={B} {dname}, forward on '
              f'{plans[False]["blocks_per_restart"]} '
              f'{plans[False]["design"]}' + (
                  f', vjp on a cluster of '
                  f'{plans[True]["blocks_per_restart"]}' if cluster else '')
              + ': ' + '; '.join(
                  f'build {i}' + (' vjp ' + ' / '.join(
                      f'{ms:.4f}' for ms in o['vjp']) if o['vjp'] else '')
                  + ' forward ' + ' / '.join(
                      f'{ms:.4f}' for ms in o['forward'])
                  + (' (column tiles\' vjp ' + ' / '.join(
                      f'{ms:.4f}' for ms in o['yard']) + ')' if o['yard']
                     else '')
                  + f' ms (U off build 0 by {diff[i][0]:.1e}, gradient by '
                  f'{diff[i][1]:.1e})' for i, o in enumerate(out)) + ' (' +
              ', '.join(f'{key} bound {bounds[key == "vjp"][0]:.4f} ms by '
                        f'{bounds[key == "vjp"][1]}, fastest '
                        f'{bounds[key == "vjp"][0] / ms:.2%}'
                        for key, ms in best.items()) + ')', flush=True)
    return 0


def block_main(sources) -> int:
    """--block: the pair on one block, every build at BLOCK_UNITARY's rows,
    in turns."""
    import torch
    import chip_smoke as c
    from cpflow_tpu_torch.kernels import rows as rk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    libs = [{dt: build(s, dt == torch.float64)
             for dt in (torch.float32, torch.float64)} for s in sources]
    print(f'{c.card_line()}; builds: '
          + ', '.join(f'{k} {s}' for k, s in enumerate(sources)), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(22)
    dev = torch.device('cuda')
    for n, k, rot, B, dname, passes, cols, _ in c.BLOCK_UNITARY:
        dtype = getattr(torch, dname)
        cdtype = torch.complex128 if dtype == torch.float64 else \
            torch.complex64
        nba = num_block_angles('cp', rot)
        log_c = 0 if cols else n
        layer = fill_layers(chain_layer(n), k)
        pl = tuple(map(tuple, all_placements(layer)))
        plc = torch.tensor(pl, dtype=torch.int32, device=dev)
        letters = torch.tensor([uk.LETTER_CODES[x] for x in rot],
                               dtype=torch.int32, device=dev)
        ops = {vjp: rk.device_schedule(n, pl, min(uk.rows_launch(
            n, k, nba, log_c, vjp, dtype)['segment'], n), dev, not vjp)
            for vjp in passes}
        angles = c.uniform_inits(3 * n + nba * k, B, 22, 'cuda').to(dtype)
        w = torch.randn((B, 1 << n, 1 << log_c), generator=gen,
                        dtype=cdtype, device=dev)
        u = uk.ansatz_forward(n, 'cp', rot, layer, angles, cols).contiguous()
        torch.cuda.synchronize()

        def launch(lib, vjp, out, grad=None):
            err = lib.cpflow_unitary_launch(
                angles.data_ptr(), out.data_ptr(),
                w.data_ptr() if vjp else None,
                grad.data_ptr() if vjp else None, plc.data_ptr(),
                letters.data_ptr(), n, k, len(rot), 0, nba, log_c, B,
                int(vjp), 0, torch.cuda.current_stream().cuda_stream,
                ops[vjp].data_ptr(), len(ops[vjp]))
            if err:
                raise RuntimeError(f'launch failed: CUDA error {err}')

        order = list(range(len(libs)))
        out = [{vjp: [] for vjp in passes} for _ in libs]
        first, diff = {}, [[0.0, 0.0] for _ in libs]
        for i in order + order[::-1]:
            lib = libs[i][dtype]
            mine = torch.empty_like(u)
            grad = torch.empty_like(angles)
            if False in passes:
                launch(lib, False, mine)
            if True in passes:
                launch(lib, True, u, grad)
            torch.cuda.synchronize()
            got = (mine, grad)
            for part, vjp in enumerate((False, True)):
                if vjp not in passes:
                    continue
                if vjp not in first:
                    first[vjp] = got[part].clone()
                scale = first[vjp].abs().clamp(min=1.0) if vjp else 1.0
                err = ((got[part] - first[vjp]).abs() / scale).max().item()
                diff[i][part] = max(diff[i][part], err)
            for vjp in passes:
                name = 'vjp' if vjp else 'forward'
                ms = c.device_ms(lambda: launch(lib, vjp, u if vjp else mine,
                                                grad), name)
                if ms is None:
                    raise RuntimeError(f'the profiler left out the {name} '
                                       f'kernel in three traces at {n}q k={k}')
                out[i][vjp].append(ms)
        work = c.unitary_work(n, k, rot, log_c=0 if cols else None,
                              dtype=dtype)
        bounds = {vjp: c.unitary_bound_ms(
            work['vjp' if vjp else 'forward'],
            work['vjp_bytes' if vjp else 'forward_bytes'], B, dtype=dtype)
            for vjp in passes}
        best = {vjp: min(min(o[vjp]) for o in out) for vjp in passes}
        print(f'{n}q chain k={k} {rot!r} B={B} {dname}'
              + (', column 0' if cols else ', the whole unitary') + ': '
              + '; '.join(
                  f'build {i} ' + ' '.join(
                      f'{"vjp" if vjp else "forward"} ' + ' / '.join(
                          f'{ms:.4f}' for ms in o[vjp]) for vjp in passes)
                  + f' ms (U off build 0 by {diff[i][0]:.1e}, gradient by '
                  f'{diff[i][1]:.1e})' for i, o in enumerate(out)) + ' ('
              + ', '.join(f'{"vjp" if vjp else "forward"} bound {b:.4f} ms '
                          f'by {by}, fastest {b / best[vjp]:.2%}, last build '
                          f'/ first {min(out[-1][vjp]) / min(out[0][vjp]):.3f}'
                          for vjp, (b, by) in bounds.items()) + ')',
              flush=True)
    return 0


def _module(path: Path, name: str):
    """The Python module at `path`, loaded under `name`."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class GlobalBuild:
    """One variant of the global row tiles: a source's library, the
    kernels/rows.py beside its csrc/, and its launch: the interface with the
    prologue (cpflow_unitary_global_gates exported) at `per_sm` blocks an
    SM, or PR 21's (its plan, workspace and launch without them)."""

    def __init__(self, lib, rows, per_sm, label):
        self.lib, self.rows, self.per_sm, self.label = lib, rows, per_sm, \
            label
        self.new = hasattr(lib, 'cpflow_unitary_global_gates')
        ptr, i = ctypes.c_void_p, ctypes.c_int
        if self.new:
            lib.cpflow_unitary_global_plan.argtypes = [i] * 5 + [ptr]
            lib.cpflow_unitary_global_work.argtypes = [i] * 5
            lib.cpflow_unitary_global_launch.argtypes = [ptr] * 7 + [
                i] * 8 + [ptr] * 5 + [i]
        else:
            lib.cpflow_unitary_global_plan.argtypes = [i] * 4 + [ptr]
            lib.cpflow_unitary_global_work.argtypes = [i] * 3
            lib.cpflow_unitary_global_launch.argtypes = [ptr] * 7 + [
                i] * 7 + [ptr] * 4 + [i]
        lib.cpflow_unitary_global_plan.restype = i
        lib.cpflow_unitary_global_work.restype = ctypes.c_longlong
        lib.cpflow_unitary_global_launch.restype = i

    def plan(self, n, k, nba, vjp):
        """(segment, log2 rows, tiles) of the library's plan; None where
        it has none."""
        got = (ctypes.c_int * 9)()
        args = (n, k, nba, int(vjp)) + ((self.per_sm,) if self.new else ())
        if self.lib.cpflow_unitary_global_plan(*args, got):
            return None
        return got[3], got[5], got[6]

    def prepare(self, n, k, nba, vjp, placements, low, B, dtype):
        """The launch's schedule, tables and workspace; the passes."""
        import torch
        seg, log_rows, _ = self.plan(n, k, nba, vjp)
        # PR 21's schedule takes the pass (its vjp walked the surface
        # round); the one beside the prologue is the same for both
        key = (n, placements, seg, log_rows, low) + (
            () if self.new else (not vjp,))
        table, offsets, ranges = self.rows.global_schedule(*key)
        dev = torch.device('cuda')
        self.table = torch.tensor(table, dtype=torch.int32, device=dev)
        self.maps = torch.tensor(self.rows.global_maps(*key),
                                 dtype=torch.int32, device=dev) \
            if self.new else None
        self.offsets = (ctypes.c_int * len(offsets))(*offsets)
        self.ranges = (ctypes.c_int * (2 * len(ranges)))(
            *[j for r in ranges for j in r])
        self.passes = len(ranges)
        per = self.lib.cpflow_unitary_global_work(
            *((n, k, nba, int(vjp), self.per_sm) if self.new else
              (n, k, nba)))
        self.work = torch.empty(max(per, 1) * B, dtype=dtype, device=dev) \
            if self.new or vjp else None
        return self.passes

    def launch(self, angles, u, w, grad, plc, letters, n, k, nrot, nba, B,
               vjp):
        import torch
        stream = torch.cuda.current_stream().cuda_stream
        head = (angles.data_ptr(), u.data_ptr(),
                w.data_ptr() if vjp else None,
                grad.data_ptr() if vjp else None,
                self.work.data_ptr() if self.work is not None else None,
                plc.data_ptr(), letters.data_ptr(), n, k, nrot, 0, nba, B,
                int(vjp))
        if self.new:
            err = self.lib.cpflow_unitary_global_launch(
                *head, self.per_sm, stream, self.table.data_ptr(),
                self.maps.data_ptr(), self.offsets, self.ranges, self.passes)
        else:
            err = self.lib.cpflow_unitary_global_launch(
                *head, stream, self.table.data_ptr(), self.offsets,
                self.ranges, self.passes)
        if err:
            raise RuntimeError(f'{self.label}: launch failed: CUDA error '
                               f'{err}')

    def launches(self, vjp):
        """{trace name: launches a call}."""
        out = {'vjp_global_kernel' if vjp else 'forward_global_kernel':
               self.passes}
        if vjp:
            out['vjp_global_sum_kernel'] = 1
        if self.new:
            out['global_gates_kernel'] = 1
        return out


def global_main(sources) -> int:
    """--global: the global row tiles of every build (and of a build with
    the prologue at 1 and 2 blocks an SM) at GLOBAL_UNITARY's rows, in
    turns."""
    import torch
    import chip_smoke as c
    from cpflow_tpu_torch.kernels import rows as rk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    builds = []
    for b, src in enumerate(sources):
        rows = _module(src.resolve().parent.parent / 'kernels' / 'rows.py',
                       f'_ab_rows_{b}')
        for dt in (torch.float32, torch.float64):
            lib = build(src, dt == torch.float64)
            if not hasattr(lib, 'cpflow_unitary_global_gates'):
                builds.append((b, dt, GlobalBuild(lib, rows, None,
                                                  f'build {b}')))
                continue
            for per_sm in (1, 2):
                builds.append((b, dt, GlobalBuild(
                    lib, rows, per_sm, f'build {b}, {per_sm} an SM')))
    print(f'{c.card_line()}; builds: '
          + ', '.join(f'{k} {s}' for k, s in enumerate(sources)), flush=True)
    gen = torch.Generator(device='cuda').manual_seed(23)
    for n, k, rot, B, dname, _, _, _, *layer in c.GLOBAL_UNITARY:
        dtype = getattr(torch, dname)
        cdtype = torch.complex128 if dtype == torch.float64 else \
            torch.complex64
        nba = num_block_angles('cp', rot)
        placements = tuple(tuple(int(q) for q in p) for p in all_placements(
            c.shape_layers(n, k, layer)))
        plc = torch.tensor(placements, dtype=torch.int32, device='cuda')
        letters = torch.tensor([uk.LETTER_CODES[x] for x in rot],
                               dtype=torch.int32, device='cuda')
        angles = c.uniform_inits(3 * n + nba * k, B, 23, 'cuda').to(dtype)
        w = torch.randn((B, 1 << n, 1), generator=gen, dtype=cdtype,
                        device='cuda')
        picks = {vjp: uk.global_per_sm(n, placements, nba, vjp, dtype)
                 for vjp in (False, True)}
        name = f'{n}q {layer[0] if layer else "chain"} k={k} {rot!r} B={B} ' \
            f'{dname}'
        for vjp in (False, True):
            what = 'vjp' if vjp else 'forward'
            variants = [v for b, dt, v in builds if dt == dtype and
                        v.plan(n, k, nba, vjp) is not None]
            if not variants:
                print(f'{name}: no global row plan for the {what}',
                      flush=True)
                continue
            passes = {v.label: v.prepare(n, k, nba, vjp, placements,
                                         rk.sector_bits(dtype), B, dtype)
                      for v in variants}
            out = {v.label: [] for v in variants}
            first, diff = None, {}
            # the vjp's U: this tree's forward pass of the same angles
            u = uk.ansatz_forward(n, 'cp', rot, c.shape_layers(n, k, layer),
                                  angles, [0]).contiguous() if vjp else \
                torch.empty((B, 1 << n, 1), dtype=cdtype, device='cuda')
            for v in variants + variants[::-1]:
                grad = torch.empty_like(angles)
                v.launch(angles, u, w, grad, plc, letters, n, k, len(rot),
                         nba, B, vjp)
                torch.cuda.synchronize()
                got = (grad if vjp else u).clone()
                if first is None:
                    first = got
                scale = first.abs().clamp(min=1.0) if vjp else 1.0
                diff[v.label] = max(diff.get(v.label, 0.0), (
                    (got - first).abs() / scale).max().item())
                ms, kept, whole = c.traced_calls(
                    lambda: v.launch(angles, u, w, grad, plc, letters, n, k,
                                     len(rot), nba, B, vjp),
                    v.launches(vjp))
                if None in ms.values():
                    raise RuntimeError(f'{name}: the profiler kept {kept} '
                                       f'of {v.label}\'s launches')
                out[v.label].append(sum(ms.values()))
            work = c.unitary_work(n, k, rot, log_c=0, dtype=dtype)
            bound, by = c.unitary_bound_ms(
                work[what], work[f'{what}_bytes'], B, dtype=dtype)
            best = min(min(t) for t in out.values())
            print(f'{name} {what}: ' + '; '.join(
                f'{label}' + (' (the wrapper\'s)' if label.endswith(
                    f'{picks[vjp]} an SM') else '') +
                f' {passes[label]} passes, ' + ' / '.join(
                    f'{t:.4f}' for t in times) + f' ms ({what} off the '
                f'first by {diff[label]:.1e})'
                for label, times in out.items()) +
                f' (bound {bound:.4f} ms by {by}, fastest {bound / best:.2%})',
                flush=True)
    return 0


def main(argv) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    from cpflow_tpu_torch.topology import (chain_layer, connected_layer,
                                           fill_layers)
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 1
    if '--rows' in argv:
        return rows_main([Path(a) for a in argv if a != '--rows'])
    if '--tiles' in argv:
        return tiles_main([Path(a) for a in argv if a != '--tiles'])
    if '--cluster' in argv:
        return cluster_main([Path(a) for a in argv if a != '--cluster'])
    if '--block' in argv:
        return block_main([Path(a) for a in argv if a != '--block'])
    if '--global' in argv:
        return global_main([Path(a) for a in argv if a != '--global'])
    sources = [Path(a) for a in argv] or \
        [Path('cpflow_tpu_torch/csrc/unitary.cu')]
    libs = [build(s) for s in sources]
    print(f'{chip_smoke.card_line()}; builds: '
          + ', '.join(f'{k} {s}' for k, s in enumerate(sources)), flush=True)
    from cpflow_tpu_torch.kernels import rows as rk
    layers = {'chain': chain_layer, 'connected': connected_layer}
    names = {vjp: (chip_smoke.TRACE_NAMES[('rows', vjp)],
                   chip_smoke.TRACE_NAMES[('columns', vjp)])
             for vjp in (False, True)}
    for name, n, k, B, rot, layer in chip_smoke.UNITARY_TIMING:
        if n > 6:
            continue
        pl = fill_layers(layers[layer](n), k)
        plc = torch.tensor(all_placements(pl), dtype=torch.int32,
                           device='cuda')
        placements = tuple(map(tuple, all_placements(pl)))
        letters = torch.tensor([uk.LETTER_CODES[c] for c in rot],
                               dtype=torch.int32, device='cuda')
        nba = num_block_angles('cp', rot)
        P, d = 3 * n + nba * k, 1 << n
        # the row-split design's schedule: the whole unitary's, for its
        # segment n (no swap)
        ops = {vjp: rk.device_schedule(n, placements, min(uk.rows_launch(
            n, k, nba, n, vjp)['segment'], n), torch.device('cuda'), not vjp)
            for vjp in (False, True)}
        gen = torch.Generator(device='cuda').manual_seed(1250 + n)
        angles = torch.rand((P, B), generator=gen, device='cuda') * \
            (2 * math.pi)
        w = torch.randn((B, d, d), generator=gen, dtype=torch.complex64,
                        device='cuda')

        def launch(lib, design, vjp, u, grad):
            err = lib.cpflow_unitary_launch(
                angles.data_ptr(), u.data_ptr(),
                w.data_ptr() if vjp else None,
                grad.data_ptr() if vjp else None, plc.data_ptr(),
                letters.data_ptr(), n, k, len(rot), 0, nba, n, B, int(vjp),
                design, torch.cuda.current_stream().cuda_stream,
                ops[vjp].data_ptr() if design == 0 else None,
                len(ops[vjp]) if design == 0 else 0)
            if err:
                raise RuntimeError(f'launch failed: CUDA error {err}')

        runs = [('rows', libs[0], 0)] + [
            (f'build {j}', lib, 1) for j, lib in enumerate(libs)]
        order = runs + runs[::-1]
        out = {label: {False: [], True: []} for label, _, _ in runs}
        diff = {}
        ref = None
        for label, lib, design in order:
            u = torch.empty((B, d, d), dtype=torch.complex64, device='cuda')
            grad = torch.empty_like(angles)
            launch(lib, design, False, u, None)
            launch(lib, design, True, u, grad)
            torch.cuda.synchronize()
            if ref is None:
                ref = (u.clone(), grad.clone())
            diff[label] = ((u - ref[0]).abs().max().item(),
                           (grad - ref[1]).abs().max().item())
            for vjp in (False, True):
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        launch(lib, design, vjp, u, grad)
                    torch.cuda.synchronize()
                total, count = 0.0, 0
                for ev in prof.key_averages():
                    if names[vjp][design] in ev.key:
                        spent = getattr(ev, 'self_device_time_total', None)
                        total += spent if spent is not None else \
                            ev.self_cuda_time_total
                        count += ev.count
                out[label][vjp].append(total / count / 1e3 if count
                                       else float('nan'))
        print(f'{name}: ' + '; '.join(
            f'{label} forward {sum(v[False]) / 2:.4f} vjp '
            f'{sum(v[True]) / 2:.4f} ms (difference from rows: U '
            f'{diff[label][0]:.1e}, gradient {diff[label][1]:.1e})'
            for label, v in out.items()), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Times builds of the sweep kernel against each other, in turns, on one
NVIDIA Hopper card.

Run from the root of the repository:

    python3 sweep_ab.py OLD/cpflow_tpu_torch/csrc/sweep.cu \\
        cpflow_tpu_torch/csrc/sweep.cu

for example with OLD an earlier commit unpacked by ``git archive`` into
``build/``. Each source must export cpflow_sweep_launch with the
arguments this tree's kernels/sweep.py passes; the shapes below all run a
restart on one block, so a source from before the cluster build, which
lacks cpflow_sweep_cluster, is given a stand-in that answers one. Each is
built with nvcc for sm_90a into build/ab/ and its ptxas report printed.
Then every build times the kernel alone (CUDA events, the faster of two
calls after a warm-up) at chip_smoke.py's phase-5 shapes and at the static
CCZ shape with batches that put about 1, 2 and 2.75 one-warp restarts on
each SM sub-partition of an H100 (132 SMs, 4 sub-partitions each), the
builds in turns (A B ... B A). It prints one row per shape with every
build's times in ms.
"""

from __future__ import annotations

import ctypes
import hashlib
from pathlib import Path
import subprocess
import sys


def build(source: Path) -> ctypes.CDLL:
    from cpflow_tpu_torch.kernels import build as kb
    # a source may include headers that lie beside it: hash its directory
    digest = hashlib.sha1(b''.join(
        p.read_bytes() for p in sorted(source.parent.iterdir())
        if p.is_file())).hexdigest()[:12]
    out = Path(__file__).resolve().parent / 'build' / 'ab' / f'{digest}.so'
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(kb.command(source, out), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {source}:\n{proc.stderr}')
    report = [line.strip() for line in proc.stderr.splitlines()
              if 'registers' in line or 'spill' in line]
    print(f'{source}: ' + ' | '.join(report), flush=True)
    lib = ctypes.CDLL(str(out))
    ptr = ctypes.c_void_p
    lib.cpflow_sweep_launch.argtypes = [ptr] * 13 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ptr]
    lib.cpflow_sweep_launch.restype = ctypes.c_int
    if hasattr(lib, 'cpflow_sweep_cluster'):
        lib.cpflow_sweep_cluster.argtypes = [ctypes.c_int] * 4
        lib.cpflow_sweep_cluster.restype = ctypes.c_int
    else:
        lib.cpflow_sweep_cluster = lambda *shape: 1
    return lib


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


def main(argv) -> int:
    import torch
    import chip_smoke as c
    from cpflow_tpu_torch.kernels import sweep as sk
    if len(argv) < 1 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    libs = [build(Path(a)) for a in argv]
    rows = [(label, c.shape_inputs(s, s.get('seed', 7)), T)
            for label, s, T in shapes()]
    times = [[[] for _ in rows] for _ in libs]
    order = list(range(len(libs)))
    for i in order + order[::-1]:
        sk._libs[torch.float32] = libs[i]
        for r, (_, (obj, init, mask), T) in enumerate(rows):
            sk.sweep(obj, init, 0.1, 2, mask)
            ms = min(c.timed(lambda: sk.sweep(obj, init, 0.1, T, mask))[1]
                     for _ in range(2))
            times[i][r].append(ms)
    print(c.card_line())
    for r, (label, _, T) in enumerate(rows):
        print(f'{label} T={T}: ' + '; '.join(
            ' / '.join(f'{ms:.2f}' for ms in times[i][r])
            for i in range(len(libs))), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Times a fresh process's first static CCZ synthesis (chip_smoke.py phase
4: 3q chain, k=12, 1024 samples) on one NVIDIA card, step by step, and
profiles it on the host.

Run from the root of a tree, whose chip_smoke.py and cpflow_tpu_torch it
imports (this one, or an earlier commit unpacked by ``git archive`` into
``build/``), as a new process each time:

    python3 PATH/cold_start.py TAG [--split] [--after-kernel]

It prints one line per step, each the seconds from a synchronized card
to a synchronized card, headed by TAG: the imports, the build (nvcc, or
the libraries already built), then the first static synthesis, whose
calls cProfile ranks by cumulative time (the 30 first, each line headed
by ``TAG |``), then a second one. ``--split`` first times apart what the
first call does before its synthesis: loading the sweep library, the
objective and initial angles, the occupancy query twice, a one-step sweep
twice and a 2000-step sweep twice, all at the static sampling shape (B =
1024). ``--after-kernel`` first launches the kernel once at chip_smoke.py
phase 3's row (a) (B = 1000, 60 steps), as the whole script does before
phase 4. Set ``CUDA_MODULE_LOADING=EAGER`` to have the CUDA runtime load
every kernel's code when a library is loaded instead of at its first
launch."""

from __future__ import annotations

import cProfile
import io
import os
import pstats
import sys
import time


def main(argv) -> int:
    if not argv or argv[0].startswith('--'):
        print(__doc__, file=sys.stderr)
        return 1
    tag = argv[0]
    start = time.perf_counter()
    sys.path.insert(0, os.getcwd())
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import chip_smoke as c
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.ops.gates import u_ccz3

    def step(label, fn, since=None):
        torch.cuda.synchronize()
        t = time.perf_counter() if since is None else since
        out = fn()
        torch.cuda.synchronize()
        print(f'{tag}: {label} {time.perf_counter() - t:.4f} s', flush=True)
        return out

    step('imports', lambda: None, start)
    step('build', c.phase_build)
    if '--split' in argv:
        step('load_library', lambda: sk.load_library(torch.float32))
        s = dict(n=3, k=12, target=u_ccz3, r=0.00055, B=1024)
        obj, init, _ = step('objective and inits',
                            lambda: c.shape_inputs(s, 7))
        for label, T in (('first', None), ('second', None)):
            step(f'{label} occupancy', lambda: sk.occupancy(obj, s['B']))
        for label, T in (('first', 1), ('second', 1), ('first', 2000),
                         ('second', 2000)):
            step(f'{label} sweep T={T}',
                 lambda: sk.sweep(obj, init, 0.1, T))
    if '--after-kernel' in argv:
        s = dict(n=3, k=12, target=u_ccz3, r=0.00055, B=1000)
        obj, init, _ = c.shape_inputs(s, 7)
        step('phase 3 (a) kernel T=60', lambda: sk.sweep(obj, init, 0.1, 60))
    prof = cProfile.Profile()
    prof.enable()
    step('first static', c.phase_main_path)
    prof.disable()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats('cumulative').print_stats(30)
    for line in out.getvalue().splitlines():
        if line.strip():
            print(f'{tag} | {line}', flush=True)
    step('second static', c.phase_main_path)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Holds the sweep kernel against its plain version at one of chip_smoke.py's
phase-3 rows over growing step counts, and the plain version on the card
against the plain version on the CPU, on the same inputs: how the error of
the best loss after T Adam steps grows with T, and how far two orders of
summation of one plain version drift apart on their own.

Run from the root of the repository on a machine with an NVIDIA card:

    python3 drift_probe.py ROW [ROW ...] [--steps 1,10,20,40,60]
        [--float64] [--cpu]

A ROW is the start of a row's name in chip_smoke.compare_shapes(), such as
'(t64)'; it runs at the seed phase 3 gives it, in its own precision, or in
float64 with ``--float64``. For each T it prints the build that ran and
the largest and median scaled error (chip_smoke.scaled_err) of the best
loss and of the loss at the initial angles between the kernel and the
plain version on the card; with ``--cpu``, at the last T, also between the
plain version on the card and on the CPU (the same initial angles, copied
to the CPU) and between the kernel and the plain version on the CPU.
"""

from __future__ import annotations

import sys


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import chip_smoke as c
    from cpflow_tpu_torch.kernels import sweep as sk
    steps = [1, 10, 20, 40, 60]
    if '--steps' in argv:
        steps = [int(t) for t in argv[argv.index('--steps') + 1].split(',')]
    names = [a for i, a in enumerate(argv) if not a.startswith('--')
             and (i == 0 or argv[i - 1] != '--steps')]
    shapes = c.compare_shapes()
    print(c.card_line(), flush=True)

    def errs(a, b):
        e = c.scaled_err(a.double().cpu(), b.double().cpu())
        return f'max {e.max().item():.3e} median {e.median().item():.3e}'

    for name in names:
        i = next(i for i, s in enumerate(shapes) if s['name'].startswith(name))
        s = dict(shapes[i])
        if '--float64' in argv:
            s['dtype'] = torch.float64
        obj, init, mask = c.shape_inputs(s, s.get('seed', 100 + i))
        build = sk.occupancy(obj, s['B'])['build']
        for T in steps:
            got = sk.sweep(obj, init, s['lr'], T, mask)
            want = sk.sweep_reference(obj, init, s['lr'], T, mask)
            print(f'{s["name"]} {obj.dtype} ({build}) T={T}: kernel against '
                  f'plain on the card: best loss {errs(got.best_loss, want.best_loss)}'
                  f'; initial loss {errs(got.regloss0, want.regloss0)}',
                  flush=True)
        if '--cpu' in argv:
            cpu = sk.sweep_reference(obj, init.cpu(), s['lr'], T,
                                     None if mask is None else mask.cpu())
            print(f'{s["name"]} {obj.dtype} T={T}: plain on the card against '
                  f'plain on the CPU: best loss '
                  f'{errs(want.best_loss, cpu.best_loss)}; kernel against '
                  f'plain on the CPU: best loss '
                  f'{errs(got.best_loss, cpu.best_loss)}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

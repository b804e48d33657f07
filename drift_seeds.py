#!/usr/bin/env python3
"""Holds the sweep builds of one or more source trees, and the plain float32
version, against the plain float64 version over several seeds, at rows of
chip_smoke.py's phases 3 and 15: how far each float32 order of summation
stands from the exact result, seed by seed.

Run from the root of the repository on a machine with an NVIDIA card and
the CUDA toolkit:

    python3 drift_seeds.py SWEEP_CU [SWEEP_CU ...] [--rows '15:(y),3:(t)']
        [--seeds 108,1,2,3]

Each SWEEP_CU is a csrc/sweep.cu (for example a parent unpacked by ``git
archive`` into build/, beside this tree's); it is built in float as
sweep_ab.py builds it. A row is a phase, 15 or 3, and the start of a
row's name in its shapes (chip_smoke.seven_shapes(),
chip_smoke.compare_shapes()); by default phase 15's (y), (x) and (q) and
phase 3's (s) and (t). The seeds default to the row's own phase seed and
1-7. For each row and seed it prints, for plain float32 and for each build, the
share of restarts whose best loss lies within 1e-4 of plain float64
and the largest scaled error of a best loss against it
(chip_smoke.scaled_err, the arbiter's measures in as_close_as_plain),
each build's largest scaled error of the initial loss against plain
float32 (phase 3 holds it to 1e-5) and whether its best losses meet the
rule phase 3 and 15 hold an arbiter row to (drift_ok against plain
float32, else as_close_as_plain); then each row's mean share over the
seeds.
"""

from __future__ import annotations

from pathlib import Path
import sys


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import chip_smoke as c
    import sweep_ab as ab
    from cpflow_tpu_torch.kernels import sweep as sk
    value = {k: argv[argv.index(k) + 1] for k in ('--rows', '--seeds')
             if k in argv}
    sources = [Path(a) for i, a in enumerate(argv) if not a.startswith('--')
               and (i == 0 or argv[i - 1] not in value)]
    if not sources:
        print(__doc__, file=sys.stderr)
        return 1
    jobs = [(src, *ab.start_build(src, False)) for src in sources]
    libs = [ab.finish_build(src, False, out, proc) for src, out, proc in jobs]
    print(c.card_line(), flush=True)
    phases = {'15': c.seven_shapes(), '3': c.compare_shapes()}
    wanted = value.get('--rows', '15:(y),15:(x),15:(q),3:(s),3:(t)')

    def within(a, ref64):
        e = c.scaled_err(a.double(), ref64)
        return (e <= 1e-4).double().mean().item(), e.max().item()

    for row in wanted.split(','):
        phase, name = row.split(':')
        shapes = phases[phase]
        i = next(i for i, s in enumerate(shapes) if s['name'].startswith(name))
        s = shapes[i]
        T = s.get('T', 60)
        seeds = ([int(x) for x in value['--seeds'].split(',')]
                 if '--seeds' in value else [s.get('seed', 100 + i)] +
                 list(range(1, 8)))
        shares = [[] for _ in range(len(libs) + 1)]
        for seed in seeds:
            obj, init, mask = c.shape_inputs(s, seed)
            ref = sk.sweep_reference(obj, init, s['lr'], T, mask)
            obj64 = c.shape_objective(s, torch.float64)[0]
            ref64 = sk.sweep_reference(obj64, init, s['lr'], T, mask)
            keep = torch.ones(s['B'], dtype=torch.bool, device='cuda')
            share, worst = within(ref.best_loss, ref64.best_loss)
            shares[0].append(share)
            line = [f'plain float32 {share:.4f} (max {worst:.2e})']
            for k, lib in enumerate(libs):
                sk._libs[torch.float32] = lib
                out = sk.sweep(obj, init, s['lr'], T, mask)
                share, worst = within(out.best_loss, ref64.best_loss)
                shares[k + 1].append(share)
                e0 = c.scaled_err(out.regloss0, ref.regloss0).max().item()
                rule = all(
                    c.drift_ok(c.scaled_err(got, want))[0] or
                    c.as_close_as_plain(got, want, exact, keep)[0]
                    for got, want, exact in (
                        (out.best_reg, ref.best_reg, ref64.best_reg),
                        (out.best_loss, ref.best_loss, ref64.best_loss)))
                line.append(f'{sources[k]} {share:.4f} (max {worst:.2e}; '
                            f'initial loss against plain float32 {e0:.2e}; '
                            f'arbiter {"met" if rule else "missed"})')
            print(f'phase {phase} {s["name"]} T={T} seed {seed}: share '
                  f'within 1e-4 of plain float64: ' + '; '.join(line),
                  flush=True)
        print(f'phase {phase} {s["name"]}: mean share over seeds {seeds}: ' +
              '; '.join(f'{what} {sum(v) / len(v):.4f}' for what, v in
                        zip(['plain float32'] + [str(p) for p in sources],
                            shares)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

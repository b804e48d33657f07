#!/usr/bin/env python3
"""Times builds of the unitary kernels (csrc/unitary.cu) against each other,
in turns, on one NVIDIA Hopper card.

Run from the root of the repository:

    python3 unitary_ab.py cpflow_tpu_torch/csrc/unitary.cu \\
        build/variant/unitary.cu

for example with build/variant/ a copy of cpflow_tpu_torch/csrc/ with one
change. Each source must export cpflow_unitary_launch with the arguments
of this tree's kernels/unitary.py (the design among them); each is built
with nvcc for sm_90a into build/ab/, and its column kernels' ptxas lines at
3 and 4 qubits are printed. Then, at every shape of chip_smoke.py's
UNITARY_TIMING up to 6 qubits, the row-split design of the first build and
the column design of every build run in turns (rows, each build, each
build in reverse, rows), the forward pass and the vjp 20 times each, and
one torch.profiler trace of the card per build and turn gives each kernel
alone. It prints one row per shape: the mean ms of each, and the largest
difference of each build's U and gradient from the row-split design's.

    python3 unitary_ab.py --rows OLD/cpflow_tpu_torch/csrc/unitary.cu \\
        cpflow_tpu_torch/csrc/unitary.cu

times the row tiles instead (one column split by rows over a cluster): at
every row of chip_smoke.py's SPLIT_UNITARY, in its precision (each source
is built in float and in double), the builds in turns (A B ... B A), the
vjp (vjp_rows_kernel) and the forward pass beside it (the row tiles'
forward_rows_kernel, or forward_kernel where the forward pass fits one
block) alone on the card, the mean over 20 launches of each by
torch.profiler (chip_smoke.device_ms). Each launch hands the kernel this
tree's row schedule (kernels/rows.py) for the segment of this tree's plan,
which a source from before the schedule never reads. It prints one row
per shape: each build's ms in turns, the bound of the vjp
(chip_smoke.unitary_bound_ms) and its share of the fastest, and the largest
difference of each build's gradient from the first build's.
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


def rows_main(sources) -> int:
    """--rows: the row tiles' vjp and forward pass of every build at
    SPLIT_UNITARY, in turns."""
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
    for n, k, rot, B, dname, _, _, blocks in c.SPLIT_UNITARY:
        dtype = getattr(torch, dname)
        nba = num_block_angles('cp', rot)
        pl = tuple(map(tuple, all_placements(fill_layers(chain_layer(n), k))))
        plc = torch.tensor(pl, dtype=torch.int32, device='cuda')
        letters = torch.tensor([uk.LETTER_CODES[x] for x in rot],
                               dtype=torch.int32, device='cuda')
        ops = rk.device_schedule(n, pl, uk.row_plan(n, k, nba,
                                                    dtype)['segment'],
                                 torch.device('cuda'))
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
                0, torch.cuda.current_stream().cuda_stream, ops.data_ptr(),
                len(ops))
            if err:
                raise RuntimeError(f'launch failed: CUDA error {err}')

        order = list(range(len(libs)))
        out = [{False: [], True: []} for _ in libs]
        first, diff = None, [0.0] * len(libs)
        for i in order + order[::-1]:
            lib = libs[i][dtype]
            grad = torch.empty_like(angles)
            launch(lib, False)
            launch(lib, True, grad)
            torch.cuda.synchronize()
            if first is None:
                first = grad.clone()
            scale = first.abs().clamp(min=1.0)
            diff[i] = max(diff[i], ((grad - first).abs() / scale).max().item())
            out[i][False].append(c.device_ms(lambda: launch(lib, False),
                                             'forward'))
            out[i][True].append(c.device_ms(lambda: launch(lib, True, grad),
                                             'vjp_rows_kernel'))
        work = c.unitary_work(n, k, rot, log_c=0, dtype=dtype)
        b_ms, by = c.unitary_bound_ms(work['vjp'], work['vjp_bytes'], B,
                                      dtype=dtype)
        best = min(min(o[True]) for o in out)
        print(f'{n}q chain k={k} {rot!r} B={B} {dname}, column 0, vjp on '
              f'{blocks} blocks: ' + '; '.join(
                  f'build {i} vjp ' + ' / '.join(f'{ms:.4f}' for ms in
                                                 o[True]) +
                  ' forward ' + ' / '.join(f'{ms:.4f}' for ms in o[False]) +
                  f' ms (gradient off build 0 by {diff[i]:.1e})'
                  for i, o in enumerate(out)) +
              f' (vjp bound {b_ms:.4f} ms by {by}, fastest {b_ms / best:.2%})',
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
    sources = [Path(a) for a in argv] or \
        [Path('cpflow_tpu_torch/csrc/unitary.cu')]
    libs = [build(s) for s in sources]
    print(f'{chip_smoke.card_line()}; builds: '
          + ', '.join(f'{k} {s}' for k, s in enumerate(sources)), flush=True)
    layers = {'chain': chain_layer, 'connected': connected_layer}
    names = {False: ('forward_kernel', 'column_forward'),
             True: ('vjp_kernel', 'column_vjp')}
    for name, n, k, B, rot, layer in chip_smoke.UNITARY_TIMING:
        if n > 6:
            continue
        pl = fill_layers(layers[layer](n), k)
        plc = torch.tensor(all_placements(pl), dtype=torch.int32,
                           device='cuda')
        letters = torch.tensor([uk.LETTER_CODES[c] for c in rot],
                               dtype=torch.int32, device='cuda')
        nba = num_block_angles('cp', rot)
        P, d = 3 * n + nba * k, 1 << n
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
                design, torch.cuda.current_stream().cuda_stream)
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

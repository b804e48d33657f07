#!/usr/bin/env python3
"""Compares the machine code of two trees' kernel sources, build by build.

Run from the root of the repository, on a machine with the CUDA toolkit:

    python3 sass_diff.py OLD/cpflow_tpu_torch/csrc cpflow_tpu_torch/csrc

for example with OLD an earlier commit unpacked by ``git archive`` into
``build/``. Each ``.cu`` file present in both directories is compiled
with nvcc for sm_90a into a cubin under build/sass/ (all compilers side
by side), with the flags of kernels/build.py and any extra flags given
after ``--`` (``-- -DCPFLOW_DOUBLE`` compares the double builds).
``cuobjdump -sass`` then lists each cubin's instructions, kernel by
kernel; the hash that nvcc puts into the names of an unnamed namespace (it
differs between two paths of one file) is masked, and runs of blanks are
collapsed (cuobjdump pads every line of a listing to the width of its
widest, which a new kernel's longer lines change). It prints, for every
source, each kernel of the first tree with the number of lines of its
listing in each tree and whether they are identical, then the kernels that
only the second tree has, and exits 1 if a kernel of the first tree
differs or is gone from the second. ``--show N`` (before ``--``) prints
the first N lines of a unified diff of each kernel that differs.
"""

from __future__ import annotations

import difflib
import os
from pathlib import Path
import re
import subprocess
import sys

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from cpflow_tpu_torch.kernels import build  # noqa: E402

OUT = ROOT / 'build' / 'sass'
FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3']


def sass(cubin: Path, cuobjdump: str) -> dict:
    """{kernel name: its instructions, one line each with its blanks
    collapsed} of a cubin, names masked."""
    text = subprocess.run([cuobjdump, '-sass', str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    text = re.sub(r'_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+', 'ANON',
                  text)
    kernels, name = {}, None
    for line in text.splitlines():
        line = ' '.join(line.split())
        if line.startswith('Function :'):
            name = line.split(':', 1)[1].strip()
            kernels[name] = []
        elif line and name is not None:
            kernels[name].append(line)
    return kernels


def main(argv) -> int:
    extra = argv[argv.index('--') + 1:] if '--' in argv else []
    argv = argv[:argv.index('--')] if '--' in argv else argv
    show = 0
    if '--show' in argv:
        i = argv.index('--show')
        show = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    dirs = [Path(a) for a in argv]
    if len(dirs) != 2:
        print(__doc__)
        return 2
    OUT.mkdir(parents=True, exist_ok=True)
    sources = sorted(p.name for p in dirs[0].glob('*.cu')
                     if (dirs[1] / p.name).exists())
    jobs = []
    for side, d in enumerate(dirs):
        for name in sources:
            cubin = OUT / f'{side}_{name}.cubin'
            jobs.append((cubin, subprocess.Popen(
                [build.nvcc(), '-cubin', *FLAGS, *extra, '-o', str(cubin),
                 str(d / name)])))
    if any(proc.wait() != 0 for _, proc in jobs):
        print('nvcc failed')
        return 1
    cuobjdump = os.path.join(os.path.dirname(build.nvcc()), 'cuobjdump')
    same = True
    for name in sources:
        a, b = (sass(OUT / f'{side}_{name}.cubin', cuobjdump)
                for side in (0, 1))
        for kernel, lines in a.items():
            other = b.get(kernel)
            same &= lines == other
            print(f'{name} {" ".join(extra)}: {kernel}: {len(lines)} and '
                  f'{len(other) if other is not None else "no"} lines of '
                  f'SASS, identical: {lines == other}')
            if show and other is not None and lines != other:
                diff = list(difflib.unified_diff(lines, other, lineterm='',
                                                 n=1))
                print('\n'.join(diff[:show]))
        for kernel in sorted(set(b) - set(a)):
            print(f'{name} {" ".join(extra)}: {kernel}: new, {len(b[kernel])} '
                  f'lines of SASS')
    return 0 if same else 1


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Asks the CUDA runtime how many restarts of the sweep's one-block build
(csrc/sweep.cu, sweep_block_kernel) an SM holds when a block carries R
restarts of one warp each, R = 1, 2, 4, 8, 16, at the 4q state of
chip_smoke.py phase 3's row (e).

Run from the root of the repository on a machine with an NVIDIA card and
the CUDA toolkit:

    python3 block_occupancy.py

It compiles, into build/occupancy/, a source that includes
cpflow_tpu_torch/csrc/sweep.cu and calls
cudaOccupancyMaxActiveBlocksPerMultiprocessor for the kernel at 32 R
threads and R times the shared memory of one restart
(kernels/sweep.py:occupancy), and prints each R's blocks and restarts an
SM with the kernel's registers and local bytes.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
import subprocess
import sys

ROOT = Path(__file__).resolve().parent

SOURCE = r'''
#include "%s"

extern "C" int block_occupancy(int threads, int bytes, int* out) {
  cudaError_t e = cudaFuncSetAttribute((const void*)sweep_block_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, sweep_block_kernel, threads, bytes);
  cudaFuncAttributes at;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&at, sweep_block_kernel);
  out[1] = at.numRegs;
  out[2] = (int)at.localSizeBytes;
  return (int)e;
}
'''


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import chip_smoke as c
    from cpflow_tpu_torch.kernels import build as kb
    from cpflow_tpu_torch.kernels import sweep as sk
    out = ROOT / 'build' / 'occupancy'
    out.mkdir(parents=True, exist_ok=True)
    src = out / 'occupancy.cu'
    src.write_text(SOURCE % (ROOT / 'cpflow_tpu_torch' / 'csrc' / 'sweep.cu'))
    lib_path = out / 'occupancy.so'
    subprocess.run(kb.command(src, lib_path, []), check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    s = next(s for s in c.compare_shapes() if s['name'].startswith('(e)'))
    obj, _, _ = c.shape_inputs(s, 7)
    one = sk.occupancy(obj, s['B'])
    print(c.card_line())
    print(f'{s["name"]}: build {one["build"]}, {one["threads"]} threads and '
          f'{one["smem_bytes"]} shared bytes a restart')
    for R in (1, 2, 4, 8, 16):
        got = (ctypes.c_int * 3)()
        err = lib.block_occupancy(32 * R, R * one['smem_bytes'], got)
        if err:
            print(f'R={R}: CUDA error {err}')
            return 1
        print(f'R={R} restarts of one warp a block: {got[0]} blocks and '
              f'{got[0] * R} restarts an SM ({got[1]} registers, {got[2]} '
              f'local bytes)')
    return 0


if __name__ == '__main__':
    sys.exit(main())

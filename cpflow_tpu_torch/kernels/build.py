"""Builds the CUDA sources of csrc/ with nvcc for sm_90a into ``build/`` and
loads them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface.
A library is rebuilt when any file under csrc/ changes (the sources share
device code through csrc/gates.cuh, so the digest covers them all).
``build_all`` starts one nvcc per source at the same time; ``load`` builds
one source if it is not built yet. Nothing here runs when the package is
imported: a build happens at the first launch of a kernel, or when a caller
asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
SOURCES = ('sweep', 'unitary')
INFO: dict = {}  # name -> library path, and nvcc seconds and ptxas report
_libs: dict = {}


def nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(f'nvcc not found: the kernels are built from {CSRC} '
                       f'with the CUDA toolkit')


def command(source: Path, out: Path) -> list:
    """The nvcc command line that builds one source into a shared library."""
    return [nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
            '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-o',
            str(out), str(source)]


def digest() -> str:
    """A digest of every file under csrc/, names and contents."""
    h = hashlib.sha1()
    for path in sorted(CSRC.iterdir()):
        if path.is_file():
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:12]


def _start(name: str):
    """Starts nvcc for csrc/<name>.cu unless its library exists. Returns the
    library's path and the running job (or None)."""
    target = BUILD_DIR / f'libcpflow_{name}_{digest()}.so'
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(command(CSRC / f'{name}.cu', Path(tmp)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    return target, (proc, tmp, time.perf_counter())


def _finish(name: str, target: Path, job) -> ctypes.CDLL:
    info = INFO.setdefault(name, {})
    if job is not None:
        proc, tmp, start = job
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f'nvcc failed for {name}.cu '
                               f'({proc.returncode}):\n{out}\n{err}')
        os.replace(tmp, target)
        info['seconds'] = time.perf_counter() - start
        info['ptxas'] = err.strip()
    info['library'] = str(target)
    _libs[name] = ctypes.CDLL(str(target))
    return _libs[name]


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built first if need be."""
    if name not in _libs:
        _finish(name, *_start(name))
    return _libs[name]


def build_all(names=SOURCES) -> None:
    """Builds every source not built yet, all nvcc processes side by side,
    and loads the libraries."""
    jobs = [(name, *_start(name)) for name in names if name not in _libs]
    try:
        for name, target, job in jobs:
            _finish(name, target, job)
    finally:  # after a failed build, leave no compiler running
        for _, _, job in jobs:
            if job is not None and job[0].poll() is None:
                job[0].kill()

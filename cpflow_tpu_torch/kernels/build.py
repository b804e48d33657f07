"""Builds the CUDA sources of csrc/ with nvcc for sm_90a into ``build/`` and
loads them with ctypes.

Each ``csrc/<name>.cu`` becomes two shared libraries with a plain C
interface: ``<name>``, in float (complex64 amplitudes), and ``<name>_f64``,
the same source compiled with -DCPFLOW_DOUBLE, in double (complex128; see
the top of csrc/gates.cuh). BUILDS names them. A library is rebuilt when
any file under csrc/ changes (the sources share device code through
csrc/gates.cuh, so the digest covers them all). ``build_all`` starts one
nvcc per build at the same time; ``load`` builds one if it is not built
yet. Nothing here runs when the package is imported: a build happens at the
first launch of a kernel, or when a caller asks for it.
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
F64 = '_f64'  # the suffix of a source's double-precision build
# build name -> (source, extra nvcc flags)
BUILDS = {name + suffix: (name, flags) for name in SOURCES
          for suffix, flags in (('', []), (F64, ['-DCPFLOW_DOUBLE']))}
INFO: dict = {}  # build -> library path, and nvcc seconds and ptxas report
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


def command(source: Path, out: Path, flags=()) -> list:
    """The nvcc command line that builds one source into a shared library
    (flags: extra nvcc options, such as -DCPFLOW_DOUBLE)."""
    return [nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
            '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
            *flags, '-o', str(out), str(source)]


def name_of(source: str, double: bool) -> str:
    """The build of csrc/<source>.cu in double (True) or float."""
    return source + (F64 if double else '')


def digest() -> str:
    """A digest of every file under csrc/, names and contents."""
    h = hashlib.sha1()
    for path in sorted(CSRC.iterdir()):
        if path.is_file():
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:12]


def _start(name: str):
    """Starts nvcc for the build `name` (of BUILDS) unless its library
    exists. Returns the library's path and the running job (or None)."""
    source, flags = BUILDS[name]
    target = BUILD_DIR / f'libcpflow_{name}_{digest()}.so'
    if target.exists():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen(command(CSRC / f'{source}.cu', Path(tmp), flags),
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
            raise RuntimeError(f'nvcc failed for {name} '
                               f'({proc.returncode}):\n{out}\n{err}')
        os.replace(tmp, target)
        info['seconds'] = time.perf_counter() - start
        info['ptxas'] = err.strip()
    info['library'] = str(target)
    _libs[name] = ctypes.CDLL(str(target))
    return _libs[name]


def load(name: str) -> ctypes.CDLL:
    """The library of the build `name` (of BUILDS), built first if need
    be."""
    if name not in _libs:
        _finish(name, *_start(name))
    return _libs[name]


def build_all(names=tuple(BUILDS)) -> None:
    """Builds every build not built yet (both precisions of every source),
    all nvcc processes side by side, and loads the libraries."""
    jobs = [(name, *_start(name)) for name in names if name not in _libs]
    try:
        for name, target, job in jobs:
            _finish(name, target, job)
    finally:  # after a failed build, leave no compiler running
        for _, _, job in jobs:
            if job is not None and job[0].poll() is None:
                job[0].kill()

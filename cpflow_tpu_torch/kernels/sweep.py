"""The multi-start Adam sweep: the hand-written Hopper kernel and its plain
PyTorch version.

``sweep`` replaces cpflow_tpu/experimental/pallas_sweep.py:make_pallas_sweep
(and its host wrapper ``pallas_minimize_fused``). On a CUDA tensor it
launches the CUDA kernel of csrc/sweep.cu, built for sm_90a with nvcc into
``build/`` at first use and bound with ctypes; it never falls back. On a CPU
tensor it runs ``sweep_reference``: the sim/batched.py objective under
PyTorch autograd and the same Adam loop, written out to match optax.adam.

What bounds the kernel on this card, and what its design does about it, is
set out at the top of csrc/sweep.cu: per-restart shared memory (the 4^n
state and cotangent; n <= 6 here, 7 qubits need tiling, ROADMAP B.7) and
the barriers and block reductions of the adjoint walk (few threads per
restart, a 31-shuffle warp reduction, double-buffered cross-warp partials).

target_loss: the sweep stops once every restart's best loss is at or under
it, as engine.fused_adam_sweep of the JAX package does. The plain loop
checks before every step; the kernel runs in launches of
TARGET_CHECK_EVERY steps with the Adam state kept on the card and is
checked between them, so it may run up to TARGET_CHECK_EVERY - 1 more
steps. Success flags agree; best losses are at most the plain loop's.
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
from typing import NamedTuple, Optional

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.ops.penalty import LinearPenalty, breakpoints
from cpflow_tpu_torch.sim.ansatz_kernel import all_placements

LAUNCHES = 0  # kernel launches since the last reset; the plain path adds none

MAX_QUBITS = 6
TARGET_CHECK_EVERY = 50  # kernel steps between host checks of target_loss
SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'sweep.cu'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
BUILD_INFO: dict = {}  # seconds and ptxas report of this process's build

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_lib = None


class SweepResult(NamedTuple):
    best_params: torch.Tensor  # (P, B) angles before the best step
    best_reg: torch.Tensor     # (B,) best regularized loss
    best_loss: torch.Tensor    # (B,) loss at that step
    regloss0: torch.Tensor     # (B,) regularized loss at the initial angles
    loss0: torch.Tensor        # (B,) loss at the initial angles


# --------------------------------------------------------------------------
# Plain version
# --------------------------------------------------------------------------

def sweep_reference(objective, params0: torch.Tensor,
                    learning_rate: float = 0.1, num_iterations: int = 5000,
                    grad_mask: Optional[torch.Tensor] = None,
                    target_loss: Optional[float] = None) -> SweepResult:
    """Multi-start Adam over objective(params_PB) -> (regloss_B, loss_B).

    optax.adam arithmetic: b1 0.9, b2 0.999, eps 1e-8 outside the square
    root, bias correction with step t from 1. grad_mask (P, B) multiplies
    the gradient before the moments, so a masked entry never moves. Best
    tracking keeps the angles *before* the update whose loss improved
    (strict <); the initial angles are the first best. With target_loss the
    loop stops once every restart's best loss is at or under it.
    """
    params = params0.detach().to(config.real_dtype).clone()
    with torch.no_grad():
        regloss0, loss0 = objective(params)
    best_p = params.clone()
    best_reg, best_loss = regloss0.clone(), loss0.clone()
    m = torch.zeros_like(params)
    v = torch.zeros_like(params)
    for it in range(num_iterations):
        if target_loss is not None and bool((best_loss <= target_loss).all()):
            break
        p = params.clone().requires_grad_(True)
        regloss, loss = objective(p)
        (grad,) = torch.autograd.grad(regloss.sum(), p)
        with torch.no_grad():
            if grad_mask is not None:
                grad = grad * grad_mask
            improved = regloss < best_reg
            best_reg = torch.where(improved, regloss, best_reg)
            best_loss = torch.where(improved, loss, best_loss)
            best_p = torch.where(improved[None, :], params, best_p)
            t = it + 1
            m = (1 - _B1) * grad + _B1 * m
            v = (1 - _B2) * (grad * grad) + _B2 * v
            mhat = m / (1 - _B1 ** t)
            vhat = v / (1 - _B2 ** t)
            params = params - learning_rate * (mhat / (torch.sqrt(vhat) + _EPS))
    return SweepResult(best_p, best_reg.detach(), best_loss.detach(),
                       regloss0, loss0)


# --------------------------------------------------------------------------
# Build and bind
# --------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError('nvcc not found: the sweep kernel is built from '
                       f'{SOURCE} with the CUDA toolkit')


def load_library() -> ctypes.CDLL:
    """Build csrc/sweep.cu for sm_90a (once per source version) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    target = BUILD_DIR / f'libcpflow_sweep_{digest}.so'
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
               '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
               '-Xptxas', '-v', '-o', tmp, str(SOURCE)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                               f'{proc.stdout}\n{proc.stderr}')
        os.replace(tmp, target)
        BUILD_INFO['seconds'] = time.perf_counter() - start
        BUILD_INFO['ptxas'] = proc.stderr.strip()
    lib = ctypes.CDLL(str(target))
    ptr = ctypes.c_void_p
    lib.cpflow_sweep_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ptr]
    lib.cpflow_sweep_launch.restype = ctypes.c_int
    lib.cpflow_sweep_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cpflow_sweep_smem_bytes.restype = ctypes.c_longlong
    BUILD_INFO['library'] = str(target)
    _lib = lib
    return lib


# --------------------------------------------------------------------------
# Kernel wrapper
# --------------------------------------------------------------------------

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def _check_objective(objective):
    n = objective.num_qubits
    if not 2 <= n <= MAX_QUBITS:
        raise ValueError(
            f'the sweep kernel takes 2 to {MAX_QUBITS} qubits, got {n}: '
            f'above {MAX_QUBITS} the state and cotangent exceed one block\'s '
            f'shared memory, and tiling them is ROADMAP B.7')
    if objective.entangling_gate_name != 'cp' or \
            objective.rotation_gates != 'xyz':
        raise NotImplementedError(
            'the sweep kernel takes the CP entangler with rotations "xyz"; '
            f'got {objective.entangling_gate_name!r} / '
            f'{objective.rotation_gates!r} (ROADMAP B.6)')
    kind = getattr(objective.unitary_loss_func, 'kind', None)
    if kind != 'hst':
        raise NotImplementedError(
            f'the sweep kernel computes the HS-test loss, got {kind!r} '
            f'(ROADMAP B.5)')
    if objective.has_penalty and \
            not isinstance(objective.regularization_func, LinearPenalty):
        raise NotImplementedError(
            'the sweep kernel computes the piecewise-linear penalty only')


def _launch(objective, params0, learning_rate, num_iterations, grad_mask,
            target_loss) -> SweepResult:
    _check_objective(objective)
    device = params0.device
    major, minor = torch.cuda.get_device_capability(device)
    if (major, minor) != (9, 0):
        raise RuntimeError(f'the sweep kernel is built for sm_90a (Hopper); '
                           f'device has compute capability {major}.{minor}')
    n = objective.num_qubits
    placements = all_placements(objective.placements)
    nb = len(placements)
    P = 3 * n + 7 * nb
    if params0.dim() != 2 or params0.shape[0] != P:
        raise ValueError(f'params0 must be (P={P}, B), got '
                         f'{tuple(params0.shape)}')
    B = params0.shape[1]
    params0 = params0.to(config.real_dtype).contiguous()
    if grad_mask is not None:
        if tuple(grad_mask.shape) != (P, B):
            raise ValueError(f'grad_mask must be ({P}, {B}), got '
                             f'{tuple(grad_mask.shape)}')
        grad_mask = grad_mask.to(device=device,
                                 dtype=config.real_dtype).contiguous()

    lib = load_library()
    smem = lib.cpflow_sweep_smem_bytes(n, nb)
    if smem > _SMEM_LIMIT:
        raise ValueError(f'{n} qubits with {nb} blocks need {smem} bytes of '
                         f'shared memory per restart, above {_SMEM_LIMIT}')

    target = torch.view_as_real(torch.as_tensor(
        np.asarray(objective.unitary_loss_func.target),
        dtype=config.complex_dtype).to(device).contiguous())
    if objective.has_penalty:
        cp_mask = torch.as_tensor(objective.cp_mask, device=device)
        xs, ys = breakpoints(*objective.regularization_func.params)
        r = objective.r
    else:  # a zero mask and r = 0: any curve gives no penalty
        cp_mask = torch.zeros(P, device=device, dtype=config.real_dtype)
        xs, ys = breakpoints(np.pi / 2, 2.0, .05, .05, .05)
        r = 0.0
    pen_tab = torch.tensor(xs + ys, dtype=config.real_dtype, device=device)
    plc = torch.tensor(placements if nb else [[0, 0]], dtype=torch.int32,
                       device=device).contiguous()
    # the Adam state, kept on the card between launches
    params = params0.clone()
    mom1 = torch.zeros_like(params0)
    mom2 = torch.zeros_like(params0)
    best_params = params0.clone()
    summary = torch.empty((4, B), dtype=config.real_dtype, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch(it_begin, it_end):
        global LAUNCHES
        err = lib.cpflow_sweep_launch(
            params.data_ptr(), mom1.data_ptr(), mom2.data_ptr(),
            best_params.data_ptr(), summary.data_ptr(), target.data_ptr(),
            cp_mask.data_ptr(),
            grad_mask.data_ptr() if grad_mask is not None else None,
            plc.data_ptr(), pen_tab.data_ptr(), n, nb, B, it_begin, it_end,
            float(learning_rate), float(r), stream)
        if err != 0:
            raise RuntimeError(f'sweep kernel launch failed: CUDA error {err}')
        LAUNCHES += 1

    T = int(num_iterations)
    if B and target_loss is None:
        launch(0, T)
    elif B:
        launch(0, 0)  # initial losses only
        it = 0
        while it < T and not bool((summary[3] <= target_loss).all()):
            end = min(it + TARGET_CHECK_EVERY, T)
            launch(it, end)
            it = end
    return SweepResult(best_params, summary[2], summary[3], summary[0],
                       summary[1])


def sweep(objective, params0: torch.Tensor, learning_rate: float = 0.1,
          num_iterations: int = 5000, grad_mask: Optional[torch.Tensor] = None,
          target_loss: Optional[float] = None) -> SweepResult:
    """The fused sweep of `objective` (a sim.batched.BatchedRegloss) from
    params0 (P, B): the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor. Returns a SweepResult."""
    if params0.device.type == 'cuda':
        return _launch(objective, params0, learning_rate, num_iterations,
                       grad_mask, target_loss)
    if params0.device.type == 'cpu':
        return sweep_reference(objective, params0, learning_rate,
                               num_iterations, grad_mask, target_loss)
    raise ValueError(f'no sweep for device {params0.device}')

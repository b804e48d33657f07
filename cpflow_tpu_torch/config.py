"""Global numeric configuration of the PyTorch port.

Counterpart of cpflow_tpu/config.py. The compute path runs in float32 /
complex64 by default, as the JAX package does, and in float64 / complex128
after ``set_precision(True)``, as the JAX package does under x64.

TF32 is switched off on import. A TF32 matrix product keeps about three
decimal digits, which floors the Hilbert-Schmidt loss far above the 1e-6
``target_loss`` that verification certifies: the same trap as the TPU's
default bf16 passes (cpflow_tpu/config.py). The hand-written sweep kernel
computes in plain float32 and never meets TF32; the switches guard the
plain PyTorch path, which is the kernel's reference on the card.
"""

from __future__ import annotations

import torch

real_dtype = torch.float32
complex_dtype = torch.complex64


def complex_of(real: torch.dtype) -> torch.dtype:
    """The complex dtype of a real one: complex128 for float64, else
    complex_dtype."""
    return torch.complex128 if real == torch.float64 else complex_dtype


def set_precision(double: bool = False) -> None:
    """Switch the default dtypes between single (the default) and double
    precision. The plain PyTorch path follows them, and so do the
    hand-written kernels on the card: a float64 objective or tensor
    launches the double build of each kernel (kernels/build.py), never the
    float one. The JAX package's switch also needs jax_enable_x64; this
    one needs nothing else."""
    global real_dtype, complex_dtype
    if double:
        real_dtype, complex_dtype = torch.float64, torch.complex128
    else:
        real_dtype, complex_dtype = torch.float32, torch.complex64


def resolve_device(given=None, device=None) -> torch.device:
    """Where an entry point runs: `device` if the caller names one, else
    the device of `given` if that is a tensor, else 'cuda'. Raises when
    that is a CUDA device and none is visible: nothing runs on the CPU
    unasked."""
    if device is None:
        device = given.device if isinstance(given, torch.Tensor) else 'cuda'
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device is cuda, but no CUDA device is visible')
    return device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


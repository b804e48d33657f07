"""Global numeric configuration of the PyTorch port.

Counterpart of cpflow_tpu/config.py. The compute path runs in float32 /
complex64, as the JAX package does.

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

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


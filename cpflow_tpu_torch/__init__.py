"""cpflow_tpu_torch: the PyTorch/CUDA port of cpflow_tpu.

Variational synthesis of CZ + 1q-rotation circuits (CP-gate relaxation,
massive multi-start Adam), running on an NVIDIA Hopper card through a
hand-written CUDA sweep kernel, or on the CPU through its plain PyTorch
version. The JAX package cpflow_tpu is the reference the port is held
against; this package never imports it, nor JAX.

Ported so far: the static synthesis path (``Synthesize.static``).
"""

from cpflow_tpu_torch.api import (Ansatz, BasicOptions, Decomposition,
                                  EntanglingBlock, LossSpec,
                                  RegularizationOptions, Results,
                                  StaticOptions, Synthesize)

__version__ = '0.1.0'

__all__ = [
    'Ansatz', 'BasicOptions', 'Decomposition', 'EntanglingBlock', 'LossSpec',
    'RegularizationOptions', 'Results', 'StaticOptions', 'Synthesize',
]

"""cpflow_tpu_torch: the PyTorch/CUDA port of cpflow_tpu.

Variational synthesis of CZ + 1q-rotation circuits (CP-gate relaxation,
massive multi-start Adam), running on an NVIDIA Hopper card through a
hand-written CUDA sweep kernel, or on the CPU through its plain PyTorch
version. The JAX package cpflow_tpu is the reference the port is held
against; this package never imports it, nor JAX.

Ported so far: ``Synthesize.static`` and ``Synthesize.adaptive`` (TPE over
the template length and the penalty weight), with the HS-test, disc,
state-preparation and modulo-identity/diagonal losses, any rotation string
of x, y, z, and the CP, CZ and CX entanglers; and, on the host in float64
numpy, ``Decomposition.refine`` with the whole ``circuits`` package (circuit
IR with QASM and drawing, passes, Rational and Clifford+T rounding, grid
synthesis, exact cyclotomic unitaries, circuit-to-ansatz).
"""

from cpflow_tpu_torch.api import (AdaptiveOptions, Ansatz, BasicOptions,
                                  Decomposition, EntanglingBlock, LossSpec,
                                  RegularizationOptions, Results,
                                  StaticOptions, Synthesize)

__version__ = '0.1.0'

__all__ = [
    'AdaptiveOptions', 'Ansatz', 'BasicOptions', 'Decomposition',
    'EntanglingBlock', 'LossSpec', 'RegularizationOptions', 'Results', 'StaticOptions', 'Synthesize',
]

"""The reference's import surface (``from cpflow import ...``) backed by
the PyTorch port, cpflow_tpu_torch: the counterpart of the ``cpflow``
compatibility package, which the JAX package backs.

Reference-style scripts and notebooks run unchanged with ``cpflow``
replaced by ``cpflow_torch`` in their imports; each submodule below
mirrors one module of ``cpflow`` and exports exactly its names. Entry
points run on the card unless given ``device='cpu'``.
"""

from cpflow_tpu_torch import __version__  # noqa: F401
from cpflow_tpu_torch.api import (Ansatz, AdaptiveOptions,  # noqa: F401
                                  BasicOptions, Decomposition,
                                  EntanglingBlock, LossSpec,
                                  RegularizationOptions, Results,
                                  StaticOptions, Synthesize)

__all__ = [
    'Ansatz', 'AdaptiveOptions', 'BasicOptions', 'Decomposition',
    'EntanglingBlock', 'LossSpec', 'RegularizationOptions', 'Results',
    'StaticOptions', 'Synthesize',
]

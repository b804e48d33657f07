"""Reference cpflow/main.py surface."""
from cpflow_tpu_torch.api import (Ansatz, AdaptiveOptions,  # noqa: F401
                                  BasicOptions, Decomposition,
                                  EntanglingBlock, LossSpec,
                                  RegularizationOptions, Results,
                                  StaticOptions, Synthesize)
from cpflow_tpu_torch.sim.ansatz_kernel import build_unitary  # noqa: F401

"""Reference cpflow/penalty.py surface."""
from cpflow_tpu_torch.ops.penalty import (  # noqa: F401
    cp_penalty_L1, cp_penalty_linear, make_regularization_function)

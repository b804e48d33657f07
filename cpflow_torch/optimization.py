"""Reference cpflow/optimization.py surface."""
from cpflow_tpu_torch.optimize import (mynimize,  # noqa: F401
                                       mynimize_repeated, unitary_learn)
from cpflow_tpu_torch.optimize.engine import (  # noqa: F401
    adam_chain, angle_by_angle_chain, gradient_descent_chain,
    minimize_multistart, plain_hessian_preconditioner,
    plain_natural_preconditioner, sparse_hessian_preconditioner)

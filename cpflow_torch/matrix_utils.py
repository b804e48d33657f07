"""Reference cpflow/matrix_utils.py surface."""
from cpflow_tpu_torch.ops.losses import (cost_HST, disc,  # noqa: F401
                                         disc2_swap, disc_modulo_diagonal,
                                         disc_modulo_identity, fubini_study,
                                         tensor_diagonal_loss,
                                         tensor_identity_loss,
                                         theoretical_lower_bound, trace_prod)

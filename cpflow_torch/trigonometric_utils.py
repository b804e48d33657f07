"""Reference cpflow/trigonometric_utils.py surface."""
from cpflow_tpu_torch.ops.trig import (bracket_angle, min_angle,  # noqa: F401
                                       min_angles, random_angles)

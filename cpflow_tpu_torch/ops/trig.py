"""Angle utilities (counterpart of cpflow_tpu/ops/trig.py).

Randomness comes from an explicit ``torch.Generator``. It does not
reproduce JAX's threefry bits: the same seed gives other angles than the
JAX package gives (see optimize/candidates.py).
"""

from __future__ import annotations

import math

import torch

from cpflow_tpu_torch import config


def random_angles(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform angles in [0, 2pi) of the given shape, drawn on `device`."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=config.real_dtype)
    return u * (2 * math.pi)


def bracket_angle(a):
    """Map an angle to the equivalent one in [-pi, pi)."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi

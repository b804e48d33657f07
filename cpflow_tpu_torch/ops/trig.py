"""Exact one-parameter trigonometric line search and angle utilities
(counterpart of cpflow_tpu/ops/trig.py).

Any loss of a circuit is, as a function of one rotation angle, of the form
F(x) = A cos x + B sin x + c; its argmin follows in closed form from the
three evaluations F(0), F(pi/2), F(pi).

Randomness comes from an explicit ``torch.Generator``. It does not
reproduce JAX's threefry bits: the same seed gives other angles than the
JAX package gives (see optimize/candidates.py).
"""

from __future__ import annotations

import math

import torch

from cpflow_tpu_torch import config


def min_angle(F):
    """Argmin of F(x) = A cos x + B sin x + const from three probes:
    const = (F(0) + F(pi)) / 2, A = F(0) - const, B = F(pi/2) - const. The
    wave is R cos(x - phi) with phi = atan2(B, A), so its minimum sits at
    phi + pi. F may return a scalar tensor or one value per restart."""
    f0 = F(0.0)
    f1 = F(math.pi / 2)
    f2 = F(math.pi)
    c = (f0 + f2) / 2
    return torch.atan2(f1 - c, f0 - c) + math.pi


def min_angles(F, angles: torch.Tensor, s0: int, s1: int) -> torch.Tensor:
    """Closed-form optimal values for angles[s0:s1], each with the others
    held fixed."""
    def one_min_angle(i):
        def probe(a):
            shifted = angles.clone()
            shifted[i] = a
            return F(shifted)
        return min_angle(probe)

    return torch.stack([one_min_angle(i) for i in range(s0, s1)])


def random_angles(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform angles in [0, 2pi) of the given shape, drawn on `device`."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=config.real_dtype)
    return u * (2 * math.pi)


def bracket_angle(a):
    """Map an angle to the equivalent one in [-pi, pi)."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi

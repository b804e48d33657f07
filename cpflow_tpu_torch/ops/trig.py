"""Exact one-parameter trigonometric line search and angle utilities
(counterpart of cpflow_tpu/ops/trig.py).

Any loss of a circuit is, as a function of one rotation angle, of the form
F(x) = A cos x + B sin x + c; its argmin follows in closed form from the
three evaluations F(0), F(pi/2), F(pi).

``random_angles`` draws from a threefry key (ops/prng.py): the same key
gives the JAX package's angles, bit for bit.
"""

from __future__ import annotations

import math

import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.ops import prng


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


def random_angles(num_angles, key=None, device=None) -> torch.Tensor:
    """Uniform angles in [0, 2pi): jax.random.uniform(key, (num_angles,),
    minval=0, maxval=2pi). num_angles may be a shape; a batch of keys
    (..., 2) gives (..., *shape). key defaults to PRNGKey(0) on `device`
    (the card unless the caller names another); the draw runs on the
    key's device."""
    if key is None:
        key = prng.PRNGKey(0, device)
    elif device is not None:
        key = key.to(device)
    return prng.uniform(key, num_angles, 0.0, 2 * math.pi,
                        dtype=config.real_dtype)


def bracket_angle(a):
    """Map an angle to the equivalent one in [-pi, pi)."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi

"""CZ-count penalty on CP angles (counterpart of cpflow_tpu/ops/penalty.py).

A continuous piecewise-linear curve on [0, 2pi]: zero plateaus around 0 and
2pi, peaks of height ymax at xmax and 2pi - xmax, a plateau of height 1
around pi. It drives CP angles toward 0 (gate removed) or pi (gate becomes a
CZ).

The curve is evaluated with the arithmetic of ``jnp.interp``: the segment is
found with a right-sided search, so at a breakpoint the value and the
autograd slope are those of the segment that starts there, as in the JAX
package and in the sweep kernel (csrc/sweep.cu, ``penalty_val_grad``).
Angles are reduced with ``torch.remainder``, which lands negative angles in
[0, 2pi) as JAX's ``%`` does (``torch.fmod`` would keep their sign).
"""

from __future__ import annotations

import math

import torch

from cpflow_tpu_torch import config

TWO_PI = 2 * math.pi


def breakpoints(xmax, ymax, plato_0, plato_1, plato_2):
    """(xs, ys) of the curve's 10 breakpoints, as Python floats."""
    pi = math.pi
    xs = [0.0, plato_0, xmax - plato_2, xmax + plato_2, pi - plato_1,
          pi + plato_1, pi + xmax - plato_2, pi + xmax + plato_2,
          2 * pi - plato_0, 2 * pi]
    ys = [0.0, 0.0, ymax, ymax, 1.0, 1.0, ymax, ymax, 0.0, 0.0]
    return xs, ys


def cp_penalty_linear(a, xmax, ymax, plato_0, plato_1, plato_2):
    """Piecewise-linear CP penalty, elementwise."""
    a = torch.as_tensor(a, dtype=config.real_dtype)
    x = torch.remainder(a, TWO_PI)
    xs_l, ys_l = breakpoints(xmax, ymax, plato_0, plato_1, plato_2)
    xs = torch.tensor(xs_l, dtype=x.dtype, device=x.device)
    ys = torch.tensor(ys_l, dtype=x.dtype, device=x.device)
    i = torch.clamp(torch.searchsorted(xs, x.detach(), right=True), 1,
                    len(xs_l) - 1)
    df = ys[i] - ys[i - 1]
    dx = xs[i] - xs[i - 1]
    return ys[i - 1] + ((x - xs[i - 1]) / dx) * df


def cp_penalty_L1(a):
    """L1 penalty."""
    return torch.abs(a)


class LinearPenalty:
    """The piecewise-linear penalty as a callable that also carries its
    breakpoint parameters, so the sweep kernel can evaluate the same curve
    on the card."""

    def __init__(self, xmax, ymax, plato_0, plato_1, plato_2):
        self.params = (float(xmax), float(ymax), float(plato_0),
                       float(plato_1), float(plato_2))

    def __call__(self, a):
        return cp_penalty_linear(a, *self.params)

    def __repr__(self):
        return f'LinearPenalty{self.params}'


def make_regularization_function(options):
    """Per-angle penalty from RegularizationOptions (an instance or the bare
    class, whose defaults then apply)."""
    if options.function == 'linear':
        return LinearPenalty(options.xmax, options.ymax, options.plato_0,
                             options.plato_1, options.plato_2)
    if options.function == 'L1':
        return cp_penalty_L1
    raise ValueError(f"penalty function {options.function!r} not supported")

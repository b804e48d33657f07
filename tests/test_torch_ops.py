"""Port vs JAX package: gate matrices, CP penalty, angle utilities and
topology (cpflow_tpu_torch.ops / topology against cpflow_tpu's)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import topology as jtop
from cpflow_tpu.experimental import pallas_sweep as jps
from cpflow_tpu.ops import gates as jgates
from cpflow_tpu.ops import penalty as jpen
from cpflow_tpu.ops import trig as jtrig
from cpflow_tpu_torch import topology as ttop
from cpflow_tpu_torch.api import RegularizationOptions
from cpflow_tpu_torch.ops import gates as tgates
from cpflow_tpu_torch.ops import penalty as tpen
from cpflow_tpu_torch.ops import trig as ttrig

torch.set_num_threads(1)

PEN = (math.pi / 2, 2.0, 0.05, 0.05, 0.05)


def _angles(n=64, seed=0):
    """Angles of both signs, several turns wide."""
    return np.random.default_rng(seed).uniform(-4 * np.pi, 4 * np.pi, n) \
        .astype(np.float32)


@pytest.mark.parametrize('name', ['rx_mat', 'ry_mat', 'rz_mat', 'cp_mat'])
def test_parametrized_gates_match_jax(name):
    # atol 1e-6: one float32 cos/sin per entry in each package
    for a in _angles(16):
        ours = getattr(tgates, name)(torch.tensor(a)).numpy()
        ref = np.asarray(getattr(jgates, name)(jnp.float32(a)))
        np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_gate_constants_and_targets_match_jax():
    for name in ['x_mat', 'y_mat', 'z_mat', 'cx_mat', 'cz_mat', 'u_toff3',
                 'u_toff4', 'u_toff5', 'u_ccz3', 'u_cccz4']:
        np.testing.assert_array_equal(getattr(tgates, name),
                                      getattr(jgates, name))
    for n in (2, 3, 4):
        np.testing.assert_array_equal(tgates.multi_controlled_z(n),
                                      jgates.multi_controlled_z(n))
        np.testing.assert_array_equal(tgates.multi_controlled_sqrt_x(n),
                                      jgates.multi_controlled_sqrt_x(n))
        np.testing.assert_allclose(tgates.multi_controlled_x_root(n, 4),
                                   jgates.multi_controlled_x_root(n, 4),
                                   atol=1e-7)


def test_penalty_value_matches_jax_both_signs():
    a = _angles(2001, seed=1)
    ours = tpen.cp_penalty_linear(torch.tensor(a), *PEN).numpy()
    ref = np.asarray(jpen.cp_penalty_linear(jnp.asarray(a), *PEN))
    np.testing.assert_allclose(ours, ref, atol=1e-6)  # same float32 formula
    reg = tpen.make_regularization_function(RegularizationOptions)
    np.testing.assert_allclose(reg(torch.tensor(a)).numpy(), ref, atol=1e-6)


def test_penalty_slope_matches_jax_grad_away_from_kinks():
    a = _angles(2001, seed=2)
    x = np.mod(a.astype(np.float64), 2 * np.pi)
    xs, _ = tpen.breakpoints(*PEN)
    away = np.min(np.abs(x[:, None] - np.asarray(xs)[None, :]), axis=1) > 1e-3
    t = torch.tensor(a, requires_grad=True)
    tpen.cp_penalty_linear(t, *PEN).sum().backward()
    ref = np.asarray(jax.vmap(jax.grad(
        lambda v: jpen.cp_penalty_linear(v, *PEN)))(jnp.asarray(a)))
    # slopes are dy/dx of the segment: identical up to float32 rounding
    np.testing.assert_allclose(t.grad.numpy()[away], ref[away], atol=1e-5)


def test_penalty_matches_pallas_kernel_val_grad():
    """The sweep kernel evaluates the Pallas kernel's curve; at a breakpoint
    both take the segment that starts there."""
    xs, _ = tpen.breakpoints(*PEN)
    a = np.concatenate([np.linspace(0.01, 2 * np.pi - 0.01, 301),
                        np.asarray(xs[1:-1]) + 1e-4]).astype(np.float32)
    val, slope = jps._penalty_val_grad(jnp.asarray(a), *PEN)
    t = torch.tensor(a, requires_grad=True)
    ours = tpen.cp_penalty_linear(t, *PEN)
    ours.sum().backward()
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(val),
                               atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(slope), atol=1e-4)


def test_random_angles_and_bracket_angle():
    from cpflow_tpu_torch.ops import prng
    a = ttrig.random_angles((5, 7), prng.PRNGKey(3, 'cpu'))
    assert a.shape == (5, 7) and a.dtype == torch.float32
    assert float(a.min()) >= 0.0 and float(a.max()) < 2 * math.pi
    again = ttrig.random_angles((5, 7), prng.PRNGKey(3, 'cpu'))
    assert torch.equal(a, again)
    # the JAX package's draw from the same key, bit for bit
    np.testing.assert_array_equal(
        ttrig.random_angles(35, prng.PRNGKey(3, 'cpu')).numpy(),
        np.asarray(jtrig.random_angles(35, key=jax.random.PRNGKey(3))))
    np.testing.assert_array_equal(
        ttrig.random_angles(9, device='cpu').numpy(),
        np.asarray(jtrig.random_angles(9)))           # default PRNGKey(0)
    b = _angles(100, seed=4)
    np.testing.assert_allclose(ttrig.bracket_angle(torch.tensor(b)).numpy(),
                               np.asarray(jtrig.bracket_angle(jnp.asarray(b))),
                               atol=1e-6)


@pytest.mark.parametrize('n', [2, 3, 4, 5])
def test_topology_matches_jax(n):
    for name in ['connected_layer', 'chain_layer', 'star_layer',
                 'square_layer']:
        layer = getattr(ttop, name)(n)
        assert layer == getattr(jtop, name)(n)
        assert ttop.num_qubits_from_layer(layer) == \
            jtop.num_qubits_from_layer(layer)
        for depth in (0, 1, 5, 12):
            assert ttop.fill_layers(layer, depth) == \
                jtop.fill_layers(layer, depth)
    assert ttop.kite_layer() == jtop.kite_layer()


def test_min_angle_and_min_angles_match_jax():
    """The closed-form argmin of A cos x + B sin x + c from three probes
    (atan2 form): 1e-5 against the JAX package, at A = 0 too, and for a
    batch of waves at once."""
    rng = np.random.default_rng(8)
    for a, b, c in [(0.7, -1.3, 0.2), (0.0, 1.0, 0.0), (-2.0, 0.0, 5.0)] + \
            [tuple(rng.normal(size=3)) for _ in range(5)]:
        got = ttrig.min_angle(lambda x: torch.as_tensor(
            a * math.cos(x) + b * math.sin(x) + c, dtype=torch.float32))
        want = jtrig.min_angle(lambda x: jnp.float32(
            a * math.cos(x) + b * math.sin(x) + c))
        assert abs(float(got) - float(want)) <= 1e-5
        wave = lambda x: a * math.cos(x) + b * math.sin(x) + c
        assert wave(float(got)) <= min(wave(x) for x in
                                       np.linspace(0, 2 * np.pi, 50)) + 1e-5
    coef = torch.tensor(rng.normal(size=(2, 6)), dtype=torch.float32)
    batch = ttrig.min_angle(lambda x: coef[0] * math.cos(x) +
                            coef[1] * math.sin(x) + 1.0)
    assert tuple(batch.shape) == (6,)
    for i in range(6):
        one = ttrig.min_angle(lambda x: coef[0, i] * math.cos(x) +
                              coef[1, i] * math.sin(x) + 1.0)
        assert abs(float(batch[i]) - float(one)) <= 1e-6
    # each angle's optimum with the others held fixed
    w = rng.normal(size=5).astype(np.float32)
    x0 = rng.uniform(0, 2 * np.pi, 5).astype(np.float32)
    got = ttrig.min_angles(lambda v: (torch.tensor(w) * torch.cos(v)).sum()
                           + torch.sin(v[0] + v[1]), torch.tensor(x0), 1, 4)
    want = jtrig.min_angles(lambda v: (jnp.asarray(w) * jnp.cos(v)).sum()
                            + jnp.sin(v[0] + v[1]), jnp.asarray(x0), 1, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)

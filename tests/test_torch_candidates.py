"""Port vs JAX package: CZ counting, projection, candidate evaluation and
filtering, and batched verification (cpflow_tpu_torch.optimize.candidates
against cpflow_tpu.optimize.candidates)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import api as japi
from cpflow_tpu import config as jconfig
from cpflow_tpu.optimize import candidates as jcand
from cpflow_tpu.optimize import engine as jengine
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch import config as tconfig
from cpflow_tpu_torch.ops import prng
from cpflow_tpu_torch.optimize import candidates as tcand
from cpflow_tpu_torch.optimize import engine as tengine
from cpflow_tpu_torch.ops.gates import u_ccz3
from cpflow_tpu_torch.topology import chain_layer, fill_layers

torch.set_num_threads(1)


def _edge_angles():
    """Angles of both signs, with points on either side of every threshold
    of cz_value / project_cp_angles (0.2 and 1e-2 around 0, pi, 2pi)."""
    base = np.array([0.0, np.pi, 2 * np.pi, -np.pi, -2 * np.pi])
    offs = np.array([-0.25, -0.199, -0.15, -0.011, -0.009, 0.0, 0.009,
                     0.011, 0.15, 0.199, 0.25])
    grid = (base[:, None] + offs[None, :]).ravel()
    rnd = np.random.default_rng(0).uniform(-7, 7, 200)
    return np.concatenate([grid, rnd]).astype(np.float32)


@pytest.mark.parametrize('threshold', [1e-2, 0.2])
def test_cz_value_and_projection_match_jax(threshold):
    a = _edge_angles()
    ours = tcand.cz_value(torch.tensor(a), threshold=threshold).numpy()
    ref = np.asarray(jcand.cz_value(jnp.asarray(a), threshold=threshold))
    np.testing.assert_array_equal(ours, ref)
    proj = tcand.project_cp_angles(torch.tensor(a), threshold=threshold)
    jproj = jcand.project_cp_angles(jnp.asarray(a), threshold=threshold)
    np.testing.assert_array_equal(proj.numpy(), np.asarray(jproj))
    two_d = a[:200].reshape(8, 25)
    np.testing.assert_array_equal(
        tcand.count_cz(torch.tensor(two_d), threshold=threshold).numpy(),
        [int(jcand.count_cz(jnp.asarray(row), threshold=threshold))
         for row in two_d])


def test_evaluate_raw_batch_and_filter_match_jax():
    rng = np.random.default_rng(1)
    B, P = 12, 30
    cp_mask = (rng.uniform(size=P) > 0.6).astype(np.float32)
    params = rng.uniform(-7, 7, (B, 2, P)).astype(np.float32)
    params[:, 1, cp_mask == 1] = np.where(
        rng.uniform(size=(B, int(cp_mask.sum()))) > 0.5, np.pi, 0.05)
    regloss = rng.uniform(0, 1, (B, 2)).astype(np.float32)
    regloss[3, 1] = regloss[3, 0]  # a tie: the first index wins in both
    loss = regloss - 1e-3
    raw = tengine.RawResult(torch.tensor(params), torch.tensor(regloss),
                            torch.tensor(loss))
    jraw = jengine.RawResult(jnp.asarray(params), jnp.asarray(regloss),
                             jnp.asarray(loss))
    ev = tcand.evaluate_raw_batch(raw, cp_mask, threshold=0.2)
    jev = jcand.evaluate_raw_batch(jraw, jnp.asarray(cp_mask), threshold=0.2)
    np.testing.assert_array_equal(ev.cz, jev.cz)
    np.testing.assert_array_equal(ev.loss, jev.loss)
    np.testing.assert_array_equal(ev.angles, jev.angles)
    for cz_max, loss_max in [(4, 0.5), (100, 1.0), (0, 0.0)]:
        np.testing.assert_array_equal(
            tcand.filter_prospective(ev, cz_max, loss_max),
            jcand.filter_prospective(jev, cz_max, loss_max))


@pytest.mark.parametrize('cp_dist', ['uniform', '0', 'normal'])
def test_generate_initial_angles_batch(cp_dist):
    """The JAX package's draw from the same key: bit-equal off the CP
    angles (and on them for 'uniform' and '0'), the normal CP draws within
    2e-6 (XLA's erfinv against the port's, a few ulp)."""
    cp_mask = np.zeros(20, dtype=np.float32)
    cp_mask[[6, 13]] = 1
    draw = lambda: tcand.generate_initial_angles_batch(
        prng.PRNGKey(5, 'cpu'), 20, cp_mask, cp_dist=cp_dist, batch_size=7)
    a = draw()
    assert a.shape == (7, 20) and a.dtype == torch.float32
    assert torch.equal(a, draw())  # same seed, same angles
    free = a[:, cp_mask == 0]
    assert float(free.min()) >= 0 and float(free.max()) < 2 * math.pi
    if cp_dist == '0':
        assert float(a[:, cp_mask == 1].abs().max()) == 0.0
    ref = np.asarray(jcand.generate_initial_angles_batch(
        jax.random.PRNGKey(5), 20, jnp.asarray(cp_mask), cp_dist=cp_dist,
        batch_size=7))
    np.testing.assert_array_equal(a[:, cp_mask == 0].numpy(),
                                  ref[:, cp_mask == 0])
    np.testing.assert_allclose(a.numpy(), ref, rtol=0,
                               atol=2e-6 if cp_dist == 'normal' else 0)


def test_verify_candidates_batch_matches_jax():
    """Same candidate angles in both packages: frozen masks and CZ counts
    exactly equal, best losses within 1e-5 (float32 over 100 steps at the
    verification learning rate 0.01), same success flags."""
    n, k = 3, 12
    janz = japi.Ansatz(n, 'cp', fill_layers(chain_layer(n), k))
    tanz = tapi.Ansatz(n, 'cp', fill_layers(chain_layer(n), k))
    rng = np.random.default_rng(2)
    cand = rng.uniform(0, 2 * np.pi, (8, janz.num_angles)).astype(np.float32)
    cp_idx = np.nonzero(tanz.cp_mask)[0]
    # CP angles near 0, pi and 2pi (projected and frozen) and some free
    snap = rng.choice([0.0, np.pi, 2 * np.pi, -np.pi], size=(8, len(cp_idx)))
    near = snap + rng.uniform(-0.15, 0.15, size=snap.shape)
    free = rng.uniform(size=snap.shape) > 0.7
    cand[:, cp_idx] = np.where(free, cand[:, cp_idx], near).astype(np.float32)
    target_loss = 0.2
    ver = tcand.verify_candidates_batch(
        tapi.LossSpec('hst', target=u_ccz3), tanz, cand, threshold_cp=0.2,
        learning_rate=0.01, num_iterations=100, target_loss=target_loss,
        device='cpu')
    jver = jcand.verify_candidates_batch(
        japi.LossSpec('hst', target=u_ccz3), janz.unitary, cand,
        janz.cp_mask, threshold_cp=0.2, learning_rate=0.01,
        num_iterations=100, target_loss=target_loss, anz=janz)
    np.testing.assert_array_equal(ver.frozen, jver.frozen)
    np.testing.assert_array_equal(ver.cz, jver.cz)
    assert ver.success.any() and not ver.success.all()
    np.testing.assert_array_equal(ver.success, jver.success)
    np.testing.assert_allclose(ver.best_loss, jver.best_loss, atol=1e-5)
    frozen = ver.frozen
    np.testing.assert_array_equal(ver.best_angles[frozen],
                                  np.asarray(jver.best_angles)[frozen])


@pytest.mark.parametrize('method', ['hessian', 'angle by angle'])
def test_verify_candidates_batch_with_another_method_matches_jax(method):
    """The non-fused branch: the same candidates through both packages'
    chains with the projected angles frozen. Frozen masks and CZ counts
    equal; best losses and angles within 1e-3 (hessian) or 1e-4 (angle by
    angle). The hessian case runs in float64 in both packages (the JAX
    package under jax.enable_x64, both precisions set back after): three
    Newton steps against a nearly singular Hessian turn float32 rounding
    into angle differences of up to 1e-3 (an angle of about 12 rad), which
    differ between hosts, and float64 leaves about 1e-11. As in the JAX
    package the mask multiplies the gradient before the preconditioner,
    which mixes coordinates, and coordinate descent takes no mask: only
    Adam keeps the projected angles exactly in place."""
    n, k = 2, 2
    janz = japi.Ansatz(n, 'cp', fill_layers(chain_layer(n), k), 'xz')
    tanz = tapi.Ansatz(n, 'cp', fill_layers(chain_layer(n), k), 'xz')
    rng = np.random.default_rng(9)
    cand = rng.uniform(0, 2 * np.pi, (4, tanz.num_angles)).astype(np.float32)
    cp = np.nonzero(tanz.cp_mask)[0]
    cand[:, cp] = np.array([[0.05, np.pi - 0.1], [np.pi + 0.1, 2.0],
                            [6.2, 0.1], [1.0, 4.0]], dtype=np.float32)
    from cpflow_tpu_torch.ops.gates import cz_mat
    kw = dict(threshold_cp=0.2, method=method, learning_rate=0.05,
              num_iterations=3, target_loss=1e-6)
    double = method == 'hessian'
    with jax.enable_x64(double):
        jconfig.set_precision(double)
        tconfig.set_precision(double)
        try:
            ver = tcand.verify_candidates_batch(
                tapi.LossSpec('hst', target=cz_mat), tanz, cand,
                device='cpu', **kw)
            jver = jcand.verify_candidates_batch(
                japi.LossSpec('hst', target=cz_mat), janz.unitary, cand,
                janz.cp_mask, **kw)
        finally:
            jconfig.set_precision(False)
            tconfig.set_precision(False)
    assert ver.best_angles.dtype == np.asarray(jver.best_angles).dtype == \
        (np.float64 if double else np.float32)
    np.testing.assert_array_equal(ver.frozen, jver.frozen)
    np.testing.assert_array_equal(ver.cz, jver.cz)
    assert ver.cz.tolist() == [1, 3, 0, 4]
    tol = 1e-4 if method == 'angle by angle' else 1e-3
    np.testing.assert_allclose(ver.best_loss, jver.best_loss, atol=tol)
    np.testing.assert_allclose(ver.best_angles, jver.best_angles, atol=tol)
    # the natural-gradient methods need the ansatz's unitary, which the JAX
    # package's verification does not hand on (it raises); the port's does
    nat = tcand.verify_candidates_batch(
        tapi.LossSpec('hst', target=cz_mat), tanz, cand, device='cpu',
        **dict(kw, method='natural adam'))
    np.testing.assert_array_equal(nat.cz, ver.cz)
    assert np.isfinite(nat.best_loss).all()


def test_insert_params_and_constrained_function_match_jax():
    got = tcand.insert_params(torch.tensor([0., 1., 2., 3.]),
                              [-1., -2., -4.], [0, 2, 4])
    assert got.tolist() == [-1., 0., -2., 1., -4., 2., 3.]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcand.insert_params(
            jnp.arange(4.), jnp.asarray([-1., -2., -4.]), [0, 2, 4])))
    host = tcand.insert_params([0, 1, 2, 3], [-1, -2, -4], [0, 2, 4],
                               as_tensor=False)
    assert isinstance(host, np.ndarray) and host.tolist() == got.tolist()
    free = torch.tensor([1., 2.], requires_grad=True)
    f = tcand.constrained_function(lambda v: (v ** 2).sum() + v[1], [5.], [1])
    out = f(free)
    assert float(out) == 1 + 25 + 4 + 5
    assert torch.autograd.grad(out, free)[0].tolist() == [2., 4.]


def test_single_candidate_wrappers_match_jax():
    """convert_cp_to_cz, evaluate_cp_result, filter_cp_results and
    verify_cp_result with the reference's contracts, on learning histories
    from the same initial angles in both packages."""
    from cpflow_tpu import optimize as jopt
    from cpflow_tpu.ops.penalty import cp_penalty_linear as j_penalty
    from cpflow_tpu_torch import optimize as topt
    from cpflow_tpu_torch.circuits.passes import hst_distance
    from cpflow_tpu_torch.ops.gates import cz_mat
    from cpflow_tpu_torch.ops.penalty import cp_penalty_linear as t_penalty
    n, k = 2, 2
    janz = japi.Ansatz(n, 'cp', fill_layers(chain_layer(n), k), 'xz')
    tanz = tapi.Ansatz(n, 'cp', fill_layers(chain_layer(n), k), 'xz')
    jspec = japi.LossSpec('hst', target=cz_mat)
    tspec = tapi.LossSpec('hst', target=cz_mat)
    pen = (np.pi / 2, 2.0, .05, .05, .05)
    jreg = lambda a: 0.002 * j_penalty(a * janz.cp_mask, *pen).sum()
    tmask = torch.tensor(tanz.cp_mask)
    treg = lambda a: 0.002 * t_penalty(a * tmask, *pen).sum()
    inits = np.random.default_rng(10).uniform(
        0, 2 * np.pi, (8, tanz.num_angles)).astype(np.float32)
    jres = jopt.mynimize_repeated(
        lambda a: jspec(janz.unitary(a)), janz.num_angles,
        initial_params_batch=jnp.asarray(inits), regularization_func=jreg,
        keep_history=False, num_iterations=500)
    tres = topt.mynimize_repeated(
        lambda a: tspec(tanz.unitary(a)), tanz.num_angles,
        initial_params_batch=inits, regularization_func=treg,
        keep_history=False, num_iterations=500, device='cpu')
    for t, j in zip(tres, jres):
        tcz, tloss, tang = tcand.evaluate_cp_result(t, tanz.cp_mask)
        jcz, jloss, jang = jcand.evaluate_cp_result(j, janz.cp_mask)
        assert isinstance(tcz, int)
        if abs(float(tloss) - float(jloss)) <= 1e-4:   # same basin
            assert tcz == jcz
    selected = tcand.filter_cp_results(tres, tanz.cp_mask,
                                       threshold_cz_count=3,
                                       threshold_loss=1e-3)
    jselected = jcand.filter_cp_results(jres, janz.cp_mask,
                                        threshold_cz_count=3,
                                        threshold_loss=1e-3)
    assert selected and [s[0] for s in selected] == sorted(
        s[0] for s in selected)
    assert selected[0][0] == jselected[0][0]

    cz0, res0 = selected[0]
    circ_func, u_func, free = tcand.convert_cp_to_cz(
        tanz, res0['params'][1])
    _, _, jfree = jcand.convert_cp_to_cz(janz, jnp.asarray(
        res0['params'][1].numpy()))
    np.testing.assert_allclose(free.numpy(), np.asarray(jfree), atol=1e-6)
    options = tapi.StaticOptions(num_cp_gates=k, accepted_num_cz_gates=3,
                                 num_gd_iterations_at_verification=1500)
    success, num_cz, circ_func, u_func, best = tcand.verify_cp_result(
        res0, tanz, tspec, options)
    assert success and num_cz == cz0
    qc = circ_func(best.numpy())
    assert hst_distance(qc.unitary().astype(np.complex64),
                        u_func(best).numpy()) < 1e-4
    out = tcand.verify_cp_result(res0, tanz, tspec, options,
                                 keep_history=True)
    assert len(out) == 7 and tuple(out[5].shape) == (1500, len(free))

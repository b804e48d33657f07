"""The reference-shaped entry points of the port, ``mynimize``,
``mynimize_repeated``, ``unitary_learn`` (optimize/__init__.py),
``Ansatz.learn`` and the non-Adam and history branches of
``Synthesize._generate_raw``, against the JAX package on the same numpy
initial angles: return shapes and keys equal, values within 1e-4 after 30
Adam steps (float32), 1e-3 after 4 steps of a preconditioned method. The
leftovers ported with them: config.set_precision, topology's random
placements, Synthesize._loss_and_reg and _plot_raw."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random as jrandom

from cpflow_tpu import api as japi
from cpflow_tpu import optimize as jopt
from cpflow_tpu import topology as jtop
from cpflow_tpu.ops.trig import random_angles as j_random_angles
from cpflow_tpu.ops.losses import cost_HST as j_hst
from cpflow_tpu.sim.ansatz_kernel import build_unitary as j_build
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch import config
from cpflow_tpu_torch import optimize as topt
from cpflow_tpu_torch import topology as ttop
from cpflow_tpu_torch.ops import prng
from cpflow_tpu_torch.ops.gates import cz_mat, u_ccz3
from cpflow_tpu_torch.ops.losses import cost_HST as t_hst
from cpflow_tpu_torch.sim.ansatz_kernel import build_unitary as t_build
from cpflow_tpu_torch.topology import chain_layer, fill_layers

torch.set_num_threads(1)

PLACEMENTS = fill_layers(chain_layer(2), 2)
P = 6 + 5 * 2     # 'xz': 5 angles a block
X0 = np.random.default_rng(0).uniform(0, 2 * np.pi, (4, P)).astype(np.float32)
ju = lambda a: j_build(2, 'cp', 'xz', PLACEMENTS, a)
tu = lambda a: t_build(2, 'cp', 'xz', PLACEMENTS, a)
jloss = lambda a: j_hst(ju(a), cz_mat)
tloss = lambda a: t_hst(tu(a), cz_mat)


def _close(t, j, atol=1e-4):
    np.testing.assert_allclose(torch.as_tensor(t).detach().numpy(),
                               np.asarray(j), atol=atol)


@pytest.mark.parametrize('keep_history', [True, False])
@pytest.mark.parametrize('method', ['adam', 'natural adam', 'hessian',
                                    'angle by angle'])
def test_mynimize_matches_jax(method, keep_history):
    steps = 30 if method == 'adam' else 4
    jh, jl = jopt.mynimize(jloss, P, method=method, u_func=ju,
                           keep_history=keep_history,
                           initial_params=jnp.asarray(X0[0]),
                           num_iterations=steps)
    th, tl = topt.mynimize(tloss, P, method=method, u_func=tu,
                           keep_history=keep_history, initial_params=X0[0],
                           num_iterations=steps, device='cpu')
    assert tuple(th.shape) == tuple(jh.shape)
    assert tuple(tl.shape) == tuple(jl.shape)
    tol = 1e-4 if method in ('adam', 'angle by angle') else 1e-3
    _close(th, jh, tol)
    _close(tl, jl, tol)


def test_mynimize_draws_its_own_angles_from_a_generator():
    """mynimize draws its start from `key` (default PRNGKey(0), as the JAX
    package's mynimize): its first iterate is the JAX package's draw, bit
    for bit, and the chains agree after 3 steps."""
    key = lambda: prng.PRNGKey(7, 'cpu')
    h1, l1 = topt.mynimize(tloss, P, num_iterations=3, device='cpu',
                           key=key())
    h2, _ = topt.mynimize(tloss, P, num_iterations=3, device='cpu',
                          key=key())
    assert tuple(h1.shape) == (3, P) and torch.equal(h1, h2)
    assert 0 <= float(h1[0].min()) and float(h1[0].max()) < 2 * np.pi
    h3, l3 = topt.mynimize(tloss, P, num_iterations=3, device='cpu')
    assert not torch.equal(h1[0], h3[0])      # the default is seed 0
    np.testing.assert_array_equal(
        h1[0].numpy(), np.asarray(j_random_angles(P, key=jrandom.PRNGKey(7))))
    jh, jl = jopt.mynimize(jloss, P, num_iterations=3)
    np.testing.assert_array_equal(h3[0].numpy(), np.asarray(jh)[0])
    _close(h3, jh)
    _close(l3, jl)


@pytest.mark.parametrize('regularized', [False, True])
@pytest.mark.parametrize('keep_history', [True, False])
def test_mynimize_repeated_matches_jax(keep_history, regularized):
    jreg = (lambda a: 0.01 * jnp.abs(a).sum()) if regularized else None
    treg = (lambda a: 0.01 * torch.abs(a).sum()) if regularized else None
    jr = jopt.mynimize_repeated(jloss, P, initial_params_batch=jnp.asarray(X0),
                                regularization_func=jreg,
                                keep_history=keep_history, num_iterations=30)
    tr = topt.mynimize_repeated(tloss, P, initial_params_batch=X0,
                                regularization_func=treg,
                                keep_history=keep_history, num_iterations=30,
                                device='cpu')
    assert isinstance(tr, list) and len(tr) == len(jr) == 4
    for t, j in zip(tr, jr):
        assert set(t) == set(j) == (
            {'params', 'loss', 'reg', 'regloss'} if regularized
            else {'params', 'loss'})
        for key in j:
            assert tuple(t[key].shape) == tuple(j[key].shape)
            _close(t[key], j[key])


def test_mynimize_repeated_single_vector_and_uncomputed_losses():
    jr = jopt.mynimize_repeated(jloss, P, initial_params_batch=jnp.asarray(
        X0[1]), num_iterations=10, keep_history=False)
    tr = topt.mynimize_repeated(tloss, P, initial_params_batch=X0[1],
                                num_iterations=10, keep_history=False,
                                device='cpu')
    assert isinstance(tr, dict) and set(tr) == set(jr) == {'params', 'loss'}
    assert tuple(tr['params'].shape) == (2, P)
    _close(tr['params'], jr['params'])
    # compute_losses=False: 'loss' is the regularized objective
    treg = lambda a: 0.01 * torch.abs(a).sum()
    out = topt.mynimize_repeated(tloss, P, initial_params_batch=X0,
                                 regularization_func=treg, num_iterations=3,
                                 compute_losses=False, device='cpu')
    assert set(out[0]) == {'params', 'loss'}
    assert abs(float(out[0]['loss'][0]) - float(
        tloss(torch.tensor(X0[0])) + treg(torch.tensor(X0[0])))) <= 1e-6
    # its own draw: num_repeats chains, or one
    many = topt.mynimize_repeated(tloss, P, num_repeats=3, num_iterations=2,
                                  device='cpu')
    one = topt.mynimize_repeated(tloss, P, num_repeats=1, num_iterations=2,
                                 device='cpu')
    assert len(many) == 3 and isinstance(one, dict)


@pytest.mark.parametrize('disc_func', [None, 'swap'])
def test_unitary_learn_matches_jax(disc_func):
    """A plain u_func, with the linear CP penalty of the reference's
    regularization_options."""
    mask = np.zeros(P, dtype=np.float32)
    mask[[10, 15]] = 1
    ropts = dict(function='linear', cp_mask=mask, r=0.002, xmax=np.pi / 2,
                 ymax=2.0, plato=0.05)
    jr = jopt.unitary_learn(ju, jnp.asarray(cz_mat), P, disc_func=disc_func,
                            regularization_options=dict(
                                ropts, cp_mask=jnp.asarray(mask)),
                            initial_angles=jnp.asarray(X0),
                            keep_history=False, num_iterations=30)
    tr = topt.unitary_learn(tu, cz_mat, P, disc_func=disc_func,
                            regularization_options=ropts, initial_angles=X0,
                            keep_history=False, num_iterations=30,
                            device='cpu')
    assert len(tr) == len(jr) == 4
    for t, j in zip(tr, jr):
        assert set(t) == set(j) == {'params', 'loss', 'reg', 'regloss'}
        for key in j:
            _close(t[key], j[key])
    with pytest.raises(ValueError, match='not supported'):
        topt.unitary_learn(tu, cz_mat, P, initial_angles=X0, device='cpu',
                           regularization_options=dict(ropts, function='L2'))


@pytest.mark.parametrize('keep_history', [True, False])
def test_ansatz_learn_matches_jax(keep_history):
    """Ansatz.learn, which learns the ansatz as a batched objective (on a
    card: through the unitary kernels), gives the JAX package's lists."""
    janz = japi.Ansatz(2, 'cp', dict(PLACEMENTS), 'xz')
    tanz = tapi.Ansatz(2, 'cp', dict(PLACEMENTS), 'xz')
    ropts = dict(function='linear', cp_mask=tanz.cp_mask, r=0.002,
                 xmax=np.pi / 2, ymax=2.0)
    jr = janz.learn(jnp.asarray(cz_mat), initial_angles=jnp.asarray(X0),
                    keep_history=keep_history, num_iterations=30,
                    regularization_options=dict(ropts, cp_mask=janz.cp_mask))
    tr = tanz.learn(cz_mat, initial_angles=X0, keep_history=keep_history,
                    num_iterations=30, regularization_options=ropts,
                    device='cpu')
    assert len(tr) == len(jr) == 4
    for t, j in zip(tr, jr):
        assert set(t) == set(j) == {'params', 'loss', 'reg', 'regloss'}
        for key in j:
            assert tuple(t[key].shape) == tuple(j[key].shape) == \
                ((30, P) if key == 'params' and keep_history else
                 (2, P) if key == 'params' else
                 (30,) if keep_history else (2,))
            _close(t[key], j[key])
    plain = tanz.learn(cz_mat, initial_angles=X0, keep_history=False,
                       num_iterations=400, device='cpu')
    assert set(plain[0]) == {'params', 'loss'}
    assert min(float(r['loss'][1]) for r in plain) < 1e-5


def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip('this machine has a card: nothing to refuse')
    from cpflow_tpu_torch.circuits import refine as trefine
    from cpflow_tpu_torch.optimize import candidates as tcand
    tanz = tapi.Ansatz(2, 'cp', dict(PLACEMENTS), 'xz')
    spec = tapi.LossSpec('hst', target=cz_mat)
    options = tapi.StaticOptions(num_cp_gates=2, accepted_num_cz_gates=2,
                                 num_gd_iterations_at_verification=1)
    history = {'params': X0[:2], 'loss': np.array([1., 0.5]),
               'regloss': np.array([1., 0.5])}      # a numpy history
    for call in [lambda **kw: trefine.lasso_angles(
                     lambda a: (a ** 2).sum() * 0, X0[0], **kw),
                 lambda **kw: tcand.convert_cp_to_cz(tanz, X0[0], **kw),
                 lambda **kw: tcand.verify_cp_result(history, tanz, spec,
                                                     options, **kw),
                 lambda **kw: topt.mynimize(tloss, P, num_iterations=1, **kw),
                 lambda **kw: topt.mynimize_repeated(
                     tloss, P, initial_params_batch=X0, num_iterations=1,
                     **kw),
                 lambda **kw: topt.unitary_learn(
                     tu, cz_mat, P, initial_angles=X0, num_iterations=1,
                     **kw),
                 lambda **kw: tanz.learn(cz_mat, initial_angles=X0,
                                         num_iterations=1, **kw)]:
        with pytest.raises(RuntimeError, match='no CUDA device is visible'):
            call()
        call(device='cpu')


# ------------------------------------------------ Synthesize's raw stage

N, K, SAMPLES = 3, 4, 6
INITS = np.random.default_rng(1).uniform(
    0, 2 * np.pi, (SAMPLES, 3 * N + 7 * K)).astype(np.float32)


def _synths():
    return (japi.Synthesize(chain_layer(N), target_unitary=u_ccz3, mesh=None),
            tapi.Synthesize(chain_layer(N), target_unitary=u_ccz3,
                            device='cpu'))


def _options(api, method, steps):
    return api.StaticOptions(num_cp_gates=K, num_samples=SAMPLES,
                             accepted_num_cz_gates=100, entry_loss=10.0,
                             method=method, num_gd_iterations=steps,
                             num_gd_iterations_at_verification=steps)


@pytest.mark.parametrize('keep_history', [True, False])
@pytest.mark.parametrize('method', ['adam', 'natural adam', 'natural gd',
                                    'hessian', 'angle by angle'])
def test_generate_raw_matches_jax_for_every_method(method, keep_history):
    jsynth, tsynth = _synths()
    # a Newton step on this 37-angle objective moves angles by 2 and then
    # by 40 (its Hessian is singular up to the Tikhonov term), so the two
    # float32 solves are held together over the first update only
    steps = {'adam': 30, 'hessian': 2}.get(method, 4)
    jraw = jsynth._generate_raw(_options(japi, method, steps),
                                jnp.asarray(INITS), keep_history=keep_history)
    traw = tsynth._generate_raw(_options(tapi, method, steps), INITS,
                                keep_history=keep_history)
    tol = 1e-4 if method in ('adam', 'angle by angle') else 1e-3
    assert tuple(traw.params.shape) == tuple(jraw.params.shape)
    for name in ('params', 'regloss', 'loss', 'reg'):
        _close(getattr(traw, name), getattr(jraw, name), tol)


@pytest.mark.parametrize('method', ['natural adam', 'natural gd', 'hessian',
                                    'angle by angle'])
def test_static_runs_with_every_method(method):
    _, tsynth = _synths()
    res = tsynth.static(_options(tapi, method, 3), save_results=False,
                        verbose=False, initial_angles_array=INITS)
    assert set(tsynth.stage_seconds) >= {'sampling'}
    for d in res.decompositions:
        assert np.isfinite(d.loss)
    ev = tsynth._raw_and_evaluate(_options(tapi, method, 3), INITS)
    assert ev.angles.shape == INITS.shape and np.isfinite(ev.loss).all()
    # the evaluation takes the best iterate of the history
    raw = tsynth._generate_raw(_options(tapi, method, 3), INITS)
    np.testing.assert_allclose(ev.loss, raw.loss[
        torch.arange(SAMPLES), raw.regloss.argmin(dim=1)].numpy())


def test_loss_and_reg_match_jax():
    jsynth, tsynth = _synths()
    jopts, topts = _options(japi, 'adam', 1), _options(tapi, 'adam', 1)
    jl, jr = jsynth._loss_and_reg(jsynth._ansatz(jopts), jopts)
    tl, tr = tsynth._loss_and_reg(tsynth._ansatz(topts), topts)
    a = INITS[0]
    assert abs(float(tl(torch.tensor(a))) - float(jl(jnp.asarray(a)))) <= 1e-5
    assert abs(float(tr(torch.tensor(a))) - float(jr(jnp.asarray(a)))) <= 1e-6


def test_plot_raw_draws_three_curves():
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    _, tsynth = _synths()
    raw = tsynth._generate_raw(_options(tapi, 'adam', 5), INITS,
                               keep_history=True)
    plt.figure()
    tsynth._plot_raw(raw[0])
    ax = plt.gca()
    assert [line.get_label() for line in ax.get_lines()] == \
        ['regloss', 'loss', 'reg']
    assert ax.get_yscale() == 'log'
    plt.close('all')


# ------------------------------------------------------------ leftovers

def test_set_precision_switches_the_default_dtypes():
    try:
        config.set_precision(double=True)
        assert config.real_dtype == torch.float64
        assert config.complex_dtype == torch.complex128
        u = t_build(2, 'cp', 'xz', PLACEMENTS, X0[0].astype(np.float64))
        assert u.dtype == torch.complex128
    finally:
        config.set_precision()
    assert config.real_dtype == torch.float32
    assert config.complex_dtype == torch.complex64
    assert tu(X0[0]).dtype == torch.complex64


def test_random_placements_are_distinct_pairs_from_a_generator():
    """Distinct pairs from a key, equal to the JAX package's pairs from the
    same key (and from the default PRNGKey(0))."""
    pairs = ttop.random_placements(5, 20, key=prng.PRNGKey(3, 'cpu'))
    assert len(pairs) == 20
    assert all(len(p) == 2 and p[0] != p[1] and 0 <= min(p) and max(p) < 5
               for p in pairs)
    assert len({tuple(p) for p in pairs}) > 5
    assert pairs == ttop.random_placements(5, 20, key=prng.PRNGKey(3, 'cpu'))
    assert ttop.random_placement(3) == ttop.random_placement(3)  # seed 0
    as_ints = lambda ps: [[int(q) for q in p] for p in ps]
    assert pairs == as_ints(jtop.random_placements(
        5, 20, key=jrandom.PRNGKey(3)))
    assert ttop.random_placement(3) == as_ints([jtop.random_placement(3)])[0]

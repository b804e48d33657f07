"""The port's optimization engine (optimize/engine.py) against
cpflow_tpu.optimize.engine on the same numpy inputs: the chains, the named
methods of minimize_chain and minimize_multistart, the preconditioners,
minimize_fused with a history, RawResult, and where an entry point runs.

Tolerances (float32 in both packages): histories of the Adam, gradient
descent and angle-by-angle chains within 1e-4 after 30 steps (10 sweeps of
angle by angle); the preconditioned methods within 1e-3 after 4 steps, where
a float32 solve against a nearly singular metric or Hessian (Tikhonov 1e-4)
has amplified the rounding; the [initial, best] contract exact in
structure."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu.ops.losses import cost_HST as j_hst
from cpflow_tpu.ops.losses import fubini_study as j_fubini_study
from cpflow_tpu.optimize import engine as jengine
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu.sim.ansatz_kernel import build_unitary as j_build
from cpflow_tpu.api import LossSpec as JLossSpec
from cpflow_tpu.ops.penalty import cp_penalty_linear as j_penalty
from cpflow_tpu_torch.api import Ansatz, LossSpec
from cpflow_tpu_torch.ops.losses import cost_HST as t_hst
from cpflow_tpu_torch.ops.penalty import LinearPenalty
from cpflow_tpu_torch.optimize import engine as tengine
from cpflow_tpu_torch.sim.ansatz_kernel import build_unitary as t_build
from cpflow_tpu_torch.sim.batched import make_batched_regloss
from cpflow_tpu_torch.topology import chain_layer, fill_layers

torch.set_num_threads(1)

N, K = 2, 2
PLACEMENTS = fill_layers(chain_layer(N), K)
P = 3 * N + 7 * K
PEN = (np.pi / 2, 2.0, 0.05, 0.05, 0.05)
METHODS = ['adam', 'natural adam', 'natural gd', 'hessian', 'angle by angle']


def _inputs(B=4, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, 2 * np.pi, (B, P)).astype(np.float32)
    target = np.asarray(j_build(N, 'cp', 'xyz', PLACEMENTS, jnp.asarray(
        rng.uniform(0, 2 * np.pi, P).astype(np.float32))))
    return x0, target


def _funcs(target):
    ju = lambda a: j_build(N, 'cp', 'xyz', PLACEMENTS, a)
    tu = lambda a: t_build(N, 'cp', 'xyz', PLACEMENTS, a)
    return (ju, lambda a: j_hst(ju(a), target),
            tu, lambda a: t_hst(tu(a), target))


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol)


# ------------------------------------------------------------------ chains

@pytest.mark.parametrize('keep_history', [True, False])
def test_adam_chain_matches_jax(keep_history):
    x0, target = _inputs()
    _, jl, _, tl = _funcs(target)
    jh, jloss = jengine.adam_chain(jax.value_and_grad(jl), jnp.asarray(x0[0]),
                                   num_iterations=30,
                                   keep_history=keep_history)

    def lg(p):
        p = p.detach().requires_grad_(True)
        loss = tl(p)
        return loss.detach(), torch.autograd.grad(loss, p)[0]

    th, tloss = tengine.adam_chain(lg, torch.tensor(x0[0]), num_iterations=30,
                                   keep_history=keep_history)
    assert tuple(th.shape) == ((30, P) if keep_history else (2, P))
    assert tuple(tloss.shape) == ((30,) if keep_history else (2,))
    _close(th, jh, 1e-4)
    _close(tloss, jloss, 1e-4)
    assert torch.equal(th[0], torch.tensor(x0[0]))         # the initial angles
    if keep_history:   # loss[i] is evaluated at params[i]
        for i in (0, 7, 29):
            assert abs(float(tloss[i]) - float(tl(th[i]))) <= 1e-6
    else:              # best: the angles before the update that improved
        assert float(tloss[1]) == float(tl(th[1]))
        assert float(tloss[1]) <= float(tloss[0])


def test_adam_chain_batch_last_equals_one_chain_at_a_time():
    """A chain on (P, B) angles with a (B,) loss is the B chains side by
    side, in history and in best mode."""
    x0, target = _inputs()
    _, _, _, tl = _funcs(target)
    batch = torch.func.vmap(torch.func.grad_and_value(tl), in_dims=1,
                            out_dims=(1, 0))
    lg_batch = lambda p: batch(p)[::-1]
    one = torch.func.grad_and_value(tl)
    lg_one = lambda p: one(p)[::-1]
    for keep_history in (True, False):
        hb, lb = tengine.adam_chain(lg_batch, torch.tensor(x0.T.copy()),
                                    num_iterations=20,
                                    keep_history=keep_history)
        for b in range(x0.shape[0]):
            h1, l1 = tengine.adam_chain(lg_one, torch.tensor(x0[b]),
                                        num_iterations=20,
                                        keep_history=keep_history)
            torch.testing.assert_close(hb[:, :, b], h1, atol=1e-5, rtol=0)
            torch.testing.assert_close(lb[:, b], l1, atol=1e-5, rtol=0)


def test_gradient_descent_chain_matches_jax():
    x0, target = _inputs()
    _, jl, _, tl = _funcs(target)
    jh, jloss = jengine.gradient_descent_chain(
        jax.value_and_grad(jl), jnp.asarray(x0[1]), learning_rate=0.3,
        num_iterations=30)
    one = torch.func.grad_and_value(tl)
    th, tloss = tengine.gradient_descent_chain(
        lambda p: one(p)[::-1], torch.tensor(x0[1]), learning_rate=0.3,
        num_iterations=30)
    assert tuple(th.shape) == (30, P) and tuple(tloss.shape) == (30,)
    _close(th, jh, 1e-4)
    _close(tloss, jloss, 1e-4)


def test_angle_by_angle_chain_matches_jax():
    x0, target = _inputs()
    _, jl, _, tl = _funcs(target)
    jh, jloss = jax.jit(lambda a: jengine.angle_by_angle_chain(
        jl, a, num_iterations=10))(jnp.asarray(x0[2]))
    th, tloss = tengine.angle_by_angle_chain(tl, torch.tensor(x0[2]),
                                             num_iterations=10)
    assert tuple(th.shape) == (10, P) and tuple(tloss.shape) == (10,)
    # an angle is defined up to 2 pi; both use atan2 + pi
    _close(th, jh, 1e-4)
    _close(tloss, jloss, 1e-4)
    assert float(tloss[-1]) < float(tloss[0])   # every sweep is exact descent
    one = tengine.angle_by_angle_update(tl, torch.tensor(x0[2]))
    _close(one, jengine.angle_by_angle_update(jl, jnp.asarray(x0[2])), 1e-4)


# ---------------------------------------------------------- preconditioners

def test_preconditioners_match_jax():
    """The same linear systems in both packages; the solutions are compared
    through the systems' residuals, as a float32 solve against a matrix of
    condition number 1e4 and more agrees no closer."""
    x0, target = _inputs()
    ju, jl, tu, tl = _funcs(target)
    x, g = x0[0], np.random.default_rng(5).normal(size=P).astype(np.float32)
    for jmake, tmake, jarg, targ in [
            (jengine.plain_hessian_preconditioner,
             tengine.plain_hessian_preconditioner, jl, tl),
            (jengine.plain_natural_preconditioner,
             tengine.plain_natural_preconditioner, ju, tu),
            (jengine.sparse_hessian_preconditioner,
             tengine.sparse_hessian_preconditioner, jl, tl)]:
        js = np.asarray(jmake(jarg)(jnp.asarray(x), jnp.asarray(g)))
        ts = tmake(targ)(torch.tensor(x), torch.tensor(g)).numpy()
        assert ts.shape == (P,) and np.isfinite(ts).all()
        if jmake is jengine.plain_natural_preconditioner:
            a = np.asarray(j_fubini_study(ju, jnp.asarray(x))) + \
                1e-4 * np.eye(P)
        else:
            a = np.asarray(jax.hessian(jl)(jnp.asarray(x))) + 1e-4 * np.eye(P)
        scale = np.abs(a).max() * max(np.abs(js).max(), 1.0)
        assert np.abs(a @ ts - g).max() <= 2e-2 * scale
        assert np.abs(a @ js - g).max() <= 2e-2 * scale


# ----------------------------------------------------------- named methods

@pytest.mark.parametrize('method', METHODS)
def test_minimize_chain_matches_jax(method):
    x0, target = _inputs()
    ju, jl, tu, tl = _funcs(target)
    steps = 30 if method == 'adam' else 4
    jh, jloss = jax.jit(lambda a: jengine.minimize_chain(
        jl, a, method=method, num_iterations=steps, u_func=ju))(
            jnp.asarray(x0[3]))
    th, tloss = tengine.minimize_chain(tl, x0[3], method=method,
                                       num_iterations=steps, u_func=tu,
                                       device='cpu')
    tol = 1e-4 if method in ('adam', 'angle by angle') else 1e-3
    _close(th, jh, tol)
    _close(tloss, jloss, tol)


def test_minimize_chain_grad_mask_freezes_coordinates():
    x0, target = _inputs()
    _, jl, _, tl = _funcs(target)
    mask = (np.arange(P) % 3 != 0).astype(np.float32)
    jh, _ = jengine.minimize_chain(jl, jnp.asarray(x0[0]), num_iterations=20,
                                   grad_mask=jnp.asarray(mask))
    th, _ = tengine.minimize_chain(tl, x0[0], num_iterations=20,
                                   grad_mask=mask, device='cpu')
    _close(th, jh, 1e-4)
    assert torch.equal(th[:, mask == 0], th[:1, mask == 0].expand(20, -1))


@pytest.mark.parametrize('keep_history', [True, False])
@pytest.mark.parametrize('method', METHODS + ['adam, regularized'])
def test_minimize_multistart_matches_jax(method, keep_history):
    """Each method on a per-chain callable, from the same (B, P) angles.
    The regularized case adds a per-chain L1 penalty and checks the
    loss/reg split of the history."""
    x0, target = _inputs()
    ju, jl, tu, tl = _funcs(target)
    jreg = treg = None
    if method.endswith('regularized'):
        method = 'adam'
        jreg = lambda a: 0.01 * jnp.abs(a).sum()
        treg = lambda a: 0.01 * torch.abs(a).sum()
    steps = 30 if method == 'adam' else (6 if method == 'angle by angle'
                                         else 4)
    jr = jengine.minimize_multistart(jl, x0, method=method,
                                     num_iterations=steps,
                                     keep_history=keep_history,
                                     regularization_func=jreg, u_func=ju)
    tr = tengine.minimize_multistart(tl, x0, method=method,
                                     num_iterations=steps,
                                     keep_history=keep_history,
                                     regularization_func=treg, u_func=tu,
                                     device='cpu')
    tol = 1e-4 if method in ('adam', 'angle by angle') else 1e-3
    assert tuple(tr.params.shape) == tuple(jr.params.shape)
    assert len(tr) == len(jr) == 4 and tr.batched
    _close(tr.params, jr.params, tol)
    _close(tr.regloss, jr.regloss, tol)
    _close(tr.loss, jr.loss, tol)
    if treg is None:
        assert tr.reg is None and jr.reg is None
    else:
        _close(tr.reg, jr.reg, 1e-5)
        torch.testing.assert_close(tr.loss + tr.reg, tr.regloss)
    if method == 'adam' and not keep_history:   # [initial, best]
        assert tuple(tr.params.shape) == (4, 2, P)
        assert torch.equal(tr.params[:, 0], torch.tensor(x0))
        assert bool((tr.regloss[:, 1] <= tr.regloss[:, 0]).all())


def test_minimize_multistart_single_chain_and_options():
    x0, target = _inputs()
    _, jl, _, tl = _funcs(target)
    jr = jengine.minimize_multistart(jl, x0[0], num_iterations=10)
    tr = tengine.minimize_multistart(tl, x0[0], num_iterations=10,
                                     batch_axis=-1, device='cpu')
    assert not tr.batched and len(tr) == 1
    assert tuple(tr.params.shape) == (10, P) == tuple(jr.params.shape)
    _close(tr.params, jr.params, 1e-4)
    assert set(tr.as_single()) == {'params', 'regloss', 'loss'}
    with pytest.raises(TypeError):
        tr[0]
    # sharding (a RestartMesh) splits the batch and changes no restart;
    # a single chain is no batch to split
    from cpflow_tpu_torch.parallel.mesh import restart_mesh
    mesh = restart_mesh(['cpu'] * 2)
    split = tengine.minimize_multistart(tl, x0, num_iterations=10,
                                        sharding=mesh, device='cpu')
    whole = tengine.minimize_multistart(tl, x0, num_iterations=10,
                                        device='cpu')
    torch.testing.assert_close(split.params, whole.params, atol=1e-6, rtol=0)
    torch.testing.assert_close(split.regloss, whole.regloss, atol=1e-6,
                               rtol=0)
    with pytest.raises(ValueError, match='batch'):
        tengine.minimize_multistart(tl, x0[0], sharding=mesh, device='cpu')
    with pytest.raises(ValueError, match='not supported'):
        tengine.minimize_multistart(tl, x0, method='newton', device='cpu')


# ------------------------------------------ the batched objective's route

def _objective(target, r=0.002):
    anz = Ansatz(N, 'cp', PLACEMENTS)
    obj = make_batched_regloss(N, 'cp', 'xyz', PLACEMENTS,
                               LossSpec('hst', target=target),
                               cp_mask=anz.cp_mask,
                               regularization_func=LinearPenalty(*PEN), r=r)
    jmask = jnp.asarray(anz.cp_mask)
    jobj = jbt.make_batched_regloss(
        N, 'cp', 'xyz', PLACEMENTS, JLossSpec('hst', target=target),
        cp_mask=jmask, regularization_func=lambda a: j_penalty(a, *PEN), r=r,
        reversible=True)
    jloss = lambda a: j_hst(j_build(N, 'cp', 'xyz', PLACEMENTS, a), target)
    jreg = lambda a: r * j_penalty(a * jmask, *PEN).sum()
    return anz, obj, jobj, jloss, jreg


@pytest.mark.parametrize('method', METHODS)
def test_minimize_multistart_on_a_batched_objective_matches_jax(method):
    """A BatchedRegloss in place of the per-chain callable (the form the
    API passes, which on a card builds its unitary with the kernels) gives
    what the JAX package gives for loss + penalty as per-chain callables."""
    x0, target = _inputs()
    anz, obj, _, jloss, jreg = _objective(target)
    ju = lambda a: j_build(N, 'cp', 'xyz', PLACEMENTS, a)
    steps = 30 if method == 'adam' else 4
    jr = jengine.minimize_multistart(jloss, x0, method=method,
                                     num_iterations=steps,
                                     regularization_func=jreg, u_func=ju)
    tr = tengine.minimize_multistart(obj, x0, method=method,
                                     num_iterations=steps,
                                     u_func=anz.unitary, device='cpu')
    tol = 1e-4 if method in ('adam', 'angle by angle') else 1e-3
    _close(tr.params, jr.params, tol)
    _close(tr.regloss, jr.regloss, tol)
    _close(tr.loss, jr.loss, tol)
    _close(tr.reg, jr.reg, 1e-5)


def test_minimize_fused_with_history_matches_jax():
    x0, target = _inputs()
    _, obj, jobj, _, _ = _objective(target)
    mask = (np.random.default_rng(3).uniform(size=x0.shape) > 0.3).astype(
        np.float32)
    jr = jengine.minimize_fused(jobj, x0, num_iterations=30,
                                keep_history=True, grad_mask=mask)
    tr = tengine.minimize_fused(obj, x0, num_iterations=30,
                                keep_history=True, grad_mask=mask,
                                device='cpu')
    assert tuple(tr.params.shape) == (4, 30, P)
    assert tuple(tr.regloss.shape) == tuple(tr.loss.shape) == (4, 30)
    for name in ('params', 'regloss', 'loss', 'reg'):
        _close(getattr(tr, name), getattr(jr, name), 1e-4)
    # loss[i] is evaluated at params[i]; frozen coordinates never move
    regloss, loss = obj(tr.params[:, 11].T)
    torch.testing.assert_close(regloss, tr.regloss[:, 11])
    torch.testing.assert_close(loss, tr.loss[:, 11])
    frozen = torch.tensor(mask == 0)
    assert torch.equal(tr.params[:, -1][frozen], torch.tensor(x0)[frozen])
    # the best of the history is the [initial, best] run's best
    best = tengine.minimize_fused(obj, x0, num_iterations=30, grad_mask=mask,
                                  device='cpu')
    torch.testing.assert_close(tr.regloss.min(dim=1).values,
                               best.regloss[:, 1])
    single = tengine.minimize_fused(obj, x0[0], num_iterations=5,
                                    keep_history=True, device='cpu')
    assert not single.batched and tuple(single.params.shape) == (5, P)


def test_raw_result_access_patterns():
    raw = tengine.RawResult(params=torch.zeros(3, 2, 5),
                            regloss=torch.ones(3, 2), loss=torch.ones(3, 2),
                            reg=torch.zeros(3, 2))
    assert len(raw) == 3 and len(list(raw)) == 3
    assert set(raw[1]) == {'params', 'regloss', 'loss', 'reg'}
    assert tuple(raw[1]['params'].shape) == (2, 5)
    assert set(tengine.RawResult(raw.params, raw.regloss, raw.loss)[0]) == \
        {'params', 'regloss', 'loss'}


# ------------------------------------------------- where an entry point runs

ENTRY_POINTS = {
    'minimize_fused': lambda obj, tl, x0, **kw: tengine.minimize_fused(
        obj, x0, num_iterations=2, **kw),
    'minimize_fused, history': lambda obj, tl, x0, **kw:
        tengine.minimize_fused(obj, x0, num_iterations=2, keep_history=True,
                               **kw),
    'minimize_multistart': lambda obj, tl, x0, **kw:
        tengine.minimize_multistart(tl, x0, num_iterations=2, **kw),
    'minimize_chain': lambda obj, tl, x0, **kw: tengine.minimize_chain(
        tl, x0[0], num_iterations=2, **kw),
}


@pytest.mark.parametrize('name', sorted(ENTRY_POINTS))
def test_entry_points_run_on_the_card_unless_asked_for_the_cpu(name):
    """A numpy input and no device means the card: without one the call
    raises, it does not run on the CPU unasked. device='cpu', or a CPU
    tensor, runs here."""
    if torch.cuda.is_available():
        pytest.skip('this machine has a card: nothing to refuse')
    x0, target = _inputs()
    _, obj, _, _, _ = _objective(target)
    _, _, _, tl = _funcs(target)
    run = ENTRY_POINTS[name]
    with pytest.raises(RuntimeError, match='no CUDA device is visible'):
        run(obj, tl, x0)
    with pytest.raises(RuntimeError, match='no CUDA device is visible'):
        run(obj, tl, x0.tolist())
    run(obj, tl, x0, device='cpu')
    run(obj, tl, torch.tensor(x0))

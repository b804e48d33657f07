"""Custom losses (a callable of one unitary) in the port against the JAX
package: the same loss written once in jnp and once in torch, fed the same
numpy angles.

Through make_batched_regloss the values and gradients agree within 1e-5
(float32, at most 11 gates); through the sweep the best losses after 60
steps within 1e-4 (the sweep tolerance of tests/test_torch_sweep.py);
through Synthesize.static on the CPU, from the same initial angles, the
verified decompositions have the same least CZ count."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import api as japi
from cpflow_tpu.optimize import candidates as jcand
from cpflow_tpu.optimize import engine as jengine
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch.kernels import sweep as sk
from cpflow_tpu_torch.optimize import engine as tengine
from cpflow_tpu_torch.ops.gates import u_toff3
from cpflow_tpu_torch.sim import batched as tbt
from cpflow_tpu_torch.topology import chain_layer, connected_layer, fill_layers

torch.set_num_threads(1)

N = 3
GHZ = np.zeros(8, dtype=np.complex64)
GHZ[0] = GHZ[-1] = 2 ** -0.5
PSI0 = np.eye(8, dtype=np.complex64)[0]
# a complex target, so that a missing conjugate would show
_rng = np.random.default_rng(11)
TARGET = np.linalg.qr(_rng.normal(size=(8, 8)) + 1j * _rng.normal(
    size=(8, 8)))[0].astype(np.complex64)

# name -> (jnp callable, torch callable)
LOSSES = {
    'ghz': (lambda u: 1 - jnp.abs(GHZ.conj() @ u @ PSI0) ** 2,
            lambda u: 1 - torch.abs(torch.as_tensor(GHZ.conj(), dtype=u.dtype)
                                    @ u @ torch.as_tensor(PSI0,
                                                          dtype=u.dtype)) ** 2),
    'relative phase': (
        lambda u: 1 - (jnp.abs(u_toff3.conj() * u) ** 2).sum() / 8,
        lambda u: 1 - (torch.abs(torch.as_tensor(u_toff3.conj(),
                                                 dtype=u.dtype) * u) ** 2
                       ).sum() / 8),
    'hs test, complex target': (
        lambda u: 1 - jnp.abs((u * TARGET.conj()).sum()) ** 2 / 64,
        lambda u: 1 - torch.abs((u * torch.as_tensor(
            TARGET.conj(), dtype=u.dtype)).sum()) ** 2 / 64),
}


def _objectives(name, k=4, layer=None, rot='xyz', r=0.002, wrap=True):
    jfn, tfn = LOSSES[name]
    pl = fill_layers(layer or chain_layer(N), k)
    janz = japi.Ansatz(N, 'cp', dict(pl), rot)
    tanz = tapi.Ansatz(N, 'cp', dict(pl), rot)
    jobj = jbt.make_batched_regloss(
        N, 'cp', rot, janz.placements, jfn, cp_mask=janz.cp_mask,
        regularization_func=japi.make_regularization_function(
            japi.RegularizationOptions), r=r, reversible=True)
    tobj = tbt.make_batched_regloss(
        N, 'cp', rot, tanz.placements,
        tapi.LossSpec('custom', fn=tfn) if wrap else tfn,
        cp_mask=tanz.cp_mask,
        regularization_func=tapi.make_regularization_function(
            tapi.RegularizationOptions), r=r)
    return janz, tanz, jobj, tobj


def _angles(P, B=6, seed=0):
    return np.random.default_rng(seed).uniform(0, 2 * np.pi, (P, B)) \
        .astype(np.float32)


@pytest.mark.parametrize('wrap', [True, False], ids=['LossSpec', 'callable'])
@pytest.mark.parametrize('name', sorted(LOSSES))
def test_custom_loss_values_and_gradients_match_jax(name, wrap):
    janz, tanz, jobj, tobj = _objectives(name, wrap=wrap)
    a = _angles(tanz.num_angles)
    jreg, jloss = jobj(jnp.asarray(a))
    jgrad = jax.grad(lambda x: jobj(x)[0].sum())(jnp.asarray(a))
    ta = torch.tensor(a, requires_grad=True)
    treg, tloss = tobj(ta)
    (tgrad,) = torch.autograd.grad(treg.sum(), ta)
    assert tuple(tloss.shape) == (a.shape[1],) and tloss.dtype == torch.float32
    np.testing.assert_allclose(tloss.detach().numpy(), np.asarray(jloss),
                               atol=1e-5)
    np.testing.assert_allclose(treg.detach().numpy(), np.asarray(jreg),
                               atol=1e-5)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), atol=1e-5)


def test_custom_loss_equals_the_builtin_kind_it_restates():
    """The HS test written as a callable gives the built-in 'hst' kind's
    values and gradients; in float64 too (the objective's dtype)."""
    _, tanz, _, tobj = _objectives('hs test, complex target')
    builtin = tbt.make_batched_regloss(
        N, 'cp', 'xyz', tanz.placements, tapi.LossSpec('hst', target=TARGET),
        cp_mask=tanz.cp_mask, regularization_func=tobj.regularization_func,
        r=tobj.r)
    a = torch.tensor(_angles(tanz.num_angles), requires_grad=True)
    for x, y in zip(tobj(a), builtin(a)):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=0)
    g1, = torch.autograd.grad(tobj(a)[0].sum(), a)
    g2, = torch.autograd.grad(builtin(a)[0].sum(), a)
    torch.testing.assert_close(g1, g2, atol=1e-6, rtol=0)
    obj64 = tbt.make_batched_regloss(
        N, 'cp', 'xyz', tanz.placements,
        tapi.LossSpec('custom', fn=LOSSES['hs test, complex target'][1]),
        dtype=torch.float64)
    out = obj64(a.detach().double())[1]
    assert out.dtype == torch.float64
    torch.testing.assert_close(out.float(), builtin(a)[1].detach(), atol=1e-5,
                               rtol=0)


def test_a_custom_loss_takes_the_whole_unitary():
    _, tanz, _, tobj = _objectives('ghz')
    assert tobj.columns is None
    u = tbt.build_unitary_batched(N, 'cp', 'xyz', tanz.placements,
                                  torch.tensor(_angles(tanz.num_angles)),
                                  columns=[0])
    with pytest.raises(ValueError, match='whole unitary'):
        tbt.batched_unitary_loss(tobj.unitary_loss_func, u)
    with pytest.raises(ValueError, match='unknown loss'):
        tbt.batched_unitary_loss(tapi.LossSpec('trace'), u)


@pytest.mark.parametrize('name', sorted(LOSSES))
def test_sweep_with_a_custom_loss_matches_jax(name):
    """60 steps of the fused sweep (on the CPU: the plain loop) with a
    gradient mask: [initial, best] within the sweep tolerances."""
    janz, tanz, jobj, tobj = _objectives(name)
    a = _angles(tanz.num_angles, B=8, seed=3)
    mask = (np.random.default_rng(4).uniform(size=a.T.shape) > 0.2).astype(
        np.float32)
    jr = jengine.minimize_fused(jobj, a.T, num_iterations=60, grad_mask=mask)
    before = sk.LAUNCHES
    tr = tengine.minimize_fused(tobj, a.T.copy(), num_iterations=60,
                                grad_mask=mask, device='cpu')
    assert sk.LAUNCHES == before
    np.testing.assert_allclose(tr.regloss[:, 0].numpy(),
                               np.asarray(jr.regloss)[:, 0], atol=1e-5)
    np.testing.assert_allclose(tr.regloss[:, 1].numpy(),
                               np.asarray(jr.regloss)[:, 1], atol=1e-4)
    np.testing.assert_allclose(tr.loss[:, 1].numpy(),
                               np.asarray(jr.loss)[:, 1], atol=1e-4)


def test_target_loss_with_a_custom_loss_stops_the_plain_loop():
    _, tanz, _, tobj = _objectives('ghz', r=0.0)
    a = torch.tensor(_angles(tanz.num_angles, B=4, seed=5))
    calls = []
    real = tobj.loss_and_penalty
    tobj.loss_and_penalty = lambda x: (calls.append(1), real(x))[1]
    res = sk.sweep(tobj, a, 0.1, 500, None, 0.9)   # reached at once or soon
    assert bool((res.best_loss <= 0.9).all())
    assert len(calls) < 500


def test_loss_spec_call_and_host_evaluation_of_a_torch_callable():
    """LossSpec.__call__ on a tensor for every kind against the JAX
    package's; a custom torch callable evaluated on the host gets a
    complex128 tensor and gives a float."""
    u = np.linalg.qr(_rng.normal(size=(8, 8)) + 1j * _rng.normal(
        size=(8, 8)))[0]
    for kind, kw in [('hst', dict(target=TARGET)),
                     ('disc', dict(target=TARGET)),
                     ('state', dict(target=GHZ)),
                     ('modulo_identity', dict(target=u_toff3, num_qubits=3,
                                              wires=[0, 2])),
                     ('modulo_diagonal', dict(target=u_toff3, num_qubits=3,
                                              wires=[0, 1, 2]))]:
        got = tapi.LossSpec(kind, **kw)(torch.tensor(u.astype(np.complex64)))
        want = japi.LossSpec(kind, **kw)(jnp.asarray(u.astype(np.complex64)))
        assert abs(float(got) - float(want)) <= 1e-5, kind
    jfn, tfn = LOSSES['relative phase']
    seen = []
    spec = tapi.LossSpec('custom', fn=lambda m: (seen.append(m), tfn(m))[1])
    host = spec.numpy(u)
    assert isinstance(host, float) and seen[0].dtype == torch.complex128
    assert abs(host - float(jfn(jnp.asarray(u.astype(np.complex64))))) <= 1e-5
    assert abs(float(spec(torch.tensor(u))) - host) <= 1e-12


@pytest.fixture(scope='module')
def ghz_runs():
    """The GHZ-3 synthesis on the chain (k=4, 12 restarts, 400 + 400 steps)
    from the same numpy initial angles: the port's static run with the loss
    as a torch callable, and the JAX package's pipeline with it in jnp."""
    k, samples = 4, 12
    inits = np.random.default_rng(6).uniform(
        0, 2 * np.pi, (samples, 3 * N + 7 * k)).astype(np.float32)
    jfn, tfn = LOSSES['ghz']
    synth = tapi.Synthesize(chain_layer(N), unitary_loss_func=tfn,
                            device='cpu')
    options = tapi.StaticOptions(num_cp_gates=k, num_samples=samples,
                                 accepted_num_cz_gates=4, r=0.002,
                                 num_gd_iterations=400,
                                 num_gd_iterations_at_verification=400)
    results = synth.static(options, save_results=False, verbose=False,
                           initial_angles_array=inits)
    janz, _, jobj, _ = _objectives('ghz', k=k)
    raw = jengine.minimize_fused(jobj, inits, num_iterations=400)
    jev = jcand.evaluate_raw_batch(raw, janz.cp_mask, 0.2)
    pros = jcand.filter_prospective(jev, 4, options.entry_loss)
    batch = jev.angles[pros]
    batch = np.concatenate([batch, np.repeat(batch[:1], 8 - len(batch), 0)]) \
        if len(batch) < 8 else batch
    jver = jcand.verify_candidates_batch(
        japi.LossSpec('custom', fn=jfn), janz.unitary, batch, janz.cp_mask,
        learning_rate=0.01, num_iterations=400, target_loss=1e-6, anz=janz)
    jcz = [int(jver.cz[i]) for i in range(len(pros)) if jver.success[i]]
    return synth, results, jcz


def test_static_with_a_custom_loss_matches_jax_pipeline(ghz_runs):
    synth, results, jcz = ghz_runs
    assert synth.unitary_loss_func.kind == 'custom'
    decs = results.decompositions
    assert decs and jcz
    assert min(d.cz_count for d in decs) == min(jcz) == 2   # GHZ_n: n - 1 CZ
    for d in decs:
        # the host loss: the torch callable on the float64 unitary
        state = d.circuit.unitary()[:, 0]
        assert d.loss == pytest.approx(1 - abs(GHZ.conj() @ state) ** 2,
                                       abs=1e-9)
        assert d.loss <= 1e-6 + 4e-6


def test_refine_after_a_custom_loss_synthesis(ghz_runs):
    _, results, _ = ghz_runs
    d = min(results.decompositions, key=lambda d: d.cz_count)
    before = d.cz_count
    assert d.refine().startswith('Refined to')
    assert d.cz_count <= before and np.isfinite(d.loss)


def test_adaptive_with_a_custom_loss_runs_bucketed_and_not():
    tfn = LOSSES['relative phase'][1]
    for bucketed in (False, True):
        synth = tapi.Synthesize(connected_layer(N), unitary_loss_func=tfn,
                                device='cpu')
        options = tapi.AdaptiveOptions(
            min_num_cp_gates=1, max_num_cp_gates=3, max_evals=2,
            num_samples=4, num_gd_iterations=5,
            num_gd_iterations_at_verification=5, bucketed=bucketed)
        res = synth.adaptive(options, save_results=False, verbose=False)
        assert len(res.trials.results) == 2
        assert all(np.isfinite(t['min_raw_loss']) for t in res.trials.results)

"""Synthesize.adaptive of the port against the JAX package: the objective
with one r per restart, the bucketed stage on the same initial angles, the
whole search loop with its raw stage stubbed by the same deterministic
batches (seed chain, TPE, constant liar, graded score, scoreboard), a
small real run with resume, parallel trials as one sweep, and trials
carried over from the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import api as japi
from cpflow_tpu.optimize import candidates as jcand
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch import params
from cpflow_tpu_torch.ops.gates import cz_mat, u_ccz3
from cpflow_tpu_torch.optimize import candidates as tcand
from cpflow_tpu_torch.sim import batched as tbt
from cpflow_tpu_torch.topology import chain_layer

torch.set_num_threads(1)

N, K_MIN, K_MAX, S = 3, 2, 6, 8
LAYER = chain_layer(N)


def _actives(ks, num_angles):
    a = np.zeros((len(ks), num_angles), dtype=np.float32)
    for j, k in enumerate(ks):
        a[j, :3 * N + 7 * k] = 1
    return a


def _options(mod, **kw):
    base = dict(min_num_cp_gates=K_MIN, max_num_cp_gates=K_MAX,
                num_samples=S, num_gd_iterations=60)
    base.update(kw)
    return mod.AdaptiveOptions(**base)


def test_objective_with_r_per_restart_equals_per_trial_jax_objectives():
    synth = tapi.Synthesize(LAYER, target_unitary=u_ccz3, device='cpu')
    objective, anz = synth._bucketed_stage(_options(tapi))
    rs = [0.0002, 0.00055, 0.003]
    rng = np.random.default_rng(3)
    angles = (rng.uniform(0, 2 * np.pi, (len(rs) * S, anz.num_angles)) *
              np.repeat(_actives([2, 4, 6], anz.num_angles), S, 0)
              ).astype(np.float32)
    run = tbt.make_batched_regloss(
        N, 'cp', 'xyz', anz.placements, synth.unitary_loss_func,
        cp_mask=anz.cp_mask, regularization_func=synth.cp_regularization_func,
        r=torch.tensor(rs).repeat_interleave(S))
    reg, loss = run(torch.tensor(angles.T.copy()))
    lp = jax.jit(jbt.make_batched_loss_and_penalty(
        N, 'cp', 'xyz', anz.placements, japi.LossSpec('hst', target=u_ccz3),
        anz.cp_mask, japi.make_regularization_function(
            japi.RegularizationOptions)))
    jloss, jpen = (np.asarray(x) for x in lp(jnp.asarray(angles.T)))
    for j, r in enumerate(rs):
        cols = slice(j * S, (j + 1) * S)
        np.testing.assert_allclose(reg[cols].numpy(),
                                   jloss[cols] + np.float32(r) * jpen[cols],
                                   atol=1e-5)
    np.testing.assert_allclose(loss.numpy(), jloss, atol=1e-5)
    # the port's loss-and-penalty split agrees with the JAX package's
    tl, tp = objective.loss_and_penalty(torch.tensor(angles.T.copy()))
    np.testing.assert_allclose(tl.numpy(), jloss, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), jpen, atol=1e-5)


def test_bucketed_stage_matches_jax_at_60_steps():
    seeds, rs, ks = [11, 12], [0.00055, 0.002], [3, 6]
    jsynth = japi.Synthesize(LAYER, target_unitary=u_ccz3, mesh=None)
    fn, janz = jsynth._bucketed_stage(_options(japi), vmapped=True)
    actives = _actives(ks, janz.num_angles)
    inits = (np.random.default_rng(8).uniform(
        0, 2 * np.pi, (2, S, janz.num_angles)) * actives[:, None]
             ).astype(np.float32)
    jcz, jloss, jang = (np.asarray(x) for x in fn(
        jnp.asarray(seeds, dtype=jnp.uint32), jnp.asarray(rs, jnp.float32),
        jnp.asarray(actives), jnp.asarray(inits), jnp.float32(1.0)))

    synth = tapi.Synthesize(LAYER, target_unitary=u_ccz3, device='cpu')
    objective, anz = synth._bucketed_stage(_options(tapi))
    cz, loss, ang = tcand.run_bucketed_stage(
        objective, seeds, rs, actives, S, anz.cp_mask, learning_rate=0.1,
        num_iterations=60, device='cpu', params_in=inits)
    assert cz.shape == jcz.shape == (2, S) and ang.shape == jang.shape
    np.testing.assert_allclose(loss, jloss, atol=1e-4)
    np.testing.assert_array_equal(cz, jcz)
    # the frozen tail of the shorter template never moves
    assert not ang[0][:, 3 * N + 7 * ks[0]:].any()


def test_bucketed_stage_from_seeds_matches_jax_at_60_steps():
    """The bucketed stage drawing its own initial angles (params_in=None)
    against the JAX package's stage with resume 0: both draw each trial
    from PRNGKey(seed) (the port all trials in one draw), so the losses
    agree within 1e-4 and the CZ counts exactly."""
    seeds, rs, ks = [11, 3_000_000_007], [0.00055, 0.002], [3, 6]
    jsynth = japi.Synthesize(LAYER, target_unitary=u_ccz3, mesh=None)
    fn, janz = jsynth._bucketed_stage(_options(japi), vmapped=True)
    actives = _actives(ks, janz.num_angles)
    unused = np.zeros((2, S, janz.num_angles), np.float32)
    jcz, jloss, jang = (np.asarray(x) for x in fn(
        jnp.asarray(seeds, dtype=jnp.uint32), jnp.asarray(rs, jnp.float32),
        jnp.asarray(actives), jnp.asarray(unused), jnp.float32(0.0)))

    synth = tapi.Synthesize(LAYER, target_unitary=u_ccz3, device='cpu')
    objective, anz = synth._bucketed_stage(_options(tapi))
    cz, loss, ang = tcand.run_bucketed_stage(
        objective, seeds, rs, actives, S, anz.cp_mask, learning_rate=0.1,
        num_iterations=60, device='cpu')
    assert cz.shape == jcz.shape == (2, S) and ang.shape == jang.shape
    np.testing.assert_allclose(loss, jloss, atol=1e-4)
    np.testing.assert_array_equal(cz, jcz)
    assert not ang[0][:, 3 * N + 7 * ks[0]:].any()


# ---------------------------------------------------------------- stubbed loop

def _fake_batch(seed, k, angles_width=None):
    """A deterministic raw-stage outcome for (seed, k): every third seed's
    restarts all miss entry_loss (the graded empty-trial score)."""
    rng = np.random.default_rng([int(seed), int(k)])
    cz = rng.integers(0, 2 * k + 1, S).astype(np.int32)
    low = -2.5 if int(seed) % 3 == 0 else -7.0
    loss = (10.0 ** rng.uniform(low, -1.0, S)).astype(np.float32)
    angles = rng.uniform(0, 2 * np.pi, (S, 3 * N + 7 * k)).astype(np.float32)
    if angles_width is not None:
        angles = np.pad(angles, ((0, 0), (0, angles_width - angles.shape[1])))
    return cz, loss, angles


def _fake_verify(anz, angles_batch, options):
    a = np.asarray(angles_batch)
    return tcand.VerifiedBatch(
        success=a[:, 1] > np.pi, best_loss=np.zeros(len(a), np.float32),
        best_angles=a, cz=(a[:, 0] * 10).astype(np.int32) % 7,
        frozen=np.zeros(a.shape, bool))


def _stub(synth, mod, anz_max):
    def raw(options, *args):
        return mod.EvaluatedBatch(*_fake_batch(options.random_seed,
                                               options.num_cp_gates))

    def staged(options, vmapped=True):
        def run(seeds, rs, actives):
            ks = [int((a.sum() - 3 * N) // 7) for a in np.asarray(actives)]
            outs = [_fake_batch(s, k, anz_max.num_angles)
                    for s, k in zip(np.asarray(seeds).tolist(), ks)]
            return tuple(np.stack(x) for x in zip(*outs))
        return run, anz_max

    synth._raw_and_evaluate = raw
    synth._staged_run = staged
    synth._verify = _fake_verify


def _pair(loss=None, **kw):
    """The two packages' Synthesize on the 3q CCZ, raw stage stubbed; loss:
    optional (kind, LossSpec keywords) in place of the HS test."""
    opts = dict(max_evals=24, bucketed=False)
    opts.update(kw)
    jkw = tkw = dict(target_unitary=u_ccz3)
    if loss is not None:
        jkw = dict(unitary_loss_func=japi.LossSpec(loss[0], **loss[1]))
        tkw = dict(unitary_loss_func=tapi.LossSpec(loss[0], **loss[1]))
    jsynth = japi.Synthesize(LAYER, mesh=None, **jkw)
    janz = japi.Ansatz(N, 'cp', {'layers': [LAYER, K_MAX // 2], 'free': []})
    _stub(jsynth, jcand, janz)
    synth = tapi.Synthesize(LAYER, device='cpu', **tkw)
    tanz = tapi.Ansatz(N, 'cp', {'layers': [LAYER, K_MAX // 2], 'free': []})
    _stub(synth, tcand, tanz)
    return jsynth, synth, _options(japi, **opts), _options(tapi, **opts)


def _records(results):
    return [(r['random_seed'], r['num_cp_gates'], r['r'], r['loss'],
             r['cz_counts'], r['min_raw_loss']) for r in results.trials.results]


@pytest.mark.parametrize('parallel_trials', [1, 3])
def test_stubbed_search_gives_identical_trial_records(parallel_trials):
    jsynth, synth, jo, to = _pair(parallel_trials=parallel_trials)
    jres = jsynth.adaptive(jo, save_results=False, verbose=False)
    tres = synth.adaptive(to, save_results=False, verbose=False)
    assert len(tres.trials.results) == 24
    assert _records(tres) == _records(jres)
    assert tres.trials.vals == jres.trials.vals
    # graded empty trials and real ones both occur
    assert any(not r['cz_counts'] for r in tres.trials.results)
    assert any(r['cz_counts'] for r in tres.trials.results)
    assert [(d.cz_count, d._cp_data[0]) for d in tres.decompositions] == \
        [(d.cz_count, d._cp_data[0]) for d in jres.decompositions]
    assert tres.decompositions
    assert tres.decompositions[0]._adaptive_options is to
    assert tres.best_hyperparameters() == jres.best_hyperparameters()
    assert set(synth.stage_seconds) == {'sampling', 'tpe', 'verification',
                                        'decomposition'}


def test_stubbed_search_stops_at_the_target():
    jsynth, synth, jo, to = _pair(parallel_trials=3, target_num_cz_gates=5,
                                  stop_if_target_reached=True)
    jres = jsynth.adaptive(jo, save_results=False, verbose=False)
    tres = synth.adaptive(to, save_results=False, verbose=False)
    assert len(tres.trials.results) < 24
    assert _records(tres) == _records(jres)
    assert len(tres.decompositions) == len(jres.decompositions)


def test_stubbed_relative_phase_search_gives_identical_trial_records():
    """The relative-phase kind: modulo-diagonal loss on all three wires of
    the CCZ, two evals; the decompositions' host losses come from each
    package's own LossSpec.numpy."""
    loss = ('modulo_diagonal', dict(target=u_ccz3, num_qubits=N,
                                    wires=[0, 1, 2]))
    jsynth, synth, jo, to = _pair(loss=loss, max_evals=2)
    jres = jsynth.adaptive(jo, save_results=False, verbose=False)
    tres = synth.adaptive(to, save_results=False, verbose=False)
    assert len(tres.trials.results) == 2
    assert _records(tres) == _records(jres)
    assert tres.decompositions and \
        len(tres.decompositions) == len(jres.decompositions)
    for d, jd in zip(tres.decompositions, jres.decompositions):
        assert d.cz_count == jd.cz_count
        assert abs(d.loss - float(jd.loss)) <= 1e-10


# ------------------------------------------------------------------- real runs

CZ_LAYER = [[0, 1]]


def _mini(max_evals):
    return tapi.AdaptiveOptions(min_num_cp_gates=1, max_num_cp_gates=3,
                                max_evals=max_evals, num_samples=8,
                                num_gd_iterations=300, rotation_gates='xz',
                                num_gd_iterations_at_verification=1000)


def test_adaptive_mini_run_records_resumes_and_ranks(tmp_path):
    synth = tapi.Synthesize(CZ_LAYER, target_unitary=cz_mat, label='cz_adapt',
                            device='cpu')
    path = str(tmp_path / 'adapt')
    results = synth.adaptive(_mini(3), save_to=path, verbose=False)
    assert len(results.trials.results) == 3
    for rec in results.trials.results:
        assert 'loss' in rec and 'num_cp_gates' in rec and 'r' in rec
        # keep_logs=False: no attachments, raw prospectives dropped
        assert 'attachments' not in rec
        assert 'prospective_decompositions' not in rec
    assert results.decompositions
    assert min(d.cz_count for d in results.decompositions) == 1
    # resume: asking for 4 evals continues from the saved 3
    results2 = synth.adaptive(_mini(4), save_to=path, verbose=False)
    assert len(results2.trials.results) == 4
    assert _records(results2)[:3] == _records(results)
    hp = results2.best_hyperparameters()
    assert len(hp) == 4 and len(hp[0]) == 2
    assert tapi.Results.load(path).trials.vals == results2.trials.vals


def test_parallel_trials_equal_sequential_stage_calls():
    synth = tapi.Synthesize(LAYER, target_unitary=u_ccz3, device='cpu')
    options = _options(tapi, num_gd_iterations=30)
    run, anz = synth._staged_run(options)
    seeds, rs = [3453687069, 5], [0.0004, 0.002]
    actives = _actives([2, 5], anz.num_angles)
    together = run(seeds, rs, actives)
    for j in range(2):
        alone = run(seeds[j:j + 1], rs[j:j + 1], actives[j:j + 1])
        np.testing.assert_array_equal(alone[0][0], together[0][j])
        # float32 rounding only: another batch width reorders the sums
        np.testing.assert_allclose(alone[1][0], together[1][j], atol=1e-5)
        np.testing.assert_allclose(alone[2][0], together[2][j], atol=1e-4)


def test_trials_from_jax_round_trip_and_resume(tmp_path):
    never = lambda anz, a, o: _fake_verify(anz, a, o)._replace(
        success=np.zeros(len(a), bool))
    jsynth, synth, jo, to = _pair(max_evals=3, keep_logs=True)
    jsynth._verify = synth._verify = never
    jpath = str(tmp_path / 'jax')
    jres = jsynth.adaptive(jo, save_to=jpath, verbose=False)
    carried = params.trials_from_jax(jres)
    assert carried.vals == jres.trials.vals
    for a, b in zip(carried.results, jres.trials.results):
        assert set(b) - set(a) == {'attachments'}
        assert [c for c, _ in a['prospective_decompositions']] == \
            [c for c, _ in b['prospective_decompositions']]
        for (_, x), (_, y) in zip(a['prospective_decompositions'],
                                  b['prospective_decompositions']):
            np.testing.assert_array_equal(x, y)
    assert params.trials_from_jax(jres.trials).vals == carried.vals

    # the JAX package's search resumes in the port as it does in its own
    tpath = str(tmp_path / 'port')
    tapi.Results(synth.unitary_loss_func, LAYER, trials=carried,
                 save_to=tpath).save()
    jo5 = _options(japi, max_evals=5, keep_logs=True)
    to5 = _options(tapi, max_evals=5, keep_logs=True)
    jres5 = jsynth.adaptive(jo5, save_to=jpath, verbose=False)
    tres5 = synth.adaptive(to5, save_to=tpath, verbose=False)
    assert _records(tres5) == _records(jres5)
    # keep_logs attachments are the port's own pickles
    att = tres5.trials.results[-1]['attachments']
    assert set(att) == {'prospective_decompositions', 'static_options',
                        'unitary_loss_func'}

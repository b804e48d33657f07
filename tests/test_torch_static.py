"""The static slice as a whole: Synthesize(..., device='cpu').static of the
port against the JAX package's pipeline composed from its public pieces
(minimize_fused -> evaluate_raw_batch -> filter_prospective ->
verify_candidates_batch -> Decomposition._from_cp_circuit), on the 3q chain
CCZ with k=12 and 16 restarts, both fed the same numpy initial angles.
Then the same verified angles refined by both packages (Decomposition.refine:
equal type, CZ count, T count, T depth, loss within 1e-9), and the rerun
recipe through Decomposition._decomposer."""

import pickle

import jax
import numpy as np
import pytest
import torch

from cpflow_tpu import api as japi
from cpflow_tpu.optimize import candidates as jcand
from cpflow_tpu.optimize import engine as jengine
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch import params
from cpflow_tpu_torch.optimize import candidates as tcand
from cpflow_tpu_torch.ops.gates import u_ccz3
from cpflow_tpu_torch.topology import chain_layer, fill_layers

torch.set_num_threads(1)

N, K, SAMPLES = 3, 12, 16
# seed 2 gives candidates that pass the entry thresholds after 1000 steps
INITS = np.random.default_rng(2).uniform(
    0, 2 * np.pi, (SAMPLES, 3 * N + 7 * K)).astype(np.float32)


def _options(iters, verify_iters=1000):
    return dict(num_cp_gates=K, num_samples=SAMPLES, accepted_num_cz_gates=8,
                num_gd_iterations=iters,
                num_gd_iterations_at_verification=verify_iters)


def _jax_raw(iters):
    janz = japi.Ansatz(N, 'cp', fill_layers(chain_layer(N), K))
    spec = japi.LossSpec('hst', target=u_ccz3)
    f = jbt.make_batched_regloss(
        N, 'cp', 'xyz', janz.placements, spec, cp_mask=janz.cp_mask,
        regularization_func=japi.make_regularization_function(
            japi.RegularizationOptions), r=0.00055, reversible=True)
    raw = jengine.minimize_fused(f, INITS, learning_rate=0.1,
                                 num_iterations=iters)
    return janz, spec, jcand.evaluate_raw_batch(raw, janz.cp_mask, 0.2)


def test_sampling_stage_matches_jax_at_60_steps():
    synth = tapi.Synthesize(chain_layer(N), target_unitary=u_ccz3,
                            device='cpu')
    options = tapi.StaticOptions(**_options(60))
    ev = synth._raw_and_evaluate(options, INITS)
    _, _, jev = _jax_raw(60)
    # per-restart losses within 1e-4 (the sweep tolerance at T = 60)
    np.testing.assert_allclose(ev.loss, jev.loss, atol=1e-4)
    assert ev.angles.shape == jev.angles.shape
    # the [initial, best] route gives the same evaluation
    raw = synth._generate_raw(options, INITS)
    ev2 = tcand.evaluate_raw_batch(raw, synth._ansatz(options).cp_mask)
    np.testing.assert_array_equal(ev2.cz, ev.cz)
    np.testing.assert_array_equal(ev2.loss, ev.loss)


def test_static_from_random_seed_alone_draws_the_jax_batch(monkeypatch):
    """Synthesize.static given only random_seed (the JAX package's default
    StaticOptions seed): the port draws the JAX package's batch bit for bit
    (ops/prng.py), and its sampling stage's per-restart losses are within
    1e-4 of the JAX package's sampling stage from the same seed."""
    joptions = japi.StaticOptions(**_options(60))
    seed = joptions.random_seed
    jsynth = japi.Synthesize(chain_layer(N), target_unitary=u_ccz3, mesh=None)
    jev = jsynth._raw_and_evaluate(joptions)
    janz = jsynth._ansatz(joptions)
    jinits = np.asarray(jcand.generate_initial_angles_batch(
        jax.random.PRNGKey(seed), janz.num_angles, janz.cp_mask,
        batch_size=SAMPLES))

    drawn, stages = [], []

    def spy(fn, into):
        def call(*args, **kwargs):
            into.append(fn(*args, **kwargs))
            return into[-1]
        return call

    monkeypatch.setattr(tcand, 'generate_initial_angles_batch',
                        spy(tcand.generate_initial_angles_batch, drawn))
    monkeypatch.setattr(tcand, 'run_raw_stage_fused',
                        spy(tcand.run_raw_stage_fused, stages))
    synth = tapi.Synthesize(chain_layer(N), target_unitary=u_ccz3,
                            device='cpu')
    synth.static(tapi.StaticOptions(**_options(60), random_seed=seed),
                 save_results=False, verbose=False)
    assert len(drawn) == 1 and len(stages) == 1
    np.testing.assert_array_equal(drawn[0].numpy(), jinits)
    np.testing.assert_allclose(stages[0].loss, jev.loss, atol=1e-4)


@pytest.fixture(scope='module')
def static_run(tmp_path_factory):
    """(synth, options, results, path) of the port's static run on the CPU,
    saved to disk."""
    path = str(tmp_path_factory.mktemp('static') / 'ccz')
    options = tapi.StaticOptions(**_options(1000))
    synth = tapi.Synthesize(chain_layer(N), target_unitary=u_ccz3,
                            device='cpu', label='ccz')
    results = synth.static(options, save_to=path, verbose=False,
                           initial_angles_array=INITS)
    return synth, options, results, path


def test_static_outcome_matches_jax_pipeline(static_run):
    synth, options, results, path = static_run
    decs = results.decompositions
    assert decs, 'the port verified no decomposition'
    assert set(synth.stage_seconds) == {'sampling', 'verification',
                                        'decomposition'}

    # the JAX package's pipeline on the same initial angles
    janz, spec, jev = _jax_raw(1000)
    pros = jcand.filter_prospective(jev, 8, options.entry_loss)
    assert len(pros)
    batch = jev.angles[pros]
    batch = np.concatenate([batch, np.repeat(batch[:1], 8 - len(batch), 0)]) \
        if len(batch) < 8 else batch
    jver = jcand.verify_candidates_batch(
        spec, janz.unitary, batch, janz.cp_mask, learning_rate=0.01,
        num_iterations=1000, target_loss=options.target_loss, anz=janz)
    jdecs = [japi.Decomposition._from_cp_circuit(spec, janz,
                                                 jver.best_angles[i])
             for i in range(len(pros)) if jver.success[i]]
    assert jdecs
    assert min(d.cz_count for d in decs) == min(d.cz_count for d in jdecs) \
        == 8

    for d in decs:
        # the device loss is float32: near |tr(T^dag U)| = d its rounding
        # is about 1e-6, so the float64 host loss may exceed target_loss
        # by that much
        host = spec.numpy(d.circuit.unitary())
        assert host <= options.target_loss + 4e-6
        assert d.loss == pytest.approx(host, abs=1e-12)
        # the same verified angles through the JAX package's Decomposition
        jd = japi.Decomposition._from_cp_circuit(spec, janz, d._cp_data[1])
        assert d.cz_count == jd.cz_count and d.cz_depth == jd.cz_depth
        np.testing.assert_allclose(d.unitary, jd.unitary, atol=1e-6)

    loaded = tapi.Results.load(path)
    assert [d.cz_count for d in loaded.decompositions] == \
        [d.cz_count for d in decs]


def test_rerun_through_the_decomposer_gives_the_same_cz_counts(static_run):
    synth, options, results, path = static_run
    d = results.decompositions[0]
    assert d._decomposer is synth and d._static_options is options
    assert tapi.Decomposition(d.unitary_loss_func,
                              d.circuit)._decomposer is None
    # the tutorial's reproducibility recipe
    again = d._decomposer.static(d._static_options, save_results=False,
                                 verbose=False, initial_angles_array=INITS)
    assert [x.cz_count for x in again.decompositions] == \
        [x.cz_count for x in results.decompositions]
    np.testing.assert_array_equal(again.decompositions[0]._cp_data[1],
                                  d._cp_data[1])
    # a Results holding such decompositions pickles and loads, the
    # decomposer with it (one object, shared) and without its stage cache
    synth._stage_cache = {'key': lambda: None}   # what a bucketed run leaves
    loaded = pickle.loads(pickle.dumps(results))
    del synth._stage_cache
    decomposers = {id(x._decomposer) for x in loaded.decompositions}
    assert len(decomposers) == 1
    back = loaded.decompositions[0]._decomposer
    assert isinstance(back, tapi.Synthesize) and back.layer == synth.layer
    assert not hasattr(back, '_stage_cache')
    assert tapi.Results.load(path).decompositions[0]._decomposer.label == 'ccz'


def test_refine_of_the_verified_angles_matches_jax(static_run):
    """The whole path: the port's verified angles carried to the JAX
    package and both Decompositions refined, with the defaults (on this
    template's free angles rationalization at angle_threshold=0.01 fails
    its guard in both, so both stay 'Approximate') and, the decomposition
    with the least loss, at angle_threshold=1e-3, which reaches
    'Clifford+T' through grid synthesis of the generic angles."""
    _, _, results, _ = static_run
    janz = japi.Ansatz(N, 'cp', fill_layers(chain_layer(N), K))
    spec = japi.LossSpec('hst', target=u_ccz3)
    decs = sorted(results.decompositions, key=lambda d: d.loss)[:3]
    types = []
    for d, kw in [(d, {}) for d in decs] + [(decs[0],
                                            {'angle_threshold': 1e-3})]:
        anz = tapi.Ansatz(N, 'cp', d._cp_data[0])
        # the verified angles as float32, as params carries them
        angles = params.angles_to_jax(
            params.angles_from_jax(d._cp_data[1], anz, 'cpu'))[0]
        td = tapi.Decomposition._from_cp_circuit(d.unitary_loss_func, anz,
                                                 angles)
        jd = japi.Decomposition._from_cp_circuit(spec, janz, angles)
        assert td.t_count is None and td.t_depth is None
        assert td.refine(**kw) == jd.refine(**kw) == f'Refined to {td.type}'
        assert td.type == jd.type and td.cz_count == jd.cz_count == 8
        assert td.cz_depth == jd.cz_depth
        assert td.t_count == jd.t_count and td.t_depth == jd.t_depth
        assert abs(td.loss - jd.loss) <= 1e-9
        assert len(td.circuit.instructions) == len(jd.circuit.instructions)
        np.testing.assert_allclose(td.unitary, jd.unitary, atol=1e-9)
        assert repr(td).split('| loss')[0] == repr(jd).split('| loss')[0]
        assert repr(td).split('| CZ')[1:] == repr(jd).split('| CZ')[1:]
        types.append(td.type)
    assert types[-1] == 'Clifford+T' and td.t_count > 0 and 'T depth' in \
        repr(td)


def test_static_entry_points_refuse_what_is_not_ported():
    """Every method and a custom loss now run (they raised before the
    engine was ported); what is left to refuse is an unknown method and a
    StaticOptions without its required arguments."""
    synth = tapi.Synthesize(chain_layer(N), target_unitary=u_ccz3,
                            device='cpu')
    opts = dict(_options(3, 3), accepted_num_cz_gates=100, entry_loss=10.0)
    res = synth.static(tapi.StaticOptions(method='natural adam', **opts),
                       save_results=False, verbose=False,
                       initial_angles_array=INITS[:4])
    assert 'sampling' in synth.stage_seconds
    assert all(np.isfinite(d.loss) for d in res.decompositions)
    # a custom loss, a torch callable of one unitary, enters the sweep
    target = torch.as_tensor(u_ccz3)
    custom = tapi.Synthesize(
        chain_layer(N), device='cpu',
        unitary_loss_func=lambda u: 1 - torch.abs(
            (u * target.to(u.dtype).conj()).sum()) ** 2 / 64)
    hst = synth._raw_and_evaluate(tapi.StaticOptions(**opts), INITS[:4])
    ev = custom._raw_and_evaluate(tapi.StaticOptions(**opts), INITS[:4])
    np.testing.assert_allclose(ev.loss, hst.loss, atol=1e-6)
    res = custom.static(tapi.StaticOptions(**opts), save_results=False,
                        verbose=False, initial_angles_array=INITS[:4])
    assert all(np.isfinite(d.loss) for d in res.decompositions)
    with pytest.raises(ValueError, match='not supported'):
        synth.static(tapi.StaticOptions(method='newton', **opts),
                     save_results=False, verbose=False,
                     initial_angles_array=INITS[:4])
    with pytest.raises(TypeError):
        tapi.StaticOptions(num_cp_gates=4)

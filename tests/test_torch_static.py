"""The static slice as a whole: Synthesize(..., device='cpu').static of the
port against the JAX package's pipeline composed from its public pieces
(minimize_fused -> evaluate_raw_batch -> filter_prospective ->
verify_candidates_batch -> Decomposition._from_cp_circuit), on the 3q chain
CCZ with k=12 and 16 restarts, both fed the same numpy initial angles."""

import numpy as np
import pytest
import torch

from cpflow_tpu import api as japi
from cpflow_tpu.optimize import candidates as jcand
from cpflow_tpu.optimize import engine as jengine
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch import api as tapi
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


def test_static_outcome_matches_jax_pipeline(tmp_path):
    options = tapi.StaticOptions(**_options(1000))
    synth = tapi.Synthesize(chain_layer(N), target_unitary=u_ccz3,
                            device='cpu', label='ccz')
    results = synth.static(options, save_to=str(tmp_path / 'ccz'),
                           verbose=False, initial_angles_array=INITS)
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

    loaded = tapi.Results.load(str(tmp_path / 'ccz'))
    assert [d.cz_count for d in loaded.decompositions] == \
        [d.cz_count for d in decs]


def test_static_entry_points_refuse_what_is_not_ported():
    synth = tapi.Synthesize(chain_layer(N), target_unitary=u_ccz3,
                            device='cpu')
    with pytest.raises(NotImplementedError, match='ROADMAP A.10'):
        synth.static(tapi.StaticOptions(method='natural adam', **_options(5)),
                     save_results=False, verbose=False)
    ghz = np.zeros(8, dtype=np.complex64)
    ghz[0] = ghz[-1] = 2 ** -0.5
    state = tapi.Synthesize(chain_layer(N), target_state=ghz, device='cpu')
    with pytest.raises(NotImplementedError, match='ROADMAP A.4'):
        state.static(tapi.StaticOptions(**_options(5)), save_results=False,
                     verbose=False)
    with pytest.raises(TypeError):
        tapi.StaticOptions(num_cp_gates=4)

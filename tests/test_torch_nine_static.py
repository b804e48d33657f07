"""Synthesize.static at 9 qubits, where the port's sweep takes the column
tiles on the card, through both packages on the CPU: the 9q CX ladder on
the chain at k = 8 from the same warm rows, the plain version on the
port's side. A file of its own beside tests/test_torch_nine_qubits.py (at
9 qubits each package's static run takes some 30 s on one core here)."""

import jax.numpy as jnp
import numpy as np
import torch

from cpflow_tpu import api as japi
from cpflow_tpu.optimize import candidates as jcand
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch.sim import batched as tbt
from cpflow_tpu_torch.topology import chain_layer, fill_layers

import chip_smoke

torch.set_num_threads(1)

LADDER9 = dict(num_cp_gates=8, accepted_num_cz_gates=8, num_gd_iterations=10,
               learning_rate=0.003, num_gd_iterations_at_verification=150,
               random_seed=0)


def test_tiny_static_ladder_at_nine_qubits_matches_jax(monkeypatch):
    """Synthesize.static for the 9q CX ladder on the chain at k = 8 in both
    packages from the same warm rows (chip_smoke.build_warm_batch around
    the exact 8-CZ embedding, rows at noise 0.003 and 0.01; the JAX
    package's seeded draw replaced by them), 10 sampling steps at lr 0.003:
    the sampling stage's losses within 1e-5 and its CZ counts equal, then
    the same decompositions (8 CZ, gates in order). Verification stops at
    the first step whose float32 loss is at most 1e-6, which two packages'
    float32 Adam reach at different angles, so their losses are not held to
    each other (as tests/test_torch_state_split.py's GHZ-14); each of the
    port's decompositions has a float32 loss of at most 1e-6 at its angles
    and a float64 host loss within 1e-6 of it (the float32 loss's rounding
    at 9 qubits: host losses of 1.35e-6 and 1.45e-6 here)."""
    n = 9
    placements, exact = chip_smoke.ladder_program(n)
    anz = tapi.Ansatz(n, 'cp', fill_layers(chain_layer(n), n - 1), 'xyz')
    assert placements == [list(p) for p in
                          anz.placements['layers'][0]][:n - 1]
    warm, sigma = chip_smoke.build_warm_batch(
        exact.astype(np.float32), np.asarray(anz.cp_mask, dtype=np.float64),
        8, 0)
    rows = warm[1:3]
    assert list(sigma[1:3]) == [0.003, 0.01]
    options = dict(LADDER9, num_samples=len(rows))
    ladder = chip_smoke.cx_ladder(n)
    monkeypatch.setattr(
        jcand, 'generate_initial_angles_batch',
        lambda key, num_angles, cp_mask, cp_dist='uniform', batch_size=1:
        jnp.asarray(rows))
    jsynth = japi.Synthesize(chain_layer(n), target_unitary=ladder,
                             mesh=None)
    tsynth = tapi.Synthesize(chain_layer(n), target_unitary=ladder,
                             device='cpu')
    evs = []  # each package's sampling stage, as its static ran it
    for synth in (jsynth, tsynth):
        stage = synth._raw_and_evaluate
        synth._raw_and_evaluate = \
            lambda *a, stage=stage: evs.append(stage(*a)) or evs[-1]
    jres = jsynth.static(japi.StaticOptions(**options), save_results=False,
                         verbose=False)
    tres = tsynth.static(tapi.StaticOptions(**options), save_results=False,
                         verbose=False, initial_angles_array=rows)
    (jev, tev) = evs
    np.testing.assert_allclose(np.asarray(tev.loss), np.asarray(jev.loss),
                               rtol=0, atol=1e-5)
    assert list(np.asarray(tev.cz)) == list(np.asarray(jev.cz))
    jd, td = jres.decompositions, tres.decompositions
    print(f'9q ladder static from {len(rows)} warm rows: JAX package '
          f'{[(d.cz_count, d.loss) for d in jd]}, port '
          f'{[(d.cz_count, d.loss) for d in td]}')
    assert len(jd) == len(td) == len(rows)
    objective = tbt.make_batched_regloss(
        n, 'cp', 'xyz', anz.placements, tsynth.unitary_loss_func)
    for a, b in zip(jd, td):
        assert a.cz_count == b.cz_count == n - 1
        assert [(g.name, tuple(g.qubits)) for g in a.circuit.instructions] \
            == [(g.name, tuple(g.qubits)) for g in b.circuit.instructions]
        with torch.no_grad():
            _, loss32 = objective(torch.tensor(
                b._cp_data[1], dtype=torch.float32)[:, None])
        assert float(loss32[0]) <= 1e-6
        assert abs(b.loss - float(loss32[0])) <= 1e-6
        assert abs(chip_smoke.hst64(b.circuit.unitary(), ladder) - b.loss) \
            <= 1e-12

"""The port runs where JAX, optax and dill are not installed (as on the
machine with the card): imported in a fresh interpreter with those modules
blocked, it runs a tiny static, adaptive, state-preparation and
relative-phase (modulo-diagonal) synthesis and a fixed-'cz' sweep on the
CPU, then every host module of circuits/: a QASM round trip, a refine to
Clifford+T, an embedding into the CP ansatz, a grid synthesis and an exact
unitary."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r'''
import sys
for name in ('jax', 'jaxlib', 'optax', 'dill'):
    sys.modules[name] = None  # any import of them now raises ImportError
import numpy as np
import cpflow_tpu_torch
from cpflow_tpu_torch import api, params
from cpflow_tpu_torch.kernels import sweep
from cpflow_tpu_torch.ops.gates import u_ccz3
from cpflow_tpu_torch.topology import chain_layer
synth = api.Synthesize(chain_layer(3), target_unitary=u_ccz3, device='cpu')
opts = api.StaticOptions(num_cp_gates=3, num_samples=4, num_gd_iterations=5,
                         accepted_num_cz_gates=100, entry_loss=1.0,
                         num_gd_iterations_at_verification=5)
res = synth.static(opts, save_results=False, verbose=False)
assert set(synth.stage_seconds) == {'sampling', 'verification',
                                    'decomposition'}
ada = api.AdaptiveOptions(min_num_cp_gates=1, max_num_cp_gates=3,
                          max_evals=3, num_samples=4, num_gd_iterations=5,
                          num_gd_iterations_at_verification=5,
                          bucketed=True, parallel_trials=2, keep_logs=True)
res = synth.adaptive(ada, save_results=False, verbose=False)
assert len(res.trials.results) == 3
ghz = np.zeros(8, dtype=np.complex64)
ghz[0] = ghz[-1] = 2 ** -0.5
state = api.Synthesize(chain_layer(3), target_state=ghz, device='cpu')
state.static(api.StaticOptions(num_cp_gates=2, num_samples=4,
                               num_gd_iterations=5, accepted_num_cz_gates=9,
                               entry_loss=1.0,
                               num_gd_iterations_at_verification=5),
             save_results=False, verbose=False)
assert set(state.stage_seconds) == {'sampling', 'verification',
                                    'decomposition'}
from cpflow_tpu_torch.ops.gates import u_toff3
rel = api.Synthesize(chain_layer(3), device='cpu', unitary_loss_func=api.LossSpec(
    'modulo_diagonal', target=u_toff3, num_qubits=3, wires=[0, 1, 2]))
rel.static(api.StaticOptions(num_cp_gates=2, num_samples=4,
                             num_gd_iterations=5, accepted_num_cz_gates=9,
                             entry_loss=10.0, rotation_gates='xz',
                             num_gd_iterations_at_verification=5),
           save_results=False, verbose=False)
assert set(rel.stage_seconds) == {'sampling', 'verification', 'decomposition'}
import torch
from cpflow_tpu_torch.sim import adjoint
g = adjoint.block_vjp('cp', 'xz', torch.zeros(5, 2, dtype=torch.float64),
                      torch.ones(4, 4, 2, dtype=torch.complex128))
assert g.shape == (5, 2)
from cpflow_tpu_torch.optimize import engine
from cpflow_tpu_torch.sim.batched import make_batched_regloss
cz = api.Ansatz(3, 'cz', {'free': [[0, 1], [1, 2]]}, 'xz')
raw = engine.minimize_fused(make_batched_regloss(
    3, 'cz', 'xz', cz.placements, api.LossSpec('disc', target=u_ccz3)),
    torch.zeros(2, cz.num_angles), num_iterations=3)
assert bool(torch.isfinite(raw.loss).all())
anz = synth._ansatz(opts)
a = np.random.default_rng(0).uniform(0, 6, (2, anz.num_angles))
assert np.allclose(params.angles_to_jax(params.angles_from_jax(a, anz,
                                                               'cpu')), a)
import math
from cpflow_tpu_torch.circuits import (clifford_t, euler, exact_unitary,
                                       gridsynth, ir, passes, refine, rings,
                                       to_ansatz)
qc = ir.parse_qasm(ir.Circuit(2).rz(math.pi / 4 + 2e-4, 0).cz(0, 1)
                   .rx(-math.pi / 2 + 1e-4, 1).rz(0.7, 1).to_qasm())
d = api.Decomposition(api.LossSpec('hst', target=qc.unitary()), qc)
assert d.refine() == 'Refined to Clifford+T' and d.t_count > 1, d
assert d._decomposer is None
placements, emb = to_ansatz.circuit_to_ansatz(qc)
back = api.Ansatz(2, 'cp', {'free': placements}).circuit(emb)
assert passes.hst_distance(back.unitary(), qc.unitary()) < 1e-12
word = gridsynth.gridsynth_rz(0.7, 1e-3)
assert clifford_t.generic_rotation_word('rz', 0.7, 1e-3) == word
assert rings.OMEGA ** 8 == rings.ZOmega(1)
exact = exact_unitary.exact_unitary(ir.Circuit(1).h(0).t(0).h(0), q=4)
np.testing.assert_allclose(exact.to_complex(),
                           euler.rx_matrix(math.pi / 4) * np.exp(1j * math.pi / 8),
                           atol=1e-12)
assert params.circuit_from_jax(params.circuit_rows(qc), 2).to_qasm() == \
    qc.to_qasm()
# the differentiable objective, custom losses and the rest of the engine
from cpflow_tpu_torch import config, optimize, topology
from cpflow_tpu_torch.kernels import build, unitary
from cpflow_tpu_torch.ops import losses, trig
from cpflow_tpu_torch.optimize import candidates
from cpflow_tpu_torch.sim import circuit_exec
assert build.digest() and unitary.FORWARD_LAUNCHES == 0
u = unitary.build_unitary(3, 'cp', 'xyz', anz.placements,
                          torch.zeros(anz.num_angles, 2))
assert u.shape == (2, 2, 2, 8, 2)
fn = lambda m: 1 - torch.abs((m * torch.as_tensor(u_ccz3).conj()).sum()) ** 2 / 64
custom = api.Synthesize(chain_layer(3), unitary_loss_func=fn, device='cpu')
custom.static(opts, save_results=False, verbose=False)
custom.adaptive(ada, save_results=False, verbose=False)
for method in ('natural adam', 'natural gd', 'hessian', 'angle by angle'):
    synth.static(api.StaticOptions(num_cp_gates=2, num_samples=2,
                                   num_gd_iterations=2, method=method,
                                   accepted_num_cz_gates=100, entry_loss=9.0,
                                   num_gd_iterations_at_verification=2),
                 save_results=False, verbose=False)
learned = anz.learn(u_ccz3, num_repeats=2, num_iterations=3, device='cpu')
assert len(learned) == 2 and learned[0]['params'].shape == (3, anz.num_angles)
hist, loss = optimize.mynimize(lambda a: (a ** 2).sum(), 3, num_iterations=4,
                               device='cpu')
assert hist.shape == (4, 3)
raw = engine.minimize_fused(make_batched_regloss(
    3, 'cz', 'xz', cz.placements, api.LossSpec('disc', target=u_ccz3)),
    np.zeros((2, cz.num_angles)), num_iterations=3, keep_history=True,
    device='cpu')
assert raw.params.shape == (2, 3, cz.num_angles)
assert trig.min_angle(lambda x: torch.cos(torch.as_tensor(x))) > 3
assert losses.fubini_study(anz.unitary, torch.zeros(anz.num_angles)).shape \
    == (anz.num_angles,) * 2
assert len(topology.random_placements(4, 3)) == 3
u_func, a0, _ = circuit_exec.circuit_to_torch_unitary(qc)
assert refine.lasso_angles(
    lambda a: losses.cost_HST(u_func(a), qc.unitary()), np.array(a0),
    eps=0.0, device='cpu').shape == (len(a0),)
config.set_precision(False)
loaded = [m for m in ('jax', 'optax', 'dill') if sys.modules.get(m)]
assert not loaded, loaded
print('ok')
'''


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('ok')


def test_no_module_of_the_port_imports_jax():
    pattern = re.compile(
        r'^\s*(import|from)\s+(jax|optax|dill|cpflow_tpu)([.\s]|$)', re.M)
    files = sorted((ROOT / 'cpflow_tpu_torch').rglob('*.py')) + \
        [ROOT / 'chip_smoke.py', ROOT / 'tests' / 'test_torch_kernel.py']
    assert len(files) > 10
    for path in files:
        assert not pattern.search(path.read_text()), path

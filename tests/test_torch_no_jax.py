"""The port runs where JAX, optax and dill are not installed (as on the
machine with the card): imported in a fresh interpreter with those modules
and the JAX package (cpflow_tpu and its shim cpflow) blocked, it imports
every module of cpflow_torch (the port's twin of cpflow), draws a golden
batch of initial angles from its seed (ops/prng.py), and it runs a
tiny static, adaptive, state-preparation and relative-phase
(modulo-diagonal) synthesis and a fixed-'cz' sweep on the CPU, then every
host module of circuits/: a QASM round trip, a refine to Clifford+T, an
embedding into the CP ansatz, a grid synthesis and an exact unitary; then
the CLI (info and a synthesis), the restart split's dry run,
utils.profiling, migrate and circuits.interop."""

import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r'''
import sys
for name in ('jax', 'jaxlib', 'optax', 'dill', 'cpflow_tpu', 'cpflow'):
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
# an 18-qubit state, past the fused kernel's row tiles (on a card the
# unitary kernels' global row tiles take it): the plain objective and its
# gradient, and the route a card would take
from cpflow_tpu_torch.topology import fill_layers
wide = np.zeros(2 ** 18, dtype=np.complex64)
wide[0] = wide[-1] = 2 ** -0.5
obj18 = make_batched_regloss(18, 'cp', 'xyz', fill_layers(chain_layer(18), 2),
                             api.LossSpec('state', target=wide))
a18 = torch.zeros(3 * 18 + 14, 2, requires_grad=True)
reg18, loss18 = obj18(a18)
(grad18,) = torch.autograd.grad(reg18.sum(), a18)
assert loss18.shape == (2,) and bool(torch.isfinite(grad18).all())
assert sweep.route(obj18, 'cpu') == 'plain'
assert sweep.route(obj18, 'cuda') == 'unitary'
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
# the CLI, the restart split, profiling, migration and the qiskit bridge
import contextlib, io, json, pickle, tempfile
from cpflow_tpu_torch import __main__ as cli, migrate
from cpflow_tpu_torch.circuits import interop
from cpflow_tpu_torch.parallel import dryrun, mesh
from cpflow_tpu_torch.utils import profiling
out = io.StringIO()
with contextlib.redirect_stdout(out):
    cli.main(['info'])
    cli.main(['synthesize', '--target', 'cz', '--static', '--num-cp-gates',
              '1', '--num-samples', '4', '--accepted-cz', '9', '--no-save',
              '--device', 'cpu'])
lines = out.getvalue().splitlines()
info, found = json.loads(lines[0]), json.loads(lines[-1])
assert info['kernel_source_digest'] == build.digest()
assert found['label'] == 'cz'
ran = dryrun.dryrun_multichip(2, device='cpu')
assert ran['mesh'] == ['cpu', 'cpu'] and ran['batch'] == 4
forward, (example,) = dryrun.entry(device='cpu')
assert forward(example).shape == (64,)
assert mesh.padded_batch_size(5, mesh.restart_mesh(['cpu'] * 2)) == 6
assert profiling.sweep_work(3, 12)['needed'] == 110841
with tempfile.TemporaryDirectory() as tmp:
    with profiling.trace(tmp):
        torch.ones(3).sum()
try:
    interop.to_qiskit(qc)
except ImportError:
    pass
with tempfile.NamedTemporaryFile(suffix='.pkl') as f:
    f.write(b'\x80\x04\x8c\x0bcpflow.main\x8c\x07Results\x93.')
    f.flush()
    assert migrate.load_reference_pickle(f.name) is api.Results
# the reference's import surface, and one draw of the JAX package's tree
import importlib
for name in ('', '.circuit_assembly', '.cp_utils', '.exact_decompositions',
             '.gates', '.main', '.matrix_utils', '.optimization', '.penalty',
             '.topology', '.trigonometric_utils'):
    importlib.import_module('cpflow_torch' + name)
from cpflow_torch.cp_utils import random_cp_angles
from cpflow_tpu_torch.ops import prng
golden = np.load('tests/golden/reference_goldens.npz')
assert np.array_equal(random_cp_angles(
    37, np.zeros(37), key=prng.PRNGKey(7, 'cpu')).numpy(),
    golden['3q_chain_cp_xyz_k4/angles'])
loaded = [m for m in ('jax', 'optax', 'dill', 'cpflow_tpu', 'cpflow')
          if sys.modules.get(m)]
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
        r'^\s*(import|from)\s+(jax|optax|dill|cpflow_tpu|cpflow)([.\s]|$)',
        re.M)
    files = sorted((ROOT / 'cpflow_tpu_torch').rglob('*.py')) + \
        sorted((ROOT / 'cpflow_torch').rglob('*.py')) + \
        [ROOT / 'chip_smoke.py', ROOT / 'tests' / 'test_torch_kernel.py',
         ROOT / 'tests' / 'test_torch_golden_reference.py']
    assert len(files) > 21
    for path in files:
        assert not pattern.search(path.read_text()), path


DOUBLE_SCRIPT = r'''
import sys
for name in ('jax', 'jaxlib', 'optax', 'dill', 'cpflow_tpu', 'cpflow'):
    sys.modules[name] = None
import numpy as np
import torch
from cpflow_tpu_torch import api, config
from cpflow_tpu_torch.kernels import sweep, unitary
from cpflow_tpu_torch.ops.gates import u_ccz3
from cpflow_tpu_torch.ops.penalty import cp_penalty_L1
from cpflow_tpu_torch.topology import chain_layer
from cpflow_tpu_torch.utils import profiling
config.set_precision(True)
try:
    synth = api.Synthesize(chain_layer(3), target_unitary=u_ccz3,
                           device='cpu')
    opts = api.StaticOptions(num_cp_gates=3, num_samples=4,
                             num_gd_iterations=5, accepted_num_cz_gates=100,
                             entry_loss=1.0,
                             num_gd_iterations_at_verification=5)
    synth.static(opts, save_results=False, verbose=False)
    assert set(synth.stage_seconds) == {'sampling', 'verification',
                                        'decomposition'}
    ev = synth._raw_and_evaluate(opts)
    assert ev.angles.dtype == np.float64 and ev.loss.dtype == np.float64
    objective = synth._objective(synth._ansatz(opts), 0.001)
    assert objective.dtype == torch.float64
    assert sweep.route(objective, 'cuda') == 'fused'
    l1 = api.Synthesize(chain_layer(3), target_unitary=u_ccz3, device='cpu',
                        cp_regularization_func=cp_penalty_L1)
    assert sweep.route(l1._objective(l1._ansatz(opts), 0.001),
                       'cuda') == 'unitary'
    l1.static(opts, save_results=False, verbose=False)
    assert sweep.cluster_plan(7, 24, 7, 'hst', torch.float64) == 4
    assert unitary.plan(8, 16, 7, 8, True,
                        torch.float64)['blocks_per_restart'] == 16
    assert profiling.bound_ms(profiling.sweep_work(
        3, 12, dtype=torch.float64), 1024, 2000)[1] == 'operations'
finally:
    config.set_precision(False)
assert config.real_dtype == torch.float32
print('ok')
'''


def test_port_runs_in_float64_without_jax():
    """A tiny static synthesis in float64 (config.set_precision(True)), with
    the piecewise-linear and the L1 penalty, and the double builds' plans
    and bounds, with the JAX modules blocked."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', DOUBLE_SCRIPT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith('ok')

"""The port runs where JAX, optax and dill are not installed (as on the
machine with the card): imported in a fresh interpreter with those modules
blocked, it runs a tiny static synthesis on the CPU."""

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
anz = synth._ansatz(opts)
a = np.random.default_rng(0).uniform(0, 6, (2, anz.num_angles))
assert np.allclose(params.angles_to_jax(params.angles_from_jax(a, anz,
                                                               'cpu')), a)
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

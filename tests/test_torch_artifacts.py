"""Parity on real circuits: every committed artifact of
benchmarks/artifacts/ (4 to 9 qubits) is embedded exactly into its CP
ansatz (circuit_to_ansatz) and its loss evaluated through both packages.

  * the embedding: the same placements in both packages, angles within
    1e-12; on the host, in float64, the port's Ansatz rebuilds the
    artifact's unitary to rounding (HS distance <= 1e-12) and the host loss
    against the stored target equals the artifact's own within 1e-12;
  * the sweeps' objectives on the CPU (sim/batched.py, the plain version of
    the kernel; above 6 qubits the only path): the port's loss in float32
    against the JAX package's within 2e-5 scaled by max(1, d / 16) (float32
    sums over d^2 entries in another order), and in float64 against the host
    loss within 1e-9.

ghz10_adaptive is left out: its stored circuit sits above the acceptance in
the JAX package's own test."""

import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpflow_tpu import api as japi
from cpflow_tpu.circuits import to_ansatz as jta
from cpflow_tpu.circuits.ir import Circuit as JCircuit
from cpflow_tpu.sim import batched as jbt
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch.circuits import to_ansatz as tta
from cpflow_tpu_torch.circuits.ir import Circuit
from cpflow_tpu_torch.circuits.passes import hst_distance
from cpflow_tpu_torch.sim import batched as tbt

torch.set_num_threads(1)

_ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    'benchmarks', 'artifacts')
# files of the directory that hold no circuit, and the stranded artifact
_NOT_CIRCUITS = ('exact_proofs', 'closed_forms', 'ghz10_adaptive')
LABELS = sorted(os.path.basename(p)[:-5]
                for p in glob.glob(os.path.join(_ART, '*.json'))
                if os.path.basename(p)[:-5] not in _NOT_CIRCUITS)


def _spec(api, meta, target):
    if meta['loss_kind'].startswith('modulo'):
        return api.LossSpec(meta['loss_kind'], target=target,
                            num_qubits=meta['num_qubits'],
                            wires=meta['wires'])
    return api.LossSpec(meta['loss_kind'], target=target)


def test_the_artifacts_are_there():
    assert len(LABELS) >= 50
    sizes = {json.load(open(os.path.join(_ART, f'{label}.json')))['num_qubits']
             for label in LABELS}
    assert {4, 5, 6, 7} <= sizes


@pytest.mark.parametrize('label', LABELS)
def test_artifact_embedding_through_both_packages(label):
    meta = json.load(open(os.path.join(_ART, f'{label}.json')))
    n = meta['num_qubits']
    target = np.load(os.path.join(_ART, 'targets.npz'))[label].astype(
        np.complex128)
    qc, jqc = Circuit(n), JCircuit(n)
    for r in meta['instructions']:
        qc.append(r['name'], tuple(r['qubits']), r.get('param'))
        jqc.append(r['name'], tuple(r['qubits']), r.get('param'))
    assert qc.gates_count(['cz']) == meta['cz_count']

    placements, angles = tta.circuit_to_ansatz(qc)
    jplacements, jangles = jta.circuit_to_ansatz(jqc)
    assert [tuple(p) for p in placements] == [tuple(p) for p in jplacements]
    np.testing.assert_allclose(angles, jangles, atol=1e-12)
    assert len(placements) == meta['cz_count']

    # the host, float64: an exact embedding
    free = {'free': [list(p) for p in placements]}
    anz = tapi.Ansatz(n, 'cp', dict(free), 'xyz')
    u = anz.circuit(angles).unitary()
    assert hst_distance(u, qc.unitary()) <= 1e-12
    spec, jspec = _spec(tapi, meta, target), _spec(japi, meta, target)
    host = spec.numpy(u)
    own = spec.numpy(qc.unitary())
    assert abs(host - own) <= 1e-12
    assert abs(own - jspec.numpy(jqc.unitary())) <= 1e-12
    assert own < 1.5e-6

    # the sweeps' objectives: float32 in both packages, float64 in the port
    janz = japi.Ansatz(n, 'cp', dict(free), 'xyz')
    f32 = tbt.make_batched_regloss(n, 'cp', 'xyz', anz.placements, spec)
    f64 = tbt.make_batched_regloss(n, 'cp', 'xyz', anz.placements, spec,
                                   dtype=torch.float64)
    jf = jbt.make_batched_regloss(n, 'cp', 'xyz', janz.placements, jspec)
    col = angles[:, None]
    loss32 = f32(torch.as_tensor(col, dtype=torch.float32))[1].item()
    loss64 = f64(torch.as_tensor(col, dtype=torch.float64))[1].item()
    jloss = float(jf(jnp.asarray(col, dtype=jnp.float32))[1][0])
    assert abs(loss64 - host) <= 1e-9
    tol = 2e-5 * max(1.0, 2 ** n / 16)
    assert abs(loss32 - jloss) <= tol
    assert abs(loss32 - host) <= tol

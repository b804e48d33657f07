"""circuit_to_ansatz of the port (cpflow_tpu_torch/circuits/to_ansatz.py)
against the JAX package's: the same placements and angles within 1e-12 on
seeded circuits, and the embedding's unitary through the port's Ansatz equal
to the circuit's up to a global phase (float64 on the host within 1e-12,
the float32 unitary of the sweeps within 1e-6)."""

import numpy as np
import pytest
import torch

from cpflow_tpu.circuits import to_ansatz as jta
from cpflow_tpu.circuits.ir import Circuit as JCircuit
from cpflow_tpu_torch import params
from cpflow_tpu_torch.api import Ansatz
from cpflow_tpu_torch.circuits import to_ansatz as tta
from cpflow_tpu_torch.circuits.ir import FIXED_GATES, Circuit
from cpflow_tpu_torch.circuits.passes import hst_distance


def _random_su2(rng):
    z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def random_cz_circuit(seed, n=3, length=30):
    """Entanglers cz and cp only, with every kind of 1q gate between."""
    rng = np.random.default_rng(seed)
    names = ['h', 'x', 's', 't', 'sdg', 'rx', 'ry', 'rz']
    qc = Circuit(n)
    for _ in range(length):
        if rng.integers(0, 4) == 0:
            i, j = (int(x) for x in rng.choice(n, size=2, replace=False))
            if rng.integers(0, 2):
                qc.cz(i, j)
            else:
                qc.cp(float(rng.uniform(-np.pi, np.pi)), i, j)
        else:
            g = names[rng.integers(0, len(names))]
            q = int(rng.integers(0, n))
            if g in ('rx', 'ry', 'rz'):
                qc.append(g, q, float(rng.uniform(-np.pi, np.pi)))
            else:
                qc.append(g, q)
    return qc


@pytest.mark.parametrize('seed', range(8))
def test_zyx_angles_random(seed):
    u = _random_su2(np.random.default_rng(seed))
    angles = tta.zyx_angles(u)
    np.testing.assert_allclose(angles, jta.zyx_angles(u), atol=1e-12)
    v = tta.zyx_reconstruct(*angles)
    np.testing.assert_allclose(v, jta.zyx_reconstruct(*angles), atol=1e-12)
    assert hst_distance(u, v) < 1e-12


@pytest.mark.parametrize('gate', ['id', 'x', 'y', 'z', 'h', 's', 't'])
def test_zyx_angles_named_gates(gate):
    u = FIXED_GATES[gate]
    angles = tta.zyx_angles(u)
    np.testing.assert_allclose(angles, jta.zyx_angles(u), atol=1e-12)
    assert hst_distance(u, tta.zyx_reconstruct(*angles)) < 1e-12


@pytest.mark.parametrize('seed', [0, 3, 11, 12, 13])
def test_random_circuit_round_trip(seed):
    qc = random_cz_circuit(seed)
    placements, angles = tta.circuit_to_ansatz(qc)
    jplacements, jangles = jta.circuit_to_ansatz(
        params.circuit_to_jax(qc, JCircuit))
    assert [tuple(p) for p in placements] == [tuple(p) for p in jplacements]
    np.testing.assert_allclose(angles, jangles, atol=1e-12)
    assert len(placements) == qc.gates_count(['cz', 'cp'])

    anz = Ansatz(3, 'cp', {'free': [list(p) for p in placements]}, 'xyz')
    assert anz.num_angles == len(angles)
    # Ansatz.circuit is the inverse: exact on the host
    assert hst_distance(anz.circuit(angles).unitary(), qc.unitary()) < 1e-12
    # and the float32 unitary the sweeps build
    u = anz.unitary(torch.as_tensor(angles, dtype=torch.float32)).numpy()
    assert hst_distance(u.astype(complex), qc.unitary()) < 1e-6


def test_what_cannot_be_embedded_is_refused():
    for mod, cls in ((tta, Circuit), (jta, JCircuit)):
        with pytest.raises(ValueError, match='flatten'):
            mod.circuit_to_ansatz(cls(2).cx(0, 1))
        with pytest.raises(ValueError, match='xyz'):
            mod.circuit_to_ansatz(cls(2), rotation_gates='xz')
    placements, angles = tta.circuit_to_ansatz(Circuit(2))
    assert placements == [] and not angles.any() and len(angles) == 6

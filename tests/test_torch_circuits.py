"""The port's carried-over circuit modules (Circuit, Ansatz.circuit,
cp_to_cz_circuit, convert_to_zxz, zxz_angles, check_approximation) against
cpflow_tpu.circuits: same instruction lists, unitaries within 1e-6 (both
float64 on the host)."""

import numpy as np
import pytest

from cpflow_tpu import api as japi
from cpflow_tpu.circuits import euler as jeuler
from cpflow_tpu.circuits import passes as jpasses
from cpflow_tpu_torch import api as tapi
from cpflow_tpu_torch.circuits import euler as teuler
from cpflow_tpu_torch.circuits import ir as tir
from cpflow_tpu_torch.circuits import passes as tpasses
from cpflow_tpu_torch.topology import chain_layer, connected_layer, fill_layers


def _same_instructions(ours, ref):
    assert ours.num_qubits == ref.num_qubits
    assert len(ours.instructions) == len(ref.instructions)
    for a, b in zip(ours.instructions, ref.instructions):
        assert (a.name, a.qubits) == (b.name, b.qubits)
        if b.param is None:
            assert a.param is None
        else:
            assert a.param == pytest.approx(b.param, abs=1e-12)


def _angles(anz, rng, snap_fraction):
    """Random angles; a fraction of the CP angles exactly 0 or pi, as
    verification leaves them."""
    a = rng.uniform(-np.pi, 3 * np.pi, anz.num_angles)
    cp = np.nonzero(anz.cp_mask)[0]
    snap = rng.uniform(size=len(cp)) < snap_fraction
    a[cp[snap]] = rng.choice([0.0, np.pi], size=int(snap.sum()))
    return a


@pytest.mark.parametrize('n,layer,rot,k,seed', [
    (3, chain_layer(3), 'xyz', 12, 0),
    (4, connected_layer(4), 'xz', 7, 1),
    (2, chain_layer(2), 'xyz', 3, 2),
])
def test_ansatz_circuit_and_passes_match_jax(n, layer, rot, k, seed):
    rng = np.random.default_rng(seed)
    janz = japi.Ansatz(n, 'cp', fill_layers(layer, k), rot)
    tanz = tapi.Ansatz(n, 'cp', fill_layers(layer, k), rot)
    np.testing.assert_array_equal(tanz.cp_mask, np.asarray(janz.cp_mask))
    a = _angles(tanz, rng, snap_fraction=0.7)

    qc, jqc = tanz.circuit(list(a)), janz.circuit(list(a))
    _same_instructions(qc, jqc)
    np.testing.assert_allclose(qc.unitary(), jqc.unitary(), atol=1e-6)
    assert qc.gates_count(['cp']) == jqc.gates_count(['cp'])
    assert qc.depth() == jqc.depth()

    cz, jcz = tpasses.cp_to_cz_circuit(qc, 1e-6), \
        jpasses.cp_to_cz_circuit(jqc, 1e-6)
    _same_instructions(cz, jcz)
    zxz, jzxz = tpasses.convert_to_zxz(cz), jpasses.convert_to_zxz(jcz)
    _same_instructions(zxz, jzxz)
    np.testing.assert_allclose(zxz.unitary(), jzxz.unitary(), atol=1e-6)
    assert zxz.gates_count(['cz']) == jzxz.gates_count(['cz'])
    assert zxz.gates_depth(['cz']) == jzxz.gates_depth(['cz'])


def test_zxz_angles_match_jax():
    rng = np.random.default_rng(3)
    mats = [np.eye(2), np.array([[0, 1], [1, 0]]), np.diag([1, 1j])]
    for _ in range(20):
        z = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        q, _ = np.linalg.qr(z)
        mats.append(q)
    for m in mats:
        np.testing.assert_allclose(teuler.zxz_angles(m),
                                   jeuler.zxz_angles(m), atol=1e-12)


def test_param_gate_matrix_and_check_approximation():
    from cpflow_tpu.circuits import ir as jir
    for name in ('rx', 'ry', 'rz', 'cp'):
        for a in (-2.5, 0.0, 1.3):
            np.testing.assert_array_equal(tir.param_gate_matrix(name, a),
                                          jir.param_gate_matrix(name, a))
    qc = tir.Circuit(2).append('rx', 0, 0.3).append('cz', (0, 1))
    tpasses.check_approximation(qc, qc.copy())
    drifted = tir.Circuit(2).append('rx', 0, 0.9).append('cz', (0, 1))
    with pytest.raises(ValueError):
        tpasses.check_approximation(qc, drifted)

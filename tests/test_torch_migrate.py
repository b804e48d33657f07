"""The port's tolerant unpickler of the reference's Results (migrate.py)
against the JAX package's, on pickles built here (the reference's
paper/results are not in this repository). The pickles name the globals
the reference's dill files name: cpflow.main.Results, Decomposition and
Synthesize, a hyperopt.base.Trials and a qiskit QuantumCircuit of
rotation, CZ and CP gates; stand-in classes are registered under those
module names only while dumping, so that loading finds none of hyperopt
or qiskit. Both packages load the same bytes: trial records equal, the
same CZ counts, host losses within 1e-9 (float64 on both sides)."""

import math
import pickle
import sys
import types

import numpy as np
import pytest

from cpflow_tpu_torch import api, migrate
from cpflow_tpu_torch.circuits.ir import Circuit

GATES = [('rz', (0,), 0.3), ('rx', (1,), math.pi / 2), ('cz', (0, 1), None),
         ('ry', (2,), -0.7), ('cp', (1, 2), math.pi), ('rz', (2,), 1.1),
         ('cz', (1, 2), None), ('rx', (0,), 0.25)]


def _modules():
    """Stand-in classes under the reference's module names."""
    def cls(module, name):
        return type(name, (), {'__module__': module, '__qualname__': name})

    mods = {}
    for module, names in [
            ('cpflow.main', ['Results', 'Decomposition', 'Synthesize']),
            ('hyperopt', []), ('hyperopt.base', ['Trials']),
            ('qiskit', []), ('qiskit.circuit', []),
            ('qiskit.circuit.quantumcircuit', ['QuantumCircuit']),
            ('qiskit.circuit.quantumregister', ['Qubit']),
            ('qiskit.circuit.gate', ['Gate'])]:
        mod = types.ModuleType(module)
        for name in names:
            setattr(mod, name, cls(module, name))
        mods[module] = mod
    return mods


def _circuit_stub(m, gates, n=3):
    qc = m['qiskit.circuit.quantumcircuit'].QuantumCircuit()
    qubits = []
    for i in range(n):
        q = m['qiskit.circuit.quantumregister'].Qubit()
        q._index = i
        qubits.append(q)
    qc._qubits = qubits
    qc._data = []
    for name, wires, param in gates:
        g = m['qiskit.circuit.gate'].Gate()
        g._name = name
        g._params = [] if param is None else [param]
        qc._data.append((g, [qubits[w] for w in wires], []))
    return qc


def _host_unitary(gates, n=3):
    c = Circuit(n)
    for name, wires, param in gates:
        c.append(name, wires if len(wires) > 1 else wires[0], param)
    return c.unitary()


@pytest.fixture(scope='module')
def payload():
    """The bytes of a reference-shaped Results: two decompositions (one
    stored unitary exact, one from slightly other angles) and three
    trials, one of them failed."""
    import cpflow  # noqa: F401  (the real package; only cpflow.main is swapped)
    m = _modules()
    saved = {k: sys.modules.get(k) for k in m}
    sys.modules.update(m)
    try:
        main = m['cpflow.main']
        trials = m['hyperopt.base'].Trials()
        trials._dynamic_trials = [
            {'result': {'status': 'ok', 'loss': -3.5, 'num_cp_gates': 6,
                        'r': 0.0007, 'cz_counts': [4, 5], 'random_seed': 11},
             'misc': {'vals': {'num_cp_gates': [6.0], 'r': [0.0007]}}},
            {'result': {'status': 'fail'}, 'misc': {'vals': {}}},
            {'result': {'status': 'ok', 'loss': -2.0, 'num_cp_gates': 4,
                        'r': 0.0011, 'cz_counts': [3], 'random_seed': 12},
             'misc': {'vals': {'num_cp_gates': [4.0], 'r': [0.0011]}}}]
        target = _host_unitary(GATES)
        decomposer = main.Synthesize()
        decomposer.target_unitary = target
        decomposer.layer = [[0, 1], [1, 2]]
        decs = []
        for shift in (0.0, 1e-3):
            d = main.Decomposition()
            d.circuit = _circuit_stub(m, GATES)
            d.unitary = _host_unitary(
                [(g, w, p + shift if g == 'rz' else p) for g, w, p in GATES])
            d.cz_count = 2
            d.loss = 0.0
            d.label = 'stand-in'
            d._decomposer = decomposer
            decs.append(d)
        results = main.Results()
        results.trials = trials
        results.decompositions = decs
        results.layer = [[0, 1], [1, 2]]
        results.label = 'stand-in'
        results.save_to = 'results/stand-in'
        return pickle.dumps(results)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


@pytest.fixture
def paths(payload, tmp_path):
    path = tmp_path / 'stand-in.pkl'
    path.write_bytes(payload)
    return str(path)


def test_both_packages_read_the_same_records(paths):
    from cpflow_tpu import migrate as jax_migrate
    ours = migrate.load_reference_pickle(paths)
    theirs = jax_migrate.load_reference_pickle(paths)
    assert type(ours) is api.Results
    assert type(ours.decompositions[0]) is api.Decomposition
    assert type(ours.decompositions[0]._decomposer) is api.Synthesize
    assert type(ours.trials).__name__ == 'Trials' and \
        isinstance(ours.trials, migrate._Stub)

    records = migrate.trial_records(ours)
    assert records == jax_migrate.trial_records(theirs)
    assert [r['num_cp_gates'] for r in records] == [6, 4]

    mine = migrate.migrated_decompositions(ours)
    jax = jax_migrate.migrated_decompositions(theirs)
    assert [d['cz_count'] for d in mine] == [d['cz_count'] for d in jax] \
        == [2, 2]
    for a, b in zip(mine, jax):
        assert a['stored_cz_count'] == b['stored_cz_count'] == 2
        assert abs(a['hs_distance_to_stored'] -
                   b['hs_distance_to_stored']) <= 1e-9
        assert [(i.name, tuple(i.qubits), i.param)
                for i in a['circuit'].instructions] == \
            [(i.name, tuple(i.qubits), i.param)
             for i in b['circuit'].instructions]
    assert mine[0]['hs_distance_to_stored'] <= 1e-12
    assert mine[1]['hs_distance_to_stored'] > 1e-9


def test_load_reference_results_repairs_into_the_port(paths):
    from cpflow_tpu import migrate as jax_migrate
    ours = migrate.load_reference_results(paths, device='cpu')
    theirs = jax_migrate.load_reference_results(paths)
    assert ours.loss_function.kind == theirs.loss_function.kind == 'hst'
    np.testing.assert_array_equal(ours.loss_function.target,
                                  theirs.loss_function.target)
    assert ours.trials.vals == theirs.trials.vals == [[6.0, 0.0007],
                                                      [4.0, 0.0011]]
    assert [r['loss'] for r in ours.trials.results] == \
        [r['loss'] for r in theirs.trials.results]
    assert ours.best_hyperparameters() == theirs.best_hyperparameters()
    for a, b in zip(ours.decompositions, theirs.decompositions):
        assert isinstance(a.circuit, Circuit)
        assert a.circuit.gates_count(['cz']) == \
            b.circuit.gates_count(['cz']) == 2
        assert a._decomposer.device.type == 'cpu'
        assert a._decomposer.mesh is None
        host = a.unitary_loss_func.numpy(a.circuit.unitary())
        jhost = b.unitary_loss_func.numpy(b.circuit.unitary())
        assert abs(host - jhost) <= 1e-9 and host <= 1e-12
    pickle.loads(pickle.dumps(ours))  # a repaired Results saves again


def test_no_module_of_jax_or_the_jax_package_is_imported(tmp_path):
    """Globals of cpflow_tpu or jax load as stubs, never as the JAX
    package's classes; cpflow.<Name> maps to the port as cpflow.main does;
    a name the port's api lacks is a stub."""
    blob = (b'\x80\x04' + b'\x8c\x0ecpflow_tpu.api\x8c\x07Results\x93'
            + b'\x8c\x06cpflow\x8c\rStaticOptions\x93'
            + b'\x8c\x0bcpflow.main\x8c\x0bNoSuchThing\x93'
            + b'\x87.')
    path = tmp_path / 'globals.pkl'
    path.write_bytes(blob)
    jax_cls, static, missing = migrate.load_reference_pickle(str(path))
    assert issubclass(jax_cls, migrate._Stub)
    assert jax_cls._stub_qualname == 'cpflow_tpu.api.Results'
    assert static is api.StaticOptions
    assert issubclass(missing, migrate._Stub)

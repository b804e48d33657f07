"""Load the reference's dill-pickled Results (paper/results/*) without the
reference stack (counterpart of cpflow_tpu/migrate.py).

The reference persists experiments as dill pickles of its own classes plus
hyperopt Trials and qiskit circuits. None of dill, hyperopt or qiskit is
needed here, so a plain load would fail on the first missing global. This
module provides a tolerant unpickler:

  * cpflow.main.<Name> and cpflow.<Name> resolve straight to
    cpflow_tpu_torch.api.<Name> (so a loaded Results IS the port's
    Results), without importing the cpflow shim, which imports the JAX
    package;
  * every other global that is missing, or belongs to JAX or the JAX
    package, resolves to an attribute-preserving stub: the pickled state
    survives as plain __dict__ data;
  * qiskit QuantumCircuit stubs are then rebuilt into the port's Circuit IR
    from their instruction data (gate name, params, qubit indices), giving
    re-executable, re-verifiable circuits.

Trials expose the (k, r) -> score history, and each stored decomposition
re-verifies against its own stored unitary.
"""

from __future__ import annotations

import io
import pickle
from typing import List, Optional

import numpy as np


# --------------------------------------------------------------------------
# Tolerant unpickling
# --------------------------------------------------------------------------

class _Stub:
    """Attribute-preserving placeholder for an unimportable pickled class."""

    def __init__(self, *args, **kwargs):
        self._stub_args = args
        self._stub_kwargs = kwargs

    def __call__(self, *args, **kwargs):
        # dill._dill._create_function etc. are pickled as callables applied
        # to their payload; calling a stub yields a stub carrying the args
        out = _Stub()
        out._stub_args = args
        out._stub_kwargs = kwargs
        out._stub_factory = getattr(type(self), '_stub_qualname', '?')
        return out

    def __setstate__(self, state):
        # object.__reduce_ex__ state conventions: dict, or (dict, slots)
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple):
            for part in state:
                if isinstance(part, dict):
                    self.__dict__.update(part)
        else:
            self._stub_state = state


_STUB_CACHE: dict = {}


def _make_stub_class(module: str, name: str):
    key = (module, name)
    if key not in _STUB_CACHE:
        _STUB_CACHE[key] = type(name, (_Stub,), {
            '__module__': module,
            '_stub_qualname': f'{module}.{name}',
        })
    return _STUB_CACHE[key]


# modules never imported while loading: the reference's names map to the
# port's api, and JAX and the JAX package are not the port's to import
_NOT_IMPORTED = ('cpflow', 'cpflow_tpu', 'jax', 'jaxlib', 'optax', 'dill')


class ReferenceUnpickler(pickle.Unpickler):
    """Resolves cpflow.main.<Name> and cpflow.<Name> to the port's api,
    stubs what is missing."""

    def find_class(self, module, name):  # noqa: D401
        if module in ('cpflow', 'cpflow.main'):
            from cpflow_tpu_torch import api
            found = getattr(api, name, None)
            if found is not None:
                return found
        if module.split('.')[0] in _NOT_IMPORTED:
            return _make_stub_class(module, name)
        try:
            return super().find_class(module, name)
        except Exception:
            return _make_stub_class(module, name)


def load_reference_pickle(path: str):
    """Unpickle a reference dill file tolerantly (the classes of
    cpflow.main come back as the port's objects; everything else missing
    as stubs)."""
    with open(path, 'rb') as f:
        return ReferenceUnpickler(io.BytesIO(f.read())).load()


# --------------------------------------------------------------------------
# Qiskit-circuit-stub -> our IR
# --------------------------------------------------------------------------

def circuit_from_qiskit_stub(qc_stub):
    """Rebuild a Circuit (our IR) from a pickled qiskit QuantumCircuit stub:
    reads instruction (name, params) and qubit indices straight out of the
    preserved state. Supports the gate set the reference emits
    (rx/ry/rz/u/cz/cp/cx/h/x/z/s/sdg/t/tdg + named Cliffords)."""
    from cpflow_tpu_torch.circuits.ir import Circuit

    qubits = qc_stub.__dict__.get('_qubits') or []
    index_of = {}
    for i, qb in enumerate(qubits):
        idx = qb.__dict__.get('_index', i)
        index_of[id(qb)] = i if idx is None else idx
    n = len(qubits)

    qc = Circuit(max(n, 1))
    for entry in qc_stub.__dict__.get('_data', []):
        # old qiskit: (instruction, qargs, cargs); newer: CircuitInstruction
        if isinstance(entry, tuple) and len(entry) == 3:
            ins, qargs, _ = entry
        else:
            ins = getattr(entry, 'operation', entry)
            qargs = getattr(entry, 'qubits', [])
        name = ins.__dict__.get('_name') or ins.__dict__.get('name')
        params = [float(p) for p in (ins.__dict__.get('_params') or [])]
        targets = tuple(index_of.get(id(q),
                                     q.__dict__.get('_index', 0))
                        for q in qargs)
        if name in ('rx', 'ry', 'rz', 'cp'):
            qc.append(name, targets if len(targets) > 1 else targets[0],
                      params[0])
        elif name == 'u':
            # ZXZ-expand: u(theta, phi, lam) = rz(phi) rx?(...) — the
            # reference refines everything to rx/ry/rz before saving, so u
            # should not appear; guard anyway
            raise ValueError('u-gate in stored circuit; refine first')
        else:
            qc.append(name, targets)
    return qc


# --------------------------------------------------------------------------
# Trials and Results views
# --------------------------------------------------------------------------

def trial_records(results) -> List[dict]:
    """Per-trial records of a loaded reference Results: the same schema our
    adaptive search logs ({'num_cp_gates', 'r', 'score', 'cz_counts',
    'random_seed'})."""
    trials = getattr(results, 'trials', None)
    if trials is None:
        return []
    dyn = getattr(trials, '_dynamic_trials', None)
    if dyn is None and isinstance(getattr(trials, '__dict__', None), dict):
        dyn = trials.__dict__.get('_dynamic_trials')
    out = []
    for t in dyn or []:
        res = t.get('result', {}) if isinstance(t, dict) else {}
        if res.get('status') != 'ok':
            continue
        out.append({
            'num_cp_gates': int(res.get('num_cp_gates', -1)),
            'r': float(res.get('r', float('nan'))),
            'score': float(res.get('loss', float('nan'))),
            'cz_counts': list(res.get('cz_counts', [])),
            'random_seed': res.get('random_seed'),
        })
    return out


def native_trials(results):
    """Convert a migrated hyperopt.Trials stub into our search.tpe.Trials
    (same record schema our adaptive search writes), so best_hyperparameters,
    plot_trials and adaptive RESUME work on migrated results."""
    from cpflow_tpu_torch.search.tpe import Trials

    t = Trials()
    dyn = getattr(results.trials, '_dynamic_trials', None) or \
        getattr(results.trials, '__dict__', {}).get('_dynamic_trials', [])
    for rec in dyn or []:
        res = rec.get('result', {}) if isinstance(rec, dict) else {}
        if res.get('status') != 'ok':
            continue
        vals = rec.get('misc', {}).get('vals', {})
        k = float(np.asarray(vals.get('num_cp_gates', [res.get(
            'num_cp_gates', -1)])).ravel()[0])
        r = float(np.asarray(vals.get('r', [res.get('r', 0.0)])).ravel()[0])
        t.record([k, r], dict(res))
    return t


def load_reference_results(path: str, device='cuda'):
    """Load a reference Results pickle AND repair it into a fully working
    native object (its decomposer on `device`, the card unless the caller
    asks for the CPU):

      * trials       -> our Trials (best_hyperparameters / plot_trials work)
      * loss_function-> LossSpec('hst', target) — the target unitary
                        survives in the pickled Synthesize (the reference's
                        dill closure itself is dead bytecode)
      * decompositions: circuit stubs -> our Circuit IR; _decomposer ->
                        a working Synthesize (so the tutorial's
                        reproducibility cells rerun, reference tutorial
                        cells 111-118)
    """
    from cpflow_tpu_torch.api import LossSpec, Synthesize

    r = load_reference_pickle(path)
    # recover the target unitary from any pickled decomposer
    target = None
    layer = getattr(r, 'layer', None)
    label = getattr(r, 'label', '')
    for d in getattr(r, 'decompositions', None) or []:
        dec = d.__dict__.get('_decomposer')
        tu = getattr(dec, '__dict__', {}).get('target_unitary') \
            if dec is not None else None
        if tu is not None:
            target = np.asarray(tu)
            layer = getattr(dec, '__dict__', {}).get('layer', layer)
            break

    spec = LossSpec('hst', target=target) if target is not None else None
    if spec is not None:
        r.loss_function = spec
    if getattr(r, 'trials', None) is not None:
        r.trials = native_trials(r)

    fresh_decomposer = None
    if target is not None and layer is not None:
        fresh_decomposer = Synthesize(
            [list(p) for p in layer], target_unitary=target.astype(
                np.complex64), label=str(label), device=device)

    for d in getattr(r, 'decompositions', None) or []:
        if type(d.__dict__.get('circuit')).__name__ == 'QuantumCircuit':
            d.circuit = circuit_from_qiskit_stub(d.circuit)
        d.unitary = np.asarray(d.unitary)
        if spec is not None:
            d.unitary_loss_func = spec
        if fresh_decomposer is not None:
            d._decomposer = fresh_decomposer
        # _static_options / _adaptive_options resolved to the port's
        # dataclasses with the reference's field values: usable as they are
        _scrub_stubs(d.__dict__)
    _scrub_stubs(r.__dict__)
    return r


def _scrub_stubs(state: dict, max_depth: int = 6) -> None:
    """Null out attributes whose value graph still contains _Stub objects
    (dead dill closures, unreconstructed internals). A repaired Results must
    re-save cleanly, and pickle cannot save the stub classes made at load
    time."""
    for key, val in list(state.items()):
        if _contains_stub(val, max_depth):
            state[key] = None


def _contains_stub(obj, depth: int, _seen=None) -> bool:
    if depth < 0:
        return False  # known stub sites are shallow (options, _cp_data)
    if isinstance(obj, _Stub) or isinstance(obj, type) and \
            issubclass(obj, _Stub):
        return True
    if isinstance(obj, (str, bytes, int, float, complex, bool, type(None),
                        np.ndarray, np.generic)):
        return False
    if _seen is None:
        _seen = set()
    if id(obj) in _seen:
        return False
    _seen.add(id(obj))
    if isinstance(obj, (list, tuple, set)):
        return any(_contains_stub(x, depth - 1, _seen) for x in obj)
    if isinstance(obj, dict):
        return any(_contains_stub(v, depth - 1, _seen)
                   for v in obj.values())
    d = getattr(obj, '__dict__', None)
    if isinstance(d, dict):
        return any(_contains_stub(v, depth - 1, _seen) for v in d.values())
    return False


def migrated_decompositions(results) -> List[dict]:
    """Rebuild each stored decomposition into our IR and re-verify it
    against ITS OWN stored unitary (HS distance). Returns records:
    {'circuit', 'cz_count', 'stored_cz_count', 'hs_distance_to_stored'}."""
    out = []
    for d in getattr(results, 'decompositions', None) or []:
        qc_stub = getattr(d, 'circuit', None)
        if qc_stub is None:
            continue
        qc = circuit_from_qiskit_stub(qc_stub)
        u = qc.unitary()
        stored = np.asarray(getattr(d, 'unitary'))
        dim = stored.shape[0]
        hs = float(1.0 - abs(np.sum(u.conj() * stored)) / dim)
        out.append({
            'circuit': qc,
            'cz_count': qc.gates_count(['cz']),
            'stored_cz_count': getattr(d, 'cz_count', None),
            'hs_distance_to_stored': hs,
        })
    return out

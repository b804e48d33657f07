"""User-facing API of the port: Synthesize.static and what it returns
(counterpart of cpflow_tpu/api.py, static slice).

The public names, option dataclasses and their defaults follow the JAX
package. What differs:

  * ``Synthesize`` takes an explicit ``device`` ('cpu' or 'cuda'). On a CUDA
    device both the sampling and the verification sweep run the
    hand-written kernel (kernels/sweep.py); on the CPU, its plain PyTorch
    version. There is no fallback from one to the other.
  * initial angles come from a ``torch.Generator`` seeded with
    ``random_seed``: the same seed gives other angles than the JAX
    package (optimize/candidates.py).
  * ``Results`` persist with the standard library's pickle.
  * Not here yet: ``adaptive`` and TPE (ROADMAP A.8), ``Decomposition.refine``
    (A.11), methods other than 'adam' (A.10), device losses other than the
    HS test (A.4), the device mesh (A.9).
"""

from __future__ import annotations

import math
import os
import pickle
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.circuits.ir import Circuit
from cpflow_tpu_torch.circuits.passes import convert_to_zxz, cp_to_cz_circuit
from cpflow_tpu_torch.optimize import candidates as cand
from cpflow_tpu_torch.optimize import engine
from cpflow_tpu_torch.ops.penalty import make_regularization_function
from cpflow_tpu_torch.sim import batched as batched_sim
from cpflow_tpu_torch.sim.ansatz_kernel import (block_matrix, build_unitary,
                                                cp_angle_indices,
                                                num_block_angles)
from cpflow_tpu_torch.topology import fill_layers, num_qubits_from_layer


# --------------------------------------------------------------------------
# Loss specifications
# --------------------------------------------------------------------------

class LossSpec:
    """Declarative unitary loss. On the device the port evaluates the HS
    test ('hst'); ``numpy`` evaluates the host loss of a float64 matrix."""

    def __init__(self, kind: str, target: Optional[np.ndarray] = None,
                 fn: Optional[Callable] = None, wires: Optional[list] = None,
                 num_qubits: Optional[int] = None):
        self.kind = kind
        self.target = None if target is None else np.asarray(target)
        if kind == 'state' and self.target is not None:
            self.target = self.target / np.linalg.norm(self.target)
        self.fn = fn
        self.wires = wires
        self.num_qubits = num_qubits

    def numpy(self, u: np.ndarray) -> float:
        t = self.target
        if self.kind == 'hst':
            n = t.shape[0]
            return float(1 - abs((u * t.conj()).sum()) ** 2 / n ** 2)
        if self.kind == 'disc':
            n = t.shape[0]
            return float(1 - abs((u.conj() * t).sum()) / n)
        if self.kind == 'state':
            overlap = (t.conj() * u[:, 0]).sum()
            return float(1 - abs(overlap) ** 2)
        if self.kind == 'custom':
            return float(self.fn(u))
        raise NotImplementedError(
            f'loss kind {self.kind!r} is not ported yet (ROADMAP A.10: the '
            f'modulo-identity/diagonal losses)')

    def __repr__(self):
        shape = None if self.target is None else self.target.shape
        return f'LossSpec({self.kind!r}, target_shape={shape})'


# --------------------------------------------------------------------------
# EntanglingBlock / Ansatz
# --------------------------------------------------------------------------

class EntanglingBlock:
    """Two-qubit block: entangling gate followed by a per-qubit rotation
    string."""

    @staticmethod
    def get_num_angles(entangling_gate_name: str, rotation_gates: str) -> int:
        return num_block_angles(entangling_gate_name, rotation_gates)

    def __init__(self, entangling_gate_name: str, rotation_gates: str, angles):
        self.entangling_gate_name = entangling_gate_name
        self.rotation_gates = rotation_gates
        self.angles = angles
        self.num_angles = self.get_num_angles(entangling_gate_name,
                                              rotation_gates)

    def circuit(self) -> Circuit:
        qc = Circuit(2)
        a = np.asarray(self.angles)
        if self.entangling_gate_name == 'cp':
            qc.append('cp', (0, 1), float(a[-1]))
        else:
            qc.append(self.entangling_gate_name, (0, 1))
        for i, letter in enumerate(self.rotation_gates):
            qc.append('r' + letter, 0, float(a[2 * i]))
            qc.append('r' + letter, 1, float(a[2 * i + 1]))
        return qc

    def unitary(self) -> torch.Tensor:
        return block_matrix(self.entangling_gate_name, self.rotation_gates,
                            torch.as_tensor(self.angles,
                                            dtype=config.real_dtype))


class _Param(float):
    """Labelled placeholder parameter for parametrized circuit rendering."""
    def __new__(cls, name):
        obj = super().__new__(cls, float('nan'))
        obj.name = name
        return obj

    def __repr__(self):
        return self.name

    def __format__(self, spec):
        return self.name


class Ansatz:
    """Template circuit: num_qubits, entangling_gate_name, rotation_gates,
    placements {'layers': [layer, n], 'free': [...]}, all_placements,
    num_angles, cp_mask (numpy float32, or None without CP gates) and
    ``unitary`` (angles tensor -> matrix)."""

    def __init__(self, num_qubits: int, entangling_gate_name: str,
                 placements: dict, rotation_gates: str = 'xyz'):
        self.num_qubits = num_qubits
        self.entangling_gate_name = entangling_gate_name
        self.rotation_gates = rotation_gates

        placements.setdefault('layers', [[], 0])
        placements.setdefault('free', [])
        self.placements = placements
        self.layer, self.num_layers = placements['layers']
        self.free_placements = placements['free']
        self.all_placements = list(self.layer) * self.num_layers + \
            list(self.free_placements)
        self.num_blocks = len(self.all_placements)

        nba = num_block_angles(entangling_gate_name, rotation_gates)
        self.num_block_angles = nba
        self.num_angles = 3 * num_qubits + nba * self.num_blocks

        if entangling_gate_name == 'cp':
            mask = np.zeros(self.num_angles, dtype=np.float32)
            mask[cp_angle_indices(num_qubits, nba, self.num_blocks)] = 1.0
            self.cp_mask = mask
        else:
            self.cp_mask = None

    def unitary(self, angles) -> torch.Tensor:
        return build_unitary(self.num_qubits, self.entangling_gate_name,
                             self.rotation_gates, self.placements, angles)

    def circuit(self, angles=None) -> Circuit:
        """IR circuit at the given angles; with angles=None, rotation
        parameters are labelled placeholders."""
        if angles is None:
            angles = [_Param(f'a_{i}') for i in range(self.num_angles)]
        a = list(angles)
        nba = self.num_block_angles

        qc = Circuit(self.num_qubits)
        for q in range(self.num_qubits):
            qc.append('rz', q, a[3 * q + 0])
            qc.append('rx', q, a[3 * q + 1])
            qc.append('rz', q, a[3 * q + 2])
        base = 3 * self.num_qubits
        for b, p in enumerate(self.all_placements):
            block = a[base + b * nba: base + (b + 1) * nba]
            if self.entangling_gate_name == 'cp':
                qc.append('cp', tuple(p), block[-1])
            else:
                qc.append(self.entangling_gate_name, tuple(p))
            for i, letter in enumerate(self.rotation_gates):
                qc.append('r' + letter, p[0], block[2 * i])
                qc.append('r' + letter, p[1], block[2 * i + 1])
        return qc


# --------------------------------------------------------------------------
# Decomposition
# --------------------------------------------------------------------------

class Decomposition:
    """A found decomposition: circuit, host loss, CZ metrics.
    ``refine`` (Clifford+T) is not ported yet (ROADMAP A.11)."""

    def __init__(self, unitary_loss_func, circuit: Circuit, label: str = '',
                 type: str = 'Approximate'):
        self.unitary_loss_func = unitary_loss_func
        self.circuit = circuit
        self.unitary = circuit.unitary()
        self.label = label
        self.loss = unitary_loss_func.numpy(self.unitary)
        self.type = type
        self.cz_count = circuit.gates_count(['cz'])
        self.cz_depth = circuit.gates_depth(['cz'])
        self._cp_data = None
        self._static_options = None

    @classmethod
    def _from_cp_circuit(cls, unitary_loss_func, anz: Ansatz, angles,
                         label: str = '') -> 'Decomposition':
        """Build from a verified CP-ansatz angle vector: render the circuit,
        project CP gates (already frozen to exact 0/pi by verification),
        convert 1q runs to ZXZ."""
        angles = np.asarray(angles, dtype=float)
        qc = anz.circuit(list(angles))
        qc = cp_to_cz_circuit(qc, cp_threshold=1e-6)
        qc = convert_to_zxz(qc)
        d = cls(unitary_loss_func, qc, label=label)
        d._cp_data = [anz.placements, angles]
        return d

    def __repr__(self):
        return (f"< {self.label}| {self.type} | loss: {self.loss}  "
                f"| CZ count: {self.cz_count} | CZ depth: {self.cz_depth}  >")


# --------------------------------------------------------------------------
# Options
# --------------------------------------------------------------------------

@dataclass
class RegularizationOptions:
    function: str = 'linear'
    ymax: float = 2
    xmax: float = math.pi / 2
    plato_0: float = 0.05
    plato_1: float = 0.05
    plato_2: float = 0.05


@dataclass
class BasicOptions:
    """Options shared by static and adaptive synthesis. num_gd_segments > 1
    chains that many verification sweeps, each resuming from the previous
    one's best angles with fresh Adam moments."""
    num_samples: int = 100
    method: str = 'adam'
    learning_rate: float = 0.1
    num_gd_iterations: int = 2000
    cp_distribution: str = 'uniform'
    entry_loss: float = 1e-3
    target_loss: float = 1e-6
    threshold_cp: float = 0.2
    learning_rate_at_verification: float = 0.01
    num_gd_iterations_at_verification: int = 5000
    random_seed: int = 0
    rotation_gates: str = 'xyz'
    num_gd_segments: int = 1


@dataclass
class StaticOptions(BasicOptions):
    """Static synthesis options."""
    num_cp_gates: int = -1
    r: float = 0.00055
    accepted_num_cz_gates: int = -1

    def __post_init__(self):
        if self.num_cp_gates == -1:
            raise TypeError("Missing required argument 'num_cp_gates'")
        if self.accepted_num_cz_gates == -1:
            raise TypeError("Missing required argument 'accepted_num_cz_gates'")


# --------------------------------------------------------------------------
# Results
# --------------------------------------------------------------------------

@dataclass
class Results:
    """Persistent store of decompositions."""
    loss_function: Any
    layer: list
    label: str = ''
    decompositions: tuple = ()
    save_to: str = ''

    def __post_init__(self):
        if self.save_to == '':
            self.save_to = f'results/{self.label}'

    def save(self):
        os.makedirs(os.path.dirname(self.save_to) or '.', exist_ok=True)
        with open(self.save_to, 'wb') as f:
            pickle.dump(self, f)

    @staticmethod
    def load(path: str) -> 'Results':
        """Load results this package saved (pickle runs code on load: only
        load files you wrote)."""
        with open(path, 'rb') as f:
            return pickle.load(f)


# --------------------------------------------------------------------------
# Synthesize
# --------------------------------------------------------------------------

class Synthesize:
    """Automated synthesis of unitaries into CZ + 1q rotations.

    Args:
        layer: connectivity pairs, e.g. [[0,1],[1,2]].
        unitary_loss_func: a LossSpec.
        target_unitary: sets the loss to the HS-test distance to this matrix.
        target_state: sets the loss to 1 - |<target|U|0>|^2 (host side
            only for now: its device loss is ROADMAP A.4).
        label: name used for persistence.
        cp_regularization_func: per-angle CP penalty (default: piecewise
            linear with RegularizationOptions defaults).
        device: where the sweeps run, 'cpu' or 'cuda'.
    """

    def __init__(self, layer, unitary_loss_func=None, target_unitary=None,
                 target_state=None, label=None, cp_regularization_func=None,
                 *, device):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError('device is cuda, but no CUDA device is visible')
        self.layer = layer
        self.num_qubits = num_qubits_from_layer(layer)
        self.target_unitary = target_unitary

        if unitary_loss_func is not None:
            if isinstance(unitary_loss_func, LossSpec):
                self.unitary_loss_func = unitary_loss_func
            else:
                self.unitary_loss_func = LossSpec('custom',
                                                  fn=unitary_loss_func)
        elif target_unitary is not None:
            d = 2 ** self.num_qubits
            assert np.shape(target_unitary) == (d, d), \
                'Number of qubits in target unitary and layer do not match.'
            self.unitary_loss_func = LossSpec('hst', target=target_unitary)
        elif target_state is not None:
            d = 2 ** self.num_qubits
            assert np.shape(target_state) == (d,), \
                'Number of qubits in target state and layer do not match.'
            self.unitary_loss_func = LossSpec('state', target=target_state)
        else:
            raise AssertionError(
                'Neither unitary loss function nor target unitary/state is '
                'provided.')

        self.label = label
        self.cp_regularization_func = cp_regularization_func or \
            make_regularization_function(RegularizationOptions)
        self.stage_seconds: dict = {}  # wall time of each stage of the last run

    # -- internals ----------------------------------------------------------

    def _ansatz(self, options) -> Ansatz:
        return Ansatz(self.num_qubits, 'cp',
                      fill_layers(self.layer, options.num_cp_gates),
                      options.rotation_gates)

    def _objective(self, anz: Ansatz, options):
        return batched_sim.make_batched_regloss(
            self.num_qubits, 'cp', options.rotation_gates, anz.placements,
            self.unitary_loss_func, cp_mask=anz.cp_mask,
            regularization_func=self.cp_regularization_func, r=options.r)

    @staticmethod
    def _check_method(options):
        if options.method != 'adam':
            raise NotImplementedError(
                f'method {options.method!r} is not ported yet (ROADMAP A.10)')

    def _generate_raw(self, options, initial_angles_array=None
                      ) -> engine.RawResult:
        """Multi-start raw sampling stage with the [initial, best] contract.
        initial_angles_array: optional (num_samples, P) initial angles in
        place of the seeded draw."""
        self._check_method(options)
        anz = self._ansatz(options)
        if initial_angles_array is None:
            gen = torch.Generator(device=self.device).manual_seed(
                int(options.random_seed))
            inits = cand.generate_initial_angles_batch(
                gen, anz.num_angles, anz.cp_mask,
                cp_dist=options.cp_distribution,
                batch_size=options.num_samples, device=self.device)
        else:
            inits = torch.as_tensor(np.asarray(initial_angles_array),
                                    dtype=config.real_dtype,
                                    device=self.device)
        return engine.minimize_fused(
            self._objective(anz, options), inits,
            learning_rate=options.learning_rate,
            num_iterations=options.num_gd_iterations)

    def _raw_and_evaluate(self, options, initial_angles_array=None
                          ) -> cand.EvaluatedBatch:
        """Raw sampling + evaluation in one pass over the device."""
        self._check_method(options)
        anz = self._ansatz(options)
        return cand.run_raw_stage_fused(
            self._objective(anz, options), options.random_seed,
            options.num_samples, anz.num_angles, anz.cp_mask,
            cp_dist=options.cp_distribution, threshold=options.threshold_cp,
            learning_rate=options.learning_rate,
            num_iterations=options.num_gd_iterations, device=self.device,
            initial_angles=initial_angles_array)

    def _verify(self, anz: Ansatz, angles_batch: np.ndarray,
                options: BasicOptions) -> cand.VerifiedBatch:
        # pad the candidate count to buckets of 8 (repeating a row), as the
        # JAX package does to bound its compiled shapes; kept so both
        # packages verify the same batches
        angles_batch = np.asarray(angles_batch)
        c = len(angles_batch)
        cb = max(8, ((c + 7) // 8) * 8)
        if cb > c:
            pad = np.repeat(angles_batch[:1], cb - c, axis=0)
            angles_batch = np.concatenate([angles_batch, pad], axis=0)
        ver = cand.verify_candidates_batch(
            self.unitary_loss_func, anz, angles_batch,
            threshold_cp=options.threshold_cp,
            learning_rate=options.learning_rate_at_verification,
            num_iterations=options.num_gd_iterations_at_verification,
            target_loss=options.target_loss,
            num_segments=options.num_gd_segments, device=self.device)
        if cb > c:
            ver = cand.VerifiedBatch(*(np.asarray(f)[:c] for f in ver))
        return ver

    def _initialize_results(self, save_results, save_to) -> Results:
        results = Results(self.unitary_loss_func, self.layer, label=self.label)
        if save_results:
            assert self.label or save_to, \
                'To save results on disk either `label` or `save_to` must be ' \
                'provided. If you insist on not saving the results call the ' \
                'decomposition routine with `save_results=False` flag.'
            if save_to:
                results.save_to = save_to
            try:
                results = Results.load(results.save_to)
            except FileNotFoundError:
                pass
        return results

    def _make_decomposition(self, anz: Ansatz, best_angles,
                            static_options=None) -> Decomposition:
        d = Decomposition._from_cp_circuit(self.unitary_loss_func, anz,
                                           best_angles, self.label)
        d._static_options = static_options
        return d

    # -- static -------------------------------------------------------------

    def static(self, options: StaticOptions, save_results=True, save_to='',
               verbose=True, initial_angles_array=None) -> Results:
        """Fixed-template synthesis. initial_angles_array: optional
        (num_samples, P) initial angles in place of the seeded draw (to hold
        the port against the JAX package on the same inputs)."""
        def log(msg):
            if verbose:
                print(msg, flush=True)

        self.stage_seconds = {}
        results = self._initialize_results(save_results, save_to)
        log(f'\nSynthesis run starting; options:\n{options}')

        log('\nRunning the multi-start sampling stage...')
        start = time.perf_counter()
        ev = self._raw_and_evaluate(options, initial_angles_array)
        self.stage_seconds['sampling'] = time.perf_counter() - start

        log('\nFiltering candidates against the entry thresholds...')
        prospective = cand.filter_prospective(
            ev, threshold_cz_count=options.accepted_num_cz_gates,
            threshold_loss=options.entry_loss)

        successful: List[Decomposition] = []
        if len(prospective):
            log(f'\n{len(prospective)} candidates pass; verifying...')
            anz = self._ansatz(options)
            start = time.perf_counter()
            ver = self._verify(anz, ev.angles[prospective], options)
            self.stage_seconds['verification'] = time.perf_counter() - start
            start = time.perf_counter()
            for pos in range(len(prospective)):
                if ver.success[pos]:
                    successful.append(self._make_decomposition(
                        anz, ver.best_angles[pos], static_options=options))
            self.stage_seconds['decomposition'] = time.perf_counter() - start
            if successful:
                log(f'\n{len(successful)} verified; CZ counts:')
                log(sorted([d.cz_count for d in successful]))
                results.decompositions = list(results.decompositions) + \
                    successful
                if save_results:
                    results.save()
            else:
                log('\nNo candidate survived verification.')
        else:
            log('\nNo candidates passed the entry thresholds.')

        return results

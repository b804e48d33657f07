"""User-facing API of the port: Synthesize.static, Synthesize.adaptive and
what they return (counterpart of cpflow_tpu/api.py).

The public names, option dataclasses and their defaults follow the JAX
package. What differs:

  * ``Synthesize`` takes a ``device``, 'cuda' unless the caller asks for
    'cpu'. On a CUDA device every sweep (sampling, the adaptive search's
    bucketed stage, verification) runs hand-written kernels; on the CPU,
    their plain PyTorch version. There is no fallback from one to the
    other. The built-in losses, the HS test (``target_unitary``), state
    preparation (``target_state``) and the ``LossSpec`` kinds 'disc',
    'modulo_identity' and 'modulo_diagonal', run in the fused sweep kernel
    (kernels/sweep.py), with any rotation string of x, y, z; ``Ansatz``
    also takes the fixed 'cz' and 'cx' entanglers (the success-ratio
    protocol's template).
  * a custom loss, ``unitary_loss_func=<callable>`` or
    ``LossSpec('custom', fn=...)``, must be a **torch** callable of one
    (d, d) complex matrix returning a real scalar. It is vmapped over the
    restarts under autograd; on the card the unitary and its gradient come
    from the forward and vjp kernels of kernels/unitary.py. The host
    checks hand it a complex128 tensor.
  * ``StaticOptions.method`` other than 'adam' ('natural adam',
    'natural gd', 'hessian', 'angle by angle') runs the chains of
    optimize/engine.py on the same batched objective; ``Ansatz.learn``
    does too.
  * initial angles come from a ``torch.Generator`` seeded with
    ``random_seed``: the same seed gives other angles than the JAX
    package (optimize/candidates.py). The adaptive search's trial seeds
    and TPE suggestions are the JAX package's, bit for bit
    (search/seed_chain.py), so equal scores give equal (seed, k, r) streams.
  * ``parallel_trials`` puts the trials side by side on the restart axis of
    one sweep (the JAX package vmaps the stage over them).
  * ``Results`` persist with the standard library's pickle;
    ``params.trials_from_jax`` carries a JAX package's trials over.
  * ``Decomposition.refine`` runs on the host in float64 numpy, with the
    JAX package's signature and defaults (circuits/refine.py).
  * Not here yet: the device mesh (A.9). Not ported:
    ``AdaptiveOptions.unsafe_batch`` (a TPU memory guard).
"""

from __future__ import annotations

import math
import os
import pickle
import time
from dataclasses import asdict, dataclass
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from cpflow_tpu_torch import config
from cpflow_tpu_torch.circuits.ir import Circuit
from cpflow_tpu_torch.circuits.passes import convert_to_zxz, cp_to_cz_circuit
from cpflow_tpu_torch.circuits.refine import host_loss_adapter
from cpflow_tpu_torch.circuits.refine import refine as refine_circuit
from cpflow_tpu_torch.optimize import candidates as cand
from cpflow_tpu_torch.optimize import engine, unitary_learn
from cpflow_tpu_torch.ops import losses
from cpflow_tpu_torch.ops.penalty import make_regularization_function
from cpflow_tpu_torch.search import tpe
from cpflow_tpu_torch.search.seed_chain import next_seed
from cpflow_tpu_torch.sim import batched as batched_sim
from cpflow_tpu_torch.sim.ansatz_kernel import (block_matrix, build_unitary,
                                                cp_angle_indices,
                                                num_block_angles)
from cpflow_tpu_torch.topology import fill_layers, num_qubits_from_layer


# --------------------------------------------------------------------------
# Loss specifications
# --------------------------------------------------------------------------

class LossSpec:
    """Declarative unitary loss: 'hst', 'disc', 'state', 'modulo_identity'
    and 'modulo_diagonal' (these two with ``num_qubits`` and ``wires``),
    and 'custom', which wraps a torch callable ``fn`` of one unitary.
    Calling the spec evaluates it on a torch tensor; ``numpy`` evaluates
    the host loss of a float64 matrix."""

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

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        if self.kind == 'hst':
            return losses.cost_HST(u, self.target)
        if self.kind == 'disc':
            return losses.disc(u, self.target)
        if self.kind == 'state':
            return losses.state_prep_loss(u, self.target)
        if self.kind == 'modulo_identity':
            return losses.disc_modulo_identity(self.target, u,
                                               self.num_qubits, self.wires)
        if self.kind == 'modulo_diagonal':
            return losses.disc_modulo_diagonal(self.target, u,
                                               self.num_qubits, self.wires)
        return self.fn(u)

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
        if self.kind == 'modulo_identity':
            return float(losses.disc_modulo_identity(
                t, np.asarray(u), self.num_qubits, self.wires))
        if self.kind == 'modulo_diagonal':
            return float(losses.disc_modulo_diagonal(
                t, np.asarray(u), self.num_qubits, self.wires))
        if self.kind == 'custom':  # a torch callable: hand it a tensor
            return float(self.fn(torch.as_tensor(
                np.asarray(u), dtype=torch.complex128)))
        raise ValueError(f'unknown loss kind {self.kind!r}')

    def __getstate__(self):
        # Results persist with the standard library's pickle, which saves
        # a function by its module and name: a lambda or a local function
        # cannot be saved. Such a custom loss is left out of the saved
        # spec (fn None), so that a run with a label still saves its trials
        # and decompositions; a module-level function is saved as it is.
        state = self.__dict__.copy()
        if self.fn is not None:
            try:
                pickle.dumps(self.fn)
            except (pickle.PicklingError, AttributeError, TypeError):
                state['fn'] = None
        return state

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

    def learn(self, u_target, method='adam', learning_rate=0.1,
              target_loss=1e-7, keep_history=True, **kwargs):
        """Multi-start learning of a target unitary: unitary_learn on this
        ansatz as a batched objective, on the card (through the unitary
        kernels) unless called with device='cpu'."""
        return unitary_learn(self.unitary, u_target, self.num_angles,
                             method=method, learning_rate=learning_rate,
                             target_loss=target_loss,
                             keep_history=keep_history, ansatz=self, **kwargs)


# --------------------------------------------------------------------------
# Decomposition
# --------------------------------------------------------------------------

class Decomposition:
    """A found decomposition: circuit, host loss, CZ metrics, refinement
    to Rational and Clifford+T circuits."""

    def __init__(self, unitary_loss_func, circuit: Circuit, label: str = '',
                 type: str = 'Approximate'):
        self.unitary_loss_func = unitary_loss_func
        self.circuit = circuit
        self.unitary = circuit.unitary()
        self.label = label
        self.loss = host_loss_adapter(unitary_loss_func)(self.unitary)
        self.type = type
        self.cz_count = circuit.gates_count(['cz'])
        self.cz_depth = circuit.gates_depth(['cz'])
        self.t_count = None
        self.t_depth = None

        self._cp_data = None
        self._static_options = None
        self._adaptive_options = None
        self._decomposer = None

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

    def refine(self, max_denominator=32, angle_threshold=0.01,
               cp_threshold=0.01, reduce_threshold=1e-5,
               recursion_degree=0, recursion_depth=5):
        """Simplify angles, rationalize, Clifford+T (host, float64)."""
        qc, refine_type, t_count, t_depth = refine_circuit(
            self.circuit, self.unitary_loss_func,
            max_denominator=max_denominator,
            angle_threshold=angle_threshold, cp_threshold=cp_threshold,
            reduce_threshold=reduce_threshold,
            recursion_degree=recursion_degree,
            recursion_depth=recursion_depth)

        self.type = refine_type
        self.circuit = qc
        self.unitary = qc.unitary()
        self.loss = host_loss_adapter(self.unitary_loss_func)(self.unitary)
        self.cz_count = qc.gates_count(['cz'])
        self.cz_depth = qc.gates_depth(['cz'])
        if refine_type == 'Clifford+T':
            self.t_count = t_count
            self.t_depth = t_depth
        return f'Refined to {refine_type}'

    def __repr__(self):
        description = (
            f"< {self.label}| {self.type} | loss: {self.loss}  "
            f"| CZ count: {self.cz_count} | CZ depth: {self.cz_depth}  >")
        if self.type == 'Clifford+T':
            description = (description[:-1] + f'| T count: {self.t_count} '
                           f'| T depth: {self.t_depth} >')
        return description


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


@dataclass
class AdaptiveOptions(BasicOptions):
    """Adaptive synthesis options: TPE over the template length
    num_cp_gates in [min_num_cp_gates, max_num_cp_gates] and the penalty
    weight r ~ lognormal(log r_mean, r_variance).

    bucketed=True runs every trial on one template padded to
    max_num_cp_gates, a shorter template's tail blocks frozen at identity
    by the gradient mask, r given per restart. parallel_trials > 1 runs
    that many TPE suggestions as one sweep (constant-liar batching:
    suggestions after the first see provisional trials at the mean
    observed score); it always takes the bucketed stage."""
    min_num_cp_gates: int = -1
    max_num_cp_gates: int = -1
    r_mean: float = 0.00055
    r_variance: float = 0.5
    max_evals: int = 100
    target_num_cz_gates: int = 0
    stop_if_target_reached: bool = False
    keep_logs: bool = False
    bucketed: bool = False
    parallel_trials: int = 1

    def __post_init__(self):
        if self.min_num_cp_gates == -1:
            raise TypeError("Missing required argument 'min_num_cp_gates'")
        if self.max_num_cp_gates == -1:
            raise TypeError("Missing required argument 'max_num_cp_gates'")
        if self.bucketed and self.method != 'adam':
            import warnings
            warnings.warn(
                f"bucketed=True always runs the fused Adam sweep; "
                f"method={self.method!r} is ignored in the raw stage "
                f"(set bucketed=False to honor it)", stacklevel=2)

    def get_static(self, num_cp_gates, r) -> StaticOptions:
        default_static = asdict(BasicOptions())
        basic = {k: v for k, v in asdict(self).items() if k in default_static}
        basic['num_cp_gates'] = num_cp_gates
        basic['r'] = r
        # adaptive trials filter on entry_loss only; any CZ count may enter
        basic['accepted_num_cz_gates'] = np.iinfo(np.int32).max
        return StaticOptions(**basic)


# --------------------------------------------------------------------------
# Results
# --------------------------------------------------------------------------

@dataclass
class Results:
    """Persistent store of trials and decompositions."""
    loss_function: Any
    layer: list
    label: str = ''
    trials: Any = None
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

    def best_hyperparameters(self) -> List[List]:
        """[num_cp_gates, r] pairs ordered by increasing score."""
        results = sorted(self.trials.results, key=lambda res: res['loss'])
        return [[res['num_cp_gates'], res['r']] for res in results]

    def plot_trials(self):
        """(k, r) -> score scatter (needs matplotlib)."""
        import matplotlib.pyplot as plt
        results = self.trials.results
        num = np.array([res['num_cp_gates'] for res in results], dtype=float)
        r = np.array([res['r'] for res in results], dtype=float)
        loss = np.array([res['loss'] for res in results], dtype=float)

        finite = np.isfinite(loss)
        n_best, r_best = self.best_hyperparameters()[0]

        plt.scatter(num[finite], r[finite], c=loss[finite], cmap='jet',
                    edgecolors='black')
        plt.colorbar()
        plt.scatter(num[~finite], r[~finite], marker='x', color='red')
        plt.scatter([n_best], [r_best], marker='*', facecolors='gold',
                    edgecolors='black', s=[250])
        plt.xlabel('Number of CP gates')
        plt.ylabel('r: regularization weight')
        plt.title('Score')


# --------------------------------------------------------------------------
# Synthesize
# --------------------------------------------------------------------------

class Synthesize:
    """Automated synthesis of unitaries into CZ + 1q rotations.

    Args:
        layer: connectivity pairs, e.g. [[0,1],[1,2]].
        unitary_loss_func: a LossSpec, or a torch callable of one (d, d)
            complex matrix returning a real scalar (a custom loss).
        target_unitary: sets the loss to the HS-test distance to this matrix.
        target_state: sets the loss to 1 - |<target|U|0>|^2; the sweeps
            then build only the |0...0> column of U.
        label: name used for persistence.
        cp_regularization_func: per-angle CP penalty (default: piecewise
            linear with RegularizationOptions defaults).
        device: where the sweeps run, 'cuda' (the default) or 'cpu'.
    """

    def __init__(self, layer, unitary_loss_func=None, target_unitary=None,
                 target_state=None, label=None, cp_regularization_func=None,
                 *, device='cuda'):
        self.device = config.resolve_device(device=device)
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

    def __getstate__(self):
        # the bucketed stage's cache is rebuilt on next use
        state = self.__dict__.copy()
        state.pop('_stage_cache', None)
        return state

    # -- internals ----------------------------------------------------------

    def _ansatz(self, options) -> Ansatz:
        return Ansatz(self.num_qubits, 'cp',
                      fill_layers(self.layer, options.num_cp_gates),
                      options.rotation_gates)

    def _objective(self, anz: Ansatz, r):
        return batched_sim.make_batched_regloss(
            self.num_qubits, 'cp', anz.rotation_gates, anz.placements,
            self.unitary_loss_func, cp_mask=anz.cp_mask,
            regularization_func=self.cp_regularization_func, r=r)

    def _loss_and_reg(self, anz: Ansatz, options):
        """The objective's two parts as per-chain callables of (P,)
        angles, differentiated as they are (the sweeps use the batched
        objective of _objective instead)."""
        loss_func = lambda angles: self.unitary_loss_func(anz.unitary(angles))
        reg_func = lambda angs: options.r * self.cp_regularization_func(
            angs * torch.as_tensor(anz.cp_mask, dtype=angs.dtype,
                                   device=angs.device)).sum()
        return loss_func, reg_func

    @staticmethod
    def _plot_raw(res):
        """Plot the regloss, loss and reg learning curves of one restart
        (needs keep_history=True histories and matplotlib)."""
        import matplotlib.pyplot as plt
        for name in ('regloss', 'loss', 'reg'):
            plt.plot(torch.as_tensor(res[name]).cpu().numpy(), label=name)
        plt.yscale('log')
        plt.legend()

    def _generate_raw(self, options, initial_angles_array=None,
                      keep_history=False) -> engine.RawResult:
        """Multi-start raw sampling stage. initial_angles_array: optional
        (num_samples, P) initial angles in place of the seeded draw.

        Method 'adam' takes the fused sweep ([initial, best], or every
        step with keep_history); any other method takes the engine's
        chains (preconditioned, or coordinate descent) on the same batched
        objective, whose unitary comes from the unitary kernels on the
        card."""
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
        objective = self._objective(anz, options.r)
        if options.method == 'adam':
            return engine.minimize_fused(
                objective, inits, learning_rate=options.learning_rate,
                num_iterations=options.num_gd_iterations,
                keep_history=keep_history)
        return engine.minimize_multistart(
            objective, inits, method=options.method,
            learning_rate=options.learning_rate,
            num_iterations=options.num_gd_iterations,
            keep_history=keep_history, u_func=anz.unitary)

    def _raw_and_evaluate(self, options, initial_angles_array=None
                          ) -> cand.EvaluatedBatch:
        """Raw sampling + evaluation in one pass over the device."""
        anz = self._ansatz(options)
        if options.method != 'adam':
            raw = self._generate_raw(options, initial_angles_array)
            return cand.evaluate_raw_batch(raw, anz.cp_mask,
                                           threshold=options.threshold_cp)
        return cand.run_raw_stage_fused(
            self._objective(anz, options.r), options.random_seed,
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
            threshold_cp=options.threshold_cp, method=options.method,
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
                            static_options=None, adaptive_options=None
                            ) -> Decomposition:
        d = Decomposition._from_cp_circuit(self.unitary_loss_func, anz,
                                           best_angles, self.label)
        d._static_options = static_options
        d._adaptive_options = adaptive_options
        d._decomposer = self
        return d

    def _bucketed_stage(self, options):
        """The padded template of the bucketed stage, cached on the
        instance: (objective, ansatz) at max_num_cp_gates. Every (k, r)
        trial runs on it, k through the gradient mask, r per restart."""
        key = (options.max_num_cp_gates, options.rotation_gates)
        cache = getattr(self, '_stage_cache', None)
        if cache is None:
            cache = self._stage_cache = {}
        if key not in cache:
            anz = Ansatz(self.num_qubits, 'cp',
                         fill_layers(self.layer, options.max_num_cp_gates),
                         options.rotation_gates)
            cache[key] = (self._objective(anz, 0.0), anz)
        return cache[key]

    def _staged_run(self, options):
        """run(seeds, rs, actives) -> (cz (N, S), loss (N, S),
        angles (N, S, P)): N trials of the bucketed stage in one sweep,
        chaining options.num_gd_segments sweeps, each resuming from the
        previous one's best angles with fresh Adam moments. It always runs
        Adam, whatever options.method says (AdaptiveOptions warns)."""
        objective, anz = self._bucketed_stage(options)
        segments = max(1, int(options.num_gd_segments or 1))

        def run(seeds, rs, actives):
            kw = dict(cp_dist=options.cp_distribution,
                      threshold=options.threshold_cp,
                      learning_rate=options.learning_rate,
                      num_iterations=options.num_gd_iterations,
                      device=self.device)
            out = cand.run_bucketed_stage(objective, seeds, rs, actives,
                                          options.num_samples, anz.cp_mask,
                                          **kw)
            for _ in range(segments - 1):
                out = cand.run_bucketed_stage(
                    objective, seeds, rs, actives, options.num_samples,
                    anz.cp_mask, params_in=out[2], **kw)
            return out

        return run, anz

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

    # -- adaptive -----------------------------------------------------------

    def adaptive(self, options: AdaptiveOptions, save_results=True,
                 save_to='', verbose=True) -> Results:
        """TPE-adaptive synthesis over (num_cp_gates, r).

        Each trial samples num_samples restarts at its (k, r) and scores
        the CZ counts of the candidates under entry_loss; candidates that
        beat the best verified CZ count so far are verified, and the first
        success is kept. Trials and decompositions are saved after each
        trial; a run finding saved trials resumes from them.
        stage_seconds sums, over the trials, the sampling, TPE,
        verification and decomposition time."""
        def log(msg):
            if verbose:
                print(msg, flush=True)

        log(f'\nSynthesis run starting; options:\n{options}')
        self.stage_seconds = dict.fromkeys(
            ('sampling', 'tpe', 'verification', 'decomposition'), 0.0)

        def timed(stage, fn, *args):
            start = time.perf_counter()
            out = fn(*args)
            self.stage_seconds[stage] += time.perf_counter() - start
            return out

        space = [
            tpe.QUniformInt('num_cp_gates', options.min_num_cp_gates,
                            options.max_num_cp_gates, 1),
            tpe.LogNormal('r', math.log(options.r_mean), options.r_variance),
        ]

        results = self._initialize_results(save_results, save_to)
        if results.trials is not None:
            log('\nExisting trials found on disk - resuming.')
            trials = results.trials
            random_seed = trials.results[-1]['random_seed']
            num_existing = len(trials.results)
        else:
            trials = tpe.Trials()
            random_seed = options.random_seed
            num_existing = 0

        if results.decompositions:
            scoreboard = sorted(set(d.cz_count for d in results.decompositions))
        else:
            scoreboard = [losses.theoretical_lower_bound(self.num_qubits)]

        if num_existing >= options.max_evals:
            log('Evaluation budget already exhausted.')

        def result_from_ev(ev, random_seed, num_cp_gates, r):
            prospective = cand.filter_prospective(
                ev, threshold_cz_count=float('inf'),
                threshold_loss=options.entry_loss)
            cz_counts = [int(ev.cz[i]) for i in prospective]

            # score: soft-min of the CZ counts, per sample (num_samples, so
            # that trials resumed elsewhere score on the same scale), log2
            score_val = np.sum(2.0 ** (-np.array(cz_counts, dtype=np.float64)))
            with np.errstate(divide='ignore'):
                score = float(np.log2(score_val / options.num_samples))
            min_raw_loss = float(np.nanmin(ev.loss)) if np.size(ev.loss) \
                else float('inf')
            if not cz_counts:
                # graded score of a trial with no prospective: ranked by how
                # close its best restart came, 1000 above any real score
                # (those are <= max_cz + log2(num_samples)), so that TPE
                # still learns from a hard target's empty trials
                score = -(1000.0 + 10.0 * math.log10(
                    max(min_raw_loss, 1e-12))) \
                    if math.isfinite(min_raw_loss) else -float('inf')

            log(f'score: {-score}, cz counts of prospective results: '
                f'{cz_counts}')

            return_dict = {
                'loss': -score,
                'status': 'ok',
                'random_seed': random_seed,
                'cz_counts': cz_counts,
                'min_raw_loss': min_raw_loss,
                'num_cp_gates': num_cp_gates,
                'r': r,
                'layer': self.layer,
                'prospective_decompositions':
                    [[int(ev.cz[i]), ev.angles[i]] for i in prospective],
            }
            if options.keep_logs:
                return_dict['attachments'] = {
                    'prospective_decompositions':
                        pickle.dumps(return_dict['prospective_decompositions']),
                    'static_options':
                        pickle.dumps(options.get_static(num_cp_gates, r)),
                    'unitary_loss_func': pickle.dumps(self.unitary_loss_func)}
            return return_dict

        def evaluate(suggestions):
            """One result dict per (seed, (k, r)) suggestion. A single
            unbucketed trial takes the static sampling stage at its own k;
            otherwise every suggestion runs in one bucketed sweep."""
            if len(suggestions) == 1 and not options.bucketed:
                seed, values = suggestions[0]
                num_cp_gates, r = int(values[0]), float(values[1])
                log(f'\nnum_cp_gates: {num_cp_gates}, r: {r}')
                static_options = options.get_static(num_cp_gates, r)
                static_options.random_seed = seed
                ev = timed('sampling', self._raw_and_evaluate, static_options)
                return [result_from_ev(ev, seed, num_cp_gates, r)]

            run, anz_max = self._staged_run(options)
            actives = np.zeros((len(suggestions), anz_max.num_angles),
                               dtype=np.float32)
            p_ks = []
            for j, (_, values) in enumerate(suggestions):
                p_k = 3 * self.num_qubits + \
                    int(values[0]) * anz_max.num_block_angles
                actives[j, :p_k] = 1.0
                p_ks.append(p_k)
            czs, lss, angs = timed(
                'sampling', run, [seed for seed, _ in suggestions],
                [float(values[1]) for _, values in suggestions], actives)
            out = []
            for j, (seed, values) in enumerate(suggestions):
                num_cp_gates, r = int(values[0]), float(values[1])
                log(f'\nnum_cp_gates: {num_cp_gates}, r: {r}')
                ev = cand.EvaluatedBatch(cz=czs[j], loss=lss[j],
                                         angles=angs[j][:, :p_ks[j]])
                out.append(result_from_ev(ev, seed, num_cp_gates, r))
            return out

        def suggest(step):
            """`step` suggestions; the seed chain runs on sequentially, so
            the trial stream equals the sequential mode's and resume works
            unchanged."""
            nonlocal random_seed
            suggestions = []
            if step > 1:
                # constant liar: later suggestions see provisional results
                # at the mean observed score, keeping the batch diverse
                lie_trials = tpe.Trials()
                lie_trials.vals = list(trials.vals)
                lie_trials.results = list(trials.results)
                lie = (float(np.mean([res['loss'] for res in trials.results]))
                       if trials.results else 0.0)
            for _ in range(step):
                random_seed = next_seed(random_seed)
                rng = np.random.default_rng(random_seed)
                values = tpe.suggest(space, trials if step == 1
                                     else lie_trials, rng)
                if step > 1:
                    lie_trials.record(values, {
                        'loss': lie, 'status': 'ok',
                        'num_cp_gates': int(values[0]),
                        'r': float(values[1]),
                        'random_seed': random_seed, 'cz_counts': []})
                suggestions.append((random_seed, values))
            return suggestions

        def verify(last):
            """Verify the trial's candidates that beat the scoreboard; keep
            the first success. Returns whether one was found."""
            num_cp_gates, r = last['num_cp_gates'], last['r']
            to_verify = [[cz, angles] for cz, angles
                         in last['prospective_decompositions']
                         if cz < scoreboard[0]]
            if not options.keep_logs:
                last.pop('prospective_decompositions')
            if not to_verify:
                log(f'\nNo candidate beats the current best CZ count '
                    f'{scoreboard[0]}.')
                return False
            log(f'\n{len(to_verify)} candidates beat the current best CZ '
                f'count {scoreboard[0]}; verifying...')
            static_options = options.get_static(num_cp_gates, r)
            anz = self._ansatz(static_options)
            ver = timed('verification', self._verify, anz,
                        np.stack([a for _, a in to_verify]), options)
            for pos in range(len(to_verify)):
                if ver.success[pos]:
                    num_cz = int(ver.cz[pos])
                    log(f'\nNew verified decomposition: {num_cz} CZ gates.')
                    scoreboard.insert(0, num_cz)
                    d = timed('decomposition', self._make_decomposition, anz,
                              ver.best_angles[pos], static_options, options)
                    results.decompositions = \
                        list(results.decompositions) + [d]
                    if save_results:
                        results.save()
                    return True
            log('\nNone of the candidates survived verification.')
            return False

        n_par = max(1, int(options.parallel_trials or 1))
        pbar = None
        if verbose:
            try:
                from tqdm.auto import tqdm
                pbar = tqdm(desc='Evaluations', initial=num_existing,
                            total=options.max_evals)
            except ImportError:
                pass
        i = num_existing
        stop = False
        while i < options.max_evals and not stop:
            step = min(n_par, options.max_evals - i)
            log('\n' + '-' * 42)
            log(f'iteration {i}/{options.max_evals}'
                + (f' ({step} parallel trials)' if step > 1 else ''))
            suggestions = timed('tpe', suggest, step)
            for (_, values), result in zip(suggestions, evaluate(suggestions)):
                trials.record(values, result)
                results.trials = trials
                if save_results:
                    results.save()
                verify(trials.results[-1])
                if options.stop_if_target_reached and \
                        scoreboard[0] <= options.target_num_cz_gates:
                    log('\nTarget CZ count reached - stopping early.')
                    stop = True
                    break
            i += step
            if pbar is not None:
                pbar.update(step)
        if pbar is not None:
            pbar.close()
        return results

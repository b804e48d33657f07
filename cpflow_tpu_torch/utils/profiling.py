"""Profiling, throughput and the H100 roofline of the port's kernels
(counterpart of cpflow_tpu/utils/profiling.py).

  * ``trace(logdir)``: torch.profiler around the enclosed block, its Chrome
    trace written into ``logdir`` (the JAX package uses jax.profiler);
  * ``Throughput``: restart-iterations per second over timed sections,
    each section synchronising the card at both ends (the device it is
    given, else the current CUDA device);
  * the work and the bound of the hand-written kernels on an H100:
    ``sweep_work`` and ``bound_ms`` for the fused sweep (csrc/sweep.cu),
    ``unitary_work`` and ``unitary_bound_ms`` for the forward and vjp
    kernels (csrc/unitary.cu), and ``roofline_model``, the sweep's model
    per restart-iteration under the JAX function's name.

The bound of a kernel is the larger of two times: the operations its
algorithm needs over the card's rate outside the tensor cores for their
type (float32, or float64 for the double builds), and the bytes it must
move (each input read once, each output written once) over the card's
memory rate. Every function of the work and the bound takes the dtype of
the build (``dtype``, float32 by default): float64 halves the peak rate
and doubles every real and complex byte.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import List

# H100 SXM5 (80 GB HBM3), NVIDIA's published rates for the card at its
# 700 W board power (H100 datasheet): 67 TFLOP/s float32 and 34 TFLOP/s
# float64 outside the tensor cores (the data sheet's "FP64"; its 67 TFLOP/s
# "FP64 Tensor Core" takes matrix products the kernels do not make), 3.35
# TB/s of HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_F64 = 34e12
PEAK_BYTES = 3.35e12


def precision(dtype='float32'):
    """(bytes of one real, peak operations per second) of float32 or
    float64, given as a torch dtype or its name."""
    name = str(dtype).replace('torch.', '')
    if name == 'float32':
        return 4, PEAK_F32
    if name == 'float64':
        return 8, PEAK_F64
    raise ValueError(f'the kernels build in float32 or float64, not {dtype}')


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block (the card's
    kernels too where a CUDA device is visible) and write it to
    ``logdir/trace.json`` (Chrome trace format). Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


def _synchronize(device) -> None:
    """Wait for the work queued on `device`; with no device, for the current
    CUDA device's work where CUDA is in use in this process."""
    import torch
    if device is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    elif torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


@dataclass
class Throughput:
    """Accumulates (restarts x iterations, seconds) across timed sections."""
    restart_iterations: float = 0.0
    seconds: float = 0.0
    sections: List[dict] = field(default_factory=list)

    @contextlib.contextmanager
    def section(self, num_restarts: int, num_iterations: int,
                label: str = '', device=None):
        """Time the enclosed block on the host clock. The card is
        synchronised before the clock is read at both ends, so that the
        section holds the work queued inside it: `device` if it is a CUDA
        device, the current CUDA device if it is None and CUDA is in use,
        nothing if it is the CPU."""
        _synchronize(device)
        t0 = time.perf_counter()
        yield
        _synchronize(device)
        dt = time.perf_counter() - t0
        work = float(num_restarts) * float(num_iterations)
        self.restart_iterations += work
        self.seconds += dt
        self.sections.append({'label': label, 'restart_iterations': work,
                              'seconds': dt,
                              'rate': work / dt if dt > 0 else float('inf')})

    @property
    def rate(self) -> float:
        return self.restart_iterations / self.seconds if self.seconds else 0.0

    def report(self) -> str:
        lines = [f'total: {self.restart_iterations:.3g} restart-iters in '
                 f'{self.seconds:.2f}s = {self.rate:.3g} restart-iter/s']
        for s in self.sections:
            lines.append(f"  [{s['label']}] {s['restart_iterations']:.3g} in "
                         f"{s['seconds']:.2f}s = {s['rate']:.3g}/s")
        return '\n'.join(lines)


# --------------------------------------------------------------------------
# The work and the bound of the kernels
# --------------------------------------------------------------------------

# operations of one restart-iteration (a complex product 6, a
# complex sum 2, a sine or cosine 1). `needed` is what the sweep's
# algorithm needs, the numerator of its bound:
#  - per amplitude of the d x C state: a 1q gate's forward pass 14 and its
#    adjoint step 44 (rewinding A by G^dag, pulling M back by G^T, summing
#    the gate's cotangent), a 2q gate's 30 and 92; the surface round, from
#    the identity (or e_0), leaves a product state, one complex multiply an
#    amplitude (6), and its gates' cotangents are the contraction of M
#    with that product state leaving one qubit out, two complex
#    multiply-adds an amplitude (16: the two halves of the bits contracted
#    against the other half's factors, as csrc/rows.cuh's surface_contract
#    does), 22 in all where n gate passes and n adjoint steps take 58 n;
#  - the loss with its cotangent: 14 per amplitude (hst, disc, state); for
#    the modulo losses 26 per entry on the blocks, 5 per entry off them and
#    6 per row;
#  - the cosine and sine of every angle (or half angle), 3 per angle;
#  - a block of m rotation letters in factored 2x2 form (sim/adjoint.py):
#    the up and down legs' 2(m - 1) products (112(m - 1)), their Kronecker
#    product (96), the legs' cotangents from the 4x4 cotangent (256) and
#    U Y^T, D Y^T (112), and down each leg a conjugation R^dag V R (51) and
#    a trace per letter (102(m - 1) + 2m): 214(m - 1) + 464 + 2m; CP adds
#    109 (its phase column in the build and the pullback, its angle
#    gradient), CZ 16 (sign flips), CX nothing (a permutation);
#  - a surface gate Rz Rx Rz: its build (112), G Gbar^T (56) and the walk
#    down its three letters (105), 273;
#  - Adam with the gradient mask, 15 per angle; the penalty's value and
#    slope, 22 per CP angle.
# `executed` counts csrc/sweep.cu's loops as they stand. Beyond `needed`
# the kernel runs the surface round as n gate passes and n adjoint steps
# (58 n an amplitude), the gradient pass rebuilds both legs of every block
# from the stored cos and sin (112(m - 1) a block), and the kernel
# computes the penalty of every angle (masked by cp_mask) in the
# evaluation and again in the Adam pass (2 x 22 per angle). Both count
# one restart-iteration once, whatever the design: the blocks of a
# cluster, and the column tiles past it, each build the restart's gates
# again, which neither counts, so that a bound means the same for every
# design.
def sweep_work(n, nb, rot='xyz', ent='cp', kind='hst', num_wires=None,
               dtype='float32'):
    """dict(P angles, target entries, needed and executed operations of one
    restart-iteration, and real_bytes and peak of the build's dtype) of a
    sweep."""
    from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
    d, m = 2 ** n, len(rot)
    P = 3 * n + num_block_angles(ent, rot) * nb
    amps = d if kind == 'state' else d * d
    common = amps * 122 * nb
    if kind.startswith('modulo'):
        on = d * 2 ** (n - num_wires)          # entries on the blocks
        common += 26 * on + 5 * (amps - on) + 6 * d
    else:
        common += 14 * amps
    common += 273 * n + (214 * max(m - 1, 0) + 464 + 2 * m + {
        'cp': 109, 'cz': 16, 'cx': 0}[ent]) * nb + 18 * P
    needed = common + 22 * amps + 22 * nb * (ent == 'cp')
    executed = common + 58 * n * amps + 112 * max(m - 1, 0) * nb + 44 * P
    real_bytes, peak = precision(dtype)
    return dict(P=P, target=amps, needed=needed, executed=executed,
                real_bytes=real_bytes, peak=peak)


def bound_ms(work, B, T):
    """(least time in ms, 'operations' or 'bytes') for a sweep of B restarts
    over T steps of sweep_work's `work`: its needed operations over the
    peak of its dtype, or the bytes it must move (initial angles, mask,
    target and r read, best angles and summary written) over the memory
    rate, whichever is larger."""
    P, rb = work['P'], work['real_bytes']
    nbytes = rb * (3 * P * B + 5 * B + P) + 2 * rb * work['target']
    t_ops = work['needed'] * B * T / work['peak'] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


# operations of one forward pass and of one adjoint walk of the
# ansatz, with sweep_work's terms: per amplitude of the d x C state a 1q
# gate costs 14 forwards and 44 in the walk, a 2q gate 30 and 92; the cos and
# sin of every angle 3; a surface gate's build 112 and its gradients 161; a
# block's build 112(m - 1) + 96 (+ 24 for CP's phase column, 4 for CZ's
# signs) and its gradients 368 + 102(m - 1) + 2m (+ 85 for CP, 12 for CZ).
# The forward pass needs no gate pass for the surface round: on the
# identity's columns (or on e_0) it leaves a product state, the Kronecker
# product of the surface gates (of their first columns), which takes one
# complex multiply (6) an amplitude once each half's factors are made. Nor
# does the walk: the surface gates' cotangents are the contraction of M
# with that product state leaving one qubit out, two complex multiply-adds
# an amplitude (16) once each half's factors are made, as sweep_work
# counts it and csrc/rows.cuh's surface_contract does it. The walk needs
# the gates too, so it builds them again; it also halves and conjugates
# the cotangent (2 per amplitude). `gates` is the gates' part alone (the
# cos and sin, the builds), once a restart: the global row tiles'
# prologue.
def unitary_work(n, nb, rot='xyz', ent='cp', log_c=None, dtype='float32'):
    """dict(P, amplitudes, forward and vjp operations of one restart,
    the gates' operations alone, forward and vjp bytes of one restart in
    `dtype`) of the unitary kernels."""
    from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
    m = len(rot)
    P = 3 * n + num_block_angles(ent, rot) * nb
    amps = 2 ** (n + (n if log_c is None else log_c))
    gates = 3 * P + 112 * n + (112 * max(m - 1, 0) + 96 + {
        'cp': 24, 'cz': 4, 'cx': 0}[ent]) * nb
    forward = amps * (6 + 30 * nb) + gates
    vjp = gates + amps * (16 + 92 * nb + 2) + 161 * n + (
        368 + 102 * max(m - 1, 0) + 2 * m + {'cp': 85, 'cz': 12, 'cx': 0}[ent]
    ) * nb
    rb = precision(dtype)[0]
    return dict(P=P, amps=amps, forward=forward, vjp=vjp, gates=gates,
                forward_bytes=rb * P + 2 * rb * amps,
                vjp_bytes=2 * rb * P + 4 * rb * amps)


def unitary_bound_ms(ops, nbytes, B, dtype='float32'):
    """(least time in ms, 'operations' or 'bytes') of B restarts in the
    build of `dtype`."""
    t_ops = ops * B / precision(dtype)[1] * 1e3
    t_bytes = nbytes * B / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def roofline_model(num_qubits: int, num_cp_gates: int,
                   rotation_gates: str = 'xyz', kind: str = 'hst',
                   reversible: bool = True, num_wires=None,
                   dtype='float32') -> dict:
    """The fused sweep kernel's work per restart-iteration at the CP
    template of `num_cp_gates` blocks, and its H100 bound.

    Modelled on the port's kernel (sweep_work), not on the JAX package's
    XLA fusions: the JAX model counts an HBM round trip of the whole state
    for every gate application, because each of its fusions ends there,
    while the kernel keeps a restart's state and cotangent in shared memory
    from the first step to the last and reads and writes HBM only at the
    ends of a sweep. So ``hbm_bytes`` here is what one restart's sweep must
    move, whatever its length: its angles read (initial angles and the
    gradient mask), its r, its best angles and summary written, and the
    shared target and CP mask counted once (a sweep of B restarts moves
    B times the first part). Its operations are those the algorithm needs
    (``flops``) and those the kernel's loops execute
    (``executed_flops``); they differ from the JAX model's ``flops``, which
    counts 4x4 gate products the factored algebra does not make, so the
    two are not to be compared. The backward pass is always the reversible
    adjoint walk (the state rewound by each gate's inverse, nothing
    stored); reversible=False, a stored tape, is no mode of the kernel and
    raises. kind: 'hst', 'disc', 'state', 'modulo_identity' or
    'modulo_diagonal' (num_wires: the wires of a modulo loss, default
    all). dtype: the build, float32 or float64 (the double build's bound
    divides by the float64 peak and counts 8-byte reals).

    Returns {'flops', 'executed_flops', 'hbm_bytes', 'num_angles',
    'bound_ms_per_restart_iteration', 'bound_by'}; the bound is of one
    restart-iteration of a long sweep, where the operations decide."""
    if not reversible:
        raise ValueError('the sweep kernel always walks back reversibly; '
                         'it has no stored-tape mode to model')
    if kind.startswith('modulo') and num_wires is None:
        num_wires = num_qubits
    work = sweep_work(num_qubits, num_cp_gates, rotation_gates, 'cp', kind,
                      num_wires, dtype)
    P, rb = work['P'], work['real_bytes']
    per_restart_bytes = rb * (3 * P + 5)
    shared_bytes = rb * P + 2 * rb * work['target']
    t_ops = work['needed'] / work['peak'] * 1e3
    return {'flops': work['needed'], 'executed_flops': work['executed'],
            'hbm_bytes': per_restart_bytes + shared_bytes, 'num_angles': P,
            'bound_ms_per_restart_iteration': t_ops,
            'bound_by': 'operations'}

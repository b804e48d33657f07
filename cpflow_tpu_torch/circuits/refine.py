"""Refinement of approximate circuits: Approximate -> Rational -> Clifford+T.

Parity target: reference cpflow/exact_decompositions.py:77-344. The greedy
1q-angle elimination (reduce_all_1q_angles) keeps the reference's exact
decision order — zero the leading angle if the loss stays below threshold,
else merge it into a later rotation on the same wire with either sign — but
evaluates every probe on the host in float64 numpy instead of dispatching one
jitted device call per probe (the reference's chatty host<->device pattern).
A 2^n x 2^n gate-chain eval at n<=6 is microseconds on host.

Each stage is guarded by check_approximation / check_loss; a ValueError rolls
the result back to the previous stage (refine state machine,
exact_decompositions.py:293-344).

Counterpart of cpflow_tpu/circuits/refine.py. Everything is host numpy but
``lasso_angles`` (the L1-regularized re-optimization), which optimizes with
the engine's ``mynimize_repeated`` and imports torch when called.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np

from cpflow_tpu_torch.circuits.clifford_t import solovay_kitaev
from cpflow_tpu_torch.circuits.ir import Circuit
from cpflow_tpu_torch.circuits.passes import (all_rgates_are_rational,
                                        check_approximation, check_loss,
                                        cp_to_cz_circuit, convert_to_zxz,
                                        rationalize_all_rgates,
                                        remove_zero_rgates)


def _bracket(a: float) -> float:
    return ((a + math.pi) % (2 * math.pi)) - math.pi


def host_loss_adapter(unitary_loss_func) -> Callable[[np.ndarray], float]:
    """Make a unitary loss callable cheaply on host numpy matrices.

    LossSpec objects (cpflow_tpu_torch.api) expose .numpy; any other callable
    is invoked directly on the float64 numpy matrix.
    """
    np_fn = getattr(unitary_loss_func, 'numpy', None)
    if np_fn is not None:
        return lambda u: float(np_fn(u))
    return lambda u: float(unitary_loss_func(u))


# --------------------------------------------------------------------------
# Greedy 1q-angle reduction
# --------------------------------------------------------------------------

def reduce_all_1q_angles(loss_of_angles: Callable[[np.ndarray], float],
                         initial_angles: np.ndarray,
                         wires: List[int],
                         threshold: float = 1e-5) -> np.ndarray:
    """Greedy elimination of rotation angles (reference
    exact_decompositions.py:77-113, iterative instead of recursive).

    For each angle position i (left to right): try setting it to zero; if the
    loss stays under `threshold`, commit. Otherwise try, for each later
    rotation j>i on the same wire, folding angle i into j with either sign.
    Earlier decisions condition later ones exactly as in the reference.
    """
    angles = np.array(initial_angles, dtype=float)
    num = len(angles)
    for i in range(num):
        trial = angles.copy()
        trial[i] = 0.0
        if loss_of_angles(trial) < threshold:
            angles = trial
            continue
        for j in range(i + 1, num):
            if wires[j] != wires[i]:
                continue
            done = False
            for sign in (-1.0, 1.0):
                trial = angles.copy()
                trial[j] = angles[j] + sign * angles[i]
                trial[i] = 0.0
                if loss_of_angles(trial) < threshold:
                    angles = trial
                    done = True
                    break
            if done:
                break
    return angles


def _circuit_loss_of_angles(qc: Circuit, host_loss) -> Callable[[np.ndarray], float]:
    def loss(angles: np.ndarray) -> float:
        return host_loss(qc.with_rotation_angles(angles).unitary())
    return loss


def polish_angles(loss_of_angles: Callable[[np.ndarray], float],
                  angles: np.ndarray,
                  frozen: Optional[np.ndarray] = None,
                  sweeps: int = 3) -> np.ndarray:
    """Exact coordinate descent on rotation angles: any circuit loss is
    F0 cos x + F1 sin x + c in each angle, so three evaluations give the
    closed-form optimum (trigonometric_utils.py:7-25, on the host).

    Used after greedy reduction: the committed zeroings each drift the loss
    by up to `threshold`, and the drift accumulates toward the rationalize
    stage's tolerance; polishing the surviving (non-frozen) angles restores
    machine-precision loss without changing the gate count."""
    angles = np.array(angles, dtype=float)
    if frozen is None:
        frozen = np.zeros(len(angles), dtype=bool)
    for _ in range(sweeps):
        for i in range(len(angles)):
            if frozen[i]:
                continue
            def f(x):
                t = angles.copy()
                t[i] = x
                return loss_of_angles(t)
            f0, f1, f2 = f(0.0), f(math.pi / 2), f(math.pi)
            c = (f0 + f2) / 2.0
            a, b = f0 - c, f1 - c
            if a == 0.0 and b == 0.0:
                continue  # loss independent of this angle
            # argmin of a cos x + b sin x + c is x = atan2(b, a) + pi
            x_min = math.atan2(b, a) + math.pi
            if f(x_min) < loss_of_angles(angles):
                angles[i] = _bracket(x_min)
    return angles


def reduce_angles(circuit: Circuit, unitary_loss_func,
                  reduce_threshold: float = 1e-5,
                  cp_threshold: float = 0.01) -> Circuit:
    """CP->CZ projection, ZXZ conversion, greedy angle reduction
    (reference exact_decompositions.py:193-209)."""
    qc = cp_to_cz_circuit(circuit, cp_threshold=cp_threshold)
    qc = convert_to_zxz(qc)

    host_loss = host_loss_adapter(unitary_loss_func)
    angles = np.array(qc.parameters, dtype=float)
    wires = qc.rotation_wires

    loss_of = _circuit_loss_of_angles(qc, host_loss)
    reduced = reduce_all_1q_angles(loss_of, angles, wires,
                                   threshold=reduce_threshold)
    # polish the surviving angles back to machine-precision loss (zeroed
    # angles stay frozen so the greedy reduction is preserved)
    polished = polish_angles(loss_of, reduced, frozen=(reduced == 0.0))
    qc = qc.with_rotation_angles([_bracket(a) for a in polished])

    check_loss(qc, host_loss, threshold_loss=reduce_threshold)
    return qc


def squeeze_to_dyadic(circuit: Circuit, unitary_loss_func,
                      max_denominator: int = 32,
                      threshold: float = 1e-5,
                      snap_tol: float = 3e-3,
                      rounds: int = 4) -> Tuple[Circuit, bool]:
    """Beyond-reference pass: drive surviving rotation angles onto the dyadic
    grid pi*p/2^k so the Rational stage (and the exact cyclotomic proofs)
    can take the circuit.

    The reference's greedy reducer only merges angles on the SAME wire
    (exact_decompositions.py:96-104); decompositions often carry continuous
    gauge freedoms that pair rotations on DIFFERENT wires (measured on
    qx_4gt13_92: two rx angles on wires 0 and 4 must be equal but their
    common value is free). This pass (1) snaps near-dyadic angles exact and
    freezes them, (2) polishes the remaining angles by exact coordinate
    descent, (3) eliminates off-grid angles by zeroing with a compensating
    +-a fold into ANY other angle, iterating to a fixed point.

    Returns (circuit, all_dyadic). Opt-in; never called by refine() itself,
    so reference-parity semantics are untouched.
    """
    host_loss = host_loss_adapter(unitary_loss_func)
    loss_of = _circuit_loss_of_angles(circuit, host_loss)
    angles = np.array(circuit.parameters, dtype=float)

    from fractions import Fraction

    def dyadic(a: float) -> Optional[float]:
        f = Fraction(a / math.pi).limit_denominator(max_denominator)
        if f.denominator and max_denominator % f.denominator == 0:
            return math.pi * f.numerator / f.denominator
        return None

    for _ in range(rounds):
        snapped = angles.copy()
        frozen = np.zeros(len(angles), dtype=bool)
        for i, a in enumerate(angles):
            v = dyadic(a)
            if v is not None and abs(a - v) < snap_tol:
                snapped[i] = v
                frozen[i] = True
        polished = polish_angles(loss_of, snapped, frozen=frozen, sweeps=6)
        if loss_of(polished) < threshold:
            angles = polished
        if frozen.all() and loss_of(angles) < threshold:
            break
        progressed = False
        for i in np.flatnonzero(~frozen):
            if angles[i] == 0.0:
                continue
            trial = angles.copy()
            trial[i] = 0.0
            if loss_of(trial) < threshold:
                angles = trial
                progressed = True
                continue
            done = False
            for j in range(len(angles)):
                if j == i:
                    continue
                for sign in (-1.0, 1.0):
                    t2 = angles.copy()
                    t2[j] = angles[j] + sign * angles[i]
                    t2[i] = 0.0
                    if loss_of(t2) < threshold:
                        angles = t2
                        done = progressed = True
                        break
                if done:
                    break
        if not progressed:
            break

    all_dyadic = True
    final = angles.copy()
    for i, a in enumerate(angles):
        v = dyadic(a)
        if v is not None and abs(a - v) < 1e-9:
            final[i] = v
        else:
            all_dyadic = False
    qc = circuit.with_rotation_angles([_bracket(a) for a in final])
    check_loss(qc, host_loss, threshold_loss=threshold)
    return qc, all_dyadic


# --------------------------------------------------------------------------
# The refine state machine
# --------------------------------------------------------------------------

def refine(circuit: Circuit,
           unitary_loss_func,
           max_denominator: int = 32,
           angle_threshold: float = 1e-3,
           cp_threshold: float = 0.01,
           reduce_threshold: float = 1e-5,
           recursion_degree: int = 0,
           recursion_depth: int = 5,
           verbose: bool = False
           ) -> Tuple[Circuit, str, Optional[int], Optional[int]]:
    """Approximate -> Rational -> Clifford+T refinement
    (reference exact_decompositions.py:293-344). Returns
    (circuit, type, t_count, t_depth); failed stages roll back."""
    qc = circuit.copy()
    refine_type = 'Approximate'
    t_count = None
    t_depth = None

    try:
        qc = reduce_angles(qc, unitary_loss_func,
                           reduce_threshold=reduce_threshold,
                           cp_threshold=cp_threshold)
        qc = remove_zero_rgates(qc)
        refine_type = 'Approximate'
    except ValueError as e:
        if verbose:
            print(e)
        return qc, refine_type, t_count, t_depth

    try:
        qc = rationalize_all_rgates(qc, max_denominator=max_denominator,
                                    angle_threshold=angle_threshold)
        qc = remove_zero_rgates(qc)
        if all_rgates_are_rational(qc, int(math.log2(max_denominator))):
            refine_type = 'Rational'
    except ValueError as e:
        if verbose:
            print(e)
        return qc, refine_type, t_count, t_depth

    try:
        qc_sk = solovay_kitaev(qc, recursion_degree=recursion_degree,
                               recursion_depth=recursion_depth)
        t_count = qc_sk.gates_count(['t', 'tdg'])
        t_depth = qc_sk.gates_depth(['t', 'tdg'])

        qc2 = reduce_angles(qc_sk, unitary_loss_func,
                            reduce_threshold=reduce_threshold,
                            cp_threshold=cp_threshold)
        qc2 = rationalize_all_rgates(qc2, max_denominator=max_denominator,
                                     angle_threshold=angle_threshold)
        qc2 = remove_zero_rgates(qc2)
        qc = qc2
        refine_type = 'Clifford+T'
    except ValueError as e:
        if verbose:
            print(e)
        return qc, refine_type, None, None

    return qc, refine_type, t_count, t_depth


# --------------------------------------------------------------------------
# Extras kept for parity
# --------------------------------------------------------------------------

def lasso_angles(loss_function, angles, eps: float = 1e-5,
                 threshold_loss: float = 1e-6, *, device=None):
    """L1-regularized re-optimization of circuit angles: Adam (10000 steps
    at 0.01) on loss_function, a torch callable of the (P,) angles, plus
    eps * sum |angle bracketed to [-pi, pi)|. Unlike the rest of this
    module it optimizes with autograd, on `device`: the angles' own device
    if they are a tensor, else the card (config.resolve_device). Raises
    AssertionError if the best iterate's loss ends above threshold_loss."""
    import torch
    from cpflow_tpu_torch import config
    from cpflow_tpu_torch.ops.trig import bracket_angle
    from cpflow_tpu_torch.optimize import mynimize_repeated

    device = config.resolve_device(angles, device)
    penalty = lambda angs: eps * torch.abs(bracket_angle(angs)).sum()
    res = mynimize_repeated(
        loss_function, len(angles), regularization_func=penalty,
        num_repeats=1, method='adam', learning_rate=0.01,
        initial_params_batch=torch.as_tensor(
            angles if isinstance(angles, torch.Tensor) else np.asarray(angles),
            dtype=config.real_dtype, device=device),
        num_iterations=10000, device=device)

    best_i = int(torch.argmin(res['regloss']))
    best_angs = res['params'][best_i]
    if not float(res['loss'][best_i]) <= threshold_loss:
        raise AssertionError('L1 regularization was not successful.')
    return best_angs

#!/usr/bin/env python3
"""Smoke test of the PyTorch port (cpflow_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs
one Hopper card (the kernels are built for sm_90a), nvcc and PyTorch
with CUDA, and never imports JAX. Phases:

  1. the card: name and power limit, torch and CUDA versions;
  2. build of the kernels from cpflow_tpu_torch/csrc/ into build/, one nvcc
     for each source (sweep.cu, unitary.cu), side by side;
  3. kernel against its plain PyTorch version on the card, same inputs,
     T = 60, at sixteen shapes: (a) 3q CCZ k=12 B=1000; (b) 5q Toffoli k=20
     B=256; (c) the verification shape B=8 with a mask, r=0, lr 0.01,
     target_loss; (d) the adaptive search's bucketed shape, 4q square
     Toffoli-4 padded to k=40, B = 4 x 256 with four r values and four
     template masks (k = 10, 20, 30, 40); (e) the state loss, 4q GHZ chain
     k=6 B=100; (f) the state loss at 10 qubits, GHZ chain k=36 B=256;
     (g) 5q connected Toffoli-5, rotations 'xz', k=36 B=256; (h) the
     modulo-diagonal loss, 4q connected Toffoli-4, all wires, k=12 B=256;
     (i) the modulo-identity loss on wires [1, 3] of the 4q chain, k=10
     B=128; (j) the disc loss, 3q CCZ k=12 B=256; (k) fixed 'cz' blocks on
     the 14 CZ placements of benchmarks/artifacts/toffoli4_connected.json,
     'xz', no penalty, B=512; (l) the modulo-diagonal loss at 6 qubits
     (the largest shared-memory layout), connected, 'xz', k=40 B=128;
     (m) as (k) with 'xyz'; (n) phase 8's bucketed sweep, (h)'s loss
     padded to k=20, B = 4 x 256 with r and a template mask per trial;
     (o) phase 9's bucketed sweep, (g)'s template padded to k=50,
     B = 4 x 256 with r and a template mask per trial; (p) fixed 'cx'
     blocks with rotations 'y', 3q chain CCZ k=8 B=256; with the
     tolerances stated in phase_compare and drift_ok;
  4. the static main path: Synthesize(...).static (on the card by default)
     on the 3q chain CCZ (k=12, 1024 samples), which must return a
     decomposition with at most 8 CZ and float64 host loss <= 1e-6,
     through the kernel in both the sampling and the verification stage;
  5. times of the kernel and the plain version (the plain one over T steps
     at the first two shapes, over 100 steps at the others, each reported
     with its step count), each kernel time beside its bound (bound_ms, from
     the operations sweep_work counts) and the kernel's registers per
     thread and resident blocks per SM at that shape: the static sampling
     shape, the 5q k=20 batch-2048 shape, shape (d) for 2000 steps, (f) for
     500, (g) for 500 and (h) for 2000;
  6. the adaptive main path: Synthesize(square_layer(4),
     target_unitary=u_toff4).adaptive with k in [10, 40], 1024 samples,
     bucketed, 4 parallel trials, 8 evals, stopping at 16 CZ; every trial
     must score finitely, every sampling sweep must run the kernel with r
     differing across its restarts, and a verified decomposition must
     reach float64 host loss <= 1e-6;
  7. the state main path: Synthesize(chain_layer(4), target_state=GHZ-4)
     .static (k=6, 100 samples, r=0.001), which must return a 3-CZ
     decomposition with float64 host state loss <= 1e-6 through the kernel
     in both stages;
  8. the relative-phase path: adaptive Toffoli-4 modulo a diagonal on full
     connectivity (k in [4, 20], 1024 samples, bucketed, 4 parallel
     trials, at most 16 evals, stopping at the published 6 CZ), checked as
     phase 6, with a verified decomposition at float64 host
     modulo-diagonal loss <= 1e-6;
  9. the 'xz' path: adaptive Toffoli-5 on full connectivity, k in
     [25, 50], 1024 samples, one bucketed sweep of 4 trials; every sweep
     must run the kernel with 'xz' and r per trial, every trial must score
     finitely;
 10. the Table-3 success ratio: fixed 'cz' blocks on the artifact's 14
     placements with 'xyz' and with 'xz', 512 restarts x 5000 steps
     through engine.minimize_fused; the kernel must run and every loss be
     finite; the ratios are printed beside the JAX package's and the
     paper's;
 11. synthesis, then refinement: Synthesize(...).static on the card, then
     Decomposition.refine (host, float64) on up to 12 of the decompositions
     with the fewest CZ gates, in two settings: (a) Toffoli-3 on full
     connectivity, k=7, r=1.31e-3, 100 samples, which must give a 6-CZ
     decomposition at float64 host loss <= 1e-6 through the kernel in both
     stages and refine one to 'Clifford+T' at host loss <= 1e-9 with its
     CZ count unchanged, proved equal to the Toffoli over the cyclotomic
     integers where the circuit's angles allow it; (b) Toffoli-3 on the
     chain, k=14, r=0.88e-3, 100 samples, 8 CZ, the best T count and T
     depth printed beside the paper's 7 and 3;
 12. the forward and vjp kernels of the differentiable ansatz
     (kernels/unitary.py) against their plain version on the card at
     fifteen templates: at B=256, 3q k=12 'xyz' cp, 5q k=20 'xz' cp, 6q
     connected k=40 (the largest layout on one block), 4q 'cz' blocks with
     'y', 10q k=36 column 0; then every template of phases 13 and 14 at the
     batch they give it, a verification's few candidates with frozen CP
     angles among them; then the whole unitary split over several blocks:
     7q chain k=24 B=64, 8q chain k=16 'xz' B=16 and the Toffoli-7
     composite's 144 placements B=8; the unitary within 2e-5, the gradients
     of two cotangents within 1e-4 scaled by max(1, |gradient|), at 3q also
     against float64 central differences (1e-3); then both kernels' times
     beside their bounds at 3q k=12 B=1024, 5q k=20 B=2048, 7q k=24 B=64
     and 8q k=16 B=16;
 13. the custom-loss path: the reference notebook's GHZ-4 and
     relative-phase Toffoli-3 syntheses with the losses as torch callables
     (adaptive, k in [0, 10], stopping at 3 CZ, max_evals cut to 8), which
     must run through the forward and vjp kernels and never through the
     plain builder; GHZ-4 must reach 3 CZ at host loss <= 1e-6, as the same
     run with target_state (the fused kernel) does; the relative-phase
     Toffoli-3's 8 trials run bucketed in one sweep of 1000 steps (2000 in
     the notebook), and its last decomposition is refined;
 14. the engine: Ansatz.learn (Toffoli-3, 200 restarts, without and with a
     history) and StaticOptions(method=...) for 'natural adam', 'hessian'
     and 'angle by angle' on the 3q chain CCZ at small budgets;
 15. seven and eight qubits, each restart's columns split over a cluster of
     2, 4 or 8 thread blocks: (a) the sweep kernel against its plain
     version as in phase 3 at twelve shapes, T = 60 unless said: (q) 7q chain
     Toffoli-7 k=24 B=256 r=0.002; (r) the disc loss on it, B=64; (s) the
     modulo-diagonal loss on wires [2, 5, 0], 'xz', k=16 B=256; (t) the
     modulo-identity loss on wires [6, 1], k=16 B=128; (u) (q)'s template
     bucketed, k in (12, 24), B = 2 x 128 with r and a template mask per
     trial ((q), (s), (t), (u) with the float64 arbiter, seven_shapes);
     (v) the verification shape, B=8 with a mask, r=0, lr 0.01,
     target_loss; (w) 8q chain k=16 'xz' B=32 (8 blocks); (x) 7q k=220
     B=8 T=10 (4 blocks); (y) the 144 placements of the Toffoli-7
     composite, B=64 T=20 (arbiter); (z1)-(z3) the shapes the main paths
     below give the kernel: (c)'s sampling (k=8 B=128) and verification
     (k=8 B=8) and (b)'s verification (k=144 B=8 T=20); (b) the Toffoli-7
     program at full width: the composite embedded exactly (k=144), its
     float32 loss in the kernel beside the float64 host loss, a warm batch
     of 64 through engine.minimize_fused at r = 1e-4, then verification:
     2000 steps at lr 0.1 must give at most 144 CZ at float64 host loss
     <= 1e-6, and 500 steps at lr 0.01 must bring a noisy row from above
     the entry loss back under it to a verified decomposition; (c)
     Synthesize.static on the 7q chain for the CX ladder (6 CZ); 9 qubits
     must be refused. Every cluster launch checks that its blocks end with
     the same Adam state (the kernel traps otherwise).

Each main path (4, 6-11, 13, 14, 15 (b) and (c)) runs with the kernels'
launch counts set to 0 just before it and read just after. Every shape's
plan (blocks a restart, shared bytes per block) is held against the
kernels' own. The script prints the card, a JSON line of kernel results
(sweep, ansatz_forward, ansatz_vjp) and, last, the JSON device line; it
exits non-zero if any phase fails or there is no card.
"""

from __future__ import annotations

from collections import Counter
import functools
import json
import math
from pathlib import Path
import subprocess
import sys
import time


class PhaseError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- helpers

def make_objective(n, k, target, r, layer=None, kind='hst', rot='xyz',
                   ent='cp', wires=None, placements=None, dtype=None):
    """The objective on an n-qubit layer (default: the chain) with k blocks
    (or the given placements); kind 'hst' for a target unitary, 'state' for
    a target state, 'disc' or 'modulo_identity'/'modulo_diagonal' on
    `wires`; the plain version in `dtype` (default float32). Returns
    (objective, number of angles)."""
    from cpflow_tpu_torch.api import Ansatz, LossSpec, RegularizationOptions
    from cpflow_tpu_torch.ops.penalty import make_regularization_function
    from cpflow_tpu_torch.sim.batched import make_batched_regloss
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    anz = Ansatz(n, ent, placements or fill_layers(layer or chain_layer(n), k),
                 rot)
    spec = LossSpec(kind, target=target) if wires is None else \
        LossSpec(kind, target=target, num_qubits=n, wires=wires)
    pen = {}
    if ent == 'cp':
        pen = dict(cp_mask=anz.cp_mask, r=r,
                   regularization_func=make_regularization_function(
                       RegularizationOptions))
    # plain=True: called on the card, this objective is the plain version
    # (the sweep kernel reads its attributes and never calls it)
    return make_batched_regloss(n, ent, rot, anz.placements, spec,
                                dtype=dtype, plain=True, **pen), anz.num_angles


def artifact_cz_placements():
    """The ordered CZ placements of the 14-CZ connected Toffoli-4 in
    benchmarks/artifacts/toffoli4_connected.json (the paper's Table 3
    protocol fixes the architecture of a found decomposition)."""
    path = Path(__file__).resolve().parent / 'benchmarks' / 'artifacts' / \
        'toffoli4_connected.json'
    doc = json.loads(path.read_text())
    return [list(i['qubits']) for i in doc['instructions'] if i['name'] == 'cz']


# float32 operations of one restart-iteration (a complex product 6, a
# complex sum 2, a sine or cosine 1). `needed` is what the sweep's
# algorithm needs, the numerator of its bound:
#  - per amplitude of the d x C state: a 1q gate's forward pass 14 and its
#    adjoint step 44 (rewinding A by G^dag, pulling M back by G^T, summing
#    the gate's cotangent), a 2q gate's 30 and 92;
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
# the gradient pass rebuilds both legs of every block from the stored cos
# and sin (112(m - 1) a block), and the kernel computes the penalty of
# every angle (masked by cp_mask) in the evaluation and again in the Adam
# pass (2 x 22 per angle).
def sweep_work(n, nb, rot='xyz', ent='cp', kind='hst', num_wires=None):
    """dict(P angles, target entries, needed and executed float32
    operations of one restart-iteration) of a sweep."""
    from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
    d, m = 2 ** n, len(rot)
    P = 3 * n + num_block_angles(ent, rot) * nb
    amps = d if kind == 'state' else d * d
    common = amps * (58 * n + 122 * nb)
    if kind.startswith('modulo'):
        on = d * 2 ** (n - num_wires)          # entries on the blocks
        common += 26 * on + 5 * (amps - on) + 6 * d
    else:
        common += 14 * amps
    common += 273 * n + (214 * max(m - 1, 0) + 464 + 2 * m + {
        'cp': 109, 'cz': 16, 'cx': 0}[ent]) * nb + 18 * P
    needed = common + 22 * nb * (ent == 'cp')
    executed = common + 112 * max(m - 1, 0) * nb + 44 * P
    return dict(P=P, target=amps, needed=needed, executed=executed)


PEAK_F32 = 67e12   # float32 FLOP/s outside the tensor cores, H100 SXM, 700 W
PEAK_BYTES = 3.35e12


def bound_ms(work, B, T):
    """(least time in ms, 'operations' or 'bytes') for a sweep of B restarts
    over T steps of sweep_work's `work`: its needed operations over the
    float32 peak, or the bytes it must move (initial angles, mask, target
    and r read, best angles and summary written) over the memory rate,
    whichever is larger."""
    P = work['P']
    nbytes = 4 * (3 * P * B + 5 * B + P) + 8 * work['target']
    t_ops = work['needed'] * B * T / PEAK_F32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def ghz(n):
    import numpy as np
    t = np.zeros(2 ** n, dtype=np.complex64)
    t[0] = t[-1] = 2 ** -0.5
    return t


BUCKET_RS = (0.0003, 0.00055, 0.001, 0.002)


def shape_objective(s, dtype=None):
    """(objective, P) of a shape dict in `dtype` (default float32). A
    bucketed shape (one with 'ks') runs its trials side by side on its
    template padded to max(ks), trial j with penalty weight rs[j] on its
    S restarts."""
    import torch
    bucketed = 'ks' in s
    obj, P = make_objective(
        s['n'], max(s['ks']) if bucketed else s['k'], s['target'],
        0.0 if bucketed else s['r'], layer=s.get('layer'),
        kind=s.get('kind', 'hst'), rot=s.get('rot', 'xyz'),
        ent=s.get('ent', 'cp'), wires=s.get('wires'),
        placements=s.get('placements'), dtype=dtype)
    if bucketed:
        obj.r = torch.tensor(s['rs'], dtype=obj.dtype,
                             device='cuda').repeat_interleave(s['S'])
    return obj, P


def shape_inputs(s, seed):
    """(objective, initial angles, gradient mask or None) of a shape on the
    card. A bucketed shape lays its trials out as
    candidates.run_bucketed_stage does: trial j's mask frees the angles of
    its first ks[j] blocks, and its initial angles are masked with it."""
    import torch
    from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
    obj, P = shape_objective(s)
    init = uniform_inits(P, s['B'], seed, 'cuda')
    if 'ks' not in s:
        return obj, init, None
    nba = num_block_angles(s.get('ent', 'cp'), s.get('rot', 'xyz'))
    active = torch.zeros((P, len(s['ks'])), device='cuda')
    for j, k in enumerate(s['ks']):
        active[:3 * s['n'] + nba * k, j] = 1.0
    mask = active.repeat_interleave(s['S'], dim=1).contiguous()
    return obj, init * mask, mask


def shape_work(s):
    """sweep_work of a shape dict."""
    wires = s.get('wires')
    return sweep_work(s['n'], max(s['ks']) if 'ks' in s else s['k'],
                      s.get('rot', 'xyz'), s.get('ent', 'cp'),
                      s.get('kind', 'hst'), len(wires) if wires else None)


def uniform_inits(P, B, seed, device):
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((P, B), generator=gen, device=device) * (2 * math.pi)


def timed(fn):
    import torch
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def device_ms(fn, kernel_name, repeats=20):
    """Mean time in ms that the kernels whose name contains `kernel_name`
    take on the card over `repeats` calls of fn, from torch.profiler's
    trace of the card; None if the trace holds no such kernel. Unlike
    `timed`, which brackets the call on the stream and so includes whatever
    the host needs to launch it, this is the kernel alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for event in prof.key_averages():
        if kernel_name in event.key:
            spent = getattr(event, 'self_device_time_total', None)
            if spent is None:
                spent = event.self_cuda_time_total
            total_us += spent
            count += event.count
    return total_us / count / 1e3 if count and total_us > 0 else None


# ----------------------------------------------------------------- phases

def phase_build():
    """Builds every source of csrc/, one nvcc each, side by side."""
    from cpflow_tpu_torch.kernels import build
    start = time.perf_counter()
    build.build_all()
    wall = time.perf_counter() - start
    for name in build.SOURCES:
        info = build.INFO[name]
        print(f'phase 2: built {info["library"]} (nvcc '
              f'{info.get("seconds", float("nan")):.2f} s; all sources '
              f'{wall:.2f} s)')
        for line in info.get('ptxas', '').splitlines():
            if 'registers' in line or 'spill' in line or \
                    'Compiling entry' in line:
                print('  ptxas:', line.strip())


def scaled_err(a, b):
    """Per-restart |a - b| / max(1, |b|). float32 rounding scales with the
    value: the HS-test, state and disc losses lie in [0, 1], where this is
    |a - b|; the modulo losses at random angles lie near d (their
    off-block weight, up to 64 at 6 qubits), where it is the relative
    error."""
    return (a - b).abs() / b.abs().clamp(min=1.0)


def drift_ok(err):
    """Per-restart scaled_err(kernel, plain) after 60 Adam steps. Adam's
    normalised step turns float32 rounding in nearly flat directions into
    full-size steps, so a few restarts drift apart in any two float32
    implementations (the plain float32 and float64 versions differ by up to
    1.9e-3 at 5q k=20, PERF.md). Required: 90% of restarts within 1e-4,
    the median within 1e-5, none beyond 1e-2."""
    within = (err <= 1e-4).float().mean().item()
    return (within >= 0.9 and err.median().item() <= 1e-5 and
            err.max().item() <= 1e-2), within


def as_close_as_plain(kernel, plain, plain64, keep):
    """On the named arbiter shapes only, where drift_ok misses, the float64
    plain version decides: the kernel must be about as close to it as the
    float32 plain version is (share within 1e-4 at most 5 points lower,
    median and max at most twice), and never needs to be closer than
    drift_ok asks."""
    ek = scaled_err(kernel.double(), plain64)[keep]
    ep = scaled_err(plain.double(), plain64)[keep]
    wk = (ek <= 1e-4).double().mean().item()
    wp = (ep <= 1e-4).double().mean().item()
    ok = (wk >= min(wp - 0.05, 0.9) and
          ek.median() <= max(2 * ep.median(), 1e-5) and
          ek.max() <= max(2 * ep.max(), 1e-2))
    return bool(ok), (f'kernel within 1e-4 {wk:.1%}, median '
                      f'{ek.median().item():.2e}, max {ek.max().item():.2e}; '
                      f'plain float32 {wp:.1%}, {ep.median().item():.2e}, '
                      f'{ep.max().item():.2e}')


def plain_drifted(kernel, plain, plain64, keep):
    """On a shape that is not an arbiter shape, where drift_ok misses, the
    plain float32 version is at fault, not the kernel, only if it misses
    drift_ok against the float64 version itself while the kernel meets
    drift_ok against float64: the same rule, held against the exact
    reference."""
    ek = scaled_err(kernel.double(), plain64)[keep]
    ep = scaled_err(plain.double(), plain64)[keep]
    (ok_k, wk), (ok_p, wp) = drift_ok(ek), drift_ok(ep)
    return ok_k and not ok_p, (
        f'kernel within 1e-4 {wk:.1%}, median {ek.median().item():.2e}, max '
        f'{ek.max().item():.2e}; plain float32 {wp:.1%}, '
        f'{ep.median().item():.2e}, {ep.max().item():.2e}')


def compare_shapes():
    """Phase 3's shapes, (a)-(p), as dicts: a bucketed one has ks, rs and S
    (B = S len(ks)). arbiter=True names the shapes on which the float64
    plain version may arbitrate (as_close_as_plain): those where plain
    float32 itself misses drift_ok against float64 at T = 60, the deep
    templates (g), (l) and (o) with their many flat directions, and (n),
    where one restart of plain float32 drifts by 1.1e-2 (PERF.md,
    Findings). Every other shape is held to drift_ok, against plain float32
    or, where plain float32 itself misses it, against float64
    (plain_drifted)."""
    from cpflow_tpu_torch.ops.gates import (multi_controlled_x, u_ccz3,
                                            u_toff4, u_toff5)
    from cpflow_tpu_torch.topology import connected_layer, square_layer
    cz14 = {'free': artifact_cz_placements()}
    return [
        dict(name='(a) 3q CCZ k=12 B=1000', n=3, k=12, target=u_ccz3, B=1000,
             r=0.00055, lr=0.1),
        dict(name='(b) 5q Toffoli k=20 B=256', n=5, k=20,
             target=multi_controlled_x(5), B=256, r=0.00055, lr=0.1),
        dict(name='(c) verification B=8', n=3, k=12, target=u_ccz3, B=8,
             r=0.0, lr=0.01, mask=True, target_loss=0.5),
        dict(name='(d) bucketed 4q square Toffoli-4 k<=40 B=4x256, r and '
             'mask per trial', n=4, layer=square_layer(4), target=u_toff4,
             ks=(10, 20, 30, 40), rs=BUCKET_RS, S=256, B=1024, lr=0.1,
             seed=300),
        dict(name='(e) state 4q GHZ k=6 B=100', n=4, k=6, target=ghz(4),
             kind='state', B=100, r=0.001, lr=0.1),
        dict(name='(f) state 10q GHZ k=36 B=256', n=10, k=36, target=ghz(10),
             kind='state', B=256, r=0.001, lr=0.1),
        dict(name="(g) 5q connected Toffoli-5 'xz' k=36 B=256", n=5, k=36,
             target=u_toff5, layer=connected_layer(5), rot='xz', B=256,
             r=0.00055, lr=0.1, arbiter=True),
        dict(name='(h) modulo_diagonal 4q connected Toffoli-4 all wires k=12 '
             'B=256', n=4, k=12, target=u_toff4, layer=connected_layer(4),
             kind='modulo_diagonal', wires=[0, 1, 2, 3], B=256, r=0.00055,
             lr=0.1),
        dict(name='(i) modulo_identity 4q chain Toffoli-4 wires [1, 3] k=10 '
             'B=128', n=4, k=10, target=u_toff4, kind='modulo_identity',
             wires=[1, 3], B=128, r=0.00055, lr=0.1),
        dict(name='(j) disc 3q CCZ k=12 B=256', n=3, k=12, target=u_ccz3,
             kind='disc', B=256, r=0.00055, lr=0.1),
        dict(name="(k) 'cz' blocks on the 14 Toffoli-4 placements 'xz' B=512",
             n=4, k=14, target=u_toff4, ent='cz', rot='xz', placements=cz14,
             B=512, r=0.0, lr=0.1),
        dict(name="(l) modulo_diagonal 6q connected Toffoli-6 'xz' k=40 B=128",
             n=6, k=40, target=multi_controlled_x(6), layer=connected_layer(6),
             kind='modulo_diagonal', wires=list(range(6)), rot='xz', B=128,
             r=0.00055, lr=0.1, arbiter=True),
        dict(name="(m) 'cz' blocks on the 14 Toffoli-4 placements 'xyz' "
             "B=512", n=4, k=14, target=u_toff4, ent='cz', placements=cz14,
             B=512, r=0.0, lr=0.1),
        dict(name='(n) bucketed modulo_diagonal 4q connected Toffoli-4 k<=20 '
             'B=4x256, r and mask per trial', n=4, layer=connected_layer(4),
             target=u_toff4, kind='modulo_diagonal', wires=[0, 1, 2, 3],
             ks=(5, 10, 15, 20), rs=BUCKET_RS, S=256, B=1024, lr=0.1,
             arbiter=True),
        dict(name="(o) bucketed 5q connected Toffoli-5 'xz' k<=50 B=4x256, r "
             "and mask per trial", n=5, layer=connected_layer(5),
             target=u_toff5, rot='xz', ks=(25, 33, 42, 50), rs=BUCKET_RS,
             S=256, B=1024, lr=0.1, arbiter=True),
        dict(name="(p) 'cx' blocks 'y' 3q CCZ k=8 B=256", n=3, k=8,
             target=u_ccz3, ent='cx', rot='y', B=256, r=0.0, lr=0.1),
    ]


def check_plan(obj, B, name):
    """The blocks a restart of `obj` runs on: kernels/sweep.py's plan
    (cluster_plan, smem_bytes) must agree with the kernel's
    (cpflow_sweep_cluster, cpflow_sweep_smem_bytes, and the cluster of the
    build it launches). Returns (blocks a restart, shared bytes per block,
    the occupancy)."""
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    kind = obj.unitary_loss_func.kind
    n, nb = obj.num_qubits, len(all_placements(obj.placements))
    nba = num_block_angles(obj.entangling_gate_name, obj.rotation_gates)
    c = sk.cluster_plan(n, nb, nba, kind)
    mine = sk.smem_bytes(n, nb, nba, kind, c)
    lib = sk.load_library()
    theirs = lib.cpflow_sweep_cluster(n, nb, nba, sk.LOSS_CODES[kind])
    card = lib.cpflow_sweep_smem_bytes(n, nb, nba, sk.LOSS_CODES[kind], c)
    occ = sk.occupancy(obj, B)
    check(mine == card == occ['smem_bytes'] and c == theirs == occ['cluster'],
          f'{name}: the plan says {c} blocks of {mine} bytes, the kernel '
          f'{theirs} ({occ["cluster"]}) blocks of {card} '
          f'({occ["smem_bytes"]}) bytes')
    return c, mine, occ


def phase_compare(shapes=None, label='phase 3'):
    """Kernel vs plain version on the card, same inputs, T steps (60 unless
    the shape says). The losses at the initial angles must agree within
    1e-5 for every restart (two derivations of one float32 forward pass),
    as scaled_err measures; the best losses after T steps as drift_ok says;
    where it misses, on an arbiter shape as close to the plain float64
    version as the plain float32 one (as_close_as_plain), on any other
    shape within drift_ok of float64 where plain float32 is not
    (plain_drifted); with target_loss the success flags must be equal.
    Every shape's plan (blocks a restart, shared bytes per block) is held
    against the kernel's (check_plan). shapes: phase 3's (compare_shapes)
    by default.
    Returns (largest absolute error, the templates driven: a dict of the
    losses, entanglers and rotation strings, and the rows: name, cluster,
    bytes, ms, plain_ms, bound_ms, bound_by)."""
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    dev = 'cuda'
    worst = 0.0
    driven = {'modes': set(), 'entanglers': set(), 'rotation_strings': set()}
    rows = []
    for i, s in enumerate(compare_shapes() if shapes is None else shapes):
        obj, init, mask = shape_inputs(s, s.get('seed', 100 + i))
        P, tl, T = init.shape[0], s.get('target_loss'), s.get('T', 60)
        if s.get('mask'):
            gen = torch.Generator(device=dev).manual_seed(200 + i)
            mask = (torch.rand((P, s['B']), generator=gen, device=dev) > 0.3
                    ).float()
        c, nbytes, occ = check_plan(obj, s['B'], s['name'])
        check(c == s.get('cluster', 1), f'{s["name"]}: {c} blocks a '
              f'restart, not {s.get("cluster", 1)}')
        before = sk.LAUNCHES
        out, ms = timed(lambda: sk.sweep(obj, init, s['lr'], T, mask, tl))
        check(sk.LAUNCHES > before, f'{s["name"]}: kernel not launched')
        ref, plain_ms = timed(lambda: sk.sweep_reference(
            obj, init, s['lr'], T, mask, tl))
        for t in out:
            check(t.shape[-1] == s['B'] and bool(torch.isfinite(t).all()),
                  f'{s["name"]}: bad output')
        err0 = scaled_err(out.regloss0, ref.regloss0).max().item()
        abs0 = (out.regloss0 - ref.regloss0).abs().max().item()
        check(err0 <= 1e-5, f'{s["name"]}: initial loss differs by {err0}')
        keep = torch.ones(s['B'], dtype=torch.bool, device=dev)
        line = (f'{label}: {s["name"]}: {c} block(s) a restart, {nbytes} '
                f'shared bytes and {occ["registers"]} registers a thread each'
                f', {occ["active_clusters"]} restarts resident; T={T}: kernel '
                f'{ms:.2f} ms, plain {plain_ms:.2f} ms; regloss0 up to '
                f'{ref.regloss0.abs().max().item():.4g}, error max {abs0:.2e}'
                f' (scaled {err0:.2e})')
        if tl is not None:
            ok_k = out.best_loss <= tl
            ok_r = ref.best_loss <= tl
            check(bool((ok_k == ok_r).all()), f'{s["name"]}: success flags '
                  f'differ: kernel {ok_k.tolist()}, plain {ok_r.tolist()}')
            line += f', success {int(ok_k.sum())}/{s["B"]} in both'
            keep = ~ok_k  # the rest ran all 60 steps in both
        worst = max(worst, abs0)
        ref64 = None
        for what, a, b in [('best regloss', out.best_reg, ref.best_reg),
                           ('best loss', out.best_loss, ref.best_loss)]:
            if not bool(keep.any()):
                continue
            err = scaled_err(a, b)[keep]
            ok, within = drift_ok(err)
            line += (f', {what} scaled error max {err.max().item():.2e} median '
                     f'{err.median().item():.2e} within 1e-4 {within:.1%}')
            if not ok:  # float64 plain decides
                if ref64 is None:
                    obj64 = shape_objective(s, torch.float64)[0]
                    ref64 = sk.sweep_reference(obj64, init, s['lr'], T, mask,
                                               tl)
                rule = as_close_as_plain if s.get('arbiter') else plain_drifted
                ok, verdict = rule(a, b, ref64.best_reg if what ==
                                   'best regloss' else ref64.best_loss, keep)
                line += f' (float64, {rule.__name__}: {verdict})'
            check(ok, f'{s["name"]}: {what} drifts beyond the rule: {line}')
            worst = max(worst, (a - b).abs()[keep].max().item())
        print(line, flush=True)
        driven['modes'].add(s.get('kind', 'hst'))
        driven['entanglers'].add(s.get('ent', 'cp'))
        driven['rotation_strings'].add(s.get('rot', 'xyz'))
        b_ms, b_by = bound_ms(shape_work(s), s['B'], T)
        rows.append(dict(shape=s['name'], T=T, cluster=c, smem_bytes=nbytes,
                         registers=occ['registers'], ms=ms, plain_ms=plain_ms,
                         plain_T=T, bound_ms=b_ms, bound_by=b_by))
    return worst, {k: sorted(v) for k, v in driven.items()}, rows


def phase_main_path():
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import Synthesize, StaticOptions
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.ops.gates import u_ccz3
    from cpflow_tpu_torch.topology import chain_layer
    synth = Synthesize(chain_layer(3), target_unitary=u_ccz3)
    target = u_ccz3.astype(np.complex128)
    options = StaticOptions(num_cp_gates=12, num_samples=1024,
                            accepted_num_cz_gates=8)
    sk.LAUNCHES = 0
    start = time.perf_counter()
    results = synth.static(options, save_results=False, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = sk.LAUNCHES
    # the sampling stage is exactly one launch (no target_loss); every
    # further launch is verification's, which runs only when candidates
    # pass, so a count of 2 or more shows the kernel ran in both stages
    check(launches >= 2, f'main path launched the kernel {launches} times: '
          f'not in both the sampling and the verification stage')
    decs = results.decompositions
    check(len(decs) > 0, 'no verified decomposition')
    best = None
    for d in decs:
        u = d.circuit.unitary()
        check(u.shape == (8, 8) and np.isfinite(u).all(), 'bad unitary')
        host = float(1 - abs((u * target.conj()).sum()) ** 2 / 64)
        if d.cz_count <= 8 and (best is None or host < best[1]):
            best = (d.cz_count, host)
    check(best is not None and best[1] <= 1e-6,
          f'no decomposition with <= 8 CZ and host loss <= 1e-6: {best}')
    cz_counts = dict(sorted(Counter(d.cz_count for d in decs).items()))
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    print(f'phase 4: static CCZ 3q k=12 1024 samples: {len(decs)} verified, '
          f'CZ count: number {cz_counts}, best {best[0]} CZ at host loss '
          f'{best[1]:.3e}; kernel launches {launches}; wall {wall:.3f} s '
          f'({stages})', flush=True)
    return launches


def phase_timing(card):
    """Kernel and plain times, and the kernel's share of its bound
    (bound_ms). The plain version of the later rows is timed over
    T_plain = 100 steps, not T: their T steps would take minutes of the
    script's budget. Each row reports the plain time it measured with its
    step count (plain_T), never a time scaled to T. Rates are
    restart-iter/s. Returns one dict per row."""
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.ops.gates import multi_controlled_x, u_ccz3
    shapes = {s['name'][:3]: s for s in compare_shapes()}
    rows = []
    for s, T, T_plain in [
            (dict(name='3q CCZ k=12 B=1024 (static sampling)', n=3, k=12,
                  target=u_ccz3, r=0.00055, B=1024), 2000, 2000),
            (dict(name='5q Toffoli k=20 B=2048', n=5, k=20,
                  target=multi_controlled_x(5), r=0.00055, B=2048), 500, 500),
            (shapes['(d)'], 2000, 100), (shapes['(f)'], 500, 100),
            (shapes['(g)'], 500, 100), (shapes['(h)'], 2000, 100)]:
        obj, init, mask = shape_inputs(s, s.get('seed', 7))
        B = init.shape[1]
        sk.sweep_reference(obj, init, 0.1, 2, mask)          # warm-up
        _, plain_ms = timed(lambda: sk.sweep_reference(obj, init, 0.1,
                                                       T_plain, mask))
        sk.sweep(obj, init, 0.1, 2, mask)                    # warm-up
        _, ms1 = timed(lambda: sk.sweep(obj, init, 0.1, T, mask))
        _, ms2 = timed(lambda: sk.sweep(obj, init, 0.1, T, mask))
        ms = min(ms1, ms2)
        work = shape_work(s)
        b_ms, b_by = bound_ms(work, B, T)
        occ = sk.occupancy(obj, B)
        print(f'phase 5: {s["name"]} T={T} on {card}: kernel {ms1:.2f} / '
              f'{ms2:.2f} ms = {B * T / (ms / 1e3):.4g} restart-iter/s; bound '
              f'{b_ms:.3f} ms by {b_by} ({work["needed"]} float32 ops needed '
              f'per restart-iter, {work["executed"]} executed), share '
              f'{b_ms / ms:.2%}; plain {plain_ms:.2f} ms over {T_plain} '
              f'steps = {B * T_plain / (plain_ms / 1e3):.4g} restart-iter/s; '
              f'{occ["registers"]} registers and {occ["local_bytes"]} local '
              f'bytes per thread, {occ["threads"]} threads and '
              f'{occ["smem_bytes"]} shared bytes per block, '
              f'{occ["blocks_per_sm"]} blocks per SM', flush=True)
        rows.append(dict(shape=s['name'], T=T, cluster=occ['cluster'], ms=ms,
                         plain_ms=plain_ms, plain_T=T_plain, bound_ms=b_ms,
                         bound_by=b_by, registers=occ['registers']))
    return rows


def run_adaptive(synth, options):
    """Synthesize.adaptive with every bucketed sampling sweep watched:
    (results, [(restarts' trials, distinct r, launches, rotations)],
    launches, wall seconds); the launch count is set to 0 just before."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.optimize import candidates as cand
    stage = cand.run_bucketed_stage
    sweeps = []

    def watched(objective, seeds, rs, *args, **kw):
        before = sk.LAUNCHES
        out = stage(objective, seeds, rs, *args, **kw)
        sweeps.append((len(rs), len(set(np.float32(rs).tolist())),
                       sk.LAUNCHES - before, objective.rotation_gates))
        return out

    cand.run_bucketed_stage = watched
    try:
        sk.LAUNCHES = 0
        start = time.perf_counter()
        results = synth.adaptive(options, save_results=False, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = sk.LAUNCHES
    finally:
        cand.run_bucketed_stage = stage
    trials = results.trials.results
    check(trials and all(np.isfinite(t['loss']) for t in trials),
          f'a trial without a finite score: {[t["loss"] for t in trials]}')
    check(sweeps and all(calls >= 1 and distinct == n and n > 1
                         for n, distinct, calls, _ in sweeps),
          f'a sampling sweep missed the kernel or r per restart: {sweeps}')
    return results, sweeps, launches, wall


def trial_summary(synth, trials):
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    tr = [(t['num_cp_gates'], round(t['r'], 6), round(t['loss'], 3))
          for t in trials]
    return f'trials (k, r, score) {tr}', stages


def phase_adaptive():
    """The adaptive main path on the 4q square Toffoli-4 (the shape of the
    JAX package's toffoli4_square benchmark config: k in [10, 40], 1024
    samples, published 16 CZ). Every bucketed sampling sweep is watched: it
    must launch the kernel, with as many distinct r values across its
    restarts as it runs trials."""
    import numpy as np
    from cpflow_tpu_torch.api import AdaptiveOptions, Synthesize
    from cpflow_tpu_torch.ops.gates import u_toff4
    from cpflow_tpu_torch.topology import square_layer
    options = AdaptiveOptions(min_num_cp_gates=10, max_num_cp_gates=40,
                              num_samples=1024, bucketed=True,
                              parallel_trials=4, max_evals=8,
                              target_num_cz_gates=16,
                              stop_if_target_reached=True)
    synth = Synthesize(square_layer(4), target_unitary=u_toff4)
    results, sweeps, launches, wall = run_adaptive(synth, options)
    trials = results.trials.results
    target = u_toff4.astype(np.complex128)
    hosts = []
    for d in results.decompositions:
        u = d.circuit.unitary()
        check(u.shape == (16, 16) and np.isfinite(u).all(), 'bad unitary')
        hosts.append((d.cz_count,
                      float(1 - abs((u * target.conj()).sum()) ** 2 / 256)))
    good = [h for h in hosts if h[1] <= 1e-6]
    check(good, f'no verified decomposition with host loss <= 1e-6: {hosts}')
    best = min(good)
    tr, stages = trial_summary(synth, trials)
    print(f'phase 6: adaptive Toffoli-4 square, bucketed, 4 parallel trials:'
          f' {len(trials)} evals in {len(sweeps)} sampling sweeps; best '
          f'{best[0]} CZ at host loss {best[1]:.3e} (published 16); '
          f'verified {sorted(h[0] for h in hosts)}; {tr}; kernel launches '
          f'{launches}; wall {wall:.3f} s ({stages})', flush=True)
    return launches


def phase_state():
    """The state main path: GHZ-4 on the 4q chain (the JAX package's
    ghz_state benchmark config; GHZ_n needs n - 1 CZ on a chain)."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import StaticOptions, Synthesize
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.topology import chain_layer
    target = ghz(4).astype(np.complex128)
    synth = Synthesize(chain_layer(4), target_state=target)
    options = StaticOptions(num_cp_gates=6, num_samples=100,
                            accepted_num_cz_gates=3, r=0.001)
    sk.LAUNCHES = 0
    start = time.perf_counter()
    results = synth.static(options, save_results=False, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = sk.LAUNCHES
    check(launches >= 2, f'state path launched the kernel {launches} times: '
          f'not in both the sampling and the verification stage')
    hosts = []
    for d in results.decompositions:
        u = d.circuit.unitary()
        check(u.shape == (16, 16) and np.isfinite(u).all(), 'bad unitary')
        hosts.append((d.cz_count,
                      float(1 - abs((target.conj() * u[:, 0]).sum()) ** 2)))
    good = [h for h in hosts if h[0] == 3 and h[1] <= 1e-6]
    check(good, f'no 3-CZ decomposition with host state loss <= 1e-6: '
          f'{hosts}')
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    print(f'phase 7: static GHZ-4 chain k=6 100 samples: {len(hosts)} '
          f'verified, {len(good)} at 3 CZ, best host state loss '
          f'{min(good)[1]:.3e}; kernel launches {launches}; wall {wall:.3f} s '
          f'({stages})', flush=True)
    return launches


def phase_relphase():
    """Phase 8: the JAX package's relphase_toff4_connected config, the 6-CZ
    block of the paper's 30-CZ Toffoli-5: modulo-diagonal loss of Toffoli-4
    on all wires, full connectivity, k in [4, 20], 1024 samples, bucketed,
    4 parallel trials, at most 16 evals (60 in the config), stopping at 6
    CZ."""
    import numpy as np
    from cpflow_tpu_torch.api import AdaptiveOptions, LossSpec, Synthesize
    from cpflow_tpu_torch.ops import losses
    from cpflow_tpu_torch.ops.gates import u_toff4
    from cpflow_tpu_torch.topology import connected_layer
    wires = [0, 1, 2, 3]
    spec = LossSpec('modulo_diagonal', target=u_toff4, num_qubits=4,
                    wires=wires)
    options = AdaptiveOptions(min_num_cp_gates=4, max_num_cp_gates=20,
                              num_samples=1024, bucketed=True,
                              parallel_trials=4, max_evals=16,
                              target_num_cz_gates=6,
                              stop_if_target_reached=True)
    synth = Synthesize(connected_layer(4), unitary_loss_func=spec)
    results, sweeps, launches, wall = run_adaptive(synth, options)
    trials = results.trials.results
    target = u_toff4.astype(np.complex128)
    hosts = []
    for d in results.decompositions:
        u = d.circuit.unitary()
        check(u.shape == (16, 16) and np.isfinite(u).all(), 'bad unitary')
        hosts.append((d.cz_count, float(losses.disc_modulo_diagonal(
            target, u, 4, wires))))
    good = [h for h in hosts if h[1] <= 1e-6]
    check(good, f'no verified relative-phase Toffoli-4 with host '
          f'modulo-diagonal loss <= 1e-6: {hosts}')
    best = min(good)
    tr, stages = trial_summary(synth, trials)
    print(f'phase 8: adaptive relative-phase Toffoli-4 connected, '
          f'modulo_diagonal, bucketed, 4 parallel trials: {len(trials)} evals '
          f'in {len(sweeps)} sampling sweeps; best {best[0]} CZ at host loss '
          f'{best[1]:.3e} (published 6); verified (CZ, host loss) '
          f'{[(c, float(f"{h:.3e}")) for c, h in sorted(hosts)]}; {tr}; '
          f'kernel launches {launches};'
          f' wall {wall:.3f} s ({stages})', flush=True)
    return launches


def phase_toffoli5_xz():
    """Phase 9: the JAX package's toffoli5_connected_xz config at full
    width (5q, 'xz' template, k in [25, 50], 1024 samples per trial), cut
    to one bucketed sampling sweep: 4 parallel trials, 4 evals."""
    import numpy as np
    from cpflow_tpu_torch.api import AdaptiveOptions, Synthesize
    from cpflow_tpu_torch.ops.gates import u_toff5
    from cpflow_tpu_torch.topology import connected_layer
    options = AdaptiveOptions(min_num_cp_gates=25, max_num_cp_gates=50,
                              num_samples=1024, bucketed=True,
                              parallel_trials=4, max_evals=4,
                              rotation_gates='xz')
    synth = Synthesize(connected_layer(5), target_unitary=u_toff5)
    results, sweeps, launches, wall = run_adaptive(synth, options)
    check(all(rot == 'xz' for *_, rot in sweeps),
          f'a sampling sweep ran another template than xz: {sweeps}')
    trials = results.trials.results
    target = u_toff5.astype(np.complex128)
    hosts = sorted(
        (d.cz_count, float(1 - abs((d.circuit.unitary() * target.conj())
                                   .sum()) ** 2 / 1024))
        for d in results.decompositions)
    tr, stages = trial_summary(synth, trials)
    print(f"phase 9: adaptive Toffoli-5 connected 'xz', bucketed, 4 "
          f'parallel trials: {len(trials)} evals in {len(sweeps)} sampling '
          f'sweep(s); best CZ count '
          f'{hosts[0][0] if hosts else "none verified"} (published 36)'
          f'{f" at host loss {hosts[0][1]:.3e}" if hosts else ""}; {tr}; '
          f'kernel launches {launches}; wall {wall:.3f} s ({stages})',
          flush=True)
    return launches


def phase_success_ratio():
    """Phase 10: the paper's Table 3 protocol (benchmarks/success_ratio.py):
    'cz' blocks on the 14 CZ placements of the connected Toffoli-4
    artifact, 'xyz' and 'xz' rotations, 512 restarts, 5000 Adam steps at
    lr 0.1 through engine.minimize_fused, success = best regloss < 1e-4."""
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.ops.gates import u_toff4
    from cpflow_tpu_torch.optimize import engine
    placements = {'free': artifact_cz_placements()}
    jax_package = {'xyz': 0.59e-2, 'xz': 5.9e-2}
    paper = {'xyz': 0.6e-2, 'xz': 7.8e-2}
    sk.LAUNCHES = 0
    start = time.perf_counter()
    parts = []
    for rot in ('xyz', 'xz'):
        obj, P = make_objective(4, 14, u_toff4, 0.0, ent='cz', rot=rot,
                                placements=placements)
        before = sk.LAUNCHES
        raw = engine.minimize_fused(obj, uniform_inits(P, 512, 0, 'cuda').T,
                                    learning_rate=0.1, num_iterations=5000)
        best = raw.regloss[:, 1]
        check(sk.LAUNCHES > before and bool(torch.isfinite(best).all()),
              f'{rot}: not through the kernel, or a loss not finite')
        ratio = (best < 1e-4).float().mean().item()
        parts.append(f"{rot} {ratio:.4g} (JAX package {jax_package[rot]}, "
                     f"paper {paper[rot]})")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = sk.LAUNCHES
    print(f'phase 10: Table-3 success ratio, cz blocks on the 14 Toffoli-4 '
          f'placements, 512 restarts x 5000 steps: {"; ".join(parts)}; '
          f'kernel launches {launches}; wall {wall:.3f} s', flush=True)
    return launches


def phase_refine(name, layer, options, want_cz, published):
    """Phase 11: Synthesize(layer, u_toff3).static(options) on the card,
    then Decomposition.refine, on the host in float64, on up to 12 of the
    decompositions with the fewest CZ gates. Needs the kernel in both
    stages, a want_cz decomposition at host loss <= 1e-6 and a refinement
    to 'Clifford+T' at host loss <= 1e-9 that keeps the CZ count. A refined
    circuit whose angles are all pi p / 2^k (k <= 5) goes through
    exact_unitary: at host loss <= 1e-9 it must be proved equal to the
    Toffoli over the cyclotomic integers."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import Synthesize
    from cpflow_tpu_torch.circuits import exact_unitary as ex
    from cpflow_tpu_torch.circuits.ir import Circuit
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.ops.gates import u_toff3
    target = u_toff3.astype(np.complex128)

    def host(d):
        u = d.circuit.unitary()
        check(u.shape == (8, 8) and np.isfinite(u).all(), 'bad unitary')
        return float(1 - abs((u * target.conj()).sum()) ** 2 / 64)

    synth = Synthesize(layer, target_unitary=u_toff3)
    sk.LAUNCHES = 0
    start = time.perf_counter()
    results = synth.static(options, save_results=False, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = sk.LAUNCHES
    check(launches >= 2, f'{name}: the kernel was launched {launches} times: '
          f'not in both the sampling and the verification stage')
    decs = sorted(results.decompositions, key=lambda d: d.cz_count)
    cz_counts = dict(sorted(Counter(d.cz_count for d in decs).items()))
    good = [d for d in decs if d.cz_count == want_cz and host(d) <= 1e-6]
    check(good, f'{name}: no {want_cz}-CZ decomposition at host loss <= 1e-6 '
          f'among CZ counts {cz_counts}')
    check(all(d._decomposer is synth for d in decs),
          f'{name}: a decomposition lost its decomposer')

    exact_toffoli = ex.ExactMatrix.from_int_matrix(ex.toffoli_permutation(3),
                                                   m=64)
    # where refine's time goes: every probe of its greedy reduction and of
    # its polish rebuilds the circuit's float64 unitary
    evals = [0, 0.0]
    unitary = Circuit.unitary

    def counted(self, *args, **kw):
        begin = time.perf_counter()
        out = unitary(self, *args, **kw)
        evals[0] += 1
        evals[1] += time.perf_counter() - begin
        return out

    types, refined, proved, refine_s = Counter(), [], 0, 0.0
    for d in decs[:12]:
        cz_before = d.cz_count
        Circuit.unitary = counted
        start = time.perf_counter()
        try:
            d.refine()
        finally:
            refine_s += time.perf_counter() - start
            Circuit.unitary = unitary
        types[d.type] += 1
        if d.type != 'Clifford+T':
            continue
        loss = host(d)
        check(d.cz_count == cz_before and abs(d.loss - loss) <= 1e-12,
              f'{name}: refinement changed the CZ count {cz_before} -> '
              f'{d.cz_count} or reports loss {d.loss} at host loss {loss}')
        check(type(d.t_count) is int and type(d.t_depth) is int,
              f'{name}: T count {d.t_count!r}, T depth {d.t_depth!r}')
        try:
            u = ex.exact_unitary(d.circuit, q=32)
        except ex.NotExactError:
            u = None
        if u is not None:
            # an approximant snapped onto the grid may sit above 1e-9: it
            # is counted as not proved, never as a failure of the proof
            exact = ex.hst_equal_certificate(u, exact_toffoli)
            check(exact or loss > 1e-9, f'{name}: a refined circuit at host '
                  f'loss {loss} is not exactly the Toffoli')
            proved += exact
        if loss <= 1e-9:
            refined.append((d.t_depth, d.t_count, d.cz_count, loss))
    check(refined, f'{name}: no refinement reached Clifford+T at host loss '
          f'<= 1e-9; types {dict(types)}')
    check(any(r[2] == want_cz for r in refined),
          f'{name}: no {want_cz}-CZ decomposition refined to Clifford+T: '
          f'{refined}')
    t_depth, t_count, _, loss = min(refined)
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    n_ref = min(12, len(decs))
    print(f'phase 11: {name}, k={options.num_cp_gates} r={options.r} '
          f'{options.num_samples} samples: {len(decs)} verified, CZ count: '
          f'number {cz_counts}, {len(good)} at {want_cz} CZ with host loss <= '
          f'1e-6; kernel launches {launches}; synthesis wall {wall:.3f} s '
          f'({stages}); refine of {n_ref} on the host {refine_s:.3f} s '
          f'({refine_s / n_ref:.3f} s each, {evals[1]:.3f} s of it in '
          f'{evals[0]} evaluations of Circuit.unitary): types {dict(types)}, '
          f'{len(refined)} Clifford+T at host loss <= 1e-9, {proved} proved '
          f'exact; best T depth {t_depth} with T count {t_count} at host loss '
          f'{loss:.3e}, least T count {min(r[1] for r in refined)} '
          f'({published})', flush=True)
    return launches


# float32 operations of one forward pass and of one adjoint walk of the
# ansatz, with sweep_work's terms: per amplitude of the d x C state a 1q
# gate costs 14 forwards and 44 in the walk, a 2q gate 30 and 92; the cos and
# sin of every angle 3; a surface gate's build 112 and its gradients 161; a
# block's build 112(m - 1) + 96 (+ 24 for CP's phase column, 4 for CZ's
# signs) and its gradients 368 + 102(m - 1) + 2m (+ 85 for CP, 12 for CZ).
# The walk needs the gates too, so it builds them again; it also halves and
# conjugates the cotangent (2 per amplitude).
def unitary_work(n, nb, rot='xyz', ent='cp', log_c=None):
    """dict(P, amplitudes, forward and vjp float32 operations of one
    restart, forward and vjp bytes of one restart) of the unitary kernels."""
    from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
    m = len(rot)
    P = 3 * n + num_block_angles(ent, rot) * nb
    amps = 2 ** (n + (n if log_c is None else log_c))
    gates = 3 * P + 112 * n + (112 * max(m - 1, 0) + 96 + {
        'cp': 24, 'cz': 4, 'cx': 0}[ent]) * nb
    forward = amps * (14 * n + 30 * nb) + gates
    vjp = gates + amps * (44 * n + 92 * nb + 2) + 161 * n + (
        368 + 102 * max(m - 1, 0) + 2 * m + {'cp': 85, 'cz': 12, 'cx': 0}[ent]
    ) * nb
    return dict(P=P, amps=amps, forward=forward, vjp=vjp,
                forward_bytes=4 * P + 8 * amps,
                vjp_bytes=8 * P + 16 * amps)


def unitary_bound_ms(ops, nbytes, B):
    """(least time in ms, 'operations' or 'bytes') of B restarts."""
    t_ops = ops * B / PEAK_F32 * 1e3
    t_bytes = nbytes * B / PEAK_BYTES * 1e3
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def unitary_shapes():
    """Phase 12's templates: dicts of n, ent, rot, placements, columns and
    the restarts B (default 256): the five largest layouts on one block,
    then every template and batch that phases 13 and 14 give the kernels,
    then three whose columns are split over several blocks (7 and 8
    qubits, and phase 15's 144-block Toffoli-7 template). With
    verification=True the batch is what a verification hands over: every
    other CP angle snapped to 0 or pi, and its gradient masked out."""
    from cpflow_tpu_torch.topology import (chain_layer, connected_layer,
                                           fill_layers)
    return [
        dict(name="3q chain k=12 'xyz' cp", n=3, ent='cp', rot='xyz',
             placements=fill_layers(chain_layer(3), 12)),
        dict(name="5q chain k=20 'xz' cp", n=5, ent='cp', rot='xz',
             placements=fill_layers(chain_layer(5), 20)),
        dict(name="6q connected k=40 'xyz' cp (the largest layout)", n=6,
             ent='cp', rot='xyz',
             placements=fill_layers(connected_layer(6), 40)),
        dict(name="4q 'cz' blocks on the 14 Toffoli-4 placements, 'y'", n=4,
             ent='cz', rot='y',
             placements={'layers': [[], 0], 'free': artifact_cz_placements()}),
        dict(name="10q chain k=36 'xyz' cp, column 0", n=10, ent='cp',
             rot='xyz', placements=fill_layers(chain_layer(10), 36),
             columns=[0]),
        dict(name="4q line k=10 'xyz' cp (phase 13's GHZ-4, longest template)",
             n=4, ent='cp', rot='xyz',
             placements=fill_layers(chain_layer(4), 10), B=100),
        dict(name="4q line k=3 'xyz' cp (phase 13's GHZ-4, its first trial)",
             n=4, ent='cp', rot='xyz',
             placements=fill_layers(chain_layer(4), 3), B=100),
        dict(name="3q connected k=10 'xyz' cp (phase 13's bucketed sweep)",
             n=3, ent='cp', rot='xyz',
             placements=fill_layers(connected_layer(3), 10), B=800),
        dict(name="3q connected k=2 'xyz' cp (a short adaptive trial)", n=3,
             ent='cp', rot='xyz',
             placements=fill_layers(connected_layer(3), 2), B=100),
        dict(name="3q connected k=7 'xyz' cp, a verification: 5 candidates, "
                  "every other CP angle at 0 or pi and frozen", n=3, ent='cp',
             rot='xyz', placements=fill_layers(connected_layer(3), 7), B=5,
             verification=True),
        dict(name="3q chain k=12 'xyz' cp (phase 14's non-Adam methods)",
             n=3, ent='cp', rot='xyz',
             placements=fill_layers(chain_layer(3), 12), B=64),
        dict(name="3q chain k=8 'xz' cp (phase 14's Ansatz.learn)", n=3,
             ent='cp', rot='xz', placements=fill_layers(chain_layer(3), 8),
             B=200),
        dict(name="7q chain k=24 'xyz' cp (phase 15's rows (q)-(v))", n=7,
             ent='cp', rot='xyz', placements=fill_layers(chain_layer(7), 24),
             B=64),
        dict(name="8q chain k=16 'xz' cp (phase 15's row (w))", n=8,
             ent='cp', rot='xz', placements=fill_layers(chain_layer(8), 16),
             B=16),
        dict(name="the Toffoli-7 composite's 144 placements 'xyz' cp "
                  "(phase 15's program)", n=7, ent='cp', rot='xyz',
             placements={'layers': [[], 0], 'free': toffoli7_program()[2]},
             B=8),
    ]


def unitary_plan(n, nb, nba, log_c, name):
    """(forward, vjp) blocks a restart of the unitary kernels: the plan of
    kernels/unitary.py (cluster_plan, smem_bytes) must agree with the
    kernels' (cpflow_unitary_cluster, cpflow_unitary_smem_bytes)."""
    from cpflow_tpu_torch.kernels import unitary as uk
    lib = uk.load_library()
    out = []
    for vjp in (False, True):
        c = uk.cluster_plan(n, nb, nba, log_c, vjp)
        mine = uk.smem_bytes(n, nb, nba, log_c, vjp, c)
        card = lib.cpflow_unitary_smem_bytes(n, nb, nba, log_c, int(vjp), c)
        theirs = lib.cpflow_unitary_cluster(n, nb, nba, log_c, int(vjp))
        check(c == theirs and mine == card,
              f'{name}: the plan says {c} blocks of {mine} bytes for the '
              f'{"vjp" if vjp else "forward pass"}, the kernels {theirs} '
              f'blocks of {card} bytes')
        out.append(c)
    return tuple(out)


def random_unitary(rng, d):
    """A complex d x d unitary from a numpy generator (QR of a Ginibre
    matrix)."""
    import numpy as np
    q, _ = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    return q


def phase_unitary(card):
    """Phase 12: the forward and vjp kernels of kernels/unitary.py against
    their plain version (sim.batched.build_unitary_batched under autograd)
    on the card, same inputs, B = 256 restarts at the five largest layouts
    and, at every template that phases 13 and 14 drive, the batch they
    drive it with (unitary_shapes), angles uniform in [0, 2 pi) from a
    seeded numpy generator. Tolerances: the unitary within 2e-5 in
    every entry (complex64, two float32 derivations of at most 46 gates);
    the angle gradients within 1e-4 of autograd's, each scaled by
    max(1, |gradient|), for two cotangents: that of the HS test against a
    complex random unitary (of the state loss against its first column where
    only column 0 is built), which catches a missing conjugate, and a
    random complex cotangent; at 3 qubits the kernel's gradient within 1e-3
    of central differences (h = 1e-4) of the plain path in float64. Then the
    times of both kernels at the static sampling shape and the 5q k=20
    B=2048 shape beside their bounds and the plain version's times: of one
    call of the wrapper (CUDA events, the faster of two; at these sizes
    mostly the host's launch path) and of the kernel alone on the card
    (torch.profiler), against which the share of the bound is taken where
    the trace has it.
    Returns (largest errors by kernel, timing rows by kernel)."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import Ansatz
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    from cpflow_tpu_torch.sim.batched import (batched_cost_hst,
                                              batched_state_prep,
                                              build_unitary_batched)
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    dev = 'cuda'
    worst = {'ansatz_forward': 0.0, 'ansatz_vjp': 0.0}

    def scaled(a, b):
        return ((a - b).abs() / b.abs().clamp(min=1.0)).max().item()

    for i, s in enumerate(unitary_shapes()):
        rng = np.random.default_rng(1200 + i)
        n, ent, rot, pl = s['n'], s['ent'], s['rot'], s['placements']
        cols, B = s.get('columns'), s.get('B', 256)
        tpl = (n, ent, rot, pl)
        nba, nb = num_block_angles(ent, rot), len(all_placements(pl))
        P = 3 * n + nba * nb
        d = 2 ** n
        blocks = unitary_plan(n, nb, nba, 0 if cols else n, s['name'])
        drawn = rng.uniform(0, 2 * math.pi, (P, B))
        mask = None
        if s.get('verification'):
            frozen = np.nonzero(Ansatz(n, ent, pl, rot).cp_mask)[0][::2]
            drawn[frozen] = math.pi * rng.integers(0, 2, (len(frozen), B))
            mask = torch.ones(P, B, device=dev)
            mask[torch.as_tensor(frozen, device=dev)] = 0
        angles = torch.tensor(drawn, dtype=torch.float32, device=dev)
        before = (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES)
        u_k = uk.ansatz_forward(*tpl, angles, cols)            # (B, d, C)
        a_p = angles.clone().requires_grad_(True)
        u_p = build_unitary_batched(*tpl, a_p, columns=cols)
        check(u_k.shape == (B, d, d if cols is None else 1) and
              bool(torch.isfinite(torch.view_as_real(u_k)).all()),
              f'{s["name"]}: bad forward output {tuple(u_k.shape)}')
        err_f = (u_k.permute(1, 2, 0).reshape(u_p.shape) - u_p).abs().max() \
            .item()
        check(err_f <= 2e-5, f'{s["name"]}: unitary differs by {err_f}')
        q = random_unitary(rng, d)
        if cols is None:
            loss_of = lambda u: batched_cost_hst(u, q)
        else:
            loss_of = lambda u: batched_state_prep(u, q[:, 0])
        w = torch.view_as_complex(torch.tensor(
            rng.normal(size=tuple(u_p.shape) + (2,)), dtype=torch.float32,
            device=dev))
        a_k = angles.clone().requires_grad_(True)
        g_k, = torch.autograd.grad(
            loss_of(uk.build_unitary(*tpl, a_k, columns=cols)).sum(), a_k)
        h_k, = torch.autograd.grad(uk.build_unitary(*tpl, a_k, columns=cols),
                                   a_k, grad_outputs=w)
        g_p, = torch.autograd.grad(loss_of(u_p).sum(), a_p, retain_graph=True)
        h_p, = torch.autograd.grad(u_p, a_p, grad_outputs=w)
        if mask is not None:    # as the Adam loop masks them
            g_k, h_k, g_p, h_p = (g * mask for g in (g_k, h_k, g_p, h_p))
        torch.cuda.synchronize()
        check(uk.FORWARD_LAUNCHES == before[0] + 3 and
              uk.VJP_LAUNCHES == before[1] + 2,
              f'{s["name"]}: the kernels were not launched')
        err_g, err_h = scaled(g_k, g_p), scaled(h_k, h_p)
        check(err_g <= 1e-4 and err_h <= 1e-4,
              f'{s["name"]}: gradient differs from autograd: loss cotangent '
              f'{err_g}, random cotangent {err_h}')
        line = (f'phase 12: {s["name"]} B={B}: forward on {blocks[0]}, vjp '
                f'on {blocks[1]} block(s) a restart; unitary error max '
                f'{err_f:.2e}; gradient error (scaled by max(1, |grad|)) loss '
                f'cotangent '
                f'{err_g:.2e} (|grad| up to {g_p.abs().max().item():.3g}), '
                f'random cotangent {err_h:.2e} (|grad| up to '
                f'{h_p.abs().max().item():.3g})')
        if n == 3:  # central differences of the plain path in float64
            h, errs = 1e-4, []
            for b in (0, 1):
                base = angles[:, b].double()
                shifted = torch.cat([base[:, None] + h * torch.eye(
                    P, dtype=torch.float64, device=dev), base[:, None] -
                    h * torch.eye(P, dtype=torch.float64, device=dev)], dim=1)
                with torch.no_grad():
                    ls = loss_of(build_unitary_batched(
                        *tpl, shifted, columns=cols, dtype=torch.float64))
                fd = (ls[:P] - ls[P:]) / (2 * h)
                if mask is not None:
                    fd = fd * mask[:, b]
                errs.append((fd - g_k[:, b].double()).abs().max().item())
            check(max(errs) <= 1e-3, f'{s["name"]}: kernel gradient differs '
                  f'from float64 central differences by {max(errs)}')
            line += f'; against float64 central differences {max(errs):.2e}'
        print(line, flush=True)
        worst['ansatz_forward'] = max(worst['ansatz_forward'], err_f)
        worst['ansatz_vjp'] = max(
            worst['ansatz_vjp'], (g_k - g_p).abs().max().item(),
            (h_k - h_p).abs().max().item())

    rows = {'ansatz_forward': [], 'ansatz_vjp': []}
    for name, n, k, Bt in [('3q chain k=12 B=1024', 3, 12, 1024),
                           ('5q chain k=20 B=2048', 5, 20, 2048),
                           ('7q chain k=24 B=64', 7, 24, 64),
                           ('8q chain k=16 B=16', 8, 16, 16)]:
        tpl = (n, 'cp', 'xyz', fill_layers(chain_layer(n), k))
        work = unitary_work(n, k)
        rng = np.random.default_rng(1250 + n)
        angles = torch.tensor(rng.uniform(0, 2 * math.pi, (work['P'], Bt)),
                              dtype=torch.float32, device=dev)
        u = uk.ansatz_forward(*tpl, angles)                    # warm-up
        w = torch.view_as_complex(torch.tensor(
            rng.normal(size=tuple(u.shape) + (2,)), dtype=torch.float32,
            device=dev))
        uk.ansatz_vjp(*tpl, angles, u, w)                      # warm-up
        f_ms = min(timed(lambda: uk.ansatz_forward(*tpl, angles))[1]
                   for _ in range(2))
        v_ms = min(timed(lambda: uk.ansatz_vjp(*tpl, angles, u, w))[1]
                   for _ in range(2))
        pf, pv = [], []
        for _ in range(3):                    # the first call warms up
            a_p = angles.clone().requires_grad_(True)
            u_p, ms = timed(lambda: build_unitary_batched(*tpl, a_p))
            w_p = w.permute(1, 2, 0).reshape(u_p.shape)
            pf.append(ms)
            pv.append(timed(lambda: torch.autograd.grad(
                u_p, a_p, grad_outputs=w_p))[1])
        f_dev = device_ms(lambda: uk.ansatz_forward(*tpl, angles),
                          'forward_kernel')
        v_dev = device_ms(lambda: uk.ansatz_vjp(*tpl, angles, u, w),
                          'vjp_kernel')
        regs = uk.registers()
        blocks = unitary_plan(n, k, num_block_angles('cp', 'xyz'), n, name)
        for kernel, ms, on_card, plain, ops, nbytes, c in [
                ('ansatz_forward', f_ms, f_dev, min(pf[1:]), work['forward'],
                 work['forward_bytes'], blocks[0]),
                ('ansatz_vjp', v_ms, v_dev, min(pv[1:]), work['vjp'],
                 work['vjp_bytes'], blocks[1])]:
            b_ms, b_by = unitary_bound_ms(ops, nbytes, Bt)
            alone = 'not measured' if on_card is None else \
                f'{on_card:.4f} ms (share of bound {b_ms / on_card:.2%})'
            reg = regs['ansatz_vjp_cluster' if kernel == 'ansatz_vjp' and
                       c > 1 else kernel]
            print(f'phase 12: {kernel} {name} on {card}: {c} block(s) a '
                  f'restart; one call {ms:.4f} ms, the kernel alone on the '
                  f'card {alone}; bound {b_ms:.5f} ms by {b_by} ({ops} '
                  f'float32 ops and {nbytes} bytes per restart); plain '
                  f'{plain:.3f} ms; {reg} registers', flush=True)
            rows[kernel].append(dict(shape=name, cluster=c, ms=ms,
                                     device_ms=on_card, plain_ms=plain,
                                     bound_ms=b_ms, bound_by=b_by,
                                     registers=reg))
    return worst, rows


class PlainBuilderWatch:
    """Counts calls of the plain builder (sim.batched.build_unitary_batched)
    while a main path runs on the card: such a path takes its unitary from
    the kernels, so the count must stay 0."""

    def __enter__(self):
        from cpflow_tpu_torch.kernels import unitary as uk
        from cpflow_tpu_torch.sim import batched as tbt
        self.calls = 0
        self.modules, self.plain = (uk, tbt), tbt.build_unitary_batched

        def counted(*args, **kw):
            self.calls += 1
            return self.plain(*args, **kw)

        for m in self.modules:
            m.build_unitary_batched = counted
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.build_unitary_batched = self.plain


def on_device(array):
    """A numpy constant as a tensor of u's dtype on u's device, made once
    per dtype and device (a custom loss runs every step: it must not copy
    its constants to the card each time)."""
    import torch
    made = {}

    def get(u):
        key = (u.dtype, u.device)
        if key not in made:
            made[key] = torch.as_tensor(array, dtype=u.dtype, device=u.device)
        return made[key]
    return get


def run_custom_adaptive(synth, options):
    """synth.adaptive(options) with the unitary kernels' launch counts set
    to 0 just before and read just after, and the plain builder watched.
    Returns (results, forward launches, vjp launches, sweep launches, plain
    builder calls, wall seconds)."""
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.kernels import unitary as uk
    with PlainBuilderWatch() as watch:
        uk.FORWARD_LAUNCHES = uk.VJP_LAUNCHES = sk.LAUNCHES = 0
        start = time.perf_counter()
        results = synth.adaptive(options, save_results=False, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES, sk.LAUNCHES)
    return (results, *counts, watch.calls, wall)


REL_STEPS = 1000  # phase 13's relative-phase Toffoli-3: sampling steps


def phase_custom_loss():
    """Phase 13: the reference notebook's two custom-loss syntheses
    (benchmarks/full_notebook_run.py, cells 24-30) with the losses written
    in torch, AdaptiveOptions defaults (100 samples, 2000 + 5000 steps) but
    max_evals cut from 100 to 8: GHZ-4 on the line with
    1 - |<ghz|U|0>|^2, k in [0, 10], stopping at 3 CZ, which must reach 3
    CZ at host loss <= 1e-6; the same run with target_state (the fused
    kernel), which must reach the same CZ count; and the relative-phase
    Toffoli-3 on full connectivity with 1 - sum |conj(T) * U|^2 / 8, then
    refine() of its last decomposition. The Toffoli's 8 trials run
    bucketed, side by side in one sweep of 8 x 100 restarts padded to k=10
    (bucketed=True, parallel_trials=8): a custom-loss step costs host time
    whatever the batch, so one trial after the other (7 sweeps until k=7
    comes up) took 56-71 s for the same trials. Its sampling sweep is cut
    from 2000 to REL_STEPS steps (a step is 3-7 ms of host time). It must
    verify a decomposition with a finite loss; its CZ count is printed, not
    held to 3. Every custom-loss sweep must go through the forward and vjp kernels,
    and never through the plain builder or the fused sweep kernel."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import AdaptiveOptions, Synthesize
    from cpflow_tpu_torch.ops.gates import u_toff3
    max_evals = 8
    make_options = lambda **kw: AdaptiveOptions(
        min_num_cp_gates=0, max_num_cp_gates=10, target_num_cz_gates=3,
        stop_if_target_reached=True, max_evals=max_evals, **kw)
    line = [[0, 1], [1, 2], [2, 3]]
    ghz4, psi0 = on_device(ghz(4)), on_device(np.eye(16)[0])
    ghz_loss = lambda u: 1 - torch.abs(ghz4(u).conj() @ u @ psi0(u)) ** 2
    launches = {}

    synth = Synthesize(line, unitary_loss_func=ghz_loss)
    results, fwd, vjp, fused, plain, wall = run_custom_adaptive(
        synth, make_options())
    check(fwd > 0 and vjp > 0 and fused == 0 and plain == 0,
          f'GHZ-4 custom loss: forward {fwd}, vjp {vjp}, fused sweep {fused} '
          f'launches, plain builder {plain} calls')
    decs = results.decompositions
    target = ghz(4).astype(np.complex128)
    hosts = sorted((d.cz_count, float(1 - abs(
        target.conj() @ d.circuit.unitary()[:, 0]) ** 2)) for d in decs)
    check(hosts and hosts[0][0] == 3 and hosts[0][1] <= 1e-6,
          f'GHZ-4 custom loss: no 3-CZ decomposition at host loss <= 1e-6 in '
          f'{len(results.trials.results)} evals: {hosts}')
    check(all(abs(d.loss - h) <= 1e-9 for d, h in zip(
        sorted(decs, key=lambda d: d.cz_count), (h for _, h in hosts))),
          'GHZ-4 custom loss: the host evaluation of the callable differs')
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    evals_custom = len(results.trials.results)
    print(f'phase 13: adaptive GHZ-4 line, custom loss, max_evals cut to '
          f'{max_evals}: {evals_custom} evals, verified (CZ, host loss) '
          f'{[(c, float(f"{h:.3e}")) for c, h in hosts]}; forward launches '
          f'{fwd}, vjp launches {vjp}, plain builder calls {plain}; wall '
          f'{wall:.3f} s ({stages})', flush=True)
    launches['adaptive_ghz4_custom'] = (fwd, vjp)

    fused_synth = Synthesize(line, target_state=ghz(4))
    results, fwd, vjp, fused, plain, wall = run_custom_adaptive(
        fused_synth, make_options())
    best = min(d.cz_count for d in results.decompositions) \
        if results.decompositions else None
    check(fused > 0 and fwd == 0 and vjp == 0 and best == hosts[0][0],
          f'GHZ-4 by target_state: {fused} sweep launches, forward {fwd}, '
          f'vjp {vjp}, best CZ count {best} against the custom loss\'s '
          f'{hosts[0][0]}')
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in fused_synth.stage_seconds.items())
    print(f'phase 13: the same with target_state (the fused sweep kernel): '
          f'{len(results.trials.results)} evals, best {best} CZ; sweep '
          f'launches {fused}; wall {wall:.3f} s ({stages})', flush=True)
    sweep_launches = fused

    t3 = on_device(u_toff3.conj())
    rel_loss = lambda u: 1 - (torch.abs(t3(u) * u) ** 2).sum() / 8
    synth = Synthesize([[0, 1], [1, 2], [0, 2]], unitary_loss_func=rel_loss)
    results, fwd, vjp, fused, plain, wall = run_custom_adaptive(
        synth, make_options(bucketed=True, parallel_trials=max_evals,
                            num_gd_iterations=REL_STEPS))
    check(fwd > 0 and vjp > 0 and fused == 0 and plain == 0,
          f'relative-phase Toffoli-3: forward {fwd}, vjp {vjp}, fused sweep '
          f'{fused} launches, plain builder {plain} calls')
    trials = results.trials.results
    check(all(np.isfinite(t['loss']) for t in trials),
          f'a trial without a finite score: {[t["loss"] for t in trials]}')
    decs = results.decompositions
    check(decs and all(np.isfinite(d.loss) for d in decs),
          f'relative-phase Toffoli-3: no verified decomposition in '
          f'{len(trials)} evals')
    last = decs[-1]
    cz, before = last.cz_count, last.loss
    start = time.perf_counter()
    refined = last.refine()
    refine_s = time.perf_counter() - start
    check(np.isfinite(last.loss) and last.cz_count <= cz,
          f'refine of the relative-phase Toffoli-3: {refined}, loss '
          f'{last.loss}, CZ {cz} -> {last.cz_count}')
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    print(f'phase 13: adaptive relative-phase Toffoli-3 connected, custom '
          f'loss, max_evals cut to {max_evals}, sampling steps cut from 2000 '
          f'to {REL_STEPS}, bucketed, {max_evals} trials '
          f'in one sweep: {len(trials)} evals recorded before the target '
          f'(k {[t["num_cp_gates"] for t in trials]}), verified CZ counts '
          f'{sorted(d.cz_count for d in decs)}; the last ({cz} CZ, '
          f'host loss {before:.3e}): {refined} at host loss {last.loss:.3e} '
          f'in {refine_s:.3f} s on the host; forward launches {fwd}, vjp '
          f'launches {vjp}, plain builder calls {plain}; wall {wall:.3f} s '
          f'({stages})', flush=True)
    launches['adaptive_relphase_toffoli3_custom'] = (fwd, vjp)
    return launches, sweep_launches


def phase_engine():
    """Phase 14: the engine on the card. Ansatz.learn as the tutorial calls
    it (Toffoli-3 on the 3q chain, k=8, 'xz', 200 restarts, the default 5000
    Adam steps, keep_history=False), and with keep_history=True over 500
    steps: history shapes, and loss[i] recomputed at params[i] with the
    plain one-unitary builder for three i (1e-5). Then
    StaticOptions(method=...) for 'natural adam', 'hessian' and 'angle by
    angle' on the 3q chain CCZ (k=12, 64 samples) at small budgets, through
    Synthesize.static with a verification of 3 steps by the same method:
    every number finite, and some restart's objective below its start.
    The gradients and the coordinate descent's probes must go through the
    unitary kernels; the preconditioners' metric and Hessian are plain
    torch ops by design and are not watched."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import Ansatz, StaticOptions, Synthesize
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.ops.gates import u_ccz3, u_toff3
    from cpflow_tpu_torch.ops.losses import cost_HST
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    launches = {}

    def counted(fn):
        uk.FORWARD_LAUNCHES = uk.VJP_LAUNCHES = 0
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - start, (uk.FORWARD_LAUNCHES,
                                                  uk.VJP_LAUNCHES)

    anz = Ansatz(3, 'cp', fill_layers(chain_layer(3), 8), rotation_gates='xz')
    with PlainBuilderWatch() as watch:
        res, wall, counts = counted(lambda: anz.learn(
            u_toff3, num_repeats=200, keep_history=False))
    check(counts[0] > 0 and counts[1] > 0 and watch.calls == 0,
          f'Ansatz.learn: forward {counts[0]}, vjp {counts[1]} launches, '
          f'plain builder {watch.calls} calls')
    check(len(res) == 200 and set(res[0]) == {'params', 'loss'} and
          tuple(res[0]['params'].shape) == (2, anz.num_angles) and
          res[0]['params'].is_cuda,
          f'Ansatz.learn: {len(res)} results of keys {sorted(res[0])}')
    loss = torch.stack([r['loss'] for r in res])               # (200, 2)
    check(bool(torch.isfinite(loss).all()) and
          bool((loss[:, 1] <= loss[:, 0]).all()),
          'Ansatz.learn: a loss not finite, or a best above its start')
    print(f'phase 14: Ansatz.learn Toffoli-3 chain k=8 xz, 200 restarts x '
          f'5000 steps, keep_history=False: best loss min '
          f'{loss[:, 1].min().item():.3e}, median '
          f'{loss[:, 1].median().item():.3e}, {(loss[:, 1] < 1e-4).sum()} '
          f'under 1e-4; forward launches {counts[0]}, vjp launches '
          f'{counts[1]}; wall {wall:.3f} s', flush=True)
    launches['ansatz_learn'] = counts

    with PlainBuilderWatch() as watch:
        res, wall, counts = counted(lambda: anz.learn(
            u_toff3, num_repeats=200, keep_history=True, num_iterations=500))
    check(counts == (500, 500) and watch.calls == 0,
          f'Ansatz.learn with history: launches {counts}, plain builder '
          f'{watch.calls} calls')
    check(len(res) == 200 and
          tuple(res[0]['params'].shape) == (500, anz.num_angles) and
          tuple(res[0]['loss'].shape) == (500,),
          f'Ansatz.learn with history: shapes '
          f'{tuple(res[0]["params"].shape)}, {tuple(res[0]["loss"].shape)}')
    worst = 0.0
    for b, i in [(0, 0), (7, 250), (199, 499)]:
        again = cost_HST(anz.unitary(res[b]['params'][i]), u_toff3)
        worst = max(worst, abs(float(again) - float(res[b]['loss'][i])))
    check(worst <= 1e-5, f'Ansatz.learn with history: loss[i] differs from '
          f'the loss at params[i] by {worst}')
    print(f'phase 14: Ansatz.learn with keep_history=True, 200 restarts x 500 '
          f'steps: params (500, {anz.num_angles}) and loss (500,) per '
          f'restart, loss[i] at params[i] within {worst:.2e}; forward '
          f'launches {counts[0]}, vjp launches {counts[1]}; wall {wall:.3f} s',
          flush=True)
    launches['ansatz_learn_history'] = counts

    synth = Synthesize(chain_layer(3), target_unitary=u_ccz3)
    for method, steps in [('natural adam', 8), ('hessian', 5),
                          ('angle by angle', 2)]:
        options = StaticOptions(
            num_cp_gates=12, num_samples=64, accepted_num_cz_gates=100,
            entry_loss=10.0, method=method, num_gd_iterations=steps,
            num_gd_iterations_at_verification=3)
        raw, wall_raw, _ = counted(lambda: synth._generate_raw(
            options, keep_history=True))
        check(tuple(raw.params.shape) == (64, steps, 93) and all(bool(
            torch.isfinite(getattr(raw, f)).all()) for f in
            ('params', 'regloss', 'loss', 'reg')),
              f'{method}: a history of shape {tuple(raw.params.shape)} or '
              f'not finite')
        lowered = int((raw.regloss.min(dim=1).values < raw.regloss[:, 0])
                      .sum())
        check(lowered > 0, f'{method}: no restart below its start')
        results, wall, counts = counted(lambda: synth.static(
            options, save_results=False, verbose=False))
        check(counts[0] > 0 and (counts[1] > 0 or method == 'angle by angle'),
              f'{method}: forward {counts[0]}, vjp {counts[1]} launches')
        check(all(np.isfinite(d.loss) for d in results.decompositions),
              f'{method}: a decomposition with a loss not finite')
        stages = ', '.join(f'{k} {v:.3f} s'
                           for k, v in synth.stage_seconds.items())
        print(f'phase 14: StaticOptions(method={method!r}) 3q chain CCZ k=12, '
              f'64 samples, {steps} steps: objective start median '
              f'{raw.regloss[:, 0].median().item():.4f}, best median '
              f'{raw.regloss.min(dim=1).values.median().item():.4f}, '
              f'{lowered} of 64 restarts below their start; raw stage with '
              f'history {wall_raw:.3f} s; static wall {wall:.3f} s ({stages}); '
              f'forward launches {counts[0]}, vjp launches {counts[1]}',
              flush=True)
        launches[f'static_{method.replace(" ", "_")}'] = counts
    return launches


# ------------------------------------------------ phase 15: 7 and 8 qubits

@functools.lru_cache(maxsize=1)
def toffoli7_program():
    """The 144-CZ connected Toffoli-7 of
    benchmarks/artifacts/toffoli7_connected_composite.json: (its circuit,
    its metadata, the CZ placements of its exact embedding in the CP
    ansatz, those exact angles), embedded by the port's
    circuits.to_ansatz.circuit_to_ansatz."""
    from cpflow_tpu_torch.circuits.ir import Circuit
    from cpflow_tpu_torch.circuits.to_ansatz import circuit_to_ansatz
    path = Path(__file__).resolve().parent / 'benchmarks' / 'artifacts' / \
        'toffoli7_connected_composite.json'
    meta = json.loads(path.read_text())
    qc = Circuit(meta['num_qubits'])
    for ins in meta['instructions']:
        qc.append(ins['name'], tuple(ins['qubits']), ins.get('param'))
    placements, angles = circuit_to_ansatz(qc)
    placements = [list(p) for p in placements]
    check({w for p in placements for w in p} == set(range(qc.num_qubits)),
          'the Toffoli-7 embedding leaves a wire without a block')
    return qc, meta, placements, angles


def build_warm_batch(angles, cp_mask, batch, seed):
    """(batch, P) float32 initial angles and the noise sigma of each row,
    as benchmarks/warmstart6q.py:build_warm_batch makes them: row 0 the
    exact angles, the first three quarters noisy copies on the sigma ladder
    3e-3 ... 0.3 (CP angles at sigma / 3), the last quarter uniform random
    controls (sigma -1)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    P = angles.shape[0]
    rot_mask = 1.0 - cp_mask
    n_warm = max(1, (3 * batch) // 4)
    sigmas = np.array([0.003, 0.01, 0.03, 0.1, 0.3])
    out = np.empty((batch, P), dtype=np.float32)
    sig_of_row = np.zeros(batch, dtype=np.float64)
    for b in range(n_warm):
        s = sigmas[(b - 1) % len(sigmas)] if b else 0.0
        noise = rng.normal(0.0, 1.0, P) * (s * rot_mask + (s / 3) * cp_mask)
        out[b] = angles + noise
        sig_of_row[b] = s
    for b in range(n_warm, batch):
        out[b] = rng.uniform(0.0, 2 * np.pi, P)
        sig_of_row[b] = -1.0
    return out, sig_of_row


def ladder7():
    """The 7-qubit CX ladder CX(0,1), then CX(1,2), ..., CX(5,6): 6 CZ on
    the chain, and no fewer."""
    from cpflow_tpu_torch.circuits.ir import Circuit
    qc = Circuit(7)
    for q in range(6):
        qc.cx(q, q + 1)
    return qc.unitary()


def seven_shapes():
    """Phase 15's rows (q)-(y) and (z1)-(z3), as phase 3's shapes, each
    with the blocks a restart must run on (`cluster`) and its steps T where
    not 60. (z1)-(z3) are the shapes phase 15's main paths give the kernel:
    (c)'s static sampling and its verification (StaticOptions' r, the
    verification's learning rate, gradient mask and target loss), and (b)'s
    verification at k = 144. At 7
    qubits plain float32 itself drifts from float64 in 60 steps on (q),
    (s), (t) and (u) (within 1e-4: 83-90%, 69-80%, 91-92% and 84% of the
    restarts, CPU tests of the plain version; on the disc loss and at 8
    qubits 100%), and in 20 steps on the 144 blocks of (y) (62.5% on the
    card): as phase 3's deep templates, they are arbiter shapes, and they
    run 64-256 restarts so that the arbiter's margin of 5 points is not
    one or two restarts."""
    from cpflow_tpu_torch.api import BasicOptions, StaticOptions
    from cpflow_tpu_torch.ops.gates import multi_controlled_x
    t7, t8 = multi_controlled_x(7), multi_controlled_x(8)
    cz144 = {'free': toffoli7_program()[2]}
    verify = dict(r=0.0, lr=BasicOptions.learning_rate_at_verification,
                  mask=True, target_loss=BasicOptions.target_loss)
    return [
        dict(name='(q) 7q chain Toffoli-7 k=24 B=256', n=7, k=24, target=t7,
             B=256, r=0.002, lr=0.1, arbiter=True, cluster=2),
        dict(name='(r) disc 7q chain Toffoli-7 k=24 B=64', n=7, k=24,
             target=t7, kind='disc', B=64, r=0.002, lr=0.1, cluster=2),
        dict(name="(s) modulo_diagonal 7q chain Toffoli-7 wires [2, 5, 0] "
             "'xz' k=16 B=256", n=7, k=16, target=t7, kind='modulo_diagonal',
             wires=[2, 5, 0], rot='xz', B=256, r=0.00055, lr=0.1,
             arbiter=True, cluster=2),
        dict(name='(t) modulo_identity 7q chain Toffoli-7 wires [6, 1] k=16 '
             'B=128', n=7, k=16, target=t7, kind='modulo_identity',
             wires=[6, 1], B=128, r=0.00055, lr=0.1, arbiter=True,
             cluster=2),
        dict(name='(u) bucketed 7q chain Toffoli-7 k<=24 B=2x128, r and mask '
             'per trial', n=7, target=t7, ks=(12, 24), rs=(0.00055, 0.002),
             S=128, B=256, lr=0.1, seed=1500, arbiter=True, cluster=2),
        dict(name='(v) verification 7q chain Toffoli-7 k=24 B=8', n=7, k=24,
             target=t7, B=8, r=0.0, lr=0.01, mask=True, target_loss=0.7,
             cluster=2),
        dict(name="(w) 8q chain Toffoli-8 'xz' k=16 B=32", n=8, k=16,
             target=t8, rot='xz', B=32, r=0.002, lr=0.1, cluster=8),
        dict(name='(x) 7q chain Toffoli-7 k=220 B=8', n=7, k=220, target=t7,
             B=8, r=0.002, lr=0.1, T=10, cluster=4),
        dict(name="(y) the Toffoli-7 composite's 144 placements B=64", n=7,
             k=144, target=t7, placements=cz144, B=64, r=0.0001, lr=0.1,
             T=20, arbiter=True, cluster=2),
        dict(name=f'(z1) static sampling 7q chain CX ladder k={LADDER_K} '
             f'B={LADDER_SAMPLES}', n=7, k=LADDER_K, target=ladder7(),
             B=LADDER_SAMPLES, r=StaticOptions.r, lr=0.1, cluster=2),
        dict(name=f'(z2) verification 7q chain CX ladder k={LADDER_K} B=8',
             n=7, k=LADDER_K, target=ladder7(), B=8, cluster=2, **verify),
        dict(name="(z3) verification on the Toffoli-7 composite's 144 "
             "placements B=8", n=7, k=144, target=t7, placements=cz144, B=8,
             T=20, cluster=2, **verify),
    ]


def hst64(u, target):
    """The float64 HS-test loss of a unitary against a target."""
    import numpy as np
    t = np.asarray(target, dtype=np.complex128)
    return float(1 - abs((u * t.conj()).sum()) ** 2 / t.shape[0] ** 2)


def phase_toffoli7(card):
    """Phase 15 (b): the JAX package's warm-start protocol
    (benchmarks/warmstart6q.py, mode warm) on the 144-CZ Toffoli-7 at full
    width, as benchmarks/run_queue32.sh ran it on the TPU: the artifact
    embedded exactly in the CP ansatz (k = 144, 'xyz') and the warm batch
    of 64 (seed 0), swept through engine.minimize_fused at r = 1e-4, then
    verify_candidates_batch (2000 steps, not 5000) on every row under the
    entry loss. Two arms from the same batch:
      * the protocol's, one sweep of 2000 steps (one segment, not four) at
        its learning rate 0.1: needs a verified decomposition with at most
        144 CZ at float64 host loss <= 1e-6;
      * 500 steps at the verification's learning rate 0.01, which brings
        noisy rows back where 0.1 throws them out of the basin: needs a
        noisy row (sigma > 0) that starts above the entry loss, ends under
        it and verifies, at a float64 host loss no further above 1e-6 than
        twice the float32 error the kernel shows at the exact angles
        (|loss0 - host loss| of row 0). Only the sweep brings such a row
        back.
    Returns (launches of both arms' sweeps and verifications, a timing row
    for each arm's sweep)."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import Ansatz, BasicOptions, LossSpec, \
        Synthesize
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.ops.gates import multi_controlled_x
    from cpflow_tpu_torch.optimize import candidates as cand
    from cpflow_tpu_torch.optimize import engine
    start = time.perf_counter()
    qc, meta, placements, exact = toffoli7_program()
    target = multi_controlled_x(7)
    k, B, r = len(placements), 64, 1e-4
    entry = BasicOptions.entry_loss
    pl = {'layers': [[], 0], 'free': placements}
    anz = Ansatz(7, 'cp', pl, 'xyz')
    obj, P = make_objective(7, k, target, r, placements=pl)
    warm, sigma = build_warm_batch(exact.astype(np.float32),
                                   np.asarray(anz.cp_mask, dtype=np.float64),
                                   B, 0)
    host0 = hst64(anz.circuit(list(warm[0])).unitary(), target)
    c, _, occ = check_plan(obj, B, 'the Toffoli-7 sweep')
    spec = LossSpec('hst', target=target)
    synth = Synthesize(placements, target_unitary=target)
    work = shape_work(dict(n=7, k=k))

    def arm(lr, T):
        """One sweep of the warm batch and the verification of its rows
        under entry: (loss0, best loss, rows under entry, verification,
        sweep ms, verification ms, sweep launches)."""
        before = sk.LAUNCHES
        raw, ms = timed(lambda: engine.minimize_fused(
            obj, torch.tensor(warm, device='cuda'), learning_rate=lr,
            num_iterations=T))
        launches = sk.LAUNCHES - before
        loss0 = raw.loss[:, 0].cpu().numpy()
        best = raw.loss[:, 1].cpu().numpy()
        check(np.isfinite(best).all() and launches == 1,
              f'the Toffoli-7 sweep at lr {lr}: {launches} launches, a loss '
              f'not finite')
        below = np.nonzero(best <= entry)[0]
        check(len(below) > 0, f'lr {lr}: no row of the warm batch under the '
              f'entry loss {entry}: best {np.sort(best)[:4]}')
        rows = torch.as_tensor(below, device='cuda')
        ver, ver_ms = timed(lambda: cand.verify_candidates_batch(
            spec, anz, raw.params[rows, 1].cpu().numpy(), learning_rate=0.01,
            num_iterations=2000, target_loss=1e-6, device='cuda'))
        per_sigma = {}  # sigma -1: the random controls
        for key in sorted(set(sigma.tolist())):
            mine = sigma == key
            under = mine[below]
            per_sigma[key] = (int(mine.sum()), int(under.sum()),
                              int(ver.success[under].sum()),
                              float(f'{best[mine].min():.3e}'))
        b_ms, b_by = bound_ms(work, B, T)
        print(f'phase 15 (b): lr {lr}: sweep of {T} steps on {card}: '
              f'{ms:.2f} ms, bound {b_ms:.3f} ms by {b_by}, share '
              f'{b_ms / ms:.2%}; best loss min {best.min():.3e}, '
              f'{len(below)} rows under entry {entry}; verification of those '
              f'({ver_ms:.2f} ms): (sigma: rows, under entry, verified, least '
              f'best loss) {per_sigma}', flush=True)
        row = dict(shape=f'Toffoli-7 composite k={k} B={B} lr={lr}', T=T,
                   cluster=c, smem_bytes=occ['smem_bytes'],
                   registers=occ['registers'], ms=ms, plain_ms=None,
                   plain_T=None, bound_ms=b_ms, bound_by=b_by)
        return loss0, below, ver, row

    sk.LAUNCHES = 0
    # the protocol's arm: the decomposition of its best verified row
    # (fewest CZ, then loss)
    loss0, below, ver, row1 = arm(0.1, 2000)
    check(bool(ver.success.any()), f'lr 0.1: no row verified: best losses '
          f'{np.sort(ver.best_loss)[:4]}')
    ok = np.nonzero(ver.success)[0]
    i = min(ok, key=lambda j: (ver.cz[j], ver.best_loss[j]))
    dec = synth._make_decomposition(anz, ver.best_angles[i])
    host = hst64(dec.circuit.unitary(), target)
    check(dec.cz_count <= meta['cz_count'] and host <= 1e-6,
          f'the best verified Toffoli-7: {dec.cz_count} CZ at host loss '
          f'{host}')
    # the verification's rate: a noisy row brought back by the sweep
    loss0_b, below_b, ver_b, row2 = arm(0.01, 500)
    back = [j for j in np.nonzero(ver_b.success)[0]
            if sigma[below_b[j]] > 0 and loss0_b[below_b[j]] > entry]
    check(len(back) > 0, 'lr 0.01: no noisy row that started above entry '
          'ended under it and verified')
    j = min(back, key=lambda j: (ver_b.cz[j], ver_b.best_loss[j]))
    dec_b = synth._make_decomposition(anz, ver_b.best_angles[j])
    host_b = hst64(dec_b.circuit.unitary(), target)
    limit = 1e-6 + 2 * abs(float(loss0[0]) - host0)
    check(dec_b.cz_count <= meta['cz_count'] and host_b <= limit,
          f'lr 0.01: the best noisy row brought back: {dec_b.cz_count} CZ at '
          f'host loss {host_b}, above {limit:.3e}')
    launches = sk.LAUNCHES
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    print(f'phase 15 (b): Toffoli-7 composite ({meta["cz_count"]} CZ, k={k}, '
          f'P={P}) warm batch of {B} on {c} blocks a restart '
          f'({occ["smem_bytes"]} shared bytes and {occ["registers"]} '
          f'registers a thread each, {occ["active_clusters"]} restarts '
          f'resident; {work["needed"]} float32 ops per restart-iter): sweep '
          f'loss0 of the exact row {loss0[0]:.3e} (float32) against float64 '
          f'host loss {host0:.3e}; lr 0.1: best verified {dec.cz_count} CZ at '
          f'float32 loss {ver.best_loss[i]:.3e}, float64 host loss '
          f'{host:.3e}; lr 0.01: {len(back)} noisy rows brought back under '
          f'entry and verified, the best (sigma {sigma[below_b[j]]}, loss0 '
          f'{loss0_b[below_b[j]]:.3e}) {dec_b.cz_count} CZ at float32 loss '
          f'{ver_b.best_loss[j]:.3e}, float64 host loss {host_b:.3e} (limit '
          f'{limit:.3e}); sweep and verification launches {launches}; wall '
          f'{wall:.3f} s', flush=True)
    return launches, [row1, row2]


LADDER_K, LADDER_SAMPLES = 8, 128  # phase 15 (c)


def phase_ladder7():
    """Phase 15 (c): Synthesize.static at 7 qubits on the chain, target the
    CX ladder (CX(0,1) first, then CX(1,2), ..., CX(5,6)), which needs 6 CZ
    on the chain: k = LADDER_K, LADDER_SAMPLES samples, accepting 6 CZ.
    Needs the kernel in both stages and a verified 6-CZ decomposition at
    float64 host loss <= 1e-6."""
    import torch
    from cpflow_tpu_torch.api import StaticOptions, Synthesize
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.topology import chain_layer
    ladder = ladder7()
    synth = Synthesize(chain_layer(7), target_unitary=ladder)
    options = StaticOptions(num_cp_gates=LADDER_K, num_samples=LADDER_SAMPLES,
                            accepted_num_cz_gates=6)
    sk.LAUNCHES = 0
    start = time.perf_counter()
    results = synth.static(options, save_results=False, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = sk.LAUNCHES
    check(launches >= 2, f'7q ladder: the kernel was launched {launches} '
          f'times: not in both the sampling and the verification stage')
    hosts = sorted((d.cz_count, hst64(d.circuit.unitary(), ladder))
                   for d in results.decompositions)
    good = [h for h in hosts if h[1] <= 1e-6]
    check(good and good[0][0] == 6, f'7q ladder: no 6-CZ decomposition at '
          f'host loss <= 1e-6: {hosts[:8]}')
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    print(f'phase 15 (c): static 7q chain CX ladder, k={LADDER_K}, '
          f'{LADDER_SAMPLES} samples: {len(hosts)} verified, {len(good)} at '
          f'host loss <= 1e-6, best {good[0][0]} CZ at {good[0][1]:.3e}; '
          f'kernel launches {launches}; wall {wall:.3f} s ({stages})',
          flush=True)
    return launches


def phase_seven(card):
    """Phase 15: seven and eight qubits. (a) the sweep kernel against its
    plain version at rows (q)-(z3) (phase_compare), on clusters of 2, 4 and
    8 blocks; (b) the Toffoli-7 program (phase_toffoli7); (c) the static 7q
    ladder (phase_ladder7); 9 qubits refused by the sweep and the unitary
    kernels. Returns (largest error of (a), the timing rows, the launches
    of (b) and (c))."""
    import numpy as np
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    start = time.perf_counter()
    worst, _, rows = phase_compare(seven_shapes(), 'phase 15 (a)')
    check({2, 4, 8} <= {r['cluster'] for r in rows},
          f'phase 15 (a) ran clusters of {sorted({r["cluster"] for r in rows})}')
    launches = {}
    launches['toffoli7_warm'], toffoli_rows = phase_toffoli7(card)
    launches['static_ladder7'] = phase_ladder7()
    obj9, P9 = make_objective(9, 2, np.eye(512, dtype=np.complex64), 0.0)
    before = (sk.LAUNCHES, uk.FORWARD_LAUNCHES)
    for name, call in [
            ('sweep', lambda: sk.sweep(obj9, uniform_inits(P9, 2, 0, 'cuda'),
                                       0.1, 1)),
            ('build_unitary', lambda: uk.build_unitary(
                9, 'cp', 'xyz', fill_layers(chain_layer(9), 2),
                uniform_inits(P9, 2, 0, 'cuda')))]:
        try:
            call()
        except ValueError as e:
            check('2 to 8 qubits' in str(e), f'9 qubits: {name}: {e}')
            print(f'phase 15: 9 qubits refused by {name}: {e}', flush=True)
        else:
            raise PhaseError(f'9 qubits: {name} did not raise')
    check((sk.LAUNCHES, uk.FORWARD_LAUNCHES) == before,
          '9 qubits: a kernel was launched')
    print(f'phase 15: wall {time.perf_counter() - start:.3f} s', flush=True)
    return worst, rows + toffoli_rows, launches


def main() -> int:
    try:
        import torch
    except ImportError:
        print('FAIL: PyTorch is not installed', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('FAIL: no CUDA device visible', file=sys.stderr)
        return 1
    try:
        import cpflow_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'FAIL: run from the root of the repository ({e})',
              file=sys.stderr)
        return 1
    start = time.perf_counter()
    try:
        card = card_line()
        print(f'phase 1: {card}; torch {torch.__version__}, CUDA '
              f'{torch.version.cuda}', flush=True)
        phase_build()
        max_err, driven, _ = phase_compare()
        launches = {'static_ccz3': phase_main_path()}
        rows = phase_timing(card)
        launches['adaptive_toffoli4'] = phase_adaptive()
        launches['static_ghz4'] = phase_state()
        launches['adaptive_relphase_toffoli4'] = phase_relphase()
        launches['adaptive_toffoli5_xz'] = phase_toffoli5_xz()
        launches['success_ratio_table3'] = phase_success_ratio()
        from cpflow_tpu_torch.api import StaticOptions
        from cpflow_tpu_torch.topology import chain_layer, connected_layer
        launches['static_toffoli3_refine'] = phase_refine(
            '(a) static Toffoli-3 connected, then refine', connected_layer(3),
            StaticOptions(num_cp_gates=7, r=1.31e-3, num_samples=100,
                          accepted_num_cz_gates=6), 6,
            'published: 6 CZ, 7 T')
        launches['static_toffoli3_chain_refine'] = phase_refine(
            '(b) static Toffoli-3 chain, then refine', chain_layer(3),
            StaticOptions(num_cp_gates=14, r=0.88e-3, num_samples=100,
                          accepted_num_cz_gates=8), 8,
            'published: 8 CZ, 7 T, T depth 3')
        unitary_err, unitary_rows = phase_unitary(card)
        unitary_launches, launches['adaptive_ghz4_state'] = \
            phase_custom_loss()
        unitary_launches.update(phase_engine())
        seven_err, seven_rows, seven_launches = phase_seven(card)
        launches.update(seven_launches)
        max_err = max(max_err, seven_err)
        check(all(v > 0 for v in launches.values()),
              f'a main path missed the sweep kernel: {launches}')
        check(all(f > 0 for f, _ in unitary_launches.values()) and
              sum(v for _, v in unitary_launches.values()) > 0,
              f'a main path missed the unitary kernels: {unitary_launches}')
        check('jax' not in sys.modules, 'jax was imported')
    except PhaseError as e:
        print(f'FAIL: {e}', file=sys.stderr)
        return 1
    print(f'all phases passed in {time.perf_counter() - start:.1f} s')
    print(card)
    # ms, plain_ms and bound_ms: the static sampling shape (phase 5, row 1),
    # the kernel and the plain version each timed over its T = 2000 steps;
    # every row of `shapes` gives the steps its plain_ms was timed over
    # (plain_T; both null where the plain version was not timed);
    # registers: per thread, as the CUDA runtime reports them;
    # no single PyTorch call computes the sweep, so library_ms is null;
    # modes, entanglers and rotation strings: those phase 3 drove;
    # shapes: phase 5's rows, phase 15's rows (q)-(z3) at their T and the
    # Toffoli-7 program's two sweeps, each with the blocks a restart ran on
    # (`cluster`; at the top, every size the kernel ran with)
    # the unitary kernels: ms (one call of the wrapper, CUDA events, as the
    # sweep's), device_ms (the kernel alone on the card, from the profiler's
    # trace; null if the trace lacks it), plain_ms and bound_ms at the same
    # 3q k=12 B=1024 shape (phase 12; `shapes` also has the 5q k=20 B=2048,
    # 7q k=24 B=64 and 8q k=16 B=16 rows, each with its `cluster`); a
    # forward pass is a chain of n + k batched gate applications and its
    # vjp a walk back through them, which no single PyTorch call computes,
    # so library_ms is null for them too
    kernels = [{
        'name': 'sweep', 'route': 'cuda',
        'source': 'cpflow_tpu_torch/csrc/sweep.cu',
        'replaces': 'cpflow_tpu/experimental/pallas_sweep.py:317',
        **driven,
        'launches': sum(launches.values()),
        'launches_by_path': launches, 'max_abs_err': max_err,
        'ms': rows[0]['ms'], 'plain_ms': rows[0]['plain_ms'],
        'bound_ms': rows[0]['bound_ms'], 'bound_by': rows[0]['bound_by'],
        'library_ms': None, 'registers': rows[0]['registers'],
        'cluster': sorted({r['cluster'] for r in rows + seven_rows}),
        'shapes': rows + seven_rows}]
    for i, name in enumerate(('ansatz_forward', 'ansatz_vjp')):
        by_path = {k: v[i] for k, v in unitary_launches.items()}
        row = unitary_rows[name][0]
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'cpflow_tpu_torch/csrc/unitary.cu',
            'replaces': 'cpflow_tpu/sim/batched.py:255',
            'launches': sum(by_path.values()), 'launches_by_path': by_path,
            'max_abs_err': unitary_err[name],
            'ms': row['ms'], 'device_ms': row['device_ms'],
            'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
            'bound_by': row['bound_by'], 'library_ms': None,
            'registers': row['registers'],
            'cluster': sorted({r['cluster'] for r in unitary_rows[name]}),
            'shapes': unitary_rows[name]})
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

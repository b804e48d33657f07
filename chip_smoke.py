#!/usr/bin/env python3
"""Smoke test of the PyTorch port (cpflow_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository: ``python3 chip_smoke.py``. It needs
one Hopper card (the sweep kernel is built for sm_90a), nvcc and PyTorch
with CUDA, and never imports JAX. Phases:

  1. the card: name and power limit, torch and CUDA versions;
  2. build of the sweep kernel from cpflow_tpu_torch/csrc/ into build/;
  3. kernel against its plain PyTorch version on the card, same inputs,
     T = 60, at six shapes: (a) 3q CCZ k=12 B=1000; (b) 5q Toffoli k=20
     B=256; (c) the verification shape B=8 with a mask, r=0, lr 0.01,
     target_loss; (d) the adaptive search's bucketed shape, 4q square
     Toffoli-4 padded to k=40, B = 4 x 256 with four r values and four
     template masks (k = 10, 20, 30, 40); (e) the state loss, 4q GHZ chain
     k=6 B=100; (f) the state loss at 10 qubits, GHZ chain k=36 B=256;
     with the tolerances stated in phase_compare and drift_ok;
  4. the static main path: Synthesize(..., device='cuda').static on the 3q
     chain CCZ (k=12, 1024 samples), which must return a decomposition with
     at most 8 CZ and float64 host loss <= 1e-6, through the kernel in both
     the sampling and the verification stage;
  5. times of the kernel and the plain version at the static sampling
     shape, at the 5q k=20 batch-2048 shape, at shape (d) for 2000 steps
     and at shape (f) for 500 steps;
  6. the adaptive main path: Synthesize(square_layer(4),
     target_unitary=u_toff4, device='cuda').adaptive with k in [10, 40],
     1024 samples, bucketed, 4 parallel trials, 8 evals, stopping at 16 CZ;
     every trial must score finitely, every sampling sweep must run the
     kernel with r differing across its restarts, and a verified
     decomposition must reach float64 host loss <= 1e-6;
  7. the state main path: Synthesize(chain_layer(4), target_state=GHZ-4,
     device='cuda').static (k=6, 100 samples, r=0.001), which must return a
     3-CZ decomposition with float64 host state loss <= 1e-6 through the
     kernel in both stages.

Each main path (4, 6, 7) runs with the kernel's launch count set to 0 just
before it and read just after. The script prints the card, a JSON line of
kernel results and, last, the JSON device line; it exits non-zero if any
phase fails or there is no card.
"""

from __future__ import annotations

import json
from collections import Counter
import math
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

def make_objective(n, k, target, r, layer=None, kind='hst'):
    """The objective on an n-qubit layer (default: the chain) with k CP
    blocks; kind 'hst' for a target unitary, 'state' for a target state."""
    from cpflow_tpu_torch.api import Ansatz, LossSpec, RegularizationOptions
    from cpflow_tpu_torch.ops.penalty import make_regularization_function
    from cpflow_tpu_torch.sim.batched import make_batched_regloss
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    anz = Ansatz(n, 'cp', fill_layers(layer or chain_layer(n), k))
    return make_batched_regloss(
        n, 'cp', 'xyz', anz.placements, LossSpec(kind, target=target),
        cp_mask=anz.cp_mask, regularization_func=make_regularization_function(
            RegularizationOptions), r=r), anz.num_angles


def ghz(n):
    import numpy as np
    t = np.zeros(2 ** n, dtype=np.complex64)
    t[0] = t[-1] = 2 ** -0.5
    return t


BUCKET_KS = (10, 20, 30, 40)
BUCKET_RS = (0.0003, 0.00055, 0.001, 0.002)


def bucketed_shape(device):
    """Shape (d): the adaptive search's bucketed sweep, four trials of 256
    restarts on the 4q square Toffoli-4 template padded to k = 40, each
    with its own r and its own template mask. Returns (objective, inits,
    mask)."""
    import torch
    from cpflow_tpu_torch.ops.gates import u_toff4
    from cpflow_tpu_torch.topology import square_layer
    obj, P = make_objective(4, 40, u_toff4, 0.0, layer=square_layer(4))
    S = 256
    obj.r = torch.tensor(BUCKET_RS, device=device).repeat_interleave(S)
    active = torch.zeros((P, len(BUCKET_KS)), device=device)
    for j, k in enumerate(BUCKET_KS):
        active[:3 * 4 + 7 * k, j] = 1.0
    mask = active.repeat_interleave(S, dim=1).contiguous()
    init = uniform_inits(P, S * len(BUCKET_KS), 300, device) * mask
    return obj, init, mask


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


# ----------------------------------------------------------------- phases

def phase_build():
    from cpflow_tpu_torch.kernels import sweep as sk
    start = time.perf_counter()
    sk.load_library()
    print(f'phase 2: built {sk.BUILD_INFO["library"]} in '
          f'{time.perf_counter() - start:.2f} s (nvcc '
          f'{sk.BUILD_INFO.get("seconds", float("nan")):.2f} s)')
    for line in sk.BUILD_INFO.get('ptxas', '').splitlines():
        if 'registers' in line or 'spill' in line:
            print('  ptxas:', line.strip())


def drift_ok(err):
    """Per-restart |kernel - plain| after 60 Adam steps. Adam's normalised
    step turns float32 rounding in nearly flat directions into full-size
    steps, so a few restarts drift apart in any two float32
    implementations (the plain float32 and float64 versions differ by up to
    1.9e-3 at 5q k=20, PERF.md). Required: 90% of restarts within 1e-4,
    the median within 1e-5, none beyond 1e-2."""
    within = (err <= 1e-4).float().mean().item()
    return (within >= 0.9 and err.median().item() <= 1e-5 and
            err.max().item() <= 1e-2), within


def phase_compare():
    """Kernel vs plain version on the card, same inputs, 60 steps. The
    losses at the initial angles must agree within 1e-5 for every restart
    (two derivations of one float32 forward pass); the best losses after
    60 steps as drift_ok says; with target_loss the success flags must be
    equal."""
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.ops.gates import multi_controlled_x, u_ccz3
    dev = 'cuda'
    shapes = [
        dict(name='(a) 3q CCZ k=12 B=1000', n=3, k=12, target=u_ccz3, B=1000,
             r=0.00055, lr=0.1, mask=False, target_loss=None),
        dict(name='(b) 5q Toffoli k=20 B=256', n=5, k=20,
             target=multi_controlled_x(5), B=256, r=0.00055, lr=0.1,
             mask=False, target_loss=None),
        dict(name='(c) verification B=8', n=3, k=12, target=u_ccz3, B=8,
             r=0.0, lr=0.01, mask=True, target_loss=0.5),
        dict(name='(d) bucketed 4q square Toffoli-4 k<=40 B=4x256, r and '
             'mask per trial', bucketed=True, B=1024, lr=0.1,
             target_loss=None),
        dict(name='(e) state 4q GHZ k=6 B=100', n=4, k=6, target=ghz(4),
             kind='state', B=100, r=0.001, lr=0.1, mask=False,
             target_loss=None),
        dict(name='(f) state 10q GHZ k=36 B=256', n=10, k=36, target=ghz(10),
             kind='state', B=256, r=0.001, lr=0.1, mask=False,
             target_loss=None),
    ]
    worst = 0.0
    for i, s in enumerate(shapes):
        mask = None
        if s.get('bucketed'):
            obj, init, mask = bucketed_shape(dev)
        else:
            obj, P = make_objective(s['n'], s['k'], s['target'], s['r'],
                                    kind=s.get('kind', 'hst'))
            init = uniform_inits(P, s['B'], 100 + i, dev)
        if s.get('mask'):
            gen = torch.Generator(device=dev).manual_seed(200 + i)
            mask = (torch.rand((P, s['B']), generator=gen, device=dev) > 0.3
                    ).float()
        before = sk.LAUNCHES
        out, ms = timed(lambda: sk.sweep(obj, init, s['lr'], 60, mask,
                                         s['target_loss']))
        check(sk.LAUNCHES > before, f'{s["name"]}: kernel not launched')
        ref, plain_ms = timed(lambda: sk.sweep_reference(
            obj, init, s['lr'], 60, mask, s['target_loss']))
        for t in out:
            check(t.shape[-1] == s['B'] and bool(torch.isfinite(t).all()),
                  f'{s["name"]}: bad output')
        err0 = (out.regloss0 - ref.regloss0).abs().max().item()
        check(err0 <= 1e-5, f'{s["name"]}: initial loss differs by {err0}')
        keep = torch.ones(s['B'], dtype=torch.bool, device=dev)
        line = (f'phase 3: {s["name"]}: kernel {ms:.2f} ms, plain '
                f'{plain_ms:.2f} ms; |regloss0| max {err0:.2e}')
        if s['target_loss'] is not None:
            ok_k = out.best_loss <= s['target_loss']
            ok_r = ref.best_loss <= s['target_loss']
            check(bool((ok_k == ok_r).all()), f'{s["name"]}: success flags '
                  f'differ: kernel {ok_k.tolist()}, plain {ok_r.tolist()}')
            line += f', success {int(ok_k.sum())}/{s["B"]} in both'
            keep = ~ok_k  # the rest ran all 60 steps in both
        worst = max(worst, err0)
        for label, a, b in [('best regloss', out.best_reg, ref.best_reg),
                            ('best loss', out.best_loss, ref.best_loss)]:
            if not bool(keep.any()):
                continue
            err = (a - b).abs()[keep]
            ok, within = drift_ok(err)
            line += (f', |{label}| max {err.max().item():.2e} median '
                     f'{err.median().item():.2e} within 1e-4 {within:.1%}')
            check(ok, f'{s["name"]}: {label} drifts beyond the rule: {line}')
            worst = max(worst, err.max().item())
        print(line, flush=True)
    return worst


def phase_main_path():
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import Synthesize, StaticOptions
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.ops.gates import u_ccz3
    from cpflow_tpu_torch.topology import chain_layer
    synth = Synthesize(chain_layer(3), target_unitary=u_ccz3, device='cuda')
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
    """Kernel and plain times. The plain version of the two new rows is
    timed over T_plain = 100 steps, not T: its time is linear in the step
    count (no early exit), and 2000 of its steps at shape (d) would take
    over a minute of the script's budget. Rates are restart-iter/s."""
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.ops.gates import multi_controlled_x, u_ccz3

    def plain_shape(n, k, target, r, B, kind='hst'):
        obj, P = make_objective(n, k, target, r, kind=kind)
        return obj, uniform_inits(P, B, 7, 'cuda'), None

    rows = []
    for name, make, T, T_plain in [
            ('3q CCZ k=12 B=1024 T=2000 (static sampling)',
             lambda: plain_shape(3, 12, u_ccz3, 0.00055, 1024), 2000, 2000),
            ('5q Toffoli k=20 B=2048 T=500',
             lambda: plain_shape(5, 20, multi_controlled_x(5), 0.00055,
                                 2048), 500, 500),
            ('(d) bucketed 4q square Toffoli-4 k<=40 B=4x256 T=2000',
             lambda: bucketed_shape('cuda'), 2000, 100),
            ('(f) state 10q GHZ k=36 B=256 T=500',
             lambda: plain_shape(10, 36, ghz(10), 0.001, 256, kind='state'),
             500, 100)]:
        obj, init, mask = make()
        B = init.shape[1]
        sk.sweep_reference(obj, init, 0.1, 2, mask)          # warm-up
        _, plain_ms = timed(lambda: sk.sweep_reference(obj, init, 0.1,
                                                       T_plain, mask))
        sk.sweep(obj, init, 0.1, 2, mask)                    # warm-up
        _, ms1 = timed(lambda: sk.sweep(obj, init, 0.1, T, mask))
        _, ms2 = timed(lambda: sk.sweep(obj, init, 0.1, T, mask))
        ms = min(ms1, ms2)
        print(f'phase 5: {name} on {card}: kernel {ms1:.2f} / {ms2:.2f} ms '
              f'= {B * T / (ms / 1e3):.4g} restart-iter/s; plain '
              f'{plain_ms:.2f} ms over {T_plain} steps = '
              f'{B * T_plain / (plain_ms / 1e3):.4g} restart-iter/s',
              flush=True)
        rows.append((ms, plain_ms))
    return rows[0]


def phase_adaptive():
    """The adaptive main path on the 4q square Toffoli-4 (the shape of the
    JAX package's toffoli4_square benchmark config: k in [10, 40], 1024
    samples, published 16 CZ). Every bucketed sampling sweep is watched: it
    must launch the kernel, with as many distinct r values across its
    restarts as it runs trials."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import AdaptiveOptions, Synthesize
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.optimize import candidates as cand
    from cpflow_tpu_torch.ops.gates import u_toff4
    from cpflow_tpu_torch.topology import square_layer
    stage = cand.run_bucketed_stage
    sweeps = []

    def watched(objective, seeds, rs, *args, **kw):
        before = sk.LAUNCHES
        out = stage(objective, seeds, rs, *args, **kw)
        sweeps.append((len(rs), len(set(np.float32(rs).tolist())),
                       sk.LAUNCHES - before))
        return out

    options = AdaptiveOptions(min_num_cp_gates=10, max_num_cp_gates=40,
                              num_samples=1024, bucketed=True,
                              parallel_trials=4, max_evals=8,
                              target_num_cz_gates=16,
                              stop_if_target_reached=True)
    synth = Synthesize(square_layer(4), target_unitary=u_toff4,
                       device='cuda')
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
                         for n, distinct, calls in sweeps),
          f'a sampling sweep missed the kernel or r per restart: {sweeps}')
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
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    print(f'phase 6: adaptive Toffoli-4 square, bucketed, 4 parallel trials:'
          f' {len(trials)} evals in {len(sweeps)} sampling sweeps; best '
          f'{best[0]} CZ at host loss {best[1]:.3e} (published 16); '
          f'verified {sorted(h[0] for h in hosts)}; trials (k, r, score) '
          f'{[(t["num_cp_gates"], round(t["r"], 6), round(t["loss"], 3)) for t in trials]}; '
          f'kernel launches {launches}; wall {wall:.3f} s ({stages})',
          flush=True)
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
    synth = Synthesize(chain_layer(4), target_state=target, device='cuda')
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
    try:
        card = card_line()
        print(f'phase 1: {card}; torch {torch.__version__}, CUDA '
              f'{torch.version.cuda}', flush=True)
        phase_build()
        max_err = phase_compare()
        launches = {'static_ccz3': phase_main_path()}
        ms, plain_ms = phase_timing(card)
        launches['adaptive_toffoli4'] = phase_adaptive()
        launches['static_ghz4'] = phase_state()
        check('jax' not in sys.modules, 'jax was imported')
    except PhaseError as e:
        print(f'FAIL: {e}', file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({'kernels': [{
        'name': 'sweep', 'route': 'cuda',
        'source': 'cpflow_tpu_torch/csrc/sweep.cu',
        'replaces': 'cpflow_tpu/experimental/pallas_sweep.py:317',
        'modes': ['hst', 'state'], 'launches': sum(launches.values()),
        'launches_by_path': launches, 'max_abs_err': max_err,
        'ms': ms, 'plain_ms': plain_ms}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())

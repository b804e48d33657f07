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
     blocks with rotations 'y', 3q chain CCZ k=8 B=256; then (q6), (r64)
     and (s)-(u) (compare_shapes: (s)-(t64) one block too deep for the
     column build, (u) a 10q state at B=700); each through the build the
     plans give it (the column build, or the one-block build on
     rows.cuh's warps: (e), (f), (s)-(u)), with the tolerances stated in
     phase_compare and drift_ok;
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
     Decomposition.refine (host, float64) on every decomposition found, in
     two settings: (a) Toffoli-3 on full connectivity, k=7, r=1.31e-3, 100
     samples, which must give a 6-CZ decomposition at float64 host loss
     <= 1e-6 through the kernel in both stages and refine one in every 12
     found (the paper refined 12) to 'Clifford+T' at host loss <= 1e-9
     with its CZ count unchanged and T count 7, proved equal to the
     Toffoli over the cyclotomic integers where the circuit's angles allow
     it; (b) Toffoli-3 on the chain, k=14, r=0.88e-3, 100 samples, 8 CZ,
     the best T count and T depth printed beside the paper's 7 and 3;
 12. the forward and vjp kernels of the differentiable ansatz
     (kernels/unitary.py) against their plain version on the card at
     fifteen templates, each through the design the plan gives it (the
     column design, one lane per column, for the whole unitary at 2 to 6
     qubits; the row-split design's plan for one column and for the vjp at
     7 and 8 qubits, on a cluster on tiles.cuh's warps; the column tiles
     for the forward pass from 7 qubits),
     the plan held against the library's: at B=256, 3q k=12 'xyz' cp, 5q
     k=20 'xz' cp, 6q connected k=40 (the largest layout on one block), 4q
     'cz' blocks with 'y', 10q k=36 column 0; then every template of phases
     13 and 14 at the batch they give it, a verification's few candidates
     with frozen CP angles among them; then the whole unitary split over
     several blocks: 7q chain k=24 B=64, 8q chain k=16 'xz' B=16 and the
     Toffoli-7 composite's 144 placements B=8; the unitary within 2e-5,
     the gradients of two cotangents within 1e-4 scaled by max(1,
     |gradient|), at 3q also against float64 central differences (1e-3);
     the column kernels with 0 bytes of stack, spills (ptxas) and local
     memory (runtime); then both kernels' times beside their bounds at the
     seven shapes of UNITARY_TIMING (3q k=12 B=1024, 5q k=20 B=2048, 7q
     k=24 B=64, 8q k=16 B=16, and the three that phases 13 and 14 launch
     most: 3q k=8 'xz' B=200, 4q k=10 B=100, 3q connected k=10 B=800), the
     row-split design timed in turns with the column design wherever the
     plan takes the latter, and at 7 and 8 qubits two launches of each
     pass on the same inputs giving the same bits;
 13. the custom-loss path: the reference notebook's GHZ-4 and
     relative-phase Toffoli-3 syntheses with the losses as torch callables
     (adaptive, k in [0, 10], stopping at 3 CZ, max_evals cut to 8), which
     must run through the forward and vjp kernels, every launch in the
     column design, and never through the plain builder; GHZ-4 must reach 3 CZ at host loss <= 1e-6, as the same
     run with target_state (the fused kernel) does; the relative-phase
     Toffoli-3's 8 trials run bucketed in one sweep of 1000 steps (2000 in
     the notebook), and its last decomposition is refined;
 14. the engine: Ansatz.learn (Toffoli-3, 200 restarts, without and with a
     history) and StaticOptions(method=...) for 'natural adam', 'hessian'
     and 'angle by angle' on the 3q chain CCZ at small budgets, every
     launch of the unitary kernels in the column design;
 15. seven and eight qubits, each restart's columns split over a cluster of
     2, 4 or 8 thread blocks on tiles.cuh's warps (the cluster build,
     sweep_cluster_kernel, every launch of the phase): (a) the sweep
     kernel against its plain
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
     Synthesize.static on the 7q chain for the CX ladder (6 CZ); the whole
     unitary one qubit past its limit (14 qubits in float32) and a modulo
     loss at 9 qubits must be refused. Every cluster launch checks that its
     blocks end with the same Adam state (the kernel traps otherwise);
 16. the command line and the restart split (parallel/mesh.py) on the one
     card, where a mesh lists cuda:0 more than once: (a) ``python -m
     cpflow_tpu_torch info`` and ``synthesize --target ccz --layer chain
     --static --num-cp-gates 12 --num-samples 1024 --accepted-cz 8
     --no-save`` as subprocesses (the second run as ``-m`` runs it, through
     runpy, so that its launch count can be read at its end), which must
     exit 0 and find an 8-CZ decomposition at loss <= 1e-6; (b)
     Synthesize.static on the 3q chain CCZ (1024 samples) with mesh
     [cuda:0, cuda:0] against no mesh: the same sorted CZ lists, losses
     within 1e-6 pair by pair, the sampling stage launching the sweep once
     per shard, the current device unchanged, and the kernel library's
     runtime seeing the last card as current under the launch guard (on
     one card that is cuda:0, current anyway, so the guard is not
     exercised); (c) the sampling sweep (3q k=12, B=1024, T=2000)
     through minimize_fused split 2 ways against the whole batch: bit-equal
     where both run the same kernel build (occupancy), else within
     drift_ok; (d) two processes over gloo (distributed_init on 127.0.0.1,
     a shard each on cuda:0), each holding the whole gathered result,
     equal to (c)'s whole batch under (c)'s rule, each with 120 s to end;
     (e) parallel.dryrun.dryrun_multichip(4). (b), (c) and (e) run first,
     with the card to themselves; the subprocesses of (a) and (d) start
     after them, so that no timing of (b) or (c) holds another process's
     kernels;
 17. the JAX package's random-number tree (ops/prng.py) on the card: (a)
     the static CCZ's initial angles (3q chain k=12, seed 0, B=1024) drawn
     on the card equal the CPU's, bit for bit for 'uniform' and '0', within
     2e-6 for 'normal', the CPU's 'normal' draw bit-equal to itself made 10
     times more in this process and once in a fresh one, and the four
     configs of tests/golden/reference_goldens.npz drawn on the card equal
     upstream's angles bit for bit; one draw timed (CUDA events; the kernels it
     launches and their time on the card from the profiler) at that shape
     and at phase 6's first bucketed stage (4 trials x 1024); (b) upstream's
     recorded 60 Adam steps (3q chain, 'xyz', k=4, the CX target) from its
     recorded start through the sweep kernel (minimize_fused, B=1, r=0, lr
     0.1): best loss within 5e-4 of the record's minimum, and its angles
     within 5e-3 of the record's last where that minimum is the last step;
     (c) the reference README's CCZ example written with ``from
     cpflow_torch import ...`` (StaticOptions(num_cp_gates=12,
     num_samples=10, accepted_num_cz_gates=8), everything else default),
     which must verify a decomposition with at most 8 CZ at float64 host
     loss <= 1e-6 through the kernel;
 18. double precision: the double builds of both sources (csrc/ compiled
     with -DCPFLOW_DOUBLE, phase 2 builds them beside the float ones):
     (a) their ptxas report (no spills), registers and local bytes at run
     time; (b) the sweep kernel against its plain float64 version, 60 steps,
     at six shapes (the static CCZ's sampling shape, 5q k=20, a 10q state,
     4q modulo-diagonal, fixed 'cz' with 'xz', 7q on 4 blocks), each plan
     held against the library's, within F64_LOSS0_TOL and F64_BEST_TOL (8
     qubits: phase 19); (c) ansatz_forward and ansatz_vjp against the plain
     float64 builder under autograd in both designs at 3q, 5q and 7q (rows
     only), within F64_UNITARY_TOL and F64_GRAD_TOL; then after
     config.set_precision(True): (d) the static CCZ (3q chain, k=12, 1024
     samples), which must verify at most 8 CZ at host loss <= 1e-6 with
     every sweep launch in float64, and phase 6's adaptive square Toffoli-4
     (8 evals), which must verify at host loss <= 1e-6; (e) phase 8's
     relative-phase Toffoli-4, 16 evals, its best CZ count and float64 host
     loss printed beside float32 verification's 2.169e-6 (informational);
     (f) phase 13's GHZ-4 custom loss (8 evals), 3 CZ at host loss <= 1e-6,
     and the static CCZ with cp_penalty_L1 (sampling through the unitary
     kernels), every unitary launch in float64; (g) each float64 kernel
     timed beside its float32 build in turns (CUDA events) at phase 5's 3q
     and 5q sweep shapes and at 3q k=12 B=1024 and 5q k=20 B=2048 for the
     unitary kernels, with the float64 bound (utils/profiling.py, PEAK_F64).
     float32 is restored in `finally`;
 19. what clusters of 16 blocks (non-portable on Hopper) and a 13-qubit
     state open: (a) the sweep kernel against its plain version at (G) 8q
     chain Toffoli-8 'xz' k=16 B=32 in float64 (phase 15's (w)), (H) 7q
     k=200 B=8 T=10 in float64 and (I) 8q k=240 B=8 T=10 in float32, each
     on 16 blocks, (J) the 13q GHZ state k=48 B=64 on one block and (K) 8q
     modulo_diagonal 'xz' k=16 B=32 in float64 on 16 blocks (a float64
     restart past 1e-9 held to 4 times the distance of the plain route on
     the host from the card's); the unitary kernels at 8q k=16 B=16 in
     float64 and 8q k=270 B=4 in float32, the vjp on a cluster of 16 blocks
     and the forward pass on the column tiles, and at a 13q column k=48 B=8
     in float32 on one block, against the plain builder under autograd;
     each with its plan, the clusters or blocks the card holds, its time and
     its share of the bound, and two launches of each pass at 8 qubits on
     the same inputs giving the same bits; (b) Synthesize.static
     on the 8q chain for the CX ladder in float64 (k=9, 7 CZ at host loss
     <= 1e-6), every sweep launch the double build on 16 blocks; (c) a
     custom loss at 8q in float64 (the ladder's HS test as a torch
     callable) through the unitary kernels, the forward pass on the column
     tiles and the vjp on a cluster of 16 blocks, against the plain float64
     route; (d) GHZ-13 in float32 with the state loss
     through Synthesize.static: from 1024 random restarts at k=14 (what it
     finds printed), and at k=12 from the noisy rows of 15 (b)'s warm batch
     around the exact 12-CZ embedding that start above the entry loss,
     which must give a 12-CZ decomposition at float64 host state loss <=
     1e-6;
 20. states past one block, a state's one column split by rows over a
     cluster of 2 to 16 blocks (the row tiles' builds of both sources, in
     float and in double): (a) the sweep kernel against its plain version
     at GHZ states on the chain at k = 2n, (L) 14q B=64 on 2 blocks, (M)
     15q B=32 on 4, (N) 16q B=16 on 8, (O) 17q B=16 on 16 in float32 (as
     phase 3 holds its shapes), (P) 13q B=32 on 2 and (Q) 16q B=8 on 16 in
     float64 (as phase 19 (a) holds its float64 rows), and the unitary
     kernels (one column) at 14-17q in float32 and 13q and 16q in float64
     against the plain builder under autograd, each with its plan, the
     clusters the card holds, its time and its share of the bound; then
     the row tiles' edges (split_edge_shapes, SPLIT_EDGE_UNITARY: the
     shortest segments, a ring of one gate, lanes past a gate's groups,
     the split qubits back to back, 'xz', 'cz' and 'cx'), each held to its
     plan's warps, segment and ring, and two launches of the sweep, of
     the unitary kernels' forward pass and of their vjp on the same inputs
     giving the same bits; (b)
     GHZ-14 and GHZ-17 in float32 and GHZ-16 in float64 through
     Synthesize.static from the noisy rows of a warm batch around the
     exact (n - 1)-CZ embedding, each to n - 1 CZ at float64 host state
     loss <= 1e-6; (c) GHZ-15 in float32 and GHZ-14 in float64 the same way
     with cp_penalty_L1, whose sampling runs through the unitary kernels'
     row tiles (verification through the sweep's); (d) a random-restart
     GHZ-14 search (k=15, 256 samples, 1000 steps), printed; then a state
     one qubit past the unitary kernels' cap (25 qubits, 24 in float64)
     refused by the sweep and by the unitary kernels, a column whose U
     exceeds the card's free memory (24 qubits, 1024 restarts) refused
     before it is allocated, each with its reason, and the whole unitary's
     refusals of phase 15;
 21. the whole unitary past what a cluster of 16 blocks holds, on the
     column tiles (a restart's columns split into tiles on independent
     blocks, two kernels a step that meet through global memory; the
     unitary kernels' forward pass and vjp the same way): (a) the sweep
     kernel against its plain version at (R) 9q chain Toffoli-9 k=10 B=8
     T=60 in float32 and (S) in float64, (T) the disc loss at 10q k=12 B=4
     T=30, (U) 11q k=12 B=2 T=10, and at the limits (V) 12q in float64 and
     (W) 13q in float32 (k=2 B=1 T=4), then on the tiles what the other
     routes take at 9 qubits: (X) a bucketed sweep with r and a template
     mask per trial, (Y) fixed 'cz' blocks with 'xz', (Z) fixed 'cx' blocks
     with 'y', each with its tiles, columns a tile, threads,
     blocks resident, registers and local bytes, time (the fastest of three
     calls after a warm-up), bound and share, and
     two launches on the same inputs giving the same bits; (b) the unitary
     kernels at 9, 10 and 11 qubits in both precisions, 12 in float64 and
     13 in float32, against the plain builder under autograd (a float32
     gradient past 1e-4 held to the plain float64 one), the vjp's three
     kernels (its prologue, the tiles' walk, the sum) each timed, and two
     launches of each pass on the same inputs giving the same bits; (c)
     Synthesize.static for the 9q CX ladder (8 CZ) in float32 from 32
     random restarts of 2000 steps at k=10, every sweep launch of both
     stages on the column tiles, and in float64 from warm rows around its
     exact embedding at k=8, each to a verified 8-CZ decomposition at
     float64 host loss <= 1e-6; (d) a custom loss, the ladder's HS test as
     a torch callable, at 9 qubits in float64 and at 10 in float32 through
     the unitary kernels' column tiles, against the plain route; (e) the
     whole unitary one qubit past its limit (14 qubits in float32, 13 in
     float64) and a modulo loss at 14 qubits refused, no kernel launched;
     (f) a 9-qubit modulo_diagonal sweep in float32 and in float64, which
     sweep() routes to the unitary kernels (ROADMAP A.16b), against the
     plain float64 route;
 22. the pair on one block (forward_block_kernel, vjp_block_kernel, kernel
     lines ansatz_forward and ansatz_vjp: the row-split design's plan with
     no cluster, on rows.cuh's warps): (a) the unitary kernels at
     BLOCK_UNITARY's rows (one column at 13q k=48 B=8 and 14q k=28 in
     float32, 12q k=24 and 13q k=26 in float64, 4q k=6 B=100, 9q k=16
     B=32; the whole unitary past the column design's depths, the vjp at
     6q k=400 in float32 and k=130 in float64 and 3q k=750, the forward
     pass at 6q k=1190, one rotation letter) against the plain builder
     under autograd (phase_sixteen_unitary: plans, phase 12's and phase
     19's tolerances, times, bounds, 0 local bytes) and two launches of
     each pass on the same inputs giving the same bits; (b) GHZ-13 in
     float32 and GHZ-12 in float64 through Synthesize.static from a warm
     start with cp_penalty_L1, both passes on one block; (c) GHZ-4 from
     phase 7's 100 random restarts with cp_penalty_L1, 3 CZ at host loss
     <= 1e-6, sampling through the pair and never the plain builder;
 23. one column past a cluster, on the global row tiles
     (global_gates_kernel, the prologue of every call, forward_global_kernel,
     vjp_global_kernel and the vjp's sum, vjp_global_sum_kernel; kernel
     lines ansatz_global_gates, ansatz_forward_global_rows and
     ansatz_vjp_global_rows): (a) the unitary kernels at GLOBAL_UNITARY's
     rows (the GHZ ladder's template at 18 and 20 qubits in float32, 17
     and 19 in float64, a random template at 20 and 19, and the cap's
     width, 24 and 23, shallow) against the plain builder under autograd
     (the float64 arbiter where plain float32 drifts), each row's passes
     printed at one and two blocks an SM with the wrapper's choice, the
     prologue's gates against the plain builders of the gates, and two
     launches of each pass on the same inputs giving the same bits; (b) there, each kernel alone on the card beside its bound,
     with registers and local bytes; (c) GHZ-20 in float32 and GHZ-18 in
     float64 through Synthesize.static from a warm start, sampling and
     verification through the global row tiles, never the plain builder,
     each to n - 1 CZ at float64 host state loss <= 1e-6.

Each main path (4, 6-11, 13, 14, 15 (b) and (c), 16 (a)-(e), 17 (c), 18
(d)-(f), 19 (b)-(d), 20 (b)-(d), 21 (c), (d) and (f), 22 (b) and (c), 23
(c)) runs
with the kernels' launch counts set to 0 just before it and read just
after (16 (a) and (d) in their own processes). Every shape's plan (blocks
a restart, shared bytes per block) is held against the kernels' own. The script prints the card, a JSON line of kernel results
(the sweep's builds sweep_block, sweep_cluster, sweep_columns,
ansatz_forward, ansatz_vjp, and their float64 builds sweep_block_f64,
sweep_cluster_f64, sweep_columns_f64, ansatz_forward_f64,
ansatz_vjp_f64; the row tiles' builds
sweep_row_tiles, ansatz_forward_row_tiles, ansatz_vjp_row_tiles and
their float64 builds, each name with _f64; the column tiles' builds
sweep_column_tiles, ansatz_forward_column_tiles, ansatz_vjp_column_tiles
and their float64 builds; the pair on one block, ansatz_forward_one_block
and ansatz_vjp_one_block, and their float64 builds; the global row
tiles, ansatz_forward_global_rows and ansatz_vjp_global_rows, and their
prologue ansatz_global_gates, each with its float64 build) and, last, the
JSON
device line; it exits non-zero if any phase fails or there is no card. A phase after the
build and the comparison (phases 2-3) that fails is reported and the
next one runs; the script then fails at the end, with no result lines.
The kernels' work and bounds come from cpflow_tpu_torch/utils/profiling.py.
``python3 chip_smoke.py --dist-worker <port> <rank> <file>`` is phase 16
(d)'s worker.
"""

from __future__ import annotations

from collections import Counter
import ctypes
import functools
import json
import math
from pathlib import Path
import os
import subprocess
import sys
import tempfile
import time


try:  # the kernels' work and bounds; main() says so if the port is missing
    from cpflow_tpu_torch.utils.profiling import (bound_ms, sweep_work,
                                                  unitary_bound_ms,
                                                  unitary_work)
except ImportError:
    pass


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
    obj, P = shape_objective(s, s.get('dtype'))
    init = uniform_inits(P, s['B'], seed, 'cuda').to(obj.dtype)
    if 'ks' not in s:
        return obj, init, None
    nba = num_block_angles(s.get('ent', 'cp'), s.get('rot', 'xyz'))
    active = torch.zeros((P, len(s['ks'])), device='cuda')
    for j, k in enumerate(s['ks']):
        active[:3 * s['n'] + nba * k, j] = 1.0
    mask = active.repeat_interleave(s['S'], dim=1).contiguous()
    return obj, init * mask, mask


def shape_work(s):
    """sweep_work of a shape dict (in its dtype, float32 by default)."""
    wires = s.get('wires')
    return sweep_work(s['n'], max(s['ks']) if 'ks' in s else s['k'],
                      s.get('rot', 'xyz'), s.get('ent', 'cp'),
                      s.get('kind', 'hst'), len(wires) if wires else None,
                      dtype=s.get('dtype', 'float32'))


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


def best_of(fn, calls=1):
    """(output, ms) of fn timed as `timed` does; with calls > 1 after one
    untimed warm-up call, the fastest of `calls` timed calls (their outputs
    are the same: every call starts from the same inputs). One timed call
    alone may hold a kernel's first launch in the process."""
    if calls == 1:
        return timed(fn)
    fn()
    runs = [timed(fn) for _ in range(calls)]
    return min(runs, key=lambda run: run[1])


def device_kernels(fn, repeats=20):
    """{event name: (launches, ms on the card in all)} over `repeats` calls
    of fn after an untimed one, from torch.profiler's trace of the card
    (host-side events have 0 ms). Unlike `timed`, which brackets the call
    on the stream and so includes whatever the host needs to launch it,
    these are the kernels alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    events = {}
    for event in prof.key_averages():
        spent = getattr(event, 'self_device_time_total', None)
        if spent is None:
            spent = event.self_cuda_time_total
        count, ms = events.get(event.key, (0, 0.0))
        events[event.key] = (count + event.count, ms + spent / 1e3)
    return events


def device_ms(fn, kernel_name, repeats=20):
    """Mean time in ms that the kernels whose name contains `kernel_name`
    take on the card over `repeats` calls of fn (device_kernels), traced
    again, three times at most, where the profiler leaves the kernel out
    of a trace; None if no trace holds it."""
    for _ in range(3):
        found = [v for k, v in device_kernels(fn, repeats).items()
                 if kernel_name in k]
        count, total = sum(c for c, _ in found), sum(ms for _, ms in found)
        if count and total > 0:
            return total / count
    return None


def traced_calls(fn, launches, repeats=20):
    """({trace name: ms on the card a call of fn}, {trace name: launches
    kept}, whether the trace kept them all) for kernels that one call
    launches a known number of times (`launches`: {trace name: launches a
    call}). The profiler loses launches now and then (in some states of a
    process one launch of every trace), and a sum over the launches
    kept, divided by the calls, would read fast. So: from a trace of
    `repeats` calls (device_kernels) that kept all repeats x launches of
    each, traced again, three times at most, where one lacks any; where
    none kept them all, from the trace that kept the most, each kernel's
    mean over the launches kept times its launches a call. A kernel the
    trace never shows has None."""
    best = None
    for _ in range(3):
        events = device_kernels(fn, repeats)
        got = {}
        for name in launches:
            found = [v for k, v in events.items() if name in k]
            got[name] = (sum(c for c, _ in found), sum(ms for _, ms in found))
        kept = {name: count for name, (count, _) in got.items()}
        if all(count == repeats * launches[name] and ms > 0
               for name, (count, ms) in got.items()):
            return ({name: ms / repeats for name, (_, ms) in got.items()},
                    kept, True)
        if best is None or sum(kept.values()) > \
                sum(c for c, _ in best.values()):
            best = got
    return ({name: ms / count * launches[name] if count and ms > 0 else None
             for name, (count, ms) in best.items()},
            {name: count for name, (count, _) in best.items()}, False)


def global_launches(fn):
    """{uk.KERNELS name ('_f64' added for the double build): kernel launches
    of one call of fn} by uk.GLOBAL_PASSES: a pass each of the global row
    tiles' passes, one sum a vjp call."""
    import torch
    from cpflow_tpu_torch.kernels import unitary as uk
    before = dict(uk.GLOBAL_PASSES)
    fn()
    torch.cuda.synchronize()
    return {k: v - before.get(k, 0) for k, v in uk.GLOBAL_PASSES.items()
            if v != before.get(k, 0)}


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
    """Phase 3's shapes, (a)-(p), (q6), (r64) and (s)-(u), as dicts: a
    bucketed one has ks, rs and S (B = S len(ks)); (q6) is the HS test at 6
    qubits, (r64) the static CCZ's sampling shape in float64 (`dtype`);
    (s)-(t64) are templates one block deeper than the column build holds
    (kernels/sweep.py:column_plan), which take the one-block build, and (u)
    a 10q state on a batch of 700 restarts, one block a restart (`build`:
    what the occupancy must report). A float64 row's
    initial losses are held to phase 18's bound besides, and its best
    losses too where it is one of phase 18's shapes (`f64_best`: (r64));
    deeper templates drift further in 60 steps between any two float64
    orders of summation (at (t64) the plain version on the card and on the
    CPU differ by 1.6e-9, drift_probe.py, PERF.md). arbiter=True names the
    shapes on which the float64 plain version may arbitrate
    (as_close_as_plain): those where plain float32 itself misses drift_ok
    against float64 at T = 60, the deep templates (g), (l), (o), (s) and
    (t) with their many flat directions, and (n), where one restart of
    plain float32 drifts by 1.1e-2 (PERF.md, Findings). Every other shape
    is held to drift_ok, against plain float32 or, where plain float32
    itself misses it, against float64 (plain_drifted)."""
    import torch
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
        dict(name='(q6) HS test 6q chain Toffoli-6 k=20 B=256', n=6, k=20,
             target=multi_controlled_x(6), B=256, r=0.00055, lr=0.1),
        dict(name='(r64) float64 3q CCZ k=12 B=1024 (static sampling)', n=3,
             k=12, target=u_ccz3, B=1024, r=0.00055, lr=0.1,
             dtype=torch.float64, f64_best=True),
        dict(name='(s) HS test 6q chain Toffoli-6 k=118 B=64 (one block too '
             'deep for the column build)', n=6, k=118,
             target=multi_controlled_x(6), B=64, r=0.00055, lr=0.1,
             arbiter=True, build='sweep_block'),
        dict(name='(t) modulo_identity 6q chain Toffoli-6 wires [5, 1] k=118 '
             'B=64 (one block too deep for the column build)', n=6, k=118,
             target=multi_controlled_x(6), kind='modulo_identity',
             wires=[5, 1], B=64, r=0.00055, lr=0.1, arbiter=True,
             build='sweep_block'),
        dict(name='(s64) float64 HS test 6q chain Toffoli-6 k=56 B=64 (one '
             'block too deep for the column build)', n=6, k=56,
             target=multi_controlled_x(6), B=64, r=0.00055, lr=0.1,
             dtype=torch.float64, build='sweep_block_f64'),
        dict(name='(t64) float64 modulo_diagonal 6q chain Toffoli-6 all '
             'wires k=55 B=64 (one block too deep for the column build)',
             n=6, k=55, target=multi_controlled_x(6), kind='modulo_diagonal',
             wires=list(range(6)), B=64, r=0.00055, lr=0.1,
             dtype=torch.float64, build='sweep_block_f64'),
        dict(name='(u) state 10q GHZ k=4 B=700 (one block a restart)', n=10,
             k=4, target=ghz(10), kind='state', B=700, r=0.002, lr=0.1,
             build='sweep_block'),
    ]


def check_plan(obj, B, name):
    """The blocks a restart of `obj` runs on: kernels/sweep.py's plan
    (cluster_plan, smem_bytes) must agree with the kernel's
    (cpflow_sweep_cluster, cpflow_sweep_smem_bytes, and the cluster of the
    build it launches), in the build of the objective's dtype; on the
    column tiles (tile_plan) the tiles a restart, the tile kernel's shared
    bytes (tile_smem_bytes) and threads (tile_threads), against
    cpflow_sweep_tiles, cpflow_sweep_tile_smem_bytes and the occupancy's;
    on the row tiles (a state on more than one block) the launch's threads,
    shared bytes, warps, segment, ring and rows a block (row_plan) against
    cpflow_sweep_row_plan and the occupancy's; on the one-block build the
    same (block_plan) against cpflow_sweep_block_plan; on the cluster build
    its threads, shared bytes, ring and columns a block (cluster_layout)
    against cpflow_sweep_cluster_layout and the occupancy's, and the build
    the occupancy names must be the one the plans give (build_of); on the
    column build (the
    whole unitary at 2 to 6 qubits, column_plan) its restarts, threads and
    shared bytes a block against cpflow_sweep_column_plan and the
    occupancy's, whose build must be the column build (and no other build
    where column_plan does not hold the shape). Returns (blocks a restart,
    shared bytes per block of the plan, the occupancy)."""
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    kind = obj.unitary_loss_func.kind
    n, nb = obj.num_qubits, len(all_placements(obj.placements))
    nba = num_block_angles(obj.entangling_gate_name, obj.rotation_gates)
    columns = sk.column_plan(n, nb, nba, kind, dtype=obj.dtype)
    suffix = '_f64' if obj.dtype == torch.float64 else ''
    if columns is not None:
        lib = sk.load_library(obj.dtype)
        got = (ctypes.c_int * 3)()
        lib.cpflow_sweep_column_plan(n, nb, nba, sk.LOSS_CODES[kind], got)
        occ = sk.occupancy(obj, B)
        want = [columns[key] for key in ('restarts', 'threads', 'smem_bytes')]
        check(list(got) == want and occ['build'] == 'sweep_columns' + suffix
              and [occ['restarts_per_block'], occ['threads'],
                   occ['smem_bytes']] == want and occ['cluster'] == 1,
              f'{name}: the plan says the column build with (restarts, '
              f'threads, bytes) {want} a block, the kernel {list(got)} and '
              f'{occ["build"]} with {occ["restarts_per_block"]}, '
              f'{occ["threads"]}, {occ["smem_bytes"]}')
        return 1, columns['smem_bytes'], occ
    tiles = sk.tile_plan(n, nb, nba, kind, dtype=obj.dtype)
    if tiles is not None:
        w, t = tiles
        mine = sk.tile_smem_bytes(n, nb, w, obj.dtype)
        lib = sk.load_library(obj.dtype)
        code = sk.LOSS_CODES[kind]
        occ = sk.occupancy(obj, B)
        check(mine == lib.cpflow_sweep_tile_smem_bytes(n, nb, nba, code) ==
              occ['smem_bytes'] and t == lib.cpflow_sweep_tiles(
                  n, nb, nba, code) == occ['tiles'] and
              occ['threads'] == sk.tile_threads(n, w, obj.dtype) and
              not lib.cpflow_sweep_cluster(n, nb, nba, code),
              f'{name}: the plan says {t} column tiles of {mine} bytes and '
              f'{sk.tile_threads(n, w, obj.dtype)} threads, the kernel '
              f'{occ.get("tiles")} of {occ["smem_bytes"]} bytes and '
              f'{occ["threads"]} threads')
        return t, mine, occ
    c = sk.cluster_plan(n, nb, nba, kind, dtype=obj.dtype)
    mine = sk.smem_bytes(n, nb, nba, kind, c, obj.dtype)
    lib = sk.load_library(obj.dtype)
    theirs = lib.cpflow_sweep_cluster(n, nb, nba, sk.LOSS_CODES[kind])
    card = lib.cpflow_sweep_smem_bytes(n, nb, nba, sk.LOSS_CODES[kind], c)
    occ = sk.occupancy(obj, B)
    code = sk.LOSS_CODES[kind]
    if c == 1 or kind == 'state':  # rows.cuh's warps
        got = (ctypes.c_int * 6)()
        check((lib.cpflow_sweep_block_plan(n, nb, nba, code, B, got) if c == 1
               else lib.cpflow_sweep_row_plan(n, nb, nba, got)) == 0,
              f'{name}: no row plan')
        # one block: the warps the library picked for the batch
        rows = sk.block_plan(n, nb, nba, kind, obj.dtype, got[2]) if c == 1 \
            else sk.row_plan(n, nb, nba, obj.dtype)
        want = [rows[key] for key in ('threads', 'smem_bytes', 'warps',
                                      'segment', 'ring', 'log_rows')]
        check(list(got) == want and occ['threads'] == rows['threads'],
              f'{name}: the row plan says (threads, bytes, warps, segment, '
              f'ring, log2 rows) {want}, the kernel {list(got)}, '
              f'{occ["threads"]} threads')
    else:  # tiles.cuh's warps
        rows = sk.cluster_layout(n, nb, nba, kind, obj.dtype)
        got = (ctypes.c_int * 4)()
        check(lib.cpflow_sweep_cluster_layout(n, nb, nba, code, got) == 0,
              f'{name}: no cluster layout')
        want = [rows[key] for key in ('threads', 'smem_bytes', 'ring',
                                      'columns')]
        check(list(got) == want and occ['threads'] == rows['threads'],
              f'{name}: the cluster layout says (threads, bytes, ring, '
              f'columns) {want}, the kernel {list(got)}, {occ["threads"]} '
              f'threads')
    launched = rows['smem_bytes']  # the bytes a block launches with
    check(mine == card and launched == occ['smem_bytes'] and
          c == theirs == occ['cluster'] and
          occ['build'] == sk.build_of(n, nb, nba, kind, obj.dtype),
          f'{name}: the plan says {c} blocks of {mine} bytes ({launched} '
          f'launched), the kernel {theirs} ({occ["cluster"]}) blocks of '
          f'{card} ({occ["smem_bytes"]}) bytes')
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
    Returns (largest absolute error, the templates driven: for each build
    that ran, a dict of the losses, entanglers and rotation strings, and
    the rows: name, build, its largest error, cluster, bytes, registers,
    local bytes, ms, plain_ms, bound_ms, bound_by)."""
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    dev = 'cuda'
    worst = 0.0
    driven = {}  # by build
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
        check(occ['build'] == s.get('build', occ['build']),
              f'{s["name"]}: the occupancy reports the build {occ["build"]}'
              f', not {s.get("build")}')
        before, built = sk.LAUNCHES, dict(sk.LAUNCHES_BY_BUILD)
        out, ms = best_of(lambda: sk.sweep(obj, init, s['lr'], T, mask, tl),
                          s.get('calls', 1))
        ran = {k for k, v in sk.LAUNCHES_BY_BUILD.items()
               if v > built.get(k, 0)}
        check(sk.LAUNCHES > before and ran == {occ['build']},
              f'{s["name"]}: builds launched {sorted(ran)}, the plan\'s '
              f'{occ["build"]}')
        ref, plain_ms = timed(lambda: sk.sweep_reference(
            obj, init, s['lr'], T, mask, tl))
        for t in out:
            check(t.shape[-1] == s['B'] and bool(torch.isfinite(t).all()),
                  f'{s["name"]}: bad output')
        err0 = scaled_err(out.regloss0, ref.regloss0).max().item()
        abs0 = (out.regloss0 - ref.regloss0).abs().max().item()
        check(err0 <= 1e-5, f'{s["name"]}: initial loss differs by {err0}')
        keep = torch.ones(s['B'], dtype=torch.bool, device=dev)
        line = (f'{label}: {s["name"]}: build {occ["build"]}, {c} block(s) '
                f'a restart, {occ["restarts_per_block"]} restart(s) a block, '
                f'{nbytes} shared bytes and {occ["registers"]} registers a '
                f'thread each, {occ["local_bytes"]} local bytes, '
                f'{occ["active_clusters"] * occ["restarts_per_block"]} '
                f'restarts resident; T={T}: kernel '
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
        row_err = abs0
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
            row_err = max(row_err, (a - b).abs()[keep].max().item())
            worst = max(worst, row_err)
        if obj.dtype == torch.float64:  # phase 18's bounds, stated there
            e = scaled_err(out.best_loss, ref.best_loss)[keep].max().item()
            line += f'; float64: initial {err0:.2e}, best loss {e:.2e}'
            check(err0 <= F64_LOSS0_TOL and
                  (e <= F64_BEST_TOL or not s.get('f64_best')),
                  f'{s["name"]}: float64 kernel against plain float64: '
                  f'initial {err0:.3e}, best {e:.3e}')
        print(line, flush=True)
        by = driven.setdefault(occ['build'], {
            'modes': set(), 'entanglers': set(), 'rotation_strings': set()})
        by['modes'].add(s.get('kind', 'hst'))
        by['entanglers'].add(s.get('ent', 'cp'))
        by['rotation_strings'].add(s.get('rot', 'xyz'))
        b_ms, b_by = bound_ms(shape_work(s), s['B'], T)
        rows.append(dict(shape=s['name'], T=T, cluster=c, smem_bytes=nbytes,
                         build=occ['build'], max_abs_err=row_err,
                         registers=occ['registers'],
                         local_bytes=occ['local_bytes'], ms=ms,
                         plain_ms=plain_ms, plain_T=T, bound_ms=b_ms,
                         bound_by=b_by))
    return worst, {b: {k: sorted(v) for k, v in by.items()}
                   for b, by in driven.items()}, rows


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
    sk.LAUNCHES_BY_BUILD.clear()
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


def timing_shapes():
    """Phase 5's rows: [(shape dict, T, T_plain)]."""
    from cpflow_tpu_torch.ops.gates import multi_controlled_x, u_ccz3
    shapes = {s['name'][:3]: s for s in compare_shapes()}
    return [(dict(name='3q CCZ k=12 B=1024 (static sampling)', n=3, k=12,
                  target=u_ccz3, r=0.00055, B=1024), 2000, 2000),
            (dict(name='5q Toffoli k=20 B=2048', n=5, k=20,
                  target=multi_controlled_x(5), r=0.00055, B=2048), 500, 500),
            (shapes['(d)'], 2000, 100), (shapes['(f)'], 500, 100),
            (shapes['(g)'], 500, 100), (shapes['(h)'], 2000, 100)]


def phase_timing(card):
    """Kernel and plain times, and the kernel's share of its bound
    (bound_ms). The plain version of the later rows is timed over
    T_plain = 100 steps, not T: their T steps would take minutes of the
    script's budget. Each row reports the plain time it measured with its
    step count (plain_T), never a time scaled to T, and the build it
    launched. Rates are restart-iter/s. Returns one dict per row."""
    from cpflow_tpu_torch.kernels import sweep as sk
    rows = []
    for s, T, T_plain in timing_shapes():
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
        print(f'phase 5: {s["name"]} T={T} on {card}: build {occ["build"]}: '
              f'kernel {ms1:.2f} / '
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
                         bound_by=b_by, registers=occ['registers'],
                         local_bytes=occ['local_bytes'],
                         blocks_per_sm=occ['blocks_per_sm'],
                         build=occ['build']))
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
        sk.LAUNCHES_BY_BUILD.clear()
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


def phase_state(label='phase 7'):
    """The state main path: GHZ-4 on the 4q chain (the JAX package's
    ghz_state benchmark config; GHZ_n needs n - 1 CZ on a chain), in the
    precision config sets."""
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
    sk.LAUNCHES_BY_BUILD.clear()
    start = time.perf_counter()
    results = synth.static(options, save_results=False, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, builds = sk.LAUNCHES, dict(sk.LAUNCHES_BY_BUILD)
    check(launches >= 2, f'state path launched the kernel {launches} times: '
          f'not in both the sampling and the verification stage')
    check(len(builds) == 1 and next(iter(builds)).startswith('sweep_block')
          and sum(builds.values()) == launches,
          f'{label}: launches by build {builds}, not all {launches} on the '
          f'one-block build')
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
    print(f'{label}: static GHZ-4 chain k=6 100 samples: {len(hosts)} '
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
    sk.LAUNCHES_BY_BUILD.clear()
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


REFINE_RATE = 12  # decompositions refined for each exact one


def phase_refine(name, layer, options, want_cz, want_t, published):
    """Phase 11: Synthesize(layer, u_toff3).static(options) on the card,
    then Decomposition.refine, on the host in float64, on every
    decomposition. Needs the kernel in both stages, a want_cz decomposition
    at host loss <= 1e-6, and one refinement to 'Clifford+T' at host loss
    <= 1e-9 that keeps the want_cz CZ count in every REFINE_RATE
    decompositions found (the paper refined 12 of each topology; the rate,
    not the first 12 in restart order, so that one more decomposition
    found cannot push the exact ones out of the sample), the least T count
    of those want_t. A refined circuit whose angles are all pi p / 2^k
    (k <= 5) goes through exact_unitary: at host loss <= 1e-9 it must be
    proved equal to the Toffoli over the cyclotomic integers."""
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
    sk.LAUNCHES_BY_BUILD.clear()
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
    for d in decs:
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
    at_want = [r for r in refined if r[2] == want_cz]
    need = -(-len(decs) // REFINE_RATE)
    check(len(at_want) >= need,
          f'{name}: {len(at_want)} {want_cz}-CZ decompositions refined to '
          f'Clifford+T at host loss <= 1e-9, fewer than one in every '
          f'{REFINE_RATE} of the {len(decs)} found ({need}): {refined}')
    least_t = min(r[1] for r in at_want)
    check(least_t == want_t, f'{name}: least T count {least_t} of the '
          f'{want_cz}-CZ Clifford+T refinements, not {want_t}')
    t_depth, t_count, _, loss = min(refined)
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    print(f'phase 11: {name}, k={options.num_cp_gates} r={options.r} '
          f'{options.num_samples} samples: {len(decs)} verified, CZ count: '
          f'number {cz_counts}, {len(good)} at {want_cz} CZ with host loss <= '
          f'1e-6; kernel launches {launches}; synthesis wall {wall:.3f} s '
          f'({stages}); refine of {len(decs)} on the host {refine_s:.3f} s '
          f'({refine_s / len(decs):.3f} s each, {evals[1]:.3f} s of it in '
          f'{evals[0]} evaluations of Circuit.unitary): types {dict(types)}, '
          f'{len(refined)} Clifford+T at host loss <= 1e-9 ({len(at_want)} '
          f'at {want_cz} CZ, at least {need} needed), {proved} proved '
          f'exact; best T depth {t_depth} with T count {t_count} at host loss '
          f'{loss:.3e}, least T count {min(r[1] for r in refined)} '
          f'({published})', flush=True)
    return launches


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


def unitary_plan(n, nb, nba, log_c, name, dtype=None, passes=(False, True),
                 placements=None):
    """(forward, vjp) plans of the unitary kernels (kernels/unitary.py:plan:
    design, threads a restart, restarts a block, shared bytes a block, blocks
    a restart), each held against the library's own (cpflow_unitary_design,
    and cpflow_unitary_column_restarts and _column_smem_bytes for the column
    design, cpflow_unitary_cluster and _smem_bytes for the row-split one,
    cpflow_unitary_warp_layout for the kernels on tiles.cuh's warps,
    cpflow_unitary_global_plan and _global_work at the plan's blocks an SM
    for the global row tiles), in the build of `dtype` (default float32);
    passes: the vjp flags of the plans to give, both by default;
    placements: the template's pairs, which decide the global row tiles'
    blocks an SM (kernels/unitary.py:global_per_sm; without them, two
    where a tile fits so)."""
    import torch
    from cpflow_tpu_torch.kernels import unitary as uk
    dtype = dtype or torch.float32
    lib = uk.load_library(dtype)
    out = []
    for vjp in passes:
        mine = uk.plan(n, nb, nba, log_c, vjp, dtype, placements)
        what = 'vjp' if vjp else 'forward pass'
        design = lib.cpflow_unitary_design(n, nb, nba, log_c, int(vjp))
        check(mine is not None and uk.DESIGNS[mine['design']] == design,
              f'{name}: the plan says {mine} for the {what}, the kernels '
              f'design {design}')
        if mine['design'] == 'global_rows':
            got = (ctypes.c_int * 9)()
            per_sm = mine['per_sm']
            check(lib.cpflow_unitary_global_plan(n, nb, nba, int(vjp),
                                                 per_sm, got) == 0,
                  f'{name}: no global row plan for the {what}')
            want = [mine[key] for key in (
                'threads', 'smem_bytes', 'warps', 'segment', 'ring',
                'log_rows', 'blocks_per_restart', 'sum_smem_bytes',
                'gates_smem_bytes')]
            work = uk.global_work(n, nb, nba, vjp, dtype, per_sm)
            card_work = lib.cpflow_unitary_global_work(n, nb, nba, int(vjp),
                                                       per_sm)
            check(list(got) == want and card_work == work and
                  lib.cpflow_unitary_cluster(n, nb, nba, log_c,
                                             int(vjp)) == 0,
                  f'{name}: the plan says (threads, bytes, warps, segment, '
                  f'ring, log2 rows, tiles, sum bytes, prologue bytes) '
                  f'{want} and {work} reals of workspace a restart for the '
                  f'{what} at {per_sm} blocks an SM, the kernels '
                  f'{list(got)} and {card_work}')
        elif mine['design'] == 'columns':
            r = lib.cpflow_unitary_column_restarts(n, nb, nba, log_c,
                                                   int(vjp))
            card = lib.cpflow_unitary_column_smem_bytes(n, nb, nba, int(vjp),
                                                        r)
            check(r == mine['restarts_per_block'] and
                  card == mine['smem_bytes'],
                  f'{name}: the plan says {mine} for the {what}, the kernels '
                  f'{r} restarts a block in {card} bytes')
        else:
            c = mine['blocks_per_restart']
            card = lib.cpflow_unitary_smem_bytes(n, nb, nba, log_c, int(vjp),
                                                 c)
            theirs = lib.cpflow_unitary_cluster(n, nb, nba, log_c, int(vjp))
            if mine['design'] == 'tiles':  # no cluster holds it
                check(theirs == 0, f'{name}: the kernels put the {what} on '
                      f'a cluster of {theirs}, the plan on column tiles')
                theirs = lib.cpflow_unitary_tiles(n, nb, nba, log_c, int(vjp))
            rows = uk.rows_launch(n, nb, nba, log_c, vjp, dtype) \
                if mine['design'] == 'rows' else None
            if rows is not None:  # on rows.cuh's warps: the pass's launch's
                # plan (one block, the row tiles, the whole unitary's tiles)
                got = (ctypes.c_int * 6)()
                check(lib.cpflow_unitary_row_plan(n, nb, nba, log_c,
                                                  int(vjp), got) == 0,
                      f'{name}: no row plan for the {what}')
                want = [rows[key] for key in ('threads', 'smem_bytes',
                                              'warps', 'segment', 'ring',
                                              'log_rows')]
                check(list(got) == want and mine['threads'] == got[0] and
                      card == uk.smem_bytes(n, nb, nba, log_c, vjp, c,
                                            dtype),
                      f'{name}: the row plan says (threads, bytes, warps, '
                      f'segment, ring, log2 rows) {want} for the {what}, '
                      f'the kernels {list(got)}; the plan\'s layout {card} '
                      f'bytes')
                card = got[1]
            if vjp and mine['design'] == 'tiles':  # the vjp's tile kernel
                got = (ctypes.c_int * 4)()
                check(lib.cpflow_unitary_tile_layout(n, nb, nba, log_c,
                                                     got) == 0,
                      f'{name}: no tile layout for the vjp')
                w = (1 << n) // c
                want = [mine['threads'], mine['smem_bytes'], c,
                        uk.tk.sum_smem_bytes(n, nb, nba, dtype)]
                work = uk.tk.vjp_workspace(n, nb, nba, c, dtype)
                check(list(got) == want and card == uk.smem_bytes(
                          n, nb, nba, log_c, True, c, dtype) and
                      lib.cpflow_unitary_tile_partials(n, nb, nba,
                                                       log_c) == work and
                      mine['threads'] == uk.tk.tile_threads(n, w, dtype),
                      f'{name}: the tile plan says (threads, bytes, tiles, '
                      f'sum bytes) {want} and {work} reals of workspace a '
                      f'restart, the kernels {list(got)} and '
                      f'{lib.cpflow_unitary_tile_partials(n, nb, nba, log_c)}'
                      f'; the plan\'s layout {card} bytes')
                card = got[1]
            if 'ring' in mine:  # the kernels on tiles.cuh's warps
                got = (ctypes.c_int * 6)()
                check(lib.cpflow_unitary_warp_layout(n, nb, nba, log_c,
                                                     int(vjp), got) == 0,
                      f'{name}: no warp layout for the {what}')
                want = [mine['threads'], mine['smem_bytes'], c,
                        mine['columns_per_warp'], mine['warps_per_column'],
                        mine['ring']]
                check(list(got) == want,
                      f'{name}: the plan says (threads, bytes, blocks, '
                      f'columns a warp, warps a column, ring) {want} for the '
                      f'{what}, the kernels {list(got)}')
                card = got[1]
            check(c == theirs and card == mine['smem_bytes'],
                  f'{name}: the plan says {c} blocks of {mine["smem_bytes"]} '
                  f'bytes for the {what}, the kernels {theirs} blocks of '
                  f'{card} bytes')
        out.append(mine)
    return tuple(out)


def plan_text(p):
    """One plan of unitary_plan in words."""
    if p['design'] == 'columns':
        return (f'columns, {p["threads_per_restart"]} threads a restart, '
                f'{p["restarts_per_block"]} a block, {p["smem_bytes"]} bytes')
    if p['design'] == 'tiles':
        return (f'column tiles, {p["blocks_per_restart"]} blocks of '
                f'{p["threads"]} threads a restart, {p["smem_bytes"]} bytes '
                f'a block')
    if p['design'] == 'global_rows':
        return (f'global row tiles, {p["blocks_per_restart"]} tiles of '
                f'2^{p["log_rows"]} rows a restart, blocks of {p["threads"]} '
                f'threads (segments of 2^{p["segment"]} rows, a ring of '
                f'{p["ring"]}), {p["smem_bytes"]} bytes a block, '
                f'{p["per_sm"]} an SM')
    return (f'rows, {p["blocks_per_restart"]} block(s) of {p["threads"]} '
            f'threads a restart, {p["smem_bytes"]} bytes a block')


def column_ptxas():
    """{kernel entry: (stack bytes, spill store bytes, spill load bytes)} of
    the column kernels from ptxas's report of the unitary library's build
    (phase 2)."""
    import re
    from cpflow_tpu_torch.kernels import build
    out, entry = {}, None
    for line in build.INFO.get('unitary', {}).get('ptxas', '').splitlines():
        if 'Compiling entry' in line:
            m = re.search(r"column_(forward|vjp)ILi(\d)E", line)
            entry = f'{m.group(1)} {m.group(2)}q' if m else None
        elif entry and 'stack frame' in line:
            out[entry] = tuple(int(v) for v in re.findall(r'(\d+) bytes',
                                                          line)[:3])
    return out


def random_unitary(rng, d):
    """A complex d x d unitary from a numpy generator (QR of a Ginibre
    matrix)."""
    import numpy as np
    q, _ = np.linalg.qr(rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d)))
    return q


# Phase 12's timing shapes: name, qubits, blocks k, restarts B, rotations,
# layer. The bench's two shapes and one of each cluster size; then the
# three templates and batches that launch the kernels most on phases 13
# and 14.
UNITARY_TIMING = [
    ('3q chain k=12 B=1024', 3, 12, 1024, 'xyz', 'chain'),
    ('5q chain k=20 B=2048', 5, 20, 2048, 'xyz', 'chain'),
    ('7q chain k=24 B=64', 7, 24, 64, 'xyz', 'chain'),
    ('8q chain k=16 B=16', 8, 16, 16, 'xyz', 'chain'),
    ("3q chain k=8 'xz' B=200 (Ansatz.learn)", 3, 8, 200, 'xz', 'chain'),
    ('4q line k=10 B=100 (the GHZ-4 custom loss)', 4, 10, 100, 'xyz',
     'chain'),
    ('3q connected k=10 B=800 (the bucketed relative-phase Toffoli-3)', 3,
     10, 800, 'xyz', 'connected'),
]
# the kernels' names in the profiler's trace, by design (trace_key) and
# pass: 'rows' the row-split design's one block a restart (and the forward
# pass of the whole unitary on its plan's blocks), 'cluster' its vjp on a
# cluster, 'row_tiles' one column split by rows over a cluster
TRACE_NAMES = {('rows', False): 'forward_block_kernel',
               ('rows', True): 'vjp_block_kernel',
               ('cluster', True): 'vjp_kernel',
               ('columns', False): 'column_forward',
               ('columns', True): 'column_vjp',
               ('row_tiles', False): 'forward_rows_kernel',
               ('row_tiles', True): 'vjp_rows_kernel',
               ('tiles', False): 'forward_tiles_kernel',
               ('tiles', True): 'vjp_tiles_kernel',
               ('global_rows', False): 'forward_global_kernel',
               ('global_rows', True): 'vjp_global_kernel',
               ('global_gates', False): 'global_gates_kernel'}
# the kernels (KERNELS names) whose redesign left no local memory, in both
# builds: the row tiles' and the column tiles' vjp (with its prologue and
# sum), the row tiles' forward pass, the vjp on a cluster, the column
# tiles' forward pass, the pair on one block and the global row tiles' pair
# (with the vjp's sum)
NO_LOCAL = ('ansatz_forward_row_tiles', 'ansatz_vjp_row_tiles',
            'ansatz_vjp_column_tiles', 'ansatz_vjp_cluster',
            'ansatz_forward_column_tiles', 'ansatz_forward', 'ansatz_vjp',
            'ansatz_forward_global_rows', 'ansatz_vjp_global_rows')


def trace_key(design, vjp, blocks=1, column=False):
    """TRACE_NAMES' design key of a launch of `design` on `blocks` blocks a
    restart (column: one column, columns=[0])."""
    if design == 'rows' and blocks > 1 and column:
        return 'row_tiles'
    if design == 'rows' and blocks > 1 and vjp:
        return 'cluster'
    return design
# the column tiles' vjp: its three kernels, by KERNELS name and trace name
TILE_VJP_PARTS = (('ansatz_vjp_tile_gates', 'vjp_tile_gates_kernel'),
                  ('ansatz_vjp_column_tiles', 'vjp_tiles_kernel'),
                  ('ansatz_vjp_tile_sum', 'vjp_tile_sum_kernel'))
# the global row tiles' kernels, the same way: the prologue a call (the
# gates), then the forward pass's passes, or the vjp's passes and its sum
GLOBAL_PARTS = {
    False: (('ansatz_global_gates', 'global_gates_kernel'),
            ('ansatz_forward_global_rows', 'forward_global_kernel')),
    True: (('ansatz_global_gates', 'global_gates_kernel'),
           ('ansatz_vjp_global_rows', 'vjp_global_kernel'),
           ('ansatz_vjp_global_sum', 'vjp_global_sum_kernel'))}


def designs_alone(calls, repeats=20):
    """{(design, vjp): mean ms of the kernel alone} from one torch.profiler
    trace of the card over `calls`, a list of (design, vjp, fn) run in that
    order `repeats` times each; the designs' kernels have different names,
    so one trace holds them all."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _, _, fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _, _, fn in calls:
            for _ in range(repeats):
                fn()
        torch.cuda.synchronize()
    out = {}
    for key in {(d, v) for d, v, _ in calls}:
        total_us, count = 0.0, 0
        for event in prof.key_averages():
            if TRACE_NAMES[key] in event.key:
                spent = getattr(event, 'self_device_time_total', None)
                if spent is None:
                    spent = event.self_cuda_time_total
                total_us += spent
                count += event.count
        out[key] = total_us / count / 1e3 if count and total_us > 0 else None
    return out


def phase_unitary(card):
    """Phase 12: the forward and vjp kernels of kernels/unitary.py against
    their plain version (sim.batched.build_unitary_batched under autograd)
    on the card, same inputs, B = 256 restarts at the five largest layouts
    and, at every template that phases 13 and 14 drive, the batch they
    drive it with (unitary_shapes), angles uniform in [0, 2 pi) from a
    seeded numpy generator, each through the design the plan gives it (the
    column design for the whole unitary at 2 to 6 qubits, the row-split
    one for one column and for 7 and 8 qubits), the plan held against the
    library's. Tolerances: the unitary within 2e-5 in every entry
    (complex64, two float32 derivations of at most 46 gates); the angle
    gradients within 1e-4 of autograd's, each scaled by max(1, |gradient|),
    for two cotangents: that of the HS test against a complex random
    unitary (of the state loss against its first column where only column 0
    is built), which catches a missing conjugate, and a random complex
    cotangent; at 3 qubits the kernel's gradient within 1e-3 of central
    differences (h = 1e-4) of the plain path in float64. The column kernels
    must have 0 bytes of local memory (CUDA runtime) and 0 bytes of stack
    and spills (ptxas). Then both kernels' times at UNITARY_TIMING beside
    their bounds and the plain version's times: of one call of the wrapper
    (CUDA events, the faster of two; at these sizes mostly the host's
    launch path) and of the kernel alone on the card (torch.profiler),
    against which the share of the bound is taken where the trace has it;
    where the plan takes the column design, the row-split design is timed
    in turns with it (rows, columns, columns, rows), with the registers,
    local bytes and resident blocks per SM of each.
    Returns (largest errors by kernel, timing rows by kernel)."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import Ansatz
    from cpflow_tpu_torch.kernels import build
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    from cpflow_tpu_torch.sim.batched import (batched_cost_hst,
                                              batched_state_prep,
                                              build_unitary_batched)
    from cpflow_tpu_torch.topology import (chain_layer, connected_layer,
                                           fill_layers)
    dev = 'cuda'
    worst = {'ansatz_forward': 0.0, 'ansatz_vjp': 0.0,
             'ansatz_forward_column_tiles': 0.0}
    regs = uk.registers(dev)
    stacks = column_ptxas()
    local = {k: v['local_bytes'] for k, v in regs.items() if 'columns' in k}
    built_here = 'ptxas' in build.INFO.get('unitary', {})
    check((len(stacks) == len(local) or not built_here) and
          all(v == (0, 0, 0) for v in stacks.values()) and
          not any(local.values()),
          f'the column kernels use local memory: ptxas (stack, spill stores, '
          f'spill loads) {stacks}, runtime local bytes {local}')
    print(f'phase 12: column kernels: runtime local bytes 0 in all '
          f'{len(local)}; ptxas '
          + (f'0 bytes of stack and spills in all {len(stacks)}' if built_here
             else 'report not read (the library was built before this run)')
          + f'; registers { {k: v["registers"] for k, v in regs.items()} }',
          flush=True)

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
        plans = unitary_plan(n, nb, nba, 0 if cols else n, s['name'])
        drawn = rng.uniform(0, 2 * math.pi, (P, B))
        mask = None
        if s.get('verification'):
            frozen = np.nonzero(Ansatz(n, ent, pl, rot).cp_mask)[0][::2]
            drawn[frozen] = math.pi * rng.integers(0, 2, (len(frozen), B))
            mask = torch.ones(P, B, device=dev)
            mask[torch.as_tensor(frozen, device=dev)] = 0
        angles = torch.tensor(drawn, dtype=torch.float32, device=dev)
        before = (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES, uk.COLUMN_LAUNCHES)
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
        on_columns = 3 * (plans[0]['design'] == 'columns') + \
            2 * (plans[1]['design'] == 'columns')
        check(uk.FORWARD_LAUNCHES == before[0] + 3 and
              uk.VJP_LAUNCHES == before[1] + 2 and
              uk.COLUMN_LAUNCHES == before[2] + on_columns,
              f'{s["name"]}: the kernels were not launched in the plan\'s '
              f'designs')
        err_g, err_h = scaled(g_k, g_p), scaled(h_k, h_p)
        check(err_g <= 1e-4 and err_h <= 1e-4,
              f'{s["name"]}: gradient differs from autograd: loss cotangent '
              f'{err_g}, random cotangent {err_h}')
        line = (f'phase 12: {s["name"]} B={B}: forward {plan_text(plans[0])}; '
                f'vjp {plan_text(plans[1])}; unitary error max '
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
        fline = 'ansatz_forward' + (
            '_column_tiles' if plans[0]['design'] == 'tiles' else '')
        worst[fline] = max(worst[fline], err_f)
        worst['ansatz_vjp'] = max(
            worst['ansatz_vjp'], (g_k - g_p).abs().max().item(),
            (h_k - h_p).abs().max().item())

    rows = {'ansatz_forward': [], 'ansatz_vjp': []}
    layers = {'chain': chain_layer, 'connected': connected_layer}
    for name, n, k, Bt, rot, layer in UNITARY_TIMING:
        tpl = (n, 'cp', rot, fill_layers(layers[layer](n), k))
        nba = num_block_angles('cp', rot)
        work = unitary_work(n, k, rot)
        rng = np.random.default_rng(1250 + n)
        angles = torch.tensor(rng.uniform(0, 2 * math.pi, (work['P'], Bt)),
                              dtype=torch.float32, device=dev)
        plans = unitary_plan(n, k, nba, n, name)
        u = uk.ansatz_forward(*tpl, angles)                    # warm-up
        w = torch.view_as_complex(torch.tensor(
            rng.normal(size=tuple(u.shape) + (2,)), dtype=torch.float32,
            device=dev))
        uk.ansatz_vjp(*tpl, angles, u, w)                      # warm-up
        pf, pv = [], []
        for _ in range(3):                    # the first call warms up
            a_p = angles.clone().requires_grad_(True)
            u_p, ms = timed(lambda: build_unitary_batched(*tpl, a_p))
            w_p = w.permute(1, 2, 0).reshape(u_p.shape)
            pf.append(ms)
            pv.append(timed(lambda: torch.autograd.grad(
                u_p, a_p, grad_outputs=w_p))[1])
        both = plans[0]['design'] == 'columns'
        # where the plan is not the column design, each pass in its plan's
        # (7 and 8 qubits: the forward pass on the column tiles, the vjp on
        # a cluster)
        turns = ['rows', 'columns', 'columns', 'rows'] if both else [None]
        calls, call_ms = [], {}
        # each pass's plan in its design, and in the row-split one
        launch_of = {(p['design'], vjp): p
                     for vjp, p in zip((False, True), plans)}
        if both:  # the row-split design's launch (rows.cuh's warps)
            for vjp in (False, True):
                q = uk.rows_launch(n, k, nba, n, vjp)
                launch_of[('rows', vjp)] = dict(
                    blocks_per_restart=q['cluster'], threads=q['threads'],
                    smem_bytes=q['smem_bytes'])
        for design in turns:
            f = functools.partial(uk.ansatz_forward, *tpl, angles,
                                  design=design)
            v = functools.partial(uk.ansatz_vjp, *tpl, angles, u, w,
                                  design=design)
            for vjp, fn in ((False, f), (True, v)):
                key = design or plans[vjp]['design']
                calls.append((trace_key(
                    key, vjp, launch_of[(key, vjp)]['blocks_per_restart']),
                              vjp, fn))
                call_ms.setdefault((key, vjp), []).append(
                    min(timed(fn)[1] for _ in range(2)))
        alone = designs_alone(calls)
        if n >= 7:  # two launches on the same inputs, the same bits
            check(torch.equal(uk.ansatz_forward(*tpl, angles),
                              uk.ansatz_forward(*tpl, angles)) and
                  torch.equal(uk.ansatz_vjp(*tpl, angles, u, w),
                              uk.ansatz_vjp(*tpl, angles, u, w)),
                  f'{name}: two launches on the same inputs differ')
        for kernel, vjp, plain, ops, nbytes in [
                ('ansatz_forward', False, min(pf[1:]), work['forward'],
                 work['forward_bytes']),
                ('ansatz_vjp', True, min(pv[1:]), work['vjp'],
                 work['vjp_bytes'])]:
            p = plans[vjp]
            kernel += '_column_tiles' if p['design'] == 'tiles' else ''
            b_ms, b_by = unitary_bound_ms(ops, nbytes, Bt)
            row = dict(shape=name, design=p['design'],
                       cluster=p['blocks_per_restart'], bound_ms=b_ms,
                       bound_by=b_by, plain_ms=plain)
            for design in turns[:2] if both else [p['design']]:
                q = launch_of[(design, vjp)]  # the row-split design's sizes
                c = q['blocks_per_restart']  # where it is not the plan's
                kname = uk.kernel_name(design, vjp, n, c)
                threads, nbytes_block = q['threads'], q['smem_bytes']
                ms = call_ms[(design, vjp)]
                prefix = '' if design == p['design'] else 'rows_'
                row.update({
                    f'{prefix}ms': sum(ms) / len(ms),
                    f'{prefix}device_ms': alone[(trace_key(design, vjp, c),
                                                 vjp)],
                    f'{prefix}registers': regs[kname]['registers'],
                    f'{prefix}local_bytes': regs[kname]['local_bytes'],
                    f'{prefix}blocks_per_sm': uk.occupancy(
                        kname, threads, nbytes_block, dev)})
                check(kname not in NO_LOCAL or
                      regs[kname]['local_bytes'] == 0,
                      f'{name}: {kname} uses local memory: {regs[kname]}')
            on_card = row['device_ms']
            shown = 'not measured' if on_card is None else \
                f'{on_card:.4f} ms (share of bound {b_ms / on_card:.2%})'
            text = (f'phase 12: {kernel} {name} on {card}: {plan_text(p)}; '
                    f'one call {row["ms"]:.4f} ms, the kernel alone on the '
                    f'card {shown}; bound {b_ms:.5f} ms by {b_by} ({ops} '
                    f'float32 ops and {nbytes} bytes per restart); plain '
                    f'{plain:.3f} ms; {row["registers"]} registers, '
                    f'{row["local_bytes"]} local bytes, '
                    f'{row["blocks_per_sm"]} blocks per SM')
            if both:
                old = row['rows_device_ms']
                text += (f'; row-split design in turns: one call '
                         f'{row["rows_ms"]:.4f} ms, alone '
                         + ('not measured' if old is None else
                            f'{old:.4f} ms ({b_ms / old:.2%})') +
                         f', {row["rows_registers"]} registers, '
                         f'{row["rows_local_bytes"]} local bytes, '
                         f'{row["rows_blocks_per_sm"]} blocks per SM')
                if old and on_card:
                    text += f'; columns / rows {on_card / old:.3f}'
            print(text, flush=True)
            rows.setdefault(kernel, []).append(row)
    ratios = [(r['shape'], kernel, r['device_ms'] / r['rows_device_ms'])
              for kernel, rs in rows.items() for r in rs
              if r.get('rows_device_ms') and r['device_ms']]
    slowest = max(ratios, key=lambda t: t[2]) if ratios else None
    first = rows['ansatz_vjp'][0]
    half = first.get('rows_device_ms') and first['device_ms'] and \
        first['device_ms'] <= 0.5 * first['rows_device_ms']
    print(f'phase 12: the column design against the row-split one, the '
          f'kernels alone in turns: slowest ratio {slowest} (no shape more '
          f'than 5% slower: {"held" if slowest and slowest[2] <= 1.05 else "missed"}); '
          f'3q k=12 B=1024 vjp at most half: {"held" if half else "missed"}',
          flush=True)
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
    to 0 just before and read just after, and the plain builder watched;
    every launch of the unitary kernels must run the column design (the
    whole unitary at 3 and 4 qubits).
    Returns (results, forward launches, vjp launches, sweep launches, plain
    builder calls, wall seconds)."""
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.kernels import unitary as uk
    with PlainBuilderWatch() as watch:
        uk.FORWARD_LAUNCHES = uk.VJP_LAUNCHES = sk.LAUNCHES = 0
        uk.COLUMN_LAUNCHES = 0
        start = time.perf_counter()
        results = synth.adaptive(options, save_results=False, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES, sk.LAUNCHES)
    check(uk.COLUMN_LAUNCHES == counts[0] + counts[1],
          f'{uk.COLUMN_LAUNCHES} of {counts[0] + counts[1]} unitary kernel '
          f'launches ran the column design')
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

    def counted(fn):  # every launch must run the column design (3q)
        uk.FORWARD_LAUNCHES = uk.VJP_LAUNCHES = uk.COLUMN_LAUNCHES = 0
        start = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts = (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES)
        check(uk.COLUMN_LAUNCHES == sum(counts),
              f'{uk.COLUMN_LAUNCHES} of {sum(counts)} unitary kernel '
              f'launches ran the column design')
        return out, time.perf_counter() - start, counts

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


def cx_ladder(n):
    """The n-qubit CX ladder CX(0,1), then CX(1,2), ..., CX(n-2,n-1): n - 1
    CZ on the chain, and no fewer."""
    from cpflow_tpu_torch.circuits.ir import Circuit
    qc = Circuit(n)
    for q in range(n - 1):
        qc.cx(q, q + 1)
    return qc.unitary()


def ladder_program(n):
    """(placements, exact angles) of the n-qubit CX ladder on the chain,
    each CX(q, q+1) as H CZ H on qubit q + 1: n - 1 CZ, embedded exactly in
    the CP ansatz by the port's circuits.to_ansatz.circuit_to_ansatz."""
    from cpflow_tpu_torch.circuits.ir import Circuit
    from cpflow_tpu_torch.circuits.to_ansatz import circuit_to_ansatz
    qc = Circuit(n)
    for q in range(n - 1):
        qc.h(q + 1)
        qc.cz(q, q + 1)
        qc.h(q + 1)
    placements, angles = circuit_to_ansatz(qc)
    return [list(p) for p in placements], angles


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
             f'B={LADDER_SAMPLES}', n=7, k=LADDER_K, target=cx_ladder(7),
             B=LADDER_SAMPLES, r=StaticOptions.r, lr=0.1, cluster=2),
        dict(name=f'(z2) verification 7q chain CX ladder k={LADDER_K} B=8',
             n=7, k=LADDER_K, target=cx_ladder(7), B=8, cluster=2, **verify),
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
                   cluster=c, build=occ['build'],
                   local_bytes=occ['local_bytes'],
                   smem_bytes=occ['smem_bytes'],
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
    ladder = cx_ladder(7)
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
    ladder (phase_ladder7); the whole unitary one qubit past the column
    tiles' limit and a modulo loss past the unitary kernels' limit refused
    (refuse_whole_beyond). Returns (largest error of (a), the timing rows,
    the launches of (b) and (c))."""
    start = time.perf_counter()
    from cpflow_tpu_torch.kernels import sweep as sk
    worst, driven, rows = phase_compare(seven_shapes(), 'phase 15 (a)')
    check({2, 4, 8} <= {r['cluster'] for r in rows} and
          {r['build'] for r in rows} == {'sweep_cluster'},
          f'phase 15 (a) ran clusters of {sorted({r["cluster"] for r in rows})}'
          f' on the builds {sorted({r["build"] for r in rows})}')
    launches, by_build = {}, {}
    sk.LAUNCHES_BY_BUILD.clear()
    launches['toffoli7_warm'], toffoli_rows = phase_toffoli7(card)
    by_build['toffoli7_warm'] = dict(sk.LAUNCHES_BY_BUILD)
    sk.LAUNCHES_BY_BUILD.clear()
    launches['static_ladder7'] = phase_ladder7()
    by_build['static_ladder7'] = dict(sk.LAUNCHES_BY_BUILD)
    check(all(by_build[p] == {'sweep_cluster': v} for p, v in launches.items()),
          f'phase 15: launches by path and build {by_build}, not all on the '
          f'cluster build')
    refuse_whole_beyond('phase 15')
    print(f'phase 15: wall {time.perf_counter() - start:.3f} s', flush=True)
    return worst, rows + toffoli_rows, launches, driven


# ------------------------------------------------------------ phase 16

MESH_T = 2000  # phase 16 (c) and (d): the sampling sweep's steps

# python -m cpflow_tpu_torch, as runpy runs it for -m, with the sweep
# kernel's launch count (set to 0 first) written to stderr once main()
# returns: the count lives in that process
CLI_COUNTED = (
    'import runpy, sys\n'
    'from cpflow_tpu_torch.kernels import sweep\n'
    'sweep.LAUNCHES = 0\n'
    'sys.argv = ["cpflow_tpu_torch"] + sys.argv[1:]\n'
    'runpy.run_module("cpflow_tpu_torch", run_name="__main__", '
    'alter_sys=True)\n'
    'print("LAUNCHES", sweep.LAUNCHES, file=sys.stderr)\n')


def mesh_sweep_inputs():
    """Phase 16 (c) and (d): the static CCZ sampling sweep's objective
    (3q chain, k=12, r=0.00055) and 1024 seeded initial angles (B, P) on
    the card."""
    from cpflow_tpu_torch.ops.gates import u_ccz3
    obj, P = make_objective(3, 12, u_ccz3, 0.00055)
    return obj, uniform_inits(P, 1024, 16, 'cuda').T.contiguous()


def same_sweep(a, b, same_build, what):
    """Phase 16's rule for two [initial, best] results of one batch: bit
    for bit where the same kernel build ran both, else drift_ok on the best
    regularised and plain losses. Returns a description."""
    import torch
    if same_build:
        check(torch.equal(a.regloss, b.regloss) and
              torch.equal(a.params, b.params) and torch.equal(a.loss, b.loss),
              f'{what}: not bit-equal on the same build')
        return 'bit-equal (same build)'
    for x, y, name in [(a.regloss[:, 1], b.regloss[:, 1], 'regloss'),
                       (a.loss[:, 1], b.loss[:, 1], 'loss')]:
        ok, within = drift_ok(scaled_err(x, y))
        check(ok, f'{what}: best {name} misses drift_ok ({within:.1%} '
              f'within 1e-4)')
    return 'within drift_ok (builds differ)'


def dist_worker(port, rank, out_path):
    """Phase 16 (d)'s worker: process `rank` of two over gloo on
    127.0.0.1, its shard on cuda:0, runs the sampling sweep of
    mesh_sweep_inputs through minimize_fused(sharding=) and saves the
    gathered result and its launch count to out_path."""
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.optimize.engine import minimize_fused
    from cpflow_tpu_torch.parallel import mesh as mesh_lib
    mesh_lib.distributed_init(f'127.0.0.1:{port}', 2, rank, timeout=90)
    mesh = mesh_lib.restart_mesh(['cuda:0'])
    obj, inits = mesh_sweep_inputs()
    sk.LAUNCHES = 0
    raw = minimize_fused(obj, inits, 0.1, MESH_T, sharding=mesh)
    torch.cuda.synchronize()
    torch.save({'regloss': raw.regloss.cpu(), 'loss': raw.loss.cpu(),
                'params': raw.params.cpu(), 'launches': sk.LAUNCHES,
                'size': mesh.size,
                'registers': sk.occupancy(obj, inits.shape[0] // 2,
                                          'cuda:0')['registers']}, out_path)
    torch.distributed.destroy_process_group()
    return 0


def phase_mesh(card):
    """Phase 16: the CLI and the restart split on the card (module
    docstring). (b), (c) and (e) run and are timed first, with the card to
    themselves; the subprocesses of (a) and (d) start after them. Returns
    the sweep kernel's launches per path."""
    import os
    import socket
    import tempfile
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import StaticOptions, Synthesize
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.ops.gates import u_ccz3
    from cpflow_tpu_torch.optimize import candidates as cand
    from cpflow_tpu_torch.optimize.engine import minimize_fused
    from cpflow_tpu_torch.parallel import mesh as mesh_lib
    from cpflow_tpu_torch.parallel.dryrun import dryrun_multichip
    from cpflow_tpu_torch.topology import chain_layer
    start = time.perf_counter()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    tmp = tempfile.mkdtemp(prefix='chip_smoke_')
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    run = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
               cwd=root, env=env)
    cli = [sys.executable, '-m', 'cpflow_tpu_torch']
    synth_args = ['synthesize', '--target', 'ccz', '--layer', 'chain',
                  '--static', '--num-cp-gates', '12', '--num-samples', '1024',
                  '--accepted-cz', '8', '--no-save']
    outs = [os.path.join(tmp, f'rank{r}.pt') for r in range(2)]
    procs = {}
    launches = {}
    try:
        # (b) the static CCZ with its restarts split over cuda:0 twice
        dev0 = torch.cuda.current_device()
        last = torch.cuda.device_count() - 1
        check(sk.library_device(f'cuda:{last}') == last, 'the kernel '
              f'library does not see cuda:{last} as current under the '
              f'launch guard')
        guard = (f'the library saw cuda:{last} current under the guard' if
                 last else 'the guard is not exercised on one card (the '
                 'library saw cuda:0, already current)')
        options = StaticOptions(num_cp_gates=12, num_samples=1024,
                                accepted_num_cz_gates=8)
        sampling = []
        real = cand.run_raw_stage_fused

        def watched(*args, **kw):
            before = sk.LAUNCHES
            out = real(*args, **kw)
            sampling.append(sk.LAUNCHES - before)
            return out

        runs, walls = {}, {}
        cand.run_raw_stage_fused = watched
        try:
            for name, mesh in [('none', None), ('mesh', mesh_lib.restart_mesh(
                    ['cuda:0', 'cuda:0']))]:
                synth = Synthesize(chain_layer(3), target_unitary=u_ccz3,
                                   mesh=mesh)
                sk.LAUNCHES = 0
                t0 = time.perf_counter()
                res = synth.static(options, save_results=False,
                                   verbose=False)
                torch.cuda.synchronize()
                walls[name] = time.perf_counter() - t0
                launches[name] = sk.LAUNCHES
                check(res.mesh_size == (2 if mesh else 1),
                      f'(b) mesh_size {res.mesh_size}')
                runs[name] = sorted((d.cz_count, float(d.loss))
                                    for d in res.decompositions)
        finally:
            cand.run_raw_stage_fused = real
        check(sampling == [1, 2], f'(b) sampling launches {sampling}, not '
              f'1 unsplit and one per shard')
        check(torch.cuda.current_device() == dev0, '(b) the current device '
              'changed')
        check(runs['none'] and [c for c, _ in runs['none']] ==
              [c for c, _ in runs['mesh']], '(b) the CZ lists differ')
        gap = max(abs(a - b) for (_, a), (_, b) in zip(runs['none'],
                                                         runs['mesh']))
        check(gap <= 1e-6, f'(b) losses differ by {gap:.3e}')
        print(f'phase 16 (b): static CCZ 1024 samples, mesh [cuda:0, '
              f'cuda:0] against none: {len(runs["mesh"])} decompositions '
              f'each, CZ lists equal, losses within {gap:.3e}; sampling '
              f'launches {sampling[1]} (none: {sampling[0]}), all '
              f'{launches["mesh"]} ({launches["none"]}); walls '
              f'{walls["mesh"]:.3f} s ({walls["none"]:.3f} s); {guard}',
              flush=True)
        launches = {'mesh_static_ccz': launches['mesh']}

        # (c) the sampling sweep split two ways against the whole batch
        obj, inits = mesh_sweep_inputs()
        B = inits.shape[0]
        whole, ms_whole = timed(lambda: minimize_fused(obj, inits, 0.1,
                                                       MESH_T))
        sk.LAUNCHES = 0
        split, ms_split = timed(lambda: minimize_fused(
            obj, inits, 0.1, MESH_T, sharding=mesh_lib.restart_mesh(
                ['cuda:0', 'cuda:0'])))
        launches['mesh_sweep'] = sk.LAUNCHES
        check(sk.LAUNCHES == 2, f'(c) {sk.LAUNCHES} launches, not 2')
        regs = {b: sk.occupancy(obj, b)['registers'] for b in (B, B // 2)}
        same = regs[B] == regs[B // 2]
        rule = same_sweep(split, whole, same, '(c)')
        print(f'phase 16 (c): 3q k=12 B={B} T={MESH_T} split 2 ways: '
              f'builds of {regs[B]} registers (whole) and {regs[B // 2]} '
              f'(halves); {rule}; {ms_split:.2f} ms split, '
              f'{ms_whole:.2f} ms whole (CUDA events around the call)',
              flush=True)

        # (e) the dry run over a mesh of four entries on the one card
        sk.LAUNCHES = 0
        t0 = time.perf_counter()
        dry = dryrun_multichip(4)
        torch.cuda.synchronize()
        launches['dryrun_multichip'] = sk.LAUNCHES
        check(dry['mesh'] == ['cuda:0'] * 4 and dry['cards_repeated'],
              f'(e) {dry}')
        check(sk.LAUNCHES >= 8, f'(e) {sk.LAUNCHES} launches: not one per '
              f'shard in both the sweep and the sampling stage')
        print(f'phase 16 (e): dryrun_multichip(4): {dry}; launches '
              f'{sk.LAUNCHES}; {time.perf_counter() - t0:.3f} s', flush=True)

        # (a) the CLI, and (d) the two processes, started once (b), (c)
        # and (e) have ended, so that no other process shares the card
        # while those are timed
        procs['info'] = subprocess.Popen(cli + ['info'], **run)
        procs['synthesize'] = subprocess.Popen(
            [sys.executable, '-c', CLI_COUNTED] + synth_args, **run)
        for r in range(2):
            procs[f'rank {r}'] = subprocess.Popen(
                [sys.executable, str(root / 'chip_smoke.py'), '--dist-worker',
                 str(port), str(r), outs[r]], **run)
        done = {}
        for name, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                raise PhaseError(f'phase 16: {name} did not end in 120 s')
            check(proc.returncode == 0, f'phase 16: {name} exited '
                  f'{proc.returncode}:\n{out[-2000:]}\n{err[-2000:]}')
            done[name] = (out, err)
        info = json.loads(done['info'][0].strip().splitlines()[-1])
        check(info['devices'] and info['devices'][0]['compute_capability']
              == '9.0', f'(a) info: {info}')
        found = json.loads(done['synthesize'][0].strip().splitlines()[-1])
        best = min((d['loss'] for d in found['decompositions']
                    if d['cz_count'] == 8), default=None)
        check(best is not None and best <= 1e-6 and min(
            d['cz_count'] for d in found['decompositions']) == 8,
              f'(a) no 8-CZ decomposition at loss <= 1e-6')
        counted = [line for line in done['synthesize'][1].splitlines()
                   if line.startswith('LAUNCHES ')]
        launches['cli_static_ccz'] = int(counted[-1].split()[1])
        check(launches['cli_static_ccz'] >= 2, '(a) the CLI launched the '
              'kernel in fewer than two stages')
        print(f'phase 16 (a): info {json.dumps(info)}; synthesize: '
              f'{len(found["decompositions"])} decompositions, best 8-CZ '
              f'loss {best:.3e}, launches {launches["cli_static_ccz"]}',
              flush=True)
        dist = []
        for r in range(2):
            got = torch.load(outs[r])
            check(got['size'] == 2 and got['regloss'].shape == (B, 2),
                  f'(d) rank {r} holds {tuple(got["regloss"].shape)}')
            dist.append(got)
            rebuilt = type(whole)(params=got['params'].cuda(),
                                  regloss=got['regloss'].cuda(),
                                  loss=got['loss'].cuda())
            rule_d = same_sweep(rebuilt, whole, got['registers'] == regs[B],
                                f'(d) rank {r}')
        launches['dist_sweep'] = sum(g['launches'] for g in dist)
        check(launches['dist_sweep'] == 2, f'(d) launches '
              f'{[g["launches"] for g in dist]}')
        print(f'phase 16 (d): two processes over gloo, one shard each on '
              f'cuda:0: both hold the whole {B} restarts, {rule_d} against '
              f'(c)\'s whole batch', flush=True)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f'phase 16: wall {time.perf_counter() - start:.3f} s; {card}',
          flush=True)
    return launches


# ------------------------------------------------------------ phase 17

GOLDEN_CONFIGS = [  # tests/test_golden_reference.py's: (tag, n, layer, ent,
    ('3q_chain_cp_xyz_k4', 3, 'chain', 'cp', 'xyz', 4, 7),   # rot, k, seed)
    ('3q_conn_cp_xz_k5', 3, 'connected', 'cp', 'xz', 5, 11),
    ('4q_chain_cz_xyz_k6', 4, 'chain', 'cz', 'xyz', 6, 3),
    ('5q_chain_cp_xyz_k8', 5, 'chain', 'cp', 'xyz', 8, 42),
]
NORMAL_ATOL = 2e-6  # the normal draws: XLA's erfinv and the port's, a few ulp
NORMAL_REPEATS = 10  # the CPU's 'normal' draw made again in this process
FRESH_NORMAL_DRAW = (  # ... and once in a fresh one, saved to argv[1]
    'import sys\n'
    'import numpy as np\n'
    'from cpflow_tpu_torch.api import Ansatz\n'
    'from cpflow_tpu_torch.ops import prng\n'
    'from cpflow_tpu_torch.optimize import candidates as cand\n'
    'from cpflow_tpu_torch.topology import chain_layer, fill_layers\n'
    "mask = Ansatz(3, 'cp', fill_layers(chain_layer(3), 12)).cp_mask\n"
    'np.save(sys.argv[1], cand.generate_initial_angles_batch(\n'
    "    prng.PRNGKey(0, 'cpu'), len(mask), mask, cp_dist='normal',\n"
    '    batch_size=1024).numpy())\n')


def draw_profile(fn, repeats=20):
    """(ms, kernels, device_ms) of one call of fn on the card: CUDA events
    around `repeats` calls, warm, over the count (the host's launching
    included, which is what a caller waits for); the kernels one call
    launches and their summed time on the card, from torch.profiler's trace
    (None if the trace holds no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    _, total = timed(lambda: [fn() for _ in range(repeats)])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, busy_us = 0, 0.0
    for event in prof.key_averages():
        spent = getattr(event, 'self_device_time_total', None)
        if spent is None:
            spent = event.self_cuda_time_total
        if spent > 0:
            kernels += event.count
            busy_us += spent
    return total / repeats, kernels or None, busy_us / 1e3 or None


def phase_prng(card):
    """Phase 17: the JAX package's random-number tree on the card, the
    sweep kernel against upstream's recorded Adam run, and the reference
    README's CCZ example through cpflow_torch. Returns the sweep kernel's
    launches on that example."""
    import numpy as np
    import torch
    import cpflow_torch
    from cpflow_torch.gates import u_ccz3
    from cpflow_torch.topology import chain_layer
    from cpflow_tpu_torch.api import Ansatz, LossSpec
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.ops import prng
    from cpflow_tpu_torch.optimize import candidates as cand
    from cpflow_tpu_torch.optimize.engine import minimize_fused
    from cpflow_tpu_torch.search.seed_chain import next_seed
    from cpflow_tpu_torch.sim.ansatz_kernel import (cp_angle_indices,
                                                    num_block_angles)
    from cpflow_tpu_torch.sim.batched import make_batched_regloss
    from cpflow_tpu_torch.topology import (connected_layer, fill_layers,
                                           square_layer)
    golden = np.load(Path(__file__).resolve().parent / 'tests' / 'golden' /
                     'reference_goldens.npz')

    # (a) the static CCZ's draw (3q chain k=12, seed 0, B=1024) on the card
    # against the CPU, then the four golden configs' draws against upstream
    mask = Ansatz(3, 'cp', fill_layers(chain_layer(3), 12)).cp_mask
    P, B = len(mask), 1024

    def draw(dist, device):
        return cand.generate_initial_angles_batch(
            prng.PRNGKey(0, device), P, mask, cp_dist=dist, batch_size=B)

    worst = {}
    for dist in ('uniform', '0', 'normal'):
        card_draw, cpu_draw = draw(dist, 'cuda').cpu(), draw(dist, 'cpu')
        off_cp = torch.as_tensor(mask) == 0
        check(torch.equal(card_draw[:, off_cp], cpu_draw[:, off_cp]),
              f'phase 17: the {dist!r} draw off the CP angles differs '
              f'between the card and the CPU')
        gap = (card_draw - cpu_draw).abs()
        worst[dist] = float(gap.max())
        limit = NORMAL_ATOL if dist == 'normal' else 0.0
        if worst[dist] > limit:
            at = np.unravel_index(int(gap.argmax()), tuple(gap.shape))
            eager = cand._cp_angles(cand._batch_draws(
                prng.PRNGKey(0, 'cuda'), P, B, dist == 'normal'), mask,
                dist).cpu()
            raise PhaseError(
                f'phase 17: the {dist!r} draw on the card is '
                f'{worst[dist]:.3e} from the CPU\'s (limit {limit}), at '
                f'{at}: card {float(card_draw[at])!r}, CPU '
                f'{float(cpu_draw[at])!r}, the card launching its kernels '
                f'one by one {float(eager[at])!r} (at most '
                f'{float((eager - cpu_draw).abs().max()):.3e} from the '
                f'CPU); {int((gap > limit).sum())} entries over')
    # the CPU's 'normal' draw made again in this long process and once in a
    # fresh one (ROADMAP C.7), each bit-equal to the first
    with tempfile.TemporaryDirectory(prefix='chip_smoke_') as tmp:
        out = os.path.join(tmp, 'fresh.npy')
        root = Path(__file__).resolve().parent
        subprocess.run([sys.executable, '-c', FRESH_NORMAL_DRAW, out],
                       check=True, capture_output=True, cwd=root,
                       env=dict(os.environ, PYTHONPATH=str(root),
                                CUDA_VISIBLE_DEVICES=''))
        fresh = torch.from_numpy(np.load(out))
    again = [draw('normal', 'cpu') for _ in range(NORMAL_REPEATS)] + [fresh]
    for i, other in enumerate(again):
        if not torch.equal(other, cpu_draw):
            at = torch.nonzero(other != cpu_draw)
            first = tuple(at[0].tolist())
            which = 'fresh process\'s' if i == NORMAL_REPEATS else \
                f'draw {i + 2}'
            raise PhaseError(
                f'phase 17: the CPU\'s {which} \'normal\' draw differs '
                f'from its first at {len(at)} '
                f'entries, {at[:6].tolist()}: at {first} '
                f'{float(other[first])!r} against {float(cpu_draw[first])!r}'
                f', the card {float(card_draw[first])!r}')
    layers = {'chain': chain_layer, 'connected': connected_layer}
    for tag, n, layer, ent, rot, k, seed in GOLDEN_CONFIGS:
        ref = golden[f'{tag}/angles']
        cp = np.zeros(len(ref), dtype=np.float32)
        if ent == 'cp':
            cp[cp_angle_indices(n, num_block_angles(ent, rot), k)] = 1
        ours = cand.random_cp_angles(len(ref), cp, 'uniform',
                                     prng.PRNGKey(seed, 'cuda'))
        check(np.array_equal(ours.cpu().numpy(), ref),
              f'phase 17: {tag} drawn on the card differs from upstream\'s')
        check(len(ref) == Ansatz(n, ent, fill_layers(layers[layer](n), k),
                                 rot).num_angles, f'phase 17: {tag} width')
    seeds, seed = [], 0
    for _ in range(4):  # phase 6's first four trial seeds
        seed = next_seed(seed)
        seeds.append(seed)
    bucket_mask = Ansatz(4, 'cp', fill_layers(square_layer(4), 40)).cp_mask
    # each draw as the path makes it (replayed from a CUDA graph) and its
    # kernels launched one by one (cand._batch_draws, the same ops)
    timings = {}
    for name, keys, width, normal in (
            ('uniform', prng.PRNGKey(0, 'cuda'), P, False),
            ('normal', prng.PRNGKey(0, 'cuda'), P, True),
            ('bucketed', prng.PRNGKey(seeds, 'cuda'), len(bucket_mask),
             False)):
        timings[name] = (
            draw_profile(lambda: prng.graphed(cand._batch_draws, keys, width,
                                              B, normal)),
            draw_profile(lambda: cand._batch_draws(keys, width, B, normal)))
    text = '; '.join(
        f'{name} {g[0]:.4f} ms ({g[1]} kernels, {g[2]} ms on the card), '
        f'launched one by one {e[0]:.4f} ms ({e[1]} kernels, {e[2]} ms)'
        for name, (g, e) in timings.items())
    print(f'phase 17 (a): draws on the card: 3q k=12 B={B} (P={P}) uniform, '
          f"'0' and 'normal' from seed 0 equal the CPU's (normal within "
          f"{worst['normal']:.3e}), the CPU's normal draw bit-equal "
          f'{NORMAL_REPEATS} times more in this process and once in a fresh '
          f"one; the four golden configs' angles equal "
          f'upstream\'s bit for bit; one draw (CUDA events; kernels and '
          f'their time on the card from the profiler), uniform and normal '
          f'at that shape, bucketed at phase 6\'s first stage (4 trials x '
          f'{B}, P={len(bucket_mask)}), replayed from a CUDA graph: {text} '
          f'({card})', flush=True)

    # (b) upstream's 60 Adam steps from its recorded start, through the
    # sweep kernel (B=1, r=0, lr 0.1) by minimize_fused
    d = 8
    tgt = np.eye(d, dtype=np.complex64)
    tgt[d - 2, d - 2] = tgt[d - 1, d - 1] = 0
    tgt[d - 2, d - 1] = tgt[d - 1, d - 2] = 1
    objective = make_batched_regloss(3, 'cp', 'xyz',
                                     fill_layers(chain_layer(3), 4),
                                     LossSpec('hst', target=tgt))
    init = torch.as_tensor(golden['adam/initial'], device='cuda')[None]
    before = sk.LAUNCHES
    raw = minimize_fused(objective, init, learning_rate=0.1,
                         num_iterations=60)
    check(sk.LAUNCHES == before + 1, 'phase 17 (b): the sweep kernel did '
          'not run')
    history = golden['adam/loss_history']
    best, at = float(raw.loss[0, 1]), int(history.argmin())
    check(abs(best - float(history.min())) <= 5e-4,
          f'phase 17 (b): best loss {best:.7f}, upstream\'s minimum '
          f'{float(history.min()):.7f}: more than 5e-4 apart')
    if at == len(history) - 1:
        gap = float(np.abs(raw.params[0, 1].cpu().numpy() -
                           golden['adam/final_params']).max())
        check(gap <= 5e-3, f'phase 17 (b): best angles {gap:.3e} from '
              f'upstream\'s final parameters')
        angles = f'best angles within {gap:.3e} of its final parameters'
    else:
        angles = (f'its minimum is step {at} of {len(history)}, not the '
                  f'last, so the record holds no angles to compare')
    print(f'phase 17 (b): sweep kernel, 60 Adam steps from upstream\'s '
          f'recorded start: best loss {best:.7f} against upstream\'s '
          f'minimum {float(history.min()):.7f} (|diff| '
          f'{abs(best - float(history.min())):.3e} <= 5e-4); {angles}',
          flush=True)

    # (c) the reference README's CCZ example through cpflow_torch, default
    # options but for the three the README sets
    s = cpflow_torch.Synthesize(chain_layer(3), target_unitary=u_ccz3,
                                label='ccz_chain')
    options = cpflow_torch.StaticOptions(num_cp_gates=12, num_samples=10,
                                         accepted_num_cz_gates=8)
    sk.LAUNCHES = 0
    start = time.perf_counter()
    results = s.static(options, save_results=False, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = sk.LAUNCHES
    target = np.asarray(u_ccz3).astype(np.complex128)
    hosts = sorted((dec.cz_count, float(1 - abs(
        (dec.circuit.unitary() * target.conj()).sum()) ** 2 / 64))
        for dec in results.decompositions)
    check(launches > 0, 'phase 17 (c): the sweep kernel did not run')
    good = [h for h in hosts if h[0] <= 8 and h[1] <= 1e-6]
    check(good, f'phase 17 (c): no decomposition with <= 8 CZ at host loss '
          f'<= 1e-6: {hosts}')
    print(f'phase 17 (c): the reference README\'s CCZ example through '
          f'cpflow_torch (10 samples, seed 0): verified {hosts}; best '
          f'{good[0][0]} CZ at host loss {good[0][1]:.3e}; kernel launches '
          f'{launches}; wall {wall:.3f} s', flush=True)
    return {'cpflow_torch_readme_ccz': launches}


# ------------------------------------------------------------ phase 18

# Phase 18's tolerances, the float64 builds against the plain float64
# version on the same inputs, stated before their first run on the card:
# the regularized losses at the initial angles within 1e-12 and the best
# losses after 60 steps within 1e-9 (scaled_err: scaled by max(1, |loss|));
# the unitary within 1e-12 and the gradient of a cotangent within 1e-11,
# scaled by max(1, |gradient|). Two float64 derivations of one function
# differ by roundoff near 1e-15; 60 Adam steps amplify it along nearly flat
# directions by a few orders (tests/test_torch_double.py), far below these
# bounds, so no drift rule is needed in float64.
F64_LOSS0_TOL, F64_BEST_TOL = 1e-12, 1e-9
F64_UNITARY_TOL, F64_GRAD_TOL = 1e-12, 1e-11
COLUMNS_F64 = 'sweep_columns_f64'  # the column build's double build
BLOCK_F64 = 'sweep_block_f64'  # the one-block build's double build
CLUSTER_F64 = 'sweep_cluster_f64'  # the cluster build's double build
C4_HOST_LOSS = 2.169e-6  # phase 8's 6-CZ decomposition in float64 (C.4)
F64_TIMING = [  # (shape, steps) of phase 5's first two rows and of (f)
    (dict(name='3q CCZ k=12 B=1024 (static sampling)', n=3, k=12, r=0.00055,
          B=1024, lr=0.1), 2000),
    (dict(name='5q Toffoli k=20 B=2048', n=5, k=20, r=0.00055, B=2048,
          lr=0.1), 500),
    (dict(name='(f) state 10q GHZ k=36 B=256', n=10, k=36, kind='state',
          B=256, r=0.001, lr=0.1), 500)]


def double_shapes():
    """Phase 18 (b)'s shapes, as phase 3's: the static CCZ's sampling shape,
    5q k=20, a 10q state, 4q modulo-diagonal, fixed 'cz' blocks with 'xz'
    and a 7q shape on a cluster (4 blocks a restart in float64, where float32
    takes 2)."""
    from cpflow_tpu_torch.ops.gates import multi_controlled_x, u_ccz3
    phase3 = {s['name'][:3]: s for s in compare_shapes()}
    return [
        dict(name='(A) 3q CCZ k=12 B=1024 (static sampling)', n=3, k=12,
             target=u_ccz3, B=1024, r=0.00055, lr=0.1),
        dict(phase3['(b)'], name='(B) 5q Toffoli k=20 B=256'),
        dict(phase3['(f)'], name='(C) state 10q GHZ k=36 B=256'),
        dict(phase3['(h)'], name='(D) modulo_diagonal 4q connected '
             'Toffoli-4 all wires k=12 B=256'),
        dict(phase3['(k)'], name="(E) 'cz' blocks on the 14 Toffoli-4 "
             "placements 'xz' B=512"),
        dict(name='(F) 7q chain Toffoli-7 k=24 B=64', n=7, k=24,
             target=multi_controlled_x(7), B=64, r=0.002, lr=0.1,
             cluster=4),
    ]


def double_ptxas(build_name):
    """[(entry, registers, stack bytes, spill stores, spill loads)] of the
    kernels of one build, from ptxas's report (phase 2's build)."""
    import re
    from cpflow_tpu_torch.kernels import build
    out, entry, frame = [], None, None
    for line in build.INFO.get(build_name, {}).get('ptxas', '').splitlines():
        if 'Compiling entry' in line:
            m = re.search(r"(sweep_kernel|forward_kernel|vjp_kernel|"
                          r"column_forward|column_vjp)(I(?:L[ib]\d+E)+E)?",
                          line)
            entry = line.split("'")[1] if m is None else m.group(1) + (
                f"<{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"
                if m.group(2) else '')
        elif entry and 'stack frame' in line:
            frame = tuple(int(v) for v in re.findall(r'(\d+) bytes',
                                                     line)[:3])
        elif entry and 'Used' in line and 'registers' in line and frame:
            regs = int(re.search(r'Used (\d+) registers', line).group(1))
            out.append((entry, regs, *frame))
            entry = frame = None
    return out


def phase_double(card):
    """Phase 18: the double-precision builds (csrc/ compiled with
    -DCPFLOW_DOUBLE) and the main paths after config.set_precision(True):
    (a) their ptxas report, registers and local bytes at run time, and the
    plans held against the libraries; (b) the sweep kernel against its
    plain float64 version at six shapes, 60 steps; (c) ansatz_forward and
    ansatz_vjp against the plain float64 builder under autograd, in both
    designs, at 3, 5 and 7 qubits; (d) the static CCZ (3q chain, k=12, 1024
    samples), 8 CZ verified with every sweep launch in float64, and phase
    6's adaptive square Toffoli-4 (bucketed, 8 evals); (e) phase 8's
    relative-phase Toffoli-4, 16 evals as phase 8, informational; (f)
    GHZ-4 with a
    custom loss through the float64 unitary kernels, and the static CCZ
    with the L1 penalty (cp_penalty_L1) routed to them; (g) times on CUDA
    events of each float64 kernel beside its float32 build, in turns, with
    the float64 bound. Runs under try/finally, so that float32 comes back
    for whatever follows. Returns the kernel lines of the float64 builds."""
    import numpy as np
    import torch
    from cpflow_tpu_torch import config
    from cpflow_tpu_torch.api import (AdaptiveOptions, Ansatz, LossSpec,
                                      StaticOptions, Synthesize)
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.ops import losses
    from cpflow_tpu_torch.ops.gates import (multi_controlled_x, u_ccz3,
                                            u_toff4)
    from cpflow_tpu_torch.ops.penalty import cp_penalty_L1
    from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
    from cpflow_tpu_torch.sim.batched import build_unitary_batched
    from cpflow_tpu_torch.topology import (chain_layer, connected_layer,
                                           fill_layers, square_layer)
    F64 = torch.float64
    start_phase = time.perf_counter()

    # (a) the builds
    from cpflow_tpu_torch.kernels import build
    for name in ('sweep_f64', 'unitary_f64'):
        info = build.INFO[name]
        rows = double_ptxas(name)
        print(f'phase 18 (a): {name}: nvcc {info.get("seconds", float("nan")):.2f}'
              f' s; ptxas (entry, registers, stack, spill stores, spill '
              f'loads) {rows}', flush=True)
        check(rows and all(r[3] == r[4] == 0 for r in rows),
              f'{name}: a kernel spills: {rows}')
    regs64 = uk.registers('cuda', F64)
    print(f'phase 18 (a): unitary kernels in float64 at run time (registers, '
          f'local bytes): {[(k, v["registers"], v["local_bytes"]) for k, v in regs64.items()]}',
          flush=True)
    check(all(v['local_bytes'] == 0 for k, v in regs64.items()
              if 'columns' in k),
          f'a float64 column kernel uses local memory: {regs64}')

    # (b) the sweep kernel against the plain float64 version
    worst_by = Counter()  # the largest error (initial, best) of each build
    cluster_rows = []  # the cluster build's rows, timed
    for s in double_shapes():
        obj, P = shape_objective(s, F64)
        init = uniform_inits(P, s['B'], s.get('seed', 7), 'cuda').to(F64)
        c, nbytes, occ = check_plan(obj, s['B'], s['name'])
        check(c == s.get('cluster', c), f'{s["name"]}: {c} blocks a restart')
        before = sk.F64_LAUNCHES
        got, ms = timed(lambda: sk.sweep(obj, init, s['lr'], 60))
        check(sk.F64_LAUNCHES == before + 1 and got.best_loss.dtype == F64,
              f'{s["name"]}: the double build did not run')
        want, plain_ms = timed(lambda: sk.sweep_reference(obj, init,
                                                          s['lr'], 60))
        e0 = scaled_err(got.regloss0, want.regloss0).max().item()
        e = scaled_err(got.best_loss, want.best_loss).max().item()
        worst_by[occ['build']] = max(worst_by[occ['build']], e0, e)
        if occ['build'] == CLUSTER_F64:
            b_ms, b_by = bound_ms(shape_work(dict(s, dtype=F64)), s['B'], 60)
            cluster_rows.append(dict(
                shape=s['name'], T=60, cluster=c, build=occ['build'], ms=ms,
                plain_ms=plain_ms, plain_T=60, bound_ms=b_ms, bound_by=b_by,
                registers=occ['registers'], local_bytes=occ['local_bytes'],
                max_abs_err=max(e0, e)))
        print(f'phase 18 (b): {s["name"]}: build {occ["build"]}, {c} block(s) '
              f'of {nbytes} bytes, '
              f'{occ["registers"]} registers, {occ["local_bytes"]} local '
              f'bytes, {occ["blocks_per_sm"]} blocks per SM; initial loss '
              f'err {e0:.3e} (tol {F64_LOSS0_TOL}), best loss err {e:.3e} '
              f'(tol {F64_BEST_TOL})', flush=True)
        check(e0 <= F64_LOSS0_TOL and e <= F64_BEST_TOL,
              f'{s["name"]}: float64 kernel against plain float64: initial '
              f'{e0:.3e}, best {e:.3e}')
    # 8 qubits in float64 (phase 15's (w), 16 blocks a restart): phase 19
    # (a), row (G)
    nba = num_block_angles('cp', 'xyz')

    # (c) the unitary kernels against the plain float64 builder
    uerr = {'ansatz_forward_f64': 0.0, 'ansatz_vjp_f64': 0.0}
    gen = torch.Generator(device='cuda').manual_seed(18)
    for n, k in ((3, 12), (5, 20), (7, 24)):
        anz = Ansatz(n, 'cp', fill_layers(chain_layer(n), k))
        fwd_plan, vjp_plan = unitary_plan(n, k, nba, n, f'{n}q k={k}', F64)
        angles = uniform_inits(anz.num_angles, 32, n, 'cuda').to(F64)
        ap = angles.clone().requires_grad_(True)
        up = build_unitary_batched(n, 'cp', 'xyz', anz.placements, ap,
                                   dtype=F64)
        up = up.reshape(2 ** n, 2 ** n, 32).permute(2, 0, 1)
        g = torch.randn(up.shape, dtype=up.dtype, device='cuda',
                        generator=gen)
        (gp,) = torch.autograd.grad((up * g.conj()).real.sum(), ap)
        # each pass in its plan's design, and where that is the column
        # design in the row-split one too (from 7 qubits the forward pass
        # runs on the column tiles alone)
        pairs = [(fwd_plan['design'], vjp_plan['design'])]
        if fwd_plan['design'] == 'columns':
            pairs.append(('rows', 'rows'))
        for fdesign, design in pairs:
            u = uk.ansatz_forward(n, 'cp', 'xyz', anz.placements, angles,
                                  design=fdesign)
            gk = uk.ansatz_vjp(n, 'cp', 'xyz', anz.placements, angles, u, g,
                               design=design)
            torch.cuda.synchronize()
            eu = (u - up.detach()).abs().max().item()
            eg = ((gk - gp).abs() / gp.abs().clamp(min=1.0)).max().item()
            fline = 'ansatz_forward' + (
                '_column_tiles_f64' if fdesign == 'tiles' else '_f64')
            uerr[fline] = max(uerr.get(fline, 0.0), eu)
            uerr['ansatz_vjp_f64'] = max(uerr['ansatz_vjp_f64'], eg)
            print(f'phase 18 (c): {n}q k={k} B=32 forward {fdesign}, vjp '
                  f'{design} design '
                  f'(forward {plan_text(fwd_plan)}; vjp {plan_text(vjp_plan)})'
                  f': unitary err {eu:.3e} (tol {F64_UNITARY_TOL}), gradient '
                  f'err {eg:.3e} (tol {F64_GRAD_TOL})', flush=True)
            check(u.dtype == torch.complex128 and eu <= F64_UNITARY_TOL and
                  eg <= F64_GRAD_TOL,
                  f'{n}q {fdesign}/{design}: float64 unitary kernels '
                  f'against plain: '
                  f'{eu:.3e}, {eg:.3e}')

    launches = {}
    columns, blocks = {}, {}  # the column and the one-block builds' shares

    def by_build(path):
        columns[path] = sk.LAUNCHES_BY_BUILD[COLUMNS_F64]
        blocks[path] = sk.LAUNCHES_BY_BUILD[BLOCK_F64]

    unitary_launches = {}
    config.set_precision(True)
    try:
        # (d) the static CCZ and the adaptive square Toffoli-4
        synth = Synthesize(chain_layer(3), target_unitary=u_ccz3)
        target = u_ccz3.astype(np.complex128)
        sk.LAUNCHES = sk.F64_LAUNCHES = 0
        sk.LAUNCHES_BY_BUILD.clear()
        start = time.perf_counter()
        results = synth.static(StaticOptions(num_cp_gates=12,
                                             num_samples=1024,
                                             accepted_num_cz_gates=8),
                               save_results=False, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        n_all, n64 = sk.LAUNCHES, sk.F64_LAUNCHES
        check(n_all >= 2 and n64 == n_all,
              f'float64 static CCZ: {n64} of {n_all} sweep launches in '
              f'float64 (2 or more, all in float64, needed)')
        hosts = sorted((d.cz_count, float(1 - abs(
            (d.circuit.unitary() * target.conj()).sum()) ** 2 / 64))
            for d in results.decompositions)
        good = [h for h in hosts if h[0] <= 8 and h[1] <= 1e-6]
        check(good, f'float64 static CCZ: no decomposition with <= 8 CZ at '
              f'host loss <= 1e-6: {hosts[:5]}')
        print(f'phase 18 (d): static CCZ 3q k=12 1024 samples in float64: '
              f'{len(hosts)} verified, CZ count: number '
              f'{dict(sorted(Counter(h[0] for h in hosts).items()))}, best '
              f'{good[0][0]} CZ at host loss {good[0][1]:.3e}; sweep launches '
              f'{n_all}, {n64} of them float64; wall {wall:.3f} s, sampling '
              f'{synth.stage_seconds["sampling"]:.3f} s '
              f'({", ".join(f"{k} {v:.3f} s" for k, v in synth.stage_seconds.items())})',
              flush=True)
        launches['static_ccz3_f64'] = n64
        by_build('static_ccz3_f64')

        # the state path of phase 7 in float64, on the one-block build
        sk.F64_LAUNCHES = 0
        n_all = phase_state('phase 18 (d) float64')
        check(sk.F64_LAUNCHES == n_all, f'float64 static GHZ-4: '
              f'{sk.F64_LAUNCHES} of {n_all} sweep launches in float64')
        launches['static_ghz4_f64'] = sk.F64_LAUNCHES
        by_build('static_ghz4_f64')

        synth = Synthesize(square_layer(4), target_unitary=u_toff4)
        sk.F64_LAUNCHES = 0
        results, sweeps, n_all, wall = run_adaptive(synth, AdaptiveOptions(
            min_num_cp_gates=10, max_num_cp_gates=40, num_samples=1024,
            bucketed=True, parallel_trials=4, max_evals=8,
            target_num_cz_gates=16, stop_if_target_reached=True))
        n64 = sk.F64_LAUNCHES
        check(n64 == n_all > 0, f'float64 adaptive Toffoli-4: {n64} of '
              f'{n_all} sweep launches in float64')
        target = u_toff4.astype(np.complex128)
        hosts = sorted((d.cz_count, float(1 - abs(
            (d.circuit.unitary() * target.conj()).sum()) ** 2 / 256))
            for d in results.decompositions)
        good = [h for h in hosts if h[1] <= 1e-6]
        check(good, f'float64 adaptive Toffoli-4: no verified decomposition '
              f'at host loss <= 1e-6: {hosts}')
        tr, stages = trial_summary(synth, results.trials.results)
        print(f'phase 18 (d): adaptive Toffoli-4 square in float64, bucketed,'
              f' 4 parallel trials: {len(results.trials.results)} evals in '
              f'{len(sweeps)} sampling sweeps; best {good[0][0]} CZ at host '
              f'loss {good[0][1]:.3e} (published 16); {tr}; sweep launches '
              f'{n_all}, {n64} float64; wall {wall:.3f} s ({stages})',
              flush=True)
        launches['adaptive_toffoli4_f64'] = n64
        by_build('adaptive_toffoli4_f64')

        # (e) the relative-phase Toffoli-4, informational
        wires = [0, 1, 2, 3]
        synth = Synthesize(connected_layer(4), unitary_loss_func=LossSpec(
            'modulo_diagonal', target=u_toff4, num_qubits=4, wires=wires))
        sk.F64_LAUNCHES = 0
        results, sweeps, n_all, wall = run_adaptive(synth, AdaptiveOptions(
            min_num_cp_gates=4, max_num_cp_gates=20, num_samples=1024,
            bucketed=True, parallel_trials=4, max_evals=16,
            target_num_cz_gates=6, stop_if_target_reached=True))
        n64 = sk.F64_LAUNCHES
        check(n64 == n_all > 0, f'float64 relative-phase Toffoli-4: {n64} of '
              f'{n_all} sweep launches in float64')
        hosts = sorted((d.cz_count, float(losses.disc_modulo_diagonal(
            target, d.circuit.unitary(), 4, wires)))
            for d in results.decompositions)
        print(f'phase 18 (e): adaptive relative-phase Toffoli-4 in float64, '
              f'{len(results.trials.results)} evals: verified (CZ, float64 host loss) '
              f'{[(c, float(f"{h:.3e}")) for c, h in hosts]}; best '
              f'{hosts[0] if hosts else None} beside float32 verification\'s '
              f'6 CZ at {C4_HOST_LOSS} (ROADMAP C.4); sweep launches {n_all}, '
              f'{n64} float64; wall {wall:.3f} s', flush=True)
        launches['adaptive_relphase_toffoli4_f64'] = n64
        by_build('adaptive_relphase_toffoli4_f64')

        # (f) a custom loss and a custom penalty through the float64 unitary
        # kernels
        ghz4, psi0 = on_device(ghz(4)), on_device(np.eye(16)[0])
        ghz_loss = lambda u: 1 - torch.abs(ghz4(u).conj() @ u @ psi0(u)) ** 2
        synth = Synthesize([[0, 1], [1, 2], [2, 3]],
                           unitary_loss_func=ghz_loss)
        uk.FORWARD_F64_LAUNCHES = uk.VJP_F64_LAUNCHES = 0
        results, fwd, vjp, fused, plain, wall = run_custom_adaptive(
            synth, AdaptiveOptions(min_num_cp_gates=0, max_num_cp_gates=10,
                                   target_num_cz_gates=3,
                                   stop_if_target_reached=True, max_evals=8))
        f64 = (uk.FORWARD_F64_LAUNCHES, uk.VJP_F64_LAUNCHES)
        check(f64 == (fwd, vjp) and fwd > 0 and vjp > 0 and fused == 0 and
              plain == 0,
              f'GHZ-4 custom loss in float64: forward {fwd} ({f64[0]} '
              f'float64), vjp {vjp} ({f64[1]}), fused {fused}, plain {plain}')
        target = ghz(4).astype(np.complex128)
        hosts = sorted((d.cz_count, float(1 - abs(
            target.conj() @ d.circuit.unitary()[:, 0]) ** 2))
            for d in results.decompositions)
        check(hosts and hosts[0][0] == 3 and hosts[0][1] <= 1e-6,
              f'GHZ-4 custom loss in float64: no 3-CZ decomposition at host '
              f'loss <= 1e-6: {hosts}')
        print(f'phase 18 (f): adaptive GHZ-4 line, custom loss, in float64: '
              f'{len(results.trials.results)} evals, verified (CZ, host loss) '
              f'{[(c, float(f"{h:.3e}")) for c, h in hosts]}; forward '
              f'launches {fwd}, vjp launches {vjp}, all float64; wall '
              f'{wall:.3f} s', flush=True)
        unitary_launches['adaptive_ghz4_custom_f64'] = f64

        synth = Synthesize(chain_layer(3), target_unitary=u_ccz3,
                           cp_regularization_func=cp_penalty_L1)
        target = u_ccz3.astype(np.complex128)
        steps = 300
        with PlainBuilderWatch() as watch:
            sk.LAUNCHES = sk.F64_LAUNCHES = 0
            sk.LAUNCHES_BY_BUILD.clear()
            uk.FORWARD_F64_LAUNCHES = uk.VJP_F64_LAUNCHES = 0
            uk.FORWARD_LAUNCHES = uk.VJP_LAUNCHES = 0
            start = time.perf_counter()
            results = synth.static(StaticOptions(
                num_cp_gates=12, num_samples=100, accepted_num_cz_gates=24,
                num_gd_iterations=steps,
                num_gd_iterations_at_verification=steps),
                save_results=False, verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
        f64 = (uk.FORWARD_F64_LAUNCHES, uk.VJP_F64_LAUNCHES)
        # sampling: a forward and a vjp launch a step, through the unitary
        # kernels; verification has no penalty and takes the fused kernel
        check(watch.calls == 0 and f64[0] > steps and f64[1] >= steps and
              f64 == (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES) and
              sk.F64_LAUNCHES == sk.LAUNCHES,
              f'L1 penalty in float64: plain builder {watch.calls}, forward '
              f'{f64[0]} of {uk.FORWARD_LAUNCHES}, vjp {f64[1]} of '
              f'{uk.VJP_LAUNCHES} in float64 ({steps} steps), sweep '
              f'{sk.F64_LAUNCHES} of {sk.LAUNCHES}')
        hosts = sorted((d.cz_count, float(1 - abs(
            (d.circuit.unitary() * target.conj()).sum()) ** 2 / 64))
            for d in results.decompositions)
        check(hosts and all(h <= 1e-6 for _, h in hosts),
              f'L1 penalty in float64: no verified decomposition: {hosts}')
        print(f'phase 18 (f): static CCZ with cp_penalty_L1 in float64, 100 '
              f'samples, 300 + 300 steps: verified (CZ, host loss) '
              f'{[(c, float(f"{h:.3e}")) for c, h in hosts[:6]]} of '
              f'{len(hosts)}; sampling through the unitary kernels, forward '
              f'{f64[0]} and vjp {f64[1]} float64 launches; verification '
              f'through the fused kernel, {sk.F64_LAUNCHES} float64 launches; '
              f'wall {wall:.3f} s', flush=True)
        unitary_launches['static_ccz3_l1_penalty_f64'] = f64
        launches['static_ccz3_l1_penalty_f64_verification'] = \
            sk.F64_LAUNCHES
        by_build('static_ccz3_l1_penalty_f64_verification')
    finally:
        config.set_precision(False)
    check(config.real_dtype == torch.float32, 'float32 did not come back')

    # (g) times, float64 beside float32, in turns
    sweep_rows = []
    for s, T in F64_TIMING:
        s = dict(s, target=ghz(s['n']) if s.get('kind') == 'state' else
                 u_ccz3 if s['n'] == 3 else multi_controlled_x(5))
        objs = {dt: shape_objective(s, dt)[0] for dt in (torch.float32, F64)}
        P = 3 * s['n'] + nba * s['k']
        init = uniform_inits(P, s['B'], 7, 'cuda')
        ms = {torch.float32: [], F64: []}
        for dt in (torch.float32, F64, F64, torch.float32):
            sk.sweep(objs[dt], init.to(dt), 0.1, 2)  # warm-up
            ms[dt].append(timed(lambda: sk.sweep(objs[dt], init.to(dt), 0.1,
                                                 T))[1])
        sk.sweep_reference(objs[F64], init.to(F64), 0.1, 2)
        T_plain = 100
        _, plain_ms = timed(lambda: sk.sweep_reference(objs[F64],
                                                       init.to(F64), 0.1,
                                                       T_plain))
        work = shape_work(dict(s, dtype=F64))
        b_ms, b_by = bound_ms(work, s['B'], T)
        occ = sk.occupancy(objs[F64], s['B'])
        m64, m32 = min(ms[F64]), min(ms[torch.float32])
        print(f'phase 18 (g): sweep {s["name"]} T={T} on {card}: '
              f'{occ["build"]}: float64 '
              f'{ms[F64][0]:.2f} / {ms[F64][1]:.2f} ms, float32 '
              f'{ms[torch.float32][0]:.2f} / {ms[torch.float32][1]:.2f} ms '
              f'(float64 / float32 {m64 / m32:.2f}); float64 bound '
              f'{b_ms:.3f} ms by {b_by} (peak {work["peak"]:.3g}), share '
              f'{b_ms / m64:.2%}; plain float64 {plain_ms:.2f} ms over '
              f'{T_plain} steps; float64 build {occ["registers"]} registers, '
              f'{occ["local_bytes"]} local bytes, {occ["threads"]} threads, '
              f'{occ["smem_bytes"]} shared bytes, {occ["blocks_per_sm"]} '
              f'blocks per SM', flush=True)
        sweep_rows.append(dict(shape=s['name'], T=T, cluster=occ['cluster'],
                               build=occ['build'], ms=m64, ms_f32=m32,
                               plain_ms=plain_ms, plain_T=T_plain,
                               bound_ms=b_ms, bound_by=b_by,
                               registers=occ['registers'],
                               local_bytes=occ['local_bytes'],
                               blocks_per_sm=occ['blocks_per_sm']))
    unitary_rows = {'ansatz_forward_f64': [], 'ansatz_vjp_f64': []}
    for n, k, B in ((3, 12, 1024), (5, 20, 2048)):
        anz = Ansatz(n, 'cp', fill_layers(chain_layer(n), k))
        angles = uniform_inits(anz.num_angles, B, 3, 'cuda')
        work = unitary_work(n, k, dtype=F64)
        for vjp, name in ((False, 'ansatz_forward_f64'),
                          (True, 'ansatz_vjp_f64')):
            calls = {}
            for dt in (torch.float32, F64):
                a = angles.to(dt)
                u = uk.ansatz_forward(n, 'cp', 'xyz', anz.placements, a)
                g = torch.randn(u.shape, dtype=u.dtype, device='cuda',
                                generator=gen)
                calls[dt] = (lambda a=a, u=u, g=g: uk.ansatz_vjp(
                    n, 'cp', 'xyz', anz.placements, a, u, g)) if vjp else \
                    (lambda a=a: uk.ansatz_forward(n, 'cp', 'xyz',
                                                   anz.placements, a))
            p = uk.plan(n, k, nba, n, vjp, F64)
            trace = TRACE_NAMES[(p['design'], vjp)]
            ms = {torch.float32: [], F64: []}
            alone = {torch.float32: [], F64: []}
            for dt in (torch.float32, F64, F64, torch.float32):
                calls[dt]()
                ms[dt].append(timed(lambda: [calls[dt]() for _ in
                                             range(20)])[1] / 20)
                alone[dt].append(device_ms(calls[dt], trace))
            a64 = angles.to(F64).requires_grad_(vjp)
            if vjp:
                up = build_unitary_batched(n, 'cp', 'xyz', anz.placements,
                                           a64, dtype=F64)
                gp = torch.randn(up.shape, dtype=up.dtype, device='cuda')
                _, plain_ms = timed(lambda: torch.autograd.grad(
                    (up * gp.conj()).real.sum(), a64, retain_graph=True))
            else:
                _, plain_ms = timed(lambda: build_unitary_batched(
                    n, 'cp', 'xyz', anz.placements, a64, dtype=F64))
            ops = work['vjp' if vjp else 'forward']
            nbytes = work['vjp_bytes' if vjp else 'forward_bytes']
            b_ms, b_by = unitary_bound_ms(ops, nbytes, B, dtype=F64)
            kname = uk.kernel_name(p['design'], vjp, n,
                                   p['blocks_per_restart'])
            m64, m32 = min(ms[F64]), min(ms[torch.float32])
            d64 = min((x for x in alone[F64] if x), default=None)
            d32 = min((x for x in alone[torch.float32] if x), default=None)
            share = f'{b_ms / d64:.2%}' if d64 else 'not measured'
            print(f'phase 18 (g): {name[:-4]} {n}q k={k} B={B} on {card} '
                  f'({p["design"]} design): kernel alone (profiler) float64 '
                  f'{alone[F64]} ms, float32 {alone[torch.float32]} ms '
                  f'(float64 / float32 '
                  f'{d64 / d32 if d64 and d32 else float("nan"):.2f}); one '
                  f'wrapper call (CUDA events, 20 in a row) float64 '
                  f'{ms[F64][0]:.4f} / {ms[F64][1]:.4f} ms, float32 '
                  f'{ms[torch.float32][0]:.4f} / {ms[torch.float32][1]:.4f} '
                  f'ms; float64 bound {b_ms:.4f} ms by {b_by}, share of the '
                  f'kernel alone {share}; plain float64 {plain_ms:.3f} ms; '
                  f'{regs64[kname]["registers"]} registers, '
                  f'{regs64[kname]["local_bytes"]} local bytes', flush=True)
            unitary_rows[name].append(dict(
                shape=f'{n}q chain k={k} B={B}', design=p['design'],
                cluster=p['blocks_per_restart'], ms=m64,
                ms_f32=m32, device_ms=d64, device_ms_f32=d32,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                registers=regs64[kname]['registers'],
                local_bytes=regs64[kname]['local_bytes']))
    print(f'phase 18: {time.perf_counter() - start_phase:.1f} s', flush=True)

    # the float64 builds' kernel lines: launches from (d)-(f), errors from
    # (b) and (c), times from (g) (unitary: at 3q k=12 B = 1024, ms one
    # wrapper call on CUDA events as phase 12's, device_ms the kernel alone;
    # sweep: plain_ms over plain_T steps); no single PyTorch call computes
    # these functions, so library_ms is null. The sweep's builds each have
    # their own line: the one-block build (sweep_block_f64: its launches,
    # its largest error in (b), its times at (f), the first row of (g) it
    # runs), the cluster build (sweep_cluster_f64: its largest error and
    # its times at (b)'s 7q row (F), its launches from phase 19's paths)
    # and the column build (its times at 3q k=12)
    row = next(r for r in sweep_rows if r['build'] == BLOCK_F64)
    lines = [{
        'name': BLOCK_F64, 'route': 'cuda', 'kernel': 'sweep_block_kernel',
        'source': 'cpflow_tpu_torch/csrc/sweep.cu',
        'build': '-DCPFLOW_DOUBLE',
        'replaces': 'cpflow_tpu/experimental/pallas_sweep.py:317',
        'launches': sum(blocks.values()), 'launches_by_path': blocks,
        'launches_all_builds_by_path': launches,
        'max_abs_err': worst_by[BLOCK_F64], 'ms': row['ms'],
        'plain_ms': row['plain_ms'], 'plain_T': row['plain_T'],
        'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
        'library_ms': None, 'registers': row['registers'],
        'local_bytes': row['local_bytes'],
        'shapes': [r for r in sweep_rows if r['build'] == BLOCK_F64]}]
    check(lines[-1]['launches'] > 0 and BLOCK_F64 in worst_by,
          f'the float64 one-block build missed phase 18\'s paths: {blocks}')
    row = cluster_rows[0]
    lines.append({
        'name': CLUSTER_F64, 'route': 'cuda', 'kernel': 'sweep_cluster_kernel',
        'source': 'cpflow_tpu_torch/csrc/sweep.cu',
        'build': '-DCPFLOW_DOUBLE',
        'replaces': 'cpflow_tpu/experimental/pallas_sweep.py:317',
        'launches': 0, 'launches_by_path': {},
        'max_abs_err': worst_by[CLUSTER_F64], 'ms': row['ms'],
        'plain_ms': row['plain_ms'], 'plain_T': row['plain_T'],
        'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
        'library_ms': None, 'registers': row['registers'],
        'local_bytes': row['local_bytes'], 'cluster': [row['cluster']],
        'shapes': cluster_rows})
    row = next(r for r in sweep_rows if r['build'] == COLUMNS_F64)
    lines.append({
        'name': COLUMNS_F64, 'route': 'cuda',
        'kernel': 'sweep_columns_kernel',
        'source': 'cpflow_tpu_torch/csrc/sweep.cu',
        'build': '-DCPFLOW_DOUBLE',
        'replaces': 'cpflow_tpu/experimental/pallas_sweep.py:317',
        'launches': sum(columns.values()), 'launches_by_path': columns,
        'max_abs_err': worst_by[COLUMNS_F64], 'ms': row['ms'],
        'plain_ms': row['plain_ms'], 'plain_T': row['plain_T'],
        'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
        'library_ms': None, 'registers': row['registers'],
        'local_bytes': row['local_bytes'],
        'shapes': [r for r in sweep_rows if r['build'] == COLUMNS_F64]})
    check(lines[-1]['launches'] > 0 and COLUMNS_F64 in worst_by,
          f'the float64 column build missed phase 18\'s paths: {columns}')
    for i, name in enumerate(('ansatz_forward_f64', 'ansatz_vjp_f64')):
        by_path = {k: v[i] for k, v in unitary_launches.items()}
        row = unitary_rows[name][0]
        lines.append({
            'name': name, 'route': 'cuda',
            'source': 'cpflow_tpu_torch/csrc/unitary.cu',
            'build': '-DCPFLOW_DOUBLE',
            'replaces': 'cpflow_tpu/sim/batched.py:255',
            'launches': sum(by_path.values()), 'launches_by_path': by_path,
            'max_abs_err': uerr[name], 'ms': row['ms'],
            'device_ms': row['device_ms'],
            'plain_ms': row['plain_ms'], 'bound_ms': row['bound_ms'],
            'bound_by': row['bound_by'], 'library_ms': None,
            'shapes': unitary_rows[name]})
    return lines


# ------------------------------------------------------------ phase 19

# Phase 19's choices, stated before its first run on the card. (b) the 8q
# CX ladder: LADDER8_SAMPLES restarts of LADDER8_STEPS sampling steps and at
# most 2000 verification steps, k = 9 on the chain, accepting 7 CZ. (c) the
# custom loss: B = 8 restarts; the kernels and the plain route held to
# F64_LOSS0_TOL and F64_BEST_TOL over 60 steps, and over CUSTOM8_STEPS
# steps to a best loss within CUSTOM8_TOL of each other (float64 roundoff
# that Adam amplifies: in C.10 a one-ulp change of the initial angles moved
# the angles by 7.8e-8 after 400 steps, so a loss off its minimum moves by
# about that much, far above 1e-9 and far below a loss that differs). (d)
# GHZ-13: Synthesize.static from GHZ13_SAMPLES random restarts at k =
# GHZ13_K, GHZ13_STEPS steps, then from a warm start at k = 12.
LADDER8_K, LADDER8_SAMPLES, LADDER8_STEPS = 9, 64, 2000
# (a)'s float64 rows: a restart whose best loss is past F64_BEST_TOL of the
# plain route on the card must be within F64_HOST_FACTOR times the distance
# of the plain route on the host from it. Phase 18's bounds assumed 60 Adam
# steps amplify float64 roundoff by a few orders only; at 8 qubits one
# restart of the modulo loss (K) amplifies it further (first run on the
# card: the kernel 1.524e-9 from the card's plain route, the host's plain
# route 2.126e-9 from it, every other restart under 3.2e-12). Two roundoff
# paths differ from a third by amounts of one order, hence the factor 4.
F64_HOST_FACTOR = 4.0
CUSTOM8_STEPS, CUSTOM8_TOL = 300, 1e-6
GHZ13_K, GHZ13_SAMPLES, GHZ13_STEPS = 14, 1024, 2000


def sixteen_shapes():
    """Phase 19 (a)'s sweep rows, as phase 3's shapes: the shapes that no
    cluster of at most 8 blocks holds, each with its dtype (default
    float32), its steps T where not 60 and the blocks a restart must run
    on. (G) is phase 15's (w) in float64, which phase 18 refused before
    clusters of 16; (H) is phase 15's (x) deepened in float64; (I) 8
    qubits deeper than 8 blocks hold in float32; (J) the 13-qubit state,
    one block a restart; (K) phase 15's (s) at 8 qubits in float64, a
    modulo loss whose sums read V across the 16 blocks' tiles."""
    import torch
    from cpflow_tpu_torch.ops.gates import multi_controlled_x
    t7, t8 = multi_controlled_x(7), multi_controlled_x(8)
    F64 = torch.float64
    return [
        dict(name="(G) 8q chain Toffoli-8 'xz' k=16 B=32 float64", n=8, k=16,
             target=t8, rot='xz', B=32, r=0.002, lr=0.1, cluster=16,
             dtype=F64),
        dict(name='(H) 7q chain Toffoli-7 k=200 B=8 T=10 float64', n=7,
             k=200, target=t7, B=8, r=0.002, lr=0.1, T=10, cluster=16,
             dtype=F64),
        dict(name='(I) 8q chain Toffoli-8 k=240 B=8 T=10', n=8, k=240,
             target=t8, B=8, r=0.002, lr=0.1, T=10, cluster=16),
        dict(name='(J) state 13q GHZ k=48 B=64', n=13, k=48, target=ghz(13),
             kind='state', B=64, r=0.001, lr=0.1, cluster=1),
        dict(name="(K) modulo_diagonal 8q chain Toffoli-8 wires [2, 5, 0] "
             "'xz' k=16 B=32 float64", n=8, k=16, target=t8,
             kind='modulo_diagonal', wires=[2, 5, 0], rot='xz', B=32,
             r=0.00055, lr=0.1, cluster=16, dtype=F64),
    ]


def sweep_row(s, c, occ, ms, plain_ms, T, card, label):
    """Prints one phase 19 (a) sweep row's plan, occupancy, times and share
    of its bound; returns its timing row."""
    import torch
    dtype = s.get('dtype', torch.float32)
    wires = s.get('wires')
    work = sweep_work(s['n'], max(s['ks']) if 'ks' in s else s['k'],
                      s.get('rot', 'xyz'), s.get('ent', 'cp'),
                      s.get('kind', 'hst'), len(wires) if wires else None,
                      dtype=dtype)
    b_ms, b_by = bound_ms(work, s['B'], T)
    tiles = 'tiles' in occ
    plan = (f'{occ["tiles"]} column tiles of {occ["columns"]} columns a '
            f'restart, each on a block' if tiles else
            f'{c} block(s) a restart')
    resident = (f'{occ["active_clusters"]} tile blocks resident; the Adam '
                f'kernel {occ["adam_registers"]} registers and '
                f'{occ["adam_local_bytes"]} local bytes' if tiles else
                f'{occ["active_clusters"]} clusters of {c} resident')
    print(f'{label}: {s["name"]} on {card}: {plan} of '
          f'{occ["threads"]} threads and {occ["smem_bytes"]} shared bytes, '
          f'{occ["registers"]} registers and {occ["local_bytes"]} local bytes '
          f'a thread, {occ["blocks_per_sm"]} block(s) and '
          f'{occ["warps_per_sm"]} warps per SM, {resident}; '
          f'T={T}: kernel {ms:.2f} ms (CUDA events), plain {plain_ms:.2f} ms; '
          f'bound {b_ms:.3f} ms by {b_by} ({str(dtype)[6:]}), share '
          f'{b_ms / ms:.2%}', flush=True)
    row = dict(shape=s['name'], T=T, cluster=c, build=occ['build'],
               smem_bytes=occ['smem_bytes'], registers=occ['registers'],
               local_bytes=occ['local_bytes'],
               active_clusters=occ['active_clusters'], ms=ms,
               plain_ms=plain_ms, plain_T=T, bound_ms=b_ms, bound_by=b_by)
    if tiles:
        row.update(cluster=1, tiles=occ['tiles'], columns=occ['columns'],
                   local_bytes=occ['local_bytes'],
                   warps_per_sm=occ['warps_per_sm'],
                   adam_registers=occ['adam_registers'])
    return row


def phase_sixteen_sweeps(card, shapes=None, label='phase 19 (a)'):
    """Phase 19 (a), the sweep: every row of `shapes` (sixteen_shapes by
    default) against its plain version on the card, the plan held against
    the library's. The float32 rows
    as phase 3 holds its shapes (phase_compare: the initial loss within 1e-5,
    the best losses by drift_ok); the float64 rows' initial losses within
    F64_LOSS0_TOL and their best losses within F64_BEST_TOL, or on a restart
    past it within F64_HOST_FACTOR times the distance of the plain route on the
    host from the card's (the roundoff of two float64 routes that Adam
    amplified on that restart); each launch of the double build counted. Every
    row must run on the blocks it names, through the build it names (a
    state on more than one block: the row tiles' build) and the card must
    hold at least one of its clusters. Returns (largest error of the float32
    rows, of the float64 rows, float32 timing rows, float64 timing rows)."""
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    F64 = torch.float64
    rows32, rows64, worst32, worst64 = [], [], 0.0, 0.0
    for s in sixteen_shapes() if shapes is None else shapes:
        dtype = s.get('dtype', torch.float32)
        T = s.get('T', 60)
        obj, P = shape_objective(s, dtype)
        c, nbytes, occ = check_plan(obj, s['B'], s['name'])
        check(c == s['cluster'] and occ['active_clusters'] >= 1,
              f'{s["name"]}: {c} blocks a restart, {occ["active_clusters"]} '
              f'clusters resident')
        tiles = 'tiles' in occ  # the column tiles: c independent blocks
        key = 'tiles' if tiles else c  # of sk.LAUNCHES_BY_CLUSTER
        build = occ['build']
        built = sk.LAUNCHES_BY_BUILD[build]
        if dtype == torch.float32:
            err, _, (row,) = phase_compare([s], label)
            worst32 = max(worst32, err)
            check(sk.LAUNCHES_BY_BUILD[build] > built,
                  f'{s["name"]}: the {build} build did not run')
            rows32.append(dict(sweep_row(s, c, occ, row['ms'],
                                         row['plain_ms'], T, card, label),
                               max_abs_err=row['max_abs_err']))
            continue
        init = uniform_inits(P, s['B'], s.get('seed', 19), 'cuda').to(F64)
        before = (sk.F64_LAUNCHES, sk.LAUNCHES_BY_CLUSTER[key])
        calls = s.get('calls', 1)
        got, ms = best_of(lambda: sk.sweep(obj, init, s['lr'], T), calls)
        runs = calls + (calls > 1)  # and the warm-up
        check((sk.F64_LAUNCHES, sk.LAUNCHES_BY_CLUSTER[key],
               sk.LAUNCHES_BY_BUILD[build]) ==
              (before[0] + runs, before[1] + runs, built + runs) and
              got.best_loss.dtype == F64,
              f'{s["name"]}: the double build {build} on {c} blocks did not '
              f'run')
        want, plain_ms = timed(lambda: sk.sweep_reference(obj, init, s['lr'],
                                                          T))
        e0 = scaled_err(got.regloss0, want.regloss0).max().item()
        err = scaled_err(got.best_loss, want.best_loss)
        e = err.max().item()
        # the restarts past F64_BEST_TOL again through the plain route on
        # the host: its distance from the card's plain route is the float64
        # roundoff that Adam amplified on them
        past = torch.nonzero(err > F64_BEST_TOL).flatten()
        host = torch.zeros_like(err)
        if len(past):
            on_host = sk.sweep_reference(obj, init[:, past].cpu(), s['lr'], T)
            host[past] = scaled_err(on_host.best_loss.to(err.device),
                                    want.best_loss[past])
        tol = torch.clamp(F64_HOST_FACTOR * host, min=F64_BEST_TOL)
        worst64 = max(worst64, e)
        print(f'{label}: {s["name"]}: initial loss err {e0:.3e} (tol '
              f'{F64_LOSS0_TOL}), best loss err {e:.3e} (tol {F64_BEST_TOL}; '
              f'{len(past)} restart(s) past it, where the plain route on the '
              f'host differs from the card\'s by up to '
              f'{host.max().item():.3e})', flush=True)
        check(e0 <= F64_LOSS0_TOL and bool((err <= tol).all()),
              f'{s["name"]}: float64 kernel against plain float64: initial '
              f'{e0:.3e}, best {err.tolist()}, the plain route on the host '
              f'against the card\'s {host.tolist()}')
        rows64.append(dict(sweep_row(s, c, occ, ms, plain_ms, T, card, label),
                           max_abs_err=max(e0, e)))
    return worst32, worst64, rows32, rows64


# (n, k, rot, B, dtype, passes, columns, blocks) of phase 19 (a)'s unitary
# rows, passes the vjp flags driven, the last of them on `blocks` blocks a
# restart: the vjp in float64 at 8q k=16 and in float32 deeper than 8
# blocks hold; the forward pass alone (no cluster: 16 independent blocks)
# in float64 where only 16 hold it, beyond the vjp's reach; one column of
# 13 qubits in float32 (a state, one block a restart)
def shape_layers(n, k, layer=()):
    """The placements of a unitary row of k blocks: on the n-qubit chain,
    or with layer ['random'] on k random distinct qubit pairs, either leg
    order, seeded by n and k."""
    import numpy as np
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    if not layer:
        return fill_layers(chain_layer(n), k)
    rng = np.random.default_rng(1000 * n + k)
    return fill_layers([list(map(int, rng.choice(n, 2, replace=False)))
                        for _ in range(k)], k)


SIXTEEN_UNITARY = [(8, 16, 'xyz', 16, 'float64', (False, True), None, 16),
                   (8, 270, 'xyz', 4, 'float32', (False, True), None, 16),
                   (8, 240, 'xyz', 2, 'float64', (False,), None, 16),
                   (13, 48, 'xyz', 8, 'float32', (False, True), [0], 1)]


def phase_sixteen_unitary(card, shapes=None, label='phase 19 (a)'):
    """Phase 19 (a), the unitary kernels: ansatz_forward and ansatz_vjp at
    `shapes` (SIXTEEN_UNITARY's by default, the same tuples) against the
    plain builder of the same dtype under
    autograd on the card (a random complex cotangent), each plan held against
    the library's; the float64 rows within F64_UNITARY_TOL and F64_GRAD_TOL,
    the float32 ones within phase 12's 2e-5 and 1e-4 (scaled by max(1,
    |gradient|)); each row's last pass must run on the blocks it names and the
    card hold at least one of its clusters (a vjp on more than one block, or
    either pass of one column split by rows) or blocks; every pass must run
    the kernel its plan names. On the column tiles (past what a cluster of
    16 holds) the sum of a float32 gradient runs over 2^2n entries, so
    where it misses 1e-4 against plain float32 the plain float64 gradient
    arbitrates: the kernel's error against it within 1e-4 or within twice
    plain float32's (as_close_as_plain's factor). The whole unitary on
    rows.cuh's warps (templates past the column design's depths, 100 to
    1100 blocks of gates, whose float32 rounding grows with depth in both
    versions): where the kernel's unitary or gradient misses against plain
    float32, it must meet the same tolerance against plain float64; both
    float32 versions' errors against plain float64 are printed at every
    such row. Prints each pass's plan,
    resident blocks or clusters, its time alone on the card (profiler) and
    by CUDA events, its bound and share. Returns (largest errors by kernel
    line name: a row tiles' and a column tiles' kernel have lines of their
    own, timing rows by kernel line name)."""
    import torch
    from cpflow_tpu_torch.api import Ansatz
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    from cpflow_tpu_torch.sim.batched import build_unitary_batched
    errs, rows = {}, {}
    gen = torch.Generator(device='cuda').manual_seed(19)
    for n, k, rot, B, dname, passes, cols, blocks, *layer in (
            SIXTEEN_UNITARY if shapes is None else shapes):
        dtype = getattr(torch, dname)
        f64 = dtype == torch.float64
        suffix = '_f64' if f64 else ''
        tol_u, tol_g = (F64_UNITARY_TOL, F64_GRAD_TOL) if f64 else (2e-5, 1e-4)
        anz = Ansatz(n, 'cp', shape_layers(n, k, layer), rot)
        nba = num_block_angles('cp', rot)
        name = f'{n}q {layer[0] if layer else "chain"} k={k} {rot!r} B={B} ' \
            f'{dname}' + (', column 0' if cols else '')
        plans = dict(zip(passes, unitary_plan(
            n, k, nba, 0 if cols else n, name, dtype, passes,
            tuple(tuple(int(q) for q in p)
                  for p in all_placements(anz.placements)))))
        last = 'vjp' if passes[-1] else 'forward pass'
        check(plans[passes[-1]]['blocks_per_restart'] == blocks,
              f'{name}: the {last} on '
              f'{plans[passes[-1]]["blocks_per_restart"]} blocks')
        vjp_too = True in passes
        vjp_blocks = plans[True]['blocks_per_restart'] if vjp_too else 1
        if vjp_too and plans[True]['design'] in ('tiles', 'global_rows'):
            # the key of uk.VJP_LAUNCHES_BY_CLUSTER
            vjp_blocks = plans[True]['design']
        angles = uniform_inits(anz.num_angles, B, 19, 'cuda').to(dtype)
        ap = angles.clone().requires_grad_(vjp_too)
        up = build_unitary_batched(n, 'cp', rot, anz.placements, ap,
                                   columns=cols, dtype=dtype)
        up = up.reshape(2 ** n, len(cols) if cols else 2 ** n, B) \
            .permute(2, 0, 1)
        if vjp_too:
            g = torch.randn(up.shape, dtype=up.dtype, device='cuda',
                            generator=gen)
            (gp,) = torch.autograd.grad((up * g.conj()).real.sum(), ap,
                                        retain_graph=True)
        before = (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES,
                  uk.VJP_LAUNCHES_BY_CLUSTER[vjp_blocks])
        knames = {vjp: uk.kernel_name(plan['design'], vjp, n,
                                      plan['blocks_per_restart'],
                                      cols is not None)
                  for vjp, plan in plans.items()}
        by_kernel = {v: uk.LAUNCHES_BY_KERNEL[kn + suffix]
                     for v, kn in knames.items()}
        u = uk.ansatz_forward(n, 'cp', rot, anz.placements, angles, cols)
        eg = 0.0
        if vjp_too:
            gk = uk.ansatz_vjp(n, 'cp', rot, anz.placements, angles, u, g,
                               cols)
            eg = ((gk - gp).abs() / gp.abs().clamp(min=1.0)).max().item()
        torch.cuda.synchronize()
        check((uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES,
               uk.VJP_LAUNCHES_BY_CLUSTER[vjp_blocks]) ==
              (before[0] + 1, before[1] + vjp_too, before[2] + vjp_too),
              f'{name}: the kernels did not run (the vjp on {vjp_blocks} '
              f'blocks)')
        check(all(uk.LAUNCHES_BY_KERNEL[kn + suffix] == by_kernel[v] + 1
                  for v, kn in knames.items()),
              f'{name}: not the kernels {knames} that the plans name')
        eu = (u - up.detach()).abs().max().item()
        # the whole unitary on rows.cuh's warps: templates past the column
        # design's depths, 300 to 1100 blocks of gates in float32 rounding
        deep = not f64 and cols is None and all(
            trace_key(p['design'], v, p['blocks_per_restart']) == 'rows'
            for v, p in plans.items())
        arbiter = ''
        if deep or (eg > tol_g and not f64 and
                    vjp_blocks in ('tiles', 'global_rows')):
            # the plain float64 builder arbitrates where the kernel misses
            # against plain float32: on the column tiles and the global row
            # tiles (sums over 2^2n or 2^18 and more entries) within twice
            # plain float32's error against it (as_close_as_plain's
            # factor), on rows.cuh's warps within the same tolerance
            a64 = angles.double().requires_grad_(vjp_too)
            u64 = build_unitary_batched(n, 'cp', rot, anz.placements, a64,
                                        columns=cols, dtype=torch.float64)
            u64 = u64.reshape(2 ** n, len(cols) if cols else 2 ** n, B) \
                .permute(2, 0, 1)
            notes = []
            if deep:
                ek = (u.to(u64.dtype) - u64.detach()).abs().max().item()
                ep = (up.detach().to(u64.dtype) - u64.detach()).abs() \
                    .max().item()
                notes.append(f'unitary: kernel {ek:.3e}, plain float32 '
                             f'{ep:.3e}' + (f' (the kernel {eu:.3e} against '
                                            f'plain float32)' if eu > tol_u
                                            else ''))
                if eu > tol_u:
                    eu = ek
            if vjp_too and (deep or eg > tol_g):
                (g64,) = torch.autograd.grad(
                    (u64 * g.to(u64.dtype).conj()).real.sum(), a64)
                scale = g64.abs().clamp(min=1.0)
                ek = ((gk.double() - g64).abs() / scale).max().item()
                ep = ((gp.double() - g64).abs() / scale).max().item()
                notes.append(f'gradient: kernel {ek:.3e}, plain float32 '
                             f'{ep:.3e}' + (f' (the kernel {eg:.3e} against '
                                            f'plain float32)' if eg > tol_g
                                            else ''))
                if eg > tol_g:
                    eg = ek
                    tol_g = tol_g if deep else max(tol_g, 2 * ep)
            del u64
            arbiter = (f' (against plain float64: {"; ".join(notes)})'
                       if notes else '')
        check(eu <= tol_u and eg <= tol_g, f'{name}: unitary err {eu:.3e}, '
              f'gradient err {eg:.3e} (tol {tol_u}, {tol_g}){arbiter}')
        regs = uk.registers('cuda', dtype)
        work = unitary_work(n, k, rot, log_c=0 if cols else None,
                            dtype=dtype)
        for vjp, plan in plans.items():
            c = plan['blocks_per_restart']
            kname = knames[vjp]
            tiles = kname.endswith('row_tiles')
            columns = plan['design'] == 'tiles'  # the column tiles
            wide = plan['design'] == 'global_rows'  # the global row tiles
            line = (kname if tiles or columns or wide else 'ansatz_vjp' if
                    vjp else 'ansatz_forward') + suffix
            errs[line] = max(errs.get(line, 0.0), eg if vjp else eu)
            call = (lambda: uk.ansatz_vjp(n, 'cp', rot, anz.placements,
                                          angles, u, g, cols)) if vjp else \
                (lambda: uk.ansatz_forward(n, 'cp', rot, anz.placements,
                                           angles, cols))
            parts, traced = None, ''
            if wide:  # a call's passes (and the vjp's sum), timed from a
                # trace that kept every launch of each: ms a call
                per = global_launches(call)
                pairs = GLOBAL_PARTS[vjp]
                want = {kernel: per.get(part + suffix, 0)
                        for part, kernel in pairs}
                got, kept, whole = traced_calls(call, want)
                check(None not in got.values(),
                      f'{name}: in three traces of 20 calls the profiler '
                      f'kept {kept} of the launches {want} a call makes')
                alone = sum(got.values())
                traced = f', launches a call {want}, ' + (
                    'all kept in 20 calls' if whole else
                    f'the profiler kept {kept} of 20 calls\' in three '
                    f'traces: the mean a launch kept times the launches a '
                    f'call')
                parts = {part: dict(
                    kernel=kernel, launches_a_call=want[kernel],
                    device_ms=got[kernel],
                    registers=regs[part]['registers'],
                    local_bytes=regs[part]['local_bytes'])
                    for part, kernel in pairs}
            elif columns and vjp:  # the prologue, the tiles' walk, the sum:
                # ms a launch, each once a call
                events = device_kernels(call)
                parts = {}
                for part, kernel in TILE_VJP_PARTS:
                    found = [v for key, v in events.items() if kernel in key]
                    count = sum(c for c, _ in found)
                    total = sum(t for _, t in found)
                    parts[part] = dict(
                        kernel=kernel, device_ms=total / count if count and
                        total > 0 else None,
                        registers=regs[part]['registers'],
                        local_bytes=regs[part]['local_bytes'])
                got = [v['device_ms'] for v in parts.values()]
                alone = None if None in got else sum(got)
            else:
                alone = device_ms(call, TRACE_NAMES[(trace_key(
                    plan['design'], vjp, c, cols is not None), vjp)])
            check(kname not in NO_LOCAL or regs[kname]['local_bytes'] == 0
                  and all(v['local_bytes'] == 0 for v in
                          (parts or {}).values()),
                  f'{name}: {kname} uses local memory: {regs[kname]}, '
                  f'{parts}')
            _, ms = timed(call)
            if vjp:
                _, plain_ms = timed(lambda: torch.autograd.grad(
                    (up * g.conj()).real.sum(), ap, retain_graph=True))
            else:
                _, plain_ms = timed(lambda: build_unitary_batched(
                    n, 'cp', rot, anz.placements, angles, columns=cols,
                    dtype=dtype))
            in_cluster = c > 1 and (vjp or tiles) and not columns and \
                not wide
            resident = uk.active_clusters(plan['threads'], plan['smem_bytes'],
                                          c, 'cuda', dtype, kname) \
                if in_cluster else uk.occupancy(
                    kname, plan['threads'], plan['smem_bytes'], 'cuda', dtype)
            check(resident >= (plan['per_sm'] if wide else 1),
                  f'{name}: the card holds {resident} {kname} of {c} blocks'
                  + (f' an SM, not the plan\'s {plan["per_sm"]}' if wide
                     else ''))
            b_ms, b_by = unitary_bound_ms(
                work['vjp' if vjp else 'forward'],
                work['vjp_bytes' if vjp else 'forward_bytes'], B, dtype=dtype)
            share = f'{b_ms / alone:.2%}' if alone else 'not measured'
            print(f'{label}: {line} {name} on {card}: {plan_text(plan)}, '
                  + (f'{resident} clusters of {c} resident' if in_cluster
                     else f'{resident} block(s) per SM')
                  + f', {regs[kname]["registers"]} registers, '
                  f'{regs[kname]["local_bytes"]} local bytes'
                  + (' (' + ', '.join(
                      f'{v["kernel"]} {v["registers"]} registers, '
                      f'{v["local_bytes"]} local bytes, {v["device_ms"]} ms'
                      for v in parts.values()) + ')' if parts else '')
                  + f'; unitary err {eu:.3e}, gradient err {eg:.3e} (tol '
                  f'{tol_u}, {tol_g}){arbiter}; '
                  f'kernel alone (profiler) {alone} ms{traced}, one wrapper '
                  f'call (CUDA events) {ms:.4f} ms, plain {plain_ms:.3f} ms; '
                  f'bound {b_ms:.4f} ms by {b_by}, share of the kernel alone '
                  f'{share}', flush=True)
            rows.setdefault(line, []).append(dict(
                shape=name, design=plan['design'], cluster=c,
                active_clusters=resident if in_cluster else None, ms=ms,
                device_ms=alone, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, registers=regs[kname]['registers'],
                local_bytes=regs[kname]['local_bytes'],
                **({'parts': parts} if parts else {}),
                **({'launches_a_call': want, 'launches_traced': kept,
                    'trace_whole': whole} if wide else {})))
    return errs, rows


def phase_ladder8(dtype=None, samples=LADDER8_SAMPLES, steps=LADDER8_STEPS):
    """Phase 19 (b): Synthesize.static at 8 qubits on the chain, target the
    CX ladder (CX(0,1) first, then CX(1,2), ..., CX(6,7)), which needs 7 CZ:
    k = LADDER8_K, `samples` restarts of `steps` sampling steps, at most
    2000 verification steps, accepting 7 CZ, in `dtype` (default float64,
    under config.set_precision(True), float32 restored in `finally`). Needs
    the kernel in both stages, every launch the build of `dtype` on the
    plan's blocks (16 in float64, 8 in float32), and a verified 7-CZ
    decomposition at float64 host loss <= 1e-6. Returns the launches."""
    import torch
    from cpflow_tpu_torch import config
    from cpflow_tpu_torch.api import StaticOptions, Synthesize
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
    from cpflow_tpu_torch.topology import chain_layer
    dtype = dtype or torch.float64
    f64 = dtype == torch.float64
    ladder = cx_ladder(8)
    c = sk.cluster_plan(8, LADDER8_K, num_block_angles('cp', 'xyz'), 'hst',
                        dtype)
    check(c == (16 if f64 else 8), f'8q ladder: {c} blocks a restart')
    config.set_precision(f64)
    try:
        synth = Synthesize(chain_layer(8), target_unitary=ladder)
        options = StaticOptions(num_cp_gates=LADDER8_K, num_samples=samples,
                                num_gd_iterations=steps,
                                num_gd_iterations_at_verification=2000,
                                accepted_num_cz_gates=7)
        sk.LAUNCHES = sk.F64_LAUNCHES = 0
        sk.LAUNCHES_BY_CLUSTER.clear()
        start = time.perf_counter()
        results = synth.static(options, save_results=False, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches, n64 = sk.LAUNCHES, sk.F64_LAUNCHES
        by_cluster = dict(sk.LAUNCHES_BY_CLUSTER)
    finally:
        config.set_precision(False)
    check(launches >= 2 and n64 == (launches if f64 else 0) and
          by_cluster == {c: launches},
          f'8q ladder in {dtype}: {launches} launches, {n64} of them float64, '
          f'by blocks a restart {by_cluster}: not every launch of both stages '
          f'the {dtype} build on {c} blocks')
    hosts = sorted((d.cz_count, hst64(d.circuit.unitary(), ladder))
                   for d in results.decompositions)
    good = [h for h in hosts if h[1] <= 1e-6]
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    print(f'phase 19 (b): static 8q chain CX ladder in {dtype}, k='
          f'{LADDER8_K}, {samples} samples, {steps} steps: {len(hosts)} '
          f'verified, CZ counts {dict(Counter(h[0] for h in hosts))}, '
          f'{len(good)} at host loss <= 1e-6, best {good[:1]}; sweep '
          f'launches {launches} ({n64} float64) on {c} blocks a restart; '
          f'wall {wall:.3f} s ({stages})', flush=True)
    check(good and good[0][0] == 7, f'8q ladder in {dtype}: no 7-CZ '
          f'decomposition at host loss <= 1e-6: {hosts[:8]}')
    return launches


def phase_custom8(card):
    """Phase 19 (c): a custom loss at 8 qubits in float64, the 8q CX ladder's
    HS test as a torch callable, on the chain at k = LADDER8_K: the sweep
    (sweep() routes a custom loss to the Adam loop over the unitary
    kernels) from 8 restarts, against the plain float64 route (the same
    loop over the plain builder, plain=True) from the same angles, both
    over 60 steps (held to F64_LOSS0_TOL and F64_BEST_TOL) and over
    CUSTOM8_STEPS steps (best losses within CUSTOM8_TOL). Every launch of
    the unitary kernels must be the double build, the forward pass on the
    column tiles and the vjp on a cluster of 16 blocks, and the plain
    builder must not be called on the kernels' route. Returns the launches
    by kernel line (the forward pass's ansatz_forward_column_tiles_f64, the
    vjp's ansatz_vjp_f64)."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import Ansatz, RegularizationOptions
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.ops.penalty import make_regularization_function
    from cpflow_tpu_torch.sim.batched import make_batched_regloss
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    F64, n, B = torch.float64, 8, 8
    ladder = on_device(cx_ladder(8))
    hs = lambda u: 1 - torch.abs((ladder(u).conj() * u).sum()) ** 2 / 65536
    anz = Ansatz(n, 'cp', fill_layers(chain_layer(n), LADDER8_K))
    objs = [make_batched_regloss(
        n, 'cp', 'xyz', anz.placements, hs, cp_mask=anz.cp_mask,
        r=0.00055, regularization_func=make_regularization_function(
            RegularizationOptions), dtype=F64, plain=plain)
        for plain in (False, True)]
    check(sk.route(objs[0], 'cuda') == 'unitary', '8q custom loss: not '
          'routed to the unitary kernels')
    init = uniform_inits(anz.num_angles, B, 190, 'cuda').to(F64)
    out = {}
    with PlainBuilderWatch() as watch:
        uk.FORWARD_LAUNCHES = uk.VJP_LAUNCHES = sk.LAUNCHES = 0
        uk.FORWARD_F64_LAUNCHES = uk.VJP_F64_LAUNCHES = 0
        uk.VJP_LAUNCHES_BY_CLUSTER.clear()
        uk.LAUNCHES_BY_KERNEL.clear()
        start = time.perf_counter()
        for T in (60, CUSTOM8_STEPS):
            out[T] = sk.sweep(objs[0], init, 0.1, T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        counts = (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES,
                  uk.FORWARD_F64_LAUNCHES, uk.VJP_F64_LAUNCHES,
                  dict(uk.VJP_LAUNCHES_BY_CLUSTER),
                  dict(uk.LAUNCHES_BY_KERNEL), sk.LAUNCHES, watch.calls)
    fwd, vjp, f64f, f64v, by_cluster, by_kernel, fused, plain_calls = counts
    # the forward pass on the column tiles, the vjp on a cluster of 16
    lines = {'ansatz_forward_column_tiles_f64': fwd, 'ansatz_vjp_f64': vjp}
    check(fwd > CUSTOM8_STEPS and vjp >= CUSTOM8_STEPS and (f64f, f64v) ==
          (fwd, vjp) and by_cluster == {16: vjp} and by_kernel == {
              'ansatz_forward_column_tiles_f64': fwd,
              'ansatz_vjp_cluster_f64': vjp} and fused == 0 and
          plain_calls == 0,
          f'8q custom loss in float64: forward {fwd} ({f64f} float64), vjp '
          f'{vjp} ({f64v}; by blocks {by_cluster}), by kernel {by_kernel}, '
          f'fused {fused}, plain builder {plain_calls}')
    start = time.perf_counter()
    ref = {T: sk.sweep_reference(objs[1], init, 0.1, T)
           for T in (60, CUSTOM8_STEPS)}
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - start
    e0 = scaled_err(out[60].regloss0, ref[60].regloss0).max().item()
    e60 = scaled_err(out[60].best_loss, ref[60].best_loss).max().item()
    eT = scaled_err(out[CUSTOM8_STEPS].best_loss,
                    ref[CUSTOM8_STEPS].best_loss).max().item()
    best = out[CUSTOM8_STEPS].best_loss
    print(f'phase 19 (c): custom loss (8q CX ladder HS test, a torch '
          f'callable) in float64 on {card}, chain k={LADDER8_K} B={B}: '
          f'initial loss err {e0:.3e} (tol {F64_LOSS0_TOL}), best after 60 '
          f'steps err {e60:.3e} (tol {F64_BEST_TOL}), after {CUSTOM8_STEPS} '
          f'err {eT:.3e} (tol {CUSTOM8_TOL}); best losses '
          f'{np.round(np.sort(best.cpu().numpy()), 6).tolist()}; forward '
          f'launches {fwd} on the column tiles, vjp {vjp} on a cluster of 16 '
          f'blocks, all float64; wall '
          f'{wall:.3f} s, plain route {plain_wall:.3f} s', flush=True)
    check(e0 <= F64_LOSS0_TOL and e60 <= F64_BEST_TOL and eT <= CUSTOM8_TOL
          and bool(torch.isfinite(best).all()),
          f'8q custom loss in float64 against the plain route: {e0:.3e}, '
          f'{e60:.3e}, {eT:.3e}')
    return lines


def ghz_host_loss(d):
    """The float64 host state loss of Decomposition d's circuit against
    GHZ-n normalized in float64, from the circuit's state (Circuit.state),
    beside the package's own d.loss (whose target is the float32 one)."""
    import numpy as np
    psi = d.circuit.state()
    t64 = ghz(d.circuit.num_qubits).astype(np.complex128)
    t64 = t64 / np.linalg.norm(t64)
    return float(1 - abs(np.vdot(t64, psi)) ** 2)


def phase_ghz_search(k=None, samples=None, steps=None, n=13,
                     label='phase 19 (d)'):
    """Phase 19 (d), the search: Synthesize.static for GHZ-n (13 by
    default) in float32 on the n-qubit chain at k blocks (default
    GHZ13_K), `samples` random restarts (GHZ13_SAMPLES) of `steps` sampling
    steps (GHZ13_STEPS), accepting n - 1 CZ (the fewest on the chain).
    Needs the kernel on the blocks its plan gives a restart; what it finds
    is printed, not required: random restarts at 13 qubits stall at a
    product state (loss 0.5), in the JAX package too
    (tests/test_torch_sixteen.py), and phase_ghz_warm holds the
    (n - 1)-CZ state. Returns the launches."""
    import torch
    from cpflow_tpu_torch.api import StaticOptions, Synthesize
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
    from cpflow_tpu_torch.topology import chain_layer
    k, samples = k or GHZ13_K, samples or GHZ13_SAMPLES
    steps = steps or GHZ13_STEPS
    c = sk.cluster_plan(n, k, num_block_angles('cp', 'xyz'), 'state')
    synth = Synthesize(chain_layer(n), target_state=ghz(n))
    options = StaticOptions(num_cp_gates=k, num_samples=samples,
                            num_gd_iterations=steps, r=0.001,
                            accepted_num_cz_gates=n - 1)
    sk.LAUNCHES = 0
    sk.LAUNCHES_BY_CLUSTER.clear()
    sk.LAUNCHES_BY_BUILD.clear()
    start = time.perf_counter()
    results = synth.static(options, save_results=False, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches, by_cluster = sk.LAUNCHES, dict(sk.LAUNCHES_BY_CLUSTER)
    build = sk.build_of(n, k, num_block_angles('cp', 'xyz'), 'state')
    check(dict(sk.LAUNCHES_BY_BUILD) == {build: launches},
          f'{label}: launches by build {dict(sk.LAUNCHES_BY_BUILD)}, not all '
          f'{launches} on {build}')
    found = sorted((d.cz_count, d.loss) for d in results.decompositions)
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    print(f'{label}: GHZ-{n} search, Synthesize.static on the {n}q chain '
          f'in float32, k={k}, {samples} samples, {steps} steps: '
          f'{len(found)} verified, (CZ, loss) {found[:4]}; sweep launches '
          f'{launches} by blocks a restart {by_cluster}; wall {wall:.3f} s '
          f'({stages})', flush=True)
    check(launches >= 1 and by_cluster == {c: launches},
          f'GHZ-{n} search: {launches} launches, by blocks a restart '
          f'{by_cluster}, not all on {c}')
    return launches


@functools.lru_cache(maxsize=2)
def ghz_program(n):
    """(placements, exact angles) of the n-qubit GHZ preparation on the
    chain, H on qubit 0 then CX(0,1), ..., CX(n-2,n-1), each CX as H CZ H:
    n - 1 CZ, embedded exactly in the CP ansatz by the port's
    circuits.to_ansatz.circuit_to_ansatz."""
    from cpflow_tpu_torch.circuits.ir import Circuit
    from cpflow_tpu_torch.circuits.to_ansatz import circuit_to_ansatz
    qc = Circuit(n)
    qc.h(0)
    for q in range(n - 1):
        qc.h(q + 1)
        qc.cz(q, q + 1)
        qc.h(q + 1)
    placements, angles = circuit_to_ansatz(qc)
    return [list(p) for p in placements], angles


def phase_ghz_warm(B=64, T=500, n=13, dtype=None, penalty=None,
                   label='phase 19 (d)', passes=None):
    """Phase 19 (d), Synthesize.static from a warm start: GHZ-n (13 by
    default) on the n-qubit chain at k = n - 1, whose template is the
    (n - 1)-CZ ladder's (ghz_program's placements, embedded exactly), in
    `dtype` (default float32; float64 under config.set_precision(True),
    float32 restored in `finally`). Static's initial angles
    (initial_angles_array) are the noisy rows of a warm batch of B
    (build_warm_batch, seed 0: not the exact row, not the random ones)
    whose float64 host state loss starts above the entry loss; T sampling
    steps at r = 1e-4 and learning rate 0.01, then static's filter, its
    verification (at most 2000 steps) and its Decompositions, checked and
    scored on the circuit's state. With `penalty` (a torch callable of the
    CP angles, such as cp_penalty_L1) sampling runs through the unitary
    kernels (one column), never the plain builder, and verification (no
    penalty) through the sweep. A state that no plan of the fused kernel
    holds (past 17 qubits, 16 in float64) runs sampling and verification
    through the unitary kernels (sweep's route), the plain builder never
    called and no sweep launched; there, where the host's Circuit.state
    takes seconds a row, the rows' starting losses come from the plain
    builder on the card in float64, before anything is counted. Needs an
    (n - 1)-CZ decomposition at host loss <= 1e-6 (the package's and
    ghz_host_loss, of the best three by CZ and package loss, the best one
    on the unitary kernels' route), every sweep launch on the blocks the
    plan gives a restart, of the build its plan names (a state on more than
    one block: the row tiles'), and every unitary launch the kernel its
    plan names; on the global row tiles, every vjp call one sum. Returns
    the wrapper calls, by kernel line name (sweep, sweep_row_tiles,
    ansatz_vjp_row_tiles_f64, ansatz_vjp_global_rows, ...); a dict given as
    `passes` takes the global row tiles' kernel launches (uk.GLOBAL_PASSES:
    a pass each, the vjp's sum once a call)."""
    import numpy as np
    import torch
    from cpflow_tpu_torch import config
    from cpflow_tpu_torch.api import (Ansatz, BasicOptions, LossSpec,
                                      StaticOptions, Synthesize)
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    dtype = dtype or torch.float32
    f64 = dtype == torch.float64
    suffix = '_f64' if f64 else ''
    target = ghz(n)
    placements, exact = ghz_program(n)
    anz = Ansatz(n, 'cp', fill_layers(chain_layer(n), n - 1), 'xyz')
    check([list(p) for p in all_placements(anz.placements)] == placements,
          f'GHZ-{n}: the chain template at k = {n - 1} is not the ladder\'s')
    nba = num_block_angles('cp', 'xyz')
    c = sk.cluster_plan(n, n - 1, nba, 'state', dtype)
    fused = c is not None  # else the unitary kernels run the sweeps
    build = ('sweep_row_tiles' if fused and c > 1 else 'sweep_block') + \
        suffix
    plans = {vjp: uk.plan(n, n - 1, nba, 0, vjp, dtype)
             for vjp in (False, True)}
    kernels = {vjp: uk.kernel_name(p['design'], vjp, n,
                                   p['blocks_per_restart'], True) + suffix
               for vjp, p in plans.items()}
    warm, sigma = build_warm_batch(exact.astype(np.float32),
                                   np.asarray(anz.cp_mask, dtype=np.float64),
                                   B, 0)
    spec, entry = LossSpec('state', target=target), BasicOptions.entry_loss
    if not fused:
        from cpflow_tpu_torch.sim.batched import build_unitary_batched
        col = build_unitary_batched(
            n, 'cp', 'xyz', anz.placements,
            torch.tensor(warm.T, dtype=torch.float64, device='cuda'),
            columns=[0], dtype=torch.float64).reshape(2 ** n, B)
        t64 = torch.tensor(target.astype(np.complex128) /
                           np.linalg.norm(target.astype(np.complex128)),
                           device='cuda')
        loss0 = (1 - (t64.conj() @ col).abs() ** 2).cpu().numpy()
        del col
    else:
        loss0 = np.array([spec.numpy(anz.circuit(list(a.astype(float)))
                                     .state()[:, None]) for a in warm])
    rows = np.nonzero((sigma > 0) & (loss0 > entry))[0]
    check(len(rows) > 0, f'GHZ-{n}: no noisy row starts above entry {entry}')
    config.set_precision(f64)
    try:
        synth = Synthesize(chain_layer(n), target_state=target,
                           **({'cp_regularization_func': penalty}
                              if penalty else {}))
        options = StaticOptions(num_cp_gates=n - 1, num_samples=len(rows),
                                num_gd_iterations=T, learning_rate=0.01,
                                r=1e-4, num_gd_iterations_at_verification=2000,
                                accepted_num_cz_gates=n - 1)
        with PlainBuilderWatch() as watch:
            sk.LAUNCHES = 0
            sk.LAUNCHES_BY_CLUSTER.clear()
            sk.LAUNCHES_BY_BUILD.clear()
            uk.FORWARD_LAUNCHES = uk.VJP_LAUNCHES = 0
            uk.LAUNCHES_BY_KERNEL.clear()
            uk.GLOBAL_PASSES.clear()
            start = time.perf_counter()
            results = synth.static(options, save_results=False,
                                   verbose=False,
                                   initial_angles_array=warm[rows])
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            launches, by_cluster = sk.LAUNCHES, dict(sk.LAUNCHES_BY_CLUSTER)
            by_build, by_kernel = (dict(sk.LAUNCHES_BY_BUILD),
                                   dict(uk.LAUNCHES_BY_KERNEL))
            unitary = (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES)
            by_pass = dict(uk.GLOBAL_PASSES)
    finally:
        config.set_precision(False)
    best = sorted(results.decompositions,
                  key=lambda d: (d.cz_count, d.loss))[:3 if fused else 1]
    hosts = [(d.cz_count, d.loss, ghz_host_loss(d)) for d in best]
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    how = f' with {penalty.__name__} (sampling through the unitary ' \
        f'kernels, {unitary[0]} forward and {unitary[1]} vjp launches ' \
        f'{by_kernel})' if penalty else ''
    if not fused:
        how = f' (sampling and verification through the unitary kernels, ' \
            f'{unitary[0]} forward and {unitary[1]} vjp launches ' \
            f'{by_kernel}, {by_pass} kernel launches, plain ' \
            f'builder {watch.calls})'
    print(f'{label}: GHZ-{n}, Synthesize.static from a warm start on the '
          f'{n}q chain in {str(dtype)[6:]}{how}, k={n - 1}: {len(rows)} noisy '
          f'rows of {B} starting above entry {entry} (host losses '
          f'{loss0[rows].min():.3g}-{loss0[rows].max():.3g}), {T} steps at '
          f'lr 0.01: {len(results.decompositions)} verified, (CZ, loss, '
          f'float64 host loss) {hosts}; sweep launches {launches} by blocks '
          f'a restart {by_cluster}, by build {by_build}; wall {wall:.3f} s '
          f'({stages})', flush=True)
    if fused:
        check(launches >= (1 if penalty else 2) and
              by_cluster == {c: launches} and by_build == {build: launches},
              f'GHZ-{n}: {launches} launches, by blocks a restart '
              f'{by_cluster}, by build {by_build}, not all {build} on {c}')
    else:
        check(launches == 0 and watch.calls == 0 and unitary[0] > T and
              unitary[1] >= T and
              by_kernel == {kernels[False]: unitary[0],
                            kernels[True]: unitary[1]},
              f'GHZ-{n}: sweep launches {launches}, plain builder '
              f'{watch.calls}, forward {unitary[0]}, vjp {unitary[1]} by '
              f'kernel {by_kernel}, not all {kernels}')
        if kernels[True].startswith('ansatz_vjp_global_rows'):
            check(by_pass.get(kernels[True].replace('global_rows',
                                                    'global_sum')) ==
                  unitary[1] and all(by_pass.get(kernels[v], 0) >= unitary[v]
                                     for v in (False, True)) and
                  by_pass.get(kernels[True].replace('vjp_global_rows',
                                                    'global_gates')) ==
                  unitary[0] + unitary[1],
                  f'GHZ-{n}: kernel launches {by_pass}, not a pass or more '
                  f'a call, one sum a vjp call and one prologue a call')
    if passes is not None:
        passes.update(by_pass)
    if penalty:
        check(watch.calls == 0 and unitary[0] > T and unitary[1] >= T and
              by_kernel == {kernels[False]: unitary[0],
                            kernels[True]: unitary[1]},
              f'GHZ-{n} with {penalty.__name__}: plain builder {watch.calls}, '
              f'forward {unitary[0]}, vjp {unitary[1]} by kernel {by_kernel}, '
              f'not all {kernels}')
    check(hosts and hosts[0][0] == n - 1 and max(hosts[0][1:]) <= 1e-6,
          f'GHZ-{n}: no {n - 1}-CZ decomposition at host loss <= 1e-6 from '
          f'noisy rows that started above entry: {hosts[:4]}')
    out = {build: launches} if fused else {}
    if penalty or not fused:
        out.update({kernels[False]: unitary[0], kernels[True]: unitary[1]})
    return out


def phase_sixteen(card):
    """Phase 19: the shapes that clusters of 16 blocks and a 13-qubit state
    open. (a) the sweep kernel at sixteen_shapes and the unitary kernels at
    SIXTEEN_UNITARY against their plain versions; (b) the static 8q CX
    ladder in float64 (phase_ladder8); (c) a custom loss at 8 qubits in
    float64 (phase_custom8); (d) GHZ-13 in float32 through
    Synthesize.static, from random restarts (phase_ghz_search) and from
    a warm start (phase_ghz_warm). Returns (largest errors by kernel
    line name, timing rows by kernel line name, sweep launches by path and
    dtype, unitary launches by path)."""
    start = time.perf_counter()
    worst32, worst64, rows32, rows64 = phase_sixteen_sweeps(card)
    errs, rows = phase_sixteen_unitary(card)
    phase_split_vjp_bits([s for s in SIXTEEN_UNITARY if s[0] <= 8],
                         'phase 19 (a)')
    for row in rows32 + rows64:  # by the build each row ran
        errs[row['build']] = max(errs.get(row['build'], 0.0),
                                 row['max_abs_err'])
        rows.setdefault(row['build'], []).append(row)
    launches = {'sweep_block': {}, CLUSTER_F64: {}}
    launches[CLUSTER_F64]['static_ladder8_f64'] = phase_ladder8()
    launches['sweep_block']['ghz13_search'] = phase_ghz_search()
    launches['sweep_block']['ghz13_warm'] = phase_ghz_warm()['sweep_block']
    unitary_launches = {'custom_ladder8_f64': phase_custom8(card)}
    print(f'phase 19: {time.perf_counter() - start:.1f} s', flush=True)
    return errs, rows, launches, unitary_launches


def split_shapes():
    """Phase 20 (a)'s sweep rows, as phase 3's shapes: GHZ states on the
    chain at k = 2n, each on the blocks its plan splits its one column over
    by rows: (L) 14q B=64 on 2, (M) 15q B=32 on 4, (N) 16q B=16 on 8 and
    (O) 17q B=16 on 16 in float32; (P) 13q B=32 on 2 and (Q) 16q B=8 on 16
    in float64; 60 steps at 14 and 15 qubits (13 in float64), 30 above."""
    import torch
    out = []
    for tag, n, B, c, dtype in [('L', 14, 64, 2, None), ('M', 15, 32, 4, None),
                                ('N', 16, 16, 8, None),
                                ('O', 17, 16, 16, None),
                                ('P', 13, 32, 2, torch.float64),
                                ('Q', 16, 8, 16, torch.float64)]:
        out.append(dict(
            name=f'({tag}) state {n}q GHZ k={2 * n} B={B}' +
            (' float64' if dtype else ''), n=n, k=2 * n, target=ghz(n),
            kind='state', B=B, r=0.001, lr=0.1, T=60 if n < 16 else 30,
            cluster=c, **({'dtype': dtype} if dtype else {})))
    return out


def split_edge_shapes():
    """Phase 20 (a)'s rows at the edges of the row tiles' design (rows.cuh),
    as split_shapes' with the plan they must run on (cluster, and the
    segment: log2 of a warp's rows, and where it is the edge, the ring of
    cotangent slots). (Q1) and (Q2): the shortest segments of 16 warps in
    float32, a 12q state on 2 blocks at k = 424 (segments of 128 rows, a
    ring of one gate) and a 13q one at k = 215 (256 rows); (Q3) and (Q4)
    the same in float64, 11q at k = 208 (a ring of one gate) and 12q at
    k = 100; (Q5) and (Q6) 9q states on 16 blocks of 32 rows, one warp each,
    whose lanes outnumber a two-qubit gate's 8 groups (the lanes past them
    idle), in float32 at k = 505 and float64 at k = 248; (Q7) a 16q state on
    8 blocks, its layer a burst of six blocks on the three split qubits back
    to back (both orders of each pair) before the chain; (Q8)-(Q10) the 14q GHZ chain at k = 28 with 'xz', and with the CZ and
    CX entanglers. The deep float32 rows take a rate of 1e-4, as phase 21's
    deepest rows do: over thousands of angles float32 drifts in the flat
    directions at 0.1 (PERF.md, Findings)."""
    import torch
    F64 = torch.float64
    burst = [[0, 1], [1, 2], [0, 2], [2, 1], [1, 0], [2, 0]]
    split3 = burst + [[q, q + 1] for q in range(15)]
    rows = [
        ('Q1', 12, 424, 4, None, 7, 1e-4, dict(ring=1)),
        ('Q2', 13, 215, 8, None, 8, 1e-4, {}),
        ('Q3', 11, 208, 4, F64, 7, 0.1, dict(ring=1)),
        ('Q4', 12, 100, 8, F64, 8, 0.1, {}),
        ('Q5', 9, 505, 4, None, 5, 1e-4, {}),
        ('Q6', 9, 248, 4, F64, 5, 0.1, {}),
        ('Q7', 16, 30, 16, None, 9, 0.1, dict(layer=split3)),
        ('Q8', 14, 28, 16, None, 9, 0.1, dict(rot='xz')),
        ('Q9', 14, 28, 16, None, 9, 0.1, dict(ent='cz')),
        ('Q10', 14, 28, 16, None, 9, 0.1, dict(ent='cx'))]
    out = []
    for tag, n, k, B, dtype, seg, lr, extra in rows:
        c = {12: 2, 13: 2, 11: 2, 9: 16, 16: 8, 14: 2}[n]
        what = (" 'xz'" if extra.get('rot') else
                f" {extra['ent']!r}" if 'ent' in extra else
                ', split qubits back to back' if 'layer' in extra else '')
        T = 10 if k > 200 else 30
        out.append(dict(
            name=f'({tag}) state {n}q GHZ{what} k={k} B={B} T={T}' +
            (' float64' if dtype else ''), n=n, k=k, target=ghz(n),
            kind='state', B=B, r=0.001, lr=lr, T=T, cluster=c, segment=seg,
            **extra, **({'dtype': dtype} if dtype else {})))
    return out


# phase 20 (a)'s unitary rows, as SIXTEEN_UNITARY's: one column of a GHZ
# chain template at k = 2n, the vjp on the blocks named (the forward pass,
# which holds no M, on half as many)
SPLIT_UNITARY = [(14, 28, 'xyz', 8, 'float32', (False, True), [0], 2),
                 (15, 30, 'xyz', 8, 'float32', (False, True), [0], 4),
                 (16, 32, 'xyz', 4, 'float32', (False, True), [0], 8),
                 (17, 34, 'xyz', 4, 'float32', (False, True), [0], 16),
                 (13, 26, 'xyz', 4, 'float64', (False, True), [0], 2),
                 (16, 32, 'xyz', 2, 'float64', (False, True), [0], 16)]
# the vjp at the row tiles' edges (rows.cuh): 16 warps of 128 rows and a
# ring of two gates (12q k=511), one warp of 32 rows on each of 16 blocks
# (9q k=621), in float64 a ring of one gate (11q k=257) and 16 blocks of 32
# rows (9q k=305); the vjp alone, the forward pass giving its U
SPLIT_EDGE_UNITARY = [(12, 511, 'xyz', 2, 'float32', (True,), [0], 2),
                      (9, 621, 'xyz', 2, 'float32', (True,), [0], 16),
                      (11, 257, 'xyz', 2, 'float64', (True,), [0], 2),
                      (9, 305, 'xyz', 2, 'float64', (True,), [0], 16)]
# the kernel lines of the row tiles' builds
ROW_TILE_LINES = ('sweep_row_tiles', 'ansatz_forward_row_tiles',
                  'ansatz_vjp_row_tiles')
GHZ14_SEARCH = dict(k=15, samples=256, steps=1000)


def phase_split(card):
    """Phase 20: states past one block, a state's one column split by rows
    over a cluster of 2 to 16 blocks (the row tiles' builds). (a) the sweep
    kernel at split_shapes and the unitary kernels at SPLIT_UNITARY against
    their plain versions, each with its plan and the clusters the card
    holds; (b) GHZ-14 and GHZ-17 in float32 and GHZ-16 in float64 through
    Synthesize.static from a warm start (phase_ghz_warm), each to n - 1
    CZ; (c) GHZ-15 in float32 and GHZ-14 in float64 the same way with
    cp_penalty_L1, whose sampling runs through the unitary kernels' row
    tiles; (d) a random-restart GHZ-14 search, printed (ROADMAP A.19); then
    18-qubit states in float32 and 17-qubit ones in float64, the whole
    unitary one qubit past its limit and a modulo loss past the unitary
    kernels' limit, refused. Returns (largest errors by kernel line name,
    timing rows by kernel line name, launches by kernel line name and
    path)."""
    import torch
    from cpflow_tpu_torch.ops.penalty import cp_penalty_L1
    start = time.perf_counter()
    shapes, edges = split_shapes(), split_edge_shapes()
    worst32, worst64, rows32, rows64 = phase_sixteen_sweeps(
        card, shapes, 'phase 20 (a)')
    e32, e64, edge32, edge64 = phase_sixteen_sweeps(card, edges,
                                                    'phase 20 (a)')
    phase_nine_bits(shapes + edges, 'phase 20 (a)')
    errs, rows = phase_sixteen_unitary(card, SPLIT_UNITARY, 'phase 20 (a)')
    edge_errs, edge_rows = phase_sixteen_unitary(card, SPLIT_EDGE_UNITARY,
                                                 'phase 20 (a)')
    phase_split_vjp_bits(SPLIT_UNITARY + SPLIT_EDGE_UNITARY)
    for line, err in edge_errs.items():
        errs[line] = max(errs.get(line, 0.0), err)
    for line, got in edge_rows.items():  # a line's numbers: its last row
        rows[line] = got + rows.get(line, [])
    errs.update(sweep_row_tiles=max(worst32, e32),
                sweep_row_tiles_f64=max(worst64, e64))
    rows.update(sweep_row_tiles=edge32 + rows32,
                sweep_row_tiles_f64=edge64 + rows64)
    launches = {}
    for path, (n, dtype, penalty) in {
            'ghz14_warm': (14, None, None), 'ghz17_warm': (17, None, None),
            'ghz16_warm_f64': (16, torch.float64, None),
            'ghz15_l1_warm': (15, None, cp_penalty_L1),
            'ghz14_l1_warm_f64': (14, torch.float64, cp_penalty_L1)}.items():
        for line, count in phase_ghz_warm(
                B=32, T=300 if penalty else 500, n=n, dtype=dtype,
                penalty=penalty, label=f'phase 20 ({"c" if penalty else "b"})'
        ).items():
            launches.setdefault(line, {})[path] = count
    launches['sweep_row_tiles']['ghz14_search'] = phase_ghz_search(
        n=14, label='phase 20 (d)', **GHZ14_SEARCH)
    refuse_beyond_plans()
    print(f'phase 20: {time.perf_counter() - start:.1f} s', flush=True)
    return errs, rows, launches


def phase_split_vjp_bits(shapes, label='phase 20 (a)'):
    """Phase 20 (a) (and 19 (a), 21 (b)): two launches of the forward pass,
    and two of the vjp where a row drives it, on the same inputs give the
    same bits at every row of `shapes` (SPLIT_UNITARY's, SIXTEEN_UNITARY's
    or NINE_UNITARY's tuples): the row tiles sum each warp's share of a
    gate's cotangent in warp order and the blocks' in rank order, the vjp on
    a cluster its warps' in warp order and its blocks' in rank order, the
    column tiles the tiles' shares in tile order."""
    import torch
    from cpflow_tpu_torch.api import Ansatz
    from cpflow_tpu_torch.kernels import unitary as uk
    gen = torch.Generator(device='cuda').manual_seed(20)
    for n, k, rot, B, dname, passes, cols, _, *layer in shapes:
        dtype = getattr(torch, dname)
        anz = Ansatz(n, 'cp', shape_layers(n, k, layer), rot)
        angles = uniform_inits(anz.num_angles, B, 20, 'cuda').to(dtype)
        u, u2 = (uk.ansatz_forward(n, 'cp', rot, anz.placements, angles,
                                   cols) for _ in range(2))
        check(torch.equal(u, u2), f'{n}q k={k} {dname}: two forward '
              f'launches on the same inputs differ')
        del u2
        if True not in passes:  # a row of the forward pass alone
            continue
        g = torch.randn(u.shape, dtype=u.dtype, device='cuda', generator=gen)
        a, b = (uk.ansatz_vjp(n, 'cp', rot, anz.placements, angles, u, g,
                              cols) for _ in range(2))
        check(torch.equal(a, b), f'{n}q k={k} {dname}: two vjp launches on '
              f'the same inputs differ')
    print(f'{label}: two forward and two vjp launches on the same inputs '
          f'gave the same bits at all {len(shapes)} rows', flush=True)


def refuse_beyond_plans():
    """Phase 20's refusals: a state one qubit past the unitary kernels' cap
    (25 qubits in float32, 24 in float64; kernels/unitary.py's
    GLOBAL_MAX_QUBITS) by the sweep and by the unitary kernels, each with
    its reason, and a column whose U the card cannot hold (24 qubits, 1024
    restarts: 128 GiB), refused before it is allocated, no kernel launched;
    then the whole unitary's (refuse_whole_beyond: one qubit past the
    column tiles' limit, a modulo loss at 14)."""
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    from cpflow_tpu_torch.sim.ansatz_kernel import all_placements
    F64 = torch.float64
    before = (sk.LAUNCHES, uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES)
    # what a 24q forward call of 1024 restarts allocates: U and the
    # workspace of its plan (the gates, their cos and sin), float32
    pairs = tuple(map(tuple, all_placements(fill_layers(chain_layer(24), 2))))
    needs = 1024 * ((8 << 24) + 4 * uk.global_work(
        24, 2, 7, False, torch.float32,
        uk.global_per_sm(24, pairs, 7, False, torch.float32)))
    refusals = [
        ('25q state, sweep', 'one column to 24 qubits, and past that cap',
         lambda: sk.sweep(
             make_objective(25, 2, ghz(25), 0.0, kind='state')[0],
             uniform_inits(3 * 25 + 14, 2, 0, 'cuda'), 0.1, 1)),
        ('24q state in float64, sweep',
         'one column to 23 qubits, and past that cap', lambda: sk.sweep(
             make_objective(24, 2, ghz(24), 0.0, kind='state', dtype=F64)[0],
             uniform_inits(3 * 24 + 14, 2, 0, 'cuda').to(F64), 0.1, 1)),
        ('25q column, unitary kernels', '2 to 24 qubits for one column',
         lambda: uk.build_unitary(25, 'cp', 'xyz',
                                  fill_layers(chain_layer(25), 2),
                                  uniform_inits(3 * 25 + 14, 2, 0, 'cuda'),
                                  columns=[0])),
        ('24q column in float64, unitary kernels',
         '2 to 23 qubits for one column',
         lambda: uk.build_unitary(24, 'cp', 'xyz',
                                  fill_layers(chain_layer(24), 2),
                                  uniform_inits(3 * 24 + 14, 2, 0, 'cuda'),
                                  columns=[0], dtype=F64)),
        ('24q column of 1024 restarts, unitary kernels',
         f'need {needs} bytes of device memory for U and its workspace of '
         f'1024 restarts',
         lambda: uk.ansatz_forward(24, 'cp', 'xyz',
                                   fill_layers(chain_layer(24), 2),
                                   uniform_inits(3 * 24 + 14, 1024, 0,
                                                 'cuda'), columns=[0]))]
    for name, want, call in refusals:
        try:
            call()
        except ValueError as e:
            check(want in str(e), f'{name}: refused for {e}')
            print(f'phase 20: {name} refused: {e}', flush=True)
        else:
            raise PhaseError(f'{name} did not raise')
    check((sk.LAUNCHES, uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES) == before,
          'a refused shape launched a kernel')
    refuse_whole_beyond('phase 20')


# ------------------------------------------------------------ phase 21

def nine_shapes():
    """Phase 21 (a)'s sweep rows, as phase 3's shapes: the whole unitary past
    what a cluster of 16 blocks holds, each on the column tiles (`cluster`:
    the tiles a restart, each on a block of its own): (R) 9q chain
    Toffoli-9 k=10 B=8 and (S) the same in float64, 60 steps; (T) the disc
    loss at 10q, k=12 B=4, 30 steps; (U) 11q k=12 B=2, 10 steps; and the
    limits, (V) 12q in float64 and (W) 13q in float32, k=2 B=1, 4 steps
    (one column a tile); then what the other routes take, on the tiles:
    (X) a bucketed 9q sweep, k<=10, B = 2 x 4 with r and a template mask
    per trial, (Y) fixed 'cz' blocks with 'xz' and (Z) fixed 'cx' blocks
    with 'y' on the 9q chain for its CX ladder, k=8 B=8, each 30 steps;
    and the deepest templates below 7 qubits, past 16 blocks, 20 steps,
    where a gate has fewer amplitude groups than a column has lanes
    (tiles.cuh): (Z3) 6q k=243 and (Z4) 5q k=251 in float64, B=2, and
    (Z1) 6q k=500 and (Z2) 5q k=508 in float32, B=16, on 32 tiles of 2 or
    1 columns. At these depths (some 1500 angles) 20 steps of Adam at a
    rate of 0.1 carry float32 rounding in the flat directions to about
    1e-3 in the plain route as in the kernel, so that no rule of phase 3
    tells them apart (PERF.md, PR 16); the float32 rows take a rate of
    1e-4, where each step moves every angle by about the rate in the
    direction of its gradient's sign and the loss stays in its linear
    range: they hold the float32 gradient's signs and sizes, the float64
    rows the whole sweep.
    The float32 rows are arbiter shapes (phase 3's
    rule, as_close_as_plain where drift_ok misses): the loss sums 2^2n
    entries, and after 60 steps at 9 qubits plain float32's median distance
    from plain float64 is most of drift_ok's 1e-5 (7.6e-6 on (R), the
    kernel's 2.4e-6; measured on one H100), so two float32 routes can be 1.8e-5
    apart while each meets drift_ok against float64. Each row is timed as
    the fastest of NINE_CALLS calls after a warm-up call (best_of)."""
    import torch
    from cpflow_tpu_torch.ops.gates import multi_controlled_x
    F64 = torch.float64
    rows = [
        dict(name='(R) 9q chain Toffoli-9 k=10 B=8', n=9, k=10,
             target=multi_controlled_x(9), B=8, r=0.002, lr=0.1, cluster=32,
             arbiter=True),
        dict(name='(S) 9q chain Toffoli-9 k=10 B=8 float64', n=9, k=10,
             target=multi_controlled_x(9), B=8, r=0.002, lr=0.1, cluster=64,
             dtype=F64),
        dict(name='(T) disc 10q chain Toffoli-10 k=12 B=4', n=10, k=12,
             target=multi_controlled_x(10), kind='disc', B=4, r=0.002,
             lr=0.1, T=30, cluster=128, arbiter=True),
        dict(name='(U) 11q chain Toffoli-11 k=12 B=2', n=11, k=12,
             target=multi_controlled_x(11), B=2, r=0.002, lr=0.1, T=10,
             cluster=512, arbiter=True),
        dict(name='(V) 12q chain Toffoli-12 k=2 B=1 float64', n=12, k=2,
             target=multi_controlled_x(12), B=1, r=0.002, lr=0.1, T=4,
             cluster=4096, dtype=F64),
        dict(name='(W) 13q chain Toffoli-13 k=2 B=1', n=13, k=2,
             target=multi_controlled_x(13), B=1, r=0.002, lr=0.1, T=4,
             cluster=8192, arbiter=True),
        dict(name='(X) bucketed 9q chain Toffoli-9 k<=10 B=2x4, r and mask '
             'per trial', n=9, target=multi_controlled_x(9), ks=(5, 10),
             rs=(0.00055, 0.002), S=4, B=8, lr=0.1, T=30, seed=2100,
             cluster=32, arbiter=True),
        dict(name="(Y) 'cz' blocks 'xz' 9q chain CX ladder k=8 B=8", n=9,
             k=8, target=cx_ladder(9), ent='cz', rot='xz', B=8, r=0.0,
             lr=0.1, T=30, cluster=32, arbiter=True),
        dict(name="(Z) 'cx' blocks 'y' 9q chain CX ladder k=8 B=8", n=9, k=8,
             target=cx_ladder(9), ent='cx', rot='y', B=8, r=0.0, lr=0.1,
             T=30, cluster=32, arbiter=True),
        dict(name='(Z1) 6q chain Toffoli-6 k=500 B=16 lr=1e-4', n=6, k=500,
             target=multi_controlled_x(6), B=16, r=0.002, lr=1e-4, T=20,
             cluster=32, arbiter=True),
        dict(name='(Z2) 5q chain Toffoli-5 k=508 B=16 lr=1e-4', n=5, k=508,
             target=multi_controlled_x(5), B=16, r=0.002, lr=1e-4, T=20,
             cluster=32, arbiter=True),
        dict(name='(Z3) 6q chain Toffoli-6 k=243 B=2 float64', n=6, k=243,
             target=multi_controlled_x(6), B=2, r=0.002, lr=0.1, T=20,
             cluster=32, dtype=F64),
        dict(name='(Z4) 5q chain Toffoli-5 k=251 B=2 float64', n=5, k=251,
             target=multi_controlled_x(5), B=2, r=0.002, lr=0.1, T=20,
             cluster=32, dtype=F64),
    ]
    return [dict(row, calls=NINE_CALLS) for row in rows]


# phase 21 (b)'s unitary rows, as SIXTEEN_UNITARY's: the vjp on the column
# tiles (the last field: its tiles a restart); the forward pass, which holds
# no M, on tiles twice as wide
NINE_UNITARY = [(9, 10, 'xyz', 4, 'float32', (False, True), None, 32),
                (9, 10, 'xyz', 4, 'float64', (False, True), None, 64),
                (10, 12, 'xyz', 2, 'float32', (False, True), None, 128),
                (10, 12, 'xyz', 2, 'float64', (False, True), None, 256),
                (11, 12, 'xyz', 1, 'float32', (False, True), None, 512),
                (11, 12, 'xyz', 1, 'float64', (False, True), None, 1024),
                (12, 2, 'xyz', 1, 'float64', (False, True), None, 4096),
                (13, 2, 'xyz', 1, 'float32', (False, True), None, 8192)]
# the kernel lines of the column tiles' builds
COLUMN_TILE_LINES = ('sweep_column_tiles', 'ansatz_forward_column_tiles',
                     'ansatz_vjp_column_tiles')
LADDER9_K, LADDER9_SAMPLES, LADDER9_STEPS = 10, 32, 2000
NINE_CALLS = 3  # timed calls of each phase 21 (a) row, after a warm-up
CUSTOM9_STEPS = 300


def phase_nine_bits(shapes, label='phase 21 (a)'):
    """Phase 21 (a) (and 20 (a)): two launches of the sweep on the same
    inputs give the same bits at every row of `shapes` (T = 10): the
    tiles' shares are summed in tile order, whatever order the blocks ran
    in."""
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    for s in shapes:
        dtype = s.get('dtype', torch.float32)
        obj, P = shape_objective(s, dtype)
        init = uniform_inits(P, s['B'], 21, 'cuda').to(dtype)
        a, b = (sk.sweep(obj, init, s['lr'], min(s.get('T', 60), 10))
                for _ in range(2))
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f'{s["name"]}: two launches on the same inputs differ')
    print(f'{label}: two launches on the same inputs gave the same bits '
          f'at all {len(shapes)} rows', flush=True)


def phase_ladder9():
    """Phase 21 (c): Synthesize.static at 9 qubits on the chain for the CX
    ladder (CX(0,1), then CX(1,2), ..., CX(7,8)), which needs 8 CZ, in
    float32 from random restarts: k = LADDER9_K, LADDER9_SAMPLES samples of
    LADDER9_STEPS steps, accepting 8 CZ. Needs every sweep launch of both
    stages on the column tiles and a verified 8-CZ decomposition at float64
    host loss <= 1e-6. Returns the launches."""
    import torch
    from cpflow_tpu_torch.api import StaticOptions, Synthesize
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.topology import chain_layer
    ladder = cx_ladder(9)
    synth = Synthesize(chain_layer(9), target_unitary=ladder)
    options = StaticOptions(num_cp_gates=LADDER9_K,
                            num_samples=LADDER9_SAMPLES,
                            num_gd_iterations=LADDER9_STEPS,
                            accepted_num_cz_gates=8)
    sk.LAUNCHES = 0
    sk.LAUNCHES_BY_CLUSTER.clear()
    sk.LAUNCHES_BY_BUILD.clear()
    start = time.perf_counter()
    results = synth.static(options, save_results=False, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = sk.LAUNCHES
    by = (dict(sk.LAUNCHES_BY_CLUSTER), dict(sk.LAUNCHES_BY_BUILD))
    hosts = sorted((d.cz_count, hst64(d.circuit.unitary(), ladder))
                   for d in results.decompositions)
    good = [h for h in hosts if h[1] <= 1e-6]
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    print(f'phase 21 (c): static 9q chain CX ladder in float32, k='
          f'{LADDER9_K}, {LADDER9_SAMPLES} samples, {LADDER9_STEPS} steps: '
          f'{len(hosts)} verified, CZ counts '
          f'{dict(Counter(h[0] for h in hosts))}, {len(good)} at host loss '
          f'<= 1e-6, best {hosts[:3]}; sweep launches {launches}, by plan '
          f'{by[0]}, by build {by[1]}; wall {wall:.3f} s ({stages})',
          flush=True)
    check(launches >= 2 and by == ({'tiles': launches},
                                   {'sweep_column_tiles': launches}),
          f'9q ladder: {launches} launches, by plan {by[0]}, by build '
          f'{by[1]}: not every launch of both stages on the column tiles')
    check(good and good[0][0] == 8, f'9q ladder: no 8-CZ decomposition at '
          f'host loss <= 1e-6: {hosts[:8]}')
    return launches


def phase_ladder9_warm(B=16, T=300):
    """Phase 21 (c), in float64: Synthesize.static for the 9q CX ladder at
    k = 8 from the warm rows of build_warm_batch around its exact 8-CZ
    embedding (ladder_program), B rows, T sampling steps at lr 0.01, under
    config.set_precision(True) (float32 restored in `finally`). Needs every
    sweep launch the double build on the column tiles and a verified 8-CZ
    decomposition at float64 host loss <= 1e-6. Returns the launches."""
    import numpy as np
    import torch
    from cpflow_tpu_torch import config
    from cpflow_tpu_torch.api import Ansatz, StaticOptions, Synthesize
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    n = 9
    ladder = cx_ladder(n)
    _, exact = ladder_program(n)
    anz = Ansatz(n, 'cp', fill_layers(chain_layer(n), n - 1), 'xyz')
    rows, sigma = build_warm_batch(exact, np.asarray(anz.cp_mask,
                                                     dtype=np.float64), B, 9)
    config.set_precision(True)
    try:
        synth = Synthesize(chain_layer(n), target_unitary=ladder)
        options = StaticOptions(num_cp_gates=n - 1, num_samples=B,
                                num_gd_iterations=T, learning_rate=0.01,
                                num_gd_iterations_at_verification=2000,
                                accepted_num_cz_gates=n - 1)
        sk.LAUNCHES = sk.F64_LAUNCHES = 0
        sk.LAUNCHES_BY_BUILD.clear()
        start = time.perf_counter()
        results = synth.static(options, save_results=False, verbose=False,
                               initial_angles_array=rows)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches, n64 = sk.LAUNCHES, sk.F64_LAUNCHES
        by_build = dict(sk.LAUNCHES_BY_BUILD)
    finally:
        config.set_precision(False)
    hosts = sorted((d.cz_count, hst64(d.circuit.unitary(), ladder))
                   for d in results.decompositions)
    good = [h for h in hosts if h[1] <= 1e-6]
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    print(f'phase 21 (c): static 9q chain CX ladder in float64 from {B} warm '
          f'rows (noise {sorted(set(np.round(sigma, 4).tolist()))}), k=8, '
          f'{T} steps at lr 0.01: {len(hosts)} verified, {len(good)} at host '
          f'loss <= 1e-6, best {hosts[:3]}; sweep launches {launches} '
          f'({n64} float64), by build {by_build}; wall {wall:.3f} s '
          f'({stages})', flush=True)
    check(launches >= 2 and n64 == launches and
          by_build == {'sweep_column_tiles_f64': launches},
          f'9q warm ladder in float64: {launches} launches ({n64} float64), '
          f'by build {by_build}')
    check(good and good[0][0] == n - 1, f'9q warm ladder in float64: no '
          f'8-CZ decomposition at host loss <= 1e-6: {hosts[:8]}')
    return launches


def custom_ladder_run(n, k, dtype, B, steps, label, card):
    """Phase 21 (d): a custom loss, the n-qubit CX ladder's HS test as a torch
    callable, on the n-qubit chain at k blocks in `dtype`: the sweep
    (sweep() routes a custom loss to the Adam loop over the unitary
    kernels) from B restarts, against the plain route (the same loop over
    the plain builder, plain=True) from the same angles. float64: over 60
    steps and over `steps`, held to F64_LOSS0_TOL, F64_BEST_TOL and
    CUSTOM8_TOL; float32: over `steps` alone, the initial losses within
    1e-5 and the best ones by drift_ok, or where it misses as close to the
    plain float64 route as the plain float32 one (as_close_as_plain: the
    callable's float32 sum over 4^n entries and its gradient drift in both
    routes). Every launch of the unitary kernels must run the column tiles'
    kernels of `dtype`, never the plain builder. Returns {kernel line:
    launches}."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import Ansatz, RegularizationOptions
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.ops.penalty import make_regularization_function
    from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
    from cpflow_tpu_torch.sim.batched import make_batched_regloss
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    f64 = dtype == torch.float64
    suffix = '_f64' if f64 else ''
    ladder = on_device(cx_ladder(n))
    d2 = float(4 ** n)
    hs = lambda u: 1 - torch.abs((ladder(u).conj() * u).sum()) ** 2 / d2
    anz = Ansatz(n, 'cp', fill_layers(chain_layer(n), k))
    objs = [make_batched_regloss(
        n, 'cp', 'xyz', anz.placements, hs, cp_mask=anz.cp_mask,
        r=0.00055, regularization_func=make_regularization_function(
            RegularizationOptions), dtype=dtype, plain=plain)
        for plain in (False, True)]
    check(sk.route(objs[0], 'cuda') == 'unitary', f'{label}: not routed to '
          f'the unitary kernels')
    nba = num_block_angles('cp', 'xyz')
    kinds = {vjp: uk.kernel_name(uk.plan(n, k, nba, n, vjp, dtype)['design'],
                                 vjp, n) + suffix for vjp in (False, True)}
    check(kinds[True] == 'ansatz_vjp_column_tiles' + suffix,
          f'{label}: the vjp plan is {kinds[True]}')
    init = uniform_inits(anz.num_angles, B, 21, 'cuda').to(dtype)
    runs = (60, steps) if f64 else (steps,)
    out = {}
    with PlainBuilderWatch() as watch:
        uk.LAUNCHES_BY_KERNEL.clear()
        uk.VJP_LAUNCHES_BY_CLUSTER.clear()
        sk.LAUNCHES = 0
        start = time.perf_counter()
        for T in runs:
            out[T] = sk.sweep(objs[0], init, 0.1, T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        by_kernel = dict(uk.LAUNCHES_BY_KERNEL)
        by_cluster = dict(uk.VJP_LAUNCHES_BY_CLUSTER)
        fused, plain_calls = sk.LAUNCHES, watch.calls
    fwd, vjp = by_kernel.get(kinds[False], 0), by_kernel.get(kinds[True], 0)
    check(fwd > steps and vjp >= steps and set(by_kernel) == set(
        kinds.values()) and by_cluster == {'tiles': vjp} and fused == 0 and
          plain_calls == 0,
          f'{label}: launches by kernel {by_kernel}, vjp by plan '
          f'{by_cluster}, fused {fused}, plain builder {plain_calls}')
    start = time.perf_counter()
    ref = {T: sk.sweep_reference(objs[1], init, 0.1, T) for T in runs}
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - start
    first = runs[0]
    e0 = scaled_err(out[first].regloss0, ref[first].regloss0).max().item()
    e1 = scaled_err(out[first].best_loss, ref[first].best_loss)
    eT = scaled_err(out[steps].best_loss, ref[steps].best_loss)
    best = out[steps].best_loss
    if f64:
        ok = (e0 <= F64_LOSS0_TOL and e1.max().item() <= F64_BEST_TOL and
              eT.max().item() <= CUSTOM8_TOL)
        rule = (f'tol {F64_LOSS0_TOL}, {F64_BEST_TOL} after 60 steps, '
                f'{CUSTOM8_TOL} after {steps}')
    else:
        ok = e0 <= 1e-5 and drift_ok(e1)[0]
        rule = f'initial within 1e-5, after {steps} steps by drift_ok'
        if e0 <= 1e-5 and not ok:  # the plain float64 route decides
            obj64 = make_batched_regloss(
                n, 'cp', 'xyz', anz.placements, hs, cp_mask=anz.cp_mask,
                r=0.00055, regularization_func=make_regularization_function(
                    RegularizationOptions), dtype=torch.float64, plain=True)
            ref64 = sk.sweep_reference(obj64, init.double(), 0.1, steps)
            keep = torch.ones(B, dtype=torch.bool, device=best.device)
            ok, verdict = as_close_as_plain(out[steps].best_loss,
                                            ref[steps].best_loss,
                                            ref64.best_loss, keep)
            rule += f'; float64, as_close_as_plain: {verdict}'
    print(f'{label}: custom loss ({n}q CX ladder HS test, a torch callable) '
          f'in {str(dtype)[6:]} on {card}, chain k={k} B={B}: initial loss '
          f'err {e0:.3e}, best after {first} steps err '
          f'{e1.max().item():.3e}, after {steps} err {eT.max().item():.3e} '
          f'({rule}); best losses '
          f'{np.round(np.sort(best.cpu().numpy()), 6).tolist()}; launches '
          f'{by_kernel}; wall {wall:.3f} s, plain route {plain_wall:.3f} s',
          flush=True)
    check(ok and bool(torch.isfinite(best).all()),
          f'{label}: against the plain route: {e0:.3e}, '
          f'{e1.max().item():.3e}, {eT.max().item():.3e}')
    return {kinds[False]: fwd, kinds[True]: vjp}


MODULO9_WIRES = [2, 7, 0]  # phase 21 (f)'s modulo_diagonal wires


def modulo_nine_run(dtype, card, B=4, k=4, T=20):
    """Phase 21 (f): a 9-qubit modulo_diagonal sweep (the Toffoli-9 on
    MODULO9_WIRES, the chain at k blocks, B restarts, T steps), which no
    plan of the fused kernel holds: sweep() must route it to the unitary
    kernels (route 'unitary', ROADMAP A.16b), every launch of them in
    `dtype` and none of the fused kernel or the plain builder, and it is
    held against the plain float64 route from the same angles: in float64
    within F64_LOSS0_TOL and F64_BEST_TOL, in float32 the initial losses
    within 1e-5 and the best ones by drift_ok, each scaled by max(1, |loss|)
    (the modulo losses start near d = 512). Returns {kernel line:
    launches}."""
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.ops.gates import multi_controlled_x
    F64 = torch.float64
    n = 9
    objs = {}
    for dt, plain in ((dtype, False), (F64, True)):
        obj, P = make_objective(n, k, multi_controlled_x(n), 0.002,
                                kind='modulo_diagonal', wires=MODULO9_WIRES,
                                dtype=dt)
        obj.plain = plain  # the kernels' route, and the plain reference
        objs[plain] = obj
    check(sk.route(objs[False], 'cuda') == 'unitary',
          f'phase 21 (f): a 9q modulo loss in {dtype} not routed to the '
          f'unitary kernels')
    suffix = '_f64' if dtype == F64 else ''
    init = uniform_inits(P, B, 29, 'cuda').to(dtype)
    with PlainBuilderWatch() as watch:
        uk.LAUNCHES_BY_KERNEL.clear()
        sk.LAUNCHES = 0
        start = time.perf_counter()
        got = sk.sweep(objs[False], init, 0.1, T)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        by_kernel = dict(uk.LAUNCHES_BY_KERNEL)
        fused, plain_calls = sk.LAUNCHES, watch.calls
    check(fused == 0 and plain_calls == 0 and len(by_kernel) == 2 and
          all(name.endswith(suffix) and v >= T for name, v in
              by_kernel.items()),
          f'phase 21 (f): launches by kernel {by_kernel}, fused {fused}, '
          f'plain builder {plain_calls}')
    start = time.perf_counter()
    ref = sk.sweep_reference(objs[True], init.to(F64), 0.1, T)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - start
    e0 = scaled_err(got.regloss0.double(), ref.regloss0)
    e = scaled_err(got.best_loss.double(), ref.best_loss)
    if dtype == F64:
        ok = (e0.max().item() <= F64_LOSS0_TOL and
              e.max().item() <= F64_BEST_TOL)
        rule = f'tol {F64_LOSS0_TOL} and {F64_BEST_TOL}'
    else:
        ok = e0.max().item() <= 1e-5 and drift_ok(e)[0]
        rule = 'initial within 1e-5, best by drift_ok'
    print(f'phase 21 (f): 9q modulo_diagonal (wires {MODULO9_WIRES}) in '
          f'{str(dtype)[6:]} on {card}, chain k={k} B={B} T={T}, through the '
          f'unitary kernels {by_kernel}: initial loss err '
          f'{e0.max().item():.3e}, best loss err {e.max().item():.3e} against '
          f'plain float64 ({rule}); best losses '
          f'{[round(x, 4) for x in got.best_loss.tolist()]}; wall {wall:.3f} '
          f's, plain float64 {plain_wall:.3f} s', flush=True)
    check(ok and bool(torch.isfinite(got.best_loss).all()),
          f'phase 21 (f): 9q modulo in {dtype} against plain float64: '
          f'{e0.tolist()}, {e.tolist()}')
    return by_kernel


def refuse_whole_beyond(label, dtypes=None):
    """The refusals of the whole unitary: one qubit past MAX_QUBITS for the
    sweep (the HS test) and for the unitary kernels, in each dtype of
    `dtypes` (float32 by default), and a modulo loss one qubit past the
    unitary kernels' limit (the fused kernel takes it to 8 qubits, the
    unitary kernels past that, ROADMAP A.16b), each with its reason, before
    any kernel is launched (the targets are placeholders: nothing reads
    them)."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.topology import chain_layer, fill_layers
    before = (sk.LAUNCHES, uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES)
    eye = np.eye(2, dtype=np.complex64)
    past = uk.MAX_QUBITS[torch.float32]['unitary'] + 1
    refusals = [(f'{past}q modulo_identity, sweep',
                 f'2 to 8 qubits.*got {past}.*A.16b.*unitary kernels.*to '
                 f'{past - 1} qubits',
                 lambda: sk.sweep(
                     make_objective(past, 2, eye, 0.0, kind='modulo_identity',
                                    wires=[0, past - 1])[0],
                     uniform_inits(3 * past + 14, 2, 0, 'cuda'), 0.1, 1))]
    for dtype in dtypes or (torch.float32,):
        n = sk.MAX_QUBITS[dtype]['hst'] + 1
        check(n - 1 == uk.MAX_QUBITS[dtype]['unitary'],
              f'the sweep and the unitary kernels disagree on the whole '
              f'unitary\'s limit in {dtype}')
        what = f'{n}q whole unitary in {str(dtype)[6:]}'
        angles = uniform_inits(3 * n + 14, 2, 0, 'cuda').to(dtype)
        refusals += [
            (f'{what}, sweep', f'2 to {n - 1} qubits', lambda n=n, a=angles,
             dt=dtype: sk.sweep(make_objective(n, 2, eye, 0.0,
                                               dtype=dt)[0], a, 0.1, 1)),
            (f'{what}, unitary kernels', f'2 to {n - 1} qubits',
             lambda n=n, a=angles, dt=dtype: uk.build_unitary(
                 n, 'cp', 'xyz', fill_layers(chain_layer(n), 2), a,
                 dtype=dt))]
    import re
    for name, want, call in refusals:
        try:
            call()
        except ValueError as e:
            check(re.search(want, str(e)), f'{name}: refused for {e}')
            print(f'{label}: {name} refused: {e}', flush=True)
        else:
            raise PhaseError(f'{name} did not raise')
    check((sk.LAUNCHES, uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES) == before,
          f'{label}: a refused shape launched a kernel')


def phase_nine(card):
    """Phase 21: the whole unitary past what a cluster of 16 blocks holds,
    on the column tiles. (a) the sweep kernel at nine_shapes against its
    plain version (phase_sixteen_sweeps) and two launches on the same inputs
    (phase_nine_bits); (b) the unitary kernels at NINE_UNITARY against the
    plain builder (phase_sixteen_unitary), and two launches of each on the
    same inputs (phase_split_vjp_bits); (c) Synthesize.static for the 9q
    CX ladder in float32 from random restarts (phase_ladder9) and in float64
    from warm rows (phase_ladder9_warm); (d) a custom loss at 9q in float64
    and at 10q in float32 through the unitary kernels' tiles
    (custom_ladder_run); (e) the refusals past the limits
    (refuse_whole_beyond); (f) a 9q modulo_diagonal sweep, routed to the
    unitary kernels, in float32 and float64 (modulo_nine_run). Returns
    (largest errors by kernel line name,
    timing rows by kernel line name, launches by kernel line name and
    path)."""
    import torch
    start = time.perf_counter()
    shapes = nine_shapes()
    worst32, worst64, rows32, rows64 = phase_sixteen_sweeps(
        card, shapes, 'phase 21 (a)')
    phase_nine_bits(shapes)
    errs, rows = phase_sixteen_unitary(card, NINE_UNITARY, 'phase 21 (b)')
    phase_split_vjp_bits(NINE_UNITARY, 'phase 21 (b)')
    errs.update(sweep_column_tiles=worst32, sweep_column_tiles_f64=worst64)
    rows.update(sweep_column_tiles=rows32, sweep_column_tiles_f64=rows64)
    launches = {'sweep_column_tiles': {'static_ladder9': phase_ladder9()},
                'sweep_column_tiles_f64': {
                    'static_ladder9_warm_f64': phase_ladder9_warm(B=4)}}
    for path, args in {
            'custom_ladder9_f64': (9, 8, torch.float64, 8, CUSTOM9_STEPS),
            'custom_ladder10': (10, 9, torch.float32, 4, 30)}.items():
        for line, count in custom_ladder_run(
                *args, f'phase 21 (d) {path}', card).items():
            launches.setdefault(line, {})[path] = count
    refuse_whole_beyond('phase 21 (e)', (torch.float32, torch.float64))
    for path, dtype in (('modulo9', torch.float32),
                        ('modulo9_f64', torch.float64)):
        for line, count in modulo_nine_run(dtype, card).items():
            launches.setdefault(line, {})[path] = count
    print(f'phase 21: {time.perf_counter() - start:.1f} s', flush=True)
    return errs, rows, launches


# Phase 22 (a)'s rows, as SIXTEEN_UNITARY's tuples: one column on one block
# (phase 19 (a)'s 13q row, the forward pass at 14 qubits, float64 at 12 and
# 13 qubits, the GHZ-4 path's 4q shape, 9q, and phase 22 (b)'s two paths'
# shapes) and the whole unitary past the column design's depths, with one
# rotation letter (3 angles a block) and with 'xyz' (9), each in its own
# one-block window (the vjp in float32 and float64, the forward pass in
# float32), and the forward pass on the row-split plan's 2 and 4
# independent blocks (6q k=1000 'xyz', 3q k=1093 'xyz', float64 6q k=600
# 'y')
BLOCK_UNITARY = [(13, 48, 'xyz', 8, 'float32', (False, True), [0], 1),
                 (14, 28, 'xyz', 8, 'float32', (False,), [0], 1),
                 (12, 24, 'xyz', 8, 'float64', (False, True), [0], 1),
                 (13, 26, 'xyz', 8, 'float64', (False,), [0], 1),
                 (4, 6, 'xyz', 100, 'float32', (False, True), [0], 1),
                 (9, 16, 'xyz', 32, 'float32', (False, True), [0], 1),
                 (13, 12, 'xyz', 18, 'float32', (False, True), [0], 1),
                 (12, 11, 'xyz', 17, 'float64', (False, True), [0], 1),
                 (6, 400, 'y', 4, 'float32', (True,), None, 1),
                 (6, 130, 'y', 4, 'float64', (True,), None, 1),
                 (6, 1190, 'y', 2, 'float32', (False,), None, 1),
                 (3, 750, 'y', 2, 'float32', (True,), None, 1),
                 (6, 400, 'xyz', 4, 'float32', (True,), None, 1),
                 (6, 110, 'xyz', 4, 'float64', (True,), None, 1),
                 (6, 930, 'xyz', 2, 'float32', (False,), None, 1),
                 (3, 622, 'xyz', 2, 'float32', (True,), None, 1),
                 (6, 1000, 'xyz', 2, 'float32', (False,), None, 2),
                 (3, 1093, 'xyz', 2, 'float32', (False,), None, 4),
                 (6, 600, 'y', 2, 'float64', (False,), None, 2)]
# the kernel lines of the pair on one block
BLOCK_LINES = ('ansatz_forward', 'ansatz_vjp')


def phase_ghz4_l1(r=0.001, label='phase 22 (c)'):
    """Phase 22 (c): phase 7's GHZ-4 (the 4q chain, k=6, 100 random
    restarts, r) with cp_penalty_L1, whose sampling runs through the
    unitary kernels (one column on one block) and verification through the
    sweep kernel. Needs a 3-CZ decomposition at float64 host state loss <=
    1e-6, no call of the plain builder, and every unitary launch the kernel
    line its plan names. Returns the launches by kernel line name."""
    import numpy as np
    import torch
    from cpflow_tpu_torch.api import StaticOptions, Synthesize
    from cpflow_tpu_torch.kernels import sweep as sk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.ops.penalty import cp_penalty_L1
    from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
    from cpflow_tpu_torch.topology import chain_layer
    target = ghz(4).astype(np.complex128)
    synth = Synthesize(chain_layer(4), target_state=target,
                       cp_regularization_func=cp_penalty_L1)
    options = StaticOptions(num_cp_gates=6, num_samples=100,
                            accepted_num_cz_gates=3, r=r)
    nba = num_block_angles('cp', 'xyz')
    kernels = {vjp: uk.kernel_name('rows', vjp, 4, uk.plan(
        4, 6, nba, 0, vjp)['blocks_per_restart'], True)
        for vjp in (False, True)}
    with PlainBuilderWatch() as watch:
        sk.LAUNCHES = 0
        uk.FORWARD_LAUNCHES = uk.VJP_LAUNCHES = 0
        uk.LAUNCHES_BY_KERNEL.clear()
        start = time.perf_counter()
        results = synth.static(options, save_results=False, verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches, by_kernel = sk.LAUNCHES, dict(uk.LAUNCHES_BY_KERNEL)
        unitary = (uk.FORWARD_LAUNCHES, uk.VJP_LAUNCHES)
    hosts = sorted((d.cz_count, ghz_host_loss(d))
                   for d in results.decompositions)
    good = [h for h in hosts if h[0] == 3 and h[1] <= 1e-6]
    stages = ', '.join(f'{k} {v:.3f} s'
                       for k, v in synth.stage_seconds.items())
    print(f'{label}: GHZ-4, Synthesize.static on the 4q chain with '
          f'cp_penalty_L1, k=6, 100 random restarts, r={r}: '
          f'{len(hosts)} verified, {len(good)} at 3 CZ, (CZ, float64 host '
          f'loss) {hosts[:3]}; unitary launches {unitary[0]} forward and '
          f'{unitary[1]} vjp {by_kernel}, plain builder {watch.calls}; '
          f'sweep launches {launches}; wall {wall:.3f} s ({stages})',
          flush=True)
    check(watch.calls == 0 and unitary[0] > 0 and unitary[1] > 0 and
          by_kernel == {kernels[False]: unitary[0],
                        kernels[True]: unitary[1]} and launches >= 1,
          f'GHZ-4 with cp_penalty_L1: plain builder {watch.calls}, forward '
          f'{unitary[0]}, vjp {unitary[1]} by kernel {by_kernel}, not all '
          f'{kernels}; sweep {launches}')
    check(good, f'GHZ-4 with cp_penalty_L1: no 3-CZ decomposition at host '
          f'loss <= 1e-6: {hosts[:4]}')
    return {kernels[False]: unitary[0], kernels[True]: unitary[1],
            'sweep_block': launches}


def phase_block(card):
    """Phase 22: the pair on one block (forward_block_kernel,
    vjp_block_kernel on rows.cuh's warps: one column, and the whole unitary
    held column-major with whole columns a warp and no swap, the forward
    pass also on the plan's independent blocks). (a) the unitary kernels at BLOCK_UNITARY against
    the plain builder (phase_sixteen_unitary: plans, tolerances, times,
    bounds) and two launches of each on the same inputs
    (phase_split_vjp_bits); (b) GHZ-13 in float32 and GHZ-12 in float64
    through Synthesize.static from a warm start with cp_penalty_L1
    (phase_ghz_warm), both passes on one block; (c) GHZ-4 from random
    restarts with cp_penalty_L1 (phase_ghz4_l1). Returns (largest errors by
    kernel line name, timing rows by kernel line name, launches by kernel
    line name and path)."""
    import torch
    from cpflow_tpu_torch.ops.penalty import cp_penalty_L1
    start = time.perf_counter()
    errs, rows = phase_sixteen_unitary(card, BLOCK_UNITARY, 'phase 22 (a)')
    phase_split_vjp_bits(BLOCK_UNITARY, 'phase 22 (a)')
    launches = {}
    for path, (n, dtype) in {'ghz13_l1_warm': (13, None),
                             'ghz12_l1_warm_f64': (12, torch.float64)}.items():
        for line, count in phase_ghz_warm(
                B=32, T=300, n=n, dtype=dtype, penalty=cp_penalty_L1,
                label='phase 22 (b)').items():
            launches.setdefault(line, {})[path] = count
    for line, count in phase_ghz4_l1().items():
        launches.setdefault(line, {})['static_ghz4_l1'] = count
    print(f'phase 22: {time.perf_counter() - start:.1f} s', flush=True)
    return errs, rows, launches


# Phase 23 (a)'s rows, as SIXTEEN_UNITARY's tuples with a ninth, the layer
# ('random': random pairs, shape_layers): one column past the row tiles,
# the vjp on the global row tiles' tiles (the forward pass there too, but
# at 18 qubits in float32 and 17 in float64, where a cluster of 16 still
# holds it): the GHZ ladder's template and a random one at 20 qubits in
# float32 and 19 in float64, phase 23 (c)'s two main paths' shapes (the
# ladder at 20 qubits in float32 and 18 in float64, B = 4, the noisy rows
# that path samples), and the edge, the cap's width (24 and 23), shallow
# for the plain version's autograd
GLOBAL_UNITARY = [(18, 17, 'xyz', 4, 'float32', (False, True), [0], 64),
                  (20, 19, 'xyz', 4, 'float32', (False, True), [0], 256),
                  (20, 40, 'xyz', 2, 'float32', (False, True), [0], 128,
                   'random'),
                  (17, 16, 'xyz', 4, 'float64', (False, True), [0], 64),
                  (18, 17, 'xyz', 4, 'float64', (False, True), [0], 128),
                  (19, 18, 'xyz', 2, 'float64', (False, True), [0], 256),
                  (19, 38, 'xyz', 2, 'float64', (False, True), [0], 256,
                   'random'),
                  (24, 2, 'xyz', 2, 'float32', (False, True), [0], 4096),
                  (23, 2, 'xyz', 2, 'float64', (False, True), [0], 4096)]
# the kernel lines of the global row tiles (the vjp's with its sum)
GLOBAL_LINES = ('ansatz_forward_global_rows', 'ansatz_vjp_global_rows')


def global_passes(shapes):
    """Prints the passes of each row's global schedules (forward pass,
    vjp) at both choices of blocks an SM (one, two on tiles half as
    large), with the one the wrapper takes (kernels/unitary.py:
    global_per_sm)."""
    from cpflow_tpu_torch.kernels import rows as rk
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.sim.ansatz_kernel import (all_placements,
                                                    num_block_angles)
    import torch
    for n, k, rot, _, dname, _, _, _, *layer in shapes:
        dtype = getattr(torch, dname)
        nba = num_block_angles('cp', rot)
        placements = tuple(tuple(int(q) for q in p) for p in all_placements(
            shape_layers(n, k, layer)))
        got = {}
        for vjp in (False, True):
            what = 'vjp' if vjp else 'forward'
            for per_sm in (1, 2):
                p = uk.global_plan(n, k, nba, vjp, dtype, per_sm)
                if p is not None:
                    _, offsets, _ = rk.global_schedule(
                        n, placements, p['segment'], p['log_rows'],
                        rk.sector_bits(dtype))
                    got[f'{what}, {per_sm} an SM (2^{p["log_rows"]} rows)'] \
                        = len(offsets) - 1
            chosen = uk.global_per_sm(n, placements, nba, vjp, dtype)
            if chosen:
                got[f'{what} takes'] = f'{chosen} an SM'
        print(f'phase 23 (a): {n}q {layer[0] if layer else "chain"} k={k} '
              f'{dname}: passes {got}', flush=True)


def global_gates_rows(card, shapes):
    """Phase 23 (a), the global row tiles' prologue alone
    (uk.global_gates, global_gates_kernel) at each of `shapes` whose
    forward pass runs on the global row tiles: every gate's matrix of every
    restart against the plain builders (sim/adjoint.py's
    surface_matrix_and_grads, block_matrix_and_grads) on the same angles,
    within 1e-6 in float32 (a few products of unit-size rotations) and
    1e-13 in float64; timed alone (traced_calls, a launch a call) and as
    a wrapper call, beside the plain builders and its bound (the gates'
    operations of utils/profiling.py:unitary_work; the angles read, the
    gates and the cos and sin written). Returns (largest errors by kernel
    line name, timing rows by kernel line name)."""
    import torch
    from cpflow_tpu_torch.api import Ansatz
    from cpflow_tpu_torch.kernels import unitary as uk
    from cpflow_tpu_torch.sim import adjoint
    from cpflow_tpu_torch.sim.ansatz_kernel import num_block_angles
    from cpflow_tpu_torch.utils.profiling import PEAK_BYTES, precision
    errs, rows = {}, {}
    for n, k, rot, B, dname, _, _, _, *layer in shapes:
        dtype = getattr(torch, dname)
        nba = num_block_angles('cp', rot)
        if uk.plan(n, k, nba, 0, False, dtype)['design'] != 'global_rows':
            continue
        line = 'ansatz_global_gates' + ('_f64' if dtype == torch.float64
                                        else '')
        anz = Ansatz(n, 'cp', shape_layers(n, k, layer), rot)
        name = f'{n}q {layer[0] if layer else "chain"} k={k} {rot!r} B={B} ' \
            f'{dname}'
        angles = uniform_inits(anz.num_angles, B, 23, 'cuda').to(dtype)
        before = uk.GLOBAL_PASSES[line]

        def call():
            return uk.global_gates(n, 'cp', rot, anz.placements, angles)

        got = call()
        torch.cuda.synchronize()
        check(uk.GLOBAL_PASSES[line] == before + 1,
              f'{name}: the prologue did not run')

        def plain():
            out = [adjoint.surface_matrix_and_grads(
                angles[3 * q:3 * q + 3])[0].reshape(4, B) for q in range(n)]
            out += [adjoint.block_matrix_and_grads(
                'cp', rot, angles[3 * n + nba * b:3 * n + nba * (b + 1)])[0]
                .reshape(16, B) for b in range(k)]
            return out

        want = plain()
        err = max((got[:, j, :w.shape[0]] - w.T).abs().max().item()
                  for j, w in enumerate(want))
        tol = 1e-13 if dtype == torch.float64 else 1e-6
        check(err <= tol, f'{name}: the prologue\'s gates off the plain '
              f'builders by {err:.3e} (tol {tol})')
        errs[line] = max(errs.get(line, 0.0), err)
        alone, kept, whole = traced_calls(call, {'global_gates_kernel': 1})
        ms = alone['global_gates_kernel']
        check(ms is not None, f'{name}: the profiler kept no prologue in '
              f'three traces')
        _, call_ms = timed(call)
        _, plain_ms = timed(plain)
        work = unitary_work(n, k, rot, log_c=0, dtype=dtype)
        real, peak = precision(dtype)
        G, P = n + k, work['P']
        t_ops = work['gates'] * B / peak * 1e3
        t_bytes = real * (P + 32 * G + 2 * P) * B / PEAK_BYTES * 1e3
        bound, by = (t_ops, 'operations') if t_ops >= t_bytes else \
            (t_bytes, 'bytes')
        regs = uk.registers('cuda', dtype)['ansatz_global_gates']
        print(f'phase 23 (a): {line} {name} on {card}: gates off the plain '
              f'builders by {err:.3e} (tol {tol}); kernel alone (profiler) '
              f'{ms:.4f} ms (' + ('all kept in 20 calls' if whole else
                                  f'kept {kept} of 20') +
              f'), one wrapper call (CUDA events) {call_ms:.4f} ms, plain '
              f'{plain_ms:.3f} ms; bound {bound:.5f} ms by {by}, share '
              f'{bound / ms:.2%}; {regs["registers"]} registers, '
              f'{regs["local_bytes"]} local bytes', flush=True)
        check(regs['local_bytes'] == 0, f'{name}: the prologue uses local '
              f'memory: {regs}')
        rows.setdefault(line, []).append(dict(
            shape=name, ms=call_ms, device_ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, registers=regs['registers'],
            local_bytes=regs['local_bytes']))
    return errs, rows


def phase_wide(card):
    """Phase 23: one column past what a cluster holds, on the global row
    tiles (forward_global_kernel, vjp_global_kernel, vjp_global_sum_kernel).
    (a) the unitary kernels at GLOBAL_UNITARY against the plain builder
    (phase_sixteen_unitary: plans, tolerances, the float64 arbiter where
    plain float32 drifts) and two launches of each on the same inputs
    (phase_split_vjp_bits), with each row's passes; (b) there, each kernel
    alone on the card beside its bound, with registers and local bytes;
    (c) GHZ-20 in float32 and GHZ-18 in float64 through Synthesize.static
    from a warm start (phase_ghz_warm, 8 rows), sampling and verification
    through the unitary kernels, never the plain builder. Returns (largest
    errors by kernel line name, timing rows by kernel line name, wrapper
    calls by kernel line name and path, kernel launches by uk.KERNELS name
    and path)."""
    import torch
    start = time.perf_counter()
    global_passes(GLOBAL_UNITARY)
    errs, rows = phase_sixteen_unitary(card, GLOBAL_UNITARY, 'phase 23 (a)')
    gate_errs, gate_rows = global_gates_rows(card, GLOBAL_UNITARY)
    errs.update(gate_errs)
    rows.update(gate_rows)
    phase_split_vjp_bits(GLOBAL_UNITARY, 'phase 23 (a)')
    print(f'phase 23 (a), (b): {time.perf_counter() - start:.1f} s',
          flush=True)
    launches, kernel_launches = {}, {}
    for path, (n, dtype) in {'ghz20_warm': (20, None),
                             'ghz18_warm_f64': (18, torch.float64)}.items():
        passes = {}
        for line, count in phase_ghz_warm(
                B=8, T=300, n=n, dtype=dtype, label='phase 23 (c)',
                passes=passes).items():
            launches.setdefault(line, {})[path] = count
        for name, count in passes.items():
            kernel_launches.setdefault(name, {})[path] = count
    print(f'phase 23: {time.perf_counter() - start:.1f} s', flush=True)
    return errs, rows, launches, kernel_launches


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
    failed = []

    def attempt(default, fn, *args):
        """One phase after the build and the comparison: a failed check is
        printed and the next phase runs; the script fails at the end."""
        try:
            return fn(*args)
        except PhaseError as e:
            print(f'FAIL: {e}', file=sys.stderr, flush=True)
            failed.append(str(e))
            return default

    try:
        card = card_line()
        print(f'phase 1: {card}; torch {torch.__version__}, CUDA '
              f'{torch.version.cuda}', flush=True)
        phase_build()
        _, driven, compare_rows = phase_compare()
        from cpflow_tpu_torch.kernels import sweep as sk
        launches, by_build = {}, {}

        def main_path(name, fn, *args):
            """A main path's phase (attempt), which sets the sweep kernel's
            counts to 0 just before it drives the path: its launches, and
            its launches by build, read just after."""
            launches[name] = attempt(0, fn, *args)
            by_build[name] = dict(sk.LAUNCHES_BY_BUILD)

        main_path('static_ccz3', phase_main_path)
        rows = attempt(None, phase_timing, card)
        main_path('adaptive_toffoli4', phase_adaptive)
        main_path('static_ghz4', phase_state)
        main_path('adaptive_relphase_toffoli4', phase_relphase)
        main_path('adaptive_toffoli5_xz', phase_toffoli5_xz)
        main_path('success_ratio_table3', phase_success_ratio)
        from cpflow_tpu_torch.api import StaticOptions
        from cpflow_tpu_torch.topology import chain_layer, connected_layer
        main_path('static_toffoli3_refine', phase_refine,
                  '(a) static Toffoli-3 connected, then refine',
                  connected_layer(3),
                  StaticOptions(num_cp_gates=7, r=1.31e-3, num_samples=100,
                                accepted_num_cz_gates=6), 6, 7,
                  'published: 6 CZ, 7 T')
        main_path('static_toffoli3_chain_refine', phase_refine,
                  '(b) static Toffoli-3 chain, then refine', chain_layer(3),
                  StaticOptions(num_cp_gates=14, r=0.88e-3, num_samples=100,
                                accepted_num_cz_gates=8), 8, 7,
                  'published: 8 CZ, 7 T, T depth 3')
        # the column build's and the one-block build's launches on those
        # paths
        columns = {name: by.get('sweep_columns', 0)
                   for name, by in by_build.items()}
        blocks = {name: by.get('sweep_block', 0)
                  for name, by in by_build.items()}
        unitary_err, unitary_rows = attempt((None, None), phase_unitary,
                                            card)
        unitary_launches, launches['adaptive_ghz4_state'] = attempt(
            ({}, 0), phase_custom_loss)
        unitary_launches.update(attempt({}, phase_engine))
        seven_err, seven_rows, seven_launches, seven_driven = attempt(
            (0.0, [], {}, {}), phase_seven, card)
        launches.update(seven_launches)
        launches.update(attempt({}, phase_mesh, card))
        launches.update(attempt({}, phase_prng, card))
        double_lines = attempt([], phase_double, card)
        sixteen = attempt(None, phase_sixteen, card)
        split = attempt(None, phase_split, card)
        nine = attempt(None, phase_nine, card)
        block = attempt(None, phase_block, card)
        wide = attempt(None, phase_wide, card)
        check(not failed, f'{len(failed)} phase(s) failed: '
              + '; '.join(failed))
        # the GHZ-4 state path (phase 13) runs the one-block build and the
        # 7-qubit paths (phase 15) the cluster build, as those phases check
        # (LAUNCHES_BY_BUILD): column_plan holds no state and nothing past
        # 6 qubits
        blocks['adaptive_ghz4_state'] = launches['adaptive_ghz4_state']
        clusters = dict(seven_launches)
        check(all(v > 0 for v in launches.values()),
              f'a main path missed the sweep kernel: {launches}')
        check(sum(blocks.values()) > 0, f'the one-block build missed the '
              f'main paths: {blocks}')
        check(sum(clusters.values()) > 0, f'the cluster build missed the '
              f'main paths: {clusters}')
        check(sum(columns.values()) > 0 and
              all(r['build'] == 'sweep_columns' for r in rows
                  if not r['shape'].startswith('(f)')),  # (f): a state
              f'the column build missed the main paths ({columns}) or '
              f'phase 5\'s rows ({[r["build"] for r in rows]})')
        check(all(f > 0 for f, _ in unitary_launches.values()) and
              sum(v for _, v in unitary_launches.values()) > 0,
              f'a main path missed the unitary kernels: {unitary_launches}')
        errs19, rows19, launches19, unitary19 = sixteen
        check(all(v > 0 for by in launches19.values() for v in by.values())
              and all(v > 0 for by in unitary19.values()
                      for v in by.values()),
              f'a phase 19 path missed its kernel: {launches19}, {unitary19}')
        errs20, rows20, launches20 = split
        lines20 = [line + suffix for line in ROW_TILE_LINES
                   for suffix in ('', '_f64')]
        check(all(sum(launches20.get(line, {}).values()) > 0
                  for line in lines20),
              f'a row tiles\' build missed the phase 20 paths: {launches20}')
        errs21, rows21, launches21 = nine
        lines21 = [line + suffix for line in COLUMN_TILE_LINES
                   for suffix in ('', '_f64')]
        check(all(sum(launches21.get(line, {}).values()) > 0
                  for line in lines21),
              f'a column tiles\' build missed the phase 21 paths: '
              f'{launches21}')
        errs22, rows22, launches22 = block
        lines22 = [line + suffix for line in BLOCK_LINES
                   for suffix in ('', '_f64')]
        check(all(sum(launches22.get(line, {}).values()) > 0
                  for line in lines22),
              f'the pair on one block missed the phase 22 paths: '
              f'{launches22}')
        errs23, rows23, launches23, passes23 = wide
        lines23 = [line + suffix for line in GLOBAL_LINES
                   for suffix in ('', '_f64')]
        check(all(sum(launches23.get(line, {}).values()) > 0
                  for line in lines23),
              f'the global row tiles missed the phase 23 paths: '
              f'{launches23}')
        check(all(sum(passes23.get(part + suffix, {}).values()) > 0
                  for parts in GLOBAL_PARTS.values() for part, _ in parts
                  for suffix in ('', '_f64')),
              f'a global row tiles\' kernel missed the phase 23 paths: '
              f'{passes23}')
        check('jax' not in sys.modules, 'jax was imported')
    except PhaseError as e:
        print(f'FAIL: {e}', file=sys.stderr)
        return 1
    print(f'all phases passed in {time.perf_counter() - start:.1f} s')
    print(card)
    # the sweep's builds each have a line; ms, plain_ms and bound_ms: a row
    # of phase 5 that the build runs, the kernel timed over its T steps and
    # the plain version over plain_T; every row of `shapes` gives the steps
    # its plain_ms was timed over (plain_T; both null where the plain
    # version was not timed);
    # registers: per thread, as the CUDA runtime reports them;
    # launches_all_builds_by_path: every main path's count of the sweep's
    # launches, phase 16's CLI (cli_static_ccz) and two-process
    # (dist_sweep) counts read from those processes;
    # no single PyTorch call computes the sweep, so library_ms is null;
    # modes, entanglers and rotation strings: those phase 3 drove on the
    # build;
    # shapes: the build's rows of phase 5, and for the one-block build
    # phase 15's rows (q)-(z3) at their T and the Toffoli-7 program's two
    # sweeps, each with the blocks a restart ran on (`cluster`; at the top,
    # every size the build ran with)
    # the unitary kernels: ms (one call of the wrapper, CUDA events, as the
    # sweep's), device_ms (the kernel alone on the card, from the profiler's
    # trace; null if the trace lacks it), plain_ms and bound_ms at the same
    # 3q k=12 B=1024 shape (phase 12; `shapes` has every row of
    # UNITARY_TIMING, each with the plan's `design`, its `cluster`,
    # `registers`, `local_bytes` and `blocks_per_sm`, and where the plan is
    # the column design the row-split design's numbers timed in turns with
    # it under `rows_`); `designs`: the designs phase 12's timing ran; a
    # forward pass is a chain of n + k batched gate applications and its
    # vjp a walk back through them, which no single PyTorch call computes,
    # so library_ms is null for them too
    # the one-block build (a state to 13 qubits, a template too deep for
    # the column build): its launches on the paths whose builds are known
    # (launches_all_builds_by_path: every build's), its largest error on
    # the rows of phase 3 that ran it, its numbers from phase 5's first row
    # that runs it ((f), the 10q state)
    mine = [r for r in compare_rows if r['build'] == 'sweep_block']
    row = next(r for r in rows if r['build'] == 'sweep_block')
    kernels = [{
        'name': 'sweep_block', 'route': 'cuda',
        'kernel': 'sweep_block_kernel',
        'source': 'cpflow_tpu_torch/csrc/sweep.cu',
        'replaces': 'cpflow_tpu/experimental/pallas_sweep.py:317',
        **driven['sweep_block'],
        'launches': sum(blocks.values()), 'launches_by_path': blocks,
        'launches_all_builds_by_path': launches,
        'max_abs_err': max(r['max_abs_err'] for r in mine),
        'ms': row['ms'], 'plain_ms': row['plain_ms'],
        'plain_T': row['plain_T'], 'bound_ms': row['bound_ms'],
        'bound_by': row['bound_by'], 'library_ms': None,
        'registers': row['registers'], 'local_bytes': row['local_bytes'],
        'cluster': [1],
        'shapes': [r for r in rows if r['build'] == 'sweep_block'] + mine}]
    # the cluster build (the whole unitary at 7 and 8 qubits): its launches
    # on phase 15's paths, its largest error on phase 15's rows, its numbers
    # from phase 15's first row ((q), 7q k=24 on 2 blocks), every row of
    # phase 15 and the Toffoli-7 program's two sweeps in `shapes`
    mine = [r for r in seven_rows if r.get('build') == 'sweep_cluster']
    row = mine[0]
    kernels.append({
        'name': 'sweep_cluster', 'route': 'cuda',
        'kernel': 'sweep_cluster_kernel',
        'source': 'cpflow_tpu_torch/csrc/sweep.cu',
        'replaces': 'cpflow_tpu/experimental/pallas_sweep.py:317',
        **seven_driven.get('sweep_cluster', {}),
        'launches': sum(clusters.values()), 'launches_by_path': clusters,
        'max_abs_err': seven_err, 'ms': row['ms'],
        'plain_ms': row['plain_ms'], 'plain_T': row['plain_T'],
        'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
        'library_ms': None, 'registers': row['registers'],
        'local_bytes': row['local_bytes'],
        'cluster': sorted({r['cluster'] for r in mine}), 'shapes': mine})
    # the column build (the whole unitary at 2 to 6 qubits): its launches on
    # the main paths of phases 4 and 6-11, its largest error on phase 3's
    # rows that ran it, its numbers from phase 5's first row (the static
    # sampling shape, which it runs), its rows of phases 3 and 5 in `shapes`
    mine = [r for r in compare_rows + rows if r['build'] == 'sweep_columns']
    kernels.append({
        'name': 'sweep_columns', 'route': 'cuda',
        'kernel': 'sweep_columns_kernel',
        'source': 'cpflow_tpu_torch/csrc/sweep.cu',
        'replaces': 'cpflow_tpu/experimental/pallas_sweep.py:317',
        **driven['sweep_columns'],
        'launches': sum(columns.values()), 'launches_by_path': columns,
        'max_abs_err': max(r['max_abs_err'] for r in mine
                           if 'max_abs_err' in r),
        'ms': rows[0]['ms'], 'plain_ms': rows[0]['plain_ms'],
        'plain_T': rows[0]['plain_T'], 'bound_ms': rows[0]['bound_ms'],
        'bound_by': rows[0]['bound_by'], 'library_ms': None,
        'registers': rows[0]['registers'],
        'local_bytes': rows[0]['local_bytes'], 'shapes': mine})
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
            'registers': row['registers'], 'local_bytes': row['local_bytes'],
            'design': row['design'],
            'designs': sorted({r['design'] for r in unitary_rows[name]}),
            'cluster': sorted({r['cluster'] for r in unitary_rows[name]}),
            'shapes': unitary_rows[name]})
    # phase 18's float64 builds, their launches on phase 18's paths
    kernels += double_lines
    # phase 19: its rows join each kernel's shapes and clusters, its main
    # paths each kernel's launches, its errors each kernel's largest error
    for line in kernels:
        name = line['name']
        by_path = dict(launches19.get(name, {}))
        by_path.update({path: by[name] for path, by in unitary19.items()
                        if name in by})
        line['launches_by_path'].update(by_path)
        line['launches'] += sum(by_path.values())
        line['max_abs_err'] = max(line['max_abs_err'], errs19.get(name, 0.0))
        line['shapes'] = line['shapes'] + rows19.get(name, [])
        line['cluster'] = sorted(set(line.get('cluster', [])) | {
            r['cluster'] for r in line['shapes'] if 'cluster' in r})
    # phase 20: a line for each build of the row tiles (a state's one column
    # split by rows), its numbers from its widest shape (the last of its
    # rows, on 16 blocks) and its launches from phase 20's paths; phase
    # 20's rows of an older build (the 14q column's forward pass on one
    # block) join that build's line
    for line in kernels:
        line['shapes'] = line['shapes'] + rows20.get(line['name'], [])
        line['max_abs_err'] = max(line['max_abs_err'],
                                  errs20.get(line['name'], 0.0))
    for name in lines20:
        rows = rows20[name]
        sweep = name.startswith('sweep')
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'cpflow_tpu_torch/csrc/' + (
                'sweep.cu' if sweep else 'unitary.cu'),
            **({'build': '-DCPFLOW_DOUBLE'} if name.endswith('_f64') else {}),
            'replaces': 'cpflow_tpu/experimental/pallas_sweep.py:317'
            if sweep else 'cpflow_tpu/sim/batched.py:255',
            'launches': sum(launches20[name].values()),
            'launches_by_path': launches20[name],
            'max_abs_err': errs20[name], 'ms': rows[-1]['ms'],
            'plain_ms': rows[-1]['plain_ms'],
            'bound_ms': rows[-1]['bound_ms'],
            'bound_by': rows[-1]['bound_by'], 'library_ms': None,
            'cluster': sorted({r['cluster'] for r in rows}), 'shapes': rows})
    # phase 21: a line for each build of the column tiles (the whole unitary
    # on independent blocks), its numbers from its first row (9 qubits) and
    # its launches from phase 21's paths; the forward pass's lines also take
    # its 7q and 8q rows of phases 12 and 19 and phase 19 (c)'s launches
    for line in kernels:
        line['shapes'] = line['shapes'] + rows21.get(line['name'], [])
        line['max_abs_err'] = max(line['max_abs_err'],
                                  errs21.get(line['name'], 0.0))
    for name in lines21:
        launches21.setdefault(name, {}).update(
            {path: by[name] for path, by in unitary19.items() if name in by})
        errs21[name] = max(errs21.get(name, 0.0), errs19.get(name, 0.0),
                           (unitary_err or {}).get(name, 0.0))
        rows21[name] = rows21.get(name, []) + \
            (unitary_rows or {}).get(name, []) + rows19.get(name, [])
    for name in lines21:
        rows = rows21[name]
        sweep = name.startswith('sweep')
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': 'cpflow_tpu_torch/csrc/' + (
                'sweep.cu' if sweep else 'unitary.cu'),
            **({'build': '-DCPFLOW_DOUBLE'} if name.endswith('_f64') else {}),
            'replaces': 'cpflow_tpu/experimental/pallas_sweep.py:317'
            if sweep else 'cpflow_tpu/sim/batched.py:255',
            'launches': sum(launches21[name].values()),
            'launches_by_path': launches21[name],
            'max_abs_err': errs21[name], 'ms': rows[0]['ms'],
            'plain_ms': rows[0]['plain_ms'], 'bound_ms': rows[0]['bound_ms'],
            'bound_by': rows[0]['bound_by'], 'library_ms': None,
            'tiles': sorted({r.get('tiles', r['cluster']) for r in rows}),
            # the vjp's three kernels (prologue, walk, sum) at its first row
            **({'parts': rows[0]['parts']} if 'parts' in rows[0] else {}),
            'shapes': rows})
    # phase 22: a line for each build of the pair on one block (kernel
    # lines ansatz_forward and ansatz_vjp), its numbers from its first row
    # (the 13q column in float32, the 12q column in float64) and its
    # launches from phase 22's paths, whose sweep launches join the sweep's
    # lines
    for line in kernels:
        by_path = launches22.get(line['name'])
        if by_path and line['name'].startswith('sweep'):
            line['launches_by_path'].update(by_path)
            line['launches'] += sum(by_path.values())
    for name in lines22:
        rows = rows22[name]
        kind, suffix = name.split('_f64')[0], '_f64' * name.endswith('_f64')
        kernels.append({
            'name': f'{kind}_one_block{suffix}', 'route': 'cuda',
            'line': name, 'kernel': TRACE_NAMES[('rows', 'vjp' in kind)],
            'source': 'cpflow_tpu_torch/csrc/unitary.cu',
            **({'build': '-DCPFLOW_DOUBLE'} if suffix else {}),
            'replaces': 'cpflow_tpu/sim/batched.py:255',
            'launches': sum(launches22[name].values()),
            'launches_by_path': launches22[name],
            'max_abs_err': errs22[name], 'ms': rows[0]['ms'],
            'device_ms': rows[0]['device_ms'],
            'plain_ms': rows[0]['plain_ms'], 'bound_ms': rows[0]['bound_ms'],
            'bound_by': rows[0]['bound_by'], 'library_ms': None,
            'registers': rows[0]['registers'],
            'local_bytes': rows[0]['local_bytes'], 'shapes': rows})
    # phase 23: a line for each build of the global row tiles' pair (the
    # vjp's with its sum kernel, and either with the prologue, in `parts`;
    # `launches` of its own kernels), its numbers from its row at
    # phase 23 (c)'s shape (the GHZ ladder's template at 20 qubits, 18 in
    # float64) and its launches from phase 23 (c)'s paths: `launches` the
    # line's kernel launches (uk.GLOBAL_PASSES: a pass each, the vjp's sum
    # once a call), `wrapper_calls` the wrapper's calls (LAUNCHES_BY_KERNEL);
    # phase 23's rows of an older build (the forward pass at 18 qubits, 17
    # in float64, on the row tiles) join that build's line
    for line in kernels:
        line['shapes'] = line['shapes'] + rows23.get(line['name'], [])
        line['max_abs_err'] = max(line['max_abs_err'],
                                  errs23.get(line['name'], 0.0))
    for name in lines23:
        rows = rows23[name]
        f64 = name.endswith('_f64')
        row = next(r for r in rows if r['shape'].startswith(
            '18q chain' if f64 else '20q chain'))
        # the prologue's launches are its own line's (below)
        by_kernel = {kernel: passes23[part + '_f64' * f64]
                     for part, kernel in GLOBAL_PARTS['vjp' in name]
                     if part != 'ansatz_global_gates'}
        kernels.append({
            'name': name, 'route': 'cuda',
            'kernel': TRACE_NAMES[('global_rows', 'vjp' in name)],
            'source': 'cpflow_tpu_torch/csrc/unitary.cu',
            **({'build': '-DCPFLOW_DOUBLE'} if name.endswith('_f64') else {}),
            'replaces': 'cpflow_tpu/sim/batched.py:255',
            'launches': sum(sum(by.values()) for by in by_kernel.values()),
            'launches_by_kernel': {kernel: sum(by.values())
                                   for kernel, by in by_kernel.items()},
            'launches_by_path': {path: sum(by.get(path, 0)
                                           for by in by_kernel.values())
                                 for path in launches23[name]},
            'wrapper_calls': sum(launches23[name].values()),
            'wrapper_calls_by_path': launches23[name],
            'max_abs_err': errs23[name], 'ms': row['ms'],
            'device_ms': row['device_ms'], 'plain_ms': row['plain_ms'],
            'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
            'library_ms': None, 'registers': row['registers'],
            'local_bytes': row['local_bytes'],
            **({'parts': row['parts']} if 'parts' in row else {}),
            'shapes': rows})
    # phase 23: the global row tiles' prologue (a line for each build), its
    # numbers from its row at phase 23 (c)'s shape, alone on the card
    # against the plain builders of the gates, its launches (one a call of
    # either pass) from phase 23 (c)'s paths
    for suffix in ('', '_f64'):
        name = 'ansatz_global_gates' + suffix
        rows = rows23[name]
        row = next(r for r in rows if r['shape'].startswith(
            '18q chain' if suffix else '20q chain'))
        kernels.append({
            'name': name, 'route': 'cuda',
            'kernel': TRACE_NAMES[('global_gates', False)],
            'source': 'cpflow_tpu_torch/csrc/unitary.cu',
            **({'build': '-DCPFLOW_DOUBLE'} if suffix else {}),
            'replaces': 'cpflow_tpu/sim/batched.py:255',
            'launches': sum(passes23[name].values()),
            'launches_by_path': passes23[name],
            'max_abs_err': errs23[name], 'ms': row['ms'],
            'device_ms': row['device_ms'], 'plain_ms': row['plain_ms'],
            'bound_ms': row['bound_ms'], 'bound_by': row['bound_by'],
            'library_ms': None, 'registers': row['registers'],
            'local_bytes': row['local_bytes'], 'shapes': rows})
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--dist-worker']:
        sys.exit(dist_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())

#!/usr/bin/env python3
"""Restates the bounds and shares of PERF.md section 6 under the counts of
cpflow_tpu_torch/utils/profiling.py, from the kernel times recorded there.

Run from the root of the repository (no card needed):

    python3 perf_bounds.py

Each row names a shape of a sweep (sweep_work, bound_ms: restarts B over T
steps) or of a vjp of the unitary kernels (unitary_work, unitary_bound_ms:
B restarts of one column or of the whole unitary; the global row tiles'
forward passes too), its build's dtype, and
the times PERF.md records for it (ms, the chip run and PR given with each).
It prints each row's bound, what bounds it, the share of the bound in each
time, and beside them the bound under the count before the surface round
was counted as a product state and its contraction (n gate passes of 14
operations an amplitude forward and n adjoint steps of 44 in the walk),
which is what PERF.md recorded before.
"""

from __future__ import annotations

from cpflow_tpu_torch.utils import profiling as prof

# sweeps: (label, n, blocks, rotations, entangler, loss, wires, B, T,
# dtype, times)
SWEEPS = [
    ('3q CCZ k=12 B=1024 T=2000', 3, 12, 'xyz', 'cp', 'hst', None, 1024,
     2000, 'float32', [109.31, 105.59, 118.90, 99.83, 109.94]),
    ('5q Toffoli k=20 B=2048 T=500', 5, 20, 'xyz', 'cp', 'hst', None, 2048,
     500, 'float32', [179.10, 180.60]),
    ('(d) bucketed 4q square k<=40 B=4x256 T=2000', 4, 40, 'xyz', 'cp',
     'hst', None, 1024, 2000, 'float32', [388.23, 395.47]),
    ('(f) state 10q GHZ k=36 B=256 T=500', 10, 36, 'xyz', 'cp', 'state',
     None, 256, 500, 'float32', [60.58, 61.24]),
    ("(g) 5q 'xz' k=36 B=256 T=500", 5, 36, 'xz', 'cp', 'hst', None, 256,
     500, 'float32', [52.44, 53.66]),
    ('(h) modulo_diagonal 4q k=12 B=256 T=2000', 4, 12, 'xyz', 'cp',
     'modulo_diagonal', 4, 256, 2000, 'float32', [82.07, 83.37]),
    ('Toffoli-7 k=144 B=64 T=2000', 7, 144, 'xyz', 'cp', 'hst', None, 64,
     2000, 'float32', [2290.59, 2354.02]),
    ('(q) 7q k=24 B=256 T=60', 7, 24, 'xyz', 'cp', 'hst', None, 256, 60,
     'float32', [51.73]),
    ("(w) 8q 'xz' k=16 B=32 T=60", 8, 16, 'xz', 'cp', 'hst', None, 32, 60,
     'float32', [30.33]),
    ('(x) 7q k=220 B=8 T=10', 7, 220, 'xyz', 'cp', 'hst', None, 8, 10,
     'float32', [10.45]),
    ('(L) state 14q k=28 B=64 T=60', 14, 28, 'xyz', 'cp', 'state', None, 64,
     60, 'float32', [19.55, 30.05, 15.55, 15.71, 16.00, 16.09]),
    ('(M) state 15q k=30 B=32 T=60', 15, 30, 'xyz', 'cp', 'state', None, 32,
     60, 'float32', [34.29, 34.37]),
    ('(N) state 16q k=32 B=16 T=30', 16, 32, 'xyz', 'cp', 'state', None, 16,
     30, 'float32', [19.79, 19.91]),
    ('(O) state 17q k=34 B=16 T=30', 17, 34, 'xyz', 'cp', 'state', None, 16,
     30, 'float32', [41.76, 42.58, 33.15, 33.29]),
    ('GHZ-14 search 14q k=15 B=256 T=1000', 14, 15, 'xyz', 'cp', 'state',
     None, 256, 1000, 'float32', [648.76, 648.84]),
    ('(R) 9q Toffoli-9 k=10 B=8 T=60', 9, 10, 'xyz', 'cp', 'hst', None, 8,
     60, 'float32', [11.49, 11.53, 10.41, 10.58]),
    ('(T) disc 10q k=12 B=4 T=30', 10, 12, 'xyz', 'cp', 'disc', None, 4, 30,
     'float32', [13.36, 13.53]),
    ('(U) 11q k=12 B=2 T=10', 11, 12, 'xyz', 'cp', 'hst', None, 2, 10,
     'float32', [14.80, 15.10, 8.33, 8.35]),
    ('(W) 13q k=2 B=1 T=4', 13, 2, 'xyz', 'cp', 'hst', None, 1, 4,
     'float32', [14.53, 14.61]),
    ('3q CCZ k=12 B=1024 T=2000', 3, 12, 'xyz', 'cp', 'hst', None, 1024,
     2000, 'float64', [180.49, 181.70]),
    ('5q Toffoli k=20 B=2048 T=500', 5, 20, 'xyz', 'cp', 'hst', None, 2048,
     500, 'float64', [374.51, 378.71]),
    ('(P) state 13q k=26 B=32 T=60', 13, 26, 'xyz', 'cp', 'state', None, 32,
     60, 'float64', [13.38, 13.56]),
    ('(Q) state 16q k=32 B=8 T=30', 16, 32, 'xyz', 'cp', 'state', None, 8,
     30, 'float64', [35.37, 35.47, 20.07, 20.10]),
    ('GHZ-14 search 14q k=15 B=256 T=1000', 14, 15, 'xyz', 'cp', 'state',
     None, 256, 1000, 'float64', [1477.64, 1478.06]),
    ('(S) 9q Toffoli-9 k=10 B=8 T=60', 9, 10, 'xyz', 'cp', 'hst', None, 8,
     60, 'float64', [20.11, 20.44]),
    ('(V) 12q k=2 B=1 T=4', 12, 2, 'xyz', 'cp', 'hst', None, 1, 4,
     'float64', [6.52, 6.70]),
]

# vjps: (label, n, blocks, rotations, log_c (None: the whole unitary, 0:
# one column), B, dtype, times)
VJPS = [
    ('3q k=12 B=1024', 3, 12, 'xyz', None, 1024, 'float32',
     [0.0213, 0.0220]),
    ('5q k=20 B=2048', 5, 20, 'xyz', None, 2048, 'float32',
     [0.1840, 0.1841]),
    ('7q k=24 B=64', 7, 24, 'xyz', None, 64, 'float32',
     [0.1588, 0.1597, 0.1250, 0.1251]),
    ('8q k=16 B=16', 8, 16, 'xyz', None, 16, 'float32',
     [0.2357, 0.2359, 0.1823, 0.1824]),
    ('8q k=270 B=4', 8, 270, 'xyz', None, 4, 'float32', [0.7198, 0.7236]),
    ('9q k=10 B=4', 9, 10, 'xyz', None, 4, 'float32', [0.0688, 0.0690]),
    ('10q k=12 B=2', 10, 12, 'xyz', None, 2, 'float32', [0.1557, 0.1562]),
    ('11q k=12 B=1', 11, 12, 'xyz', None, 1, 'float32', [0.3189, 0.3192]),
    ('13q k=2 B=1', 13, 2, 'xyz', None, 1, 'float32', [2.9874, 3.0069]),
    ('custom 10q k=9 B=4', 10, 9, 'xyz', None, 4, 'float32',
     [0.2734, 0.2737]),
    ('modulo 9q k=4 B=4', 9, 4, 'xyz', None, 4, 'float32', [0.0440, 0.0444]),
    ('13q column k=48 B=8', 13, 48, 'xyz', 0, 8, 'float32',
     [0.2193, 0.2196]),
    ('14q column k=28 B=8', 14, 28, 'xyz', 0, 8, 'float32',
     [0.1690, 0.1691]),
    ('15q column k=30 B=8', 15, 30, 'xyz', 0, 8, 'float32',
     [0.1907, 0.1908]),
    ('16q column k=32 B=4', 16, 32, 'xyz', 0, 4, 'float32',
     [0.2124, 0.2125]),
    ('17q column k=34 B=4', 17, 34, 'xyz', 0, 4, 'float32',
     [0.2981, 0.3305, 0.2402, 0.2403]),
    ('3q k=12 B=1024', 3, 12, 'xyz', None, 1024, 'float64', [0.0346]),
    ('5q k=20 B=2048', 5, 20, 'xyz', None, 2048, 'float64',
     [0.3727, 0.3812]),
    ('8q k=16 B=16', 8, 16, 'xyz', None, 16, 'float64', [0.2512, 0.2515]),
    ('custom 8q k=9 B=8', 8, 9, 'xyz', None, 8, 'float64',
     [0.1180, 0.1181]),
    ('9q k=10 B=4', 9, 10, 'xyz', None, 4, 'float64', [0.1290, 0.1291]),
    ('10q k=12 B=2', 10, 12, 'xyz', None, 2, 'float64', [0.2971, 0.2972]),
    ('11q k=12 B=1', 11, 12, 'xyz', None, 1, 'float64', [0.6086, 0.6103]),
    ('12q k=2 B=1', 12, 2, 'xyz', None, 1, 'float64', [1.3468]),
    ('custom 9q k=8 B=8', 9, 8, 'xyz', None, 8, 'float64',
     [0.2353, 0.2357]),
    ('modulo 9q k=4 B=4', 9, 4, 'xyz', None, 4, 'float64', [0.0860, 0.0863]),
    ('13q column k=26 B=4', 13, 26, 'xyz', 0, 4, 'float64',
     [0.1464, 0.1465]),
    ('16q column k=32 B=2', 16, 32, 'xyz', 0, 2, 'float64',
     [0.4222, 0.4239, 0.2154, 0.2156]),
    # the global row tiles: PR 21's kernels, then PR 22's (unitary_ab.py
    # --global in turns, PR 22)
    ('18q column k=17 B=4', 18, 17, 'xyz', 0, 4, 'float32',
     [0.2378, 0.2380, 0.0921, 0.0920]),
    ('20q column k=19 B=4', 20, 19, 'xyz', 0, 4, 'float32',
     [1.2588, 1.2594, 0.3463, 0.3464]),
    ('20q random column k=40 B=2', 20, 40, 'xyz', 0, 2, 'float32',
     [0.9903, 0.9904, 0.4227, 0.4226, 0.4056, 0.4058]),
    ('24q column k=2 B=2', 24, 2, 'xyz', 0, 2, 'float32',
     [6.6935, 0.4527]),
    ('17q column k=16 B=4', 17, 16, 'xyz', 0, 4, 'float64',
     [0.1970, 0.1971, 0.0842, 0.0840]),
    ('18q column k=17 B=4', 18, 17, 'xyz', 0, 4, 'float64',
     [0.4907, 0.4904, 0.1619, 0.1622]),
    ('19q column k=18 B=2', 19, 18, 'xyz', 0, 2, 'float64',
     [0.5150, 0.5139, 0.1743, 0.1696]),
    ('19q random column k=38 B=2', 19, 38, 'xyz', 0, 2, 'float64',
     [0.7980, 0.7992, 0.3389, 0.3457]),
    ('23q column k=2 B=2', 23, 2, 'xyz', 0, 2, 'float64',
     [5.6151, 5.6132, 0.4878, 0.4876]),
]

# forward passes of the global row tiles: (label, n, blocks, rotations, B,
# dtype, times): PR 21's kernels, then PR 22's (unitary_ab.py --global in
# turns, PR 22); their count did not change
FORWARDS = [
    ('20q column k=19 B=4', 20, 19, 'xyz', 4, 'float32',
     [0.3314, 0.3318, 0.1274, 0.1263]),
    ('20q random column k=40 B=2', 20, 40, 'xyz', 2, 'float32',
     [0.4332, 0.4337, 0.1391, 0.1386]),
    ('24q column k=2 B=2', 24, 2, 'xyz', 2, 'float32',
     [0.9539, 0.9549, 0.2372, 0.2373]),
    ('18q column k=17 B=4', 18, 17, 'xyz', 4, 'float64',
     [0.1243, 0.1247, 0.0570, 0.0569]),
    ('19q column k=18 B=2', 19, 18, 'xyz', 2, 'float64',
     [0.1286, 0.1286, 0.0585, 0.0585]),
    ('19q random column k=38 B=2', 19, 38, 'xyz', 2, 'float64',
     [0.2685, 0.2854, 0.1238, 0.1241, 0.1259, 0.1263]),
    ('23q column k=2 B=2', 23, 2, 'xyz', 2, 'float64',
     [0.7434, 0.7432, 0.2033, 0.2027]),
]


def _pick(t_ops, t_bytes):
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')


def sweep_row(n, nb, rot, ent, kind, wires, B, T, dtype):
    """(bound ms, by) now and the bound ms before (the surface round as n
    gate passes and n adjoint steps, 58 n an amplitude)."""
    work = prof.sweep_work(n, nb, rot, ent, kind, wires, dtype)
    now = prof.bound_ms(work, B, T)
    old = dict(work, needed=work['needed'] + (58 * n - 22) * work['target'])
    return now, prof.bound_ms(old, B, T)[0]


def vjp_row(n, nb, rot, log_c, B, dtype):
    """(bound ms, by) of the vjp now, and its bound ms before (n adjoint
    steps of 44 operations an amplitude for the surface round)."""
    work = prof.unitary_work(n, nb, rot, log_c=log_c, dtype=dtype)
    now = prof.unitary_bound_ms(work['vjp'], work['vjp_bytes'], B, dtype)
    old = prof.unitary_bound_ms(work['vjp'] + (44 * n - 16) * work['amps'],
                                work['vjp_bytes'], B, dtype)[0]
    return now, old


def main() -> int:
    for label, n, nb, rot, ent, kind, wires, B, T, dtype, times in SWEEPS:
        (ms, by), old = sweep_row(n, nb, rot, ent, kind, wires, B, T, dtype)
        print(f'sweep {label} {dtype}: bound {ms:.3f} ms by {by} (before '
              f'{old:.3f}); shares ' + ', '.join(
                  f'{t} ms {ms / t:.2%}' for t in times))
    for label, n, nb, rot, B, dtype, times in FORWARDS:
        work = prof.unitary_work(n, nb, rot, log_c=0, dtype=dtype)
        ms, by = prof.unitary_bound_ms(work['forward'],
                                       work['forward_bytes'], B, dtype)
        print(f'forward {label} {dtype}: bound {ms:.4f} ms by {by}; '
              f'shares ' + ', '.join(f'{t} ms {ms / t:.2%}' for t in times))
    for label, n, nb, rot, log_c, B, dtype, times in VJPS:
        (ms, by), old = vjp_row(n, nb, rot, log_c, B, dtype)
        print(f'vjp {label} {dtype}: bound {ms:.4f} ms by {by} (before '
              f'{old:.4f}); shares ' + ', '.join(
                  f'{t} ms {ms / t:.2%}' for t in times))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())

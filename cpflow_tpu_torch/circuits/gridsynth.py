"""Ross-Selinger-style exact synthesis of Rz rotations over Clifford+T.

Replaces the Solovay-Kitaev fallback for angles that are not multiples of
pi/4 (reference path: qiskit-fork SolovayKitaevDecomposition,
exact_decompositions.py:261-269). Three stages, all exact integer
arithmetic over the rings in rings.py:

  1. Grid search: find u in Z[w] with u / sqrt2^k inside an eps-box around
     exp(-i theta/2), subject to the bullet-embedding bound |u^bullet| <=
     sqrt2^k. Enumeration is the 1D two-embedding interval walk per
     coordinate — O(sqrt2^k) vectorized numpy work per denominator
     exponent k, with k growing until a candidate admits a solution.
  2. Diophantine: solve t t^dag = 2^k - |u|^2 in Z[w] by factoring the
     rational norm and splitting each prime class (p = 2, p mod 8 in
     {1,3,5,7}) via Euclidean gcds in Z[w] / Z[sqrt2] and square roots
     mod p. Unsolvable candidates are skipped (expected O(log) tries).
  3. Exact synthesis: the matrix [[u, -t^dag],[t, u^dag]] / sqrt2^k is a
     det-1 Clifford+T unitary; column reduction by H T^-m factors
     (Kliuchnikov-Maslov-Mosca) emits the gate word, T-count ~ 2k.

Result: Rz(theta) to distance eps with T-count ~ 4 log2(1/eps), minutes-free
(milliseconds at eps ~ 1e-5), versus the BFS-table Solovay-Kitaev whose
word length explodes past eps ~ 1e-2.
"""

from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np

from cpflow_tpu_torch.circuits.rings import (DELTA, LAMBDA, OMEGA, ZOmega,
                                             ZRt2, factorize, sqrt_mod)

_SQRT2 = math.sqrt(2.0)

# --------------------------------------------------------------------------
# Fixed-point scalars for the exact acceptance test
#
# The accept criterion is dist^2 = 1 - Re(conj(z) u)/R <= eps^2 with
# 1 - re ~ eps^2: below eps ~ 1e-8 that subtraction is pure float64 noise
# (the float64 "eps floor"). Candidates u are exact ring elements and theta
# is an exact double, so the criterion is decidable exactly: evaluate it in
# 256-bit fixed point with cos/sin from an exact-Fraction Taylor series.
# Float64 stays only in the *enumeration* (where all slop is widened, and
# false inclusions are rejected here or by the exact bullet-embedding check
# in solve_norm_equation).
# --------------------------------------------------------------------------

_PREC = 256
_ONE = 1 << _PREC
_SQRT2_FP = math.isqrt(2 << (2 * _PREC))
_INV_SQRT2_FP = math.isqrt((1 << (2 * _PREC)) // 2)


@functools.lru_cache(maxsize=256)
def _cos_sin_fp(theta_half: float) -> Tuple[int, int]:
    """(cos, sin) of the exact double theta_half as PREC-bit fixed point
    (absolute error < 2^-(PREC-2)); exact-Fraction Taylor, |x| <= pi."""
    x = Fraction(theta_half)
    x2 = x * x
    tol = Fraction(1, 1 << (_PREC + 16))
    c, term, n = Fraction(1), Fraction(1), 0
    while True:
        n += 2
        term = -term * x2 / (n * (n - 1))
        c += term
        if abs(term) < tol:
            break
    s, term, n = x, x, 1
    while True:
        n += 2
        term = -term * x2 / (n * (n - 1))
        s += term
        if abs(term) < tol:
            break
    return int(c * _ONE), int(s * _ONE)


def _re_im_fp(u: ZOmega) -> Tuple[int, int]:
    """(Re u, Im u) in PREC-bit fixed point (u = a + b w + c w^2 + d w^3:
    Re = a + (b - d)/sqrt2, Im = c + (b + d)/sqrt2)."""
    a, b, c, d = u.a
    return (a * _ONE + (b - d) * _INV_SQRT2_FP,
            c * _ONE + (b + d) * _INV_SQRT2_FP)


def _dist2_fp(u: ZOmega, k: int, cos_fp: int, sin_fp: int) -> int:
    """dist^2 * 2^PREC for the Rz approximation u/sqrt2^k, where
    dist^2 = 1 - Re(conj(z) u)/R, z = exp(-i theta/2), R = sqrt2^k."""
    reu, imu = _re_im_fp(u)
    re_fp = (cos_fp * reu - sin_fp * imu) >> _PREC
    r_fp = (_ONE << (k // 2)) if k % 2 == 0 else (_SQRT2_FP << (k // 2))
    return _ONE - (re_fp << _PREC) // r_fp


# --------------------------------------------------------------------------
# Double-double (two-float) vectorized arithmetic for the enumeration
#
# The sliver band has radial depth eps^2 R / 2; float64 endpoint noise is
# ~1e-16 R. Below eps ~ 1e-8 the noise band dwarfs the true band, so a
# float64 enumeration either loses every true candidate (tight pads) or
# drowns in noise-band junk (safe pads). Two-float arithmetic gives ~1e-32
# relative endpoints — resolving the true band down to eps ~ 1e-13 — while
# staying fully vectorized numpy. Dekker/Knuth error-free transforms,
# no FMA assumed.
# --------------------------------------------------------------------------

_SPLIT = 134217729.0  # 2^27 + 1


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _quick_two_sum(a, b):  # requires |a| >= |b| elementwise
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b):
    p = a * b
    ca = _SPLIT * a
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = _SPLIT * b
    bhi = cb - (cb - b)
    blo = b - bhi
    return p, ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo


def _dd_add(x, y):
    s, e = _two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return _quick_two_sum(s, e)


def _dd_sub(x, y):
    return _dd_add(x, (-y[0], -y[1]))


def _dd_mul(x, y):
    p, e = _two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    return _quick_two_sum(p, e)


def _dd_mul_f(x, f):
    """dd times plain float64."""
    p, e = _two_prod(x[0], f)
    e = e + x[1] * f
    return _quick_two_sum(p, e)


def _dd_div(x, y):
    q1 = x[0] / y[0]
    r = _dd_sub(x, _dd_mul_f(y, q1))
    q2 = r[0] / y[0]
    return _quick_two_sum(q1, q2)


def _dd_sqrt(x):
    """sqrt of a nonnegative dd (one Newton step from float64 sqrt)."""
    y = np.sqrt(np.maximum(x[0], 0.0))
    p, e = _two_prod(y, y)
    r = _dd_add(_dd_sub(x, (p, e)), (0.0, 0.0))
    denom = np.where(y > 0, 2.0 * y, 1.0)
    return _quick_two_sum(y, r[0] / denom)


def _dd_max(x, y):
    c = (x[0] > y[0]) | ((x[0] == y[0]) & (x[1] >= y[1]))
    return np.where(c, x[0], y[0]), np.where(c, x[1], y[1])


def _dd_min(x, y):
    c = (x[0] < y[0]) | ((x[0] == y[0]) & (x[1] <= y[1]))
    return np.where(c, x[0], y[0]), np.where(c, x[1], y[1])


def _dd_from_fraction(f: Fraction):
    hi = float(f)
    lo = float(f - Fraction(hi))
    return hi, lo


def _dd_floor_i64(x):
    """Elementwise floor of a dd as exact int64 (|value| < 2^62)."""
    base = np.floor(x[0])
    frac = (x[0] - base) + x[1]
    return base.astype(np.int64) + np.floor(frac).astype(np.int64)


def _dd_ceil_i64(x):
    base = np.ceil(x[0])
    frac = (x[0] - base) + x[1]
    return base.astype(np.int64) + np.ceil(frac).astype(np.int64)


def _dd_floor_int(x) -> int:
    """Floor of a scalar dd as an exact Python int — no magnitude limit:
    a dd pair (hi, lo) represents integers exactly up to ~2^106, because
    hi carries the high bits (an exact float64, ulp(hi) > 1 once
    hi > 2^53) and lo the low bits."""
    base = math.floor(float(x[0]))
    frac = (float(x[0]) - base) + float(x[1])
    return base + math.floor(frac)


def _dd_ceil_int(x) -> int:
    base = math.ceil(float(x[0]))
    frac = (float(x[0]) - base) + float(x[1])
    return base + math.ceil(frac)


_DD_INV_SQRT2 = _dd_from_fraction(Fraction(_INV_SQRT2_FP, _ONE))
_DD_SQRT2 = _dd_from_fraction(Fraction(_SQRT2_FP, _ONE))


# --------------------------------------------------------------------------
# Stage 1: grid candidates
# --------------------------------------------------------------------------

_LOG_LAMBDA = math.log(1.0 + _SQRT2)


_EMPTY = (np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))


def _solve_zrt2_intervals(A: float, B: float, C: float, D: float,
                          cap: int = 200_000
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """All (m, n) in Z^2 with  m + n sqrt2 in [A, B]  and
    m - n sqrt2 in [C, D], as a pair of aligned arrays (m_arr, n_arr)
    (int64, or object dtype when the reconstruction products overflow).

    The naive scan costs O(max(widths)); rescaling by the fundamental unit
    lambda = 1 + sqrt2 (an automorphism of the lattice that stretches one
    embedding by lambda and shrinks the other by 1/lambda) equalizes the two
    intervals first, so the scan costs O(sqrt(w W)) — the 1D grid-problem
    trick from the Ross-Selinger synthesis paper."""
    w, W = B - A, D - C
    if w <= 0 or W <= 0:
        return _EMPTY
    # v = lambda^j vt widens [A,B] by lambda^-j and shrinks [C,D] by
    # lambda^j (|lambda_bullet| = 1/lambda): equal widths at
    # lambda^(2j) = w/W
    j = int(math.floor(0.5 * math.log(w / W) / _LOG_LAMBDA + 0.5))

    lam_j = LAMBDA ** j if j >= 0 else ZRt2(-1, 1) ** (-j)  # exact lambda^j
    # scale factors in log space: the exact coefficients of lambda^j are
    # exponentially large and catastrophically cancel in float
    lj = math.exp(j * _LOG_LAMBDA)
    lbj = math.exp(-j * _LOG_LAMBDA) * (1.0 if j % 2 == 0 else -1.0)
    # v = lambda^j vt: vt in [A,B]/lambda^j; vt_bullet in [C,D]/lambda_bullet^j
    A2, B2 = A / lj, B / lj
    if A2 > B2:
        A2, B2 = B2, A2
    C2, D2 = C / lbj, D / lbj
    if C2 > D2:
        C2, D2 = D2, C2

    m_lo = math.floor((A2 + C2) / 2.0) - 1
    m_hi = math.ceil((B2 + D2) / 2.0) + 1
    if m_hi - m_lo > cap:
        return _EMPTY
    if max(abs(m_lo), abs(m_hi)) > 2 ** 52:
        # the arange below cannot represent consecutive integers beyond
        # float53; enumerating would silently skip lattice points. Bail
        # (completeness loss only — acceptance stays exact downstream);
        # gridsynth_rz's eps floor keeps workloads away from this wall.
        return _EMPTY
    ms = np.arange(m_lo, m_hi + 1, dtype=np.float64)
    # scale-aware slop: endpoint magnitudes reach ~sqrt2 R (R = sqrt2^k, so
    # ulp ~ 4e-9 at k = 50); widening only ADDS boundary candidates, which
    # the exact acceptance / bullet checks reject downstream
    tol = 1e-9 + 4e-15 * max(abs(A2), abs(B2), abs(C2), abs(D2))
    n_lo = np.ceil(np.maximum(A2 - ms, ms - D2) / _SQRT2 - tol)
    n_hi = np.floor(np.minimum(B2 - ms, ms - C2) / _SQRT2 + tol)
    ok = np.nonzero(n_lo <= n_hi)[0]
    if len(ok) == 0:
        return _EMPTY
    La, Lb = lam_j.a, lam_j.b  # raw-int reconstruct (ZRt2 mult per point
    # costs ~30x in object overhead on the hot enumeration path)

    cnt = (n_hi[ok] - n_lo[ok] + 1).astype(np.int64)
    tot = int(cnt.sum())
    if tot > cap:
        return _EMPTY
    starts = np.cumsum(cnt) - cnt
    # (outer point, n) flat expansion
    scale = max(abs(La), 2 * abs(Lb), 1) * (
        float(np.abs(ms[ok]).max()) + float(np.abs(n_hi[ok]).max())
        + float(np.abs(n_lo[ok]).max()) + 2.0)
    mt_v = np.repeat(ms[ok].astype(np.int64), cnt)
    nt_v = (np.arange(tot) - np.repeat(starts, cnt)
            + np.repeat(n_lo[ok].astype(np.int64), cnt))
    if scale < 2 ** 61:
        # products provably fit int64: fully vectorized (the outer call at
        # eps ~ 1e-10 visits ~10^6 lattice points per k)
        return (La * mt_v + 2 * Lb * nt_v, La * nt_v + Lb * mt_v)

    # reconstruction products overflow int64 (eps below ~3e-11): same
    # expansion through object (Python-int) arrays — exact at any size,
    # elementwise-C rather than a Python double loop. The equalized
    # coordinates themselves still fit int64 (they are bounded by the
    # arange above; _grid_candidates guards the float53 wall upstream).
    mt_o = mt_v.astype(object)
    nt_o = nt_v.astype(object)
    # back to the original frame: (m + n sqrt2) = lambda^j (mt + nt sqrt2)
    return (La * mt_o + 2 * Lb * nt_o, La * nt_o + Lb * mt_o)


def _grid_candidates(theta: float, eps: float, k: int,
                     max_candidates: int = 64) -> List[ZOmega]:
    """u in Z[w] with u / sqrt2^k in the eps-sliver around exp(-i theta/2)
    (phase-invariant distance <= eps) and the bullet embedding inside the
    radius-sqrt2^k disc, best-first.

    Enumerates the axis whose sliver extent is smaller as the outer loop
    (the tangential extent is ~eps R along the direction perpendicular to
    z, so the outer axis is the one z mostly points along), then solves the
    inner axis exactly per outer point. Z[w] coordinates: u = a + b w +
    c w^2 + d w^3 has Re = a + (b - d)/sqrt2, Im = c + (b + d)/sqrt2 with
    (b - d) = alpha, (b + d) = beta, alpha = beta mod 2.
    """
    R = _SQRT2 ** k
    zx, zy = math.cos(theta / 2.0), -math.sin(theta / 2.0)
    cos_fp, sin_fp = _cos_sin_fp(theta / 2.0)
    eps2_fp = int(Fraction(eps) * Fraction(eps) * _ONE) + 1

    swap = abs(zy) > abs(zx)  # outer axis must have |z component| >= 1/sqrt2
    if swap:
        zx, zy = zy, zx

    # outer extent: cap corners sit at x = zx R (1 - eps^2/2) +-
    # |zy| R sqrt(eps^2 - eps^4/4), so the x-extent is |zy| eps R + O(eps^2 R)
    # (NOT ~eps R: the tangent direction has x-component |zy|); pad by the
    # float64 noise floor of the outer lattice solve
    span = 1.05 * abs(zy) * eps * R + 2.0 * eps * eps * R + 8e-16 * R
    lo, hi = zx * R - span, zx * R + span
    lo = max(lo, -R)
    hi = min(hi, R)

    # outer axis lattice: x = a + alpha/sqrt2 -> sqrt2 x = alpha + a sqrt2;
    # bullet: sqrt2 x_bullet = -(alpha - a sqrt2) -> alpha - a sqrt2 in
    # -sqrt2 [-R, R] = [-sqrt2 R, sqrt2 R]
    s2R = _SQRT2 * R
    alpha_raw, a_raw = _solve_zrt2_intervals(_SQRT2 * lo, _SQRT2 * hi,
                                             -s2R, s2R, cap=30_000_000)
    if len(alpha_raw) == 0:
        return []

    # ---- vectorized inner stage (double-double precision) ----------------
    # One pass over ALL outer points at once. The y-band depth is
    # eps^2 R / 2 — far below the float64 noise floor of ~1e-16 R once
    # eps < 1e-8 — so the interval geometry runs in two-float (dd)
    # arithmetic (~1e-32 relative). All slop still only widens; membership
    # authority is the exact integer accept at the end.
    alpha_f = alpha_raw.astype(np.float64)
    a_f = a_raw.astype(np.float64)
    zero = np.zeros_like(alpha_f)

    f_sqrt2 = Fraction(_SQRT2_FP, _ONE)
    f_zx, f_zy = Fraction(cos_fp, _ONE), -Fraction(sin_fp, _ONE)
    if swap:
        f_zx, f_zy = f_zy, f_zx
    zx_dd = _dd_from_fraction(f_zx)
    zy_dd = _dd_from_fraction(f_zy)
    f_R = (1 << (k // 2)) * (f_sqrt2 if k % 2 else Fraction(1))
    c1_dd = _dd_from_fraction(f_R * (1 - Fraction(eps) ** 2 / 2))
    R2 = float(1 << k)  # exact
    pad_dd = (1e-30 * R, 0.0)

    ax = _dd_mul_f(_DD_INV_SQRT2, alpha_f)          # alpha / sqrt2
    x_dd = _dd_add((a_f, zero), ax)
    xb_dd = _dd_sub((a_f, zero), ax)

    rad2_dd = _dd_sub((R2, 0.0), _dd_mul(x_dd, x_dd))
    valid = rad2_dd[0] > 0
    rad_dd = _dd_sqrt((np.maximum(rad2_dd[0], 0.0),
                       np.where(valid, rad2_dd[1], 0.0)))
    thresh_dd = _dd_div(_dd_sub(c1_dd, _dd_mul(x_dd, zx_dd)), zy_dd)
    neg_rad = (-rad_dd[0], -rad_dd[1])
    if zy > 0:
        y_lo_dd = _dd_max(_dd_sub(thresh_dd, pad_dd), _dd_sub(neg_rad, pad_dd))
        y_hi_dd = _dd_add(rad_dd, pad_dd)
    else:
        y_lo_dd = _dd_sub(neg_rad, pad_dd)
        y_hi_dd = _dd_min(_dd_add(thresh_dd, pad_dd), _dd_add(rad_dd, pad_dd))

    yb2_dd = _dd_sub((R2, 0.0), _dd_mul(xb_dd, xb_dd))
    yb_dd = _dd_sqrt((np.maximum(yb2_dd[0], 0.0),
                      np.where(yb2_dd[0] > 0, yb2_dd[1], 0.0)))

    p_arr = (alpha_raw.astype(np.int64) & 1).astype(np.float64) \
        if alpha_raw.dtype != object else \
        np.array([int(v) & 1 for v in alpha_raw], dtype=np.float64)
    sh_dd = _dd_mul_f(_DD_INV_SQRT2, p_arr)
    # y = c + (2 n + p)/sqrt2: solve yt = y - sh = c + n sqrt2 with
    # yt in [Ai, Bi], yt_bullet in [Ci, Di]
    Ai = _dd_sub(y_lo_dd, sh_dd)
    Bi = _dd_sub(y_hi_dd, sh_dd)
    Ci = _dd_add((-yb_dd[0], -yb_dd[1]), sh_dd)
    Di = _dd_add(yb_dd, sh_dd)
    w_i = _dd_sub(Bi, Ai)[0]
    W_i = _dd_sub(Di, Ci)[0]
    valid &= (w_i > 0) & (W_i > 0)
    if not valid.any():
        return []

    # per-point lambda-rescale (cf. _solve_zrt2_intervals), dd divisors
    # built from the EXACT lambda^j ring coefficients so the rescaled
    # intervals stay consistent with the exact reconstruction map
    with np.errstate(divide='ignore', invalid='ignore'):
        j_i = np.floor(0.5 * np.log(np.where(valid, w_i / W_i, 1.0))
                       / _LOG_LAMBDA + 0.5)
    j_i = np.clip(j_i, -60, 60)
    lam_pows: dict = {}
    lam_tab: dict = {}
    for jj in np.unique(j_i[valid]).astype(np.int64):
        jj = int(jj)
        zr = LAMBDA ** jj if jj >= 0 else ZRt2(-1, 1) ** (-jj)
        lam_pows[jj] = zr
        v = Fraction(zr.a) + Fraction(zr.b) * f_sqrt2
        vb = Fraction(zr.a) - Fraction(zr.b) * f_sqrt2
        lam_tab[jj] = (_dd_from_fraction(v), _dd_from_fraction(vb))
    lam_hi = np.ones_like(w_i)
    lam_lo = np.zeros_like(w_i)
    lamb_hi = np.ones_like(w_i)
    lamb_lo = np.zeros_like(w_i)
    for jj, ((vh, vl), (bh, bl)) in lam_tab.items():
        m = (j_i == jj) & valid
        lam_hi[m] = vh
        lam_lo[m] = vl
        lamb_hi[m] = bh
        lamb_lo[m] = bl

    A2 = _dd_div(Ai, (lam_hi, lam_lo))
    B2 = _dd_div(Bi, (lam_hi, lam_lo))
    C2 = _dd_div(Ci, (lamb_hi, lamb_lo))
    D2 = _dd_div(Di, (lamb_hi, lamb_lo))
    C2, D2 = _dd_min(C2, D2), _dd_max(C2, D2)

    # int64-representability split: rows whose equalized coordinates fit
    # int64 take the vectorized walk below; wider rows (eps under ~3e-11
    # pushes coordinates past 2^62) take an exact Python-int scalar walk
    # after it — dd endpoint pairs represent integers exactly to ~2^106,
    # so enumeration stays exact far below the old int64 floor.
    big = np.maximum(np.abs(A2[0]), np.abs(B2[0]))
    big = np.maximum(big, np.maximum(np.abs(C2[0]), np.abs(D2[0])))
    valid &= np.isfinite(big)
    if not valid.any():
        return []
    fits64 = valid & (big < 4.0e18)
    over = valid & ~fits64
    for arr in (A2, B2, C2, D2):
        arr[0][~valid] = 0.0
        arr[1][~valid] = 0.0

    # ---- equalized-frame lattice walk (int64 + dd residuals) -------------
    # Equalized coordinates reach ~sqrt(W/w) ~ R/eps, far beyond float64's
    # 2^53 exact-integer range at eps <= 1e-9 (a float mt quantizes to
    # multiples of 64, inflating every n-window by that much). So: lattice
    # coordinates live in int64 (exact to 9.2e18), and interval residuals
    # are dd values around the per-point integer center m0.
    m_ctr = _dd_mul_f(_dd_add(A2, C2), 0.5)
    ctr_hi = np.where(valid, m_ctr[0], 0.0)
    ctr_lo = np.where(valid, m_ctr[1], 0.0)
    # nearest-integer center as an EXACT dd pair (+-1 slop absorbed by the
    # dm range below): both words round to integer-valued floats, so
    # hi + lo is an exact integer of ANY magnitude — overflow rows carry
    # centers far past 2^62, so no int64 cast happens here
    m0_dd = _quick_two_sum(np.round(ctr_hi), np.round(ctr_lo))

    w2 = _dd_sub(B2, A2)[0]
    W2 = _dd_sub(D2, C2)[0]
    half_w = np.where(valid, np.ceil((w2 + W2) / 2.0) + 2, -1)
    dmax = int(min(np.max(half_w, initial=0), 16))

    scored: List[Tuple[int, ZOmega]] = []
    two_k = 1 << k
    tolr = 1e-9
    inv_s2_dd = _DD_INV_SQRT2
    hits: List[Tuple[int, int, int, int]] = []  # (i, mt, n_lo, n_hi)
    for dm in range(-dmax, dmax + 1):
        mt_dd = (m0_dd[0], m0_dd[1] + dm)
        nA = _dd_mul(_dd_sub(A2, mt_dd), inv_s2_dd)
        nB = _dd_mul(_dd_sub(B2, mt_dd), inv_s2_dd)
        nC = _dd_mul(_dd_sub(C2, mt_dd), inv_s2_dd)
        nD = _dd_mul(_dd_sub(D2, mt_dd), inv_s2_dd)
        low = _dd_max(nA, (-nD[0], -nD[1]))
        upp = _dd_min(nB, (-nC[0], -nC[1]))
        # rows within int64: exact vectorized ceil/floor (cast garbage on
        # overflow rows is masked out by sel and silenced here)
        with np.errstate(invalid='ignore'):
            n_lo64 = _dd_ceil_i64(_dd_add(low, (-tolr, 0.0)))
            n_hi64 = _dd_floor_i64(_dd_add(upp, (tolr, 0.0)))
        in_band = np.abs(dm) <= half_w
        sel = np.nonzero(fits64 & in_band & (n_lo64 <= n_hi64))[0]
        for i in sel:
            hits.append((int(i), int(m0_dd[0][i]) + int(m0_dd[1][i]) + dm,
                         int(n_lo64[i]), int(n_hi64[i])))
        if not over.any():
            continue
        # overflow rows (coordinates past 2^62; the norm below eps ~3e-11):
        # the dd interval math above is magnitude-agnostic, so only the
        # integer window bounds need exact handling — pre-filter rows whose
        # window could contain an integer, then drop to Python ints for
        # just those few (actual hits are O(candidates))
        gap_ok = _dd_sub(upp, low)[0] >= -0.5
        for i in np.nonzero(over & in_band & gap_ok)[0]:
            i = int(i)
            n_lo_i = _dd_ceil_int(_dd_add(
                (float(low[0][i]), float(low[1][i])), (-tolr, 0.0)))
            n_hi_i = _dd_floor_int(_dd_add(
                (float(upp[0][i]), float(upp[1][i])), (tolr, 0.0)))
            if n_lo_i <= n_hi_i:
                hits.append((i, int(m0_dd[0][i]) + int(m0_dd[1][i]) + dm,
                             n_lo_i, n_hi_i))

    # survivors are O(candidates): reconstruct exactly and accept exactly
    for (i, mt_f, nlo, nhi) in hits:
        if nhi - nlo > 64:  # no legitimate row spans more than a few n
            continue
        jj = int(j_i[i])
        La, Lb = lam_pows[jj].a, lam_pows[jj].b
        alpha, a = int(alpha_raw[i]), int(a_raw[i])
        p = alpha & 1
        for nt in range(nlo, nhi + 1):
            c = La * mt_f + 2 * Lb * nt
            nb = La * nt + Lb * mt_f
            beta = 2 * nb + p
            a1 = (alpha + beta) // 2
            a3 = (beta - alpha) // 2
            u0, u1, u2, u3 = ((a, a1, c, a3) if not swap
                              else (c, a1, a, -a3))
            # exact accept, both parts integer-decided (float64 cannot
            # resolve 1 - re ~ eps^2 nor |u| <= R to relative eps^2 below
            # eps ~ 1e-8):
            #  (a) xi = 2^k - |u|^2 >= 0 in both embeddings — points a
            #      float-ulp OUTSIDE the disc have dist^2 < 0 and would
            #      otherwise sort first and crowd out every true candidate;
            #  (b) dist^2 <= eps^2 in 256-bit fixed point.
            # |u|^2 = s1 + s2 sqrt2 (raw ints: ~10x less object overhead)
            s1 = u0 * u0 + u1 * u1 + u2 * u2 + u3 * u3
            s2 = u1 * (u0 + u2) + u3 * (u2 - u0)
            if not (_nonneg(two_k - s1, -s2) and _nonneg(two_k - s1, s2)):
                continue
            zo = ZOmega(u0, u1, u2, u3)
            d2 = _dist2_fp(zo, k, cos_fp, sin_fp)
            if d2 <= eps2_fp:
                scored.append((d2, zo))
    scored.sort(key=lambda s: s[0])
    return [z for _, z in scored[:max_candidates]]


def _nonneg(a: int, b: int) -> bool:
    """Exact a + b sqrt2 >= 0 (cf. ZRt2.is_nonneg, without the object)."""
    if a >= 0:
        return b >= 0 or a * a >= 2 * b * b
    return b > 0 and 2 * b * b >= a * a


# --------------------------------------------------------------------------
# Stage 2: the norm equation t t^dag = xi over Z[w]
# --------------------------------------------------------------------------

def _zrt2_multiplicity(xi: ZRt2, pi: ZRt2) -> Tuple[int, ZRt2]:
    e = 0
    while True:
        q = pi.divides_exactly(xi)
        if q is None:
            return e, xi
        e += 1
        xi = q


def _tau_for_prime(p: int) -> Optional[ZOmega]:
    """tau in Z[w] with |N(tau)| = p, for p inert in Z[sqrt2]
    (p mod 8 in {3, 5})."""
    if p % 8 == 5:
        h = sqrt_mod(-1, p)
        if h is None:
            return None
        tau = ZOmega(p).gcd(ZOmega(h, 0, 1, 0))      # gcd(p, h + i)
    else:  # p % 8 == 3
        h = sqrt_mod(-2, p)
        if h is None:
            return None
        tau = ZOmega(p).gcd(ZOmega(h, 1, 0, 1))      # gcd(p, h + sqrt(-2))
    return tau if tau.norm_int() == p else None


def _tau_for_split_prime(pi: ZRt2, p: int) -> Optional[ZOmega]:
    """tau with tau tau^dag ~ pi (up to Z[sqrt2] unit), for N(pi) = +-p,
    p = 1 mod 8 (p splits completely in Z[w])."""
    h = sqrt_mod(-1, p)
    if h is None:
        return None
    for cand in (ZOmega(h, 0, 1, 0), ZOmega(h, 0, -1, 0)):
        tau = pi.to_zomega().gcd(cand)
        if abs(tau.norm_int()) == p:
            return tau
    return None


def solve_norm_equation(xi: ZRt2) -> Optional[ZOmega]:
    """t in Z[w] with t t^dag = xi, or None. Requires xi >= 0 in both
    embeddings (checked)."""
    if not xi:
        return ZOmega(0)
    if not (xi.is_nonneg() and xi.adj2().is_nonneg()):
        return None
    n = abs(xi.norm_int())
    fac = factorize(n)
    if fac is None:
        return None

    t = ZOmega(1)
    rem = xi
    for p in sorted(fac):
        if p == 2:
            e, rem = _zrt2_multiplicity(rem, ZRt2(0, 1))
            t = t * (DELTA ** e)
        elif p % 8 == 7:
            s2 = sqrt_mod(2, p)
            if s2 is None:
                return None
            pi = ZRt2(p).gcd(ZRt2(s2, -1))
            if abs(pi.norm_int()) != p:
                return None
            for piv in (pi, pi.adj2()):
                e, rem = _zrt2_multiplicity(rem, piv)
                if e % 2:
                    return None  # 7 mod 8 primes must pair up
                t = t * (piv ** (e // 2)).to_zomega()
        elif p % 8 == 1:
            s2 = sqrt_mod(2, p)
            if s2 is None:
                return None
            pi = ZRt2(p).gcd(ZRt2(s2, -1))
            if abs(pi.norm_int()) != p:
                return None
            for piv in (pi, pi.adj2()):
                e, rem = _zrt2_multiplicity(rem, piv)
                if e:
                    tau = _tau_for_split_prime(piv, p)
                    if tau is None:
                        return None
                    t = t * (tau ** e)
        else:  # p mod 8 in {3, 5}: inert in Z[sqrt2]
            e, rem = _zrt2_multiplicity(rem, ZRt2(p))
            if 2 * e != fac[p]:
                return None
            tau = _tau_for_prime(p)
            if tau is None:
                return None
            t = t * (tau ** e)

    # fix the leftover unit: xi / (t t^dag) is lambda^(2m) (positive in both
    # embeddings since xi and t t^dag are)
    q = t.norm_zrt2()
    unit = q.divides_exactly(xi)
    if unit is None:
        return None
    m = 0
    while unit != ZRt2(1):
        v = unit.value()
        if v > 1.0:
            nxt = LAMBDA.divides_exactly(unit)
            m += 1
        else:
            nxt = unit * LAMBDA
            unit = None  # replaced below
            unit = nxt
            m -= 1
            continue
        if nxt is None:
            return None
        unit = nxt
        if abs(m) > 64:
            return None
    if m % 2:
        return None
    half = m // 2
    lam_half = (LAMBDA ** half).to_zomega() if half >= 0 else None
    if half >= 0:
        t = t * lam_half
    else:
        inv = (ZRt2(-1, 1) ** (-half)).to_zomega()  # lambda^-1 = -1 + sqrt2
        t = t * inv
    return t if t.norm_zrt2() == xi else None


# --------------------------------------------------------------------------
# Stage 3: exact synthesis of the Z[w] unitary to an H/T word
# --------------------------------------------------------------------------

_TPOW_WORDS = {0: [], 1: ['t'], 2: ['s'], 3: ['s', 't']}


def _strip(u: ZOmega, t: ZOmega, k: int) -> Tuple[ZOmega, ZOmega, int]:
    """Remove sqrt2 factors common to both entries (vector sde)."""
    while k > 0:
        du, dt = u.div_sqrt2(), t.div_sqrt2()
        if du is None or dt is None:
            break
        u, t, k = du, dt, k - 1
    return u, t, k


def _ht_step(u: ZOmega, t: ZOmega, k: int, m: int
             ) -> Tuple[ZOmega, ZOmega, int]:
    """Apply H T^-m on the left: (u, t) -> ((u + w^-m t), (u - w^-m t)),
    exponent k+1, then strip."""
    wm = OMEGA ** ((-m) % 8)
    return _strip(u + wm * t, u - wm * t, k + 1)


def _find_descent(u: ZOmega, t: ZOmega, k: int, max_depth: int = 5
                  ) -> Optional[List[int]]:
    """Shortest sequence of H T^-m left-factors that strictly lowers the
    vector sde. A single greedy step is not enough: the walk sometimes needs
    a plateau move (k unchanged) before the exponent can drop, so search
    breadth-first over the 8 m-branches to a small depth."""
    frontier = [((), u, t, k)]
    seen = {(u.a, t.a)}
    for _ in range(max_depth):
        nxt = []
        for path, cu, ct, ck in frontier:
            for m in range(8):
                nu, nt, nk = _ht_step(cu, ct, ck, m)
                if nk < k:
                    return list(path) + [m]
                if nk == k:
                    key = (nu.a, nt.a)
                    if key not in seen:
                        seen.add(key)
                        nxt.append((path + (m,), nu, nt, nk))
        frontier = nxt
        if not frontier:
            break
    return None


def _reduce_column(u: ZOmega, t: ZOmega, k: int
                   ) -> Tuple[List[int], ZOmega, ZOmega, int]:
    """Left-multiply H T^-m factors until the denominator exponent hits 0.
    Returns (ms, u, t, 0) where applying H T^-m_i for each m in order
    reduces the original column to (u, t) at exponent 0."""
    u, t, k = _strip(u, t, k)
    ms: List[int] = []
    while k > 0:
        path = _find_descent(u, t, k)
        if path is None:
            raise ArithmeticError('column reduction stalled (invalid input?)')
        for m in path:
            u, t, k = _ht_step(u, t, k, m)
            ms.append(m)
        if len(ms) > 20_000:
            raise ArithmeticError('column reduction runaway')
    return ms, u, t, k


def synthesize_unitary_word(u: ZOmega, t: ZOmega, k: int) -> List[str]:
    """Gate word (circuit order: first-applied first) for
    U = [[u, -t^dag],[t, u^dag]] / sqrt2^k, exact up to global phase."""
    ms, _, _, _ = _reduce_column(u, t, k)

    # F = T^{m_1} H T^{m_2} H ... T^{m_L} H satisfies F^dag U = residual
    # Clifford; build F exactly (2x2 over Z[w], exponent = number of H's)
    fa, fb, fc, fd = ZOmega(1), ZOmega(0), ZOmega(0), ZOmega(1)
    for m in ms:
        wm = OMEGA ** (m % 8)
        # right-multiply by T^m H = [[1, 1], [w^m, -w^m]] / sqrt2
        fa, fb = fa + fb * wm, fa - fb * wm
        fc, fd = fc + fd * wm, fc - fd * wm
    e = len(ms)  # F numerator exponent

    # D = F^dag U, numerator exponent e + k, then strip to 0
    ua, ub, uc, ud = u, -t.conj(), t, u.conj()
    da = fa.conj() * ua + fc.conj() * uc
    db = fa.conj() * ub + fc.conj() * ud
    dc = fb.conj() * ua + fd.conj() * uc
    dd = fb.conj() * ub + fd.conj() * ud
    kk = e + k
    while kk > 0:
        parts = [x.div_sqrt2() for x in (da, db, dc, dd)]
        if any(p is None for p in parts):
            break
        da, db, dc, dd = parts
        kk -= 1
    assert kk == 0, 'residual is not Clifford (reduction bug)'

    tail: List[str] = []
    if not da:  # residual is antidiagonal: flip with X
        tail.append('x')
        da, dc = dc, da
        db, dd = dd, db
    assert not db and not dc, (da, db, dc, dd)
    rel = (_omega_power(dd) - _omega_power(da)) % 8
    diag_word = {0: [], 1: ['t'], 2: ['s'], 3: ['s', 't'], 4: ['z'],
                 5: ['z', 't'], 6: ['sdg'], 7: ['tdg']}[rel]

    # U = F * [X?] * diag up to global phase — application right-to-left
    gates: List[str] = list(diag_word) + tail
    for m in reversed(ms):
        gates.append('h')
        gates.extend(_TPOW_WORDS[m % 4] if m % 8 < 4
                     else ['z'] + _TPOW_WORDS[m % 4])
    return gates


def _omega_power(z: ZOmega) -> int:
    for j in range(8):
        if OMEGA ** j == z:
            return j
    raise ArithmeticError(f'{z} is not a power of omega')


# --------------------------------------------------------------------------
# Top level
# --------------------------------------------------------------------------

def gridsynth_rz(theta: float, eps: float = 1e-5, max_k: int = 120
                 ) -> Optional[List[str]]:
    """Clifford+T word for Rz(theta) to phase-invariant distance <= eps
    (circuit order), or None if no candidate solved within max_k.

    Acceptance is decided exactly (256-bit fixed point, _dist2_fp) and the
    interval geometry runs in double-double, so eps = 1e-10 synthesizes
    correctly in seconds (a float64 acceptance test walls at ~1e-7).
    Lattice coordinates that overflow int64 (below eps ~ 3e-11) fall back
    to exact Python-int walks, extending the floor to eps = 1e-12. The
    remaining wall is float53: the outer-frame scan enumerates consecutive
    integers in a float64 arange, which silently skips lattice points once
    coordinates pass 2^52 (~eps 1e-13); guarded explicitly there and
    here."""
    if eps < 1e-12:
        raise ValueError(
            f'eps={eps:g} is below the enumeration floor (1e-12): the '
            f'outer-frame scan coordinates (~R sqrt(2/eps)) pass the '
            f'float53 consecutive-integer range; see _solve_zrt2_intervals')
    theta = math.remainder(theta, 4.0 * math.pi)
    # first solutions appear when eps^3 R^4 ~ 1 (sliver area x bullet disc),
    # i.e. k ~ 1.5 log2(1/eps); starting a little low costs nothing now
    k0 = max(0, int(1.5 * math.log2(1.0 / max(eps, 1e-12))) - 4)
    for k in range(k0, max_k):
        for u in _grid_candidates(theta, eps, k):
            xi = ZRt2(2 ** k, 0) - u.norm_zrt2()
            # pre-screen: only attempt norms that factor cheaply (small
            # primes x at-most-one large prime). Candidates are plentiful
            # and ~1/ln(N) of them have prime cofactor; running Pollard rho
            # on every 100+-bit composite norm is what made eps <= 1e-8
            # take minutes.
            if not _norm_factors_easily(abs(xi.norm_int())):
                continue
            t = solve_norm_equation(xi)
            if t is None:
                continue
            word = synthesize_unitary_word(u, t, k)
            return word
    return None


def _norm_factors_easily(n: int, rho_bits: int = 56) -> bool:
    """True when n = (small primes) x (prime or < 2^rho_bits cofactor):
    exactly the cases factorize() resolves in microseconds."""
    from cpflow_tpu_torch.circuits.rings import is_prime
    if n <= 1:
        return True
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47):
        while n % p == 0:
            n //= p
    return n == 1 or n.bit_length() <= rho_bits or is_prime(n)


def word_matrix(word: List[str]) -> np.ndarray:
    """Dense matrix of a gate word in circuit order (for tests)."""
    from cpflow_tpu_torch.circuits.ir import FIXED_GATES
    m = np.eye(2, dtype=complex)
    for g in word:
        m = FIXED_GATES[g] @ m
    return m


def phase_invariant_distance(u: np.ndarray, v: np.ndarray) -> float:
    t = abs((u.conj() * v).sum()) / 2.0
    return math.sqrt(max(0.0, 1.0 - min(1.0, t)))


# --------------------------------------------------------------------------
# Exact word verification (float64 word_matrix cannot resolve dist <= 1e-8:
# 1 - |tr|/2 ~ eps^2 underflows the 2^-53 relative precision)
# --------------------------------------------------------------------------

_ZO0, _ZO1 = ZOmega(0), ZOmega(1)
# name -> ((m00, m01), (m10, m11), denominator sqrt2-exponent)
_EXACT_1Q = {
    'h': ((_ZO1, _ZO1), (_ZO1, -_ZO1), 1),
    'x': ((_ZO0, _ZO1), (_ZO1, _ZO0), 0),
    'z': ((_ZO1, _ZO0), (_ZO0, -_ZO1), 0),
    's': ((_ZO1, _ZO0), (_ZO0, OMEGA ** 2), 0),
    'sdg': ((_ZO1, _ZO0), (_ZO0, OMEGA ** 6), 0),
    't': ((_ZO1, _ZO0), (_ZO0, OMEGA), 0),
    'tdg': ((_ZO1, _ZO0), (_ZO0, OMEGA ** 7), 0),
}


def word_unitary_exact(word: List[str]):
    """Exact unitary of a Clifford+T word (circuit order): returns
    ((m00, m01), (m10, m11), k) with U = M / sqrt2^k over Z[w]."""
    (a, b), (c, d), k = (_ZO1, _ZO0), (_ZO0, _ZO1), 0
    for g in word:
        (ga, gb), (gc, gd), gk = _EXACT_1Q[g]
        a, b, c, d = (ga * a + gb * c, ga * b + gb * d,
                      gc * a + gd * c, gc * b + gd * d)
        k += gk
        if k >= 2:  # keep coefficients small: strip sqrt2^2 = 2 when possible
            parts = [x.div_sqrt2() for x in (a, b, c, d)]
            if all(p is not None for p in parts):
                a, b, c, d = parts
                k -= 1
    return (a, b), (c, d), k


def word_dist2_rz(word: List[str], theta: float) -> Fraction:
    """Exact-to-2^-256 phase-invariant distance SQUARED between the word's
    unitary and Rz(theta): dist^2 = 1 - |tr(U^dag Rz)| / 2."""
    (m00, _), (_, m11), k = word_unitary_exact(word)
    c_fp, s_fp = _cos_sin_fp(theta / 2.0)
    re0, im0 = _re_im_fp(m00)
    re3, im3 = _re_im_fp(m11)
    # tr(U^dag Rz) = [conj(m00) z + conj(m11) conj(z)] / sqrt2^k,
    # z = cos - i sin
    tr_re = ((re0 * c_fp - im0 * s_fp) + (re3 * c_fp + im3 * s_fp)) >> _PREC
    tr_im = ((-re0 * s_fp - im0 * c_fp) + (re3 * s_fp - im3 * c_fp)) >> _PREC
    abs_tr = math.isqrt(tr_re * tr_re + tr_im * tr_im)
    r_fp = (_ONE << (k // 2)) if k % 2 == 0 else (_SQRT2_FP << (k // 2))
    return Fraction(_ONE - (abs_tr << _PREC) // (2 * r_fp), _ONE)

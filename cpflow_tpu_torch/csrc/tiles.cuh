// Device code of sweep.cu's column tiles (the multi-start Adam sweep's
// port, csrc/sweep.cu, for the whole unitary past what a cluster of 16
// blocks holds): a tile's columns owned by warps.
//
// A tile holds w columns of a restart's d x d state A and cotangent M
// (d = 2^n), column-major in shared memory with a column stride of d + 1
// amplitudes (the pad keeps the block-wide passes over the tile, which walk
// the target row by row, free of bank conflicts). Every gate acts on row
// bits only, so a column never meets another under a gate: each column
// belongs to a group of gw = nw / w warps of the block's nw, which runs the
// chain and the walk on it alone, its lanes dealing out the column's
// amplitude groups, with a barrier of its own between two gates (a warp
// barrier where gw = 1, else a named barrier, bar.sync, of the group's
// 32 gw threads) and never the block's. At one column a tile the group is
// the whole block.
//
// The walk leaves each gate's cotangent share. A warp sums its lanes'
// shares by shuffles (columns.cuh's reduce_step, 31 of them for the 32
// reals of a block) and stores them in its slot of a ring in shared memory
// that holds kTileRing gates; every kTileRing gates the block meets at two
// barriers and sums the warps' slots in warp order into global memory, one
// entry a thread. The order of every sum is fixed, so that two launches on
// the same inputs give the same bits.
//
// The gate matrices reach the tile already built: one bulk copy
// (cp.async.bulk, completing on an mbarrier) brings the restart's G x 16
// complex entries from global memory, where sweep.cu's Adam kernel left
// them after its update (or its prologue kernel before the first step).
//
// What bounds it. A tile's A and M (128 KB) leave one block an SM, so the
// warps in flight are the block's: 16 in float, where 512 threads held to
// 128 registers fill the SM's registers (8 in double). The work is 4x4 and
// 2x2 complex products on shared memory, about 48 complex multiply-adds
// per amplitude group of a two-qubit gate in the walk and 16 forward, so
// the issue of the float32 (or float64) operations bounds it; the gates'
// products with the state take four fused multiply-adds a complex term
// (cmac) where cadd of cmul took six, and no block barrier or cross-warp
// sum stands between two gates.

#pragma once

#include <cstdint>
#include <type_traits>

#include "columns.cuh"

namespace {

// Threads of a tile's block, and how many of them a float build holds to
// 128 registers (512 threads fill an SM's 65,536); the double build's walk
// needs about 250 registers, so it takes 256 threads.
#ifdef CPFLOW_DOUBLE
constexpr int kTileThreads = 256;
#else
constexpr int kTileThreads = 512;
#endif
constexpr int kTileRing = 16;     // gates between two sums of the warps' slots
constexpr int kTileSegment = 32;  // tiles one segment sum adds (sweep.cu)

// Threads of a block of the tiles of 2^log_w columns (at most kTileThreads
// / 32 of them): one per 4 amplitudes, at least a warp a column, at most
// kTileThreads. From 7 qubits every lane has an amplitude group of every
// gate; below, where only very deep templates take tiles, the lanes past a
// gate's groups idle on it (tile_forward, tile_backward).
__host__ __device__ inline int tile_threads(int n, int log_w) {
  const int quarter = 1 << (n + log_w - 2), least = 32 << log_w;
  const int t = quarter > least ? quarter : least;
  return t < kTileThreads ? t : kTileThreads;
}

struct TileLayout {
  int d, w, S, nt, nw, gw, G;  // S: column stride; gw: warps a column
  size_t off_M, off_gates, off_ring, off_sw, off_bar, off_bits, bytes;
};

// The tile kernel's shared memory for G = n + nb gates and tiles of 2^log_w
// columns: A and M (w columns of d + 1 amplitudes each), the gates (16
// complex each, 16-byte aligned for the bulk copy), the ring (nw warps x
// kTileRing gates x 32 reals), each warp's share of s (2 reals), the
// mbarrier and a flag (16 bytes), each gate's two row bits (2 ints).
__host__ __device__ inline TileLayout tile_layout(int n, int nb, int log_w) {
  TileLayout L;
  L.d = 1 << n;
  L.w = 1 << log_w;
  L.S = L.d + 1;
  L.nt = tile_threads(n, log_w);
  L.nw = L.nt / 32;
  L.gw = L.nw / L.w;
  L.G = n + nb;
  size_t o = (size_t)L.w * L.S * sizeof(cplx);  // A at offset 0
  L.off_M = o;      o += (size_t)L.w * L.S * sizeof(cplx);
  o = (o + 15) & ~(size_t)15;
  L.off_gates = o;  o += (size_t)L.G * 16 * sizeof(cplx);
  L.off_ring = o;   o += (size_t)L.nw * kTileRing * 32 * sizeof(real);
  L.off_sw = o;     o += (size_t)L.nw * 2 * sizeof(real);
  L.off_bar = o;    o += 16;
  L.off_bits = o;   o += (size_t)L.G * 2 * sizeof(int);
  L.bytes = o;
  return L;
}

// ------------------------------------------------------- bulk copy
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Thread 0: makes *bar an mbarrier of one arrival, visible to the async
// proxy; the caller's barrier then publishes it to the block.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(1u)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Thread 0: arrives on *bar expecting `bytes` and starts the copy of them
// from global src to shared dst (both 16-byte aligned, bytes a multiple of
// 16), which completes the phase.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Waits until the phase of parity `phase` of *bar has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
  }
}

// ------------------------------------------------- a column's gates
// The barrier of the warps of column `col`: a warp barrier, or named
// barrier 1 + col of the group's 32 gw threads.
__device__ __forceinline__ void column_sync(int col, int gw) {
  if (gw == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(1 + col), "r"(32 * gw) : "memory");
}

// acc + a b and acc + conj(a) b in four fused multiply-adds each (cadd of
// cmul rounds a b first and takes six instructions: two FMUL, two FFMA and
// two FADD). For the gates' products with the state, whose terms do not
// cancel as a rule; the walk's cotangent sums keep cadd of cmul.
__device__ __forceinline__ cplx cmac(cplx acc, cplx a, cplx b) {
  acc.x = fma(a.x, b.x, acc.x);
  acc.x = fma(-a.y, b.y, acc.x);
  acc.y = fma(a.x, b.y, acc.y);
  acc.y = fma(a.y, b.x, acc.y);
  return acc;
}
__device__ __forceinline__ cplx cmac_conj(cplx acc, cplx a, cplx b) {
  acc.x = fma(a.x, b.x, acc.x);
  acc.x = fma(a.y, b.y, acc.x);
  acc.y = fma(a.x, b.y, acc.y);
  acc.y = fma(-a.y, b.x, acc.y);
  return acc;
}

// The rows of a K-qubit gate on row bits sa (, sb), as gate_row lays them
// out: amplitude p of group g lies at row spread(g) + bit[p], where spread
// inserts a zero bit at each leg. A lane's groups g = gl + i gL (gl < gL,
// both powers of two) have disjoint bits, so spread(g) = spread(gl) +
// spread(i gL): the lane's part once a gate, the step's part, the same on
// every lane, once a group.
template <int K>
struct GateRows {
  int lo, hi, lane, bit[1 << K];
  __device__ __forceinline__ GateRows(int sa, int sb, int gl) {
    lo = K == 1 || sa < sb ? sa : sb;
    hi = K == 1 ? 31 : (sa < sb ? sb : sa);
    lane = spread(gl);
#pragma unroll
    for (int p = 0; p < (1 << K); ++p)
      bit[p] = K == 1 ? p << sa : ((p >> 1) << sa) | ((p & 1) << sb);
  }
  __device__ __forceinline__ int spread(int g) const {
    return K == 1 ? ins0(g, lo) : ins0(ins0(g, lo), hi);
  }
};

// X <- G X on a column X of d = 2^n amplitudes: lane gl of the column's gL
// takes groups gl, gl + gL, ... of the gate's 2^(n - K); where there are
// fewer groups than lanes (below 7 qubits) lane gl >= 2^(n - K) takes none.
template <int K>
__device__ __forceinline__ void tile_forward(cplx* X, const cplx* g, int n,
                                             int sa, int sb, int gl, int gL) {
  constexpr int D = 1 << K;
  if (gl >= (1 << (n - K))) return;  // more lanes than groups: this one idles
  cplx G[16];
  load_gate<K>(g, G);
  const GateRows<K> rows(sa, sb, gl);
  for (int step = 0; step < (1 << (n - K)); step += gL) {
    const int r0 = rows.lane + rows.spread(step);
    cplx x[D];
#pragma unroll
    for (int p = 0; p < D; ++p) x[p] = X[r0 + rows.bit[p]];
#pragma unroll
    for (int p = 0; p < D; ++p) {
      cplx acc = mkc(RL(0.), RL(0.));
#pragma unroll
      for (int k = 0; k < D; ++k) acc = cmac(acc, G[p * D + k], x[k]);
      X[r0 + rows.bit[p]] = acc;
    }
  }
}

// One step of the walk on a column: X <- G^dag X, gb[p,k] += Y[p] X[k]
// (Y at the gate's output, X at its input), Y <- G^T Y.
template <int K>
__device__ __forceinline__ void tile_backward(cplx* X, cplx* Y, const cplx* g,
                                              int n, int sa, int sb, int gl,
                                              int gL, real (&gb)[32]) {
  constexpr int D = 1 << K;
  if (gl >= (1 << (n - K))) return;  // idles, its shares 0
  cplx G[16];
  load_gate<K>(g, G);
  const GateRows<K> rows(sa, sb, gl);
  for (int step = 0; step < (1 << (n - K)); step += gL) {
    const int r0 = rows.lane + rows.spread(step);
    cplx x[D], y[D];
#pragma unroll
    for (int p = 0; p < D; ++p) {
      x[p] = X[r0 + rows.bit[p]];
      y[p] = Y[r0 + rows.bit[p]];
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      cplx ak = mkc(RL(0.), RL(0.)), mk = mkc(RL(0.), RL(0.));
#pragma unroll
      for (int p = 0; p < D; ++p) {
        ak = cmac_conj(ak, G[p * D + k], x[p]);
        mk = cmac(mk, G[p * D + k], y[p]);
      }
#pragma unroll
      for (int p = 0; p < D; ++p) {  // the product first: near a fit its
        const cplx t = cmul(y[p], ak);  // parts cancel, and cmac would round
        gb[2 * (p * D + k)] += t.x;     // each term at the sum's size
        gb[2 * (p * D + k) + 1] += t.y;
      }
      X[r0 + rows.bit[k]] = ak;
      Y[r0 + rows.bit[k]] = mk;
    }
  }
}

// The chain on the warp's column: gates 0 .. G-1, bits[j] their row bits.
__device__ __forceinline__ void tile_chain(cplx* X, const cplx* gates,
                                           const int2* bits, int n, int G,
                                           int col, int gw, int gl, int gL) {
  for (int j = 0; j < n; ++j) {
    tile_forward<1>(X, gates + 16 * j, n, bits[j].x, 0, gl, gL);
    column_sync(col, gw);
  }
  for (int j = n; j < G; ++j) {
    tile_forward<2>(X, gates + 16 * j, n, bits[j].x, bits[j].y, gl, gL);
    column_sync(col, gw);
  }
}

// The walk's sum of the warps' slots of gates j0 .. min(j0 + kTileRing, G)
// - 1, in warp order, into out[32 j + e] (a surface gate's 8 reals; its
// other 24 are written 0), one entry a thread, between two block barriers:
// the first so that every warp's slots are in, the second so that none is
// overwritten before it is read.
__device__ __forceinline__ void tile_flush(const real* ring, real* out,
                                           int j0, int n, int G, int nw) {
  __syncthreads();
  for (int i = threadIdx.x; i < kTileRing * 32; i += blockDim.x) {
    const int r = i >> 5, e = i & 31, j = j0 + r;
    if (j >= G) break;
    real s = RL(0.);
    if (j >= n || e < 8)
      for (int w = 0; w < nw; ++w) s += ring[(w * kTileRing + r) * 32 + e];
    out[32 * j + e] = s;
  }
  __syncthreads();
}

// Sum of count values p[0], p[stride], ... (count a power of two) in a
// fixed order: four running sums over every fourth value, then (s0 + s1) +
// (s2 + s3). Sixteen loads stand in flight at once. Reads past L1, where
// other blocks of the same launch wrote the values.
__device__ __forceinline__ real sum_fixed(const real* p, int count,
                                          size_t stride) {
  real s[4] = {RL(0.), RL(0.), RL(0.), RL(0.)};
  if (count < 4) {
    for (int q = 0; q < count; ++q) s[q] += __ldcg(p + (size_t)q * stride);
  } else {
#pragma unroll 4
    for (int q = 0; q < count; q += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += __ldcg(p + (size_t)(q + i) * stride);
    }
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// The walk on a column by its warps, last gate first (tile_backward): every
// warp's sum of each gate's cotangent share into its ring slot, and every
// kTileRing gates the slots summed into out (tile_flush). unitary.cu's vjp
// tiles call it and the next; sweep.cu's sweep_tile_kernel has the same
// lines inline, where moving them here changed its machine code.
__device__ __forceinline__ void tile_walk(cplx* X, cplx* Y, const cplx* gates,
                                          const int2* bits, real* ring,
                                          real* out, int n, int G, int col,
                                          int gw, int gl, int gL, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = G - 1; j >= n; --j) {
    real gb[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) gb[e] = RL(0.);
    tile_backward<2>(X, Y, gates + 16 * j, n, bits[j].x, bits[j].y, gl, gL,
                     gb);
    int base = 0;
    reduce_step<16, 32>(gb, lane, base, kFull);
    ring[(warp * kTileRing + j % kTileRing) * 32 + base] = gb[0];
    column_sync(col, gw);
    if (j % kTileRing == 0) tile_flush(ring, out, j, n, G, nw);
  }
  for (int j = n - 1; j >= 0; --j) {
    real gb[32];
#pragma unroll
    for (int e = 0; e < 8; ++e) gb[e] = RL(0.);
    tile_backward<1>(X, Y, gates + 16 * j, n, bits[j].x, 0, gl, gL, gb);
    int base = 0;
    reduce_step<16, 8>(gb, lane, base, kFull);
    if ((lane & 3) == 0)
      ring[(warp * kTileRing + j % kTileRing) * 32 + base] = gb[0];
    column_sync(col, gw);
    if (j % kTileRing == 0) tile_flush(ring, out, j, n, G, nw);
  }
}

// Past kTileSegment tiles a restart: the last tile of segment `seg` to
// finish (an atomic count) adds the segment's kTileSegment tiles' shares, E
// reals each at stride E from parts, in tile order into out (sum_fixed), and
// sets the count back to 0. `last` is a flag in shared memory. Ends the
// block's work.
__device__ __forceinline__ void tile_segment_sum(const real* parts,
                                                 real* out, unsigned* count,
                                                 int* last, int E) {
  const int tid = threadIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(count, 1u) == kTileSegment - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  for (int i = tid; i < E; i += blockDim.x)
    out[i] = sum_fixed(parts + i, kTileSegment, E);
  if (tid == 0) *count = 0;
}

// ------------------------------------------- the unitary kernels' warps
// unitary.cu's tiles of the whole unitary (the forward pass's column tiles,
// and the vjp on a cluster at 7 and 8 qubits) hold w = 2 ... 128 columns
// on the nw warps of a block of tile_threads. Where w <= nw a column has
// its group of gw = nw / w warps, as above. Where w > nw (7 to 9 qubits) a
// warp owns cw = w / nw columns, c0 ... c0 + cw - 1: it runs a gate on all
// of them, its lanes dealing out each column's amplitude groups, then a
// warp barrier; in the walk it sums a gate's cotangent over its columns in
// registers before its lanes' shuffles. Neither regime has a block barrier
// between two gates. Functions of their own, so that the sweep's tile
// kernel above keeps its machine code.
struct WarpColumns {
  int c0, cw;  // the warp's first column, and its columns
  int gw;      // warps a column (column_sync's group of column c0)
  int gl, gL;  // the thread's lane among the column's gL
};

__host__ __device__ inline int tile_columns_a_warp(int w, int nw) {
  return w > nw ? w / nw : 1;
}

__device__ __forceinline__ WarpColumns warp_columns(int w, int nw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  WarpColumns o;
  if (w > nw) {
    o.cw = w / nw;
    o.c0 = warp * o.cw;
    o.gw = 1;
    o.gl = lane;
    o.gL = 32;
  } else {
    o.gw = nw / w;
    o.c0 = warp / o.gw;
    o.cw = 1;
    o.gl = (warp % o.gw) * 32 + lane;
    o.gL = 32 * o.gw;
  }
  return o;
}

// The row bits of gate j: a surface gate's on qubit j, a block's on its
// placement (qubit q on row bit n - 1 - q).
__device__ __forceinline__ int2 gate_bits(const int* placements, int n,
                                          int j) {
  if (j < n) return make_int2(n - 1 - j, 0);
  return make_int2(n - 1 - __ldg(&placements[2 * (j - n)]),
                   n - 1 - __ldg(&placements[2 * (j - n) + 1]));
}

// The rows of a K-qubit gate's amplitude groups, as GateRows, with lane
// gl taking its group's amplitudes in the order p ^ rho. The lanes of one
// shared-memory wavefront (16 in float, 8 in double: 2^kBankBits complex
// values of 128 bytes) read consecutive groups of a column; a gate leg on
// a row bit below kBankBits leaves their rows on fewer banks, so rho XORs
// the p bits of those legs with the lane's group bits that land at or
// above kBankBits, and the wavefront's rows fall on distinct banks. The
// gate's entries are taken in the same order (swiz_gate).
#ifdef CPFLOW_DOUBLE
constexpr int kBankBits = 3;
#else
constexpr int kBankBits = 4;
#endif

template <int K>
struct SwizRows {
  int lo, hi, lane, rho, bit[1 << K];
  __device__ __forceinline__ SwizRows(int sa, int sb, int gl) {
    lo = K == 1 || sa < sb ? sa : sb;
    hi = K == 1 ? 31 : (sa < sb ? sb : sa);
    lane = spread(gl);
    const bool la = sa < kBankBits, lb = K == 2 && sb < kBankBits;
    const int m = (int)la + (int)lb;
    const int h = (gl >> (kBankBits - m)) & ((1 << m) - 1);
    rho = K == 1 ? h : (la && !lb ? h << 1 : h);
#pragma unroll
    for (int p = 0; p < (1 << K); ++p) {
      const int q = p ^ rho;
      bit[p] = K == 1 ? q << sa : ((q >> 1) << sa) | ((q & 1) << sb);
    }
  }
  __device__ __forceinline__ int spread(int g) const {
    return K == 1 ? ins0(g, lo) : ins0(ins0(g, lo), hi);
  }
};

// The gate's entries in a lane's order: G'[p][k] = G[p ^ rho][k ^ rho].
template <int K>
__device__ __forceinline__ void swiz_gate(const cplx* g, int rho,
                                          cplx (&G)[16]) {
  constexpr int D = 1 << K;
#pragma unroll
  for (int p = 0; p < D; ++p)
#pragma unroll
    for (int k = 0; k < D; ++k) G[p * D + k] = g[(p ^ rho) * D + (k ^ rho)];
}

// Swaps complex entries e and e ^ M of v (N of them) where c holds.
template <int M, int N>
__device__ __forceinline__ void swap_entries(real (&v)[32], bool c) {
  constexpr int low = M & -M;
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (e & low) continue;
    const int f = e ^ M;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const real a = v[2 * e + h], b = v[2 * f + h];
      v[2 * e + h] = c ? b : a;
      v[2 * f + h] = c ? a : b;
    }
  }
}

// Whether a gate on row bits sa (, sb) has a leg below kBankBits, and so
// takes its amplitudes in each lane's order (SwizRows); the others take
// them in the natural order (GateRows), the gate by load_gate.
template <int K>
__device__ __forceinline__ bool low_leg(int sa, int sb) {
  return sa < kBankBits || (K == 2 && sb < kBankBits);
}

// The lane's rows and gate of either order.
template <int K, bool kSwiz>
using RowsOf =
    typename std::conditional<kSwiz, SwizRows<K>, GateRows<K>>::type;

template <int K, bool kSwiz>
__device__ __forceinline__ void gate_of(const cplx* g,
                                        const RowsOf<K, kSwiz>& rows,
                                        cplx (&G)[16]) {
  if constexpr (kSwiz)
    swiz_gate<K>(g, rows.rho, G);
  else
    load_gate<K>(g, G);
}

// X <- G X on the warp's columns X, X + S, ... (tile_forward on each, the
// gate loaded once; with kSwiz the amplitudes in each lane's order).
template <int K, bool kSwiz>
__device__ __forceinline__ void warp_forward(cplx* X, int S, const cplx* g,
                                             int n, int sa, int sb,
                                             const WarpColumns& wc) {
  constexpr int D = 1 << K;
  if (wc.gl >= (1 << (n - K))) return;  // more lanes than groups
  const RowsOf<K, kSwiz> rows(sa, sb, wc.gl);
  cplx G[16];
  gate_of<K, kSwiz>(g, rows, G);
  for (int c = 0; c < wc.cw; ++c, X += S)
    for (int step = 0; step < (1 << (n - K)); step += wc.gL) {
      const int r0 = rows.lane + rows.spread(step);
      cplx x[D];
#pragma unroll
      for (int p = 0; p < D; ++p) x[p] = X[r0 + rows.bit[p]];
#pragma unroll
      for (int p = 0; p < D; ++p) {
        cplx acc = mkc(RL(0.), RL(0.));
#pragma unroll
        for (int k = 0; k < D; ++k) acc = cmac(acc, G[p * D + k], x[k]);
        X[r0 + rows.bit[p]] = acc;
      }
    }
}

// One step of the walk on the warp's columns (tile_backward on each, the
// gate loaded once): the cotangent shares of all of them summed into gb,
// column by column; with kSwiz the amplitudes in each lane's order, and gb
// then put back in the natural order.
template <int K, bool kSwiz>
__device__ __forceinline__ void warp_backward(cplx* X, cplx* Y, int S,
                                              const cplx* g, int n, int sa,
                                              int sb, const WarpColumns& wc,
                                              real (&gb)[32]) {
  constexpr int D = 1 << K;
  if (wc.gl >= (1 << (n - K))) return;  // idles, its shares 0
  const RowsOf<K, kSwiz> rows(sa, sb, wc.gl);
  cplx G[16];
  gate_of<K, kSwiz>(g, rows, G);
  for (int c = 0; c < wc.cw; ++c, X += S, Y += S)
    for (int step = 0; step < (1 << (n - K)); step += wc.gL) {
      const int r0 = rows.lane + rows.spread(step);
      cplx x[D], y[D];
#pragma unroll
      for (int p = 0; p < D; ++p) {
        x[p] = X[r0 + rows.bit[p]];
        y[p] = Y[r0 + rows.bit[p]];
      }
#pragma unroll
      for (int k = 0; k < D; ++k) {
        cplx ak = mkc(RL(0.), RL(0.)), mk = mkc(RL(0.), RL(0.));
#pragma unroll
        for (int p = 0; p < D; ++p) {
          ak = cmac_conj(ak, G[p * D + k], x[p]);
          mk = cmac(mk, G[p * D + k], y[p]);
        }
#pragma unroll
        for (int p = 0; p < D; ++p) {  // the product first, as tile_backward
          const cplx t = cmul(y[p], ak);
          gb[2 * (p * D + k)] += t.x;
          gb[2 * (p * D + k) + 1] += t.y;
        }
        X[r0 + rows.bit[k]] = ak;
        Y[r0 + rows.bit[k]] = mk;
      }
    }
  if constexpr (kSwiz) {  // entry (p, k) of gb holds (p ^ rho, k ^ rho)
    if (K == 2) {  // rho's bit 0 toggles the sb leg's, bit 1 the sa leg's
      swap_entries<5, 16>(gb, rows.rho & 1);
      swap_entries<10, 16>(gb, rows.rho & 2);
    } else {
      swap_entries<3, 4>(gb, rows.rho & 1);
    }
  }
}

// The surface round on the identity's columns C0, C0 + 1, ... of the
// warp's (X, X + S, ...), in one pass instead of n: entry r of column C is
// the product over q of G_q[r's bit, C's bit] on row bit n - 1 - q (from
// e_C each gate's other amplitude is 0). The lane's rows r = gl + i gL
// share their low log2(gL) bits, so the factors of those qubits are taken
// once a column.
__device__ __forceinline__ void warp_product(cplx* X, int S,
                                             const cplx* gates, int n,
                                             int C0, const WarpColumns& wc) {
  int lg = 0;
  while ((1 << lg) < wc.gL && lg < n) ++lg;
  for (int c = 0; c < wc.cw; ++c, X += S) {
    const int C = C0 + c;
    cplx lo = mkc(RL(1.), RL(0.));
    for (int s = 0; s < lg; ++s)
      lo = cmul(lo, gates[16 * (n - 1 - s) + 2 * ((wc.gl >> s) & 1) +
                          ((C >> s) & 1)]);
    for (int r = wc.gl; r < (1 << n); r += wc.gL) {
      cplx v = lo;
      for (int s = lg; s < n; ++s)
        v = cmul(v, gates[16 * (n - 1 - s) + 2 * ((r >> s) & 1) +
                          ((C >> s) & 1)]);
      X[r] = v;
    }
  }
}

// Gates j0 .. G - 1 of the chain on the warp's columns, a column_sync
// after each.
__device__ __forceinline__ void warp_chain(cplx* X, int S, const cplx* gates,
                                           const int* placements, int n,
                                           int j0, int G,
                                           const WarpColumns& wc) {
  for (int j = j0; j < n; ++j) {
    const int s = n - 1 - j;
    if (low_leg<1>(s, 0))
      warp_forward<1, true>(X, S, gates + 16 * j, n, s, 0, wc);
    else
      warp_forward<1, false>(X, S, gates + 16 * j, n, s, 0, wc);
    column_sync(wc.c0, wc.gw);
  }
  for (int j = j0 > n ? j0 : n; j < G; ++j) {
    const int2 bits = gate_bits(placements, n, j);
    if (low_leg<2>(bits.x, bits.y))
      warp_forward<2, true>(X, S, gates + 16 * j, n, bits.x, bits.y, wc);
    else
      warp_forward<2, false>(X, S, gates + 16 * j, n, bits.x, bits.y, wc);
    column_sync(wc.c0, wc.gw);
  }
}

// The sum of x[w stride] over warps w0 .. w0 + N - 1 that are below nw,
// pairwise: the halves' sums added, so that each value is rounded through
// log2(N) additions, not up to N - 1 as in warp order (no array, so no
// local memory).
template <int N>
__device__ __forceinline__ real tree_sum(const real* x, int stride, int nw,
                                         int w0 = 0) {
  if constexpr (N == 1)
    return w0 < nw ? x[w0 * stride] : RL(0.);
  else
    return tree_sum<N / 2>(x, stride, nw, w0) +
           tree_sum<N / 2>(x, stride, nw, w0 + N / 2);
}

// The sum of x[0], x[stride], ... x[(nw - 1) stride] (nw a power of two, at
// most 16) pairwise (tree_sum).
__device__ __forceinline__ real pairwise_sum(const real* x, int stride,
                                             int nw) {
  return nw == 1 ? x[0] : tree_sum<16>(x, stride, nw);
}

// tile_flush with a ring of R gates (a power of two, at most kTileRing),
// into out in shared memory: the warps' slots of gates j0 .. min(j0 + R,
// G) - 1 summed in warp order (with kTree pairwise, pairwise_sum) between
// two block barriers.
template <bool kTree = false>
__device__ __forceinline__ void ring_flush(const real* ring, int R,
                                           real* out, int j0, int n, int G,
                                           int nw) {
  __syncthreads();
  for (int i = threadIdx.x; i < R * 32; i += blockDim.x) {
    const int r = i >> 5, e = i & 31, j = j0 + r;
    if (j >= G) break;
    real s = RL(0.);
    if (j >= n || e < 8) {
      if constexpr (kTree)
        s = pairwise_sum(ring + r * 32 + e, R * 32, nw);
      else
        for (int w = 0; w < nw; ++w) s += ring[(w * R + r) * 32 + e];
    }
    out[32 * j + e] = s;
  }
  __syncthreads();
}

// The walk on the warp's columns (X, Y: its first column of A and M),
// last gate first: each gate's cotangent summed over the warp's columns in
// registers, then over its lanes by shuffles into its slot of a ring of R
// gates, and every R gates the slots summed in warp order into gbar
// (ring_flush; with kTree pairwise). Ends with a block barrier.
template <bool kTree = false>
__device__ __forceinline__ void warp_walk(cplx* X, cplx* Y, int S,
                                          const cplx* gates,
                                          const int* placements, real* ring,
                                          int R, real* gbar, int n, int G,
                                          int nw, const WarpColumns& wc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = G - 1; j >= n; --j) {
    real gb[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) gb[e] = RL(0.);
    const int2 bits = gate_bits(placements, n, j);
    if (low_leg<2>(bits.x, bits.y))
      warp_backward<2, true>(X, Y, S, gates + 16 * j, n, bits.x, bits.y, wc,
                             gb);
    else
      warp_backward<2, false>(X, Y, S, gates + 16 * j, n, bits.x, bits.y,
                              wc, gb);
    int base = 0;
    reduce_step<16, 32>(gb, lane, base, kFull);
    ring[(warp * R + j % R) * 32 + base] = gb[0];
    column_sync(wc.c0, wc.gw);
    if (j % R == 0) ring_flush<kTree>(ring, R, gbar, j, n, G, nw);
  }
  for (int j = n - 1; j >= 0; --j) {
    real gb[32];
#pragma unroll
    for (int e = 0; e < 8; ++e) gb[e] = RL(0.);
    const int s = n - 1 - j;
    if (low_leg<1>(s, 0))
      warp_backward<1, true>(X, Y, S, gates + 16 * j, n, s, 0, wc, gb);
    else
      warp_backward<1, false>(X, Y, S, gates + 16 * j, n, s, 0, wc, gb);
    int base = 0;
    reduce_step<16, 8>(gb, lane, base, kFull);
    if ((lane & 3) == 0) ring[(warp * R + j % R) * 32 + base] = gb[0];
    column_sync(wc.c0, wc.gw);
    if (j % R == 0) ring_flush<kTree>(ring, R, gbar, j, n, G, nw);
  }
}

}  // namespace

// Device code of unitary.cu's column kernels: the whole unitary of a
// restart at 2 to 6 qubits, one lane per column.
//
// Every gate acts on row bits only (gates.cuh), so column c of U is the
// state G_{G-1} ... G_0 e_c and evolves apart from every other column. In
// the adjoint walk the lane that owns column c of a restart rewinds its
// column of A, pulls back its column of M and accumulates its share of
// each gate's cotangent in registers, with no barrier and no exchange;
// the restart's C = 2^n lanes then sum the cotangent by shuffles.
//
// A restart takes one warp up to 5 qubits and two at 6 (column_lanes). At
// 2 to 4 qubits the lanes past C hold no column in the walk: they share the
// prologue (the cos and sin of the angles, the gate matrices, the copies of
// U and its cotangent), the angle gradients and the stores, which cost a
// small restart more than its chain. Packing 32 / C restarts into a warp
// measured slower on the card in both passes, each lane then building
// 32 / C times the gates before its chain could start. In the forward
// pass the 32 / C lanes of a column share its amplitude groups
// (column_ways), with a warp barrier after each gate: one lane alone on
// its column measured 22-49% slower there at 3 and 4 qubits on an H100
// (unitary_ab.py, PERF.md).
//
// The columns live in shared memory, in the row-major d x C layout of
// gates.cuh: lane c touches word c of a row, so a restart's lanes fall on
// consecutive words and never conflict, and the rows a gate touches come
// from its placement at run time. A column in registers needs indices known
// at compile time, one copy of the gate code for each placement of a gate:
// that measured no faster at 3 qubits and much slower in the walk at 4,
// whose 16 copies of about a thousand instructions each overflow the
// instruction cache.
//
// The block's shared memory (column_layout) holds, per restart, A (and M
// in the walk), the angles, the cos and sin of each, the G gate matrices,
// and in the walk each gate's cotangent (one slot per warp of the restart)
// and the angle gradients; and the gates' codes, once per block.

#pragma once

#include <cuda_pipeline.h>

#include "gates.cuh"

namespace {

constexpr int kColumnThreads = 64;   // threads of a column kernel's block
constexpr int kColumnQubitsMin = 2;  // the column kernels' range of qubits
constexpr int kColumnQubitsMax = 6;

// Lanes of one restart: a warp up to 5 qubits, the 64 columns at 6.
__host__ __device__ constexpr int column_lanes(int n) {
  return n < 5 ? 32 : 1 << n;
}

// Lanes that share a column in the forward chain: every lane of the restart
// takes part, the amplitude groups of a gate dealt out among a column's
// lanes, with a warp barrier after each gate (2 to 4 qubits).
__host__ __device__ constexpr int column_ways(int n) {
  return n < 5 ? 32 >> n : 1;
}

struct ColumnLayout {
  int P, G, R, lanes, slots;  // R: restarts a block; slots: warps a restart
  size_t off_M, off_gates, off_gbar, off_params, off_cs, off_grad, off_codes,
      bytes;
};

// Shared memory of a block of R restarts at n qubits; the forward pass keeps
// no M, cotangents and gradients. slots: warps a restart (0: those of
// column_lanes(n)).
__host__ __device__ inline ColumnLayout column_layout(int n, int nb, int nba,
                                                     int R, bool vjp,
                                                     int slots = 0) {
  ColumnLayout L;
  L.P = 3 * n + nba * nb;
  L.G = n + nb;
  L.R = R;
  L.slots = slots ? slots : column_lanes(n) / 32;
  L.lanes = 32 * L.slots;
  const size_t amps = (size_t)R << (2 * n);
  size_t o = amps * sizeof(cplx);  // A at offset 0
  L.off_M = o;      if (vjp) o += amps * sizeof(cplx);
  L.off_gates = o;  o += (size_t)R * L.G * 16 * sizeof(cplx);
  L.off_gbar = o;
  if (vjp) o += (size_t)R * L.slots * L.G * 32 * sizeof(real);
  L.off_params = o; o += (size_t)R * L.P * sizeof(real);
  L.off_cs = o;     o += (size_t)R * 2 * L.P * sizeof(real);
  L.off_grad = o;   if (vjp) o += (size_t)R * L.P * sizeof(real);
  L.off_codes = o;  o += (size_t)L.G * sizeof(int);
  L.bytes = o;
  return L;
}

// Restarts a block of the column kernels holds: kColumnThreads / lanes (2 up
// to 5 qubits, 1 at 6), or 1 where that layout does not fit; 0 where the
// column kernels do not take the shape (one column, n outside 2..6, or no
// layout fits).
__host__ __device__ inline int column_restarts(int n, int nb, int nba,
                                               int log_c, bool vjp) {
  if (log_c != n || n < kColumnQubitsMin || n > kColumnQubitsMax) return 0;
  const int most = kColumnThreads / column_lanes(n);
  for (int R = most > 1 ? most : 1; R >= 1; R >>= 1)
    if (column_layout(n, nb, nba, R, vjp).bytes <= kSmemLimit) return R;
  return 0;
}

// sin and cos of x in float32 without local memory: sincosf reduces large
// arguments with a 28-byte table in local memory, the whole of the 32-byte
// stack frame of a kernel that calls it. Here x is reduced by pi/2 with
// three-part constants (exact to far below float32 for |x| < 1e5), and
// sin and cos of the remainder, |r| <= pi/4, come from minimax polynomials
// of float32 accuracy; a larger |x| goes to the double-precision sincospi,
// whose reduction needs no memory either.
__device__ __forceinline__ void column_sincos(float x, float* s, float* c) {
  if (fabsf(x) > 1e5f) {
    double sd, cd;
    sincospi((double)x * 0.318309886183790671538, &sd, &cd);  // x / pi
    *s = (float)sd;
    *c = (float)cd;
    return;
  }
  const float j = rintf(x * 0.636619772f);  // x = j pi / 2 + r
  float r = fmaf(j, -1.57079625129699707031e+00f, x);
  r = fmaf(j, -7.54978941586159635335e-08f, r);
  r = fmaf(j, -5.39030252995776476554e-15f, r);
  const float r2 = r * r;
  float sp = fmaf(r2, -1.9515295891e-4f, 8.3321608736e-3f);
  sp = fmaf(r2, sp, -1.6666654611e-1f);
  const float sr = fmaf(r * r2, sp, r);
  float cp = fmaf(r2, 2.443315711809948e-5f, -1.388731625493765e-3f);
  cp = fmaf(r2, cp, 4.166664568298827e-2f);
  const float cr = fmaf(r2 * r2, cp, fmaf(r2, -0.5f, 1.f));
  const int q = (int)j & 3;  // the quadrant
  const float sv = q & 1 ? cr : sr, cv = q & 1 ? sr : cr;
  *s = q & 2 ? -sv : sv;
  *c = (q + 1) & 2 ? -cv : cv;
}

// Starts the copy of the block's angles, params[r P + p] = angle p of
// restart b0 + r (restarts past B copy restart B - 1's), as asynchronous
// copies that all stand in flight at once, and commits them as one group.
__device__ __forceinline__ void column_fetch_angles(const real* angles, int B,
                                                    int b0,
                                                    const ColumnLayout& L,
                                                    real* params) {
  for (int i = threadIdx.x; i < L.R * L.P; i += blockDim.x) {
    const int r = i % L.R, p = i / L.R;  // neighbouring threads, restarts
    __pipeline_memcpy_async(params + r * L.P + p,
                            angles + (size_t)p * B + min(b0 + r, B - 1),
                            sizeof(real));
  }
  __pipeline_commit();
}

// Complex values in 16 bytes, two in float and one in double, and a type
// of 16 bytes to copy them by.
constexpr int kPer16 = 16 / sizeof(cplx);
#ifdef CPFLOW_DOUBLE
typedef double2 Vec16;
#else
typedef float4 Vec16;
#endif

// Starts the copy of `count` complex values (a multiple of kPer16, both ends
// 16-byte aligned) from src to dst by the `lanes` lanes of a restart, 16
// bytes a copy. The caller commits.
__device__ __forceinline__ void fetch_slab(cplx* dst, const cplx* src,
                                           int count, int lane, int lanes) {
  for (int e = kPer16 * lane; e < count; e += kPer16 * lanes)
    __pipeline_memcpy_async(dst + e, src + e, 16);
}

// Waits for the angles (`later`: the copy groups this thread committed
// after them, awaited before the end), then writes the gates' codes (64 + q
// for the surface gate on qubit q, 8 q0 + q1 for a block on qubits q0, q1),
// the cos and sin of every angle (as gates.cuh's angle_trig takes them) and
// the gate matrices, each built by one thread. Ends with a barrier, after
// which every copy the block started has landed.
template <int later>
__device__ inline void column_gates(const Template& t, int n,
                                    const int* placements,
                                    const ColumnLayout& L,
                                    const real* params, int* codes,
                                    real* cs, cplx* gates) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int j = tid; j < L.G; j += nt)
    codes[j] = j < n ? 64 + j
                     : 8 * placements[2 * (j - n)] + placements[2 * (j - n) + 1];
  __pipeline_wait_prior(later);
  __syncthreads();
  for (int i = tid; i < L.R * L.P; i += nt) {
    const int p = i % L.P;
    const int bi = p - 3 * n;
    const bool phase = t.ent == E_CP && bi >= 0 && bi % t.nba == t.nba - 1;
    const real x = params[i];
#ifdef CPFLOW_DOUBLE
    real_sincos(phase ? x : RL(0.5) * x, cs + 2 * i + 1, cs + 2 * i);
#else
    column_sincos(phase ? x : RL(0.5) * x, cs + 2 * i + 1, cs + 2 * i);
#endif
  }
  __syncthreads();
  for (int i = tid; i < L.R * L.G; i += nt) {
    const int r = i % L.R, j = i / L.R;
    const real* c = cs + r * 2 * L.P;
    cplx* g = gates + (r * L.G + j) * 16;
    if (j < n) surface_gate(c + 6 * j, g);
    else block_gate(t, c + 2 * (3 * n + t.nba * (j - n)), g);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
}

// A gate's matrix (K = 1: 2x2, K = 2: 4x4, row-major) into registers.
template <int K>
__device__ __forceinline__ void load_gate(const cplx* g, cplx (&G)[16]) {
#ifdef CPFLOW_DOUBLE
#pragma unroll
  for (int e = 0; e < (K == 1 ? 4 : 16); ++e) G[e] = g[e];  // 16 bytes each
#else
  const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll
  for (int e = 0; e < (K == 1 ? 2 : 8); ++e) {
    const float4 v = g4[e];
    G[2 * e] = mkc(v.x, v.y);
    G[2 * e + 1] = mkc(v.z, v.w);
  }
#endif
}

__host__ __device__ constexpr int ins0(int x, int s) {
  return ((x >> s) << (s + 1)) | (x & ((1 << s) - 1));
}

// Row of amplitude p of group g of a K-qubit gate on row bits sa (, sb):
// p's high bit on sa, its low bit on sb.
__host__ __device__ constexpr int gate_row(int K, int sa, int sb, int g,
                                           int p) {
  return K == 1 ? ins0(g, sa) | (p << sa)
                : ins0(ins0(g, sa < sb ? sa : sb), sa < sb ? sb : sa) |
                      ((p >> 1) << sa) | ((p & 1) << sb);
}

// The column `col` of a restart's d x C states A and M (M: the walk only),
// d = C = 2^N, row-major in shared memory.
template <int N>
struct Column {
  cplx* A;
  cplx* M;
  int col;

  // the row bits of the gate of this code; qubit 0 is the most significant
  __device__ __forceinline__ static void bits(int code, int& sa, int& sb) {
    if (code >= 64) {
      sa = N - 1 - (code - 64);
      sb = 0;
    } else {
      sa = N - 1 - (code >> 3);
      sb = N - 1 - (code & 7);
    }
  }

  // A <- G A on amplitude group g of the gate's rows.
  template <int K>
  __device__ __forceinline__ void forward_group(int sa, int sb, int g,
                                                const cplx (&G)[16]) {
    constexpr int D = 1 << K;
    int idx[D];
    cplx x[D];
#pragma unroll
    for (int p = 0; p < D; ++p) {
      idx[p] = (gate_row(K, sa, sb, g, p) << N) + col;
      x[p] = A[idx[p]];
    }
#pragma unroll
    for (int p = 0; p < D; ++p) {
      cplx acc = mkc(RL(0.), RL(0.));
#pragma unroll
      for (int k = 0; k < D; ++k) acc = cadd(acc, cmul(G[p * D + k], x[k]));
      A[idx[p]] = acc;
    }
  }

  // A <- G A on the gate's rows: this lane's share of the amplitude groups,
  // every `ways`-th from `way`; all of them unrolled, or one at a time where
  // `lean` is 2 (chain_range).
  template <int K, int ways = column_ways(N), int lean = 0>
  __device__ __forceinline__ void forward(int code, const cplx (&G)[16],
                                          int way) {
    constexpr int groups = 1 << (N - K);
    constexpr int unroll = lean >= 2 ? 1 : (groups + ways - 1) / ways;
    int sa, sb;
    bits(code, sa, sb);
#pragma unroll (unroll)
    for (int g0 = 0; g0 < groups; g0 += ways) {
      const int g = g0 + way;
      if (ways > 1 && g >= groups) break;
      forward_group<K>(sa, sb, g, G);
    }
  }

  // One step of the walk on amplitude group g: A <- G^dag A,
  // gb[p,k] += M[p] A[k] (with M at the gate's output and A at its input),
  // M <- G^T M.
  template <int K>
  __device__ __forceinline__ void backward_group(int sa, int sb, int g,
                                                 const cplx (&G)[16],
                                                 real (&gb)[32]) {
    constexpr int D = 1 << K;
    int idx[D];
    cplx x[D], y[D];
#pragma unroll
    for (int p = 0; p < D; ++p) {
      idx[p] = (gate_row(K, sa, sb, g, p) << N) + col;
      x[p] = A[idx[p]];
      y[p] = M[idx[p]];
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      cplx ak = mkc(RL(0.), RL(0.)), mk = mkc(RL(0.), RL(0.));
#pragma unroll
      for (int p = 0; p < D; ++p) {
        ak = cadd(ak, cmul(conj2(G[p * D + k]), x[p]));
        mk = cadd(mk, cmul(G[p * D + k], y[p]));
      }
#pragma unroll
      for (int p = 0; p < D; ++p) {
        const cplx t = cmul(y[p], ak);
        gb[2 * (p * D + k)] += t.x;
        gb[2 * (p * D + k) + 1] += t.y;
      }
      A[idx[k]] = ak;
      M[idx[k]] = mk;
    }
  }

  // One step of the walk through a gate on this lane's share of the
  // amplitude groups, every `ways`-th from `way`: all of them unrolled, or
  // one at a time where `lean` is 2.
  template <int K, int ways = 1, int lean = 0>
  __device__ __forceinline__ void backward(int code, const cplx (&G)[16],
                                           real (&gb)[32], int way = 0) {
    constexpr int groups = 1 << (N - K);
    constexpr int unroll = lean >= 2 ? 1 : (groups + ways - 1) / ways;
    int sa, sb;
    bits(code, sa, sb);
#pragma unroll (unroll)
    for (int g0 = 0; g0 < groups; g0 += ways) {
      const int g = ways > 1 ? g0 + way : g0;
      if (ways > 1 && g >= groups) break;
      backward_group<K>(sa, sb, g, G, gb);
    }
  }
};

// ------------------------------------------------ the chain and the walk
// Gate j's matrix where it lies in shared memory, as the array a Column
// step takes (chain_range's and walk_range's lean 2).
__device__ __forceinline__ const cplx (&in_place(const cplx* gates,
                                                 int j))[16] {
  return *reinterpret_cast<const cplx(*)[16]>(gates + 16 * j);
}

// Gates lo..hi-1, all of K qubits, on the lane's column (its share of
// each gate's groups, `way` of `ways`). With lean 0, gate j + 1's matrix
// and code are loaded before gate j is applied; where registers are wanted
// elsewhere (the double sweep), lean 1 loads each gate's at its turn, and
// lean 2 holds no matrix in registers (a gate's entries read in shared
// memory where they are used) and takes a gate's groups one at a time
// (Column). Where a
// column's groups are shared (ways > 1), a warp barrier follows each gate;
// no block barrier.
template <int K, int N, int ways = column_ways(N), int lean = 0>
__device__ __forceinline__ void chain_range(Column<N>& col,
                                            const cplx* gates,
                                            const int* codes, int lo, int hi,
                                            int way) {
  if (lo >= hi) return;
  constexpr bool ahead = lean == 0;
  cplx Gc[16];
  load_gate<K>(gates + 16 * lo, Gc);
  int code = codes[lo];
  for (int j = lo; j < hi; ++j) {
    if constexpr (!ahead) {
      if (j > lo) {
        if constexpr (lean < 2) load_gate<K>(gates + 16 * j, Gc);
        code = codes[j];
      }
    }
    cplx Gn[16];
    int next = 0;
    if (ahead && j + 1 < hi) {
      load_gate<K>(gates + 16 * (j + 1), Gn);
      next = codes[j + 1];
    }
    if constexpr (lean >= 2)
      col.template forward<K, ways, lean>(code, in_place(gates, j), way);
    else
      col.template forward<K, ways, lean>(code, Gc, way);
    if constexpr (ways > 1) __syncwarp();
    if constexpr (ahead) {
#pragma unroll
      for (int e = 0; e < 16; ++e) Gc[e] = Gn[e];
      code = next;
    }
  }
}

// A <- G_{G-1} ... G_0 A: the surface round, then every block.
template <int N, int ways = column_ways(N), int lean = 0>
__device__ __forceinline__ void column_chain(Column<N>& col,
                                             const cplx* gates,
                                             const int* codes, int G,
                                             int way) {
  chain_range<1, N, ways, lean>(col, gates, codes, 0, N, way);
  chain_range<2, N, ways, lean>(col, gates, codes, N, G, way);
}

// One step of a reduce-scatter over the lanes of a segment: the lanes that
// differ in lane bit S swap halves of their NV values (those with the bit
// set keep the upper half, and add H to `base`, the index of their first
// value) until one value is left, which they then sum (butterfly). Every
// index is known at compile time, so v stays in registers. mask: the lanes
// of the warp that take part.
template <int S, int NV>
__device__ __forceinline__ void reduce_step(real (&v)[32], int lane,
                                            int& base, unsigned mask) {
  if constexpr (S >= 1) {
    if constexpr (NV > 1) {
      constexpr int H = NV / 2;
      const bool upper = lane & S;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const real send = upper ? v[i] : v[i + H];
        const real keep = upper ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(mask, send, S);
      }
      if (upper) base += H;
      reduce_step<S / 2, H>(v, lane, base, mask);
    } else {
      v[0] += __shfl_xor_sync(mask, v[0], S);
      reduce_step<S / 2, 1>(v, lane, base, mask);
    }
  }
}

// The adjoint walk through gates hi-1 .. lo, all of K qubits: each step
// leaves the gate's cotangent, 32 reals (K = 2) or 8 (K = 1), summed over
// the 2^LC lanes of the warp that hold the restart's columns (lanes 0 to
// 2^LC - 1, `mask`). The sum of gate j is held in registers and stored to
// gbar[32 j + ...] only after gate j - 1 has been applied and its matrix
// loaded, so that no gate waits on the previous gate's sum (`lean` as
// chain_range's). Where `ways` lanes share a column (each its share of the
// groups, `way`), a warp barrier follows each gate; no block barrier.
template <int K, int LC, int ways = 1, int lean = 0, class Col>
__device__ __forceinline__ void walk_range(Col& col, const cplx* gates,
                                           const int* codes, real* gbar,
                                           int lo, int hi, unsigned mask,
                                           int way = 0) {
  constexpr int NV = K == 2 ? 32 : 8;
  constexpr int C = 1 << LC;
  constexpr int KEEP = NV > C ? NV / C : 1;  // values a lane ends with
  constexpr int SAME = C > NV ? C / NV : 1;  // lanes that end with the same
  if (lo >= hi) return;
  constexpr bool ahead = lean == 0;
  const int lane = threadIdx.x & 31;
  const bool owner = (lane & (SAME - 1)) == 0;
  cplx Gc[16];
  load_gate<K>(gates + 16 * (hi - 1), Gc);
  int code = codes[hi - 1];
  real held[KEEP];
  int held_base = 0;
  for (int j = hi - 1; j >= lo; --j) {
    if constexpr (!ahead) {
      if (j < hi - 1) {
        if constexpr (lean < 2) load_gate<K>(gates + 16 * j, Gc);
        code = codes[j];
      }
    }
    real gb[32];
#pragma unroll
    for (int e = 0; e < NV; ++e) gb[e] = RL(0.);
    if constexpr (lean >= 2)
      col.template backward<K, ways, lean>(code, in_place(gates, j), gb, way);
    else
      col.template backward<K, ways, lean>(code, Gc, gb, way);
    if constexpr (ways > 1) __syncwarp();
    cplx Gn[16];
    int next = 0;
    if (ahead && j > lo) {
      load_gate<K>(gates + 16 * (j - 1), Gn);
      next = codes[j - 1];
    }
    if (j < hi - 1 && owner) {
#pragma unroll
      for (int e = 0; e < KEEP; ++e) gbar[32 * (j + 1) + held_base + e] = held[e];
    }
    int base = 0;
    reduce_step<C / 2, NV>(gb, lane, base, mask);
#pragma unroll
    for (int e = 0; e < KEEP; ++e) held[e] = gb[e];
    held_base = base;
    if constexpr (ahead) {
#pragma unroll
      for (int e = 0; e < 16; ++e) Gc[e] = Gn[e];
      code = next;
    }
  }
  if (owner) {
#pragma unroll
    for (int e = 0; e < KEEP; ++e) gbar[32 * lo + held_base + e] = held[e];
  }
}

// The whole walk, last gate first: the blocks, then the surface round.
template <int LC, int ways = 1, int lean = 0, class Col>
__device__ __forceinline__ void column_walk(Col& col, const cplx* gates,
                                            const int* codes, real* gbar,
                                            int n, int G, unsigned mask,
                                            int way = 0) {
  walk_range<2, LC, ways, lean>(col, gates, codes, gbar, n, G, mask, way);
  walk_range<1, LC, ways, lean>(col, gates, codes, gbar, 0, n, mask, way);
}

}  // namespace

// Device code shared by the kernels of this directory: the gate algebra of
// the two-qubit-block ansatz in factored 2x2 form (each gate's matrix from
// the cos and sin of its angles, and its angle gradients from its
// cotangent), and what a restart split over a thread-block cluster sums and
// checks across its blocks.
//
// sweep.cu (the fused multi-start Adam sweep) and unitary.cu (the ansatz as a
// differentiable function of its angles) include it; each compiles it into
// its own library, so everything sits in an unnamed namespace. How a gate is
// applied to a state in shared memory is each design's own: columns.cuh (a
// column a lane), tiles.cuh (a tile's columns owned by warps) and rows.cuh
// (a column's rows owned by warps).
//
// A restart's d x C complex state A (C = 2^n columns for the whole unitary,
// C = 1 for the |0...0> column alone) and, in the walk, the cotangent M live
// in shared memory. Where one block's shared memory does not hold them, a
// restart runs on a cluster of c = 2^j blocks (at most 16: Hopper's portable
// clusters end at 8, and a kernel takes 16 only with
// cudaFuncAttributeNonPortableClusterSizeAllowed set): the whole unitary
// split by columns (tiles.cuh), one column split by rows (rows.cuh). What
// crosses the blocks (the sums over entries, each gate's cotangent, the
// modulo losses' entries) goes through distributed shared memory
// (cluster_sum). Past what a cluster of 16 holds, tiles run on independent
// blocks with no cluster (the column tiles of sweep.cu and unitary.cu, the
// global row tiles of unitary.cu), and what crosses them goes through
// global memory, summed by a further kernel in a fixed order.
//
// The precision of a build. Every source compiles twice: as it stands, in
// float (complex64 amplitudes), and with -DCPFLOW_DOUBLE in double
// (complex128) into a library of its own (kernels/build.py). The device code
// is written in `real` and `cplx` and the few functions below; RL(x) is a
// literal of the build's type, so that the float build keeps the float
// literals (0.9f, 1e-8f) it always had and compiles to the same code.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

#ifdef CPFLOW_DOUBLE
typedef double real;
typedef double2 cplx;
#define RL(x) x
__device__ __forceinline__ cplx mkc(real x, real y) { return make_double2(x, y); }
__device__ __forceinline__ real r_sqrt(real x) { return sqrt(x); }
__device__ __forceinline__ real r_pow(real x, real y) { return pow(x, y); }
__device__ __forceinline__ real r_fmod(real x, real y) { return fmod(x, y); }
__device__ __forceinline__ bool same_bits(real a, real b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}
// sin and cos without local memory: sincos(double) keeps a Payne-Hanek
// reduction for huge arguments on a stack in local memory, while sincospi's
// reduction is exact and needs none. x / pi is formed to double precision
// (the product, then its residual x - y pi by two fused multiply-adds), so
// the result stays within a few ulp of sin and cos of x for the angles Adam
// leaves (well below 1e9).
__device__ __forceinline__ void real_sincos(real x, real* s, real* c) {
  constexpr double kInvPi = 0.318309886183790671538;
  constexpr double kPiHi = 3.141592653589793116;
  constexpr double kPiLo = 1.2246467991473532e-16;
  const double y = x * kInvPi;
  double e = fma(-y, kPiHi, x);
  e = fma(-y, kPiLo, e);
  sincospi(fma(e, kInvPi, y), s, c);
}
#else
typedef float real;
typedef float2 cplx;
#define RL(x) x##f
__device__ __forceinline__ cplx mkc(real x, real y) { return make_float2(x, y); }
__device__ __forceinline__ real r_sqrt(real x) { return sqrtf(x); }
__device__ __forceinline__ real r_pow(real x, real y) { return powf(x, y); }
__device__ __forceinline__ real r_fmod(real x, real y) { return fmodf(x, y); }
__device__ __forceinline__ bool same_bits(real a, real b) {
  return __float_as_uint(a) == __float_as_uint(b);
}
__device__ __forceinline__ void real_sincos(real x, real* s, real* c) {
  sincosf(x, s, c);
}
#endif

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448;  // shared memory one block may use
constexpr int kMaxClusterLog = 4;      // clusters of at most 16 blocks

// entanglers, as kernels/sweep.py numbers them
enum { E_CP, E_CZ, E_CX };

// Threads of one restart's block: one per 16 amplitudes, between a warp and
// kMaxThreads.
__host__ __device__ inline int threads_for(int n, int log_c) {
  int groups = (1 << (n + log_c)) / 16;
  return groups < 32 ? 32 : (groups > kMaxThreads ? kMaxThreads : groups);
}

// ---------------------------------------------------------------- complex
__device__ __forceinline__ cplx cmul(cplx a, cplx b) {
  return mkc(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ cplx cadd(cplx a, cplx b) {
  return mkc(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ cplx conj2(cplx a) {
  return mkc(a.x, -a.y);
}

// ------------------------------------------------------- small gate algebra
// Blocks and surface gates in factored 2x2 form (cpflow_tpu_torch/sim/
// adjoint.py is its plain version and derivation). evaluate takes the cosine
// and sine of each angle once per iteration into cs: cs[2i] and cs[2i + 1]
// of half angle i for a rotation, of angle i itself for a CP phase. The gate
// builds and the angle gradients read them there.

// 2x2 rotation exp(-i a P/2) = c I - i s P, row-major, from c = cos(a/2) and
// s = sin(a/2); letter 0, 1, 2 for x, y, z.
__device__ __forceinline__ void rot2(int letter, real c, real s,
                                     cplx* R) {
  if (letter == 0) {         // x
    R[0] = mkc(c, RL(0.));  R[1] = mkc(RL(0.), -s);
    R[2] = mkc(RL(0.), -s); R[3] = mkc(c, RL(0.));
  } else if (letter == 1) {  // y
    R[0] = mkc(c, RL(0.));  R[1] = mkc(-s, RL(0.));
    R[2] = mkc(s, RL(0.));  R[3] = mkc(c, RL(0.));
  } else {                   // z
    R[0] = mkc(c, -s);   R[1] = mkc(RL(0.), RL(0.));
    R[2] = mkc(RL(0.), RL(0.)); R[3] = mkc(c, s);
  }
}

// out = a b (2x2); out aliases neither
__device__ __forceinline__ void mm2(const cplx* a, const cplx* b,
                                    cplx* out) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      out[i * 2 + j] = cadd(cmul(a[i * 2], b[j]), cmul(a[i * 2 + 1], b[2 + j]));
}

// out = a b^T (2x2); out aliases neither
__device__ __forceinline__ void mm2_bt(const cplx* a, const cplx* b,
                                       cplx* out) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      out[i * 2 + j] = cadd(cmul(a[i * 2], b[j * 2]),
                            cmul(a[i * 2 + 1], b[j * 2 + 1]));
}

// v <- R^dag v R for the rotation R = c I - i s P of a letter, as
// c^2 v + s^2 P v P + i c s (P v - v P): a Pauli matrix only permutes and
// negates entries. q = i (P v - v P).
__device__ __forceinline__ void conj_rot(int letter, real c, real s,
                                         cplx* v) {
  const cplx v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3];
  cplx w[4], q[4];
  if (letter == 0) {         // P v P swaps rows and columns
    w[0] = v3; w[1] = v2; w[2] = v1; w[3] = v0;
    const cplx a = mkc(v2.x - v1.x, v2.y - v1.y);
    const cplx b = mkc(v3.x - v0.x, v3.y - v0.y);
    q[0] = mkc(-a.y, a.x);  q[1] = mkc(-b.y, b.x);
    q[2] = mkc(b.y, -b.x);  q[3] = mkc(a.y, -a.x);
  } else if (letter == 1) {  // y
    w[0] = v3; w[1] = mkc(-v2.x, -v2.y);
    w[2] = mkc(-v1.x, -v1.y); w[3] = v0;
    const cplx a = mkc(v1.x + v2.x, v1.y + v2.y);
    const cplx b = mkc(v0.x - v3.x, v0.y - v3.y);
    q[0] = a; q[1] = mkc(-b.x, -b.y);
    q[2] = mkc(-b.x, -b.y); q[3] = mkc(-a.x, -a.y);
  } else {                   // z
    w[0] = v0; w[1] = mkc(-v1.x, -v1.y);
    w[2] = mkc(-v2.x, -v2.y); w[3] = v3;
    q[0] = q[3] = mkc(RL(0.), RL(0.));
    q[1] = mkc(RL(-2.) * v1.y, RL(2.) * v1.x);
    q[2] = mkc(RL(2.) * v2.y, RL(-2.) * v2.x);
  }
  const real cc = c * c, ss = s * s, cs = c * s;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = mkc(cc * v[e].x + ss * w[e].x + cs * q[e].x,
                       cc * v[e].y + ss * w[e].y + cs * q[e].y);
}

// Im tr(v P) for the Pauli matrix P of a letter
__device__ __forceinline__ real im_tr_pauli(int letter, const cplx* v) {
  return letter == 0 ? v[1].y + v[2].y
                     : (letter == 1 ? v[1].x - v[2].x : v[0].y - v[3].y);
}

// The rotation letters of a leg: a block's, from its template, or a surface
// gate's z, x, z.
struct BlockLetters {
  const int* letters;
  __device__ int operator()(int i) const { return __ldg(&letters[i]); }
};
struct SurfaceLetters {
  __device__ int operator()(int i) const { return i == 1 ? 0 : 2; }
};

// U = R_{m-1} ... R_0 of one leg, whose i-th angle has its cos and sin at
// cs[stride i] and cs[stride i + 1].
template <class Letters>
__device__ inline void leg_product(Letters let, int m, const real* cs,
                                   int stride, cplx* U) {
  if (m == 0) {
    U[0] = U[3] = mkc(RL(1.), RL(0.));
    U[1] = U[2] = mkc(RL(0.), RL(0.));
    return;
  }
  rot2(let(0), cs[0], cs[1], U);
  for (int i = 1; i < m; ++i) {
    cplx R[4], t[4];
    rot2(let(i), cs[stride * i], cs[stride * i + 1], R);
    mm2(R, U, t);
#pragma unroll
    for (int e = 0; e < 4; ++e) U[e] = t[e];
  }
}

// The angle gradients of one leg from v = U Y^T, Y = dL/dU:
// grad[gstride i] = Im tr(V_i P_i) with V_{m-1} = v and
// V_{i-1} = R_i^dag V_i R_i. Overwrites v.
template <class Letters>
__device__ inline void leg_grads(Letters let, int m, const real* cs,
                                 int stride, cplx* v, real* grad,
                                 int gstride) {
  for (int i = m - 1; i >= 0; --i) {
    const int letter = let(i);
    grad[gstride * i] = im_tr_pauli(letter, v);
    if (i > 0) conj_rot(letter, cs[stride * i], cs[stride * i + 1], v);
  }
}

// The block template: rotation letters, their count m, the entangler and
// the angles per block.
struct Template {
  const int* letters;  // (m,) 0, 1, 2 for x, y, z
  int m, ent, nba;
};

// Block gate G = (U (x) D) E, 4x4 row-major with the up leg on the more
// significant bit; cs holds the cos and sin of the block's angles. U and D
// are the up and down legs (angles 0, 2, ... and 1, 3, ...), and E acts on
// the columns: CP scales column 3 by e^{i phi}, CZ negates it, CX swaps
// columns 2 and 3.
__device__ inline void block_gate(const Template& t, const real* cs,
                                  cplx* G) {
  const BlockLetters let{t.letters};
  cplx U[4], D[4];
  leg_product(let, t.m, cs, 4, U);
  leg_product(let, t.m, cs + 2, 4, D);
  const cplx phase = t.ent == E_CP ? mkc(cs[4 * t.m], cs[4 * t.m + 1])
                                     : mkc(RL(1.), RL(0.));
#pragma unroll
  for (int row = 0; row < 4; ++row)
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      cplx w = cmul(U[(row & 2) + (col >> 1)], D[(row & 1) * 2 + (col & 1)]);
      if (col == 3 && t.ent == E_CP) w = cmul(w, phase);
      if (col == 3 && t.ent == E_CZ) w = mkc(-w.x, -w.y);
      G[row * 4 + (t.ent == E_CX && col >= 2 ? 5 - col : col)] = w;
    }
}

// Angle gradients of one block from its cotangent Gbar = dL/dG: with
// X = Gbar E^T, the legs' cotangents Y_U[p,k] = sum_{q,l} X[pq,kl] D[q,l]
// and Y_D[q,l] = sum_{p,k} X[pq,kl] U[p,k], walked down each leg by
// leg_grads; the CP angle's is 2 Re sum_pq Gbar[pq,3] (U (x) D)[pq,3]
// i e^{i phi}.
__device__ inline void block_grads(const Template& t, const real* cs,
                                   const cplx* gbar, real* grad) {
  const BlockLetters let{t.letters};
  const bool cp = t.ent == E_CP;
  cplx U[4], D[4], YU[4], YD[4];
  leg_product(let, t.m, cs, 4, U);
  leg_product(let, t.m, cs + 2, 4, D);
  const cplx phase = cp ? mkc(cs[4 * t.m], cs[4 * t.m + 1])
                          : mkc(RL(1.), RL(0.));
  cplx acc = mkc(RL(0.), RL(0.));
#pragma unroll
  for (int e = 0; e < 4; ++e) YU[e] = YD[e] = mkc(RL(0.), RL(0.));
#pragma unroll
  for (int row = 0; row < 4; ++row) {
    const int p = row >> 1, q = row & 1;
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      const int k = col >> 1, l = col & 1;
      cplx x;
      if (col < 2) {
        x = gbar[row * 4 + col];
      } else if (t.ent == E_CX) {
        x = gbar[row * 4 + 5 - col];
      } else if (col == 2) {
        x = gbar[row * 4 + 2];
      } else {
        x = gbar[row * 4 + 3];
        x = cp ? cmul(x, phase) : mkc(-x.x, -x.y);
      }
      YU[2 * p + k] = cadd(YU[2 * p + k], cmul(x, D[2 * q + l]));
      YD[2 * q + l] = cadd(YD[2 * q + l], cmul(x, U[2 * p + k]));
    }
    if (cp)
      acc = cadd(acc, cmul(gbar[row * 4 + 3], cmul(U[2 * p + 1], D[2 * q + 1])));
  }
  if (cp) grad[2 * t.m] = RL(2.) * (-phase.y * acc.x - phase.x * acc.y);
  cplx v[4];
  mm2_bt(U, YU, v);
  leg_grads(let, t.m, cs, 4, v, grad, 2);
  mm2_bt(D, YD, v);
  leg_grads(let, t.m, cs + 2, 4, v, grad + 1, 2);
}

// Surface gate Rz(a2) Rx(a1) Rz(a0): one leg with the letters z, x, z.
__device__ inline void surface_gate(const real* cs, cplx* G) {
  cplx U[4];
  leg_product(SurfaceLetters{}, 3, cs, 2, U);
#pragma unroll
  for (int e = 0; e < 4; ++e) G[e] = U[e];
}

// Its three angle gradients from the gate G and its cotangent Gbar.
__device__ inline void surface_grads(const real* cs, const cplx* G,
                                     const cplx* gbar, real* grad) {
  cplx v[4];
  mm2_bt(G, gbar, v);
  leg_grads(SurfaceLetters{}, 3, cs, 2, v, grad, 1);
}

// ------------------------------------------------------- the gates a step
// None ends with a barrier.

// cos and sin of each of the P angles, once, into cs[2i], cs[2i + 1]: of half
// the angle for a rotation, of the angle for a CP phase (the last of a CP
// block's angles).
__device__ __forceinline__ void angle_trig(const Template& t, int n, int P,
                                           const real* params, real* cs) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int bi = i - 3 * n;
    const bool phase = t.ent == E_CP && bi >= 0 && bi % t.nba == t.nba - 1;
    real s, c;
    real_sincos(phase ? params[i] : RL(0.5) * params[i], &s, &c);
    cs[2 * i] = c;
    cs[2 * i + 1] = s;
  }
}

// The G = n + nb gate matrices (16 cplx each; a surface gate uses the first
// four) from the cos and sin of the angles, one gate per thread.
__device__ __forceinline__ void build_gates(const Template& t, int n, int G,
                                            const real* cs, cplx* gates) {
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    if (j < n) surface_gate(cs + 6 * j, gates + 16 * j);
    else block_gate(t, cs + 2 * (3 * n + t.nba * (j - n)), gates + 16 * j);
  }
}

// ------------------------------------------------------------- clusters
// Sums the partials x[0..len) that the blocks of a cluster hold at the same
// shared-memory offset and leaves the sum in every block's x. One thread of
// the cluster sums entry i, over the ranks in the order 0, 1, ..., c - 1,
// and writes it to every block: all blocks then hold the same bits, so that
// the angles, which every block updates, never drift apart. Begins and ends
// with a cluster barrier.
__device__ inline void cluster_sum(real* x, int len) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster.sync();
  for (int i = rank * blockDim.x + threadIdx.x; i < len;
       i += c * blockDim.x) {
    real s = RL(0.);
    for (int q = 0; q < c; ++q) s += *cluster.map_shared_rank(x + i, q);
    for (int q = 0; q < c; ++q) *cluster.map_shared_rank(x + i, q) = s;
  }
  cluster.sync();
}

// Traps unless every block of the cluster holds the same bits in x[0..len)
// as rank 0. The blocks of a restart update the same angles from the same
// sums; a block that differs runs another unitary than its peers, and
// nothing else would show it. Begins and ends with a cluster barrier, so that
// rank 0's shared memory stays in place while its peers read it.
__device__ inline void cluster_agree(const real* x, int len) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() != 0) {
    const real* x0 = cluster.map_shared_rank(const_cast<real*>(x), 0);
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      if (!same_bits(x[i], x0[i])) __trap();
  }
  cluster.sync();
}

// The launch of `grid` blocks of `threads` threads with `smem` bytes of
// dynamic shared memory on `stream`, in clusters of `cluster` blocks along x
// (1: no cluster). `attr` holds the cluster's dimensions and must outlive the
// configuration.
inline cudaLaunchConfig_t launch_config(unsigned grid, int threads,
                                        size_t smem, unsigned cluster,
                                        cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  return cfg;
}

// Every angle's gradient from the gates' cotangents, one gate per thread.
__device__ __forceinline__ void angle_grads(const Template& t, int n, int G,
                                            const real* cs,
                                            const cplx* gates,
                                            const real* gbar, real* grad) {
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    const cplx* gbj = reinterpret_cast<const cplx*>(gbar + 32 * j);
    if (j < n) {
      surface_grads(cs + 6 * j, gates + 16 * j, gbj, grad + 3 * j);
    } else {
      const int off = 3 * n + t.nba * (j - n);
      block_grads(t, cs + 2 * off, gbj, grad + off);
    }
  }
}

// ------------------------------------------------------------- row tiles
// A state's one column split by rows over a cluster of c = 2^j blocks: the
// block of rank rho holds rows [rho d / c, (rho + 1) d / c) as its tile of
// 2^log_rows rows (log_rows = n - j), so the top j row bits, qubits
// 0 ... j - 1, name the block, and a gate with a leg on one of them crosses
// blocks. Every kernel of the row tiles (sweep.cu's sweep_rows_kernel,
// unitary.cu's forward_rows_kernel and vjp_rows_kernel) runs the warps'
// design of rows.cuh: each block's rows owned by its warps, and the bits a
// gate needs brought onto a warp's own rows by swaps beforehand.

}  // namespace

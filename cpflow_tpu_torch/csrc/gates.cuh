// Device code shared by the kernels of this directory: the gate algebra of
// the two-qubit-block ansatz in factored 2x2 form, the application of a gate
// to a state held in shared memory, forwards and in the adjoint walk, and
// the walk itself.
//
// sweep.cu (the fused multi-start Adam sweep) and unitary.cu (the ansatz as a
// differentiable function of its angles) include it; each compiles it into
// its own library, so everything sits in an unnamed namespace.
//
// One thread block owns one restart. Its d x C complex64 state A (C = 2^n
// columns for the whole unitary, C = 1 for the |0...0> column alone) and,
// in the walk, the cotangent M live in shared memory; a gate is applied by
// all threads of the block to disjoint amplitude groups, with one barrier
// between gates.
//
// Above 6 qubits the whole unitary's A and M exceed one block's shared
// memory. Then a restart runs on a cluster of c = 2^j blocks, and the block
// of rank rho owns columns [rho C / c, (rho + 1) C / c) as a row-major
// d x (C / c) tile. Every gate acts on row bits only, so each block runs the
// chain and the walk on its own tile, calling the functions below with the
// tile's log_c = n - j; what crosses columns (the sums over entries, each
// gate's cotangent, the modulo losses' entries) goes through distributed
// shared memory (tile_to_global, cluster_sum).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmemLimit = 232448;  // shared memory one block may use
constexpr int kMaxClusterLog = 3;      // clusters of at most 8 blocks

// entanglers, as kernels/sweep.py numbers them
enum { E_CP, E_CZ, E_CX };

// Threads of one restart's block: one per 16 amplitudes, between a warp and
// kMaxThreads.
__host__ __device__ inline int threads_for(int n, int log_c) {
  int groups = (1 << (n + log_c)) / 16;
  return groups < 32 ? 32 : (groups > kMaxThreads ? kMaxThreads : groups);
}

// ---------------------------------------------------------------- complex
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 conj2(float2 a) {
  return make_float2(a.x, -a.y);
}

// ------------------------------------------------------- small gate algebra
// Blocks and surface gates in factored 2x2 form (cpflow_tpu_torch/sim/
// adjoint.py is its plain version and derivation). evaluate takes the cosine
// and sine of each angle once per iteration into cs: cs[2i] and cs[2i + 1]
// of half angle i for a rotation, of angle i itself for a CP phase. The gate
// builds and the angle gradients read them there.

// 2x2 rotation exp(-i a P/2) = c I - i s P, row-major, from c = cos(a/2) and
// s = sin(a/2); letter 0, 1, 2 for x, y, z.
__device__ __forceinline__ void rot2(int letter, float c, float s,
                                     float2* R) {
  if (letter == 0) {         // x
    R[0] = make_float2(c, 0.f);  R[1] = make_float2(0.f, -s);
    R[2] = make_float2(0.f, -s); R[3] = make_float2(c, 0.f);
  } else if (letter == 1) {  // y
    R[0] = make_float2(c, 0.f);  R[1] = make_float2(-s, 0.f);
    R[2] = make_float2(s, 0.f);  R[3] = make_float2(c, 0.f);
  } else {                   // z
    R[0] = make_float2(c, -s);   R[1] = make_float2(0.f, 0.f);
    R[2] = make_float2(0.f, 0.f); R[3] = make_float2(c, s);
  }
}

// out = a b (2x2); out aliases neither
__device__ __forceinline__ void mm2(const float2* a, const float2* b,
                                    float2* out) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      out[i * 2 + j] = cadd(cmul(a[i * 2], b[j]), cmul(a[i * 2 + 1], b[2 + j]));
}

// out = a b^T (2x2); out aliases neither
__device__ __forceinline__ void mm2_bt(const float2* a, const float2* b,
                                       float2* out) {
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
__device__ __forceinline__ void conj_rot(int letter, float c, float s,
                                         float2* v) {
  const float2 v0 = v[0], v1 = v[1], v2 = v[2], v3 = v[3];
  float2 w[4], q[4];
  if (letter == 0) {         // P v P swaps rows and columns
    w[0] = v3; w[1] = v2; w[2] = v1; w[3] = v0;
    const float2 a = make_float2(v2.x - v1.x, v2.y - v1.y);
    const float2 b = make_float2(v3.x - v0.x, v3.y - v0.y);
    q[0] = make_float2(-a.y, a.x);  q[1] = make_float2(-b.y, b.x);
    q[2] = make_float2(b.y, -b.x);  q[3] = make_float2(a.y, -a.x);
  } else if (letter == 1) {  // y
    w[0] = v3; w[1] = make_float2(-v2.x, -v2.y);
    w[2] = make_float2(-v1.x, -v1.y); w[3] = v0;
    const float2 a = make_float2(v1.x + v2.x, v1.y + v2.y);
    const float2 b = make_float2(v0.x - v3.x, v0.y - v3.y);
    q[0] = a; q[1] = make_float2(-b.x, -b.y);
    q[2] = make_float2(-b.x, -b.y); q[3] = make_float2(-a.x, -a.y);
  } else {                   // z
    w[0] = v0; w[1] = make_float2(-v1.x, -v1.y);
    w[2] = make_float2(-v2.x, -v2.y); w[3] = v3;
    q[0] = q[3] = make_float2(0.f, 0.f);
    q[1] = make_float2(-2.f * v1.y, 2.f * v1.x);
    q[2] = make_float2(2.f * v2.y, -2.f * v2.x);
  }
  const float cc = c * c, ss = s * s, cs = c * s;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = make_float2(cc * v[e].x + ss * w[e].x + cs * q[e].x,
                       cc * v[e].y + ss * w[e].y + cs * q[e].y);
}

// Im tr(v P) for the Pauli matrix P of a letter
__device__ __forceinline__ float im_tr_pauli(int letter, const float2* v) {
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
__device__ inline void leg_product(Letters let, int m, const float* cs,
                                   int stride, float2* U) {
  if (m == 0) {
    U[0] = U[3] = make_float2(1.f, 0.f);
    U[1] = U[2] = make_float2(0.f, 0.f);
    return;
  }
  rot2(let(0), cs[0], cs[1], U);
  for (int i = 1; i < m; ++i) {
    float2 R[4], t[4];
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
__device__ inline void leg_grads(Letters let, int m, const float* cs,
                                 int stride, float2* v, float* grad,
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
__device__ inline void block_gate(const Template& t, const float* cs,
                                  float2* G) {
  const BlockLetters let{t.letters};
  float2 U[4], D[4];
  leg_product(let, t.m, cs, 4, U);
  leg_product(let, t.m, cs + 2, 4, D);
  const float2 phase = t.ent == E_CP ? make_float2(cs[4 * t.m], cs[4 * t.m + 1])
                                     : make_float2(1.f, 0.f);
#pragma unroll
  for (int row = 0; row < 4; ++row)
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      float2 w = cmul(U[(row & 2) + (col >> 1)], D[(row & 1) * 2 + (col & 1)]);
      if (col == 3 && t.ent == E_CP) w = cmul(w, phase);
      if (col == 3 && t.ent == E_CZ) w = make_float2(-w.x, -w.y);
      G[row * 4 + (t.ent == E_CX && col >= 2 ? 5 - col : col)] = w;
    }
}

// Angle gradients of one block from its cotangent Gbar = dL/dG: with
// X = Gbar E^T, the legs' cotangents Y_U[p,k] = sum_{q,l} X[pq,kl] D[q,l]
// and Y_D[q,l] = sum_{p,k} X[pq,kl] U[p,k], walked down each leg by
// leg_grads; the CP angle's is 2 Re sum_pq Gbar[pq,3] (U (x) D)[pq,3]
// i e^{i phi}.
__device__ inline void block_grads(const Template& t, const float* cs,
                                   const float2* gbar, float* grad) {
  const BlockLetters let{t.letters};
  const bool cp = t.ent == E_CP;
  float2 U[4], D[4], YU[4], YD[4];
  leg_product(let, t.m, cs, 4, U);
  leg_product(let, t.m, cs + 2, 4, D);
  const float2 phase = cp ? make_float2(cs[4 * t.m], cs[4 * t.m + 1])
                          : make_float2(1.f, 0.f);
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int e = 0; e < 4; ++e) YU[e] = YD[e] = make_float2(0.f, 0.f);
#pragma unroll
  for (int row = 0; row < 4; ++row) {
    const int p = row >> 1, q = row & 1;
#pragma unroll
    for (int col = 0; col < 4; ++col) {
      const int k = col >> 1, l = col & 1;
      float2 x;
      if (col < 2) {
        x = gbar[row * 4 + col];
      } else if (t.ent == E_CX) {
        x = gbar[row * 4 + 5 - col];
      } else if (col == 2) {
        x = gbar[row * 4 + 2];
      } else {
        x = gbar[row * 4 + 3];
        x = cp ? cmul(x, phase) : make_float2(-x.x, -x.y);
      }
      YU[2 * p + k] = cadd(YU[2 * p + k], cmul(x, D[2 * q + l]));
      YD[2 * q + l] = cadd(YD[2 * q + l], cmul(x, U[2 * p + k]));
    }
    if (cp)
      acc = cadd(acc, cmul(gbar[row * 4 + 3], cmul(U[2 * p + 1], D[2 * q + 1])));
  }
  if (cp) grad[2 * t.m] = 2.f * (-phase.y * acc.x - phase.x * acc.y);
  float2 v[4];
  mm2_bt(U, YU, v);
  leg_grads(let, t.m, cs, 4, v, grad, 2);
  mm2_bt(D, YD, v);
  leg_grads(let, t.m, cs + 2, 4, v, grad + 1, 2);
}

// Surface gate Rz(a2) Rx(a1) Rz(a0): one leg with the letters z, x, z.
__device__ inline void surface_gate(const float* cs, float2* G) {
  float2 U[4];
  leg_product(SurfaceLetters{}, 3, cs, 2, U);
#pragma unroll
  for (int e = 0; e < 4; ++e) G[e] = U[e];
}

// Its three angle gradients from the gate G and its cotangent Gbar.
__device__ inline void surface_grads(const float* cs, const float2* G,
                                     const float2* gbar, float* grad) {
  float2 v[4];
  mm2_bt(G, gbar, v);
  leg_grads(SurfaceLetters{}, 3, cs, 2, v, grad, 1);
}

// ------------------------------------------------------------ reductions
// Lane L returns the warp-wide sum of v[L] (31 shuffles for 32 values).
__device__ inline float warp_reduce_scatter32(float (&v)[32]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int step = 16; step >= 1; step >>= 1) {
    const bool upper = lane & step;
#pragma unroll
    for (int i = 0; i < step; ++i) {
      float send = upper ? v[i] : v[i + step];
      float keep = upper ? v[i + step] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, step);
    }
  }
  return v[0];
}

__device__ __forceinline__ int insert_zero(int x, int s) {
  return ((x >> s) << (s + 1)) | (x & ((1 << s) - 1));
}

// Indices in the row-major d x C state of one amplitude group of a K-qubit
// gate on row bits sa(, sb).
template <int K>
__device__ __forceinline__ void group_rows(int g, int log_c, int sa, int sb,
                                           int* idx) {
  const int col = g & ((1 << log_c) - 1);
  int r = g >> log_c;
  if (K == 1) {
    r = insert_zero(r, sa);
    idx[0] = (r << log_c) + col;
    idx[1] = ((r | (1 << sa)) << log_c) + col;
  } else {
    const int lo = sa < sb ? sa : sb, hi = sa < sb ? sb : sa;
    r = insert_zero(insert_zero(r, lo), hi);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      idx[p] = ((r | ((p >> 1) << sa) | ((p & 1) << sb)) << log_c) + col;
  }
}

// A <- G A on the gate's legs.
template <int K>
__device__ inline void apply_forward(float2* A, const float2* gsm, int n,
                                     int log_c, int sa, int sb) {
  constexpr int D = 1 << K;
  float2 G[D * D];
#pragma unroll
  for (int e = 0; e < D * D; ++e) G[e] = gsm[e];
  const int ngroups = (1 << (n + log_c)) >> K;
  for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
    int idx[D];
    group_rows<K>(g, log_c, sa, sb, idx);
    float2 a[D];
#pragma unroll
    for (int p = 0; p < D; ++p) a[p] = A[idx[p]];
#pragma unroll
    for (int p = 0; p < D; ++p) {
      float2 acc = make_float2(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < D; ++k) acc = cadd(acc, cmul(G[p * D + k], a[k]));
      A[idx[p]] = acc;
    }
  }
}

// One step of the adjoint walk through a gate: A <- G^dag A (state before
// the gate), gb[p,k] += sum M[p] A[k] (dL/dG), M <- G^T M.
template <int K>
__device__ inline void apply_backward(float2* A, float2* M, const float2* gsm,
                                      int n, int log_c, int sa, int sb,
                                      float (&gb)[32]) {
  constexpr int D = 1 << K;
  float2 G[D * D];
#pragma unroll
  for (int e = 0; e < D * D; ++e) G[e] = gsm[e];
  const int ngroups = (1 << (n + log_c)) >> K;
  for (int g = threadIdx.x; g < ngroups; g += blockDim.x) {
    int idx[D];
    group_rows<K>(g, log_c, sa, sb, idx);
    float2 a[D], m[D];
#pragma unroll
    for (int p = 0; p < D; ++p) { a[p] = A[idx[p]]; m[p] = M[idx[p]]; }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float2 ak = make_float2(0.f, 0.f), mk = make_float2(0.f, 0.f);
#pragma unroll
      for (int p = 0; p < D; ++p) {
        ak = cadd(ak, cmul(conj2(G[p * D + k]), a[p]));
        mk = cadd(mk, cmul(G[p * D + k], m[p]));
      }
#pragma unroll
      for (int p = 0; p < D; ++p) {
        float2 t = cmul(m[p], ak);
        gb[2 * (p * D + k)] += t.x;
        gb[2 * (p * D + k) + 1] += t.y;
      }
      A[idx[k]] = ak;
      M[idx[k]] = mk;
    }
  }
}

// ------------------------------------------------------- the chain of gates
// The steps of one evaluation and of its adjoint walk, as every kernel here
// runs them. None ends with a barrier unless it says so.

// cos and sin of each of the P angles, once, into cs[2i], cs[2i + 1]: of half
// the angle for a rotation, of the angle for a CP phase (the last of a CP
// block's angles).
__device__ __forceinline__ void angle_trig(const Template& t, int n, int P,
                                           const float* params, float* cs) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int bi = i - 3 * n;
    const bool phase = t.ent == E_CP && bi >= 0 && bi % t.nba == t.nba - 1;
    float s, c;
    sincosf(phase ? params[i] : 0.5f * params[i], &s, &c);
    cs[2 * i] = c;
    cs[2 * i + 1] = s;
  }
}

// The G = n + nb gate matrices (16 float2 each; a surface gate uses the first
// four) from the cos and sin of the angles, one gate per thread.
__device__ __forceinline__ void build_gates(const Template& t, int n, int G,
                                            const float* cs, float2* gates) {
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    if (j < n) surface_gate(cs + 6 * j, gates + 16 * j);
    else block_gate(t, cs + 2 * (3 * n + t.nba * (j - n)), gates + 16 * j);
  }
}

// A <- G_{G-1} ... G_0 A: the surface round, then every block on its
// placement (qubit 0 the most significant bit). A barrier after every gate.
__device__ __forceinline__ void forward_chain(float2* A, const float2* gates,
                                              const int* placements, int n,
                                              int nb, int log_c) {
  for (int q = 0; q < n; ++q) {
    apply_forward<1>(A, gates + 16 * q, n, log_c, n - 1 - q, 0);
    __syncthreads();
  }
  for (int b = 0; b < nb; ++b) {
    const int q0 = placements[2 * b], q1 = placements[2 * b + 1];
    apply_forward<2>(A, gates + 16 * (n + b), n, log_c, n - 1 - q0,
                     n - 1 - q1);
    __syncthreads();
  }
}

// The adjoint walk, last gate first: from A = the chain's output and
// M = dL/dA it rewinds A by unitarity, pulls M back, and leaves every gate's
// cotangent dL/dG in gbar (32 floats a gate). red: 2 x nw x 32 floats of
// cross-warp partials, double-buffered so that a gate costs one barrier.
// Ends with a barrier.
__device__ __forceinline__ void adjoint_walk(float2* A, float2* M,
                                             const float2* gates,
                                             const int* placements,
                                             float* red, float* gbar, int n,
                                             int G, int log_c, int nw) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = G - 1; j >= 0; --j) {
    float gb[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) gb[e] = 0.f;
    if (j >= n) {
      const int bb = j - n;
      const int q0 = placements[2 * bb], q1 = placements[2 * bb + 1];
      apply_backward<2>(A, M, gates + 16 * j, n, log_c, n - 1 - q0,
                        n - 1 - q1, gb);
    } else {
      apply_backward<1>(A, M, gates + 16 * j, n, log_c, n - 1 - j, 0, gb);
    }
    float part = warp_reduce_scatter32(gb);
    float* rb = red + (j & 1) * nw * 32;
    rb[warp * 32 + lane] = part;
    __syncthreads();
    if (tid < 32) {
      float s = 0.f;
      for (int w = 0; w < nw; ++w) s += rb[w * 32 + tid];
      gbar[32 * j + tid] = s;
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------- clusters
// Index in the row-major d x 2^log_c whole of entry e of the tile of rank
// `rank`, a row-major d x 2^log_ct block of its columns.
__device__ __forceinline__ int tile_to_global(int e, int log_c, int log_ct,
                                              int rank) {
  return ((e >> log_ct) << log_c) + (rank << log_ct) +
         (e & ((1 << log_ct) - 1));
}

// Sums the partials x[0..len) that the blocks of a cluster hold at the same
// shared-memory offset and leaves the sum in every block's x. One thread of
// the cluster sums entry i, over the ranks in the order 0, 1, ..., c - 1,
// and writes it to every block: all blocks then hold the same bits, so that
// the angles, which every block updates, never drift apart. Begins and ends
// with a cluster barrier.
__device__ inline void cluster_sum(float* x, int len) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster.sync();
  for (int i = rank * blockDim.x + threadIdx.x; i < len;
       i += c * blockDim.x) {
    float s = 0.f;
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
__device__ inline void cluster_agree(const float* x, int len) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() != 0) {
    const float* x0 = cluster.map_shared_rank(const_cast<float*>(x), 0);
    for (int i = threadIdx.x; i < len; i += blockDim.x)
      if (__float_as_uint(x[i]) != __float_as_uint(x0[i])) __trap();
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
                                            const float* cs,
                                            const float2* gates,
                                            const float* gbar, float* grad) {
  for (int j = threadIdx.x; j < G; j += blockDim.x) {
    const float2* gbj = reinterpret_cast<const float2*>(gbar + 32 * j);
    if (j < n) {
      surface_grads(cs + 6 * j, gates + 16 * j, gbj, grad + 3 * j);
    } else {
      const int off = 3 * n + t.nba * (j - n);
      block_grads(t, cs + 2 * off, gbj, grad + off);
    }
  }
}

}  // namespace

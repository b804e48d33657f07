// Device code of the row tiles' walk and chain (sweep.cu's
// sweep_rows_kernel and unitary.cu's vjp_rows_kernel): a state's one column
// split by rows over a cluster of c = 2^j blocks, each block's tile of
// 2^log_rows rows owned by its warps. unitary.cu's one-block kernels
// (forward_block_kernel, vjp_block_kernel) run the same code with c = 1
// and none of the cluster's (kOneBlock), on one column or on the whole
// unitary held column-major, whose "rows" are then the 2^(n + log w)
// entries of its w columns, whole columns a warp, so that its table has no
// swap; their gates take the lanes' own order on long segments (row_gate's
// kSwiz).
//
// A block holds rows [rho 2^log_rows, (rho + 1) 2^log_rows) of the d = 2^n
// amplitudes (gates.cuh, row tiles), and each of its W warps owns a
// contiguous segment of 2^seg of them (seg = log_rows - log2 W). A gate
// whose legs lie on the segment's bits touches only rows of one segment, so
// a warp runs it on its own segment, its lanes dealing out the amplitude
// groups as tiles.cuh's column tiles do (tile_forward, tile_backward; a lane
// past a gate's groups idles), and meets no other warp before the next gate:
// a warp barrier, no block barrier and no cluster barrier.
//
// The gates of a template touch every bit, so the bits move instead. The
// rows are kept under a permutation of their index bits: a qubit's bit may
// lie on a segment bit, on a bit that names the warp, or on one that names
// the block. Before a gate that needs a bit outside the segment, that bit is
// swapped with a segment bit the gate does not use, the one whose next use
// lies furthest ahead (Belady's rule). A swap inside the block is one pass
// over the tile in shared memory between two block barriers; a swap with a
// bit that names the block exchanges half of the tile with the block that
// differs in that bit, over distributed shared memory, 16 bytes a copy where
// the swapped segment bit is not bit 0 of a float tile, between two cluster
// barriers. The schedule depends on the template and the segment only: the
// wrapper computes it on the host (kernels/rows.py:schedule) as a table
// of ops, op.x >= 0 gate op.x on segment bits op.y (, op.z), op.x < 0 the
// swap of segment bit op.y with bit op.z (below log_rows a bit of the tile,
// above it one of the block's rank). The chain runs the table forward; the
// walk runs it backward, each swap its own inverse, on A and M. The table
// ends on the identity, so that the chain leaves the state in natural order
// (the loss reads the target as it is) and the walk starts from it (the
// vjp loads U as it is); it starts wherever the schedule needs, and e_0, the
// chain's input, is row 0 under every permutation. The forward pass's
// table (forward_rows_kernel) starts with the surface round already done:
// from e_0 it leaves a product state, which row_product writes in the
// table's first permutation, so that no bit is swapped for it.
//
// The walk's cotangents. A warp sums its lanes' shares of a gate's 32 reals
// by shuffles (columns.cuh's reduce_step, in registers: no local memory)
// into its slot of a ring in shared memory that holds `ring` gates; every
// `ring` gates the block meets at two barriers and sums the warps' slots in
// warp order into gbar, one entry a thread. A gate's cotangent does not
// depend on where its legs lie, as long as each leg keeps its role (op.y is
// the gate's first leg, sa, op.z its second, sb). Every sum runs in a fixed
// order, so two launches give the same bits; cluster_sum then adds the
// blocks' gbar in rank order, as before.
//
// What bounds it. A tile of A and M takes about 128 KB, so an SM holds one
// block, and its warps are the SM's: 16 in float, where 512 threads held to
// 128 registers fill the SM's registers, 8 in double. The gates' work is
// the 2x2 and 4x4 complex products of tiles.cuh on shared memory; the swaps
// move a tile's half once for every gate run the schedule saves a crossing.

#pragma once

#include "tiles.cuh"

namespace {

#ifdef CPFLOW_DOUBLE
constexpr int kRowThreads = 256;
#else
constexpr int kRowThreads = 512;
#endif
constexpr int kRowSegmentMin = 7;  // log2 of a segment's rows while warps
                                   // are split off: a two-qubit gate's 32
                                   // groups, one a lane
constexpr int kRowRingMax = 16;    // gates between two sums of the slots
constexpr int kRowSwizMin = 8;     // log2 of the fewest rows a warp owns
                                   // where row_gate takes the lanes' own
                                   // order

// A block of the row tiles: its warps, log2 of a warp's rows, the gates
// its ring of cotangent slots holds.
struct RowPlan {
  int warps, seg, ring;
};

// The plan of a tile of 2^log_rows rows whose ring may take `spare` bytes
// of shared memory (what the plan's layout leaves, with its cross-warp
// partials): a warp for every 2^kRowSegmentMin rows, at most kRowThreads
// threads, and a ring of as many gates, at most kRowRingMax and a power of
// two, as the bytes hold; the warps halve where a ring of one gate does not
// fit, down to one warp, whose ring of 32 reals the plan's own cross-warp
// partials (2 x its warps x 32 reals) always hold.
__host__ __device__ inline RowPlan row_plan(int log_rows, size_t spare) {
  const int split = log_rows > kRowSegmentMin ? log_rows - kRowSegmentMin : 0;
  int lw = 0;
  while (lw < split && (64 << lw) <= kRowThreads) ++lw;
  while (lw > 0 && ((size_t)32 << lw) * sizeof(real) > spare) --lw;
  int ring = kRowRingMax;
  while (ring > 1 && ((size_t)(32 * ring) << lw) * sizeof(real) > spare)
    ring >>= 1;
  return {1 << lw, log_rows - lw, ring};
}

// gates.cuh's angle_trig without local memory: in float column_sincos
// (columns.cuh) for sincosf, whose reduction of large arguments keeps a
// table in local memory, the whole of a kernel's stack frame; in double
// real_sincos, as angle_trig has it.
__device__ __forceinline__ void row_angle_trig(const Template& t, int n,
                                               int P, const real* params,
                                               real* cs) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    const int bi = i - 3 * n;
    const bool phase = t.ent == E_CP && bi >= 0 && bi % t.nba == t.nba - 1;
    const real x = phase ? params[i] : RL(0.5) * params[i];
#ifdef CPFLOW_DOUBLE
    real_sincos(x, cs + 2 * i + 1, cs + 2 * i);
#else
    column_sincos(x, cs + 2 * i + 1, cs + 2 * i);
#endif
  }
}

// --------------------------------------------------------------- swaps
// Exchanges the V-sized units at X + i and Y + j (V: one complex, or the
// 16 bytes of Vec16).
template <class V>
__device__ __forceinline__ void swap_at(cplx* X, int i, cplx* Y, int j) {
  V* p = reinterpret_cast<V*>(X + i);
  V* q = reinterpret_cast<V*>(Y + j);
  const V x = *p, y = *q;
  *p = y;
  *q = x;
}

// Swaps row bits s < b of the tile's 2^log_rows rows of X (and of Y with
// kM), the 2^(log_rows - 2) pairs dealt over the block, U rows a copy.
template <class V, bool kM>
__device__ __forceinline__ void swap_tile_bits(cplx* X, cplx* Y, int s,
                                               int b, int log_rows) {
  constexpr int U = sizeof(V) / sizeof(cplx);
  for (int i = U * threadIdx.x; i < 1 << (log_rows - 2);
       i += U * blockDim.x) {
    const int r = ins0(ins0(i, s), b);
    swap_at<V>(X, r | 1 << s, X, r | 1 << b);
    if (kM) swap_at<V>(Y, r | 1 << s, Y, r | 1 << b);
  }
}

// Swaps segment bit s with bit p of the block's rank: the block whose bit
// p is 0 gives its rows with bit s set for the rows with bit s clear of the
// block whose bit p is 1. The two blocks share the 2^(log_rows - 1) pairs,
// each half of them, U rows a copy over distributed shared memory.
template <class V, bool kM>
__device__ __forceinline__ void swap_split_bit(cplx* A, cplx* M, int s,
                                               int p, int log_rows,
                                               int rank) {
  namespace cg = cooperative_groups;
  constexpr int U = sizeof(V) / sizeof(cplx);
  cg::cluster_group cluster = cg::this_cluster();
  const int partner = rank ^ (1 << p), high = (rank >> p) & 1;
  cplx* Ar = cluster.map_shared_rank(A, partner);
  cplx* Mr = kM ? cluster.map_shared_rank(M, partner) : nullptr;
  const int half = 1 << (log_rows - 2);
  for (int i = high * half + U * threadIdx.x; i < (high + 1) * half;
       i += U * blockDim.x) {
    const int r1 = ins0(i, s) | 1 << s, r0 = r1 ^ 1 << s;
    const int here = high ? r0 : r1, there = high ? r1 : r0;
    swap_at<V>(A, here, Ar, there);
    if (kM) swap_at<V>(M, here, Mr, there);
  }
}

// The swap of segment bit s with bit b, of the tile (b < log_rows) between
// two block barriers, or of the rank (b - log_rows) between two cluster
// barriers; on A, and on M with kM. Without kCluster (one block a restart:
// log_rows = n, every bit the tile's) no cluster code is compiled in.
template <bool kM, bool kCluster = true>
__device__ __forceinline__ void row_swap(cplx* A, cplx* M, int s, int b,
                                         int log_rows, int rank) {
  const bool wide = kPer16 == 1 || s > 0;  // 16 bytes a copy
  if (!kCluster || b < log_rows) {
    __syncthreads();
    if (wide) swap_tile_bits<Vec16, kM>(A, M, s, b, log_rows);
    else swap_tile_bits<cplx, kM>(A, M, s, b, log_rows);
    __syncthreads();
    return;
  }
  if constexpr (kCluster) {
    namespace cg = cooperative_groups;
    cg::this_cluster().sync();
    if (wide) swap_split_bit<Vec16, kM>(A, M, s, b - log_rows, log_rows, rank);
    else swap_split_bit<cplx, kM>(A, M, s, b - log_rows, log_rows, rank);
    cg::this_cluster().sync();
  }
}

// ------------------------------------------------ the chain and the walk
// The state the surface round leaves from e_0, forward_rows_kernel's start
// (the first n ops of its table, kernels/rows.py:schedule with forward):
// a product of each qubit's amplitudes, the first column of its surface
// gate, qubit n - 1 - ops[v].z on row bit v. Each warp fills its own
// segment, lane l its rows l, l + 32, ...: the factors of the bits a
// lane's rows share once, the others' a row. The caller's warp barrier
// follows.
__device__ __forceinline__ void row_product(cplx* A, const cplx* gates,
                                            const int4* ops, int n,
                                            const RowPlan& p, int log_rows,
                                            int rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int low = p.seg < 5 ? p.seg : 5;  // the bits that name a lane
  if (lane >= 1 << low) return;
  const int row0 = (rank << log_rows) | (warp << p.seg) | lane;
  cplx c = mkc(RL(1.), RL(0.));
  for (int v = 0; v < n; ++v) {
    if (v >= low && v < p.seg) continue;
    const int q = n - 1 - __ldg(&ops[v].z);
    c = cmul(c, gates[16 * q + 2 * ((row0 >> v) & 1)]);
  }
  cplx* X = A + (warp << p.seg);
  for (int i = 0; i < 1 << (p.seg - low); ++i) {
    const int e = lane | (i << low);
    cplx a = c;
    for (int v = low; v < p.seg; ++v) {
      const int q = n - 1 - __ldg(&ops[v].z);
      a = cmul(a, gates[16 * q + 2 * ((e >> v) & 1)]);
    }
    X[e] = a;
  }
}

// A K-qubit gate on the warp's segment X of 2^seg rows (Y: its rows of M),
// forward, or in the walk with its share of the cotangent into gb:
// tiles.cuh's tile_forward and tile_backward; with kSwiz (the one-block
// kernels of unitary.cu), where a warp owns at least 2^kRowSwizMin rows
// and the gate has a leg on a row bit below kBankBits, its warp_forward
// and warp_backward, whose lanes take the gate's amplitudes in an order of
// their own, so that a wavefront's rows fall on distinct banks. On a
// shorter segment a lane has one or two amplitude groups of a gate, and
// the order's own work outweighs the conflicts it saves (at 9 qubits 10%
// slower, at 4 qubits 14%; at 13 qubits 1.16 times faster: PERF.md §6).
template <int K, bool kSwiz>
__device__ __forceinline__ void row_gate(cplx* X, const cplx* g, int seg,
                                         int sa, int sb, int lane) {
  if (kSwiz && seg >= kRowSwizMin && low_leg<K>(sa, sb)) {
    const WarpColumns wc{0, 1, 1, lane, 32};
    warp_forward<K, true>(X, 0, g, seg, sa, sb, wc);
  } else {
    tile_forward<K>(X, g, seg, sa, sb, lane, 32);
  }
}

template <int K, bool kSwiz>
__device__ __forceinline__ void row_gate_back(cplx* X, cplx* Y, const cplx* g,
                                              int seg, int sa, int sb,
                                              int lane, real (&gb)[32]) {
  if (kSwiz && seg >= kRowSwizMin && low_leg<K>(sa, sb)) {
    const WarpColumns wc{0, 1, 1, lane, 32};
    warp_backward<K, true>(X, Y, 0, g, seg, sa, sb, wc, gb);
  } else {
    tile_backward<K>(X, Y, g, seg, sa, sb, lane, 32, gb);
  }
}

// A <- G_{G-1} ... G_0 A on the block's row tile: the schedule's ops in
// order, each gate on its warp's segment, a warp barrier after it. Ends with
// a block barrier. kOneBlock (unitary.cu's one-block kernels): the swaps
// without cluster code (row_swap's kCluster false) and the gates in the
// lanes' own order (row_gate's kSwiz).
template <bool kOneBlock = false>
__device__ __forceinline__ void row_chain(cplx* A, const cplx* gates,
                                          const int4* ops, int nops, int n,
                                          const RowPlan& p, int log_rows,
                                          int rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cplx* X = A + (warp << p.seg);
  for (int i = 0; i < nops; ++i) {
    const int4 op = __ldg(ops + i);
    if (op.x < 0) {
      row_swap<false, !kOneBlock>(A, nullptr, op.y, op.z, log_rows, rank);
      continue;
    }
    if (op.x < n)
      row_gate<1, kOneBlock>(X, gates + 16 * op.x, p.seg, op.y, 0, lane);
    else
      row_gate<2, kOneBlock>(X, gates + 16 * op.x, p.seg, op.y, op.z, lane);
    __syncwarp();
  }
  __syncthreads();
}

// The sum of the warps' slots of gates j0 .. min(j0 + ring, G) - 1, in warp
// order (with kTree pairwise, tiles.cuh's pairwise_sum), into gbar[32 j + e]
// (a surface gate's 8 reals; its other 24 are written 0), one entry a
// thread, between two block barriers: the first so that every warp's slots
// are in, the second so that none is overwritten before it is read.
template <bool kTree = false>
__device__ __forceinline__ void row_flush(const real* ring, real* gbar,
                                          int j0, int n, int G,
                                          const RowPlan& p) {
  __syncthreads();
  for (int i = threadIdx.x; i < p.ring * 32; i += blockDim.x) {
    const int r = i >> 5, e = i & 31, j = j0 + r;
    if (j >= G) break;
    real s = RL(0.);
    if (j >= n || e < 8) {
      if constexpr (kTree)
        s = pairwise_sum(ring + r * 32 + e, p.ring * 32, p.warps);
      else
        for (int w = 0; w < p.warps; ++w)
          s += ring[(w * p.ring + r) * 32 + e];
    }
    gbar[32 * j + e] = s;
  }
  __syncthreads();
}

// The adjoint walk on the block's row tile, last gate first: the
// schedule's ops backward, each gate on its warp's segment (A rewound, M
// pulled back, the warp's share of the gate's cotangent into its ring
// slot), each swap on A and M. Leaves the block's share of every gate's
// cotangent in gbar, for cluster_sum. Ends with a block barrier.
// kOneBlock: as row_chain; kTree: the warps' slots summed pairwise
// (row_flush).
template <bool kOneBlock = false, bool kTree = false>
__device__ __forceinline__ void row_walk(cplx* A, cplx* M, const cplx* gates,
                                         const int4* ops, int nops,
                                         real* ring, real* gbar, int n,
                                         int G, const RowPlan& p,
                                         int log_rows, int rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  cplx* X = A + (warp << p.seg);
  cplx* Y = M + (warp << p.seg);
  real* slots = ring + warp * p.ring * 32;
  for (int i = nops - 1; i >= 0; --i) {
    const int4 op = __ldg(ops + i);
    if (op.x < 0) {
      row_swap<true, !kOneBlock>(A, M, op.y, op.z, log_rows, rank);
      continue;
    }
    const int j = op.x, slot = j & (p.ring - 1);
    real gb[32];
    int base = 0;
    if (j >= n) {
#pragma unroll
      for (int e = 0; e < 32; ++e) gb[e] = RL(0.);
      row_gate_back<2, kOneBlock>(X, Y, gates + 16 * j, p.seg, op.y, op.z, lane,
                              gb);
      reduce_step<16, 32>(gb, lane, base, kFull);
      slots[slot * 32 + base] = gb[0];
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) gb[e] = RL(0.);
      row_gate_back<1, kOneBlock>(X, Y, gates + 16 * j, p.seg, op.y, 0, lane,
                              gb);
      reduce_step<16, 8>(gb, lane, base, kFull);
      if ((lane & 3) == 0) slots[slot * 32 + base] = gb[0];
    }
    __syncwarp();
    if (slot == 0) row_flush<kTree>(ring, gbar, j, n, G, p);
  }
}


// ------------------------------------------------------- global row tiles
// A column too wide for a cluster's shared memory (unitary.cu's
// forward_global_kernel and vjp_global_kernel): it stays in device memory
// in natural order, and each launch (a pass) runs every tile of 2^log_rows
// rows on a block of its own, the bits on row bits log_rows ... n - 1 (the
// global bits) naming the tile. A pass's table (kernels/rows.py:
// global_schedule) starts with n rows (-2, v, b, 0), row bit v holding bit
// b of the amplitudes' index when the pass begins; its swaps never leave
// the tile. The block loads its tile under that permutation and stores it
// under the one the swaps leave, so every address is an amplitude's own
// index and the column is in natural order between passes, whatever
// permutation a pass runs in. Both permutations hold the tile's lowest
// address bits on the lowest row bits, in order (at least bit 0, the
// sector bit), so a thread copies 16 bytes, two neighbouring amplitudes in
// float, in increasing address order: a warp reads and writes whole 32-byte
// sectors, and eight threads' rows fall on distinct banks. The rows and
// addresses come from the pass's tables, made on the host
// (kernels/rows.py:global_maps): row(i) = T[i & 127] | T[128 + (i >> 7)]
// for the tile's i-th amplitude in address order, its address bits the
// same way, and the tile's base address from its index t.

constexpr int kGlobalMapInts = 1536;  // a pass's tables in device memory
constexpr int kGlobalMapBytes = 4096;  // the 8 of them a block holds: rows,
                                       // addresses, for each end of a pass

// Thread 0: arrives on *bar expecting `bytes` in all, from the bulk copies
// that follow (bulk_copy).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Thread 0: starts the copy of `bytes` (a multiple of 16, both ends
// 16-byte aligned) from global src to shared dst, completing on *bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The tile row and the address bits of the tile's i-th amplitude in
// address order, from the tables of one end of the pass (m: 512 ints).
__device__ __forceinline__ int global_row(const int* m, int i) {
  return m[i & 127] | m[128 + (i >> 7)];
}
__device__ __forceinline__ int global_addr(const int* m, int i) {
  return m[256 + (i & 127)] | m[384 + (i >> 7)];
}

// The address bits that tile t's index sets at end `at` of the pass (maps:
// the pass's tables in device memory).
__device__ __forceinline__ size_t global_base(const int* maps, int at,
                                              int t) {
  const int* b = maps + 1024 + 256 * at;
  return (size_t)(__ldg(b + (t & 127)) | __ldg(b + 128 + (t >> 7)));
}

// Tile `base` of the column(s) x (and y with kM) into the shared rows X (Y)
// under the tables m, 16 bytes a copy by cp.async. Waits for the block's
// own copies; the caller's barrier publishes them.
template <bool kM>
__device__ __forceinline__ void global_load(cplx* X, cplx* Y, const cplx* x,
                                            const cplx* y, const int* m,
                                            size_t base, int log_rows) {
  for (int i = kPer16 * threadIdx.x; i < 1 << log_rows;
       i += kPer16 * blockDim.x) {
    const int e = global_row(m, i);
    const size_t addr = base | (size_t)global_addr(m, i);
    __pipeline_memcpy_async(X + e, x + addr, 16);
    if (kM) __pipeline_memcpy_async(Y + e, y + addr, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// The shared rows X (Y) into tile `base` of the column(s) x (y) under the
// tables m, 16 bytes a copy.
template <bool kM>
__device__ __forceinline__ void global_store(const cplx* X, const cplx* Y,
                                             cplx* x, cplx* y, const int* m,
                                             size_t base, int log_rows) {
  for (int i = kPer16 * threadIdx.x; i < 1 << log_rows;
       i += kPer16 * blockDim.x) {
    const int e = global_row(m, i);
    const size_t addr = base | (size_t)global_addr(m, i);
    *reinterpret_cast<Vec16*>(x + addr) =
        *reinterpret_cast<const Vec16*>(X + e);
    if (kM)
      *reinterpret_cast<Vec16*>(y + addr) =
          *reinterpret_cast<const Vec16*>(Y + e);
  }
}

// The warp's sum of v by xor shuffles (the same order on every lane).
__device__ __forceinline__ cplx warp_csum(cplx v) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    v.x += __shfl_xor_sync(kFull, v.x, s);
    v.y += __shfl_xor_sync(kFull, v.y, s);
  }
  return v;
}

// The product of the factors w[2 u + bit u of x] over u in [0, bits),
// leaving out u = skip.
__device__ __forceinline__ cplx factor_product(const cplx* w, int x, int bits,
                                               int skip) {
  cplx p = mkc(RL(1.), RL(0.));
  for (int u = 0; u < bits; ++u)
    if (u != skip) p = cmul(p, w[2 * u + ((x >> u) & 1)]);
  return p;
}

// The surface round's cotangents, the vjp's last launch (its first pass).
// The walk has rewound A to the product state that the surface round
// leaves from e_0, each qubit's factor a_q the first column of its surface
// gate (gates[16 q + 2 r]), so the input of surface gate q is e_0 on qubit
// q: its cotangent (tile_backward's sum of M[p] A[k] at the gate, M pulled
// back through the later surface gates) has one non-zero column,
//   Gbar_q[r][0] = sum over x with x_q = r of M[x] prod_{p != q} a_p[x_p],
// the contraction of M with the other qubits' factors. The tile's share,
// M's rows under the pass's start permutation (row bit v holding address
// bit ops[v].z, qubit n - 1 - ops[v].z): the row bits split at 6, Y[hi] =
// sum_lo M[hi, lo] W_lo[lo] and X[lo] = sum_hi M[hi, lo] W_hi[hi] (W the
// products of each half's factors), then each row bit's two sums from X or
// Y with the factors of its half's other bits, all times c, the product of
// the global bits' factors at the tile's index; a global bit's qubit gets
// c without its own factor times the whole sum, in its entry for the
// tile's value of the bit, and 0 in the other. Every sum runs in a fixed
// order. Writes the 8 reals of each surface gate's share at out + 32 (q
// tiles + t) (kernels/rows.py numbers the tiles); S: scratch of at least
// 2^log_rows complex (A, free once the walk is done). Starts and ends
// with a block barrier.
__device__ __forceinline__ void surface_contract(const cplx* M, cplx* S,
                                                 const cplx* gates,
                                                 const int4* ops, int n,
                                                 int log_rows, int t,
                                                 real* out, int tiles) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int hb = log_rows - 6, H = 1 << hb, ng = n - log_rows;
  const int chunks = nt >= 64 ? nt / 64 : 1;
  cplx* w = S;               // 2 log_rows factors: row bit v's at 2 v + r
  cplx* c = S + 32;          // c[i]: without global bit i; c[ng]: all
  cplx* sums = S + 64;       // 2 a row bit, then the whole sum
  cplx* Wlo = S + 128;       // 64
  cplx* X = S + 192;         // 64
  cplx* Whi = S + 256;       // H
  cplx* Y = Whi + H;         // H
  cplx* part = Y + H;        // chunks x 64
  __syncthreads();
  for (int v = tid; v < log_rows; v += nt) {
    const cplx* g = gates + 16 * (n - 1 - __ldg(&ops[v].z));
    w[2 * v] = g[0];
    w[2 * v + 1] = g[2];
  }
  for (int i = tid; i <= ng; i += nt) {
    cplx p = mkc(RL(1.), RL(0.));
    for (int k = 0; k < ng; ++k)
      if (k != i)
        p = cmul(p, gates[16 * (n - 1 - __ldg(&ops[log_rows + k].z)) +
                          2 * ((t >> k) & 1)]);
    c[i] = p;
  }
  __syncthreads();
  for (int x = tid; x < 64 + H; x += nt) {
    if (x < 64) Wlo[x] = factor_product(w, x, 6, -1);
    else Whi[x - 64] = factor_product(w + 12, x - 64, hb, -1);
  }
  __syncthreads();
  for (int hi = warp; hi < H; hi += nw) {  // Y: a warp a row of 64
    const cplx* m = M + (hi << 6);
    cplx v = cmul(m[lane], Wlo[lane]);
    v = cadd(v, cmul(m[32 + lane], Wlo[32 + lane]));
    v = warp_csum(v);
    if (lane == 0) Y[hi] = v;
  }
  for (int i = tid; i < chunks * 64; i += nt) {  // X: chunks of the rows
    const int lo = i & 63;
    cplx v = mkc(RL(0.), RL(0.));
    for (int hi = i >> 6; hi < H; hi += chunks)
      v = cadd(v, cmul(M[(hi << 6) | lo], Whi[hi]));
    part[i] = v;
  }
  __syncthreads();
  for (int lo = tid; lo < 64; lo += nt) {
    cplx v = part[lo];
    for (int k = 1; k < chunks; ++k) v = cadd(v, part[k * 64 + lo]);
    X[lo] = v;
  }
  __syncthreads();
  for (int v = warp; v <= log_rows; v += nw) {  // a warp a row bit
    cplx s0 = mkc(RL(0.), RL(0.)), s1 = s0;
    if (v < 6) {
      const int x = ins0(lane, v);
      const cplx p = factor_product(w, x, 6, v);
      s0 = cmul(X[x], p);
      s1 = cmul(X[x | 1 << v], p);
    } else if (v < log_rows) {
      const int u = v - 6;
      for (int l = lane; l < H / 2; l += 32) {
        const int x = ins0(l, u);
        const cplx p = factor_product(w + 12, x, hb, u);
        s0 = cadd(s0, cmul(Y[x], p));
        s1 = cadd(s1, cmul(Y[x | 1 << u], p));
      }
    } else {  // the whole sum
      s0 = cadd(cmul(X[lane], Wlo[lane]), cmul(X[32 + lane], Wlo[32 + lane]));
    }
    s0 = warp_csum(s0);
    s1 = warp_csum(s1);
    if (lane == 0) {
      sums[2 * v] = s0;
      sums[2 * v + 1] = s1;
    }
  }
  __syncthreads();
  for (int v = tid; v < n; v += nt) {
    cplx g0, g1;
    if (v < log_rows) {
      g0 = cmul(c[ng], sums[2 * v]);
      g1 = cmul(c[ng], sums[2 * v + 1]);
    } else {
      const cplx all = cmul(c[v - log_rows], sums[2 * log_rows]);
      const cplx zero = mkc(RL(0.), RL(0.));
      const bool one = (t >> (v - log_rows)) & 1;
      g0 = one ? zero : all;
      g1 = one ? all : zero;
    }
    real* o = out + ((size_t)(n - 1 - __ldg(&ops[v].z)) * tiles + t) * 32;
    o[0] = g0.x;
    o[1] = g0.y;
    o[2] = o[3] = RL(0.);
    o[4] = g1.x;
    o[5] = g1.y;
    o[6] = o[7] = RL(0.);
  }
  __syncthreads();
}

}  // namespace

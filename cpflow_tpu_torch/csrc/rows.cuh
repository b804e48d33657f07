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
// order, into gbar[32 j + e] (a surface gate's 8 reals; its other 24 are
// written 0), one entry a thread, between two block barriers: the first so
// that every warp's slots are in, the second so that none is overwritten
// before it is read.
__device__ __forceinline__ void row_flush(const real* ring, real* gbar,
                                          int j0, int n, int G,
                                          const RowPlan& p) {
  __syncthreads();
  for (int i = threadIdx.x; i < p.ring * 32; i += blockDim.x) {
    const int r = i >> 5, e = i & 31, j = j0 + r;
    if (j >= G) break;
    real s = RL(0.);
    if (j >= n || e < 8)
      for (int w = 0; w < p.warps; ++w) s += ring[(w * p.ring + r) * 32 + e];
    gbar[32 * j + e] = s;
  }
  __syncthreads();
}

// The adjoint walk on the block's row tile, last gate first: the
// schedule's ops backward, each gate on its warp's segment (A rewound, M
// pulled back, the warp's share of the gate's cotangent into its ring
// slot), each swap on A and M. Leaves the block's share of every gate's
// cotangent in gbar, for cluster_sum. Ends with a block barrier.
// kOneBlock: as row_chain.
template <bool kOneBlock = false>
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
    if (slot == 0) row_flush(ring, gbar, j, n, G, p);
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
// permutation a pass runs in. The sector bits (bit 0, and bit 1 in float)
// lie in every pass's tile, and a block copies its tile in increasing
// address order, so that a warp reads and writes whole 32-byte sectors.

// A pass's two permutations, at its start (0) and its end (1): row bit ->
// address bit, and the tile's address bits in increasing order with the
// row bit of each.
struct GlobalMaps {
  int held[2][32];
  int bit[2][32];
  int row[2][32];
};

// The pass's maps from its table (nops int4, the n header rows first),
// formed by thread 0. Ends with a block barrier.
__device__ __forceinline__ void global_maps(const int4* ops, int nops, int n,
                                            int log_rows, GlobalMaps* m) {
  if (threadIdx.x == 0) {
    for (int v = 0; v < n; ++v) m->held[0][v] = m->held[1][v] = ops[v].z;
    for (int i = n; i < nops; ++i) {
      const int4 op = ops[i];
      if (op.x != -1) continue;
      const int y = m->held[1][op.y];
      m->held[1][op.y] = m->held[1][op.z];
      m->held[1][op.z] = y;
    }
    for (int at = 0; at < 2; ++at) {
      int k = 0;
      for (int b = 0; b < n; ++b)
        for (int v = 0; v < log_rows; ++v)
          if (m->held[at][v] == b) {
            m->bit[at][k] = b;
            m->row[at][k++] = v;
          }
    }
  }
  __syncthreads();
}

// The address of the tile's amplitude base + i-th (in increasing address
// order) under permutation `at`, and the tile row that holds it.
__device__ __forceinline__ size_t global_address(const GlobalMaps& m, int at,
                                                 size_t base, int i,
                                                 int log_rows, int* e) {
  size_t addr = base;
  int r = 0;
  for (int u = 0; u < log_rows; ++u)
    if ((i >> u) & 1) {
      addr |= (size_t)1 << m.bit[at][u];
      r |= 1 << m.row[at][u];
    }
  *e = r;
  return addr;
}

// The address bits that tile t's index sets under permutation `at`.
__device__ __forceinline__ size_t global_base(const GlobalMaps& m, int at,
                                              int n, int log_rows, int t) {
  size_t base = 0;
  for (int i = 0; i < n - log_rows; ++i)
    if ((t >> i) & 1) base |= (size_t)1 << m.held[at][log_rows + i];
  return base;
}

// Tile t of the column(s) x (and y with kM) into the shared rows X (Y)
// under permutation `at`; kHalf: Y = conj(y) / 2 (the vjp's M from Ubar).
template <bool kM, bool kHalf>
__device__ __forceinline__ void global_load(cplx* X, cplx* Y, const cplx* x,
                                            const cplx* y,
                                            const GlobalMaps& m, int at,
                                            int n, int log_rows, int t) {
  const size_t base = global_base(m, at, n, log_rows, t);
  for (int i = threadIdx.x; i < 1 << log_rows; i += blockDim.x) {
    int e;
    const size_t addr = global_address(m, at, base, i, log_rows, &e);
    X[e] = x[addr];
    if (kM) {
      const cplx v = y[addr];
      Y[e] = kHalf ? mkc(RL(0.5) * v.x, RL(-0.5) * v.y) : v;
    }
  }
}

// The shared rows X (Y) into tile t of the column(s) x (y) under
// permutation `at`.
template <bool kM>
__device__ __forceinline__ void global_store(const cplx* X, const cplx* Y,
                                             cplx* x, cplx* y,
                                             const GlobalMaps& m, int at,
                                             int n, int log_rows, int t) {
  const size_t base = global_base(m, at, n, log_rows, t);
  for (int i = threadIdx.x; i < 1 << log_rows; i += blockDim.x) {
    int e;
    const size_t addr = global_address(m, at, base, i, log_rows, &e);
    x[addr] = X[e];
    if (kM) y[addr] = Y[e];
  }
}

}  // namespace

// The two-qubit-block ansatz as a differentiable function of its angles:
// two kernels, the forward pass angles -> U and its vector-Jacobian product,
// each in two designs.
//
// No TPU kernel stands behind them. They replace
// cpflow_tpu/sim/batched.py:make_reversible_builder (its fwd and bwd), a
// jax.custom_vjp that XLA fused on the TPU and that nothing fuses on Hopper:
// without them a loss that the fused sweep (sweep.cu) does not know, a
// Python callable of U, would fall to one small library launch per gate and
// per restart batch. kernels/unitary.py wraps the pair as one
// torch.autograd.Function.
//
//   ansatz_forward: angles (P, B) real -> U (B, d, C) complex: the cos
//     and sin of each angle once, the gates in factored 2x2 form
//     (gates.cuh), the surface round and every block applied to the
//     identity's columns, then a store of the state.
//   ansatz_vjp: angles (P, B), U (B, d, C) as the forward stored it, and the
//     cotangent g of U as PyTorch hands it to a backward (dL/dRe + i dL/dIm
//     of a real L, which is conj(2 M) for the holomorphic partial
//     M = dL/dU of gates.cuh) -> dL/dangles (P, B). It loads A = U and
//     M = conj(g) / 2 and runs the adjoint walk: it rewinds A by unitarity
//     (A_{j-1} = G_j^dag A_j), pulls M back (M_{j-1} = G_j^T M_j) and sums
//     every gate's cotangent, then each angle's gradient
//     2 Re sum Gbar * dG/dtheta. No intermediate state is stored or read.
//
// What bounds them at the main paths' shapes. The paths that launch them (a
// custom loss, a history, the non-Adam methods, Ansatz.learn) hand over
// 5 to 800 restarts at 3 and 4 qubits: the whole batch is resident on the
// card at once, and a launch lasts as long as one restart's work, the
// prologue (the cos and sin of its angles, its gate matrices) and then its
// chain of n + k gates, each waiting on the last. So latency bounds them,
// not the float32 rate (at 3q k=12 B=1024 on an H100 the forward pass needs
// 0.0005 ms of float32 work and the walk 0.0014 ms, against 0.0079 and
// 0.0213 ms on the card, PERF.md) and not device memory (the forward pass
// writes, and the walk reads twice, 8 d C bytes a restart).
//
// The column design (the whole unitary at 2 to 6 qubits; columns.cuh) cuts
// that latency. Every gate acts on row bits only, so a lane owns one column
// of a restart: the walk runs on it with no barrier, rewinding the column
// and pulling its cotangent back, and sums each gate's cotangent over the
// restart's lanes by shuffles, held in registers until the next gate has
// been applied. A restart takes one warp (two at 6 qubits), so the prologue
// and the angle gradients, which cost a small restart more than its chain,
// spread over 32 lanes; in the forward pass at 2 to 4 qubits the 32 / C
// lanes of a column share its amplitude groups, with a warp barrier after
// each gate. No block barrier falls inside the chain or the walk. Blocks of
// 64 threads, two restarts (one at 6 qubits), one where that layout does not
// fit: the runtime places 8 to 10 of them on an SM at 3 and 4 qubits
// (chip_smoke.py phase 12), so a main path's whole batch is resident, and
// blocks of one restart measured no faster.
//
// The row-split design (one column, n <= 17, and the vjp of the whole
// unitary at 7 and 8 qubits): its plan (make_layout, cluster_plan) gives
// each restart one thread block, or where that layout does not fit one
// block's shared memory (the vjp holds A and M, 16 * 4^n bytes for the
// whole unitary) c = 2, 4, 8 or 16 blocks, the smallest c whose layout
// fits. No kernel of the design keeps its first form (a block barrier after
// every gate, each gate's cotangent reduced over the block before the
// next): each runs on the warps of rows.cuh or tiles.cuh. One block a
// restart (forward_block_kernel, vjp_block_kernel) runs rows.cuh's warps
// with no cluster: one column, every bit a gate needs swapped in inside
// the block (at 7 qubits or fewer one warp owns the column and nothing is
// swapped); the whole unitary (templates below 7 qubits too deep for the
// column design) held column-major with no pad, so that a warp's segment
// holds whole columns, every lane has an amplitude group of every gate
// down to 6 qubits, and the table has no swap (tiles.cuh's warps, a column
// or more a warp, leave half the lanes idle below 7 qubits: 1.23 to 1.40
// times the first design's time at 6 qubits, PERF.md); its forward pass
// runs the same way on each of the plan's c independent blocks, d / c
// columns each. On a cluster, a restart's columns are split over its c
// blocks, each holding d x (d / c) of them on tiles.cuh's warps
// (vjp_kernel, below): no block barrier or cross-warp sum between
// two gates, the gates built once a cluster, and the gates' cotangents
// summed over distributed shared memory in rank order before the angle
// gradients. One column has too few columns to
// share out: above 13 qubits (12 in double) its rows are split instead,
// d / c a block (gates.cuh, row tiles), and both passes become clusters
// (forward_rows_kernel, vjp_rows_kernel). In both, each block's rows are
// owned by its warps (rows.cuh), which run each gate on a warp's own
// segment and swap in the bits a gate needs from outside it, inside the
// block or with another block, as the wrapper's table for the pass's
// segment says (kernels/rows.py); the vjp sums its cotangents as the tiles
// of columns do. The vjp splits a qubit
// sooner than the forward pass, which holds no M: at k = 2n 'xyz' 14, 15,
// 16, 17 qubits take 2, 4, 8, 16 blocks in the vjp and 1, 2, 4, 8 in the
// forward pass. A cluster of 16 is non-portable: each cluster kernel is
// given cudaFuncAttributeNonPortableClusterSizeAllowed once per device,
// and a launch whose cluster the card cannot place fails before it
// starts. At 7 and 8 qubits a column of A and M (4 and 8 KB) and a
// restart's layout exceed what one lane and one block hold.
//
// The column tiles (the forward pass of the whole unitary from 7 qubits;
// the vjp past what a cluster of 16 holds: 9 qubits and up, in float to 13
// and in double to 12): a restart's columns on 2^j independent blocks, no
// cluster, the fewest tiles that fit (forward_tile_log, tile_log; the vjp's
// tiles of 16, 8 and 4 columns at 9, 10 and 11 qubits in float, 8, 4 and 2
// in double, the forward pass's twice as wide). Both run the design of
// tiles.cuh (a tile's columns owned by warps). The forward pass's tiles
// never meet; the vjp's (the gates built once a call by a prologue) meet
// in the sum of the gates' cotangents, which a last kernel forms in a
// fixed order from shares the tiles leave in global memory (the column
// tiles section below).
//
// The global row tiles (one column past what a cluster of 16 holds: from
// 18 qubits in float and 17 in double to kGlobalMaxQubits, 24 and 23): the
// column stays in device memory and runs a launch a pass, each tile of
// rows on a block of its own on rows.cuh's warps, a gate with a bit outside
// the tile ending the pass, the surface round written as a product state
// and contracted in the vjp rather than walked (global_gates_kernel, the
// gates once a call; forward_global_kernel, vjp_global_kernel and the
// vjp's fixed-order sum, vjp_global_sum_kernel; the section below).
//
// Why no tensor cores: the products are 2x2 and 4x4 complex matrices
// applied to one column at a time, far below wgmma's tile of 64 rows, and
// TF32's 10-bit mantissa would break the 2e-5 (unitary) and 1e-4
// (gradient) agreement with the plain float32 version (and tensor cores
// hold no double complex product either). Why no cluster for the whole
// unitary below 7 qubits: a restart's whole layout fits one block there,
// and a column never needs another block's data; one column split by rows
// does, at every gate on a split bit, and takes a cluster only past one
// block's shared memory.
//
// Precision: the file compiles twice (gates.cuh), in float for complex64
// and with -DCPFLOW_DOUBLE in double for complex128. The double build's
// tiles take twice the bytes; the column kernels keep every layout up to 6
// qubits at k = 40, the row-split vjp of the whole unitary at 8 qubits
// takes 16 blocks (up to k = 125 'xyz' blocks), and one column fits one
// block up to 12 qubits (13 in float) and 16 blocks up to 16 (17 in
// float).
// No kernel holds local memory (the cos and sin from rows.cuh's
// row_angle_trig, columns.cuh's column_sincos or gates.cuh's real_sincos).
//
// The design is an explicit argument of the launch; kernels/unitary.py
// passes the plan's (cpflow_unitary_design), which it mirrors for the
// checks without a card. A launch the design does not take fails; nothing
// falls back.

#include "gates.cuh"
#include "columns.cuh"
#include "rows.cuh"

namespace {

struct Args {
  const real* angles;    // (P, B)
  cplx* U;              // (B, d, C): written by forward, read by vjp
  const cplx* Ubar;     // (B, d, C): dL/dRe U + i dL/dIm U (vjp only)
  real* grad;            // (P, B): written by vjp
  const int* placements;  // (nb, 2)
  Template tpl;
  int n, nb, log_c, B, cluster_log;
  int restarts;           // restarts a block (column design)
};

// The row tiles' arguments: the row schedule (rows.cuh; the wrapper's
// table, nops int4 of it in device memory) and the row tiles' plan.
struct RowArgs : Args {
  const int4* ops;
  int nops;
  RowPlan plan;
};

struct Layout {
  int P, G, nt, nw;
  size_t off_M, off_gates, off_gbar, off_red, off_params, off_grad, off_cs,
      bytes;
};

// The row-split design's plan: shared memory of one block of a restart
// split over 2^cluster_log blocks as its first kernels laid it out (A, M,
// the gates, gbar, 2 x nw x 32 reals of cross-warp partials in red, the
// angles, the gradient, the cos and sin; the forward pass keeps no M,
// gbar, red and grad). Its bytes decide cluster_plan, which the kernels
// keep; the row layouts below take it with red made their ring.
__host__ __device__ inline Layout make_layout(int n, int nb, int nba,
                                              int log_c, int cluster_log,
                                              bool vjp) {
  Layout L;
  L.P = 3 * n + nba * nb;
  L.G = n + nb;
  L.nt = threads_for(n, log_c - cluster_log);
  L.nw = L.nt / 32;
  const size_t amps = (size_t)1 << (n + log_c - cluster_log);
  size_t o = amps * sizeof(cplx);                // A at offset 0
  L.off_M = o;        if (vjp) o += amps * sizeof(cplx);
  L.off_gates = o;    o += (size_t)L.G * 16 * sizeof(cplx);
  L.off_gbar = o;     if (vjp) o += (size_t)L.G * 32 * sizeof(real);
  L.off_red = o;      if (vjp) o += (size_t)2 * L.nw * 32 * sizeof(real);
  L.off_params = o;   o += (size_t)L.P * sizeof(real);
  L.off_grad = o;     if (vjp) o += (size_t)L.P * sizeof(real);
  L.off_cs = o;       o += (size_t)2 * L.P * sizeof(real);
  L.bytes = o;
  return L;
}

// log2 of the smallest split of a restart whose blocks' layout fits a
// block's shared memory (at most kMaxClusterLog): of the columns, never
// more than there are, or of one column by rows (log_c = 0), never to
// tiles of fewer than 4 rows; -1 if none fits.
inline int cluster_plan(int n, int nb, int nba, int log_c, bool vjp) {
  const int parts = log_c ? log_c : n - 2;  // log2 of the most tiles
  const int most = parts < kMaxClusterLog ? parts : kMaxClusterLog;
  for (int j = 0; j <= most; ++j)
    if (make_layout(n, nb, nba, log_c, j, vjp).bytes <= kSmemLimit) return j;
  return -1;
}

// The layout of the vjp on rows.cuh's warps (vjp_rows_kernel: one column
// split by rows over the cluster of 2^cluster_log blocks that cluster_plan
// picks; vjp_block_kernel: one column, or the whole unitary's 2^log_c
// columns, on one block): make_layout's, whose bytes decide the plan, with
// the threads and the ring of cotangent slots of rows.cuh's row_plan
// (which *plan receives) for the block's 2^(n + log_c - cluster_log)
// amplitudes in place of the cross-warp partials, in what the plan's
// layout leaves of a block's shared memory.
__host__ __device__ inline Layout row_layout(int n, int nb, int nba,
                                             int log_c, int cluster_log,
                                             RowPlan* plan) {
  Layout L = make_layout(n, nb, nba, log_c, cluster_log, true);
  const size_t red = (size_t)2 * L.nw * 32 * sizeof(real);
  *plan = row_plan(n + log_c - cluster_log, kSmemLimit - (L.bytes - red));
  L.nt = 32 * plan->warps;
  L.nw = plan->warps;
  size_t o = L.off_red + (size_t)32 * plan->warps * plan->ring * sizeof(real);
  L.off_params = o;   o += (size_t)L.P * sizeof(real);
  L.off_grad = o;     o += (size_t)L.P * sizeof(real);
  L.off_cs = o;       o += (size_t)2 * L.P * sizeof(real);
  L.bytes = o;
  return L;
}

// The layout of the forward pass on rows.cuh's warps
// (forward_rows_kernel: one column split by rows over the cluster that
// cluster_plan picks for the forward pass; forward_block_kernel: one
// column on one block, or the whole unitary's 2^log_c columns on the
// plan's 2^cluster_log independent blocks): make_layout's, whose bytes
// decide the plan, with the warps of rows.cuh's row_plan (which *plan
// receives) and no ring, for the chain sums no cotangent.
__host__ __device__ inline Layout forward_row_layout(int n, int nb, int nba,
                                                     int log_c,
                                                     int cluster_log,
                                                     RowPlan* plan) {
  Layout L = make_layout(n, nb, nba, log_c, cluster_log, false);
  *plan = row_plan(n + log_c - cluster_log, ~(size_t)0);
  plan->ring = 0;
  L.nt = 32 * plan->warps;
  L.nw = plan->warps;
  return L;
}

// The global row tiles (one column past what a cluster holds; rows.cuh's
// global row tiles): the widest column they take, by build (a column of
// 2^24 complex64 or 2^23 complex128 amplitudes is 128 MiB, and the vjp
// holds four of them a restart, U, Ubar and its A and M: 512 MiB; it is
// the widest that chip_smoke.py holds against the plain version on the
// card), log2 of the fewest rows of a tile (a pass's window of gates then
// holds at least 8 bits beside the sector bits), and the shared memory a
// block may use where two blocks of a pass share an SM (half the SM's
// 233,472 bytes, less the 1,024 the runtime keeps for each block).
#ifdef CPFLOW_DOUBLE
constexpr int kGlobalMaxQubits = 23;
#else
constexpr int kGlobalMaxQubits = 24;
#endif
constexpr int kGlobalRowsMin = 10;
constexpr size_t kGlobalSmemTwo = 115712;

__host__ __device__ inline size_t global_limit(int per_sm) {
  return per_sm == 2 ? kGlobalSmemTwo : kSmemLimit;
}

// A block of a pass of the global row tiles on 2^(n - j) rows with per_sm
// (1 or 2) blocks an SM: a warp for every 2^kRowSegmentMin rows, at most
// kRowThreads / per_sm threads; in shared memory A (and the vjp's M), the
// G gates (and the vjp's gbar), the pass's copy tables (kGlobalMapBytes),
// its mbarrier, and the vjp's ring of cotangent slots, as many gates of
// kRowRingMax, ... 1 as global_limit(per_sm) holds (the layout does not
// fit where one does not).
struct GlobalLayout {
  RowPlan plan;
  int log_rows, nt;
  size_t off_M, off_gates, off_gbar, off_maps, off_bar, off_ring, bytes;
};

__host__ __device__ inline GlobalLayout global_layout(int n, int nb, int j,
                                                      bool vjp, int per_sm) {
  GlobalLayout L;
  L.log_rows = n - j;
  const int cap = kRowThreads / per_sm;
  int lw = 0;
  while (lw < L.log_rows - kRowSegmentMin && (64 << lw) <= cap) ++lw;
  const size_t rows = (size_t)1 << L.log_rows, G = n + nb;
  size_t o = rows * sizeof(cplx);  // A at offset 0
  L.off_M = o;      if (vjp) o += rows * sizeof(cplx);
  L.off_gates = o;  o += G * 16 * sizeof(cplx);
  L.off_gbar = o;   if (vjp) o += G * 32 * sizeof(real);
  L.off_maps = o;   o += kGlobalMapBytes;
  L.off_bar = o;    o += 16;
  L.off_ring = o;
  int ring = 0;
  if (vjp) {
    ring = kRowRingMax;
    while (ring > 1 && o + ((size_t)(32 * ring) << lw) * sizeof(real) >
                           global_limit(per_sm))
      ring >>= 1;
    o += ((size_t)(32 * ring) << lw) * sizeof(real);
  }
  L.plan = RowPlan{1 << lw, L.log_rows - lw, ring};
  L.nt = 32 << lw;
  L.bytes = o;
  return L;
}

// The most qubits of one column that a cluster of the row tiles holds with
// no blocks (17 in float, 16 in double).
inline int row_tiles_max() {
  int n = 2;
  while (cluster_plan(n + 1, 0, 0, 0, true) >= 0) ++n;
  return n;
}

// log2 of the tiles a restart of one column takes on the global row tiles
// with per_sm blocks an SM: past the row tiles' widest column, up to
// kGlobalMaxQubits, where no cluster holds the pass, the fewest whose
// global_layout fits, tiles of at least 2^kGlobalRowsMin rows; -1
// elsewhere.
inline int global_log(int n, int nb, int nba, int log_c, bool vjp,
                      int per_sm = 1) {
  if (log_c || (per_sm != 1 && per_sm != 2) || n <= row_tiles_max() ||
      n > kGlobalMaxQubits || cluster_plan(n, nb, nba, 0, vjp) >= 0)
    return -1;
  for (int j = 1; n - j >= kGlobalRowsMin; ++j)
    if (global_layout(n, nb, j, vjp, per_sm).bytes <= global_limit(per_sm))
      return j;
  return -1;
}

// The layout of the kernels on tiles.cuh's warps (the forward pass's
// column tiles, forward_tiles_kernel, and the vjp on a cluster,
// vjp_kernel): a block holds w = 2^log_w columns of the whole
// unitary, column-major with a column stride of S = d + 1 amplitudes, in
// tile_threads(n, log_w) threads: A (and the vjp's M), the gates (16
// complex each, 16-byte aligned), the vjp's gates' cotangents gbar (32
// reals each) and the ring of its warps' cotangent slots (nw warps x ring
// gates x 32 reals), the cos and sin of the angles, and P reals that hold
// the angles and then the vjp's gradient.
struct WarpLayout {
  int d, w, S, nt, nw, G, P, ring;
  size_t off_M, off_gates, off_gbar, off_ring, off_cs, off_pg, bytes;
};

__host__ __device__ inline WarpLayout warp_layout(int n, int nb, int nba,
                                                  int log_w, bool vjp,
                                                  int ring) {
  WarpLayout L;
  L.d = 1 << n;
  L.w = 1 << log_w;
  L.S = L.d + 1;
  L.nt = tile_threads(n, log_w);
  L.nw = L.nt / 32;
  L.G = n + nb;
  L.P = 3 * n + nba * nb;
  L.ring = vjp ? ring : 0;
  size_t o = (size_t)L.w * L.S * sizeof(cplx);  // A at offset 0
  L.off_M = o;      if (vjp) o += (size_t)L.w * L.S * sizeof(cplx);
  o = (o + 15) & ~(size_t)15;
  L.off_gates = o;  o += (size_t)L.G * 16 * sizeof(cplx);
  L.off_gbar = o;   if (vjp) o += (size_t)L.G * 32 * sizeof(real);
  L.off_ring = o;   o += (size_t)L.nw * L.ring * 32 * sizeof(real);
  L.off_cs = o;     o += (size_t)2 * L.P * sizeof(real);
  L.off_pg = o;     o += (size_t)L.P * sizeof(real);
  L.bytes = o;
  return L;
}

// The ring of the vjp on a cluster of blocks of 2^log_w columns: the most
// gates of kTileRing, 8, 4, 2, 1 whose warp_layout fits a block; 0 if none
// does (never where cluster_plan takes the shape: kernels/tiles.py).
__host__ __device__ inline int cluster_ring(int n, int nb, int nba,
                                            int log_w) {
  for (int r = kTileRing; r >= 1; r >>= 1)
    if (warp_layout(n, nb, nba, log_w, true, r).bytes <= kSmemLimit) return r;
  return 0;
}

// log2 of the forward pass's column tiles of the whole unitary (log_c = n):
// the fewest tiles whose warp_layout fits a block; -1 for one column.
inline int forward_tile_log(int n, int nb, int nba, int log_c) {
  if (!log_c) return -1;
  for (int j = 0; j <= log_c; ++j)
    if (warp_layout(n, nb, nba, n - j, false, 0).bytes <= kSmemLimit)
      return j;
  return -1;
}

// log2 of the forward pass's tiles that store together (a cluster of
// them): 0 where a tile's run of w amplitudes of a row fills a 32-byte
// sector, else as many as fill one.
__host__ __device__ inline int store_pairs_log(int w) {
  int lp = 0;
  while (((size_t)w << lp) * sizeof(cplx) < 32) ++lp;
  return lp;
}

// Whether the forward pass runs on the column tiles: the whole unitary
// from 7 qubits, and below where no split of the row-split design holds
// it (past the column design's depths).
inline bool forward_on_tiles(int n, int nb, int nba, int log_c) {
  return log_c &&
         (n >= 7 || cluster_plan(n, nb, nba, log_c, false) < 0) &&
         forward_tile_log(n, nb, nba, log_c) >= 0;
}

// The restart's angles into shared memory, their cos and sin (without local
// memory, rows.cuh), the gates. Ends with a barrier.
__device__ __forceinline__ void load_gates(const Args& a, const Layout& L,
                                           int b, real* params, real* cs,
                                           cplx* gates) {
  for (int i = threadIdx.x; i < L.P; i += blockDim.x)
    params[i] = a.angles[(size_t)i * a.B + b];
  __syncthreads();
  row_angle_trig(a.tpl, a.n, L.P, params, cs);
  __syncthreads();
  build_gates(a.tpl, a.n, L.G, cs, gates);
  __syncthreads();
}

// The block's rank in its cluster; 0 without kCluster.
template <bool kCluster>
__device__ __forceinline__ int rank_of() {
  if constexpr (kCluster)
    return (int)cooperative_groups::this_cluster().block_rank();
  return 0;
}

// The columns [c0, c0 + w) of the identity after the surface round, on
// the block's tile (column-major, entry (c - c0) 2^n + r, no pad): entry r
// of column C is the product over the qubits of G_q[r's bit, C's bit] on
// row bit n - 1 - q (from e_C each gate's other amplitude is 0). Only for
// a table with no swap (a segment that holds every row bit: the whole
// unitary's, or one column owned by one warp), which starts on the
// identity. Each warp fills its own segment.
__device__ __forceinline__ void unitary_product(cplx* A, const cplx* gates,
                                                int n, const RowPlan& p,
                                                int c0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int e = lane; e < 1 << p.seg; e += 32) {
    const int at = (warp << p.seg) | e;
    const int r = at & ((1 << n) - 1), C = c0 + (at >> n);
    cplx v = mkc(RL(1.), RL(0.));
    for (int s = 0; s < n; ++s)
      v = cmul(v, gates[16 * (n - 1 - s) + 2 * ((r >> s) & 1) +
                        ((C >> s) & 1)]);
    A[at] = v;
  }
}

// The vjp on rows.cuh's warps: one column split by rows over a cluster
// (kCluster, vjp_rows_kernel: the block of rank rho holds rows [rho
// 2^log_rows, (rho + 1) 2^log_rows)), or on one block with no cluster code
// (vjp_block_kernel) one column (log_c = 0) or the whole unitary (log_c =
// n: its columns column-major, 2^n rows each, so that a warp's segment
// holds whole columns and the table no swap), A = U and M = conj(Ubar) / 2
// copied while the gates are built. The walk (row_walk) runs the wrapper's
// table backward, its gates in each lane's order on one block (rows.cuh's
// row_gate), and with kCluster the blocks' gbar are summed in rank order
// (cluster_sum) before the angle gradients.
template <bool kCluster>
__device__ __forceinline__ void vjp_rows_body(const RowArgs& ra) {
  const Args& a = ra;
  extern __shared__ __align__(16) unsigned char smem[];
  RowPlan plan;
  const Layout L = row_layout(a.n, a.nb, a.tpl.nba, kCluster ? 0 : a.log_c,
                              a.cluster_log, &plan);
  cplx* A = reinterpret_cast<cplx*>(smem);
  cplx* M = reinterpret_cast<cplx*>(smem + L.off_M);
  cplx* gates = reinterpret_cast<cplx*>(smem + L.off_gates);
  real* gbar = reinterpret_cast<real*>(smem + L.off_gbar);
  real* ring = reinterpret_cast<real*>(smem + L.off_red);
  real* params = reinterpret_cast<real*>(smem + L.off_params);
  real* grad = reinterpret_cast<real*>(smem + L.off_grad);
  real* cs = reinterpret_cast<real*>(smem + L.off_cs);
  const int lc = kCluster ? 0 : a.log_c, n = a.n;
  const int log_rows = n + lc - a.cluster_log, amps = 1 << log_rows;
  const int b = blockIdx.x >> a.cluster_log, rank = rank_of<kCluster>();

  const cplx* u = a.U + ((size_t)b << (n + lc));
  const cplx* g = a.Ubar + ((size_t)b << (n + lc));
  if constexpr (kCluster) {
    for (int e = threadIdx.x; e < amps; e += blockDim.x) {
      const int at = (rank << log_rows) + e;
      A[e] = u[at];
      const cplx t = g[at];
      M[e] = mkc(RL(0.5) * t.x, RL(-0.5) * t.y);  // M = conj(g) / 2
    }
    load_gates(a, L, b, params, cs, gates);
  } else {
    if (!lc) {  // the column, 16 bytes a copy
      for (int e = kPer16 * threadIdx.x; e < amps; e += kPer16 * blockDim.x) {
        __pipeline_memcpy_async(A + e, u + e, 16);
        __pipeline_memcpy_async(M + e, g + e, 16);
      }
    } else {  // U's rows into the tile's columns, an entry a copy
      for (int e = threadIdx.x; e < amps; e += blockDim.x) {
        const int at = ((e & ((1 << n) - 1)) << n) | (e >> n);
        __pipeline_memcpy_async(A + e, u + at, sizeof(cplx));
        __pipeline_memcpy_async(M + e, g + at, sizeof(cplx));
      }
    }
    __pipeline_commit();
    load_gates(a, L, b, params, cs, gates);
    __pipeline_wait_prior(0);
    __syncthreads();  // every thread's copies landed
    for (int e = threadIdx.x; e < amps; e += blockDim.x) {
      const cplx t = M[e];  // M = conj(g) / 2, in place
      M[e] = mkc(RL(0.5) * t.x, RL(-0.5) * t.y);
    }
    __syncthreads();
  }
  row_walk<!kCluster>(A, M, gates, ra.ops, ra.nops, ring, gbar, n, L.G,
                      ra.plan, log_rows, rank);
  if constexpr (kCluster) cluster_sum(gbar, 32 * L.G);
  angle_grads(a.tpl, n, L.G, cs, gates, gbar, grad);
  __syncthreads();
  if (rank != 0) return;
  for (int i = threadIdx.x; i < L.P; i += blockDim.x)
    a.grad[(size_t)i * a.B + b] = grad[i];
}

// Gate j's matrix from the cos and sin of the angles (build_gates' body).
__device__ __forceinline__ void build_gate(const Template& t, int n, int j,
                                           const real* cs, cplx* gates) {
  if (j < n) surface_gate(cs + 6 * j, gates + 16 * j);
  else block_gate(t, cs + 2 * (3 * n + t.nba * (j - n)), gates + 16 * j);
}

// The vjp of the whole unitary on a cluster of c = 2^cluster_log blocks
// (7 and 8 qubits; below, templates past the column design's depths): the
// block of rank rho holds columns [rho w, (rho + 1) w), w = d / c, on
// tiles.cuh's warps (warp_layout), each warp owning cw = w / nw columns (or
// a column its gw warps). The tile's A = U and M = conj(Ubar) / 2 are read
// row by row in runs of w. The gates are built once a cluster: rank rho
// builds gates j = rho mod c, and after a cluster barrier each block
// copies the others' over distributed shared memory. The walk (warp_walk)
// has no block barrier or cross-warp sum between two gates: each warp sums
// a gate's cotangent over its columns in registers and its lanes by
// shuffles into its ring slot, and every `ring` gates the block sums the
// slots in warp order into its own gbar; cluster_sum then adds the
// blocks' gbar in rank order, and rank rho forms the angle gradients of
// its gates. Every sum runs in a fixed order, so that two launches on the
// same inputs give the same bits.
__device__ __forceinline__ void vjp_cluster_body(const Args& a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, lw = n - a.cluster_log, c = 1 << a.cluster_log;
  const WarpLayout L = warp_layout(n, a.nb, a.tpl.nba, lw, true,
                                   cluster_ring(n, a.nb, a.tpl.nba, lw));
  cplx* A = reinterpret_cast<cplx*>(smem);
  cplx* M = reinterpret_cast<cplx*>(smem + L.off_M);
  cplx* gates = reinterpret_cast<cplx*>(smem + L.off_gates);
  real* gbar = reinterpret_cast<real*>(smem + L.off_gbar);
  real* ring = reinterpret_cast<real*>(smem + L.off_ring);
  real* cs = reinterpret_cast<real*>(smem + L.off_cs);
  real* pg = reinterpret_cast<real*>(smem + L.off_pg);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rank = (int)cluster.block_rank(), b = blockIdx.x >> a.cluster_log;
  const int d = L.d, w = L.w, S = L.S, G = L.G;

  // the tile's U and Ubar, row by row in runs of w, copied asynchronously
  // while the angles' cos and sin and the gates are formed
  const cplx* u = a.U + ((size_t)b << (2 * n)) + (rank << lw);
  const cplx* g = a.Ubar + ((size_t)b << (2 * n)) + (rank << lw);
  for (int e = tid; e < w * d; e += nt) {
    const int r = e >> lw, col = e & (w - 1);
    const size_t at = ((size_t)r << n) + col;
    __pipeline_memcpy_async(A + col * S + r, u + at, sizeof(cplx));
    __pipeline_memcpy_async(M + col * S + r, g + at, sizeof(cplx));
  }
  __pipeline_commit();
  for (int i = tid; i < L.P; i += nt) pg[i] = a.angles[(size_t)i * a.B + b];
  __syncthreads();
  row_angle_trig(a.tpl, n, L.P, pg, cs);
  __syncthreads();
  for (int j = rank + c * tid; j < G; j += c * nt)
    build_gate(a.tpl, n, j, cs, gates);
  cluster.sync();
  for (int i = tid; i < 16 * G; i += nt) {  // the others' gates
    const int owner = (i >> 4) & (c - 1);
    if (owner != rank) gates[i] = *cluster.map_shared_rank(gates + i, owner);
  }
  __pipeline_wait_prior(0);
  for (int e = tid; e < w * d; e += nt) {  // M = conj(Ubar) / 2, in place
    const int r = e >> lw, col = e & (w - 1);
    const cplx x = M[col * S + r];
    M[col * S + r] = mkc(RL(0.5) * x.x, RL(-0.5) * x.y);
  }
  __syncthreads();

  const WarpColumns wc = warp_columns(w, L.nw);
  warp_walk(A + wc.c0 * S, M + wc.c0 * S, S, gates, a.placements, ring,
            L.ring, gbar, n, G, L.nw, wc);
  cluster_sum(gbar, 32 * G);
  // the angle gradients of this rank's gates, each written by its thread
  for (int j = rank + c * tid; j < G; j += c * nt) {
    const cplx* gbj = reinterpret_cast<const cplx*>(gbar + 32 * j);
    const int off = j < n ? 3 * j : 3 * n + a.tpl.nba * (j - n);
    const int count = j < n ? 3 : a.tpl.nba;
    if (j < n) surface_grads(cs + 6 * j, gates + 16 * j, gbj, pg + off);
    else block_grads(a.tpl, cs + 2 * off, gbj, pg + off);
    for (int i = 0; i < count; ++i)
      a.grad[(size_t)(off + i) * a.B + b] = pg[off + i];
  }
}

// The restart's columns split over the blocks of a cluster
// (vjp_cluster_body, 512 threads in float at most 128 registers, 256 in
// double); one block a restart is vjp_block_kernel.
__global__ void __launch_bounds__(kTileThreads) vjp_kernel(Args a) {
  vjp_cluster_body(a);
}

// The forward pass on rows.cuh's warps: one column split by rows over a
// cluster (kCluster, forward_rows_kernel), or with no cluster code
// (forward_block_kernel) one column on one block, or the whole unitary's
// columns on the plan's 2^cluster_log independent blocks, block t of a
// restart holding columns [t w, (t + 1) w), column-major. The chain runs on
// the wrapper's table (its forward form: n start ops, then the blocks')
// from the surface round's product state, on e_0 in the table's first
// permutation (row_product) or on the identity's columns
// (unitary_product), its gates in each lane's order without kCluster
// (rows.cuh's row_gate), to U's column in natural order (the table ends on
// the identity), stored 16 bytes a copy, or to the tile's columns, stored
// into U's rows in runs of w.
template <bool kCluster>
__device__ __forceinline__ void forward_rows_body(const RowArgs& ra) {
  const Args& a = ra;
  extern __shared__ __align__(16) unsigned char smem[];
  RowPlan plan;
  const int lc = kCluster ? 0 : a.log_c, n = a.n;
  const Layout L =
      forward_row_layout(n, a.nb, a.tpl.nba, lc, a.cluster_log, &plan);
  cplx* A = reinterpret_cast<cplx*>(smem);
  cplx* gates = reinterpret_cast<cplx*>(smem + L.off_gates);
  real* params = reinterpret_cast<real*>(smem + L.off_params);
  real* cs = reinterpret_cast<real*>(smem + L.off_cs);
  const int log_rows = n + lc - a.cluster_log;
  const int b = blockIdx.x >> a.cluster_log;
  const int rank = kCluster ? rank_of<kCluster>()
                            : blockIdx.x & ((1 << a.cluster_log) - 1);
  load_gates(a, L, b, params, cs, gates);
  if (kCluster || ra.plan.seg < n)  // in the table's start permutation
    row_product(A, gates, ra.ops, n, ra.plan, log_rows, rank);
  else  // whole columns a warp (one column: one warp): no swap
    unitary_product(A, gates, n, ra.plan, rank << (log_rows - n));
  __syncwarp();
  row_chain<!kCluster>(A, gates, ra.ops + n, ra.nops - n, n, ra.plan,
                       log_rows, rank);
  if (kCluster || !lc) {
    const Vec16* from = reinterpret_cast<const Vec16*>(A);
    Vec16* to = reinterpret_cast<Vec16*>(a.U + ((size_t)b << (n + lc)) +
                                         ((size_t)rank << log_rows));
    for (int e = threadIdx.x; e < (1 << log_rows) / kPer16; e += blockDim.x)
      to[e] = from[e];
    return;
  }
  const int lw = log_rows - n;  // the tile's 2^lw columns into U's rows
  cplx* out = a.U + ((size_t)b << (2 * n)) + (rank << lw);
  for (int e = threadIdx.x; e < 1 << log_rows; e += blockDim.x) {
    const int r = e >> lw, c = e & ((1 << lw) - 1);
    out[((size_t)r << n) + c] = A[(c << n) + r];
  }
}

// The row tiles' kernels: one column split by rows over a cluster, each
// block's rows owned by its warps (rows.cuh).
__global__ void __launch_bounds__(kRowThreads, 1)
forward_rows_kernel(RowArgs ra) {
  forward_rows_body<true>(ra);
}

__global__ void __launch_bounds__(kRowThreads, 1)
vjp_rows_kernel(RowArgs ra) {
  vjp_rows_body<true>(ra);
}

// One block a restart in the row-split design's plan, with no cluster (and
// the forward pass of the whole unitary on that plan's independent
// blocks): rows.cuh's warps on one column or on whole columns.
__global__ void __launch_bounds__(kRowThreads, 1)
forward_block_kernel(RowArgs ra) {
  forward_rows_body<false>(ra);
}

__global__ void __launch_bounds__(kRowThreads, 1)
vjp_block_kernel(RowArgs ra) {
  vjp_rows_body<false>(ra);
}

// ------------------------------------------------------ the column design
// Block blockIdx.x holds restarts [R blockIdx.x, R blockIdx.x + R), each on
// column_lanes(N) threads; in the walk lane c < C of a restart owns its
// column c, in the forward pass lane l works on column l mod C.
template <int N>
__global__ void __launch_bounds__(kColumnThreads)
column_forward(Args a) {
  constexpr int C = 1 << N, lanes = column_lanes(N);
  extern __shared__ __align__(16) unsigned char smem[];
  const ColumnLayout L = column_layout(N, a.nb, a.tpl.nba, a.restarts, false);
  cplx* gates = reinterpret_cast<cplx*>(smem + L.off_gates);
  real* params = reinterpret_cast<real*>(smem + L.off_params);
  real* cs = reinterpret_cast<real*>(smem + L.off_cs);
  int* codes = reinterpret_cast<int*>(smem + L.off_codes);
  const int r = threadIdx.x / lanes, q = threadIdx.x % lanes;
  const int b0 = blockIdx.x * L.R, b = b0 + r;
  cplx* A = reinterpret_cast<cplx*>(smem) + ((size_t)r << (2 * N));
  column_fetch_angles(a.angles, a.B, b0, L, params);
  for (int e = q; e < C * C; e += lanes)  // the identity
    A[e] = mkc((e >> N) == (e & (C - 1)) ? RL(1.) : RL(0.), RL(0.));
  column_gates<0>(a.tpl, N, a.placements, L, params, codes, cs, gates);
  if (q < C * column_ways(N)) {  // every lane up to 4 qubits
    Column<N> x{A, nullptr, q & (C - 1)};
    column_chain(x, gates + r * L.G * 16, codes, L.G, q >> N);
  }
  __syncthreads();
  if (b < a.B) {  // the restart's d x C matrix, 16 bytes a lane
    const Vec16* from = reinterpret_cast<const Vec16*>(A);
    Vec16* to = reinterpret_cast<Vec16*>(a.U + ((size_t)b << (2 * N)));
    for (int e = q; e < C * C / kPer16; e += lanes) to[e] = from[e];
  }
}

template <int N>
__global__ void __launch_bounds__(kColumnThreads)
column_vjp(Args a) {
  constexpr int C = 1 << N, lanes = column_lanes(N), LC = N < 5 ? N : 5;
  constexpr unsigned mask = C >= 32 ? kFull : (1u << C) - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const ColumnLayout L = column_layout(N, a.nb, a.tpl.nba, a.restarts, true);
  cplx* gates = reinterpret_cast<cplx*>(smem + L.off_gates);
  real* gbar = reinterpret_cast<real*>(smem + L.off_gbar);
  real* params = reinterpret_cast<real*>(smem + L.off_params);
  real* cs = reinterpret_cast<real*>(smem + L.off_cs);
  real* grad = reinterpret_cast<real*>(smem + L.off_grad);
  int* codes = reinterpret_cast<int*>(smem + L.off_codes);
  const int r = threadIdx.x / lanes, q = threadIdx.x % lanes;
  const int b0 = blockIdx.x * L.R, b = b0 + r;
  cplx* A = reinterpret_cast<cplx*>(smem) + ((size_t)r << (2 * N));
  cplx* M = reinterpret_cast<cplx*>(smem + L.off_M) + ((size_t)r << (2 * N));
  column_fetch_angles(a.angles, a.B, b0, L, params);
  // U and its cotangent copied while the gates are built
  const size_t at = (size_t)min(b, a.B - 1) << (2 * N);
  fetch_slab(A, a.U + at, C * C, q, lanes);
  fetch_slab(M, a.Ubar + at, C * C, q, lanes);
  __pipeline_commit();
  column_gates<1>(a.tpl, N, a.placements, L, params, codes, cs, gates);
  if (q < C) {
    for (int row = 0; row < C; ++row) {  // M = conj(g) / 2
      const cplx t = M[row * C + q];
      M[row * C + q] = mkc(RL(0.5) * t.x, RL(-0.5) * t.y);
    }
    Column<N> x{A, M, q};
    real* gb = gbar + (size_t)(r * L.slots + q / 32) * L.G * 32;
    column_walk<LC>(x, gates + r * L.G * 16, codes, gb, N, L.G, mask);
  }
  __syncthreads();
  if (L.slots > 1) {  // the warps of a restart: their partials into slot 0
    for (int i = threadIdx.x; i < L.R * L.G * 32; i += blockDim.x) {
      const int rr = i / (L.G * 32), e = i - rr * L.G * 32;
      real* x = gbar + (size_t)rr * L.slots * L.G * 32 + e;
      for (int s = 1; s < L.slots; ++s) x[0] += x[s * L.G * 32];
    }
    __syncthreads();
  }
  // every angle's gradient, one gate per thread, as gates.cuh's angle_grads
  for (int i = threadIdx.x; i < L.R * L.G; i += blockDim.x) {
    const int rr = i % L.R, j = i / L.R;
    const real* c = cs + rr * 2 * L.P;
    const cplx* gbj = reinterpret_cast<const cplx*>(
        gbar + ((size_t)rr * L.slots * L.G + j) * 32);
    real* gr = grad + rr * L.P;
    if (j < N) {
      surface_grads(c + 6 * j, gates + (rr * L.G + j) * 16, gbj, gr + 3 * j);
    } else {
      const int off = 3 * N + a.tpl.nba * (j - N);
      block_grads(a.tpl, c + 2 * off, gbj, gr + off);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L.R * L.P; i += blockDim.x) {
    const int rr = i % L.R, p = i / L.R;
    if (b0 + rr < a.B) a.grad[(size_t)p * a.B + b0 + rr] = grad[rr * L.P + p];
  }
}

// ------------------------------------------------------ the column tiles
// The whole unitary past what a cluster of 16 blocks holds (9 qubits and
// up; at 8 qubits in double past k = 125): a restart's columns split into
// 2^j tiles of d x 2^(n - j), the fewest whose layout fits a block
// (tile_log), each on a block of its own with no cluster. The forward pass
// needs nothing more: its tiles never meet (forward_tiles_kernel, from 7
// qubits, on its own tiles: forward_tile_log). The vjp's tiles meet only
// in the sum of each gate's cotangent, and run the design of tiles.cuh, as
// sweep.cu's column tiles do; a call enqueues three kernels:
//   vjp_tile_gates_kernel, a block a restart: the cos and sin of its angles
//     and its gate matrices into the workspace, and its segments' counts
//     set to 0;
//   vjp_tiles_kernel, a block a (restart, tile): the gates by one bulk copy,
//     the tile's A = U and M = conj(Ubar) / 2 column-major, the walk on each
//     column by its own warps with no block barrier or cross-warp sum
//     between gates, each gate's cotangent share summed by shuffles into the
//     ring and every kTileRing gates the tile's shares into the workspace;
//     past kTileSegment tiles the last tile of each segment to finish (an
//     atomic count) adds the segment's shares in tile order;
//   vjp_tile_sum_kernel, a block a restart: the tiles' shares (or the
//     segments' sums) added in a fixed order, an entry a thread, and the
//     angle gradients from the gates and the cos and sin the prologue left.
// Every sum runs in a fixed order, so that no bit depends on the order the
// blocks ran in.

struct TileArgs {
  Args a;      // cluster_log: log2 of the tiles a restart
  real* work;  // the vjp's workspace (vjp_work), B restarts' of it
};

// The vjp's workspace of a restart on 2^tile_log tiles, offsets in reals
// from the restart's start, restart b's at b * per: its gate matrices (32 G
// reals, first, so that they are 16-byte aligned for the bulk copy), the
// cos and sin of its angles (2 P), each tile's shares of the gates'
// cotangents (E = 32 G reals), each segment's sums (S segments; none at
// kTileSegment tiles or fewer, where the sum kernel adds the tiles'
// shares itself) and one count (an unsigned int) a segment; per rounded up
// to 16 bytes.
struct VjpWork {
  int G, P, E, Q, S;
  size_t cs, parts, segs, counts, per;
};

__host__ __device__ inline VjpWork vjp_work(int n, int nb, int nba,
                                            int tile_log) {
  VjpWork W;
  W.G = n + nb;
  W.P = 3 * n + nba * nb;
  W.E = 32 * W.G;
  W.Q = 1 << tile_log;
  W.S = W.Q > kTileSegment ? W.Q / kTileSegment : 0;
  W.cs = (size_t)32 * W.G;
  W.parts = W.cs + (size_t)2 * W.P;
  W.segs = W.parts + (size_t)W.Q * W.E;
  W.counts = W.segs + (size_t)W.S * W.E;
  const size_t end = W.counts + ((size_t)W.S * sizeof(unsigned) +
                                 sizeof(real) - 1) / sizeof(real);
  constexpr size_t r16 = 16 / sizeof(real);
  W.per = (end + r16 - 1) / r16 * r16;
  return W;
}

// Shared memory of the prologue and the sum kernel: the gates (at offset
// 0), their cotangents, the gradient, the angles and their cos and sin.
struct SumLayout {
  size_t off_gbar, off_grad, off_params, off_cs, bytes;
};

__host__ __device__ inline SumLayout sum_layout(int G, int P) {
  SumLayout L;
  size_t o = (size_t)G * 16 * sizeof(cplx);
  L.off_gbar = o;    o += (size_t)G * 32 * sizeof(real);
  L.off_grad = o;    o += (size_t)P * sizeof(real);
  L.off_params = o;  o += (size_t)P * sizeof(real);
  L.off_cs = o;      o += (size_t)2 * P * sizeof(real);
  L.bytes = o;
  return L;
}

// log2 of the fewest tiles of the whole unitary's columns (log_c = n) whose
// make_layout of the vjp fits a block (the rule of the first tile kernels)
// and whose tile kernel's own layout (tiles.cuh) fits with a warp for
// every column; -1 for one column or if none fits.
inline int tile_log(int n, int nb, int nba, int log_c) {
  if (!log_c) return -1;
  for (int j = 0; j <= log_c; ++j)
    if (make_layout(n, nb, nba, log_c, j, true).bytes <= kSmemLimit &&
        (32 << (n - j)) <= kTileThreads &&
        tile_layout(n, nb, n - j).bytes <= kSmemLimit)
      return j;
  return -1;
}

// The forward pass on the column tiles: block blockIdx.x holds tile t =
// blockIdx.x mod 2^j of restart blockIdx.x / 2^j, columns [t w, (t + 1) w)
// on tiles.cuh's warps (warp_layout, no M): its own cos and sin (without
// local memory, rows.cuh) and gates, the surface round's product state on
// the identity's columns in one pass (warp_product), the blocks' chain on
// each warp's columns (a warp barrier a gate, none of the block's), and a
// store of the tile into U's rows in runs of w. Where a run is less than a
// 32-byte sector (2 columns in float at 13 qubits), a cluster of 2 or 4
// tiles stores together, each block a share of the rows of all their
// columns, so that no sector is written in parts (store_pairs_log): with
// runs of 16 bytes the store took about half of the 13-qubit forward
// pass.
__global__ void __launch_bounds__(kTileThreads, 1)
forward_tiles_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, tl = a.cluster_log, lw = n - tl;
  const WarpLayout L = warp_layout(n, a.nb, a.tpl.nba, lw, false, 0);
  cplx* A = reinterpret_cast<cplx*>(smem);
  cplx* gates = reinterpret_cast<cplx*>(smem + L.off_gates);
  real* cs = reinterpret_cast<real*>(smem + L.off_cs);
  real* params = reinterpret_cast<real*>(smem + L.off_pg);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int b = blockIdx.x >> tl, t = blockIdx.x & ((1 << tl) - 1);
  const int d = L.d, w = L.w, S = L.S;

  for (int i = tid; i < L.P; i += nt)
    params[i] = a.angles[(size_t)i * a.B + b];
  __syncthreads();
  row_angle_trig(a.tpl, n, L.P, params, cs);
  __syncthreads();
  build_gates(a.tpl, n, L.G, cs, gates);
  __syncthreads();

  const WarpColumns wc = warp_columns(w, L.nw);
  cplx* X = A + wc.c0 * S;
  warp_product(X, S, gates, n, (t << lw) + wc.c0, wc);
  column_sync(wc.c0, wc.gw);
  warp_chain(X, S, gates, a.placements, n, n, L.G, wc);
  __syncthreads();
  const int lp = store_pairs_log(w);
  if (!lp) {  // runs of w of each row, whole sectors
    cplx* out = a.U + ((size_t)b << (2 * n)) + (t << lw);
    for (int e = tid; e < w * d; e += nt) {
      const int r = e >> lw, c = e & (w - 1);
      out[((size_t)r << n) + c] = A[c * S + r];
    }
    return;
  }
  // A tile's run of a row is less than a sector: the 2^lp tiles of a
  // cluster each store d / 2^lp rows of all their columns, the others' over
  // distributed shared memory, so that every sector is written whole.
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = t & ((1 << lp) - 1), lr = n - lp, ls = lw + lp;
  cplx* out = a.U + ((size_t)b << (2 * n)) + ((t - rank) << lw) +
              ((size_t)rank << (lr + n));
  for (int e = tid; e < (1 << (lr + ls)); e += nt) {
    const int r = e >> ls, cc = e & ((1 << ls) - 1);
    const cplx* from = cluster.map_shared_rank(A, cc >> lw);
    out[((size_t)r << n) + cc] = from[(cc & (w - 1)) * S + (rank << lr) + r];
  }
  cluster.sync();
}

// The vjp's prologue: restart blockIdx.x's cos and sin (without local
// memory, rows.cuh) and gate matrices into its workspace, its segments'
// counts set to 0.
__global__ void __launch_bounds__(kMaxThreads)
vjp_tile_gates_kernel(TileArgs ta) {
  const Args& a = ta.a;
  extern __shared__ __align__(16) unsigned char smem[];
  const VjpWork W = vjp_work(a.n, a.nb, a.tpl.nba, a.cluster_log);
  const SumLayout L = sum_layout(W.G, W.P);
  cplx* gates = reinterpret_cast<cplx*>(smem);
  real* params = reinterpret_cast<real*>(smem + L.off_params);
  real* cs = reinterpret_cast<real*>(smem + L.off_cs);
  const int b = blockIdx.x;
  real* work = ta.work + (size_t)b * W.per;
  for (int i = threadIdx.x; i < W.P; i += blockDim.x)
    params[i] = a.angles[(size_t)i * a.B + b];
  __syncthreads();
  row_angle_trig(a.tpl, a.n, W.P, params, cs);
  __syncthreads();
  build_gates(a.tpl, a.n, W.G, cs, gates);
  __syncthreads();
  const real* g = reinterpret_cast<const real*>(gates);
  for (int i = threadIdx.x; i < 32 * W.G; i += blockDim.x) work[i] = g[i];
  for (int i = threadIdx.x; i < 2 * W.P; i += blockDim.x)
    work[W.cs + i] = cs[i];
  unsigned* counts = reinterpret_cast<unsigned*>(work + W.counts);
  for (int i = threadIdx.x; i < W.S; i += blockDim.x) counts[i] = 0;
}

// Block blockIdx.x holds tile t = blockIdx.x mod 2^j of restart
// blockIdx.x / 2^j: the walk on its columns, its shares into the workspace.
__global__ void __launch_bounds__(kTileThreads, 1)
vjp_tiles_kernel(TileArgs ta) {
  const Args& a = ta.a;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, tl = a.cluster_log, lw = n - tl;
  const TileLayout L = tile_layout(n, a.nb, lw);
  const VjpWork W = vjp_work(n, a.nb, a.tpl.nba, tl);
  cplx* A = reinterpret_cast<cplx*>(smem);
  cplx* M = reinterpret_cast<cplx*>(smem + L.off_M);
  cplx* gates = reinterpret_cast<cplx*>(smem + L.off_gates);
  real* ring = reinterpret_cast<real*>(smem + L.off_ring);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.off_bar);
  int* last = reinterpret_cast<int*>(smem + L.off_bar + 8);
  int2* bits = reinterpret_cast<int2*>(smem + L.off_bits);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x >> tl, t = blockIdx.x & (W.Q - 1);
  const int d = L.d, w = L.w, S = L.S, G = L.G;
  real* work = ta.work + (size_t)b * W.per;

  // the restart's gates, one bulk copy; meanwhile each gate's row bits and
  // the tile's A = U and M = conj(Ubar) / 2, read row by row in runs of w
  if (tid == 0) mbar_init(bar);
  __syncthreads();
  if (tid == 0)
    bulk_load(gates, work, (unsigned)(G * 16 * sizeof(cplx)), bar);
  for (int j = tid; j < G; j += nt)
    bits[j] = j < n ? make_int2(n - 1 - j, 0)
                    : make_int2(n - 1 - __ldg(&a.placements[2 * (j - n)]),
                                n - 1 - __ldg(&a.placements[2 * (j - n) + 1]));
  const cplx* u = a.U + ((size_t)b << (2 * n)) + (t << lw);
  const cplx* g = a.Ubar + ((size_t)b << (2 * n)) + (t << lw);
  for (int e = tid; e < w * d; e += nt) {
    const int r = e >> lw, c = e & (w - 1);
    const size_t at = ((size_t)r << n) + c;
    A[c * S + r] = __ldg(u + at);
    const cplx x = __ldg(g + at);
    M[c * S + r] = mkc(RL(0.5) * x.x, RL(-0.5) * x.y);
  }
  mbar_wait(bar, 0);
  __syncthreads();

  // the walk, last gate first, each column by its warps: every warp's sum
  // of each gate's cotangent share into its ring slot, and every kTileRing
  // gates the slots summed into the tile's shares
  const int gw = L.gw, col = warp / gw;
  const int gl = (warp % gw) * 32 + lane, gL = 32 * gw;
  cplx* X = A + col * S;
  cplx* Y = M + col * S;
  real* out = work + W.parts + (size_t)t * W.E;
  tile_walk(X, Y, gates, bits, ring, out, n, G, col, gw, gl, gL, L.nw);
  if (W.S == 0) return;
  const int seg = t / kTileSegment;
  tile_segment_sum(work + W.parts + (size_t)seg * kTileSegment * W.E,
                   work + W.segs + (size_t)seg * W.E,
                   reinterpret_cast<unsigned*>(work + W.counts) + seg, last,
                   W.E);
}

// sum_fixed for 4 values or more; 1 or 2 in order (the same sum), with no
// dynamic index into sum_fixed's running sums, which the double build
// kept in local memory.
__device__ __forceinline__ real sum_tiles(const real* p, int count,
                                          size_t stride) {
  if (count >= 4) return sum_fixed(p, count, stride);
  real s = __ldcg(p);
  for (int q = 1; q < count; ++q) s += __ldcg(p + (size_t)q * stride);
  return s;
}

// Restart blockIdx.x's angle gradients: its tiles' shares (or its segments'
// sums, in segment order) added in a fixed order, an entry a thread, then
// angle_grads on the gates and the cos and sin of its workspace.
__global__ void __launch_bounds__(kMaxThreads)
vjp_tile_sum_kernel(TileArgs ta) {
  const Args& a = ta.a;
  extern __shared__ __align__(16) unsigned char smem[];
  const VjpWork W = vjp_work(a.n, a.nb, a.tpl.nba, a.cluster_log);
  const SumLayout L = sum_layout(W.G, W.P);
  cplx* gates = reinterpret_cast<cplx*>(smem);
  real* gbar = reinterpret_cast<real*>(smem + L.off_gbar);
  real* grad = reinterpret_cast<real*>(smem + L.off_grad);
  real* cs = reinterpret_cast<real*>(smem + L.off_cs);
  const int b = blockIdx.x;
  const real* work = ta.work + (size_t)b * W.per;
  real* g = reinterpret_cast<real*>(gates);
  for (int i = threadIdx.x; i < 32 * W.G; i += blockDim.x) g[i] = work[i];
  for (int i = threadIdx.x; i < 2 * W.P; i += blockDim.x)
    cs[i] = work[W.cs + i];
  const int count = W.S ? W.S : W.Q;
  const real* part = work + (W.S ? W.segs : W.parts);
  for (int i = threadIdx.x; i < W.E; i += blockDim.x)
    gbar[i] = sum_tiles(part + i, count, W.E);
  __syncthreads();
  angle_grads(a.tpl, a.n, W.G, cs, gates, gbar, grad);
  __syncthreads();
  for (int i = threadIdx.x; i < W.P; i += blockDim.x)
    a.grad[(size_t)i * a.B + b] = grad[i];
}

// ------------------------------------------------- the global row tiles
// One column past what a cluster of 16 blocks holds (from 18 qubits in
// float, 17 in double, to kGlobalMaxQubits): the column stays in device
// memory, in natural order, and each restart's 2^j tiles of 2^(n - j) rows
// run on blocks of their own, a launch a pass of the schedule
// (kernels/rows.py:global_schedule, rows.cuh's global row tiles): a pass
// loads its tile under its start permutation, runs its gates and swaps on
// rows.cuh's warps as one block does (row_chain, row_walk with c = 1), and
// stores the tile under the permutation its swaps leave. A gate whose bits
// are not all in the tile ends a pass, and the next pass's load brings
// them in: no launch of its own swaps bits through device memory. Both
// schedules hold the blocks alone: the surface round from e_0 leaves a
// product state, which the forward pass writes in its first pass and
// against which the vjp's last launch contracts M (surface_contract), so
// the surface gates, which touch every bit, cut no pass. A call enqueues
//   global_gates_kernel, a block a restart: the cos and sin of its angles
//     and its gates, once, into the call's workspace;
//   the forward pass: forward_global_kernel once a pass, the first writing
//     the surface round's product state in its start permutation
//     (row_product), in place on U (each block reads and writes the same
//     addresses);
//   the vjp: vjp_global_kernel once a pass, last pass first, A = U and
//     M = conj(Ubar) / 2 loaded by the first launch and kept in the
//     workspace for the next, each block's shares of its pass's gates'
//     cotangents into the workspace, the last launch's the surface
//     round's too; then vjp_global_sum_kernel, a block a (restart, gate),
//     which adds the tiles' shares in a fixed order and forms that gate's
//     angle gradients.
// Each block of a pass brings in its pass's gates (and the surface
// round's where it uses them) and its copy tables by bulk copies on one
// mbarrier; the copies of its tile are 16 bytes a thread, by the tables.
// No TPU kernel stands behind them: they replace the XLA builder's column-0
// path (cpflow_tpu/sim/batched.py:255-362 with columns=[0]). What bounds
// them on this card: bytes. The forward pass must write U once and the vjp
// read U and Ubar once; each pass past one reads and writes the column (A
// and M in the vjp) again, 8 or 16 bytes an amplitude in float, unless it
// stays in the 50 MB L2, so the schedule makes the fewest passes (the
// longest runs of gates whose bits fit a tile) and puts the swaps that
// cross tiles into the passes' loads. A block walks its tile between its
// load and its store; the wrapper puts two blocks on an SM (tiles half as
// large, per_sm = 2), so that one's copies run under the other's walk,
// where that costs the template no pass (kernels/unitary.py:
// global_per_sm). Every sum runs in a fixed order, so that two launches
// give the same bits.

// The reals of a call's workspace a restart on 2^j tiles (per), and where
// its parts start: in the vjp A and M (2^n complex each) at 0, then the
// tiles' shares (G x 2^j x 32 reals, `parts`); then the gates (32 reals
// each, `gates`) and the cos and sin of the angles (`cs`), from the
// prologue; per a multiple of 4 reals.
struct GlobalWork {
  size_t per, parts, gates, cs;
};

__host__ __device__ inline GlobalWork global_work(int n, int G, int P, int j,
                                                  bool vjp) {
  GlobalWork W;
  W.parts = (size_t)4 << n;
  W.gates = vjp ? W.parts + ((size_t)G << j) * 32 : 0;
  W.cs = W.gates + (size_t)32 * G;
  W.per = (W.cs + 2 * (size_t)P + 3) & ~(size_t)3;
  return W;
}

struct GlobalArgs {
  RowArgs ra;    // cluster_log: log2 of the tiles a restart; ops, nops: the
                 // pass's table, its n header rows first; plan: the pass's
                 // warps
  real* work;    // the call's workspace, W.per reals a restart
  GlobalWork W;
  const int* maps;  // the pass's copy tables (kGlobalMapInts ints)
  int per_sm;    // blocks of a pass an SM
  int first;     // the forward pass's first pass; the vjp's first launch
  int last;      // the vjp's last launch (its first pass)
  int jlo, jhi;  // the pass's gates
};

// The prologue: restart blockIdx.x's cos and sin (without local memory,
// rows.cuh) and gate matrices into its workspace.
__global__ void __launch_bounds__(kMaxThreads)
global_gates_kernel(GlobalArgs ga) {
  const Args& a = ga.ra;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, G = n + a.nb, P = 3 * n + a.tpl.nba * a.nb;
  const SumLayout L = sum_layout(G, P);
  cplx* gates = reinterpret_cast<cplx*>(smem);
  real* params = reinterpret_cast<real*>(smem + L.off_params);
  real* cs = reinterpret_cast<real*>(smem + L.off_cs);
  const int b = blockIdx.x;
  real* work = ga.work + (size_t)b * ga.W.per;
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    params[i] = a.angles[(size_t)i * a.B + b];
  __syncthreads();
  row_angle_trig(a.tpl, n, P, params, cs);
  __syncthreads();
  build_gates(a.tpl, n, G, cs, gates);
  __syncthreads();
  const real* g = reinterpret_cast<const real*>(gates);
  for (int i = threadIdx.x; i < 32 * G; i += blockDim.x)
    work[ga.W.gates + i] = g[i];
  for (int i = threadIdx.x; i < 2 * P; i += blockDim.x)
    work[ga.W.cs + i] = cs[i];
}

// Thread 0: the mbarrier, then the bulk copies of gates g0 ... jhi of
// restart `work` into their places and of the pass's tables; every thread
// waits for them.
__device__ __forceinline__ void global_bring(const GlobalArgs& ga,
                                             const real* work, int g0,
                                             cplx* gates, int* maps,
                                             uint64_t* bar) {
  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned bytes = (unsigned)((ga.jhi + 1 - g0) * 16 * sizeof(cplx));
    mbar_expect(bar, bytes + kGlobalMapBytes);
    bulk_copy(gates + 16 * g0, work + ga.W.gates + 32 * g0, bytes, bar);
    bulk_copy(maps, ga.maps, kGlobalMapBytes, bar);
  }
  mbar_wait(bar, 0);
}

__global__ void __launch_bounds__(kRowThreads, 1)
forward_global_kernel(GlobalArgs ga) {
  const RowArgs& ra = ga.ra;
  const Args& a = ra;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, j = a.cluster_log;
  const GlobalLayout L = global_layout(n, a.nb, j, false, ga.per_sm);
  const int log_rows = L.log_rows;
  cplx* A = reinterpret_cast<cplx*>(smem);
  cplx* gates = reinterpret_cast<cplx*>(smem + L.off_gates);
  int* maps = reinterpret_cast<int*>(smem + L.off_maps);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.off_bar);
  const int b = blockIdx.x >> j, t = blockIdx.x & ((1 << j) - 1);
  cplx* col = a.U + ((size_t)b << n);
  // the pass's gates, and the surface round's in the first pass
  global_bring(ga, ga.work + (size_t)b * ga.W.per, ga.first ? 0 : ga.jlo,
               gates, maps, bar);
  if (ga.first) {
    row_product(A, gates, ra.ops, n, ra.plan, log_rows, t);
    __syncwarp();
  } else {
    global_load<false>(A, nullptr, col, nullptr, maps,
                       global_base(ga.maps, 0, t), log_rows);
    __syncthreads();
  }
  row_chain<true>(A, gates, ra.ops + n, ra.nops - n, n, ra.plan, log_rows,
                  t);
  global_store<false>(A, nullptr, col, nullptr, maps + 512,
                      global_base(ga.maps, 1, t), log_rows);
}

__global__ void __launch_bounds__(kRowThreads, 1)
vjp_global_kernel(GlobalArgs ga) {
  const RowArgs& ra = ga.ra;
  const Args& a = ra;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = a.n, j = a.cluster_log, G = n + a.nb;
  const GlobalLayout L = global_layout(n, a.nb, j, true, ga.per_sm);
  const int log_rows = L.log_rows, tiles = 1 << j;
  cplx* A = reinterpret_cast<cplx*>(smem);
  cplx* M = reinterpret_cast<cplx*>(smem + L.off_M);
  cplx* gates = reinterpret_cast<cplx*>(smem + L.off_gates);
  real* gbar = reinterpret_cast<real*>(smem + L.off_gbar);
  int* maps = reinterpret_cast<int*>(smem + L.off_maps);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.off_bar);
  real* ring = reinterpret_cast<real*>(smem + L.off_ring);
  const int b = blockIdx.x >> j, t = blockIdx.x & ((1 << j) - 1);
  real* work = ga.work + (size_t)b * ga.W.per;
  cplx* Aw = reinterpret_cast<cplx*>(work);
  cplx* Mw = Aw + ((size_t)1 << n);
  real* parts = work + ga.W.parts;
  // the pass's gates, and the surface round's in the last launch
  global_bring(ga, work, ga.last ? 0 : ga.jlo, gates, maps, bar);
  // the walk starts where the chain ended: U, Ubar (M = conj(Ubar) / 2)
  const size_t end = global_base(ga.maps, 1, t);
  if (ga.first) {
    global_load<true>(A, M, a.U + ((size_t)b << n),
                      a.Ubar + ((size_t)b << n), maps + 512, end, log_rows);
    __syncthreads();
    for (int e = threadIdx.x; e < 1 << log_rows; e += blockDim.x) {
      const cplx v = M[e];
      M[e] = mkc(RL(0.5) * v.x, RL(-0.5) * v.y);
    }
  } else {
    global_load<true>(A, M, Aw, Mw, maps + 512, end, log_rows);
  }
  __syncthreads();
  const int ringm = ra.plan.ring - 1;
  row_walk<true>(A, M, gates, ra.ops + n, ra.nops - n, ring, gbar, n, G,
                 ra.plan, log_rows, t);
  // the ring's last gates, if the pass's first gate left them unsummed
  if (ga.jlo & ringm) row_flush(ring, gbar, ga.jlo & ~ringm, n, G, ra.plan);
  __syncthreads();
  if (ga.last)  // A is the product state: the surface round by contraction
    surface_contract(M, A, gates, ra.ops, n, log_rows, t, parts, tiles);
  else
    global_store<true>(A, M, Aw, Mw, maps, global_base(ga.maps, 0, t),
                       log_rows);
  for (int i = threadIdx.x; i < (ga.jhi - ga.jlo + 1) * 32; i += blockDim.x) {
    const int g = ga.jlo + (i >> 5);
    parts[((size_t)g * tiles + t) * 32 + (i & 31)] = gbar[32 * g + (i & 31)];
  }
}

// Block blockIdx.x holds gate g = blockIdx.x mod G of restart blockIdx.x /
// G: the tiles' shares of its cotangent (8 reals of a surface gate, 32 of a
// block) added in a fixed order (8 runs of tiles, each in tile order, then
// the runs in order; a thread an entry of a run), then its angles'
// gradients from its gate and the cos and sin of the prologue.
__global__ void __launch_bounds__(kMaxThreads)
vjp_global_sum_kernel(GlobalArgs ga) {
  const Args& a = ga.ra;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ real runs[kMaxThreads];
  const int n = a.n, G = n + a.nb, P = 3 * n + a.tpl.nba * a.nb;
  const SumLayout L = sum_layout(1, P);
  cplx* gate = reinterpret_cast<cplx*>(smem);
  real* gbar = reinterpret_cast<real*>(smem + L.off_gbar);
  real* grad = reinterpret_cast<real*>(smem + L.off_grad);
  real* cs = reinterpret_cast<real*>(smem + L.off_cs);
  const int b = blockIdx.x / G, g = blockIdx.x - b * G, tid = threadIdx.x;
  const int tiles = 1 << a.cluster_log;
  const int count = tiles < 8 ? tiles : 8, run = tiles / count;
  const int E = g < n ? 8 : 32;
  const real* work = ga.work + (size_t)b * ga.W.per;
  for (int i = tid; i < 2 * P; i += blockDim.x) cs[i] = work[ga.W.cs + i];
  for (int i = tid; i < 32; i += blockDim.x)
    reinterpret_cast<real*>(gate)[i] = work[ga.W.gates + 32 * g + i];
  const real* part = work + ga.W.parts + (size_t)g * tiles * 32;
  if (tid < 32 * count)
    runs[tid] = (tid & 31) < E
                    ? sum_tiles(part + (size_t)(tid >> 5) * run * 32 +
                                    (tid & 31),
                                run, 32)
                    : RL(0.);
  __syncthreads();
  if (tid < 32) {
    real s = runs[tid];
    for (int q = 1; q < count; ++q) s += runs[32 * q + tid];
    gbar[tid] = s;
  }
  __syncthreads();
  if (tid != 0) return;
  const cplx* gbj = reinterpret_cast<const cplx*>(gbar);
  if (g < n) {
    surface_grads(cs + 6 * g, gate, gbj, grad);
    for (int i = 0; i < 3; ++i)
      a.grad[(size_t)(3 * g + i) * a.B + b] = grad[i];
  } else {
    const int off = 3 * n + a.tpl.nba * (g - n);
    block_grads(a.tpl, cs + 2 * off, gbj, grad);
    for (int i = 0; i < a.tpl.nba; ++i)
      a.grad[(size_t)(off + i) * a.B + b] = grad[i];
  }
}

// 0 forward, 1 vjp on one block a restart (the row-split design's plan
// with no cluster: forward_block_kernel, vjp_block_kernel), 2 vjp on a
// cluster of tiles of columns (tiles.cuh's warps); 3 + n - 2 the column
// forward pass at n qubits, 8 + n - 2 the column vjp; 13 the forward pass,
// 14 the vjp's walk and 15 its sum on the column tiles; 16 forward and 17
// vjp of one column split by rows over a cluster (the row-split design's
// row tiles); 18 the column tiles' vjp prologue; 19 forward and 20 vjp of
// the global row tiles, 21 the vjp's sum there, 22 their prologue.
constexpr int kKernels = 13 + 2 * (kColumnQubitsMax - kColumnQubitsMin + 1);
constexpr int kForwardBlock = 0, kVjpBlock = 1;
constexpr int kForwardTiles = 13, kVjpTiles = 14, kVjpTileSum = 15;
constexpr int kForwardRows = 16, kVjpRows = 17, kVjpTileGates = 18;
constexpr int kForwardGlobal = 19, kVjpGlobal = 20, kVjpGlobalSum = 21;
constexpr int kGlobalGates = 22;
const void* kernel_of(int which) {
  const void* kernels[kKernels] = {
      (const void*)forward_block_kernel, (const void*)vjp_block_kernel,
      (const void*)vjp_kernel,     (const void*)column_forward<2>,
      (const void*)column_forward<3>,    (const void*)column_forward<4>,
      (const void*)column_forward<5>,    (const void*)column_forward<6>,
      (const void*)column_vjp<2>,        (const void*)column_vjp<3>,
      (const void*)column_vjp<4>,        (const void*)column_vjp<5>,
      (const void*)column_vjp<6>,        (const void*)forward_tiles_kernel,
      (const void*)vjp_tiles_kernel,     (const void*)vjp_tile_sum_kernel,
      (const void*)forward_rows_kernel,  (const void*)vjp_rows_kernel,
      (const void*)vjp_tile_gates_kernel, (const void*)forward_global_kernel,
      (const void*)vjp_global_kernel,    (const void*)vjp_global_sum_kernel,
      (const void*)global_gates_kernel};
  return kernels[which];
}

enum { DESIGN_ROWS = 0, DESIGN_COLUMNS = 1, DESIGN_TILES = 2,
       DESIGN_GLOBAL = 3 };

// Dynamic shared memory granted to each kernel on each device so far,
// whether each cluster kernel may take a cluster of 16 (non-portable)
// blocks on each device, and the last (threads, bytes) at which each device
// placed such a cluster of each kernel: each attribute is set, and the
// placement asked, once per kernel and device (and size), not before every
// launch.
constexpr int kMaxDevices = 64;
constexpr int kClusterKernel = 2;  // vjp_kernel
constexpr unsigned kMaxPortableCluster = 8;
size_t g_granted[kMaxDevices][kKernels];
bool g_non_portable[kMaxDevices][kKernels];
struct Placed {
  int threads;
  size_t bytes;
};
Placed g_placed[kMaxDevices][kKernels];

// The kernels launched as clusters.
inline bool is_cluster_kernel(int which) {
  return which == kClusterKernel || which == kForwardRows ||
         which == kVjpRows;
}

cudaError_t grant_smem(int which, size_t bytes) {
  // the default allows it, and only the cluster kernels take one more
  const bool cluster = is_cluster_kernel(which);
  if (bytes <= 48 * 1024 && !cluster) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (cluster && !(dev < kMaxDevices && g_non_portable[dev][which])) {
    err = cudaFuncSetAttribute(kernel_of(which),
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) g_non_portable[dev][which] = true;
  }
  if (bytes <= 48 * 1024) return cudaSuccess;
  size_t* granted = dev < kMaxDevices ? &g_granted[dev][which] : nullptr;
  if (granted && *granted >= bytes) return cudaSuccess;
  if (which == kForwardGlobal || which == kVjpGlobal) {
    // two blocks of a pass an SM need the SM's whole shared memory
    err = cudaFuncSetAttribute(kernel_of(which),
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  err = cudaFuncSetAttribute(kernel_of(which),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && granted) *granted = bytes;
  return err;
}

// The launch of one design: kernel, grid, threads and bytes a block, and
// the cluster; false if the design does not take the shape.
struct Launch {
  int which, threads;
  unsigned grid, cluster;
  size_t bytes;
};

bool plan_launch(RowArgs& a, int vjp, int design, Launch& out) {
  const int n = a.n, nb = a.nb, nba = a.tpl.nba;
  if (design == DESIGN_COLUMNS) {
    a.cluster_log = 0;
    a.restarts = column_restarts(n, nb, nba, a.log_c, vjp != 0);
    if (!a.restarts) return false;
    out.which = (vjp ? 8 : 3) + n - kColumnQubitsMin;
    out.threads = a.restarts * column_lanes(n);
    out.grid = (unsigned)((a.B + a.restarts - 1) / a.restarts);
    out.cluster = 1;
    out.bytes = column_layout(n, nb, nba, a.restarts, vjp != 0).bytes;
    return true;
  }
  if (design != DESIGN_ROWS) return false;
  // the forward pass of the whole unitary from 7 qubits runs on the column
  // tiles alone (cpflow_unitary_tiles_launch)
  if (!vjp && forward_on_tiles(n, nb, nba, a.log_c)) return false;
  a.restarts = 1;
  a.cluster_log = cluster_plan(n, nb, nba, a.log_c, vjp != 0);
  if (a.cluster_log < 0) return false;
  const int cl = a.cluster_log;
  out.grid = (unsigned)a.B << cl;
  if (a.log_c && vjp && cl) {  // the whole unitary's vjp on a cluster
    const int lw = n - cl;
    const WarpLayout W = warp_layout(n, nb, nba, lw, true,
                                     cluster_ring(n, nb, nba, lw));
    if (!W.ring || W.bytes > kSmemLimit) return false;
    out.which = kClusterKernel;
    out.threads = W.nt;
    out.bytes = W.bytes;
    out.cluster = 1u << cl;
    return true;
  }
  // rows.cuh's warps: one column on one block or split by rows over a
  // cluster (the row tiles), the whole unitary's vjp on one block and its
  // forward pass on the plan's independent blocks
  const Layout L = vjp ? row_layout(n, nb, nba, a.log_c, cl, &a.plan)
                       : forward_row_layout(n, nb, nba, a.log_c, cl, &a.plan);
  const bool tiles = !a.log_c && cl;  // of rows
  out.which = tiles ? (vjp ? kVjpRows : kForwardRows)
                    : (vjp ? kVjpBlock : kForwardBlock);
  out.cluster = tiles ? 1u << cl : 1u;
  out.threads = L.nt;
  out.bytes = L.bytes;
  return true;
}

// cudaErrorLaunchOutOfResources where the card places no cluster of the
// launch l (configured as cfg), so that it never starts. Asked of the
// runtime only for a non-portable cluster, above 8 blocks (a portable one
// always fits), and then once per device and shape.
cudaError_t check_placement(const Launch& l, const cudaLaunchConfig_t& cfg) {
  if (l.cluster <= kMaxPortableCluster) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Placed* placed = dev < kMaxDevices ? &g_placed[dev][l.which] : nullptr;
  if (placed && placed->threads == l.threads && placed->bytes == l.bytes)
    return cudaSuccess;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(kernel_of(l.which)), &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  if (placed) *placed = {l.threads, l.bytes};
  return cudaSuccess;
}

// The arguments of a call of the global row tiles; false where they do not
// take the shape.
bool global_args(GlobalArgs& ga, const void* angles, void* U,
                 const void* Ubar, void* grad, void* work,
                 const void* placements, const void* letters, int n,
                 int num_blocks, int num_letters, int ent, int nba, int B,
                 int vjp, int per_sm) {
  RowArgs& a = ga.ra;
  a.angles = static_cast<const real*>(angles);
  a.U = static_cast<cplx*>(U);
  a.Ubar = static_cast<const cplx*>(Ubar);
  a.grad = static_cast<real*>(grad);
  a.placements = static_cast<const int*>(placements);
  a.tpl.letters = static_cast<const int*>(letters);
  a.tpl.m = num_letters;
  a.tpl.ent = ent;
  a.tpl.nba = nba;
  a.n = n;
  a.nb = num_blocks;
  a.log_c = 0;
  a.B = B;
  a.restarts = 1;
  a.cluster_log = global_log(n, num_blocks, nba, 0, vjp != 0, per_sm);
  if (a.cluster_log < 0 || !work) return false;
  const GlobalLayout L =
      global_layout(n, num_blocks, a.cluster_log, vjp != 0, per_sm);
  a.plan = L.plan;
  a.ops = nullptr;
  a.nops = 0;
  ga.work = static_cast<real*>(work);
  ga.W = global_work(n, n + num_blocks, 3 * n + nba * num_blocks,
                     a.cluster_log, vjp != 0);
  ga.maps = nullptr;
  ga.per_sm = per_sm;
  ga.first = ga.last = 0;
  ga.jlo = ga.jhi = 0;
  return true;
}

// The prologue's launch (global_gates_kernel) of the call ga.
cudaError_t global_gates_launch(const GlobalArgs& ga, cudaStream_t s) {
  const Args& a = ga.ra;
  const size_t bytes =
      sum_layout(a.n + a.nb, 3 * a.n + a.tpl.nba * a.nb).bytes;
  cudaError_t err = grant_smem(kGlobalGates, bytes);
  if (err != cudaSuccess) return err;
  global_gates_kernel<<<a.B, kMaxThreads, bytes, s>>>(ga);
  return cudaGetLastError();
}


}  // namespace

extern "C" {

// Dynamic shared memory of each of the `cluster` blocks (1, 2, 4, 8 or 16)
// that hold a restart's columns in the row-split design (vjp: 0 forward,
// 1 vjp).
long long cpflow_unitary_smem_bytes(int n, int num_blocks, int nba, int log_c,
                                    int vjp, int cluster) {
  int log = 0;
  while ((1 << log) < cluster) ++log;
  return (long long)make_layout(n, num_blocks, nba, log_c, log, vjp != 0)
      .bytes;
}

// The blocks a restart's columns are split over in the row-split design
// (cluster_plan), 0 if no split fits or the forward pass runs on the column
// tiles.
int cpflow_unitary_cluster(int n, int num_blocks, int nba, int log_c,
                           int vjp) {
  if (!vjp && forward_on_tiles(n, num_blocks, nba, log_c)) return 0;
  const int log = cluster_plan(n, num_blocks, nba, log_c, vjp != 0);
  return log < 0 ? 0 : 1 << log;
}

// Restarts a block of the column design (column_restarts), 0 where that
// design does not take the shape.
int cpflow_unitary_column_restarts(int n, int num_blocks, int nba, int log_c,
                                   int vjp) {
  return column_restarts(n, num_blocks, nba, log_c, vjp != 0);
}

// Dynamic shared memory of a block of the column design holding `restarts`
// restarts.
long long cpflow_unitary_column_smem_bytes(int n, int num_blocks, int nba,
                                           int vjp, int restarts) {
  return (long long)column_layout(n, num_blocks, nba, restarts, vjp != 0)
      .bytes;
}

// The plan's design for a shape: 1 the column design (the whole unitary at
// 2 to 6 qubits, where its layout fits), else for the forward pass 2 the
// column tiles for the whole unitary from 7 qubits (forward_on_tiles),
// else 0 the row-split design where one block or a cluster holds it, else
// 2 the column tiles where they hold it, else 3 the global row tiles where
// they hold one column (global_log), else 0.
int cpflow_unitary_design(int n, int num_blocks, int nba, int log_c,
                          int vjp) {
  if (column_restarts(n, num_blocks, nba, log_c, vjp != 0) > 0)
    return DESIGN_COLUMNS;
  if (!vjp && forward_on_tiles(n, num_blocks, nba, log_c))
    return DESIGN_TILES;
  if (vjp && cluster_plan(n, num_blocks, nba, log_c, true) < 0 &&
      tile_log(n, num_blocks, nba, log_c) >= 0)
    return DESIGN_TILES;
  if (global_log(n, num_blocks, nba, log_c, vjp != 0) >= 0)
    return DESIGN_GLOBAL;
  return DESIGN_ROWS;
}

// The tiles a restart's columns are split into on the column tiles (the
// vjp's tile_log, the forward pass's forward_tile_log: the fewest whose
// layout fits a block), 0 for one column or where none fits.
int cpflow_unitary_tiles(int n, int num_blocks, int nba, int log_c,
                         int vjp) {
  const int log = vjp ? tile_log(n, num_blocks, nba, log_c)
                      : forward_tile_log(n, num_blocks, nba, log_c);
  return log < 0 ? 0 : 1 << log;
}

// The launch of a kernel on tiles.cuh's warps (warp_layout): the forward
// pass on the column tiles (vjp == 0, where forward_on_tiles) or the vjp
// of the whole unitary on a cluster (vjp == 1, where cluster_plan splits
// it): out[0] threads and out[1] dynamic shared memory bytes a block,
// out[2] blocks a restart, out[3] columns a warp, out[4] warps a column,
// out[5] gates in the ring (0 in the forward pass). Returns
// cudaErrorInvalidValue where neither takes the shape.
int cpflow_unitary_warp_layout(int n, int num_blocks, int nba, int log_c,
                               int vjp, int* out) {
  int log = -1, ring = 0;
  if (!vjp && forward_on_tiles(n, num_blocks, nba, log_c)) {
    log = forward_tile_log(n, num_blocks, nba, log_c);
  } else if (vjp && log_c) {
    log = cluster_plan(n, num_blocks, nba, log_c, true);
    if (log > 0) ring = cluster_ring(n, num_blocks, nba, n - log);
    if (!ring) return (int)cudaErrorInvalidValue;
  }
  if (log < 0) return (int)cudaErrorInvalidValue;
  const WarpLayout L = warp_layout(n, num_blocks, nba, n - log, vjp != 0,
                                   ring);
  out[0] = L.nt;
  out[1] = (int)L.bytes;
  out[2] = 1 << log;
  out[3] = tile_columns_a_warp(L.w, L.nw);
  out[4] = L.w < L.nw ? L.nw / L.w : 1;
  out[5] = ring;
  return 0;
}

// The reals of the workspace each restart of the vjp needs on the column
// tiles (vjp_work: its gates, the cos and sin of its angles, its tiles'
// shares, its segments' sums and counts); 0 where they do not take the
// shape.
long long cpflow_unitary_tile_partials(int n, int num_blocks, int nba,
                                       int log_c) {
  const int log = tile_log(n, num_blocks, nba, log_c);
  return log < 0 ? 0 : (long long)vjp_work(n, num_blocks, nba, log).per;
}

// The vjp's launches on the column tiles: out[0] threads and out[1] dynamic
// shared memory bytes a block of vjp_tiles_kernel (tile_layout), out[2]
// tiles a restart, out[3] dynamic shared memory bytes a block of the
// prologue and the sum kernel (sum_layout). Returns cudaErrorInvalidValue
// where the column tiles do not take the shape.
int cpflow_unitary_tile_layout(int n, int num_blocks, int nba, int log_c,
                               int* out) {
  const int log = tile_log(n, num_blocks, nba, log_c);
  if (log < 0) return (int)cudaErrorInvalidValue;
  const TileLayout T = tile_layout(n, num_blocks, n - log);
  const VjpWork W = vjp_work(n, num_blocks, nba, log);
  out[0] = T.nt;
  out[1] = (int)T.bytes;
  out[2] = 1 << log;
  out[3] = (int)sum_layout(W.G, W.P).bytes;
  return 0;
}

// cpflow_unitary_launch on the column tiles, with the same arguments and
// `work`, a device buffer of B x cpflow_unitary_tile_partials reals (the
// vjp only; null for the forward pass; its contents need no setting): the
// forward pass (forward_tiles_kernel), or the vjp's prologue
// (vjp_tile_gates_kernel), walk (vjp_tiles_kernel) and sum
// (vjp_tile_sum_kernel), on `stream`. Returns cudaErrorInvalidValue for a
// shape the tiles do not take, else the first CUDA error of the launches.
int cpflow_unitary_tiles_launch(const void* angles, void* U,
                                const void* Ubar, void* grad, void* work,
                                const void* placements, const void* letters,
                                int n, int num_blocks, int num_letters,
                                int ent, int nba, int log_c, int B, int vjp,
                                void* stream) {
  TileArgs ta;
  Args& a = ta.a;
  a.angles = static_cast<const real*>(angles);
  a.U = static_cast<cplx*>(U);
  a.Ubar = static_cast<const cplx*>(Ubar);
  a.grad = static_cast<real*>(grad);
  a.placements = static_cast<const int*>(placements);
  a.tpl.letters = static_cast<const int*>(letters);
  a.tpl.m = num_letters;
  a.tpl.ent = ent;
  a.tpl.nba = nba;
  a.n = n;
  a.nb = num_blocks;
  a.log_c = log_c;
  a.B = B;
  a.restarts = 1;
  a.cluster_log = vjp ? tile_log(n, num_blocks, nba, log_c)
                      : forward_tile_log(n, num_blocks, nba, log_c);
  ta.work = static_cast<real*>(work);
  if (a.cluster_log < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)B << a.cluster_log;
  cudaError_t err;
  if (!vjp) {
    const WarpLayout L = warp_layout(n, num_blocks, nba, n - a.cluster_log,
                                     false, 0);
    err = grant_smem(kForwardTiles, L.bytes);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(
        blocks, L.nt, L.bytes, 1u << store_pairs_log(L.w), s, &attr);
    err = cudaLaunchKernelEx(&cfg, forward_tiles_kernel, a);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
  }
  const TileLayout T = tile_layout(n, num_blocks, n - a.cluster_log);
  const VjpWork W = vjp_work(n, num_blocks, nba, a.cluster_log);
  const size_t sum_bytes = sum_layout(W.G, W.P).bytes;
  err = grant_smem(kVjpTileGates, sum_bytes);
  if (err == cudaSuccess) err = grant_smem(kVjpTiles, T.bytes);
  if (err == cudaSuccess) err = grant_smem(kVjpTileSum, sum_bytes);
  if (err != cudaSuccess) return (int)err;
  vjp_tile_gates_kernel<<<B, kMaxThreads, sum_bytes, s>>>(ta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vjp_tiles_kernel<<<blocks, T.nt, T.bytes, s>>>(ta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vjp_tile_sum_kernel<<<B, kMaxThreads, sum_bytes, s>>>(ta);
  return (int)cudaGetLastError();
}

// The plan on rows.cuh's warps of the forward pass (vjp == 0) or the vjp
// (vjp == 1) in the row-split design: one column (log_c = 0) on the one
// block or the cluster that cluster_plan gives it, the whole unitary
// (log_c = n) below 7 qubits, its vjp on one block and its forward pass on
// the plan's blocks (forward_row_layout, row_layout): out[0] threads and
// out[1] dynamic shared memory bytes a block, out[2] warps, out[3] log2 of
// a warp's amplitudes (the segment bits a row schedule runs its gates on;
// whole columns of the whole unitary), out[4] gates in the ring (0 in the
// forward pass), out[5] log2 of a block's amplitudes. Returns
// cudaErrorInvalidValue where the pass does not run on rows.cuh's warps.
int cpflow_unitary_row_plan(int n, int num_blocks, int nba, int log_c,
                            int vjp, int* out) {
  if (!vjp && forward_on_tiles(n, num_blocks, nba, log_c))
    return (int)cudaErrorInvalidValue;
  const int log = cluster_plan(n, num_blocks, nba, log_c, vjp != 0);
  if (log < 0 || (log_c && vjp && log)) return (int)cudaErrorInvalidValue;
  RowPlan plan;
  const Layout L =
      vjp ? row_layout(n, num_blocks, nba, log_c, log, &plan)
          : forward_row_layout(n, num_blocks, nba, log_c, log, &plan);
  out[0] = L.nt;
  out[1] = (int)L.bytes;
  out[2] = plan.warps;
  out[3] = plan.seg;
  out[4] = plan.ring;
  out[5] = n + log_c - log;
  return 0;
}

// Launches the forward pass (vjp == 0: writes U) or the vector-Jacobian
// product (vjp == 1: reads U and Ubar, writes grad) in the given design
// (0 row-split, 1 columns) on `stream`. Either pass of one column (on one
// block or split by rows) takes row_ops, the row schedule (rows.cuh) of
// row_nops int4 for the segment bits cpflow_unitary_row_plan gives that
// pass (the forward pass's in its forward form, kernels/rows.py:schedule).
// angles and grad: (P, B) of the build's real type (float, or double with
// -DCPFLOW_DOUBLE); U and Ubar: (B, d, C) complex64 (complex128) with C =
// 2^log_c, log_c = n or 0; letters: (num_letters,) rotation letters 0, 1,
// 2 for x, y, z; ent: 0 CP, 1 CZ, 2 CX; nba: angles per block. In the
// row-split design each restart runs on the blocks cluster_plan picks: one
// block with no cluster (forward_block_kernel, vjp_block_kernel), the
// vjp's tiles of columns as a cluster, one column's tiles of rows as a
// cluster in both passes, and the forward pass of the whole unitary below
// 7 qubits on the plan's tiles of columns as independent blocks
// (forward_block_kernel; from 7 qubits it runs on the column tiles:
// cpflow_unitary_tiles_launch). Every pass on rows.cuh's warps takes the
// row schedule (the whole unitary's for segment n: no swap).
// Returns cudaErrorInvalidValue if the design does not hold the shape,
// cudaErrorLaunchOutOfResources if the card cannot place a non-portable
// cluster, else cudaGetLastError() after the launch.
int cpflow_unitary_launch(const void* angles, void* U, const void* Ubar,
                          void* grad, const void* placements,
                          const void* letters, int n, int num_blocks,
                          int num_letters, int ent, int nba, int log_c, int B,
                          int vjp, int design, void* stream,
                          const void* row_ops, int row_nops) {
  RowArgs a;
  a.angles = static_cast<const real*>(angles);
  a.U = static_cast<cplx*>(U);
  a.Ubar = static_cast<const cplx*>(Ubar);
  a.grad = static_cast<real*>(grad);
  a.placements = static_cast<const int*>(placements);
  a.tpl.letters = static_cast<const int*>(letters);
  a.tpl.m = num_letters;
  a.tpl.ent = ent;
  a.tpl.nba = nba;
  a.n = n;
  a.nb = num_blocks;
  a.log_c = log_c;
  a.B = B;
  a.ops = static_cast<const int4*>(row_ops);
  a.nops = row_nops;
  a.plan = RowPlan{0, 0, 0};
  Launch l;
  if (!plan_launch(a, vjp, design, l)) return (int)cudaErrorInvalidValue;
  // the kernels on rows.cuh's warps: RowArgs, with the schedule
  const bool rows = l.which == kVjpRows || l.which == kForwardRows ||
                    l.which == kVjpBlock || l.which == kForwardBlock;
  if (rows && (!row_ops || row_nops < n + num_blocks))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = grant_smem(l.which, l.bytes);
  if (err != cudaSuccess) return (int)err;
  Args plain = a;  // the other kernels take Args
  void* args[] = {rows ? static_cast<void*>(&a) : static_cast<void*>(&plain)};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(l.grid, l.threads, l.bytes, l.cluster,
                    static_cast<cudaStream_t>(stream), &attr);
  err = check_placement(l, cfg);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(
                                      kernel_of(l.which)), args);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The plan of a pass of the global row tiles (one column past what a
// cluster holds, global_log) with per_sm (1 or 2) blocks an SM: out[0]
// threads and out[1] dynamic shared memory bytes a block (global_layout),
// out[2] warps, out[3] log2 of a warp's rows, out[4] gates in the ring (0
// in the forward pass), out[5] log2 of a tile's rows, out[6] tiles a
// restart, out[7] the sum kernel's and out[8] the prologue's dynamic
// shared memory bytes. Returns cudaErrorInvalidValue where they do not
// take the shape.
int cpflow_unitary_global_plan(int n, int num_blocks, int nba, int vjp,
                               int per_sm, int* out) {
  const int j = global_log(n, num_blocks, nba, 0, vjp != 0, per_sm);
  if (j < 0) return (int)cudaErrorInvalidValue;
  const GlobalLayout L = global_layout(n, num_blocks, j, vjp != 0, per_sm);
  const int P = 3 * n + nba * num_blocks;
  out[0] = L.nt;
  out[1] = (int)L.bytes;
  out[2] = L.plan.warps;
  out[3] = L.plan.seg;
  out[4] = L.plan.ring;
  out[5] = L.log_rows;
  out[6] = 1 << j;
  out[7] = (int)sum_layout(1, P).bytes;
  out[8] = (int)sum_layout(n + num_blocks, P).bytes;
  return 0;
}

// The reals of a call's workspace a restart on the global row tiles with
// per_sm blocks an SM (global_work: the vjp's A and M and its tiles'
// shares of the gates' cotangents, then the gates and the cos and sin of
// the angles); 0 where they do not take the shape.
long long cpflow_unitary_global_work(int n, int num_blocks, int nba,
                                     int vjp, int per_sm) {
  const int j = global_log(n, num_blocks, nba, 0, vjp != 0, per_sm);
  return j < 0 ? 0
               : (long long)global_work(n, n + num_blocks,
                                        3 * n + nba * num_blocks, j, vjp != 0)
                     .per;
}

// The prologue of the global row tiles alone (global_gates_kernel: each
// restart's gates and the cos and sin of its angles into `work`, B x
// cpflow_unitary_global_work reals, where a call of that pass and per_sm
// keeps them: the gates, 32 reals each, first in the forward pass's), with
// the arguments of cpflow_unitary_global_launch, on `stream`. Returns
// cudaErrorInvalidValue for a shape the global row tiles do not take, else
// the CUDA error of the launch.
int cpflow_unitary_global_gates(const void* angles, void* work,
                                const void* letters, int n, int num_blocks,
                                int num_letters, int ent, int nba, int B,
                                int vjp, int per_sm, void* stream) {
  GlobalArgs ga;
  if (!global_args(ga, angles, nullptr, nullptr, nullptr, work, nullptr,
                   letters, n, num_blocks, num_letters, ent, nba, B, vjp,
                   per_sm))
    return (int)cudaErrorInvalidValue;
  return (int)global_gates_launch(ga, static_cast<cudaStream_t>(stream));
}

// The forward pass (vjp == 0: writes U) or the vjp (vjp == 1: reads U and
// Ubar, writes grad) of one column on the global row tiles with per_sm (1
// or 2) blocks of a pass an SM, on `stream`, with the arguments of
// cpflow_unitary_launch (log_c 0), `work`, a device buffer of B x
// cpflow_unitary_global_work reals (whose contents need no setting), and
// the pass's schedule (kernels/rows.py:global_schedule and global_maps,
// the forward pass's or the vjp's for the segment and tile of
// cpflow_unitary_global_plan): `ops`, its table, and `maps`, its copy
// tables (kGlobalMapInts ints a pass), on the device; `offsets` (passes +
// 1 ints) and `ranges` (2 x passes ints, each pass's first and last gate,
// blocks only), on the host. Launches the prologue (global_gates_kernel),
// then the forward pass forward_global_kernel once a pass, in order, or
// the vjp vjp_global_kernel once a pass, last pass first, then
// vjp_global_sum_kernel. Returns cudaErrorInvalidValue for a shape or a
// schedule they do not take, else the first CUDA error of the launches.
int cpflow_unitary_global_launch(const void* angles, void* U,
                                 const void* Ubar, void* grad, void* work,
                                 const void* placements, const void* letters,
                                 int n, int num_blocks, int num_letters,
                                 int ent, int nba, int B, int vjp, int per_sm,
                                 void* stream, const void* ops,
                                 const void* maps, const int* offsets,
                                 const int* ranges, int passes) {
  GlobalArgs ga;
  const int G = n + num_blocks;
  if (!global_args(ga, angles, U, Ubar, grad, work, placements, letters, n,
                   num_blocks, num_letters, ent, nba, B, vjp, per_sm) ||
      !ops || !maps || passes < 1 || !offsets || !ranges)
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < passes; ++p)
    if (offsets[p + 1] - offsets[p] < n || ranges[2 * p] < n ||
        ranges[2 * p] > ranges[2 * p + 1] || ranges[2 * p + 1] >= G)
      return (int)cudaErrorInvalidValue;
  RowArgs& a = ga.ra;
  const GlobalLayout L =
      global_layout(n, num_blocks, a.cluster_log, vjp != 0, per_sm);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)B << a.cluster_log;
  const int4* table = static_cast<const int4*>(ops);
  const int* map = static_cast<const int*>(maps);
  cudaError_t err = grant_smem(vjp ? kVjpGlobal : kForwardGlobal, L.bytes);
  if (err != cudaSuccess) return (int)err;
  const size_t sum_bytes = sum_layout(1, 3 * n + nba * num_blocks).bytes;
  if (vjp) err = grant_smem(kVjpGlobalSum, sum_bytes);
  if (err == cudaSuccess) err = global_gates_launch(ga, s);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < passes; ++i) {
    const int p = vjp ? passes - 1 - i : i;  // the vjp: last pass first
    a.ops = table + offsets[p];
    a.nops = offsets[p + 1] - offsets[p];
    ga.maps = map + (size_t)p * kGlobalMapInts;
    ga.first = i == 0;
    ga.last = vjp && p == 0;
    ga.jlo = ranges[2 * p];
    ga.jhi = ranges[2 * p + 1];
    if (vjp)
      vjp_global_kernel<<<blocks, L.nt, L.bytes, s>>>(ga);
    else
      forward_global_kernel<<<blocks, L.nt, L.bytes, s>>>(ga);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!vjp) return 0;
  vjp_global_sum_kernel<<<(unsigned)B * G, kMaxThreads, sum_bytes, s>>>(ga);
  return (int)cudaGetLastError();
}

int cpflow_unitary_kernel_count() { return kKernels; }

// Registers per thread (out[0]) and local memory bytes per thread (out[1])
// of kernel `which` (kernel_of's numbering). Returns a CUDA error code, 0 on
// success.
int cpflow_unitary_attributes(int which, int* out) {
  if (which < 0 || which >= kKernels) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of(which));
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return 0;
}

// Resident blocks per SM of kernel `which` at `threads` threads and `bytes`
// of dynamic shared memory a block, from the CUDA runtime.
int cpflow_unitary_occupancy(int which, int threads, long long bytes,
                             int* blocks) {
  if (which < 0 || which >= kKernels) return (int)cudaErrorInvalidValue;
  cudaError_t err = grant_smem(which, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel_of(which), threads, (size_t)bytes);
  return (int)err;
}

// Clusters of `cluster` blocks (2 to 16) of the cluster kernel `which`
// (kernel_of's numbering: 2, 16 or 17), at `threads` threads and `bytes` of
// dynamic shared memory a block, that the card holds at once
// (cudaOccupancyMaxActiveClusters), in *clusters. Returns a CUDA error
// code.
int cpflow_unitary_clusters(int which, int threads, long long bytes,
                            int cluster, int* clusters) {
  if (cluster < 2 || cluster > (1 << kMaxClusterLog) || which < 0 ||
      which >= kKernels || !is_cluster_kernel(which))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = grant_smem(which, (size_t)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      (unsigned)cluster, threads, (size_t)bytes, (unsigned)cluster, nullptr,
      &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(kernel_of(which)), &cfg);
}

}  // extern "C"

// The two-qubit-block ansatz as a differentiable function of its angles:
// two kernels, the forward pass angles -> U and its vector-Jacobian product.
//
// No TPU kernel stands behind them. They replace
// cpflow_tpu/sim/batched.py:make_reversible_builder (its fwd and bwd), a
// jax.custom_vjp that XLA fused on the TPU and that nothing fuses on Hopper:
// without them a loss that the fused sweep (sweep.cu) does not know, a
// Python callable of U, would fall to one small library launch per gate and
// per restart batch. kernels/unitary.py wraps the pair as one
// torch.autograd.Function.
//
//   ansatz_forward: angles (P, B) float32 -> U (B, d, C) complex64, the
//     chain of sweep.cu's evaluation (cos and sin once per angle, the gates
//     in factored 2x2 form, the surface round and every block applied to a
//     state in shared memory) followed by a store of the state.
//   ansatz_vjp: angles (P, B), U (B, d, C) as the forward stored it, and the
//     cotangent g of U as PyTorch hands it to a backward (dL/dRe + i dL/dIm
//     of a real L, which is conj(2 M) for the holomorphic partial
//     M = dL/dU of gates.cuh) -> dL/dangles (P, B). It loads A = U and
//     M = conj(g) / 2 and runs sweep.cu's adjoint walk: it rewinds A by
//     unitarity (A_{j-1} = G_j^dag A_j), pulls M back (M_{j-1} = G_j^T M_j)
//     and sums every gate's cotangent, then each angle's gradient
//     2 Re sum Gbar * dG/dtheta. No intermediate state is stored or read.
//
// C = 2^n columns (the whole unitary) or C = 1 (the |0...0> column,
// n <= 12). One thread block per restart, as in sweep.cu, with the same
// threads per restart, where the block's layout fits its shared memory:
// the forward pass holds A, the vjp A and M (16 * 4^n bytes for the whole
// unitary). Above that a restart's columns are split over c = 2, 4 or 8
// blocks, each holding a d x (C / c) tile (gates.cuh), the smallest c that
// fits (cluster_plan; the whole unitary then reaches 8 qubits): the
// forward pass's blocks are independent, each storing its columns of U;
// the vjp's form a cluster, which sums the gates' cotangents over
// distributed shared memory in rank order before the angle gradients, and
// rank 0 writes them. What bounds them on this card: the forward pass
// writes, and the walk reads twice, 8 d C bytes per restart, against
// 30 d C float32 operations per two-qubit gate forwards and 92 in the walk:
// at n + k >= 10 gates both are bound by the float32 rate, not by device
// memory, and inside the block by the barrier after every gate and, in the
// walk, the block reduction of every gate's 32-float cotangent.

#include "gates.cuh"

namespace {

struct Args {
  const float* angles;    // (P, B)
  float2* U;              // (B, d, C): written by forward, read by vjp
  const float2* Ubar;     // (B, d, C): dL/dRe U + i dL/dIm U (vjp only)
  float* grad;            // (P, B): written by vjp
  const int* placements;  // (nb, 2)
  Template tpl;
  int n, nb, log_c, B, cluster_log;
};

struct Layout {
  int P, G, nt, nw, log_ct;  // log_ct: log2 of a block's columns
  size_t off_M, off_gates, off_gbar, off_red, off_params, off_grad, off_cs,
      bytes;
};

// Shared memory of one block of a restart split over 2^cluster_log blocks;
// the forward pass keeps no M, gbar, red and grad.
__host__ __device__ inline Layout make_layout(int n, int nb, int nba,
                                              int log_c, int cluster_log,
                                              bool vjp) {
  Layout L;
  L.P = 3 * n + nba * nb;
  L.G = n + nb;
  L.log_ct = log_c - cluster_log;
  L.nt = threads_for(n, L.log_ct);
  L.nw = L.nt / 32;
  const size_t amps = (size_t)1 << (n + L.log_ct);
  size_t o = amps * sizeof(float2);                // A at offset 0
  L.off_M = o;        if (vjp) o += amps * sizeof(float2);
  L.off_gates = o;    o += (size_t)L.G * 16 * sizeof(float2);
  L.off_gbar = o;     if (vjp) o += (size_t)L.G * 32 * sizeof(float);
  L.off_red = o;      if (vjp) o += (size_t)2 * L.nw * 32 * sizeof(float);
  L.off_params = o;   o += (size_t)L.P * sizeof(float);
  L.off_grad = o;     if (vjp) o += (size_t)L.P * sizeof(float);
  L.off_cs = o;       o += (size_t)2 * L.P * sizeof(float);
  L.bytes = o;
  return L;
}

// log2 of the smallest split of the columns whose blocks' layout fits a
// block's shared memory (at most kMaxClusterLog, never more than the
// columns); -1 if none fits.
inline int cluster_plan(int n, int nb, int nba, int log_c, bool vjp) {
  const int most = log_c < kMaxClusterLog ? log_c : kMaxClusterLog;
  for (int j = 0; j <= most; ++j)
    if (make_layout(n, nb, nba, log_c, j, vjp).bytes <= kSmemLimit) return j;
  return -1;
}

// The restart's angles into shared memory, their cos and sin, the gates.
// Ends with a barrier.
__device__ __forceinline__ void load_gates(const Args& a, const Layout& L,
                                           int b, float* params, float* cs,
                                           float2* gates) {
  for (int i = threadIdx.x; i < L.P; i += blockDim.x)
    params[i] = a.angles[(size_t)i * a.B + b];
  __syncthreads();
  angle_trig(a.tpl, a.n, L.P, params, cs);
  __syncthreads();
  build_gates(a.tpl, a.n, L.G, cs, gates);
  __syncthreads();
}

// Block blockIdx.x holds the tile of rank blockIdx.x mod c of restart
// blockIdx.x / c; the blocks of a restart need nothing of each other.
__global__ void __launch_bounds__(kMaxThreads)
forward_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(a.n, a.nb, a.tpl.nba, a.log_c, a.cluster_log,
                               false);
  float2* A = reinterpret_cast<float2*>(smem);
  float2* gates = reinterpret_cast<float2*>(smem + L.off_gates);
  float* params = reinterpret_cast<float*>(smem + L.off_params);
  float* cs = reinterpret_cast<float*>(smem + L.off_cs);
  const int lc = a.log_c, lt = L.log_ct, amps = 1 << (a.n + lt);
  const int b = blockIdx.x >> a.cluster_log;
  const int rank = blockIdx.x & ((1 << a.cluster_log) - 1);

  // the identity's first C columns, row-major d x C, the block's tile of
  // them
  for (int e = threadIdx.x; e < amps; e += blockDim.x) {
    const int g = tile_to_global(e, lc, lt, rank);
    A[e] = make_float2((g >> lc) == (g & ((1 << lc) - 1)) ? 1.f : 0.f, 0.f);
  }
  load_gates(a, L, b, params, cs, gates);
  forward_chain(A, gates, a.placements, a.n, a.nb, lt);
  float2* out = a.U + ((size_t)b << (a.n + lc));
  for (int e = threadIdx.x; e < amps; e += blockDim.x)
    out[tile_to_global(e, lc, lt, rank)] = A[e];
}

// kCluster: the restart's columns split over the blocks of a cluster.
template <bool kCluster>
__global__ void __launch_bounds__(kMaxThreads)
vjp_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(a.n, a.nb, a.tpl.nba, a.log_c,
                               kCluster ? a.cluster_log : 0, true);
  float2* A = reinterpret_cast<float2*>(smem);
  float2* M = reinterpret_cast<float2*>(smem + L.off_M);
  float2* gates = reinterpret_cast<float2*>(smem + L.off_gates);
  float* gbar = reinterpret_cast<float*>(smem + L.off_gbar);
  float* red = reinterpret_cast<float*>(smem + L.off_red);
  float* params = reinterpret_cast<float*>(smem + L.off_params);
  float* grad = reinterpret_cast<float*>(smem + L.off_grad);
  float* cs = reinterpret_cast<float*>(smem + L.off_cs);
  const int lc = a.log_c, lt = L.log_ct, amps = 1 << (a.n + lt);
  int b = blockIdx.x, rank = 0;
  if constexpr (kCluster) {
    b = blockIdx.x >> a.cluster_log;
    rank = (int)cooperative_groups::this_cluster().block_rank();
  }

  const float2* u = a.U + ((size_t)b << (a.n + lc));
  const float2* g = a.Ubar + ((size_t)b << (a.n + lc));
  for (int e = threadIdx.x; e < amps; e += blockDim.x) {
    const int at = kCluster ? tile_to_global(e, lc, lt, rank) : e;
    A[e] = u[at];
    const float2 t = g[at];
    M[e] = make_float2(0.5f * t.x, -0.5f * t.y);  // M = conj(g) / 2
  }
  load_gates(a, L, b, params, cs, gates);
  adjoint_walk(A, M, gates, a.placements, red, gbar, a.n, L.G, lt, L.nw);
  if constexpr (kCluster) cluster_sum(gbar, 32 * L.G);
  angle_grads(a.tpl, a.n, L.G, cs, gates, gbar, grad);
  __syncthreads();
  if (rank != 0) return;
  for (int i = threadIdx.x; i < L.P; i += blockDim.x)
    a.grad[(size_t)i * a.B + b] = grad[i];
}

using Kernel = void (*)(Args);

// 0 forward, 1 vjp on one block a restart, 2 vjp on a cluster
Kernel kernel_of(int which) {
  const Kernel kernels[3] = {forward_kernel, vjp_kernel<false>,
                             vjp_kernel<true>};
  return kernels[which];
}

}  // namespace

extern "C" {

// Dynamic shared memory of each of the `cluster` blocks (1, 2, 4 or 8) that
// hold a restart's columns (vjp: 0 forward, 1 vjp).
long long cpflow_unitary_smem_bytes(int n, int num_blocks, int nba, int log_c,
                                    int vjp, int cluster) {
  int log = 0;
  while ((1 << log) < cluster) ++log;
  return (long long)make_layout(n, num_blocks, nba, log_c, log, vjp != 0)
      .bytes;
}

// The blocks a restart's columns are split over (cluster_plan), 0 if no
// split fits.
int cpflow_unitary_cluster(int n, int num_blocks, int nba, int log_c,
                           int vjp) {
  const int log = cluster_plan(n, num_blocks, nba, log_c, vjp != 0);
  return log < 0 ? 0 : 1 << log;
}

// Launches the forward pass (vjp == 0: writes U) or the vector-Jacobian
// product (vjp == 1: reads U and Ubar, writes grad) on `stream`. angles and
// grad: (P, B) float32; U and Ubar: (B, d, C) complex64 with C = 2^log_c,
// log_c = n or 0; letters: (num_letters,) rotation letters 0, 1, 2 for x, y,
// z; ent: 0 CP, 1 CZ, 2 CX; nba: angles per block. Each restart runs on the
// blocks cluster_plan picks: the forward pass's as independent blocks, the
// vjp's as a cluster launched with cudaLaunchKernelEx. Returns
// cudaErrorInvalidValue if no split holds the shape, else
// cudaGetLastError() after the launch.
int cpflow_unitary_launch(const void* angles, void* U, const void* Ubar,
                          void* grad, const void* placements,
                          const void* letters, int n, int num_blocks,
                          int num_letters, int ent, int nba, int log_c, int B,
                          int vjp, void* stream) {
  Args a;
  a.angles = static_cast<const float*>(angles);
  a.U = static_cast<float2*>(U);
  a.Ubar = static_cast<const float2*>(Ubar);
  a.grad = static_cast<float*>(grad);
  a.placements = static_cast<const int*>(placements);
  a.tpl.letters = static_cast<const int*>(letters);
  a.tpl.m = num_letters;
  a.tpl.ent = ent;
  a.tpl.nba = nba;
  a.n = n;
  a.nb = num_blocks;
  a.log_c = log_c;
  a.B = B;
  a.cluster_log = cluster_plan(n, num_blocks, nba, log_c, vjp != 0);
  if (a.cluster_log < 0) return (int)cudaErrorInvalidValue;
  const Layout L = make_layout(n, num_blocks, nba, log_c, a.cluster_log,
                               vjp != 0);
  const bool cluster = vjp && a.cluster_log > 0;
  const Kernel kernel = kernel_of(vjp ? 1 + cluster : 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(
      (unsigned)B << a.cluster_log, L.nt, L.bytes,
      cluster ? 1u << a.cluster_log : 1u, static_cast<cudaStream_t>(stream),
      &attr);
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel),
                            args);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Registers per thread of the forward kernel (out[0]), the vjp kernel on
// one block a restart (out[1]) and on a cluster (out[2]). Returns a CUDA
// error code, 0 on success.
int cpflow_unitary_registers(int* out) {
  for (int i = 0; i < 3; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of(i));
    if (err != cudaSuccess) return (int)err;
    out[i] = attr.numRegs;
  }
  return 0;
}

}  // extern "C"

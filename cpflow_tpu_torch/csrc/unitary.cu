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
// C = 2^n columns (the whole unitary, n <= 6) or C = 1 (the |0...0> column,
// n <= 12). One thread block per restart, as in sweep.cu, with the same
// threads per restart. What bounds them on this card: the forward pass
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
  int n, nb, log_c, B;
};

struct Layout {
  int P, G, nt, nw;
  size_t off_M, off_gates, off_gbar, off_red, off_params, off_grad, off_cs,
      bytes;
};

// Shared memory of one restart's block; the forward pass keeps no M, gbar,
// red and grad.
__host__ __device__ inline Layout make_layout(int n, int nb, int nba,
                                              int log_c, bool vjp) {
  Layout L;
  L.P = 3 * n + nba * nb;
  L.G = n + nb;
  L.nt = threads_for(n, log_c);
  L.nw = L.nt / 32;
  const size_t amps = (size_t)1 << (n + log_c);
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

// The restart's angles into shared memory, their cos and sin, the gates.
// Ends with a barrier.
__device__ __forceinline__ void load_gates(const Args& a, const Layout& L,
                                           float* params, float* cs,
                                           float2* gates) {
  for (int i = threadIdx.x; i < L.P; i += blockDim.x)
    params[i] = a.angles[(size_t)i * a.B + blockIdx.x];
  __syncthreads();
  angle_trig(a.tpl, a.n, L.P, params, cs);
  __syncthreads();
  build_gates(a.tpl, a.n, L.G, cs, gates);
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
forward_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(a.n, a.nb, a.tpl.nba, a.log_c, false);
  float2* A = reinterpret_cast<float2*>(smem);
  float2* gates = reinterpret_cast<float2*>(smem + L.off_gates);
  float* params = reinterpret_cast<float*>(smem + L.off_params);
  float* cs = reinterpret_cast<float*>(smem + L.off_cs);
  const int lc = a.log_c, amps = 1 << (a.n + lc);

  // the identity's first C columns, row-major d x C
  for (int e = threadIdx.x; e < amps; e += blockDim.x)
    A[e] = make_float2((e >> lc) == (e & ((1 << lc) - 1)) ? 1.f : 0.f, 0.f);
  load_gates(a, L, params, cs, gates);
  forward_chain(A, gates, a.placements, a.n, a.nb, lc);
  float2* out = a.U + (size_t)blockIdx.x * amps;
  for (int e = threadIdx.x; e < amps; e += blockDim.x) out[e] = A[e];
}

__global__ void __launch_bounds__(kMaxThreads)
vjp_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(a.n, a.nb, a.tpl.nba, a.log_c, true);
  float2* A = reinterpret_cast<float2*>(smem);
  float2* M = reinterpret_cast<float2*>(smem + L.off_M);
  float2* gates = reinterpret_cast<float2*>(smem + L.off_gates);
  float* gbar = reinterpret_cast<float*>(smem + L.off_gbar);
  float* red = reinterpret_cast<float*>(smem + L.off_red);
  float* params = reinterpret_cast<float*>(smem + L.off_params);
  float* grad = reinterpret_cast<float*>(smem + L.off_grad);
  float* cs = reinterpret_cast<float*>(smem + L.off_cs);
  const int lc = a.log_c, amps = 1 << (a.n + lc);

  const float2* u = a.U + (size_t)blockIdx.x * amps;
  const float2* g = a.Ubar + (size_t)blockIdx.x * amps;
  for (int e = threadIdx.x; e < amps; e += blockDim.x) {
    A[e] = u[e];
    const float2 t = g[e];
    M[e] = make_float2(0.5f * t.x, -0.5f * t.y);  // M = conj(g) / 2
  }
  load_gates(a, L, params, cs, gates);
  adjoint_walk(A, M, gates, a.placements, red, gbar, a.n, L.G, lc, L.nw);
  angle_grads(a.tpl, a.n, L.G, cs, gates, gbar, grad);
  __syncthreads();
  for (int i = threadIdx.x; i < L.P; i += blockDim.x)
    a.grad[(size_t)i * a.B + blockIdx.x] = grad[i];
}

using Kernel = void (*)(Args);

Kernel kernel_of(bool vjp) { return vjp ? vjp_kernel : forward_kernel; }

}  // namespace

extern "C" {

// Dynamic shared memory one restart's block needs (vjp: 0 forward, 1 vjp).
long long cpflow_unitary_smem_bytes(int n, int num_blocks, int nba, int log_c,
                                    int vjp) {
  return (long long)make_layout(n, num_blocks, nba, log_c, vjp != 0).bytes;
}

// Launches the forward pass (vjp == 0: writes U) or the vector-Jacobian
// product (vjp == 1: reads U and Ubar, writes grad) on `stream`. angles and
// grad: (P, B) float32; U and Ubar: (B, d, C) complex64 with C = 2^log_c,
// log_c = n or 0; letters: (num_letters,) rotation letters 0, 1, 2 for x, y,
// z; ent: 0 CP, 1 CZ, 2 CX; nba: angles per block. Returns
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
  const Layout L = make_layout(n, num_blocks, nba, log_c, vjp != 0);
  const Kernel kernel = kernel_of(vjp != 0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(B),
                         dim3(L.nt), args, L.bytes,
                         static_cast<cudaStream_t>(stream));
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Registers per thread of the forward (out[0]) and the vjp kernel (out[1]).
// Returns a CUDA error code, 0 on success.
int cpflow_unitary_registers(int* out) {
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel_of(i != 0));
    if (err != cudaSuccess) return (int)err;
    out[i] = attr.numRegs;
  }
  return 0;
}

}  // extern "C"

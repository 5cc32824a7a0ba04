// Chronopoulos-Gear block-Jacobi PCG on stencil-form normal equations in
// two fused passes per iteration, with the scalar recursion on the device.
//
// Replaces the TPU kernels of pypose_tpu/ops/pallas_cg.py:stencil_cg_fused:
//   _fused_axpy_kernel (:253)  pass 1: given (alpha, beta),
//                              p = u + beta p, s = w + beta s,
//                              x += alpha p, r -= alpha s, u = Minv r,
//                              and the dots (r, u), (r, r);
//   _fused_mv_kernel (:290)    pass 2: w = A u and the dot (w, u).
// The Pallas passes accumulate their dots in SMEM across the sequential
// TPU grid and leave the rolls of the back-products and the scalar
// recursion (:408-436) to XLA.  Here pass 2 computes the whole matvec in
// gather form (stencil_common.cuh), so (w, u) is complete after one pass
// and the roll identity of :296-299 is not needed; and the scalars never
// leave the device:
//   - each block reduces its dot partials in a fixed order and writes them
//     to its own slot; the last block to finish (an integer ticket, no
//     float atomics) sums the slots in slot order, so the iteration count
//     is the same on every run;
//   - pass 1 forms alpha and beta from the previous iteration's dots
//     (:423-430) in every thread; pass 2's last block commits the
//     iteration (gamma, delta, rr, the previous gamma and alpha, the
//     iteration count) and decides whether the next one runs
//     (it < maxiter and |r|^2 > tol^2 |b|^2, the while_loop's cond);
//   - once the solve has stopped, further launches return at once, so the
//     host may queue several iterations and read the flag only now and
//     then.
// An init pass (init = 1: alpha = beta = 0 on zero u, p, s, w, x and r = b)
// gives x0 = 0, r0 = b, u0 = Minv b, gamma0, |b|^2 and w0 = A u0, delta0,
// as :408-415 do.
//
// Design: one thread per node, 256 threads a block, the grid over all
// nodes.  Updates are node-local and in place (each thread reads and
// writes only its own node's entries), except w = A u, which reads u at
// the neighbours and writes the separate w.
//
// What bounds it on an H100: device-memory bandwidth.  At the 100k-pose
// graph pass 1 moves 11 vectors and Minv (~41 MB) and pass 2 A, both
// channels, u and w (~48 MB) per iteration, against ~67 MB for the tiled
// kernels plus the ~10 state-vector passes of the torch CG around them.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see pypose_tpu_torch/ops/_build.py)

#include <cuda_runtime.h>

#include "stencil_common.cuh"

namespace {

constexpr int kThreads = 256;

// The solver's scalars, float sc[kNumScalars]: the committed state of the
// recursion, then what pass 1 hands to pass 2.
enum {
  kGamma, kDelta, kGammaPrev, kAlphaPrev, kRR, kTol2,
  kGammaNew, kRRNew, kAlpha, kNumScalars
};
// int st[kNumInts]: iterations done, whether the next iteration runs, and
// the two passes' tickets (always back at 0 between launches).
enum { kIt, kRunning, kTicketAxpy, kTicketMv, kNumInts };

__device__ __forceinline__ float guard(float v) {
  return v == 0.f ? 1e-31f : v;
}

// Publishes this block's two partial sums to its slots and returns, in
// every thread, whether this block is the last of the grid to do so.
__device__ bool publish_partials(float a, float b, float* slots,
                                 int* ticket) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    slots[blockIdx.x] = a;
    slots[gridDim.x + blockIdx.x] = b;
    __threadfence();  // the slots are visible before the ticket is
    last = atomicAdd(ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  return last;
}

// In the last block: the sums of both slot rows, in slot order.
__device__ void sum_slots(const float* slots, float& a, float& b,
                          float* sh) {
  a = 0.f;
  b = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x);
       i += blockDim.x) {
    a += __ldcg(slots + i);  // past L1: other SMs wrote them
    b += __ldcg(slots + gridDim.x + i);
  }
  ppt::block_sum2(a, b, sh);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
fused_axpy_kernel(int init, const float* __restrict__ Minv, int N,
                  float* __restrict__ u, float* __restrict__ p,
                  float* __restrict__ s, const float* __restrict__ w,
                  float* __restrict__ x, float* __restrict__ r, float* sc,
                  int* st, float* slots) {
  __shared__ float sh[66];
  if (!init && !st[kRunning]) return;  // the same in every block
  float alpha = 0.f, beta = 0.f;
  if (!init) {
    const float gamma = sc[kGamma], delta = sc[kDelta];
    const bool first = st[kIt] == 0;
    beta = first ? 0.f : gamma / guard(sc[kGammaPrev]);
    const float den = delta - beta * gamma / guard(sc[kAlphaPrev]);
    alpha = gamma / (first ? guard(delta) : guard(den));
  }
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  float ru = 0.f, rr = 0.f;
  if (n < N) {
    const size_t NN = static_cast<size_t>(N);
    float rv[T], zv[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const size_t j = i * NN + n;
      const float p2 = u[j] + beta * p[j];
      const float s2 = w[j] + beta * s[j];
      p[j] = p2;
      s[j] = s2;
      x[j] = x[j] + alpha * p2;
      rv[i] = r[j] - alpha * s2;
      r[j] = rv[i];
      zv[i] = 0.f;
    }
    ppt::block_mul_add<T, false>(Minv, NN, n, rv, zv);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      u[i * NN + n] = zv[i];
      ru += rv[i] * zv[i];
      rr += rv[i] * rv[i];
    }
  }
  ppt::block_sum2(ru, rr, sh);  // threads past N add zeros
  if (!publish_partials(ru, rr, slots, st + kTicketAxpy)) return;
  float gamma_new, rr_new;
  sum_slots(slots, gamma_new, rr_new, sh);
  if (threadIdx.x == 0) {
    sc[kGammaNew] = gamma_new;
    sc[kRRNew] = rr_new;
    sc[kAlpha] = alpha;
    st[kTicketAxpy] = 0;
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads)
fused_mv_kernel(int init, int maxiter, float tol2_scale,
                const float* __restrict__ A, const float* __restrict__ C,
                ppt::Offsets offs, int n_off, int N,
                const float* __restrict__ u, float* __restrict__ w,
                float* sc, int* st, float* slots) {
  __shared__ float sh[66];
  if (!init && !st[kRunning]) return;
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  float wu = 0.f, unused = 0.f;
  if (n < N) {
    const size_t NN = static_cast<size_t>(N);
    float un[T], y[T];
#pragma unroll
    for (int i = 0; i < T; ++i) un[i] = u[i * NN + n];
    ppt::stencil_row<T>(A, C, u, offs, n_off, N, n, un, y);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      w[i * NN + n] = y[i];
      wu += y[i] * un[i];
    }
  }
  ppt::block_sum2(wu, unused, sh);
  if (!publish_partials(wu, unused, slots, st + kTicketMv)) return;
  float delta;
  sum_slots(slots, delta, unused, sh);
  if (threadIdx.x == 0) {
    int it;
    if (init) {
      sc[kTol2] = tol2_scale * sc[kRRNew];
      sc[kGammaPrev] = 1.f;
      sc[kAlphaPrev] = 1.f;
      it = 0;
    } else {
      sc[kGammaPrev] = sc[kGamma];
      sc[kAlphaPrev] = sc[kAlpha];
      it = st[kIt] + 1;
    }
    sc[kGamma] = sc[kGammaNew];
    sc[kRR] = sc[kRRNew];
    sc[kDelta] = delta;
    st[kIt] = it;
    st[kRunning] = it < maxiter && sc[kRR] > sc[kTol2];
    st[kTicketMv] = 0;
  }
}

int blocks_for(int N) { return (N + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Floats of dot-product slots the passes need for N nodes.
int ppt_fused_slots(int N) { return 2 * blocks_for(N); }

// Pass 1 on `stream`; returns cudaGetLastError() (0 on success).  `sc`
// holds kNumScalars floats and `st` kNumInts ints (zeroed before the init
// pass), `slots` ppt_fused_slots(N) floats.  t = 6 only.
int ppt_fused_axpy(int t, int init, const float* Minv, int N, float* u,
                   float* p, float* s, const float* w, float* x, float* r,
                   float* sc, int* st, float* slots, void* stream) {
  if (N <= 0 || t != 6) return static_cast<int>(cudaErrorInvalidValue);
  fused_axpy_kernel<6><<<blocks_for(N), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      init, Minv, N, u, p, s, w, x, r, sc, st, slots);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 on `stream`; returns cudaGetLastError().  `offsets` is a host
// array of n_off circular offsets in [0, N).  t = 6 only.
int ppt_fused_mv(int t, int init, int maxiter, double tol, const float* A,
                 const float* C, const int* offsets, int n_off, int N,
                 const float* u, float* w, float* sc, int* st, float* slots,
                 void* stream) {
  ppt::Offsets offs;
  if (!ppt::make_offsets(offsets, n_off, &offs) || N <= 0 || t != 6)
    return static_cast<int>(cudaErrorInvalidValue);
  // same rounding as (tol * tol) * |b|^2 with a float32 |b|^2
  const float tol2_scale = static_cast<float>(tol * tol);
  fused_mv_kernel<6><<<blocks_for(N), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      init, maxiter, tol2_scale, A, C, offs, n_off, N, u, w, sc, st, slots);
  return static_cast<int>(cudaGetLastError());
}

const char* ppt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

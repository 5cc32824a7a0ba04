// Whole-solve block-Jacobi PCG on stencil-form normal equations, in one
// kernel launch.
//
// Replaces the TPU kernel pypose_tpu/ops/pallas_cg.py:_kernel (the Pallas
// body of stencil_cg_transposed, which runs _cg_body with every operand in
// VMEM).  It computes what _cg_body computes: x0 = 0, r0 = b, z0 = Minv r0,
// p0 = z0; each iteration Ap = A p, alpha = (r.z) / (p.Ap), x += alpha p,
// r -= alpha Ap, z = Minv r, beta = (r.z)_new / (r.z), p = z + beta p; stop
// when |r|^2 <= tol^2 |b|^2 or at maxiter; divisions by zero are guarded
// with 1e-31.  The operator is
//
//   (A p)_n = A_n p_n + sum_k [ C_k[n] p_{(n+d_k) mod N}
//                              + C_k[(n-d_k) mod N]^T p_{(n-d_k) mod N} ],
//
// computed in gather form (each node reads its neighbours; no atomics).
// Layouts and the shared pieces: stencil_common.cuh.
//
// Design: ONE persistent thread block of 1024 threads runs the whole loop,
// maxiter included.  Threads stride over nodes, so each thread owns the
// same nodes in every phase and the per-node updates need no barrier.  The
// vectors x, r, z, p and Ap live in global scratch that the caller
// allocates; at sphere2500's size (~1.8 MB of operands and state) they stay
// resident in the 50 MB L2.  Dot products are block-wide tree reductions
// in shared memory in a fixed order, so the iteration count is the same on
// every run.
//
// What bounds it on an H100: one SM does all the work, so each iteration
// is bounded by that SM's L2 bandwidth (it reads A, Minv and both sides of
// every channel, ~216 floats per node) and by the five block barriers per
// iteration.  The multi-SM design (a thread-block cluster keeping the state
// in distributed shared memory, or a cooperative grid-sync kernel) is later
// work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see pypose_tpu_torch/ops/_build.py)

#include <cuda_runtime.h>

#include "stencil_common.cuh"

namespace {

using ppt::block_mul_add;
using ppt::block_sum2;
using ppt::Offsets;

constexpr int kThreads = 1024;

template <int T>
__global__ void __launch_bounds__(kThreads, 1)
stencil_pcg_kernel(const float* __restrict__ b, const float* __restrict__ A,
                   const float* __restrict__ Minv,
                   const float* __restrict__ C, Offsets offs, int n_off,
                   int N, int maxiter, float tol2_scale, float* x, float* r,
                   float* z, float* p, float* Ap, int* it_out) {
  __shared__ float sh[66];
  const size_t NN = static_cast<size_t>(N);

  // x = 0, r = b, z = Minv r, p = z; gamma = r.z, |b|^2
  float gamma = 0.f, bb = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float rv[T], zv[T];
#pragma unroll
    for (int i = 0; i < T; ++i) {
      rv[i] = b[i * NN + n];
      x[i * NN + n] = 0.f;
      r[i * NN + n] = rv[i];
      bb += rv[i] * rv[i];
      zv[i] = 0.f;
    }
    block_mul_add<T, false>(Minv, NN, n, rv, zv);
#pragma unroll
    for (int i = 0; i < T; ++i) {
      z[i * NN + n] = zv[i];
      p[i * NN + n] = zv[i];
      gamma += rv[i] * zv[i];
    }
  }
  block_sum2(gamma, bb, sh);  // its barriers also publish p
  const float tol2 = tol2_scale * bb;
  float rr = bb;
  int it = 0;

  while (it < maxiter && rr > tol2) {
    // Ap = A p (gather form) and p.Ap
    float pap = 0.f, unused = 0.f;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float pn[T], y[T];
#pragma unroll
      for (int i = 0; i < T; ++i) pn[i] = p[i * NN + n];
      ppt::stencil_row<T>(A, C, p, offs, n_off, N, n, pn, y);
#pragma unroll
      for (int i = 0; i < T; ++i) {
        Ap[i * NN + n] = y[i];
        pap += pn[i] * y[i];
      }
    }
    block_sum2(pap, unused, sh);
    const float alpha = gamma / (pap == 0.f ? 1e-31f : pap);

    // x += alpha p, r -= alpha Ap, z = Minv r; new r.z and |r|^2
    float gnew = 0.f, rnew = 0.f;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      float rv[T], zv[T];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        x[i * NN + n] += alpha * p[i * NN + n];
        rv[i] = r[i * NN + n] - alpha * Ap[i * NN + n];
        r[i * NN + n] = rv[i];
        rnew += rv[i] * rv[i];
        zv[i] = 0.f;
      }
      block_mul_add<T, false>(Minv, NN, n, rv, zv);
#pragma unroll
      for (int i = 0; i < T; ++i) {
        z[i * NN + n] = zv[i];
        gnew += rv[i] * zv[i];
      }
    }
    block_sum2(gnew, rnew, sh);
    const float beta = gnew / (gamma == 0.f ? 1e-31f : gamma);

    // p = z + beta p, then publish p to the block for the next matvec
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
#pragma unroll
      for (int i = 0; i < T; ++i)
        p[i * NN + n] = z[i * NN + n] + beta * p[i * NN + n];
    }
    __syncthreads();
    gamma = gnew;
    rr = rnew;
    ++it;
  }
  if (threadIdx.x == 0) *it_out = it;
}

}  // namespace

extern "C" {

// Launches the solve on `stream` and returns cudaGetLastError() (0 on
// success).  `offsets` is a host array of n_off circular offsets in
// [0, N); `scratch` holds 4*t*N floats (r, z, p, Ap); `it` receives the
// iteration count.  Only t = 6 is instantiated.
int ppt_stencil_pcg(int t, const float* b, const float* A, const float* Minv,
                    const float* C, const int* offsets, int n_off, int N,
                    int maxiter, double tol, float* x, float* scratch,
                    int* it, void* stream) {
  Offsets offs;
  if (!ppt::make_offsets(offsets, n_off, &offs) || N <= 0 || t != 6)
    return static_cast<int>(cudaErrorInvalidValue);
  // same rounding as (tol * tol) * |b|^2 with a float32 |b|^2
  const float tol2_scale = static_cast<float>(tol * tol);
  const size_t tN = static_cast<size_t>(t) * N;
  float* r = scratch;
  float* z = scratch + tN;
  float* p = scratch + 2 * tN;
  float* Ap = scratch + 3 * tN;
  stencil_pcg_kernel<6><<<1, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      b, A, Minv, C, offs, n_off, N, maxiter, tol2_scale, x, r, z, p, Ap,
      it);
  return static_cast<int>(cudaGetLastError());
}

const char* ppt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Pieces shared by the stencil PCG kernels (stencil_cg.cu,
// stencil_cg_tiled.cu, stencil_cg_fused.cu).
//
// Layouts (float32, lane-major: node n is the fastest index, so
// neighbouring threads read neighbouring addresses):
//   vectors  [t, N]          entry i of node n at i*N + n
//   blocks   [t*t, N]        block entry (i, u) of node n at (i*t+u)*N + n
//   channels [n_off*t*t, N]  channel k, entry (i, u) at ((k*t+i)*t+u)*N + n
//
// The stencil operator, in gather form (each node reads its neighbours; no
// atomics, and a fixed summation order):
//
//   (A p)_n = A_n p_n + sum_k [ C_k[n] p_{(n+d_k) mod N}
//                              + C_k[(n-d_k) mod N]^T p_{(n-d_k) mod N} ].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace ppt {

constexpr int kMaxOffsets = 16;

// An operand entry as float32: operands are stored as float32 or, in the
// fused solver, as bf16 (widened exactly; the arithmetic stays float32).
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Offsets travel by value in the kernel's parameter space.
struct Offsets {
  int d[kMaxOffsets];
};

// Copies n_off host offsets (each in [0, N)) into the parameter struct;
// false when n_off is out of range.
inline bool make_offsets(const int* offsets, int n_off, Offsets* out) {
  if (n_off < 0 || n_off > kMaxOffsets) return false;
  *out = Offsets{};
  for (int k = 0; k < n_off; ++k) out->d[k] = offsets[k];
  return true;
}

// y += M_n v for the t x t block of node n (transposed: M_n^T v); M holds
// float32 or bf16 entries.
template <int T, bool kTranspose, typename OpT>
__device__ __forceinline__ void block_mul_add(const OpT* __restrict__ M,
                                              size_t N, int n,
                                              const float* v, float* y) {
#pragma unroll
  for (int i = 0; i < T; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < T; ++u) {
      const int e = kTranspose ? (u * T + i) : (i * T + u);
      acc += to_f32(M[e * N + n]) * v[u];
    }
    y[i] += acc;
  }
}

// y = (A p)_n, with pn = p_n already loaded.
template <int T>
__device__ __forceinline__ void stencil_row(const float* __restrict__ A,
                                            const float* __restrict__ C,
                                            const float* p,
                                            const Offsets& offs, int n_off,
                                            int N, int n, const float* pn,
                                            float* y) {
  const size_t NN = static_cast<size_t>(N);
  const size_t TT = static_cast<size_t>(T) * T;
  float q[T];
#pragma unroll
  for (int i = 0; i < T; ++i) y[i] = 0.f;
  block_mul_add<T, false>(A, NN, n, pn, y);
  for (int k = 0; k < n_off; ++k) {
    const int d = offs.d[k];
    const float* Ck = C + k * TT * NN;
    int nf = n + d;
    if (nf >= N) nf -= N;
    int nb = n - d;
    if (nb < 0) nb += N;
#pragma unroll
    for (int u = 0; u < T; ++u) q[u] = p[u * NN + nf];
    block_mul_add<T, false>(Ck, NN, n, q, y);
#pragma unroll
    for (int u = 0; u < T; ++u) q[u] = p[u * NN + nb];
    block_mul_add<T, true>(Ck, NN, nb, q, y);
  }
}

// Block-wide sums of two values: shuffles within each warp, then warp 0
// over the per-warp partials (at most 32 warps).  Fixed order, so the
// result is the same on every run.  `sh` holds 66 floats; every thread
// returns both sums.
__device__ __forceinline__ void block_sum2(float& a, float& b, float* sh) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    sh[warp] = a;
    sh[32 + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    a = lane < nwarps ? sh[lane] : 0.f;
    b = lane < nwarps ? sh[32 + lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      b += __shfl_down_sync(0xffffffffu, b, o);
    }
    if (lane == 0) {
      sh[64] = a;
      sh[65] = b;
    }
  }
  __syncthreads();
  a = sh[64];
  b = sh[65];
}

}  // namespace ppt

// Per-iteration kernels of the HBM-streamed stencil PCG: the stencil
// matvec and the block-Jacobi apply, one launch each per CG iteration.
//
// Replaces the TPU kernels of pypose_tpu/ops/pallas_cg.py:stencil_cg_tiled:
//   _tiled_mv_kernel (:131)  q = A p + sum_k C_k p_{+d_k} per node tile, and
//                            bk_k = C_k^T p, which the caller rolls by +d_k
//                            and adds (:213-223);
//   _tiled_pc_kernel (:149)  z = Minv r per node tile.
// ppt_tiled_mv computes the whole matvec q = A p in gather form (see
// stencil_common.cuh): node n reads C_k at n - d_k and applies its
// transpose, so no back-products, rolls or atomics are needed and the
// summation order is fixed.  The CG state (x, r, z, p, the dot products,
// the stop test) stays in torch ops, as the JAX package keeps it in XLA ops
// (pypose_tpu_torch/ops/stencil_cg.py:_tiled_cg).
//
// Design: one thread per node, 256 threads a block, the grid over all
// nodes, so every SM streams its share of the operands.  The block size t
// is a template parameter, instantiated for 3, 4, 6 and 7.  Neighbouring
// threads read neighbouring addresses of every [*, N] row.
//
// What bounds it on an H100: device-memory bandwidth.  At the 100k-pose
// graph (t = 6, offsets (1, 993)) the operands are ~72 MB, more than the
// 50 MB L2, so every iteration streams them from HBM: the matvec reads A
// (36 floats a node), both channels (72) and p, and writes q (~48 MB); the
// apply reads Minv (36) and r and writes z (~19 MB).  The gather form
// reads channel k a second time at n - d_k; for d = 1 that is the same
// cache line and for d = 993 a block ~4 blocks back, which the L2 still
// holds, so HBM sees each channel about once.  Fusing the CG state into
// the passes is stencil_cg_fused.cu's design.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see pypose_tpu_torch/ops/_build.py)

#include <cuda_runtime.h>

#include "stencil_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int T>
__global__ void __launch_bounds__(kThreads)
tiled_mv_kernel(const float* __restrict__ A, const float* __restrict__ C,
                ppt::Offsets offs, int n_off, int N,
                const float* __restrict__ p, float* __restrict__ q) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t NN = static_cast<size_t>(N);
  float pn[T], y[T];
#pragma unroll
  for (int i = 0; i < T; ++i) pn[i] = p[i * NN + n];
  ppt::stencil_row<T>(A, C, p, offs, n_off, N, n, pn, y);
#pragma unroll
  for (int i = 0; i < T; ++i) q[i * NN + n] = y[i];
}

template <int T>
__global__ void __launch_bounds__(kThreads)
tiled_pc_kernel(const float* __restrict__ Minv, int N,
                const float* __restrict__ r, float* __restrict__ z) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t NN = static_cast<size_t>(N);
  float rv[T], zv[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    rv[i] = r[i * NN + n];
    zv[i] = 0.f;
  }
  ppt::block_mul_add<T, false>(Minv, NN, n, rv, zv);
#pragma unroll
  for (int i = 0; i < T; ++i) z[i * NN + n] = zv[i];
}

int blocks_for(int N) { return (N + kThreads - 1) / kThreads; }

template <int T>
void launch_mv(const float* A, const float* C, const ppt::Offsets& offs,
               int n_off, int N, const float* p, float* q, cudaStream_t s) {
  tiled_mv_kernel<T><<<blocks_for(N), kThreads, 0, s>>>(A, C, offs, n_off, N,
                                                        p, q);
}

template <int T>
void launch_pc(const float* Minv, int N, const float* r, float* z,
               cudaStream_t s) {
  tiled_pc_kernel<T><<<blocks_for(N), kThreads, 0, s>>>(Minv, N, r, z);
}

}  // namespace

extern "C" {

// q = A p on `stream`; returns cudaGetLastError() (0 on success).
// `offsets` is a host array of n_off circular offsets in [0, N).
// Instantiated for t = 3, 4, 6 and 7 (any other t: cudaErrorInvalidValue).
int ppt_tiled_mv(int t, const float* A, const float* C, const int* offsets,
                 int n_off, int N, const float* p, float* q, void* stream) {
  ppt::Offsets offs;
  if (!ppt::make_offsets(offsets, n_off, &offs) || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (t) {
    case 3:
      launch_mv<3>(A, C, offs, n_off, N, p, q, s);
      break;
    case 4:
      launch_mv<4>(A, C, offs, n_off, N, p, q, s);
      break;
    case 6:
      launch_mv<6>(A, C, offs, n_off, N, p, q, s);
      break;
    case 7:
      launch_mv<7>(A, C, offs, n_off, N, p, q, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// z = Minv r on `stream`; returns cudaGetLastError().  t as ppt_tiled_mv.
int ppt_tiled_pc(int t, const float* Minv, int N, const float* r, float* z,
                 void* stream) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (t) {
    case 3:
      launch_pc<3>(Minv, N, r, z, s);
      break;
    case 4:
      launch_pc<4>(Minv, N, r, z, s);
      break;
    case 6:
      launch_pc<6>(Minv, N, r, z, s);
      break;
    case 7:
      launch_pc<7>(Minv, N, r, z, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ppt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

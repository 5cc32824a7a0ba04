// Brute-force nearest neighbours: nn1 (k = 1) and nnk (running top-k), one
// kernel template for both.
//
// Replaces the TPU kernels of pypose_tpu/ops/pallas_knn.py:
//   _knn1_kernel (:22)  per [Tr, Tn] tile, the Gram-form squared distance
//                       and a running min/argmin per reference row;
//   _knnk_kernel (:50)  per tile, k min/argmin/mask passes, then a
//                       first-occurrence merge of 2k candidates.
// Here each thread owns one reference row and scans every neighbour in
// ascending index, keeping its best K as a list sorted by (d^2, index).  A
// neighbour enters only with a strictly smaller d^2 than the entry it
// displaces, so among equal distances the lower index stays first: the
// Pallas kernels' first occurrence within a tile and earlier tile across
// tiles.  nn1 is K = 1.
//
// d^2 = (|a|^2 + |b|^2) - 2 a.b with every product and sum rounded once
// (__fmul_rn/__fadd_rn: no contraction), the cross term summed from the
// first coordinate.  That is the order of the plain PyTorch version
// (pypose_tpu_torch/ops/knn.py:_gram_d2), so both give the same bits and
// the same neighbours.  The clamp at 0 comes after the choice, as in
// pallas_knn.py:153,191.
//
// Design: 128 threads a block, one reference row each; neighbours are
// staged through shared memory kTile at a time with their |b|^2, so a
// thread reads each neighbour as one broadcast shared-memory load and
// keeps its own point, |a|^2 and its list in registers.  No padding:
// bounds checks replace the Pallas kernels' +inf rows.
//
// What bounds it on an H100: instruction throughput.  Each pair costs
// about 12 instructions per thread (3 FMUL + 3 FADD + 1 FFMA for d^2, a
// compare, a select, an index move and loop overhead) against one
// broadcast shared-memory load, so the 100k x 100k association of ICP
// (1e10 pairs) is ~4e9 warp instructions, a few ms at the card's ~1e12
// warp instructions per second; device memory sees only the clouds (each
// block rereads the 1.2 MB neighbour cloud from L2).  Dropping the
// bit-for-bit agreement with the plain version (FMA contraction, |a|^2
// added after the scan) would halve the count.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see pypose_tpu_torch/ops/_build.py)

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;  // neighbours in shared memory per pass
constexpr int kMaxDim = 4;   // ops/knn.py:MAX_DIM
constexpr int kMaxK = 16;    // ops/knn.py:MAX_K

template <int D>
__device__ __forceinline__ float sqnorm(const float* x) {
  float s = __fmul_rn(x[0], x[0]);
#pragma unroll
  for (int c = 1; c < D; ++c) s = __fadd_rn(s, __fmul_rn(x[c], x[c]));
  return s;
}

// Inserts (d, j) into the list (v, id) sorted by (d^2, index); j is above
// every index already held.
template <int K>
__device__ __forceinline__ void insert(float d, int j, float* v, int* id) {
  if (!(d < v[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (d < v[s - 1]) {
      v[s] = v[s - 1];
      id[s] = id[s - 1];
    } else if (d < v[s]) {
      v[s] = d;
      id[s] = j;
    }
  }
  if (d < v[0]) {
    v[0] = d;
    id[0] = j;
  }
}

template <int D, int K>
__global__ void __launch_bounds__(kThreads)
knn_kernel(const float* __restrict__ ref, const float* __restrict__ nbr,
           int R, int N, int k, float* __restrict__ d2_out,
           long long* __restrict__ idx_out) {
  // each neighbour: D coordinates then |b|^2
  __shared__ __align__(16) float tile[kTile * (D + 1)];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < R;
  float a[D];
#pragma unroll
  for (int c = 0; c < D; ++c)
    a[c] = live ? ref[static_cast<size_t>(row) * D + c] : 0.f;
  const float an = sqnorm<D>(a);
  float v[K];
  int id[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    v[s] = CUDART_INF_F;
    id[s] = 0;
  }
  for (int j0 = 0; j0 < N; j0 += kTile) {
    const int n = min(kTile, N - j0);
    __syncthreads();  // the previous tile has been read
    for (int t = threadIdx.x; t < n; t += kThreads) {
      float b[D];
#pragma unroll
      for (int c = 0; c < D; ++c)
        b[c] = nbr[static_cast<size_t>(j0 + t) * D + c];
#pragma unroll
      for (int c = 0; c < D; ++c) tile[t * (D + 1) + c] = b[c];
      tile[t * (D + 1) + D] = sqnorm<D>(b);
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      float b[D + 1];
      if constexpr (D == 3) {
        const float4 q = reinterpret_cast<const float4*>(tile)[t];
        b[0] = q.x;
        b[1] = q.y;
        b[2] = q.z;
        b[3] = q.w;
      } else {
#pragma unroll
        for (int c = 0; c <= D; ++c) b[c] = tile[t * (D + 1) + c];
      }
      float cross = __fmul_rn(a[0], b[0]);
#pragma unroll
      for (int c = 1; c < D; ++c)
        cross = __fadd_rn(cross, __fmul_rn(a[c], b[c]));
      // 2 * cross is exact, so this rounds once, as (an + bn) - 2 cross does
      const float d = __fmaf_rn(-2.f, cross, __fadd_rn(an, b[D]));
      insert<K>(d, j0 + t, v, id);
    }
  }
  if (!live) return;
  const size_t out = static_cast<size_t>(row) * k;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k) {
      d2_out[out + s] = fmaxf(v[s], 0.f);
      idx_out[out + s] = id[s];
    }
  }
}

template <int D, int K>
void launch_k(const float* ref, const float* nbr, int R, int N, int k,
              float* d2, long long* idx, cudaStream_t stream) {
  knn_kernel<D, K><<<(R + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      ref, nbr, R, N, k, d2, idx);
}

template <int D>
cudaError_t launch(const float* ref, const float* nbr, int R, int N, int k,
                   float* d2, long long* idx, cudaStream_t stream) {
  // the smallest list that holds k; its first k entries are the answer
  if (k == 1)
    launch_k<D, 1>(ref, nbr, R, N, k, d2, idx, stream);
  else if (k <= 2)
    launch_k<D, 2>(ref, nbr, R, N, k, d2, idx, stream);
  else if (k <= 4)
    launch_k<D, 4>(ref, nbr, R, N, k, d2, idx, stream);
  else if (k <= 8)
    launch_k<D, 8>(ref, nbr, R, N, k, d2, idx, stream);
  else
    launch_k<D, kMaxK>(ref, nbr, R, N, k, d2, idx, stream);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The k nearest of N neighbours (nbr [N, D]) of each of R reference rows
// (ref [R, D]), both float32 row-major: d2 [R, k] ascending, clamped at 0,
// and idx [R, k] int64, on `stream`.  Returns cudaGetLastError() (0 on
// success); invalid sizes (1 <= k <= min(N, 16), 1 <= D <= 4, R >= 1)
// return cudaErrorInvalidValue without launching.
int ppt_knn(const float* ref, const float* nbr, int R, int N, int D, int k,
            float* d2, long long* idx, void* stream) {
  if (R <= 0 || N <= 0 || k < 1 || k > N || k > kMaxK || D < 1 ||
      D > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1: return static_cast<int>(launch<1>(ref, nbr, R, N, k, d2, idx, s));
    case 2: return static_cast<int>(launch<2>(ref, nbr, R, N, k, d2, idx, s));
    case 3: return static_cast<int>(launch<3>(ref, nbr, R, N, k, d2, idx, s));
    default: return static_cast<int>(launch<4>(ref, nbr, R, N, k, d2, idx, s));
  }
}

const char* ppt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

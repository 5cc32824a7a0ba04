// Brute-force nearest neighbours: nn1 (k = 1), a register-tiled scan of
// its own, and nnk (a running top-k; the wrappers send it k >= 2).
//
// Replaces the TPU kernels of pypose_tpu/ops/pallas_knn.py:
//   _knn1_kernel (:22)  per [Tr, Tn] tile, the Gram-form squared distance
//                       and a running min/argmin per reference row;
//   _knnk_kernel (:50)  per tile, k min/argmin/mask passes, then a
//                       first-occurrence merge of 2k candidates.
// Both return, among equal distances, the lowest index: the Pallas
// kernels' first occurrence within a tile and earlier tile across tiles.
//
// nn1.  Neighbours are staged through shared memory as one float4 each,
// (-2 b_0, -2 b_1, -2 b_2, |b|^2) (D = 4: the four -2 b_c and |b|^2 in a
// second array), and each thread holds kRT = 8 reference rows in
// registers, so one broadcast LDS.128 feeds eight rows and a pair costs
// three FFMA, s = fma(a_2, -2 b_2, fma(a_1, -2 b_1, fma(a_0, -2 b_0,
// |b|^2))), and one FMNMX.  Min first, index later: a row keeps only the
// running min of s, and after each sub-tile of kSub neighbours notes the
// sub-tile if the min fell in it (a strict <, so a tie keeps the earlier
// one).  At the end of a staged tile, a row whose min fell there scans that
// sub-tile again in ascending order for the first exact match under the
// same arithmetic.  Rescanning every sub-tile where some row of a warp
// improved would cost more than the scan itself: in a warp of 256 rows
// some row improves in most early sub-tiles.  The
// neighbour range is split over blockIdx.y so that ~16 blocks an SM are in
// flight; a merge pass takes each row's best over the splits in order
// (strict <, so the lower index on ties), adds |a|^2 and clamps at 0, as
// pallas_knn.py:153 does.  d^2 rounds differently from the plain version
// (ops/knn.py:_gram_d2, every product and sum rounded alone), so on a
// near-tie the two may pick different neighbours: the card is held to the
// tolerance of pypose_tpu_torch/testing:nn1_tolerance_failures.
//
// nnk.  Each thread owns one reference row and scans every neighbour in
// ascending index, keeping its best K as a list sorted by (d^2, index).  A
// neighbour enters only with a strictly smaller d^2 than the entry it
// displaces, so among equal distances the lower index stays first.  d^2 =
// (|a|^2 + |b|^2) - 2 a.b with every product and sum rounded once
// (__fmul_rn/__fadd_rn: no contraction), the cross term summed from the
// first coordinate: the order of the plain PyTorch version, so both give
// the same bits.  The clamp at 0 comes after the choice, as in
// pallas_knn.py:191.  128 threads a block; neighbours staged through
// shared memory kTile at a time with their |b|^2; no padding: bounds
// checks replace the Pallas kernels' +inf rows.
//
// What bounds them on an H100: instruction issue.  nn1 needs 3 FMA a pair:
// 1e10 pairs (ICP's 100k x 100k) are 6e10 flop, 0.90 ms at 67 TFLOP/s;
// with the FMNMX and one LDS.128 per kRT pairs the scan issues ~4.2
// instructions a pair, ~1.3e9 warp instructions, ~1.3 ms at one per
// cycle per scheduler.  nnk issues ~12 a pair (3 FMUL + 3 FADD + 1 FFMA,
// the list's compares and selects, loop overhead).  Device memory sees
// only the clouds (each block rereads its neighbours from L2).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see pypose_tpu_torch/ops/_build.py)

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

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
  // (k = 1 reaches here only by a direct call: the wrappers send it to nn1)
  if (k <= 2)
    launch_k<D, 2>(ref, nbr, R, N, k, d2, idx, stream);
  else if (k <= 4)
    launch_k<D, 4>(ref, nbr, R, N, k, d2, idx, stream);
  else if (k <= 8)
    launch_k<D, 8>(ref, nbr, R, N, k, d2, idx, stream);
  else
    launch_k<D, kMaxK>(ref, nbr, R, N, k, d2, idx, stream);
  return cudaGetLastError();
}

// ---- nn1 ------------------------------------------------------------------

constexpr int kNn1Threads = 128;
constexpr int kRT = 8;                          // reference rows a thread
constexpr int kNn1Rows = kNn1Threads * kRT;     // reference rows a block
constexpr int kNn1Tile = 1024;                  // neighbours staged a pass
constexpr int kSub = 32;                        // neighbours a sub-tile
constexpr int kMinSplit = 2048;                 // neighbours a split, least
constexpr int kBlocksPerSm = 16;                // blocks in flight, aim

// s = |b|^2 - 2 a.b from the staged (-2 b, |b|^2), FMA from the first
// coordinate; the scan and its rescan call this one function, so a rescan
// finds the min's bits again.
template <int D>
__device__ __forceinline__ float score(const float* a, float4 w, float bn) {
  float s = __fmaf_rn(a[0], w.x, bn);
  if (D > 1) s = __fmaf_rn(a[1], w.y, s);
  if (D > 2) s = __fmaf_rn(a[2], w.z, s);
  if (D > 3) s = __fmaf_rn(a[3], w.w, s);
  return s;
}

// Each row's least s over the neighbours [split * chunk, + chunk), and the
// first index that gives it, into part_s / part_i [splits, R].
template <int D>
__global__ void __launch_bounds__(kNn1Threads, 4)
nn1_scan(const float* __restrict__ ref, const float* __restrict__ nbr,
         int R, int N, int chunk, float* __restrict__ part_s,
         int* __restrict__ part_i) {
  __shared__ float4 tw[kNn1Tile];
  __shared__ float tb[D == 4 ? kNn1Tile : 1];
  const int j_begin = blockIdx.y * chunk;
  const int j_end = min(N, j_begin + chunk);
  const int row0 = blockIdx.x * kNn1Rows + threadIdx.x;
  float a[kRT][D], best[kRT];
  int bidx[kRT];
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int row = row0 + r * kNn1Threads;
#pragma unroll
    for (int c = 0; c < D; ++c)
      a[r][c] = row < R ? ref[static_cast<size_t>(row) * D + c] : 0.f;
    best[r] = CUDART_INF_F;
    bidx[r] = 0;
  }
  for (int t0 = j_begin; t0 < j_end; t0 += kNn1Tile) {
    const int n = min(kNn1Tile, j_end - t0);
    const int n_pad = (n + kSub - 1) / kSub * kSub;
    __syncthreads();  // the previous tile has been read
    for (int t = threadIdx.x; t < n_pad; t += kNn1Threads) {
      // padding: zero coordinates and |b|^2 = inf, so s = inf
      float b[4] = {0.f, 0.f, 0.f, 0.f};
      float bn = CUDART_INF_F;
      if (t < n) {
#pragma unroll
        for (int c = 0; c < D; ++c)
          b[c] = nbr[static_cast<size_t>(t0 + t) * D + c];
        bn = b[0] * b[0];
#pragma unroll
        for (int c = 1; c < D; ++c) bn = __fmaf_rn(b[c], b[c], bn);
      }
      tw[t] = make_float4(-2.f * b[0], -2.f * b[1], -2.f * b[2],
                          D == 4 ? -2.f * b[3] : bn);
      if (D == 4) tb[t] = bn;
    }
    __syncthreads();
    // the running min of each row, and the sub-tile of this tile where it
    // last fell (-1: not in this tile)
    int sub[kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r) sub[r] = -1;
    for (int s0 = 0; s0 < n_pad; s0 += kSub) {
      float m[kRT];
#pragma unroll
      for (int r = 0; r < kRT; ++r) m[r] = best[r];
#pragma unroll 8
      for (int s = 0; s < kSub; ++s) {
        const float4 w = tw[s0 + s];
        const float bn = D == 4 ? tb[s0 + s] : w.w;
#pragma unroll
        for (int r = 0; r < kRT; ++r)
          m[r] = fminf(m[r], score<D>(a[r], w, bn));
      }
#pragma unroll
      for (int r = 0; r < kRT; ++r) {
        sub[r] = m[r] < best[r] ? s0 : sub[r];
        best[r] = m[r];
      }
    }
    // index later: the first match of the min in its sub-tile
#pragma unroll
    for (int r = 0; r < kRT; ++r) {
      if (sub[r] >= 0) {
        int s = 0;
        for (; s < kSub - 1; ++s) {
          const float4 w = tw[sub[r] + s];
          if (score<D>(a[r], w, D == 4 ? tb[sub[r] + s] : w.w) == best[r])
            break;
        }
        bidx[r] = t0 + sub[r] + s;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int row = row0 + r * kNn1Threads;
    if (row < R) {
      part_s[static_cast<size_t>(blockIdx.y) * R + row] = best[r];
      part_i[static_cast<size_t>(blockIdx.y) * R + row] = bidx[r];
    }
  }
}

// Each row's best over the splits in order (strict <: the lower index on
// ties), then d^2 = s + |a|^2 clamped at 0.
template <int D>
__global__ void nn1_merge(const float* __restrict__ ref, int R, int splits,
                          const float* __restrict__ part_s,
                          const int* __restrict__ part_i,
                          float* __restrict__ d2,
                          long long* __restrict__ idx) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float best = part_s[row];
  int bi = part_i[row];
  for (int sp = 1; sp < splits; ++sp) {
    const float v = part_s[static_cast<size_t>(sp) * R + row];
    if (v < best) {
      best = v;
      bi = part_i[static_cast<size_t>(sp) * R + row];
    }
  }
  const float* a = ref + static_cast<size_t>(row) * D;
  float an = a[0] * a[0];
#pragma unroll
  for (int c = 1; c < D; ++c) an = __fmaf_rn(a[c], a[c], an);
  d2[row] = fmaxf(__fadd_rn(best, an), 0.f);
  idx[row] = bi;
}

// Neighbours a split: ceil(N / splits) rounded up to whole sub-tiles.
int nn1_chunk(int N, int splits) {
  const int c = (N + splits - 1) / splits;
  return (c + kSub - 1) / kSub * kSub;
}

template <int D>
cudaError_t launch_nn1(const float* ref, const float* nbr, int R, int N,
                       int splits, float* part_s, int* part_i, float* d2,
                       long long* idx, cudaStream_t stream) {
  const dim3 grid((R + kNn1Rows - 1) / kNn1Rows, splits);
  nn1_scan<D><<<grid, kNn1Threads, 0, stream>>>(
      ref, nbr, R, N, nn1_chunk(N, splits), part_s, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  nn1_merge<D><<<(R + 255) / 256, 256, 0, stream>>>(ref, R, splits, part_s,
                                                    part_i, d2, idx);
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

// Splits of the neighbour range that nn1 uses for R rows and N
// neighbours on the current device: enough for ~16 blocks an SM, at least
// 2048 neighbours each.  ppt_nn1's scratch holds splits * R floats and
// splits * R ints.  Returns 0 on invalid sizes or a device query failure.
int ppt_nn1_splits(int R, int N) {
  int dev = 0, sms = 0;
  if (R <= 0 || N <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const int row_blocks = (R + kNn1Rows - 1) / kNn1Rows;
  const int want = (kBlocksPerSm * sms + row_blocks - 1) / row_blocks;
  const int splits = std::max(1, std::min(want, N / kMinSplit));
  const int chunk = nn1_chunk(N, splits);
  return (N + chunk - 1) / chunk;
}

// The nearest of N neighbours (nbr [N, D]) of each of R reference rows
// (ref [R, D]), both float32 row-major: d2 [R] clamped at 0 and idx [R]
// int64, on `stream`, through `splits` (ppt_nn1_splits) partial results in
// part_s [splits, R] / part_i [splits, R].  Returns cudaGetLastError()
// (0 on success); invalid sizes (R, N, splits >= 1, 1 <= D <= 4) return
// cudaErrorInvalidValue without launching.
int ppt_nn1(const float* ref, const float* nbr, int R, int N, int D,
            int splits, float* part_s, int* part_i, float* d2,
            long long* idx, void* stream) {
  if (R <= 0 || N <= 0 || splits < 1 || splits > N || D < 1 ||
      D > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1: return static_cast<int>(launch_nn1<1>(ref, nbr, R, N, splits,
                                                  part_s, part_i, d2, idx, s));
    case 2: return static_cast<int>(launch_nn1<2>(ref, nbr, R, N, splits,
                                                  part_s, part_i, d2, idx, s));
    case 3: return static_cast<int>(launch_nn1<3>(ref, nbr, R, N, splits,
                                                  part_s, part_i, d2, idx, s));
    default: return static_cast<int>(launch_nn1<4>(
        ref, nbr, R, N, splits, part_s, part_i, d2, idx, s));
  }
}

const char* ppt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

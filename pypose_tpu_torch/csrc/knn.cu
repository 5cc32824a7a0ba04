// Brute-force nearest neighbours: nn1 (k = 1) and nnk (2 <= k <= 16), two
// register-tiled scans of one design.
//
// Replaces the TPU kernels of pypose_tpu/ops/pallas_knn.py:
//   _knn1_kernel (:22)  per [Tr, Tn] tile, the Gram-form squared distance
//                       and a running min/argmin per reference row;
//   _knnk_kernel (:50)  per tile, k min/argmin/mask passes, then a
//                       first-occurrence merge of 2k candidates.
// Both return, among equal distances, the lowest index: the Pallas
// kernels' first occurrence within a tile and earlier tile across tiles.
//
// Both scans.  Neighbours are staged through shared memory as one float4
// each, (-2 b_0, -2 b_1, -2 b_2, |b|^2) (D = 4: the four -2 b_c and |b|^2
// in a second array), and each thread holds several reference rows in
// registers, so one broadcast LDS.128 feeds them all and a pair costs
// three FFMA, s = fma(a_2, -2 b_2, fma(a_1, -2 b_1, fma(a_0, -2 b_0,
// |b|^2))), and a compare.  Rows are ranked by s = |b|^2 - 2 a.b; |a|^2 is
// added after the scan, and d^2 clamped at 0, as pallas_knn.py:153 and
// :191 do.  The neighbour range is split over blockIdx.y so that enough
// blocks are in flight; a merge pass combines each row's results over the
// splits in split order.  d^2 rounds differently from the plain version
// (ops/knn.py:_gram_d2, every product and sum rounded alone), so on a
// near-tie the two may pick different neighbours: the card is held to the
// tolerance of pypose_tpu_torch/testing:nnk_tolerance_failures (for k = 1,
// nn1_tolerance_failures).
//
// nn1: min first, index later.  A row keeps only the running min of s (one
// FMNMX a pair), and after each sub-tile of kSub neighbours notes the
// sub-tile if the min fell in it (a strict <, so a tie keeps the earlier
// one).  At the end of a staged tile, a row whose min fell there scans that
// sub-tile again in ascending order for the first exact match under the
// same arithmetic.  Rescanning every sub-tile where some row of a warp
// improved would cost more than the scan itself: in a warp of 256 rows
// some row improves in most early sub-tiles.
//
// nnk: a threshold scan.  Each row keeps its best K (s, index) pairs,
// sorted by (s, index), in registers (K the least of 2, 4, 8, 16 that holds
// k; 4 rows a thread, 2 at K = 16), and the K-th s as its threshold.  Over
// a batch of kBatch = 64 neighbours a pair costs its three FFMA, one
// compare with the threshold and one OR into a 64-bit mask of candidates;
// after the batch each candidate is scored again (the same function, the
// same bits) in ascending index and inserted into the list, which raises
// it past nothing it does not beat (a strict <: among equal s the lower
// index stays first).  A warp runs an insert round whenever one of its
// lanes has a candidate, so batching halves the rounds of the scan's long
// tail, where candidates are rare but some lane has one.  A random cloud makes ~k (1 + ln(M / k)) entries a row over
// a split of M neighbours, so the inserts, divergent as they are, stay a
// small part of the scan.  Each split keeps its first k pairs; the merge
// inserts the splits' lists in split order, each in its order, into one
// list per row, so among equal s the lower index again comes first.
//
// What bounds them on an H100: instruction issue.  nn1 needs 3 FMA a pair:
// 1e10 pairs (ICP's 100k x 100k) are 6e10 flop, 0.90 ms at 67 TFLOP/s;
// with the FMNMX and one LDS.128 per kRT pairs the scan issues ~4.2
// instructions a pair, ~1.3e9 warp instructions, ~1.3 ms at one per
// cycle per scheduler.  nnk issues ~5.5 a pair (3 FFMA, the compare and the
// OR, a share of the LDS) plus its inserts.  Device memory sees only the
// clouds and the splits' partial results (each block rereads its
// neighbours from L2).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see pypose_tpu_torch/ops/_build.py)

#include <cuda_runtime.h>
#include <math_constants.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;   // threads a block, both scans
constexpr int kTile = 1024;     // neighbours staged a pass
constexpr int kSub = 32;        // neighbours a sub-tile
constexpr int kMinSplit = 2048; // neighbours a split, least
constexpr int kMaxDim = 4;      // ops/knn.py:MAX_DIM
constexpr int kMaxK = 16;       // ops/knn.py:MAX_K

// Inserts (d, j) into the list (v, id) sorted by (d^2, index), behind
// every entry whose d^2 it does not beat (a strict <).
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

// s = |b|^2 - 2 a.b from the staged (-2 b, |b|^2), FMA from the first
// coordinate; a scan and its second look at a neighbour call this one
// function, so both see the same bits.
template <int D>
__device__ __forceinline__ float score(const float* a, float4 w, float bn) {
  float s = __fmaf_rn(a[0], w.x, bn);
  if (D > 1) s = __fmaf_rn(a[1], w.y, s);
  if (D > 2) s = __fmaf_rn(a[2], w.z, s);
  if (D > 3) s = __fmaf_rn(a[3], w.w, s);
  return s;
}

// Stages neighbours [t0, t0 + n) into tw (and tb for D = 4), padded to
// n_pad with zero coordinates and |b|^2 = inf, so s = inf.
template <int D>
__device__ __forceinline__ void stage(const float* __restrict__ nbr, int t0,
                                      int n, int n_pad, float4* tw,
                                      float* tb) {
  for (int t = threadIdx.x; t < n_pad; t += kThreads) {
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
}

// |a|^2 of reference row `row`, FMA from the first coordinate.
template <int D>
__device__ __forceinline__ float ref_sqnorm(const float* ref, int row) {
  const float* a = ref + static_cast<size_t>(row) * D;
  float an = a[0] * a[0];
#pragma unroll
  for (int c = 1; c < D; ++c) an = __fmaf_rn(a[c], a[c], an);
  return an;
}

// Neighbours a split: ceil(N / splits) rounded up to whole sub-tiles.
int split_chunk(int N, int splits) {
  const int c = (N + splits - 1) / splits;
  return (c + kSub - 1) / kSub * kSub;
}

// Splits of N neighbours for R rows at `rows` rows a block on the current
// device: enough for `per_sm` blocks an SM, at least kMinSplit neighbours
// each; 0 on invalid sizes or a device query failure.
int splits_for(int R, int N, int rows, int per_sm) {
  int dev = 0, sms = 0;
  if (R <= 0 || N <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const int row_blocks = (R + rows - 1) / rows;
  const int want = (per_sm * sms + row_blocks - 1) / row_blocks;
  const int splits = std::max(1, std::min(want, N / kMinSplit));
  const int chunk = split_chunk(N, splits);
  return (N + chunk - 1) / chunk;
}

// ---- nn1 ------------------------------------------------------------------

constexpr int kRT = 8;                      // reference rows a thread
constexpr int kNn1Rows = kThreads * kRT;    // reference rows a block
constexpr int kNn1BlocksPerSm = 16;         // blocks in flight, aim

// Each row's least s over the neighbours [split * chunk, + chunk), and the
// first index that gives it, into part_s / part_i [splits, R].
template <int D>
__global__ void __launch_bounds__(kThreads, 4)
nn1_scan(const float* __restrict__ ref, const float* __restrict__ nbr,
         int R, int N, int chunk, float* __restrict__ part_s,
         int* __restrict__ part_i) {
  __shared__ float4 tw[kTile];
  __shared__ float tb[D == 4 ? kTile : 1];
  const int j_begin = blockIdx.y * chunk;
  const int j_end = min(N, j_begin + chunk);
  const int row0 = blockIdx.x * kNn1Rows + threadIdx.x;
  float a[kRT][D], best[kRT];
  int bidx[kRT];
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int row = row0 + r * kThreads;
#pragma unroll
    for (int c = 0; c < D; ++c)
      a[r][c] = row < R ? ref[static_cast<size_t>(row) * D + c] : 0.f;
    best[r] = CUDART_INF_F;
    bidx[r] = 0;
  }
  for (int t0 = j_begin; t0 < j_end; t0 += kTile) {
    const int n = min(kTile, j_end - t0);
    const int n_pad = (n + kSub - 1) / kSub * kSub;
    __syncthreads();  // the previous tile has been read
    stage<D>(nbr, t0, n, n_pad, tw, tb);
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
    const int row = row0 + r * kThreads;
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
  d2[row] = fmaxf(__fadd_rn(best, ref_sqnorm<D>(ref, row)), 0.f);
  idx[row] = bi;
}

template <int D>
cudaError_t launch_nn1(const float* ref, const float* nbr, int R, int N,
                       int splits, float* part_s, int* part_i, float* d2,
                       long long* idx, cudaStream_t stream) {
  const dim3 grid((R + kNn1Rows - 1) / kNn1Rows, splits);
  nn1_scan<D><<<grid, kThreads, 0, stream>>>(
      ref, nbr, R, N, split_chunk(N, splits), part_s, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  nn1_merge<D><<<(R + 255) / 256, 256, 0, stream>>>(ref, R, splits, part_s,
                                                    part_i, d2, idx);
  return cudaGetLastError();
}

// ---- nnk ------------------------------------------------------------------

// blocks in flight, aim: fewer splits than nn1's, since each split fills
// its lists from scratch
constexpr int kNnkBlocksPerSm = 4;
constexpr int kBatch = 64;  // neighbours a candidate mask covers

// The list length for k (the least of 2, 4, 8, 16 that holds it), and the
// reference rows a thread keeps in registers with lists of K.
int list_len(int k) { return k <= 2 ? 2 : k <= 4 ? 4 : k <= 8 ? 8 : 16; }
__host__ __device__ constexpr int nnk_rows(int K) { return K >= 16 ? 2 : 4; }

// Each row's best k (s, index) pairs over the neighbours [split * chunk,
// + chunk), sorted by (s, index), into part_s / part_i [splits, k, R].
template <int D, int K>
__global__ void __launch_bounds__(kThreads)
nnk_scan(const float* __restrict__ ref, const float* __restrict__ nbr,
         int R, int N, int k, int chunk, float* __restrict__ part_s,
         int* __restrict__ part_i) {
  constexpr int RT = nnk_rows(K);
  __shared__ float4 tw[kTile];
  __shared__ float tb[D == 4 ? kTile : 1];
  const int j_begin = blockIdx.y * chunk;
  const int j_end = min(N, j_begin + chunk);
  const int row0 = blockIdx.x * (kThreads * RT) + threadIdx.x;
  float a[RT][D], v[RT][K];
  int id[RT][K];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = row0 + r * kThreads;
#pragma unroll
    for (int c = 0; c < D; ++c)
      a[r][c] = row < R ? ref[static_cast<size_t>(row) * D + c] : 0.f;
#pragma unroll
    for (int e = 0; e < K; ++e) {
      v[r][e] = CUDART_INF_F;
      id[r][e] = 0;
    }
  }
  for (int t0 = j_begin; t0 < j_end; t0 += kTile) {
    const int n = min(kTile, j_end - t0);
    const int n_pad = (n + kBatch - 1) / kBatch * kBatch;
    __syncthreads();  // the previous tile has been read
    stage<D>(nbr, t0, n, n_pad, tw, tb);
    __syncthreads();
    for (int s0 = 0; s0 < n_pad; s0 += kBatch) {
      // the candidates of the batch: s under the row's threshold
      unsigned long long m[RT];
      float thr[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        m[r] = 0ull;
        thr[r] = v[r][K - 1];
      }
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {
        const float4 w = tw[s0 + s];
        const float bn = D == 4 ? tb[s0 + s] : w.w;
#pragma unroll
        for (int r = 0; r < RT; ++r)
          m[r] |= score<D>(a[r], w, bn) < thr[r] ? 1ull << s : 0ull;
      }
      // each candidate again, in ascending index, into the list
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        while (m[r]) {
          const int s = s0 + __ffsll(m[r]) - 1;
          m[r] &= m[r] - 1ull;
          const float4 w = tw[s];
          insert<K>(score<D>(a[r], w, D == 4 ? tb[s] : w.w), t0 + s, v[r],
                    id[r]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = row0 + r * kThreads;
    if (row < R) {
#pragma unroll
      for (int e = 0; e < K; ++e) {
        if (e < k) {
          const size_t o = (static_cast<size_t>(blockIdx.y) * k + e) * R + row;
          part_s[o] = v[r][e];
          part_i[o] = id[r][e];
        }
      }
    }
  }
}

// Each row's best k over the splits: the splits' lists inserted in split
// order, each in its (s, index) order, so that among equal s the lower
// index stays first; then d^2 = s + |a|^2 clamped at 0.
template <int D, int K>
__global__ void nnk_merge(const float* __restrict__ ref, int R, int k,
                          int splits, const float* __restrict__ part_s,
                          const int* __restrict__ part_i,
                          float* __restrict__ d2,
                          long long* __restrict__ idx) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  float v[K];
  int id[K];
#pragma unroll
  for (int e = 0; e < K; ++e) {
    v[e] = CUDART_INF_F;
    id[e] = 0;
  }
  for (int sp = 0; sp < splits; ++sp) {
    for (int e = 0; e < k; ++e) {
      const size_t o = (static_cast<size_t>(sp) * k + e) * R + row;
      const float s = part_s[o];
      if (!(s < v[K - 1])) break;  // the split's later entries are no less
      insert<K>(s, part_i[o], v, id);
    }
  }
  const float an = ref_sqnorm<D>(ref, row);
  const size_t out = static_cast<size_t>(row) * k;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    if (e < k) {
      d2[out + e] = fmaxf(__fadd_rn(v[e], an), 0.f);
      idx[out + e] = id[e];
    }
  }
}

template <int D, int K>
cudaError_t launch_nnk_k(const float* ref, const float* nbr, int R, int N,
                         int k, int splits, float* part_s, int* part_i,
                         float* d2, long long* idx, cudaStream_t stream) {
  constexpr int rows = kThreads * nnk_rows(K);
  const dim3 grid((R + rows - 1) / rows, splits);
  nnk_scan<D, K><<<grid, kThreads, 0, stream>>>(
      ref, nbr, R, N, k, split_chunk(N, splits), part_s, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  nnk_merge<D, K><<<(R + 255) / 256, 256, 0, stream>>>(
      ref, R, k, splits, part_s, part_i, d2, idx);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_nnk(const float* ref, const float* nbr, int R, int N,
                       int k, int splits, float* part_s, int* part_i,
                       float* d2, long long* idx, cudaStream_t stream) {
  switch (list_len(k)) {
    case 2: return launch_nnk_k<D, 2>(ref, nbr, R, N, k, splits, part_s,
                                      part_i, d2, idx, stream);
    case 4: return launch_nnk_k<D, 4>(ref, nbr, R, N, k, splits, part_s,
                                      part_i, d2, idx, stream);
    case 8: return launch_nnk_k<D, 8>(ref, nbr, R, N, k, splits, part_s,
                                      part_i, d2, idx, stream);
    default: return launch_nnk_k<D, kMaxK>(ref, nbr, R, N, k, splits, part_s,
                                           part_i, d2, idx, stream);
  }
}

}  // namespace

extern "C" {

// Splits of the neighbour range that nn1 uses for R rows and N
// neighbours on the current device: enough for ~16 blocks an SM, at least
// 2048 neighbours each.  ppt_nn1's scratch holds splits * R floats and
// splits * R ints.  Returns 0 on invalid sizes or a device query failure.
int ppt_nn1_splits(int R, int N) {
  return splits_for(R, N, kNn1Rows, kNn1BlocksPerSm);
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

// Splits of the neighbour range that nnk uses for R rows, N neighbours
// and k on the current device: enough for ~4 blocks an SM, at least 2048
// neighbours each.  ppt_nnk's scratch holds splits * k * R floats and as
// many ints.  Returns 0 on invalid sizes or a device query failure.
int ppt_nnk_splits(int R, int N, int k) {
  if (k < 1 || k > kMaxK) return 0;
  return splits_for(R, N, kThreads * nnk_rows(list_len(k)), kNnkBlocksPerSm);
}

// The k nearest of N neighbours (nbr [N, D]) of each of R reference rows
// (ref [R, D]), both float32 row-major: d2 [R, k] ascending by (d^2,
// index), clamped at 0, and idx [R, k] int64, on `stream`, through
// `splits` (ppt_nnk_splits) partial lists in part_s / part_i [splits, k,
// R].  Returns cudaGetLastError() (0 on success); invalid sizes (R >= 1,
// 1 <= k <= min(N, 16), 1 <= D <= 4, 1 <= splits <= N) return
// cudaErrorInvalidValue without launching.
int ppt_nnk(const float* ref, const float* nbr, int R, int N, int D, int k,
            int splits, float* part_s, int* part_i, float* d2,
            long long* idx, void* stream) {
  if (R <= 0 || N <= 0 || k < 1 || k > N || k > kMaxK || D < 1 ||
      D > kMaxDim || splits < 1 || splits > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1: return static_cast<int>(launch_nnk<1>(
        ref, nbr, R, N, k, splits, part_s, part_i, d2, idx, s));
    case 2: return static_cast<int>(launch_nnk<2>(
        ref, nbr, R, N, k, splits, part_s, part_i, d2, idx, s));
    case 3: return static_cast<int>(launch_nnk<3>(
        ref, nbr, R, N, k, splits, part_s, part_i, d2, idx, s));
    default: return static_cast<int>(launch_nnk<4>(
        ref, nbr, R, N, k, splits, part_s, part_i, d2, idx, s));
  }
}

const char* ppt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

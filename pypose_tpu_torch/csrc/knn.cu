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
// Both scans.  Neighbours are staged through shared memory as float4s of
// -2 b_c, four coordinates each, with |b|^2 in the last float4's free w
// slot (D = 1-3: (-2 b_0, -2 b_1, -2 b_2, |b|^2); D = 5-7: a second float4
// (-2 b_4, .., |b|^2)) or, when D is 4 or 8 and no slot is free, in an
// array of its own; each thread holds several reference rows in registers,
// so one broadcast LDS.128 (two past D = 4) feeds them all and a pair costs
// D FFMA, s = fma(a_{D-1}, -2 b_{D-1}, ... fma(a_0, -2 b_0, |b|^2)), and a
// compare.  Rows are ranked by s = |b|^2 - 2 a.b; |a|^2 is
// added after the scan, and d^2 clamped at 0, as pallas_knn.py:153 and
// :191 do.  The neighbour range is split over blockIdx.y so that enough
// blocks are in flight; a merge pass combines each row's results over the
// splits in split order.  d^2 rounds differently from the plain version
// (ops/knn.py:_gram_d2, every product and sum rounded alone), so on a
// near-tie the two may pick different neighbours: the card is held to the
// tolerance of pypose_tpu_torch/testing:nnk_tolerance_failures (for k = 1,
// nn1_tolerance_failures).  Both scans are instantiated for 1 <= D <= 8
// and for float32 and float64 clouds (T); a float64 neighbour is staged
// as double-precision 4-vectors (two LDS.128 each) in a tile of half the
// length, and a thread keeps half the rows, so that the rows' coordinates
// stay at 32 registers as they do in float32 (nn1: 8 rows a thread in
// float32 up to D = 4, 4 past it).
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
// What bounds them on an H100: instruction issue.  nn1 needs D FMA a pair;
// at D = 3:
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
constexpr int kSub = 32;        // neighbours a sub-tile
constexpr int kMinSplit = 2048; // neighbours a split, least
constexpr int kMaxDim = 8;      // ops/knn.py:MAX_DIM
constexpr int kMaxK = 16;       // ops/knn.py:MAX_K

// Neighbours staged a pass: 1024 in float32, 512 in float64 (36 KB of
// shared memory at D = 8 either way).
template <typename T>
__host__ __device__ constexpr int tile_len() { return 4096 / sizeof(T); }

// The scalar type's arithmetic, each operation rounded once.
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }
__device__ __forceinline__ float max_of(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_of(double a, double b) { return fmax(a, b); }
template <typename T> __device__ __forceinline__ T inf();
template <> __device__ __forceinline__ float inf<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double inf<double>() { return CUDART_INF; }

// Four coordinates of a staged neighbour: a float4, or its float64 peer.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
struct alignas(16) Double4 { double x, y, z, w; };
template <> struct Vec4<double> { using type = Double4; };
template <typename T> using vec4_t = typename Vec4<T>::type;

// Inserts (d, j) into the list (v, id) sorted by (d^2, index), behind
// every entry whose d^2 it does not beat (a strict <).
template <int K, typename T>
__device__ __forceinline__ void insert(T d, int j, T* v, int* id) {
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

// Where a staged neighbour keeps |b|^2: the free w slot of its last
// 4-vector, unless D fills it (D = 4, 8), then an array of its own.
template <int D>
__host__ __device__ constexpr bool own_bn() { return D % 4 == 0; }

// The shared-memory tile of tile_len<T>() staged neighbours: the
// 4-vectors of coordinates 0-3 and 4-7 (the second only past D = 4), and
// |b|^2 where own_bn<D>().
template <typename T, int D>
struct Tile {
  vec4_t<T> w0[tile_len<T>()];
  vec4_t<T> w1[D > 4 ? tile_len<T>() : 1];
  T bn[own_bn<D>() ? tile_len<T>() : 1];
};

// A staged neighbour as a scan reads it.
template <typename T>
struct Nbr {
  vec4_t<T> w0, w1;
  T bn;
};

template <typename T, int D>
__device__ __forceinline__ Nbr<T> load(const Tile<T, D>& tl, int t) {
  Nbr<T> b;
  b.w0 = tl.w0[t];
  b.w1 = D > 4 ? tl.w1[t] : b.w0;
  b.bn = own_bn<D>() ? tl.bn[t] : D > 4 ? b.w1.w : b.w0.w;
  return b;
}

// s = |b|^2 - 2 a.b from the staged (-2 b, |b|^2), FMA from the first
// coordinate; a scan and its second look at a neighbour call this one
// function, so both see the same bits.
template <typename T, int D>
__device__ __forceinline__ T score(const T* a, const Nbr<T>& b) {
  T s = fma_rn(a[0], b.w0.x, b.bn);
  if (D > 1) s = fma_rn(a[1], b.w0.y, s);
  if (D > 2) s = fma_rn(a[2], b.w0.z, s);
  if (D > 3) s = fma_rn(a[3], b.w0.w, s);
  if (D > 4) s = fma_rn(a[4], b.w1.x, s);
  if (D > 5) s = fma_rn(a[5], b.w1.y, s);
  if (D > 6) s = fma_rn(a[6], b.w1.z, s);
  if (D > 7) s = fma_rn(a[7], b.w1.w, s);
  return s;
}

// Stages neighbours [t0, t0 + n) into the tile, padded to n_pad with zero
// coordinates and |b|^2 = inf, so s = inf.
template <typename T, int D>
__device__ __forceinline__ void stage(const T* __restrict__ nbr, int t0,
                                      int n, int n_pad, Tile<T, D>& tl) {
  for (int t = threadIdx.x; t < n_pad; t += kThreads) {
    T b[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    T bn = inf<T>();
    if (t < n) {
#pragma unroll
      for (int c = 0; c < D; ++c)
        b[c] = nbr[static_cast<size_t>(t0 + t) * D + c];
      bn = b[0] * b[0];
#pragma unroll
      for (int c = 1; c < D; ++c) bn = fma_rn(b[c], b[c], bn);
    }
    T w[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) w[c] = T(-2) * b[c];
    if (!own_bn<D>()) w[D > 4 ? 7 : 3] = bn;
    tl.w0[t] = vec4_t<T>{w[0], w[1], w[2], w[3]};
    if (D > 4) tl.w1[t] = vec4_t<T>{w[4], w[5], w[6], w[7]};
    if (own_bn<D>()) tl.bn[t] = bn;
  }
}

// |a|^2 of reference row `row`, FMA from the first coordinate.
template <typename T, int D>
__device__ __forceinline__ T ref_sqnorm(const T* ref, int row) {
  const T* a = ref + static_cast<size_t>(row) * D;
  T an = a[0] * a[0];
#pragma unroll
  for (int c = 1; c < D; ++c) an = fma_rn(a[c], a[c], an);
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

// reference rows a thread: in float32 8, 4 past D = 4; half in float64
// (32 registers of coordinates either way)
template <typename T>
__host__ __device__ constexpr int nn1_rt(int D) {
  return (D > 4 ? 4 : 8) * 4 / static_cast<int>(sizeof(T));
}
constexpr int kNn1BlocksPerSm = 16;         // blocks in flight, aim

// Each row's least s over the neighbours [split * chunk, + chunk), and the
// first index that gives it, into part_s / part_i [splits, R].
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 4)
nn1_scan(const T* __restrict__ ref, const T* __restrict__ nbr, int R, int N,
         int chunk, T* __restrict__ part_s, int* __restrict__ part_i) {
  constexpr int kRT = nn1_rt<T>(D);
  __shared__ Tile<T, D> tl;
  const int j_begin = blockIdx.y * chunk;
  const int j_end = min(N, j_begin + chunk);
  const int row0 = blockIdx.x * (kThreads * kRT) + threadIdx.x;
  T a[kRT][D], best[kRT];
  int bidx[kRT];
#pragma unroll
  for (int r = 0; r < kRT; ++r) {
    const int row = row0 + r * kThreads;
#pragma unroll
    for (int c = 0; c < D; ++c)
      a[r][c] = row < R ? ref[static_cast<size_t>(row) * D + c] : T(0);
    best[r] = inf<T>();
    bidx[r] = 0;
  }
  for (int t0 = j_begin; t0 < j_end; t0 += tile_len<T>()) {
    const int n = min(tile_len<T>(), j_end - t0);
    const int n_pad = (n + kSub - 1) / kSub * kSub;
    __syncthreads();  // the previous tile has been read
    stage<T, D>(nbr, t0, n, n_pad, tl);
    __syncthreads();
    // the running min of each row, and the sub-tile of this tile where it
    // last fell (-1: not in this tile)
    int sub[kRT];
#pragma unroll
    for (int r = 0; r < kRT; ++r) sub[r] = -1;
    for (int s0 = 0; s0 < n_pad; s0 += kSub) {
      T m[kRT];
#pragma unroll
      for (int r = 0; r < kRT; ++r) m[r] = best[r];
#pragma unroll 8
      for (int s = 0; s < kSub; ++s) {
        const Nbr<T> b = load<T, D>(tl, s0 + s);
#pragma unroll
        for (int r = 0; r < kRT; ++r)
          m[r] = min_of(m[r], score<T, D>(a[r], b));
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
          if (score<T, D>(a[r], load<T, D>(tl, sub[r] + s)) == best[r]) break;
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
template <typename T, int D>
__global__ void nn1_merge(const T* __restrict__ ref, int R, int splits,
                          const T* __restrict__ part_s,
                          const int* __restrict__ part_i, T* __restrict__ d2,
                          long long* __restrict__ idx) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  T best = part_s[row];
  int bi = part_i[row];
  for (int sp = 1; sp < splits; ++sp) {
    const T v = part_s[static_cast<size_t>(sp) * R + row];
    if (v < best) {
      best = v;
      bi = part_i[static_cast<size_t>(sp) * R + row];
    }
  }
  d2[row] = max_of(add_rn(best, ref_sqnorm<T, D>(ref, row)), T(0));
  idx[row] = bi;
}

template <typename T, int D>
cudaError_t launch_nn1(const T* ref, const T* nbr, int R, int N, int splits,
                       T* part_s, int* part_i, T* d2, long long* idx,
                       cudaStream_t stream) {
  constexpr int rows = kThreads * nn1_rt<T>(D);
  const dim3 grid((R + rows - 1) / rows, splits);
  nn1_scan<T, D><<<grid, kThreads, 0, stream>>>(
      ref, nbr, R, N, split_chunk(N, splits), part_s, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  nn1_merge<T, D><<<(R + 255) / 256, 256, 0, stream>>>(ref, R, splits,
                                                       part_s, part_i, d2,
                                                       idx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t nn1_any(const void* ref, const void* nbr, int R, int N, int D,
                    int splits, void* part_s, int* part_i, void* d2,
                    long long* idx, cudaStream_t stream) {
  cudaError_t (*launch[kMaxDim])(const T*, const T*, int, int, int, T*, int*,
                                 T*, long long*, cudaStream_t) = {
      launch_nn1<T, 1>, launch_nn1<T, 2>, launch_nn1<T, 3>, launch_nn1<T, 4>,
      launch_nn1<T, 5>, launch_nn1<T, 6>, launch_nn1<T, 7>, launch_nn1<T, 8>};
  return launch[D - 1](static_cast<const T*>(ref), static_cast<const T*>(nbr),
                       R, N, splits, static_cast<T*>(part_s), part_i,
                       static_cast<T*>(d2), idx, stream);
}

// ---- nnk ------------------------------------------------------------------

// blocks in flight, aim: fewer splits than nn1's, since each split fills
// its lists from scratch
constexpr int kNnkBlocksPerSm = 4;
constexpr int kBatch = 64;  // neighbours a candidate mask covers

// The list length for k (the least of 2, 4, 8, 16 that holds it), and the
// reference rows a thread keeps in registers with lists of K (in float64
// half as many).
int list_len(int k) { return k <= 2 ? 2 : k <= 4 ? 4 : k <= 8 ? 8 : 16; }
template <typename T>
__host__ __device__ constexpr int nnk_rows(int K) {
  return (K >= 16 ? 2 : 4) * 4 / static_cast<int>(sizeof(T));
}

// Each row's best k (s, index) pairs over the neighbours [split * chunk,
// + chunk), sorted by (s, index), into part_s / part_i [splits, k, R].
template <typename T, int D, int K>
__global__ void __launch_bounds__(kThreads)
nnk_scan(const T* __restrict__ ref, const T* __restrict__ nbr, int R, int N,
         int k, int chunk, T* __restrict__ part_s, int* __restrict__ part_i) {
  constexpr int RT = nnk_rows<T>(K);
  __shared__ Tile<T, D> tl;
  const int j_begin = blockIdx.y * chunk;
  const int j_end = min(N, j_begin + chunk);
  const int row0 = blockIdx.x * (kThreads * RT) + threadIdx.x;
  T a[RT][D], v[RT][K];
  int id[RT][K];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = row0 + r * kThreads;
#pragma unroll
    for (int c = 0; c < D; ++c)
      a[r][c] = row < R ? ref[static_cast<size_t>(row) * D + c] : T(0);
#pragma unroll
    for (int e = 0; e < K; ++e) {
      v[r][e] = inf<T>();
      id[r][e] = 0;
    }
  }
  for (int t0 = j_begin; t0 < j_end; t0 += tile_len<T>()) {
    const int n = min(tile_len<T>(), j_end - t0);
    const int n_pad = (n + kBatch - 1) / kBatch * kBatch;
    __syncthreads();  // the previous tile has been read
    stage<T, D>(nbr, t0, n, n_pad, tl);
    __syncthreads();
    for (int s0 = 0; s0 < n_pad; s0 += kBatch) {
      // the candidates of the batch: s under the row's threshold
      unsigned long long m[RT];
      T thr[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        m[r] = 0ull;
        thr[r] = v[r][K - 1];
      }
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {
        const Nbr<T> b = load<T, D>(tl, s0 + s);
#pragma unroll
        for (int r = 0; r < RT; ++r)
          m[r] |= score<T, D>(a[r], b) < thr[r] ? 1ull << s : 0ull;
      }
      // each candidate again, in ascending index, into the list
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        while (m[r]) {
          const int s = s0 + __ffsll(m[r]) - 1;
          m[r] &= m[r] - 1ull;
          insert<K>(score<T, D>(a[r], load<T, D>(tl, s)), t0 + s, v[r],
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
template <typename T, int D, int K>
__global__ void nnk_merge(const T* __restrict__ ref, int R, int k, int splits,
                          const T* __restrict__ part_s,
                          const int* __restrict__ part_i, T* __restrict__ d2,
                          long long* __restrict__ idx) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= R) return;
  T v[K];
  int id[K];
#pragma unroll
  for (int e = 0; e < K; ++e) {
    v[e] = inf<T>();
    id[e] = 0;
  }
  for (int sp = 0; sp < splits; ++sp) {
    for (int e = 0; e < k; ++e) {
      const size_t o = (static_cast<size_t>(sp) * k + e) * R + row;
      const T s = part_s[o];
      if (!(s < v[K - 1])) break;  // the split's later entries are no less
      insert<K>(s, part_i[o], v, id);
    }
  }
  const T an = ref_sqnorm<T, D>(ref, row);
  const size_t out = static_cast<size_t>(row) * k;
#pragma unroll
  for (int e = 0; e < K; ++e) {
    if (e < k) {
      d2[out + e] = max_of(add_rn(v[e], an), T(0));
      idx[out + e] = id[e];
    }
  }
}

template <typename T, int D, int K>
cudaError_t launch_nnk_k(const T* ref, const T* nbr, int R, int N, int k,
                         int splits, T* part_s, int* part_i, T* d2,
                         long long* idx, cudaStream_t stream) {
  constexpr int rows = kThreads * nnk_rows<T>(K);
  const dim3 grid((R + rows - 1) / rows, splits);
  nnk_scan<T, D, K><<<grid, kThreads, 0, stream>>>(
      ref, nbr, R, N, k, split_chunk(N, splits), part_s, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  nnk_merge<T, D, K><<<(R + 255) / 256, 256, 0, stream>>>(
      ref, R, k, splits, part_s, part_i, d2, idx);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_nnk(const T* ref, const T* nbr, int R, int N, int k,
                       int splits, T* part_s, int* part_i, T* d2,
                       long long* idx, cudaStream_t stream) {
  switch (list_len(k)) {
    case 2: return launch_nnk_k<T, D, 2>(ref, nbr, R, N, k, splits, part_s,
                                         part_i, d2, idx, stream);
    case 4: return launch_nnk_k<T, D, 4>(ref, nbr, R, N, k, splits, part_s,
                                         part_i, d2, idx, stream);
    case 8: return launch_nnk_k<T, D, 8>(ref, nbr, R, N, k, splits, part_s,
                                         part_i, d2, idx, stream);
    default: return launch_nnk_k<T, D, kMaxK>(ref, nbr, R, N, k, splits,
                                              part_s, part_i, d2, idx,
                                              stream);
  }
}

template <typename T>
cudaError_t nnk_any(const void* ref, const void* nbr, int R, int N, int D,
                    int k, int splits, void* part_s, int* part_i, void* d2,
                    long long* idx, cudaStream_t stream) {
  cudaError_t (*launch[kMaxDim])(const T*, const T*, int, int, int, int, T*,
                                 int*, T*, long long*, cudaStream_t) = {
      launch_nnk<T, 1>, launch_nnk<T, 2>, launch_nnk<T, 3>, launch_nnk<T, 4>,
      launch_nnk<T, 5>, launch_nnk<T, 6>, launch_nnk<T, 7>, launch_nnk<T, 8>};
  return launch[D - 1](static_cast<const T*>(ref), static_cast<const T*>(nbr),
                       R, N, k, splits, static_cast<T*>(part_s), part_i,
                       static_cast<T*>(d2), idx, stream);
}

}  // namespace

extern "C" {

// Splits of the neighbour range that nn1 uses for R rows of D coordinates
// (float64 if f64, else float32) and N neighbours on the current device:
// enough for ~16 blocks an SM, at least 2048 neighbours each.  ppt_nn1's
// scratch holds splits * R values of the clouds' type and splits * R
// ints.  Returns 0 on invalid sizes or a device query failure.
int ppt_nn1_splits(int R, int N, int D, int f64) {
  if (D < 1 || D > kMaxDim) return 0;
  const int rt = f64 ? nn1_rt<double>(D) : nn1_rt<float>(D);
  return splits_for(R, N, kThreads * rt, kNn1BlocksPerSm);
}

// The nearest of N neighbours (nbr [N, D]) of each of R reference rows
// (ref [R, D]), both row-major float64 if f64, else float32: d2 [R] of
// the same type, clamped at 0, and idx [R] int64, on `stream`, through
// `splits` (ppt_nn1_splits) partial results in part_s [splits, R] (the
// clouds' type) / part_i [splits, R].  Returns cudaGetLastError() (0 on
// success); invalid sizes (R, N, splits >= 1, 1 <= D <= 8) return
// cudaErrorInvalidValue without launching.
int ppt_nn1(const void* ref, const void* nbr, int R, int N, int D, int f64,
            int splits, void* part_s, int* part_i, void* d2, long long* idx,
            void* stream) {
  if (R <= 0 || N <= 0 || splits < 1 || splits > N || D < 1 ||
      D > kMaxDim)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f64 ? nn1_any<double>(ref, nbr, R, N, D, splits, part_s, part_i, d2,
                            idx, s)
          : nn1_any<float>(ref, nbr, R, N, D, splits, part_s, part_i, d2, idx,
                           s));
}

// Splits of the neighbour range that nnk uses for R rows, N neighbours
// and k (float64 if f64, else float32) on the current device: enough for
// ~4 blocks an SM, at least 2048 neighbours each.  ppt_nnk's scratch
// holds splits * k * R values of the clouds' type and as many ints.
// Returns 0 on invalid sizes or a device query failure.
int ppt_nnk_splits(int R, int N, int k, int f64) {
  if (k < 1 || k > kMaxK) return 0;
  const int K = list_len(k);
  const int rt = f64 ? nnk_rows<double>(K) : nnk_rows<float>(K);
  return splits_for(R, N, kThreads * rt, kNnkBlocksPerSm);
}

// The k nearest of N neighbours (nbr [N, D]) of each of R reference rows
// (ref [R, D]), both row-major float64 if f64, else float32: d2 [R, k] of
// the same type, ascending by (d^2, index), clamped at 0, and idx [R, k]
// int64, on `stream`, through `splits` (ppt_nnk_splits) partial lists in
// part_s / part_i [splits, k, R].  Returns cudaGetLastError() (0 on
// success); invalid sizes (R >= 1, 1 <= k <= min(N, 16), 1 <= D <= 8,
// 1 <= splits <= N) return cudaErrorInvalidValue without launching.
int ppt_nnk(const void* ref, const void* nbr, int R, int N, int D, int k,
            int f64, int splits, void* part_s, int* part_i, void* d2,
            long long* idx, void* stream) {
  if (R <= 0 || N <= 0 || k < 1 || k > N || k > kMaxK || D < 1 ||
      D > kMaxDim || splits < 1 || splits > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f64 ? nnk_any<double>(ref, nbr, R, N, D, k, splits, part_s, part_i, d2,
                            idx, s)
          : nnk_any<float>(ref, nbr, R, N, D, k, splits, part_s, part_i, d2,
                           idx, s));
}

const char* ppt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

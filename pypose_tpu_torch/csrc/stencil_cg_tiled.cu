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
// What bounds it on an H100: device-memory bandwidth.  At the 100k-pose
// graph (t = 6, offsets (1, 993)) the operands are ~72 MB, more than the
// 50 MB L2, so every iteration streams them from HBM: the matvec reads A
// (36 floats a node), both channels (72) and p, and writes q (~48 MB); the
// apply reads Minv (36) and r and writes z (~19 MB).  The gather form
// reads channel k a second time at n - d_k, a few hundred nodes from where
// another block streams it at the same time, so the L2 serves that read
// and HBM sees each channel about once.
//
// Two designs, each where it was measured faster (H100 80GB HBM3, 700 W,
// 100k shape, L2 flushed; probes/stencil_probes.py --old):
//
// - One thread a node (tiled_mv_kernel, tiled_pc_kernel), 256 threads a
//   block, the grid over all nodes: the templates (t = 3, 4, 6, 7) of both
//   kernels, and at every t the apply.  The runtime-t kernels below
//   kRingMinT (tiled_mv_any_t, tiled_pc_any_t) take one thread a (block
//   row, node) with one accumulator, so no t-float array sits in
//   registers.  Neighbouring threads read neighbouring addresses of every
//   [*, N] row.
// - The ring (tiled_mv_ring): the runtime-t matvec from kRingMinT on.  A
//   thread a (row, node) reads p at n, n + d_k and n - d_k once a row, t
//   times a node in all; the ring stages each p window once in shared
//   memory for up to kMaxGroup rows.  Persistent CTAs (one an SM) each
//   take a balanced share of the nodes and walk it in tiles of at most
//   kTileNodes (512) nodes, two a consumer thread.  Per tile the operator
//   is a sequence of parts, each a t x t block product: A with p at the
//   tile, then for each offset C_k with p at n + d_k (forward) and C_k^T
//   at n - d_k with p there (back).  A stage of a ring in shared memory
//   holds one part's vector window (us rows) and its operand rows for g
//   block rows i and us columns u, each row a window of the tile's nodes
//   (up to 2 KB, one bulk copy, two where it wraps at N), filled by up to
//   kProducerWarps producer warps in turn by cp.async.bulk behind
//   mbarriers (full: the copies' bytes and the lanes' plain loads landed;
//   empty: the consumer warps are done) while the consumers work on
//   earlier stages.  It takes as many columns a stage as let four stages
//   fit (their column sums carry across stages in registers).  The
//   bulk-copy engine fills an SM's shared memory at ~23 GB/s from device
//   memory (probes/bulk_rate.cu), a producer warp spends ~1,000 cycles a
//   stage whatever its bytes, and the ring's copies are ~1.7x the
//   matvec's device-memory bytes (the back windows and the vector windows
//   come again from L2): that holds it near half of its byte bound, and
//   below the one-thread-a-node kernels at the templates' t, below
//   kRingMinT and for the apply, where p's re-reads cost less.
//
// Every kernel takes each sum in stencil_row's order: acc over u
// ascending, added to y[i] after the A block, then each offset's forward
// and back blocks in turn (block_mul_add's for the apply); so all give the
// same bits at every t.
//
// The ring's alignment: a bulk copy moves 16-byte-aligned multiples of 16
// bytes, and a window of a [rows, N] row starts anywhere (n0 - d_k, any
// N % 4).  So each window is copied as its 16-byte-aligned superset, and a
// row's slot in shared memory sits at the same residue mod 16 bytes as the
// row in device memory (row pitch = N mod 4 floats, block pitches = t N
// mod 4): a node's position is then the same in every row of a window,
// and a consumer finds its nodes once a stage.  A window that wraps at N
// is two copies; the floats outside a tensor's aligned interior (its first
// and last few, where its base or end is not 16-byte aligned) are loaded
// by the producer's lanes one by one.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see pypose_tpu_torch/ops/_build.py)

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "bulk_copy.cuh"
#include "stencil_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// One thread a node (templates) or a (block row, node) (runtime t)
// ---------------------------------------------------------------------------

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

// The runtime-t kernels: thread j = i * N + n computes row i of node n.
__global__ void __launch_bounds__(kThreads)
tiled_mv_any_t(const float* __restrict__ A, const float* __restrict__ C,
               ppt::Offsets offs, int n_off, int N, int t,
               const float* __restrict__ p, float* __restrict__ q) {
  const size_t NN = static_cast<size_t>(N);
  const size_t j = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= t * NN) return;
  const int i = static_cast<int>(j / NN);
  const int n = static_cast<int>(j - i * NN);
  const size_t tt = static_cast<size_t>(t) * t;
  float acc = 0.f;
  for (int u = 0; u < t; ++u) acc += A[(i * t + u) * NN + n] * p[u * NN + n];
  float y = 0.f;
  y += acc;
  for (int k = 0; k < n_off; ++k) {
    const int d = offs.d[k];
    const float* Ck = C + k * tt * NN;
    int nf = n + d;
    if (nf >= N) nf -= N;
    int nb = n - d;
    if (nb < 0) nb += N;
    acc = 0.f;
    for (int u = 0; u < t; ++u)
      acc += Ck[(i * t + u) * NN + n] * p[u * NN + nf];
    y += acc;
    acc = 0.f;
    for (int u = 0; u < t; ++u)
      acc += Ck[(u * t + i) * NN + nb] * p[u * NN + nb];
    y += acc;
  }
  q[j] = y;
}

__global__ void __launch_bounds__(kThreads)
tiled_pc_any_t(const float* __restrict__ Minv, int N, int t,
               const float* __restrict__ r, float* __restrict__ z) {
  const size_t NN = static_cast<size_t>(N);
  const size_t j = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= t * NN) return;
  const int i = static_cast<int>(j / NN);
  const int n = static_cast<int>(j - i * NN);
  float acc = 0.f;
  for (int u = 0; u < t; ++u)
    acc += Minv[(i * t + u) * NN + n] * r[u * NN + n];
  float zi = 0.f;
  zi += acc;
  z[j] = zi;
}

int blocks_for(size_t rows) {
  return static_cast<int>((rows + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// The ring: the runtime-t matvec from kRingMinT
// ---------------------------------------------------------------------------

using ppt::bulk_load;
using ppt::fence_proxy_async;
using ppt::mbar_arrive;
using ppt::mbar_expect_tx;
using ppt::mbar_init;
using ppt::mbar_wait;

// The runtime-t matvec takes the ring from this t (below it, and at the
// templates' t unless forced, the one-thread-a-(row, node) kernel wins).
constexpr int kRingMinT = 5;

// The plan's constants; ops/stencil_cg.py:tiled_plan mirrors them.
constexpr int kConsumerWarps = 8;
constexpr int kStride = 32 * kConsumerWarps;  // a consumer's nodes: j + 256 q
constexpr int kNodesPerThread = 2;
constexpr int kTileNodes = kStride * kNodesPerThread;  // at most
constexpr int kProducerWarps = 4;  // stages in turn (at most one a stage)
constexpr int kRingThreads = 32 * (kConsumerWarps + kProducerWarps);
constexpr int kMinCtaNodes = 128;  // fewer CTAs than that for small N
constexpr int kMargin = 18;      // a row slot: the tile, alignment, a wrap
constexpr int kMaxGroup = 8;     // block rows a stage, at most
constexpr int kMaxStages = 16;
constexpr int kMinStages = 4;    // a stage at most a quarter of the ring
constexpr int kRowsPerLane = 3;  // a stage's rows, at most 32 times this
constexpr int kBarBytes = 256;   // full and empty mbarriers, at the head
constexpr int kCtaBytes = 232448;  // one CTA an SM, the opt-in limit

// How a launch lays out its stages (see tiled_plan):
struct Plan {
  int g;             // block rows i a stage
  int us;            // columns u a stage
  int stages;        // of the ring
  int pitch;         // floats from a row slot to the next, = N (mod 4)
  int gpf;           // forward operands: floats a block row, = t N (mod 4)
  int gpb;           // back operands: floats a column, = t N (mod 4)
  int vec_floats;    // a stage's vector window
  int stage_floats;  // a stage: vector window, then operand rows
  int smem;          // dynamic shared memory, bytes
};

int mod4(long long x) { return static_cast<int>(x & 3); }
int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

Plan make_plan(int N, int t) {
  Plan p{};
  p.pitch = kTileNodes + kMargin + mod4(N - kTileNodes - kMargin);
  const int tn = mod4(static_cast<long long>(t) * N);
  p.g = ceil_div(t, ceil_div(t, kMaxGroup));
  for (int slabs = 1;; ++slabs) {
    p.us = ceil_div(t, slabs);
    p.gpf = p.us * p.pitch + mod4(tn - p.us * p.pitch);
    p.gpb = p.g * p.pitch + mod4(tn - p.g * p.pitch);
    p.vec_floats = round4(p.us * p.pitch);
    p.stage_floats =
        p.vec_floats + round4(std::max(p.g * p.gpf, p.us * p.gpb));
    if (p.us == 1 ||
        (kBarBytes + kMinStages * 4 * p.stage_floats <= kCtaBytes &&
         p.us * (1 + p.g) <= 32 * kRowsPerLane))
      break;
  }
  p.stages = std::min(kMaxStages,
                      (kCtaBytes - kBarBytes) / (4 * p.stage_floats));
  p.smem = kBarBytes + 4 * p.stages * p.stage_floats;
  return p;
}

struct Args {
  const float* A;    // [t*t, N]
  const float* C;    // channels [n_off*t*t, N]
  const float* p;    // [t, N]
  float* q;          // [t, N]
  ppt::Offsets offs;
  int n_off, N, t;
  Plan plan;
};

__device__ __forceinline__ uintptr_t umax(uintptr_t a, uintptr_t b) {
  return a > b ? a : b;
}
__device__ __forceinline__ uintptr_t umin(uintptr_t a, uintptr_t b) {
  return a < b ? a : b;
}

// A window of `len` nodes from node s (mod N) of the rows of tensor M
// that a stage holds: the first len1 nodes from s, the rest from node 0.
// In each row's slot node s sits at c1, node 0 (past the wrap) at c2,
// both at the residue mod 4 of their float in device memory.
struct Window {
  const float* M;
  uintptr_t i0, i1;  // the tensor's 16-byte-aligned interior
  int s, len1, c1, c2;
};

__device__ __forceinline__ Window make_window(const float* M, size_t total,
                                              long long row0, int s, int len,
                                              int N) {
  Window w;
  w.M = M;
  w.i0 = (reinterpret_cast<uintptr_t>(M) + 15) & ~uintptr_t{15};
  w.i1 = reinterpret_cast<uintptr_t>(M + total) & ~uintptr_t{15};
  w.s = s;
  w.len1 = min(len, N - s);
  // residue mod 4 of the float (row0, s) in device memory
  const int g0 = static_cast<int>(
      ((reinterpret_cast<uintptr_t>(M) >> 2) +
       static_cast<uintptr_t>(row0 & 3) * (N & 3) + (s & 3)) & 3);
  w.c1 = 3 + ((g0 + 1) & 3);
  const int e = w.c1 + w.len1 + 6;
  w.c2 = e + ((g0 - s - e) & 3);
  return w;
}

__device__ __forceinline__ int window_pos(const Window& w, int j) {
  return j < w.len1 ? w.c1 + j : w.c2 + (j - w.len1);
}

// A bulk copy: `bytes` from `src` to the shared address `dst`, both
// 16-byte aligned (bytes 0: none).
struct Piece {
  uintptr_t src;
  char* dst;
  uint32_t bytes;
};

// `count` floats from `src` to `dst` (dst at src's residue mod 16 bytes):
// their 16-byte-aligned superset within the tensor's aligned interior.
__device__ __forceinline__ Piece make_piece(float* dst, const float* src,
                                            int count, const Window& w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = a + 4 * static_cast<uintptr_t>(count);
  const uintptr_t lo = umax(a & ~uintptr_t{15}, w.i0);
  const uintptr_t hi = umin((e + 15) & ~uintptr_t{15}, w.i1);
  Piece p;
  p.src = lo;
  p.dst = reinterpret_cast<char*>(dst) +
          (static_cast<intptr_t>(lo) - static_cast<intptr_t>(a));
  p.bytes = hi > lo ? static_cast<uint32_t>(hi - lo) : 0;
  return p;
}

// The floats of those `count` outside the aligned interior (where the
// tensor's base or end is not 16-byte aligned), stored one by one;
// returns whether there were any.
__device__ __forceinline__ bool copy_tails(float* dst, const float* src,
                                           int count, const Window& w) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = a + 4 * static_cast<uintptr_t>(count);
  if (a >= w.i0 && e <= w.i1) return false;
  const uintptr_t head = umin(e, w.i0);
  const uintptr_t tail = umax(umax(a, w.i1), head);
  for (uintptr_t x = a; x < head; x += 4)
    dst[(x - a) / 4] = *reinterpret_cast<const float*>(x);
  for (uintptr_t x = tail; x < e; x += 4)
    dst[(x - a) / 4] = *reinterpret_cast<const float*>(x);
  return true;
}

// One stage: part `part` of the tile (n0, len), block rows [i0, i0 + g),
// columns [u0, u0 + us).  Operand row (ii, u) is tensor row row0 + ii*rsi
// + u*rsu, at slot ii*si + u*su of the operand region; vector row u at
// slot u*pitch of the vector region.
struct Stage {
  Window vw, ow;
  long long row0;
  int rsi, rsu, si, su;
};

__device__ __forceinline__ Stage make_stage(const Args& a, int n0, int len,
                                            int i0, int part, int u0) {
  const int N = a.N, t = a.t;
  const Plan& p = a.plan;
  const float* M = a.A;
  size_t total = static_cast<size_t>(t) * t * N;
  long long rbase = 0;
  int sv = n0, so = n0;
  bool back = false;
  if (part > 0) {
    const int k = (part - 1) >> 1;
    const int d = a.offs.d[k];
    back = ((part - 1) & 1) != 0;
    M = a.C;
    total *= a.n_off;
    rbase = static_cast<long long>(k) * t * t;
    if (back) {
      sv = n0 - d;
      if (sv < 0) sv += N;
      so = sv;
    } else {
      sv = n0 + d;
      if (sv >= N) sv -= N;
    }
  }
  Stage s;
  s.vw = make_window(a.p, static_cast<size_t>(t) * N, u0, sv, len, N);
  s.row0 = rbase + (back ? static_cast<long long>(u0) * t + i0
                         : static_cast<long long>(i0) * t + u0);
  s.ow = make_window(M, total, s.row0, so, len, N);
  s.rsi = back ? 1 : t;
  s.rsu = back ? t : 1;
  s.si = back ? p.pitch : p.gpf;
  s.su = back ? p.gpb : p.pitch;
  return s;
}

// The bulk copies of row r of a stage (vector rows first, then operand
// rows (ii, u)), one a piece of its window (two where it wraps), into
// `pc`; the floats outside the tensor's aligned interior are stored
// here.  Returns whether there were any.
__device__ __forceinline__ bool stage_row(const Stage& s, const Plan& p,
                                          float* stage, int r, int uu, int u0,
                                          int len, int N, Piece* pc) {
  const bool vec = r < uu;
  const Window w = vec ? s.vw : s.ow;
  float* slot;
  long long row;
  if (vec) {
    slot = stage + r * p.pitch;
    row = u0 + r;
  } else {
    const int ii = (r - uu) / uu;
    const int u = r - uu - ii * uu;
    slot = stage + p.vec_floats + ii * s.si + u * s.su;
    row = s.row0 + static_cast<long long>(ii) * s.rsi +
          static_cast<long long>(u) * s.rsu;
  }
  const float* src = w.M + row * N;
  pc[0] = make_piece(slot + w.c1, src + w.s, w.len1, w);
  bool tails = copy_tails(slot + w.c1, src + w.s, w.len1, w);
  pc[1].bytes = 0;
  if (w.len1 < len) {
    pc[1] = make_piece(slot + w.c2, src, len - w.len1, w);
    tails |= copy_tails(slot + w.c2, src, len - w.len1, w);
  }
  return tails;
}

__global__ void __launch_bounds__(kRingThreads, 1)
tiled_mv_ring(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  const Plan& p = a.plan;
  const int t = a.t, g = p.g, us = p.us;
  const int N = a.N;
  const size_t NN = static_cast<size_t>(N);
  const int S = p.stages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this CTA's nodes, [nb, ne), in tiles of at most kTileNodes, balanced
  const int nb = static_cast<int>(static_cast<long long>(N) * blockIdx.x /
                                  gridDim.x);
  const int ne = static_cast<int>(static_cast<long long>(N) *
                                  (blockIdx.x + 1) / gridDim.x);
  const int tiles = ceil_div(ne - nb, kTileNodes);
  const int tile_nodes = tiles ? ceil_div(ne - nb, tiles) : 0;
  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) {
      mbar_init(&full[st], 33);  // lane 0's expect_tx, then all 32 lanes
      mbar_init(&empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // producer warp w fills stages it = w (mod P); P <= S keeps each ring
  // slot's empty phases in order (the warp's own previous wait on it
  // covered the phase before)
  const int P = min(kProducerWarps, S);
  const int pw = warp - kConsumerWarps;
  const bool producer = pw >= 0;
  if (producer && pw >= P) return;
  const int j = threadIdx.x;
  const int parts = 1 + 2 * a.n_off;
  float y[kNodesPerThread][kMaxGroup], acc[kNodesPerThread][kMaxGroup];
  int it = 0;
  for (int tile = 0; tile < tiles; ++tile) {
    const int n0 = nb + tile * tile_nodes;
    const int len = min(tile_nodes, ne - n0);
    for (int i0 = 0; i0 < t; i0 += g) {
      const int gg = min(g, t - i0);
      for (int part = 0; part < parts; ++part) {
        for (int u0 = 0; u0 < t; u0 += us, ++it) {
          const int uu = min(us, t - u0);
          const int st = it % S;
          float* stage = ring + static_cast<size_t>(st) * p.stage_floats;
          if (producer && it % P != pw) continue;
          const Stage s = make_stage(a, n0, len, i0, part, u0);
          if (producer) {
            if (it >= S) mbar_wait(&empty[st], ((it / S) + 1) & 1);
            // each lane's rows (at most kRowsPerLane): the pieces and the
            // plain loads first, its arrival after its plain stores, then
            // the bulk copies (the phase waits for their bytes)
            const int rows = uu + gg * uu;
            Piece pc[2 * kRowsPerLane];
            bool tails = false;
#pragma unroll
            for (int k = 0; k < kRowsPerLane; ++k) {
              const int r = lane + 32 * k;
              pc[2 * k].bytes = pc[2 * k + 1].bytes = 0;
              if (r < rows)
                tails |= stage_row(s, p, stage, r, uu, u0, len, N,
                                   &pc[2 * k]);
            }
            // the plain stores before a later bulk copy into their slots
            if (tails) fence_proxy_async();
            uint32_t bytes = 0;
#pragma unroll
            for (int k = 0; k < 2 * kRowsPerLane; ++k) bytes += pc[k].bytes;
            bytes = __reduce_add_sync(0xffffffffu, bytes);
            if (lane == 0) mbar_expect_tx(&full[st], bytes);
            mbar_arrive(&full[st]);
            __syncwarp();
#pragma unroll
            for (int k = 0; k < 2 * kRowsPerLane; ++k)
              if (pc[k].bytes)
                bulk_load(pc[k].dst, reinterpret_cast<const void*>(pc[k].src),
                          pc[k].bytes, &full[st]);
            continue;
          }
          // a node past a ragged tile reads node 0's slots, stores nothing
          const float* vr[kNodesPerThread];
          const float* orow[kNodesPerThread];
#pragma unroll
          for (int q = 0; q < kNodesPerThread; ++q) {
            const int jq = j + kStride * q < len ? j + kStride * q : 0;
            vr[q] = stage + window_pos(s.vw, jq);
            orow[q] = stage + p.vec_floats + window_pos(s.ow, jq);
          }
          mbar_wait(&full[st], (it / S) & 1);
          if (u0 == 0) {
#pragma unroll
            for (int q = 0; q < kNodesPerThread; ++q)
#pragma unroll
              for (int ii = 0; ii < kMaxGroup; ++ii) acc[q][ii] = 0.f;
          }
#pragma unroll 4
          for (int u = 0; u < uu; ++u) {
#pragma unroll
            for (int q = 0; q < kNodesPerThread; ++q) {
              const float x = vr[q][u * p.pitch];
#pragma unroll
              for (int ii = 0; ii < kMaxGroup; ++ii)
                if (ii < gg) acc[q][ii] += orow[q][ii * s.si + u * s.su] * x;
            }
          }
          // every read of the stage before the next bulk copy into it
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[st]);
          if (u0 + uu < t) continue;
#pragma unroll
          for (int q = 0; q < kNodesPerThread; ++q)
#pragma unroll
            for (int ii = 0; ii < kMaxGroup; ++ii) {
              if (part == 0) y[q][ii] = 0.f;
              y[q][ii] += acc[q][ii];
            }
          if (part < parts - 1) continue;
#pragma unroll
          for (int q = 0; q < kNodesPerThread; ++q)
#pragma unroll
            for (int ii = 0; ii < kMaxGroup; ++ii)
              if (ii < gg && j + kStride * q < len)
                a.q[static_cast<size_t>(i0 + ii) * NN + n0 + j +
                    kStride * q] = y[q][ii];
        }
      }
    }
  }
}

// The ring's grid at N nodes: one CTA an SM, at most one a kMinCtaNodes
// nodes.  Its shared-memory limit is raised, and the SM count read, once
// a device.
cudaError_t ring_grid(int N, int* grid) {
  constexpr int kDevices = 64;
  static int sms[kDevices];  // 0: not set up yet
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    int count = 0;
    e = cudaFuncSetAttribute(tiled_mv_ring,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kCtaBytes);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 dev);
    if (e != cudaSuccess) return e;
    sms[dev] = count;
  }
  *grid = std::min(ceil_div(N, kMinCtaNodes), sms[dev]);
  return cudaSuccess;
}

cudaError_t launch_ring(const float* A, const float* C,
                        const ppt::Offsets& offs, int n_off, int N, int t,
                        const float* p, float* q, cudaStream_t s) {
  Args a{};
  a.A = A;
  a.C = C;
  a.p = p;
  a.q = q;
  a.offs = offs;
  a.n_off = n_off;
  a.N = N;
  a.t = t;
  a.plan = make_plan(N, t);
  int grid = 0;
  const cudaError_t e = ring_grid(N, &grid);
  if (e != cudaSuccess) return e;
  tiled_mv_ring<<<grid, kRingThreads, a.plan.smem, s>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Dispatch
// ---------------------------------------------------------------------------

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

// Which matvec: the templates at their t, else the runtime-t kernels
// (kRouted); the runtime-t kernels at every t (kAnyT); the ring (kRing).
enum class Mv { kRouted, kAnyT, kRing };

int tiled_mv(int t, Mv which, const float* A, const float* C,
             const int* offsets, int n_off, int N, const float* p, float* q,
             void* stream) {
  ppt::Offsets offs;
  if (t < 1 || !ppt::make_offsets(offsets, n_off, &offs) || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which == Mv::kRouted ? t : 0) {
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
      if (which == Mv::kRing || t >= kRingMinT)
        return static_cast<int>(
            launch_ring(A, C, offs, n_off, N, t, p, q, s));
      tiled_mv_any_t<<<blocks_for(static_cast<size_t>(t) * N), kThreads, 0,
                       s>>>(A, C, offs, n_off, N, t, p, q);
  }
  return static_cast<int>(cudaGetLastError());
}

int tiled_pc(int t, bool any_t, const float* Minv, int N, const float* r,
             float* z, void* stream) {
  if (t < 1 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (any_t ? 0 : t) {
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
      tiled_pc_any_t<<<blocks_for(static_cast<size_t>(t) * N), kThreads, 0,
                       s>>>(Minv, N, t, r, z);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q = A p on `stream`; returns a CUDA error code (0 on success).
// `offsets` is a host array of n_off circular offsets in [0, N).  Any
// t >= 1: t = 3, 4, 6 and 7 take their templates, every other t the
// runtime-t matvec (the ring from t = kRingMinT); t < 1 or more than 16
// offsets return cudaErrorInvalidValue.
int ppt_tiled_mv(int t, const float* A, const float* C, const int* offsets,
                 int n_off, int N, const float* p, float* q, void* stream) {
  return tiled_mv(t, Mv::kRouted, A, C, offsets, n_off, N, p, q, stream);
}

// z = Minv r on `stream`; returns a CUDA error code.  t as ppt_tiled_mv
// (the apply has no ring).
int ppt_tiled_pc(int t, const float* Minv, int N, const float* r, float* z,
                 void* stream) {
  return tiled_pc(t, false, Minv, N, r, z, stream);
}

// ppt_tiled_mv and ppt_tiled_pc through the runtime-t kernels at every t,
// the templates' t included (to hold them against the templates).
int ppt_tiled_mv_any_t(int t, const float* A, const float* C,
                       const int* offsets, int n_off, int N, const float* p,
                       float* q, void* stream) {
  return tiled_mv(t, Mv::kAnyT, A, C, offsets, n_off, N, p, q, stream);
}

int ppt_tiled_pc_any_t(int t, const float* Minv, int N, const float* r,
                       float* z, void* stream) {
  return tiled_pc(t, true, Minv, N, r, z, stream);
}

// ppt_tiled_mv through the ring at every t (to hold it against the other
// kernels and time it beside them).
int ppt_tiled_mv_ring(int t, const float* A, const float* C,
                      const int* offsets, int n_off, int N, const float* p,
                      float* q, void* stream) {
  return tiled_mv(t, Mv::kRing, A, C, offsets, n_off, N, p, q, stream);
}

// The ring's plan at N nodes and block size t, as ops/stencil_cg.py:
// tiled_plan computes it, on the current device: out[0..9] = tile nodes
// (most), block rows a stage (g), columns a stage (us), stages, row
// pitch, forward and back pitches, floats a stage, shared-memory bytes,
// CTAs.
int ppt_tiled_plan(int N, int t, int* out) {
  if (t < 1 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(N, t);
  int grid = 0;
  const cudaError_t e = ring_grid(N, &grid);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int fields[] = {kTileNodes, p.g,   p.us,           p.stages, p.pitch,
                        p.gpf,      p.gpb, p.stage_floats, p.smem,   grid};
  for (int i = 0; i < 10; ++i) out[i] = fields[i];
  return 0;
}

const char* ppt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

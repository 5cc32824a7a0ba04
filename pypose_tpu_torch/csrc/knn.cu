// Brute-force nearest neighbours: nn1 (k = 1) and nnk (2 <= k <= N), two
// register-tiled scans of one design for clouds of 1 to 8 coordinates, and
// two wide scans for clouds of more; past k = 16 the lists leave the
// registers (below).
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
// nn1_tolerance_failures).  Both register-tiled scans are instantiated for
// 1 <= D <= 8
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
// Wide clouds (D > 8), float32: nn1_wide_scan and nnk_wide_scan (both
// wide_tc_scan), the same TPU kernels (pallas_knn.py:nn1 :176 and nnk
// :138) past 8 coordinates (FPFH descriptors are 33-D, SIFT 128-D), on
// Hopper's tensor cores in three-pass TF32.  What bounds them: the cross
// term a.b, 2 D flop a pair, which on the SIMT units can never pass 67
// TFLOP/s; the tensor cores run TF32 at 495 TFLOP/s, but one TF32 pass
// keeps 11 bits of each coordinate, hundreds of times the near-tie
// tolerance.  So:
//  - a pre-pass (tf32_split) splits each coordinate once a call into
//    hi = rna_tf32(x) and lo = rna_tf32(x - hi) (cvt.rna: rounded, not the
//    tensor core's truncation of raw float32), zero-padded to Dp, a
//    multiple of 8 coordinates, in panels of 64 rows laid out as wgmma's
//    K-major operand with the 32-byte swizzle (a row's k-step contiguous;
//    the unswizzled layout, its two 16-byte halves 1 KB apart, timed the
//    same), with |b|^2 (the FMA chain from the first coordinate; +inf past
//    N) after each panel;
//  - a block of two consumer warpgroups (64 reference rows each) and one
//    producer warp walks the split's tiles of 64 neighbours; the producer
//    brings each tile's hi, lo and |b|^2 by cp.async.bulk into a ring of
//    2-4 shared-memory stages (the most that keep the most blocks an SM,
//    tc_plan_k) behind mbarriers (full: bytes arrived; empty:
//    the 256 consumer threads are done), in chunks of 64 coordinates; the
//    block's rows stay resident while Dp <= 128 and ride in each stage
//    past that (any D); where 66 KB past the ring leave no room for two
//    such stages (past k = 16 and in the select path, below), a stage
//    holds one block of a fresh sum (32 or 40 coordinates) instead;
//  - each warpgroup forms its 64 x 64 tile of cross terms with
//    wgmma.m64n64k8.tf32, both operands from shared memory: for each block
//    of 32 coordinates (40 where 8 are left) a fresh sum, a_lo b_hi and
//    a_hi b_lo first (the small products), a_hi b_hi last, added to a
//    float32 total rounded to nearest; s = |b|^2 - 2 total.  The tensor
//    cores truncate as they accumulate: one sum over 128 coordinates put
//    d^2 1.05 times the near-tie tolerance off on 100-sum descriptors (the
//    card test at D = 128); blocks keep each sum's magnitude, and so its
//    truncation, small.  Three passes cost 3 x 2 D flop a pair, 165
//    TFLOP/s of effective rate at the TF32 peak, and hold the float32 FMA
//    chain's accuracy (the emulation in ops/knn.py:_tf32_scores);
//  - selection stays in registers: a thread holds two rows' scores of 16
//    columns a tile (wgmma's accumulator layout) and scans them in
//    ascending index; nn1 keeps a running (s, index) minimum (a tile's
//    min first, its first index only when it improves), nnk a K-list a row
//    and thread pruned by the least K-th s of the row's four threads; the
//    four threads of a row merge by shuffles in (s, index) order, so the
//    lowest index wins a tie.
// On the card (PERF.md; probes/knn_probes.py): ptxas serialized
// every wgmma while the consumers' code sat on a path it could not prove
// uniform (C7520: the role branch, a C++ wait loop), 1.3-1.4 times the
// time; hence the shuffled role and the PTX wait loop.  Alone, the
// m64n64k8 TF32 wgmma runs at 0.96 of the peak with two warpgroups an SM
// (probes/wgmma_rate.cu).  With the products removed a scan still takes
// a half (D = 33) to a third (D = 128) of its time: the neighbours'
// stream from L2 and the selection.
// The splits of the neighbour range and the merge passes are the D <= 8
// scans'.
//
// Wide clouds (D > 8), float64: the same tensor-core scan,
// wide_tc_scan<double, K> (every K: 1, the list lengths, kBig, kCount,
// kEmit), on the FP64 tensor cores.  What bounds it: the cross term, 2 D
// flop a pair, at 34 TFLOP/s on the SIMT units (an earlier small SIMT GEMM:
// 2.67 ms at FPFH-like 10,000^2, k = 32; 1.14 ms for nn1) and 67 on DMMA;
// and past a few hundred k the merge scan's merges (44.34 ms at
// k = 1024).  So:
//  - Hopper has no float64 wgmma: each warp forms its 16 rows x 64
//    neighbours by mma.sync.m16n8k8.f64 (dmma_unit), eight column slices
//    of 8, whose accumulators sit where wgmma.m64n64's do, so every
//    selection mode (nn1's running minimum, the K-lists, the buffers,
//    flush_row, the lists, nnk_merge_big, the counting passes, the
//    emission and the sample) reads them as it reads float32's; alone each m16n8 shape runs at 66 TFLOP/s
//    (probes/dmma_rate.cu), m8n8k4 at 33;
//  - a pre-pass (f64_panels) lays each cloud out once a call in panels of
//    the float32 split's bytes (a float64 coordinate takes a hi and lo
//    pair's 8 bytes; |b|^2, the FMA chain, after each panel in 64
//    doubles): each k-step's row in the order 0 4 1 5 2 6 3 7, so a
//    thread's two coordinates t and t + 4 come by one 16-byte load and a
//    quarter-warp's loads cover 128 contiguous bytes (no 64-bit ldmatrix
//    exists; alone the loads move 127 of an SM's 128 bytes a cycle, two
//    8-byte loads in coordinate order 64, probes/dmma_rate.cu); the
//    producer's bulk copies and mbarriers are float32's, one copy a
//    unit, and the consumers fence the async proxy before each release
//    (every operand is read by plain loads);
//  - one sum a tile, k-steps in ascending order, then s = |b|^2 - 2 a.b
//    by one FMA (|b|^2 + sum a (-2 b): the factor -2 is exact), the same
//    in every mode, so the merge scan and the select path return the
//    same bits; DMMA rounds otherwise than the SIMT chain: the card holds
//    it at rtol = atol = 1e-13;
//  - tc_plan_k's layouts hold as in float32 at D = 33, 128 and 300 but
//    the merge scan's buffers: an entry is 12 bytes, 99 KB past the ring,
//    two block stages where float32 has three past 96 coordinates.
// Past the crossover (wide_select_k: 48 up to 64 coordinates, 192 past)
// and at k = N the select path (launch_nnk_wide_select<double>).  Up to
// k = 16 every mode forms the same s as the merge scan past it, so nnk(16)
// is nnk(32)'s first 16 columns bit for bit, and nn1 nnk(2)'s first.
//
// nnk past k = 16, two ways.  The same TPU kernel (pallas_knn.py:
// _knnk_kernel :50, which takes any k <= N).
//
// The merge scans (nnk_warp_scan, wide_tc_scan<T, kBig>): each family at
// 16 < k below its crossover and N.  A list of k = 100 pairs a row would
// take 200 registers, so each family scores its pairs as at k <= 16 (the
// same FMA chain; on the tensor cores the same three-pass total, or
// DMMA's float64 sum) and appends each pair before its row's k-th pair
// in (s, index) order (every pair until the row's list holds k) to the
// row's buffer in shared memory, which the row's warp merges into the
// row's sorted list (flush_row: a bitonic sort of 64 candidates in
// registers by shuffles, then the list rewritten in place from its top
// down, each entry moving up by the candidates before it); the row's
// k-th pair, the threshold, tightens.  A random cloud makes ~k (1 +
// ln(M / k)) candidates a row over a split of M neighbours.
//
// The register-tiled family (D <= 8), nnk_warp_scan.  The earlier design (one
// row a thread, buffers of 32, the lists in global memory) took 8.3-14.8
// ms at k = 30-100 on 100,000^2 (0.06-0.11 of its bound, PERF.md): each
// warp merged its 32 rows one after another, the lists' reads and writes
// chains through L2, every row's first ceil(k / 32) batches all merges;
// one neighbour's load fed one row; and its splits left 1.5 waves.  So:
//  - the lists stay in shared memory: a warp keeps 4 rows (2 in float64),
//    each row's list of k pairs, its buffer and its state beside them; no
//    merge leaves the SM, and where one split covers the rows the scan
//    writes d^2 and the indices itself (no merge pass);
//  - the warp's lanes score different neighbours against the same rows:
//    a lane's LDS.128 of a neighbour feeds the warp's 4 rows, the pair
//    costs its D FFMA, a compare with the row's threshold and an OR into
//    the lane's candidate bits; a batch of 64 neighbours (two a lane) ends
//    in one vote, and only where some lane has a candidate do its lanes
//    take buffer places by shared atomics (with the scores they already
//    hold);
//  - a row's buffer holds 64, merged before a batch would overflow it
//    (a batch brings one or two candidates a row in the scan's long
//    tail, so a merge takes 60-64; the split's first k take ceil(k / 64)
//    merges);
//  - warps do not wait for each other: the neighbours are staged once a
//    call (warp_tiles, in global memory) and one producer thread streams
//    them by bulk copies into a ring of 4 stages behind mbarriers (with a
//    block barrier a tile, the tile staged by all, every warp waited for
//    the block's slowest, whose merges fell in that tile);
//  - the warps a block and the splits come from the blocks an SM holds
//    (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the lists' bytes,
//    warp_plan): the warps that let the most share an SM, then the split
//    count whose waves cost least (one split at ICP's 100,000 rows);
//    several splits' lists meet in nnk_merge_big.
// The lists' bytes grow with k (a block of 8 warps at k = 100 takes 58
// KB in float32), so past a few hundred k fewer warps share an SM while
// each row merges more often: there the select path takes over.
//
// The tensor-core scans (wide_tc_scan<T, kBig>) append from a row's four
// threads (their columns interleave, hence the (s, index) order in the
// test) to buffers of 64 (kBuf: a tile of 64 neighbours appends at most
// 64), merged by flush_row into lists in global memory, in part_s /
// part_i [splits, R, k] (in L2 while the split runs); splits as many as
// one wave of blocks holds, at most 32, within 1 GB of lists
// (kPartBudget); a split of fewer than k neighbours sorts them all, its
// list ending in (inf, INT_MAX) pairs; the merge pass (nnk_merge_big)
// takes a warp a row, lane sp the head of split sp's list, and writes
// the k least heads.  The scan keeps its 128 rows a block, its producer
// and its ring; the buffers take 66 KB past the ring (float64: 99 KB),
// which leaves two stages of a chunk up to 96 padded coordinates; past
// that a stage holds a block of 32 coordinates and the rows ride in it
// (tc_plan_k), at any D, so every wide call past k = 16 runs on the
// tensor cores.
//
// Select, then sort (launch_nnk_select, launch_nnk_wide_select): the
// register-tiled family at k >= select_k(R) (kSelectK, kSelectK64 in
// float64, past kSmallR rows; kSelectKSmallR up to them) and the wide
// families at k >= wide_select_k (kWideSelectK in float32; kWideSelectK64
// and kWideSelectK64Long in float64, by D; the crossovers, measured), all
// at k = N (the float64 wide family past k = 16).
// Rather than merge candidates, find each row's k-th (s, index) pair
// first, write the pairs before it once, and sort them once:
//  - keys: s as an order-preserving unsigned key (Sel<T>::key: every bit
//    flipped where s < 0, the sign bit where s >= 0, -0 made +0 first, as
//    the (s, index) order holds them equal); a pair's place is its (key,
//    index), packed into 64 bits in float32;
//  - select (sel_count, sel_pick): counting passes fix the row's
//    threshold 8 bits at a time, the key's from the top, then the
//    index's (exact ties, as on integer clouds, cut by index).  Each pass
//    scores every pair again from the staged tiles, the scans' function
//    and bits: at D <= 8 a score is 3-8 FMA, far cheaper than storing
//    10^9 pairs.  It counts the digit of the pairs that share the prefix
//    fixed so far in the row's 256 counters in shared memory (one row a
//    thread, 128 a block, the counters the thread's own: two 16-bit
//    counts a word, so splits of at most 65,504 neighbours); the blocks
//    of a row add theirs into its global histogram (integer atomics: the
//    same counts in any order), and a warp a row fixes the digit where
//    the k-th pair falls, until the pairs of that bin complete the k or
//    fit the row's boundary buffer (256-512 pairs).  Past 8 coordinates
//    each pass is a mode of the tensor-core scan (wide_tc_scan<T,
//    kCount>): the merge scan's products and sums, so the same s; a row's
//    four threads add into its counters by shared atomics (the counters
//    take 66 KB past the ring, as the float32 merge scan's buffers do),
//    and the first digit is guessed from a sample of every 8th tile and
//    checked by the pass that counts the second (launch_nnk_wide_select;
//    float64's keys take 8 digits, the walk a row three full passes on
//    FPFH-like clouds, the guess spares one);
//  - emit (sel_emit; wide_tc_scan<T, kEmit>): one more pass writes every
//    pair before the prefix
//    into the row's slots of the outputs (as pairs, slots by atomics) and
//    the bin's pairs there or into the boundary buffer; no [splits, R, k]
//    lists, so no budget on them;
//  - sort (sel_sort): one block a row sorts its list (at most k - 1 plus
//    its boundary pairs, padded to a power of 2) by (key, index), a
//    bitonic network with 8 pairs a thread in registers: a step runs in
//    the layout that holds its stride's bit, the layouts exchanged
//    through shared memory (~log2(P) / 3 + 1 a merge); then the first k
//    as d^2 = s + |a|^2 clamped at 0.  Past kSortMax pairs the network's
//    long strides run in global memory (sel_step) between blocks of the
//    row's tiles.  k = N within a block: the sort alone (sel_sort_all),
//    scoring its pairs itself, in the register-tiled family; the wide
//    family emits its N pairs a row by the tensor-core pass and sorts
//    them.
// What bounds it on an H100: instruction issue over the R x N pairs, in
// two or three counting passes (on random float32 clouds) and the
// emission.  The first count is the dear one: every pair forms its key
// and counts; a thread's pairs of one digit count in a register until
// the digit changes, which spares most of its shared-memory atomics.  In
// the later passes a pair outside the prefix's score bounds (sel_bounds)
// costs its score and two compares.  Then the sort, ~P/2 log2(P)
// (log2(P) + 1) / 2 compare-exchanges a row of P, in registers.  Both
// paths rank the same s in the same (s, index) order, so they return the
// same bits (the card test against the merge scan's build,
// probes/knn_probes.py --crossover).

// What bounds the register-tiled scans on an H100: instruction issue.  nn1
// needs D FMA a pair;
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
#include <climits>
#include <cmath>
#include <cstdint>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 128;   // threads a block, both scans
constexpr int kSub = 32;        // neighbours a sub-tile
constexpr int kMinSplit = 2048; // neighbours a split, least
constexpr int kMaxDim = 8;      // the register-tiled scans' largest D
constexpr int kMaxK = 16;       // the longest list kept in registers

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

// The shared-memory tile of L (tile_len<T>() unless named) staged
// neighbours: the 4-vectors of coordinates 0-3 and 4-7 (the second only
// past D = 4), and |b|^2 where own_bn<D>().
template <typename T, int D, int L = tile_len<T>()>
struct Tile {
  vec4_t<T> w0[L];
  vec4_t<T> w1[D > 4 ? L : 1];
  T bn[own_bn<D>() ? L : 1];
};

// A staged neighbour as a scan reads it.
template <typename T>
struct Nbr {
  vec4_t<T> w0, w1;
  T bn;
};

template <typename T, int D, int L>
__device__ __forceinline__ Nbr<T> load(const Tile<T, D, L>& tl, int t) {
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
// coordinates and |b|^2 = inf, so s = inf, by `threads` threads (thread
// `first` the first).
template <typename T, int D, int L>
__device__ __forceinline__ void stage(const T* __restrict__ nbr, int t0,
                                      int n, int n_pad, Tile<T, D, L>& tl,
                                      int threads = kThreads,
                                      int first = threadIdx.x) {
  for (int t = first; t < n_pad; t += threads) {
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

// Coordinates past which a float32 |x|^2 sums in float64 and rounds once:
// at 300 coordinates the float32 chains of |a|^2 and |b|^2 put d^2 1.07
// times the near-tie tolerance off (3e-5 and 5e-5 on 300-bin histograms,
// whose cross term three TF32 passes hold to 1e-7; the card test at
// D = 300).
constexpr int kLongNorm = 128;

// |a|^2 of reference row `row`, FMA from the first coordinate (in float64,
// rounded once, for float32 rows past kLongNorm coordinates); D = 0 (the
// wide scans) reads the number of coordinates from `dim`.
template <typename T, int D>
__device__ __forceinline__ T ref_sqnorm(const T* ref, int row, int dim) {
  const int n = D > 0 ? D : dim;
  const T* a = ref + static_cast<size_t>(row) * n;
  if (sizeof(T) == sizeof(float) && n > kLongNorm) {
    double an = 0.0;
    for (int c = 0; c < n; ++c)
      an = __fma_rn(static_cast<double>(a[c]), static_cast<double>(a[c]), an);
    return static_cast<T>(an);
  }
  T an = a[0] * a[0];
#pragma unroll
  for (int c = 1; c < n; ++c) an = fma_rn(a[c], a[c], an);
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
__global__ void nn1_merge(const T* __restrict__ ref, int R, int dim,
                          int splits,
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
  d2[row] = max_of(add_rn(best, ref_sqnorm<T, D>(ref, row, dim)), T(0));
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
  nn1_merge<T, D><<<(R + 255) / 256, 256, 0, stream>>>(ref, R, D, splits,
                                                       part_s, part_i, d2,
                                                       idx);
  return cudaGetLastError();
}

// The wide scan (below): on the tensor cores through `scratch`, float32
// in three-pass TF32, float64 on DMMA.
template <typename T>
cudaError_t launch_nn1_wide(const T* ref, const T* nbr, int R, int N, int D,
                            int splits, void* scratch, T* part_s,
                            int* part_i, T* d2, long long* idx,
                            cudaStream_t stream);

template <typename T>
cudaError_t nn1_any(const void* ref, const void* nbr, int R, int N, int D,
                    int splits, void* scratch, void* part_s, int* part_i,
                    void* d2, long long* idx, cudaStream_t stream) {
  if (D > kMaxDim)
    return launch_nn1_wide(
        static_cast<const T*>(ref), static_cast<const T*>(nbr), R, N, D,
        splits, scratch, static_cast<T*>(part_s), part_i,
        static_cast<T*>(d2), idx, stream);
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
__global__ void nnk_merge(const T* __restrict__ ref, int R, int dim, int k,
                          int splits,
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
  const T an = ref_sqnorm<T, D>(ref, row, dim);
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
      ref, R, D, k, splits, part_s, part_i, d2, idx);
  return cudaGetLastError();
}

// ---- k > 16: the lists off the registers ----------------------------------

constexpr int kBig = 0;           // wide_tc_scan's K for k > kMaxK
constexpr int kBuf = 64;          // candidates a row's buffer holds, most
constexpr int kMaxBigSplits = 32; // splits at k > kMaxK: one a merge lane
// bytes of partial lists at k > kMaxK, most (one split always)
constexpr size_t kPartBudget = size_t{1} << 30;

// (a, ia) before (b, ib) in (s, index) order
template <typename T>
__device__ __forceinline__ bool lex_less(T a, int ia, T b, int ib) {
  return a < b || (a == b && ia < ib);
}

// Sorts the 64 (s, index) pairs a warp holds, two a lane (position lane
// in slot 0, lane + 32 in slot 1), ascending by (s, index): a bitonic
// network over shuffles.  Pairs are distinct but for equal padding.
template <typename T>
__device__ __forceinline__ void warp_sort64(T (&s)[2], int (&id)[2]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      if (stride == 32) {
        if (lex_less(s[1], id[1], s[0], id[0])) {
          const T x = s[0];
          const int xi = id[0];
          s[0] = s[1];
          id[0] = id[1];
          s[1] = x;
          id[1] = xi;
        }
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = lane + 32 * h;
        const T os = __shfl_xor_sync(0xffffffffu, s[h], stride);
        const int oi = __shfl_xor_sync(0xffffffffu, id[h], stride);
        // the lower position of an ascending pair keeps the least
        const bool keep_min = ((p & stride) == 0) == ((p & size) == 0);
        if (keep_min ? lex_less(os, oi, s[h], id[h])
                     : lex_less(s[h], id[h], os, oi)) {
          s[h] = os;
          id[h] = oi;
        }
      }
    }
  }
}

// How many of the warp's 64 sorted pairs (warp_sort64's layout) come
// before (x, xi); every lane calls it.
template <typename T>
__device__ __forceinline__ int below_in_buffer(const T (&s)[2],
                                               const int (&id)[2], T x,
                                               int xi) {
  int cnt = 0;
#pragma unroll
  for (int step = 64; step > 0; step >>= 1) {
    const int p = min(cnt + step, 64) - 1;
    const T s0 = __shfl_sync(0xffffffffu, s[0], p % 32);
    const T s1 = __shfl_sync(0xffffffffu, s[1], p % 32);
    const int i0 = __shfl_sync(0xffffffffu, id[0], p % 32);
    const int i1 = __shfl_sync(0xffffffffu, id[1], p % 32);
    if (cnt + step <= 64 &&
        lex_less(p < 32 ? s0 : s1, p < 32 ? i0 : i1, x, xi))
      cnt += step;
  }
  return cnt;
}

constexpr int kRound = 4;    // list entries a lane moves a round
constexpr int kHist = 68;    // a warp's counters: 65, padded to 16 bytes

// The warp merges one row's buffer of c >= 1 candidates (entry e at
// bs[e * bstride], bi[e * bstride]) into the row's list (ls, li in global
// memory: n pairs sorted by (s, index)), keeping the first k; returns the
// list's new length.  Every lane calls it with the same arguments; hist is
// the warp's kHist counters in shared memory, zero on entry and on return.
// The buffer is sorted in registers.  A list entry j moves up by c_j, the
// candidates before it (indices are distinct, so the places are too); the
// list is rewritten in place from its top down, 32 Round entries a round,
// each round's reads before its writes (which land at or above its
// entries) and the next round's reads in flight over them; the rounds stop
// at the first whose lowest entry stays (c_j = 0: so does every entry
// under it).  Candidate i lands at i plus its rank in the list, the
// entries with c_j <= i: those under the last round and a histogram of the
// rounds' c_j.
template <typename T, int Round = kRound>
__device__ int flush_row(const T* bs, const int* bi, int bstride, int c,
                         T* ls, int* li, int n, int k, int* hist) {
  const int lane = threadIdx.x % 32;
  T s[2];
  int id[2];
  __syncwarp();  // the owner's appends
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = lane + 32 * h;
    s[h] = e < c ? bs[static_cast<size_t>(e) * bstride] : inf<T>();
    id[h] = e < c ? bi[static_cast<size_t>(e) * bstride] : INT_MAX;
  }
  warp_sort64(s, id);
  T xs[Round], ns[Round];
  int xi[Round], ni[Round];
  int top = n, below = 0;
#pragma unroll
  for (int u = 0; u < Round; ++u) {
    const int j = top - 32 * Round + lane + 32 * u;
    xs[u] = j >= 0 ? ls[j] : T(0);
    xi[u] = j >= 0 ? li[j] : 0;
  }
  while (top > 0) {
    const int base = top - 32 * Round;
    int cj[Round];
#pragma unroll
    for (int u = 0; u < Round; ++u) {
      const int jn = base - 32 * Round + lane + 32 * u;
      ns[u] = jn >= 0 ? ls[jn] : T(0);
      ni[u] = jn >= 0 ? li[jn] : 0;
    }
    if (base >= 0) {
      // a whole round: the slots' shuffle chains interleave
#pragma unroll
      for (int u = 0; u < Round; ++u)
        cj[u] = below_in_buffer(s, id, xs[u], xi[u]);
    } else {
      // the last round: a slot wholly under the list's bottom (the same
      // on every lane) skips its shuffles, as most of a short list's do
#pragma unroll
      for (int u = 0; u < Round; ++u) {
        cj[u] = -1;
        if (base + 32 * u + 31 < 0) continue;
        const int c_j = below_in_buffer(s, id, xs[u], xi[u]);
        cj[u] = base + lane + 32 * u >= 0 ? c_j : -1;
      }
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < Round; ++u) {
      if (base + 32 * u + 31 < 0) continue;
      const int j = base + lane + 32 * u;
      if (cj[u] > 0 && j + cj[u] < k) {
        ls[j + cj[u]] = xs[u];
        li[j + cj[u]] = xi[u];
      }
      // the histogram: the last lane of each run of equal c_j adds the run
      const int prev = __shfl_up_sync(0xffffffffu, cj[u], 1);
      const int next = __shfl_down_sync(0xffffffffu, cj[u], 1);
      const unsigned starts =
          __ballot_sync(0xffffffffu, lane == 0 || prev != cj[u]);
      // the run's first lane: the last start at or below this lane
      const int first = 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
      if (cj[u] >= 0 && (lane == 31 || next != cj[u]))
        atomicAdd(&hist[cj[u]], lane + 1 - first);
    }
    const int lowest = __shfl_sync(0xffffffffu, cj[0], 0);
    top = base;
    if (base <= 0 || lowest == 0) {
      below = max(base, 0);
      break;
    }
#pragma unroll
    for (int u = 0; u < Round; ++u) {
      xs[u] = ns[u];
      xi[u] = ni[u];
    }
  }
  __syncwarp();
  // rank of candidates lane and lane + 32: below + the counts up to them
  int r0 = hist[lane], r1 = hist[lane + 32];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a0 = __shfl_up_sync(0xffffffffu, r0, off);
    const int a1 = __shfl_up_sync(0xffffffffu, r1, off);
    if (lane >= off) {
      r0 += a0;
      r1 += a1;
    }
  }
  r1 += __shfl_sync(0xffffffffu, r0, 31);
  const int pos[2] = {lane + below + r0, lane + 32 + below + r1};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (lane + 32 * h < c && pos[h] < k) {
      ls[pos[h]] = s[h];
      li[pos[h]] = id[h];
    }
  }
  hist[lane] = 0;
  hist[lane + 32] = 0;
  if (lane == 0) hist[64] = 0;
  __syncwarp();
  return min(k, n + c);
}

// Where a block of the k > kMaxK scans keeps its rows' candidates and
// lists.  Dynamic shared memory holds the buffers (`cap` entries a row,
// at most kBuf), entry e of block row r at e * (rows + 1) + r (rows + 1:
// a warp's lanes on distinct banks both when each appends to its row and
// when the warp reads one row), then each warp's kHist counters; the
// lists are part_s / part_i [splits, R, k] themselves.
template <typename T>
struct BigLists {
  T* bs;
  int* bi;
  T* ls;
  int* li;
  int* hist;
  int stride, k;

  __device__ BigLists(unsigned char* smem, int rows, int k_, T* part_s,
                      int* part_i, int R, int row0, int cap = kBuf)
      : stride(rows + 1), k(k_) {
    bs = reinterpret_cast<T*>(smem);
    bi = reinterpret_cast<int*>(bs + cap * stride);
    hist = bi + cap * stride + kHist * (threadIdx.x / 32);
    const size_t o = (static_cast<size_t>(blockIdx.y) * R + row0) * k;
    ls = part_s + o;
    li = part_i + o;
  }
  // the calling warp zeroes its counters
  __device__ void init() const {
    for (int e = threadIdx.x % 32; e < kHist; e += 32) hist[e] = 0;
    __syncwarp();
  }
  __device__ T* list_s(int r) const { return ls + static_cast<size_t>(r) * k; }
  __device__ int* list_i(int r) const {
    return li + static_cast<size_t>(r) * k;
  }
  // the warp merges the buffer of block row r (c candidates) into its
  // list of n; returns the new length
  __device__ int flush(int r, int c, int n) const {
    return flush_row(bs + r, bi + r, stride, c, list_s(r), list_i(r), n, k,
                     hist);
  }
  // the warp ends block row r's list of n < k pairs (a split of fewer
  // than k neighbours) with (inf, INT_MAX), after every real pair
  __device__ void pad(int r, int n) const {
    for (int e = n + threadIdx.x % 32; e < k; e += 32) {
      list_s(r)[e] = inf<T>();
      list_i(r)[e] = INT_MAX;
    }
  }
  // appends (s, j) as entry e of block row r's buffer
  __device__ void put(int r, int e, T s, int j) const {
    bs[static_cast<size_t>(e) * stride + r] = s;
    bi[static_cast<size_t>(e) * stride + r] = j;
  }
};

// Dynamic shared memory of a k > kMaxK block of `rows` rows and `threads`
// threads: buffers of `cap` candidates and the warps' counters.
size_t big_bytes(int rows, int threads, size_t scalar, int cap = kBuf) {
  return cap * static_cast<size_t>(rows + 1) * (scalar + sizeof(int)) +
         sizeof(int) * kHist * static_cast<size_t>((threads + 31) / 32);
}

int smem_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

// ---- shared memory by the bulk-copy engine, behind mbarriers --------------
// (bulk_copy.cuh)

using ppt::bulk_load;
using ppt::fence_proxy_async;
using ppt::mbar_arrive;
using ppt::mbar_expect_tx;
using ppt::mbar_init;
using ppt::mbar_wait;
using ppt::smem_addr;

// ---- k > 16, D <= 8: the warp merge scan ---------------------------------

// Rows a warp of nnk_warp_scan keeps (float32 4, float64 2: their
// coordinates stay at 32 registers either way), neighbours a lane scores
// a batch, scanning warps a block (most; one producer warp beside them),
// the neighbours a ring stage holds (a tile of that length, 4 KB of
// coordinates) and the ring's stages.
template <typename T>
__host__ __device__ constexpr int warp_rows() {
  return 16 / static_cast<int>(sizeof(T));
}
constexpr int kLaneNbrs = 2;
constexpr int kWarpBatch = 32 * kLaneNbrs;  // neighbours a warp's batch
constexpr int kMaxWarps = 7;
template <typename T>
__host__ __device__ constexpr int ring_len() {
  return 1024 / static_cast<int>(sizeof(T));
}
constexpr int kRingStages = 4;
constexpr int kWarpBarBytes = 128;  // the ring's mbarriers, at the head
// list entries a lane moves a merge round (flush_row): fewer registers
// live beside the rows' than kRound's
constexpr int kWarpRound = 1;
// a row's buffer: a batch appends at most kWarpBatch candidates to the
// fewer than kBuf it holds
constexpr int kWarpBuf = kBuf + kWarpBatch;

template <typename T, int D>
using RingTile = Tile<T, D, ring_len<T>()>;

// Dynamic shared memory of a block of nnk_warp_scan of `warps` scanning
// warps (`rows` rows) of D coordinates at k: the ring's mbarriers and
// stages, each row's list (k pairs), buffer (kWarpBuf pairs) and state
// (threshold, list length, buffer count), then each warp's kHist
// counters.
template <typename T, int D>
size_t warp_bytes(int rows, int warps, int k) {
  return kWarpBarBytes + kRingStages * sizeof(RingTile<T, D>) +
         static_cast<size_t>(rows) *
             ((static_cast<size_t>(k) + kWarpBuf) * (sizeof(T) + sizeof(int)) +
              sizeof(T) + 2 * sizeof(int)) +
         sizeof(int) * kHist * static_cast<size_t>(warps);
}

// The pre-pass: neighbours [0, tiles * L) of nbr [N, D] staged once a call
// into `tiles` ring tiles in global memory, as stage() lays them out
// (zero coordinates and |b|^2 = inf past N), which the scan's producer
// copies whole.  One thread a neighbour.
template <typename T, int D>
__global__ void warp_tiles(const T* __restrict__ nbr, int N, int tiles,
                           RingTile<T, D>* __restrict__ out) {
  constexpr int L = ring_len<T>();
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= tiles * L) return;
  stage<T, D>(nbr, j / L * L, max(0, min(L, N - j / L * L)), L, out[j / L],
              L, j % L);
}

// nnk at 16 < k below the crossover, D <= 8: each scanning warp keeps
// warp_rows() rows (the same on every lane), and its lanes score a batch
// of kWarpBatch staged neighbours against them, kLaneNbrs a lane (a
// neighbour's LDS.128 feeds every row of the warp): the score of
// nnk_scan, compared with the row's threshold, its k-th s.  A pair under
// it is a candidate (every neighbour of the split's first k is one): it
// takes a place in the row's buffer in shared memory, ranked among the
// warp's by a ballot, with the score it already has; the counts live in
// registers (uniform), shared memory only at the merges.  Where a row's
// buffer then holds kBuf, the warp merges kBuf of them into the row's
// sorted list of k, also in shared memory (flush_row: a bitonic sort of
// the 64 by shuffles, then the list rewritten in place from its top
// down), the rest moving to the buffer's front, and the threshold
// tightens; the split's first k fill the list by ceil(k / 64) such
// merges, the rest of the buffers merged after them.  The merges come
// after the appends, when the batch's scores are dead: fewer registers.  Within a split the lists hold only
// neighbours of earlier batches, so a candidate equal to the k-th s comes
// later than it and loses: a strict < is the (s, index) order.  The
// staged tiles (warp_tiles) come by bulk copies of the last warp's lane 0
// into a ring of kRingStages stages behind mbarriers (full: the bytes
// arrived; empty: every scanning warp is done with it), so no warp waits
// for another's merges.  One split (the rows' whole range) writes d^2 = s
// + |a|^2, clamped at 0, and the indices; several write their lists to
// part_s / part_i [splits, R, k] (ending in (inf, INT_MAX) past a split of
// fewer than k neighbours) for nnk_merge_big.  Rows past R take no
// candidate (a threshold of -inf).
template <typename T, int D>
__global__ void __launch_bounds__(32 * (kMaxWarps + 1), 3)
nnk_warp_scan(const T* __restrict__ ref, const RingTile<T, D>* __restrict__ tiles,
              int R, int N, int k, int split_tiles, T* __restrict__ part_s,
              int* __restrict__ part_i, T* __restrict__ d2,
              long long* __restrict__ idx) {
  constexpr int RW = warp_rows<T>();
  constexpr int L = ring_len<T>();
  using Stage = RingTile<T, D>;
  extern __shared__ __align__(16) unsigned char warp_smem[];
  const int warps = blockDim.x / 32 - 1, rows = warps * RW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint64_t* const full = reinterpret_cast<uint64_t*>(warp_smem);
  uint64_t* const empty = full + kRingStages;
  Stage* const ring = reinterpret_cast<Stage*>(warp_smem + kWarpBarBytes);
  const int all_tiles = (N + L - 1) / L;
  const int tile0 = blockIdx.y * split_tiles;
  const int tile1 = min(all_tiles, tile0 + split_tiles);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kRingStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == warps) {
    // the producer: one thread keeps the ring full
    if (lane != 0) return;
    for (int t = tile0, it = 0; t < tile1; ++t, ++it) {
      const int st = it % kRingStages;
      if (it >= kRingStages)
        mbar_wait(&empty[st], ((it / kRingStages) - 1) & 1);
      mbar_expect_tx(&full[st], sizeof(Stage));
      bulk_load(&ring[st], &tiles[t], sizeof(Stage), &full[st]);
    }
    return;
  }
  T* const ls = reinterpret_cast<T*>(ring + kRingStages);
  T* const bs = ls + static_cast<size_t>(rows) * k;
  T* const sthr = bs + rows * kWarpBuf;
  int* const li = reinterpret_cast<int*>(sthr + rows);
  int* const bi = li + static_cast<size_t>(rows) * k;
  int* const slen = bi + rows * kWarpBuf;
  int* const scnt = slen + rows;
  int* const hist = scnt + rows + kHist * warp;
  const int rb0 = warp * RW, row0 = blockIdx.x * rows + rb0;
  for (int e = lane; e < kHist; e += 32) hist[e] = 0;
  if (lane < RW) {
    sthr[rb0 + lane] = row0 + lane < R ? inf<T>() : -inf<T>();
    slen[rb0 + lane] = 0;
    scnt[rb0 + lane] = 0;
  }
  __syncwarp();
  T a[RW][D], thr[RW];
  int cnt[RW];  // each row's buffer count (scnt is written at its merges)
  bool live[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    live[r] = row0 + r < R;
#pragma unroll
    for (int c = 0; c < D; ++c)
      a[r][c] = live[r] ? ref[static_cast<size_t>(row0 + r) * D + c] : T(0);
    thr[r] = sthr[rb0 + r];
    cnt[r] = 0;
  }
  const int j_end = min(N, tile1 * L);
  const int j_fill = tile0 * L + k;  // the split's first k: all candidates
  // The warp merges block row rb's first min(kBuf, count) candidates into
  // its list; the rest move to the buffer's front.
  auto merge = [&](int rb) {
    const int c = scnt[rb], m = min(kBuf, c);
    T* const b_s = bs + rb * kWarpBuf;
    int* const b_i = bi + rb * kWarpBuf;
    T* const l_s = ls + static_cast<size_t>(rb) * k;
    const int n = flush_row<T, kWarpRound>(b_s, b_i, 1, m, l_s,
                                           li + static_cast<size_t>(rb) * k,
                                           slen[rb], k, hist);
    const int e = m + lane;  // the rest: fewer than kWarpBatch + 1
    const T xs0 = e < c ? b_s[e] : T(0), xs1 = e + 32 < c ? b_s[e + 32] : T(0);
    const int xi0 = e < c ? b_i[e] : 0, xi1 = e + 32 < c ? b_i[e + 32] : 0;
    __syncwarp();
    if (e < c) {
      b_s[e - m] = xs0;
      b_i[e - m] = xi0;
    }
    if (e + 32 < c) {
      b_s[e + 32 - m] = xs1;
      b_i[e + 32 - m] = xi1;
    }
    if (lane == 0) {
      slen[rb] = n;
      scnt[rb] = c - m;
      sthr[rb] = n == k ? l_s[k - 1] : inf<T>();
    }
    __syncwarp();
  };
  // The warp merges the buffers of its rows that hold at least `least`
  // candidates until none does, then reloads their counts and thresholds.
  auto drain = [&](int least) {
    unsigned todo = 0u;
    int mine = 0;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      todo |= cnt[r] >= least ? 1u << r : 0u;
      mine = lane == r ? cnt[r] : mine;
    }
    if (!todo) return;
    if (lane < RW) scnt[rb0 + lane] = mine;
    __syncwarp();
    for (unsigned t = todo; t; t &= t - 1u) {
      const int rb = rb0 + __ffs(t) - 1;
      while (scnt[rb] >= least) merge(rb);
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      cnt[r] = scnt[rb0 + r];
      thr[r] = sthr[rb0 + r];
    }
  };
  // The candidates of the batch at j0 (each lane's bits m, scores sc)
  // into their rows' buffers, ranked by ballots (neighbour slot u's
  // candidates of the warp, then u + 1's); then the merges of the buffers
  // that hold kBuf (`last`: of every buffer).
  auto take = [&](const unsigned (&m)[RW], const T (&sc)[RW][kLaneNbrs],
                  int j0, bool last) {
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      if (__any_sync(0xffffffffu, m[r] != 0u)) {
        int at = (rb0 + r) * kWarpBuf + cnt[r];
#pragma unroll
        for (int u = 0; u < kLaneNbrs; ++u) {
          const unsigned w = __ballot_sync(0xffffffffu, m[r] >> u & 1u);
          if (m[r] >> u & 1u) {
            bs[at + __popc(w & below)] = sc[r][u];
            bi[at + __popc(w & below)] = j0 + 32 * u + lane;
          }
          at += __popc(w);
        }
        cnt[r] = at - (rb0 + r) * kWarpBuf;
      }
    }
    __syncwarp();
    drain(last ? 1 : kBuf);
  };
  for (int t = tile0, it = 0; t < tile1; ++t, ++it) {
    const int st = it % kRingStages;
    mbar_wait(&full[st], (it / kRingStages) & 1);
    const Stage& tl = ring[st];
    const int t0 = t * L;
    T sc[RW][kLaneNbrs];
    unsigned m[RW];
    int s0 = 0;
    // the split's first k (and the rest of their batch): every neighbour
    // a candidate; the last such batch empties the buffers, so that every
    // list holds k before the thresholds apply
    for (; s0 < L && t0 + s0 < min(j_fill, j_end); s0 += kWarpBatch) {
#pragma unroll
      for (int u = 0; u < kLaneNbrs; ++u) {
        const int s = s0 + 32 * u + lane;
        const Nbr<T> b = load<T, D>(tl, s);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          sc[r][u] = score<T, D>(a[r], b);
          m[r] = (u ? m[r] : 0u) | (live[r] && t0 + s < j_end ? 1u << u : 0u);
        }
      }
      take(m, sc, t0 + s0,
           t0 + s0 + kWarpBatch >= min(j_fill, j_end));
    }
    for (; s0 < L && t0 + s0 < j_end; s0 += kWarpBatch) {
#pragma unroll
      for (int u = 0; u < kLaneNbrs; ++u) {
        const Nbr<T> b = load<T, D>(tl, s0 + 32 * u + lane);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          sc[r][u] = score<T, D>(a[r], b);
          m[r] = (u ? m[r] : 0u) | (sc[r][u] < thr[r] ? 1u << u : 0u);
        }
      }
      unsigned any = 0u;
#pragma unroll
      for (int r = 0; r < RW; ++r) any |= m[r];
      if (__any_sync(0xffffffffu, any != 0u)) take(m, sc, t0 + s0, false);
    }
    // every read of the stage before the next bulk copy into it
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  drain(1);
#pragma unroll 1
  for (int r = 0; r < RW; ++r) {
    const int row = row0 + r, rb = rb0 + r;
    if (row >= R) break;
    const int n = slen[rb];
    const T* l_s = ls + static_cast<size_t>(rb) * k;
    const int* l_i = li + static_cast<size_t>(rb) * k;
    if (gridDim.y == 1) {
      const T an = ref_sqnorm<T, D>(ref, row, D);
      for (int e = lane; e < k; e += 32) {
        d2[static_cast<size_t>(row) * k + e] = max_of(add_rn(l_s[e], an), T(0));
        idx[static_cast<size_t>(row) * k + e] = l_i[e];
      }
    } else {
      const size_t o = (static_cast<size_t>(blockIdx.y) * R + row) * k;
      for (int e = lane; e < k; e += 32) {
        part_s[o + e] = e < n ? l_s[e] : inf<T>();
        part_i[o + e] = e < n ? l_i[e] : INT_MAX;
      }
    }
  }
}

// Each row's best k over the splits' lists (part_s / part_i [splits, R,
// k], each sorted by (s, index)): a warp a row, lane sp the head of split
// sp's list (the next entry already loaded); each step the least head in
// (s, index) order (the earlier split's on equal s, whose indices are
// lower) is the row's next, written 32 at a time; then d^2 = s + |a|^2
// clamped at 0.
template <typename T, int D>
__global__ void __launch_bounds__(256)
nnk_merge_big(const T* __restrict__ ref, int R, int dim, int k, int splits,
              const T* __restrict__ part_s, const int* __restrict__ part_i,
              T* __restrict__ d2, long long* __restrict__ idx) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= R) return;
  const T an = ref_sqnorm<T, D>(ref, row, dim);
  const size_t out = static_cast<size_t>(row) * k;
  if (splits == 1) {
    for (int e = lane; e < k; e += 32) {
      d2[out + e] = max_of(add_rn(part_s[out + e], an), T(0));
      idx[out + e] = part_i[out + e];
    }
    return;
  }
  const bool mine = lane < splits;
  const size_t base = (static_cast<size_t>(mine ? lane : 0) * R + row) * k;
  T hs = mine ? part_s[base] : inf<T>();
  int hi = mine ? part_i[base] : INT_MAX;
  T ns = mine && k > 1 ? part_s[base + 1] : inf<T>();
  int ni = mine && k > 1 ? part_i[base + 1] : INT_MAX;
  int cur = 0;
  T os = T(0);
  int oi = 0;
  for (int e = 0; e < k; ++e) {
    T bs = hs;
    int bi = hi, bl = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T xs = __shfl_xor_sync(0xffffffffu, bs, off);
      const int xi = __shfl_xor_sync(0xffffffffu, bi, off);
      const int xl = __shfl_xor_sync(0xffffffffu, bl, off);
      if (lex_less(xs, xi, bs, bi) || (!lex_less(bs, bi, xs, xi) && xl < bl)) {
        bs = xs;
        bi = xi;
        bl = xl;
      }
    }
    if (lane == e % 32) {
      os = bs;
      oi = bi;
    }
    if (lane == bl) {
      ++cur;
      hs = ns;
      hi = ni;
      ns = cur + 1 < k ? part_s[base + cur + 1] : inf<T>();
      ni = cur + 1 < k ? part_i[base + cur + 1] : INT_MAX;
    }
    if (e % 32 == 31 || e == k - 1) {
      const int e0 = e - e % 32;
      if (lane <= e % 32) {
        d2[out + e0 + lane] = max_of(add_rn(os, an), T(0));
        idx[out + e0 + lane] = oi;
      }
    }
  }
}

// How nnk_warp_scan runs R rows against N neighbours at k: the scanning
// warps a block (of those whose blocks fit, the count that lets the most
// scan on an SM, the most a block on a tie: each block streams every
// neighbour of its split once), the splits (the count whose waves of
// blocks, at the blocks an SM the kernel holds, cost least: a split of M
// neighbours costs a block its M scored and ~k (1 + ln(M / k)) candidates
// at kCandCost neighbours each; at most kMaxBigSplits and what
// kPartBudget holds, whole ring tiles), each split's tiles, and the
// dynamic shared memory; warps 0 where no block fits or a device query
// fails.
struct WarpPlan {
  int warps, splits, split_tiles;
  size_t smem;
};
constexpr double kCandCost = 64.0;

template <typename T, int D>
WarpPlan warp_plan(int R, int N, int k) {
  constexpr int RW = warp_rows<T>(), L = ring_len<T>();
  WarpPlan best{0, 0, 0, 0};
  int dev = 0, sms = 0, most = 0, per_sm = 0;
  if (R <= 0 || N <= 0 || k < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return best;
  for (int w = kMaxWarps; w >= 1; --w) {
    const size_t smem = warp_bytes<T, D>(w * RW, w, k);
    int n = 0;
    if (smem > static_cast<size_t>(INT_MAX) ||
        cudaFuncSetAttribute(nnk_warp_scan<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, nnk_warp_scan<T, D>, 32 * (w + 1), smem) != cudaSuccess) {
      (void)cudaGetLastError();  // a block this large does not fit
      continue;
    }
    if (n * w > most) {
      most = n * w;
      per_sm = n;
      best = WarpPlan{w, 0, 0, smem};
    }
  }
  if (most == 0) return best;
  const long long row_blocks = (R + best.warps * RW - 1) / (best.warps * RW);
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int tiles = (N + L - 1) / L;
  const size_t pair = sizeof(T) + sizeof(int);
  double best_cost = -1.0;
  for (int s = 1; s <= std::min(kMaxBigSplits, tiles); ++s) {
    const int per = (tiles + s - 1) / s;
    if ((tiles + per - 1) / per != s) continue;  // as the tiles cut
    if (s > 1 && static_cast<size_t>(s) * R * k * pair > kPartBudget) break;
    const double M = static_cast<double>(per) * L;
    const double cand = M > k ? k * (1.0 + std::log(M / k)) : M;
    const long long waves = (row_blocks * s + slots - 1) / slots;
    const double cost = static_cast<double>(waves) * (M + kCandCost * cand);
    if (best_cost < 0.0 || cost < best_cost) {
      best_cost = cost;
      best.splits = s;
      best.split_tiles = per;
    }
  }
  return best;
}

// Bytes of the ring tiles the pre-pass writes for N neighbours.
template <typename T, int D>
size_t warp_tile_bytes(int N) {
  return static_cast<size_t>((N + ring_len<T>() - 1) / ring_len<T>()) *
         sizeof(RingTile<T, D>);
}

// The pre-pass into `scratch` (warp_tile_bytes), the warp merge scan on
// `splits` splits (warp_plan's), and past one split the merge of their
// lists.
template <typename T, int D>
cudaError_t launch_nnk_warp(const T* ref, const T* nbr, int R, int N, int k,
                            int splits, void* scratch, T* part_s,
                            int* part_i, T* d2, long long* idx,
                            cudaStream_t stream) {
  const WarpPlan p = warp_plan<T, D>(R, N, k);
  if (p.warps < 1 || splits != p.splits || scratch == nullptr ||
      (splits > 1 && (part_s == nullptr || part_i == nullptr)))
    return cudaErrorInvalidValue;
  auto* tiles = static_cast<RingTile<T, D>*>(scratch);
  const int n_tiles = (N + ring_len<T>() - 1) / ring_len<T>();
  warp_tiles<T, D><<<(n_tiles * ring_len<T>() + 255) / 256, 256, 0, stream>>>(
      nbr, N, n_tiles, tiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(nnk_warp_scan<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(p.smem));
  if (e != cudaSuccess) return e;
  const int rows = p.warps * warp_rows<T>();
  const dim3 grid((R + rows - 1) / rows, splits);
  nnk_warp_scan<T, D><<<grid, 32 * (p.warps + 1), p.smem, stream>>>(
      ref, tiles, R, N, k, p.split_tiles, part_s, part_i, d2, idx);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  nnk_merge_big<T, D><<<(R + 7) / 8, 256, 0, stream>>>(
      ref, R, D, k, splits, part_s, part_i, d2, idx);
  return cudaGetLastError();
}

// warp_plan's splits, and the pre-pass's scratch bytes, for D coordinates
// (0 where no plan fits).
template <typename T>
int warp_splits(int R, int N, int D, int k) {
  WarpPlan (*plan[kMaxDim])(int, int, int) = {
      warp_plan<T, 1>, warp_plan<T, 2>, warp_plan<T, 3>, warp_plan<T, 4>,
      warp_plan<T, 5>, warp_plan<T, 6>, warp_plan<T, 7>, warp_plan<T, 8>};
  const WarpPlan p = plan[D - 1](R, N, k);
  return p.warps < 1 ? 0 : p.splits;
}
template <typename T>
size_t warp_scratch(int N, int D) {
  size_t (*bytes[kMaxDim])(int) = {
      warp_tile_bytes<T, 1>, warp_tile_bytes<T, 2>, warp_tile_bytes<T, 3>,
      warp_tile_bytes<T, 4>, warp_tile_bytes<T, 5>, warp_tile_bytes<T, 6>,
      warp_tile_bytes<T, 7>, warp_tile_bytes<T, 8>};
  return bytes[D - 1](N);
}

// ---- k >= kSelectK and k = N, D <= 8: select, then sort ------------------

// The least k that takes the select-then-sort path (the crossovers
// measured by probes/knn_probes.py --crossover, PERF.md; k = N takes it
// at any k): the register-tiled family (D <= 8) past kSmallR rows
// (measured on ICP's 100,000^2 at D = 3: float32 from 320, float64 from
// 384), and at most kSmallR rows (measured at 10,000 rows: float32 from
// 320 against 100,000 neighbours, float64 from 448 on [knn-d6]'s
// 10,000^2, D = 6); the float32 wide family (D > 8; measured on FPFH-like
// 50,000^2, D = 33, and SIFT-like 20,000 x 100,000, D = 128: 256 at both).
constexpr int kSelectK = 320;
constexpr int kSelectK64 = 384;
constexpr int kSelectKSmallR = 320;
constexpr int kSelectKSmallR64 = 448;
constexpr int kSmallR = 32768;    // between the measured 10,000 and 100,000
constexpr int kWideSelectK = 256;
// the float64 wide family (D > 8, k > 16), by width: up to kShortDim64
// coordinates (measured on FPFH-like 10,000^2, D = 33: the merge scan
// wins at 32, the select path from 48) and past them (SIFT-like 10,000 x
// 20,000, D = 128: at 128, from 192); a pass's products grow with D, the
// merge scan's merges do not
constexpr int kWideSelectK64 = 48;
constexpr int kWideSelectK64Long = 192;
constexpr int kShortDim64 = 64;
constexpr int kSelRows = 128;       // rows an emission block, one a thread
constexpr int kCountRT = 2;         // rows a lane of a counting block
constexpr int kCountRows = 32 * kCountRT;  // rows a counting block
constexpr int kBins = 256;          // a digit: 8 bits of the (key, index)
// a row's counters in shared memory: two 16-bit counts a word, and a word
// of padding (row r's word w on bank (r + w) % 32)
constexpr int kHistStride = kBins / 2 + 1;
// neighbours a counting split, most (a 16-bit count never carries), and
// least where the splits are many
constexpr int kMaxSelChunk = 65504;
constexpr int kMinSelChunk = 4096;
constexpr int kSelBlocksPerSm = 24; // counting blocks a pass an SM, aim
// pairs of a row that share the threshold's bin and go to the boundary
// buffer, least (the sort's length: k - 1 + kMinBoundary) and most
constexpr int kMinBoundary = 256;
constexpr int kMaxBoundary = 512;
constexpr int kSortE = 8;           // pairs a sorting thread holds
constexpr int kSortMax = 8192;      // pairs one block sorts, most
constexpr int kMinSort = 64;        // and least: a layout's bits [3, 6)

// A row's mode: counting digits; done, the pairs in the prefix's bin
// complete its k; done, they go to the boundary buffer; counting the
// digit after a first digit guessed from a sample, and the pairs before
// that digit's bin, which sel_pick checks (the float32 wide family).
enum { kCounting = 0, kTakeAll = 1, kToBoundary = 2, kGuess = 3 };

// A pair's place in the (s, index) order: the key of s (its bits made an
// order-preserving unsigned: every bit flipped where s < 0, the sign bit
// where s >= 0; -0 made +0 first, as the order holds them equal; +inf
// last) and the index.  float32 packs both into one 64-bit word, key
// above; float64 keeps its 64-bit key beside the index.
struct Pair64 {
  unsigned long long k;
  unsigned int j, pad;
};

template <typename T> struct Sel;
template <> struct Sel<float> {
  using Key = unsigned int;
  using Pair = unsigned long long;
  __device__ static Key key(float s) {
    const unsigned u = __float_as_uint(__fadd_rn(s, 0.0f));
    return u ^ (static_cast<unsigned>(static_cast<int>(u) >> 31) |
                0x80000000u);
  }
  __device__ static float unkey(Key k) {
    return __uint_as_float(k & 0x80000000u ? k ^ 0x80000000u : ~k);
  }
  __device__ static float score(const Pair& p) {
    return unkey(static_cast<Key>(p >> 32));
  }
  __device__ static float below_zero() { return -CUDART_MIN_DENORM_F; }
  __device__ static Pair pair(Key k, unsigned j) {
    return (static_cast<Pair>(k) << 32) | j;
  }
  __device__ static long long index(const Pair& p) {
    return static_cast<unsigned>(p);
  }
  __device__ static Pair last() { return ~0ull; }
  __device__ static bool less(const Pair& a, const Pair& b) { return a < b; }
  // a pair kept in slot o of the outputs until the sort: idx's 8 bytes
  __device__ static void put(float*, long long* idx, size_t o, Pair p) {
    reinterpret_cast<Pair*>(idx)[o] = p;
  }
  __device__ static Pair get(const float*, const long long* idx, size_t o) {
    return reinterpret_cast<const Pair*>(idx)[o];
  }
};
template <> struct Sel<double> {
  using Key = unsigned long long;
  using Pair = Pair64;
  __device__ static Key key(double s) {
    const Key u = static_cast<Key>(__double_as_longlong(__dadd_rn(s, 0.0)));
    return u ^ (static_cast<Key>(static_cast<long long>(u) >> 63) |
                0x8000000000000000ull);
  }
  __device__ static double unkey(Key k) {
    return __longlong_as_double(static_cast<long long>(
        k >> 63 ? k ^ 0x8000000000000000ull : ~k));
  }
  __device__ static double score(const Pair& p) { return unkey(p.k); }
  __device__ static double below_zero() { return -CUDART_MIN_DENORM; }
  __device__ static Pair pair(Key k, unsigned j) { return Pair{k, j, 0u}; }
  __device__ static long long index(const Pair& p) { return p.j; }
  __device__ static Pair last() { return Pair{~0ull, ~0u, 0u}; }
  __device__ static bool less(const Pair& a, const Pair& b) {
    return a.k < b.k || (a.k == b.k && a.j < b.j);
  }
  // d2's 8 bytes hold the key, idx's the index
  __device__ static void put(double* d2, long long* idx, size_t o, Pair p) {
    reinterpret_cast<Key*>(d2)[o] = p.k;
    idx[o] = p.j;
  }
  __device__ static Pair get(const double* d2, const long long* idx,
                             size_t o) {
    return Pair{reinterpret_cast<const Key*>(d2)[o],
                static_cast<unsigned>(idx[o]), 0u};
  }
};

// A row's threshold so far: the prefix (the key's and the index's bits of
// the digits fixed, `level` of them, the key's first), the pairs before
// it and the pairs that share it.
template <typename K>
struct SelRow {
  K pk;
  unsigned pj;
  int level, below, count, mode;
};

// Index bits the index digits read: N - 1's, rounded up to whole digits.
int index_bits(int N) {
  int b = 8;
  while (b < 32 && (static_cast<unsigned>(N - 1) >> b)) b += 8;
  return b;
}
// The bits that `level` fixed digits fix: of the key, then of the index.
template <typename K>
__device__ __forceinline__ K key_mask(int level) {
  constexpr int kd = sizeof(K);
  const int l = min(level, kd);
  return l == 0 ? K(0) : ~K(0) << (8 * (kd - l));
}
__device__ __forceinline__ unsigned index_mask(int level, int kd,
                                               int ibits) {
  return level <= kd ? 0u : ~0u << (ibits - 8 * (level - kd));
}

// The pairs that share a row's prefix (its key's bits of `km` and its
// index's of `jm` fixed) as bounds the scores and indices can be held to
// without forming keys: s in [lo, hi], j in [jlo, jhi].  The key map is
// monotone, so a key range is a score range; past the keys of +-inf it
// is open; an upper bound of -0 (the key below 0's) becomes the least
// negative score, since s <= -0 would admit 0, whose key is above it.
template <typename T>
struct SelBounds {
  T lo, hi;
  unsigned jlo, jhi;
};

template <typename T, typename K>
__device__ __forceinline__ SelBounds<T> sel_bounds(K pk, unsigned pj,
                                                   int level, int ibits) {
  using S = Sel<T>;
  constexpr int kd = sizeof(K);
  const K km = key_mask<K>(level);
  const unsigned jm = index_mask(level, kd, ibits);
  const K top = pk | ~km;
  SelBounds<T> b;
  b.lo = pk <= S::key(-inf<T>()) ? -inf<T>() : S::unkey(pk);
  b.hi = top >= S::key(inf<T>()) ? inf<T>() : S::unkey(top);
  if (b.hi == T(0) && signbit(b.hi)) b.hi = S::below_zero();
  b.jlo = pj;
  b.jhi = pj | ~jm;
  return b;
}

// The scratch of the select path for R rows, N neighbours and k, and how
// its passes run: P pairs a row's sort (a power of 2), at most `cap`
// boundary pairs a row, `levels` counting passes at most; the offsets of
// the rows' states, global histograms [R, 256] (uint32), the emission's
// counts [R, 2] (int32), the boundary buffers [R, cap] and, past kSortMax,
// the rows' sort buffers [R, P] (pairs: 8 bytes in float32, 16 in
// float64).  k = N within one block's sort needs none of it where the
// sort scores its own pairs (`fused`: the register-tiled family).
struct SelPlan {
  long long P;
  int cap, ibits, levels;
  size_t st, hist, cnt, bnd, big, bytes;
};

template <typename T>
SelPlan sel_plan(int R, int N, int k, bool fused = true) {
  using S = Sel<T>;
  SelPlan p{};
  const long long want = k == N ? k : k - 1LL + kMinBoundary;
  p.P = kMinSort;
  while (p.P < want) p.P <<= 1;
  p.cap = k == N ? 0 : static_cast<int>(std::min<long long>(
                           kMaxBoundary, p.P - (k - 1)));
  p.ibits = index_bits(N);
  p.levels = k == N ? 0 : static_cast<int>(sizeof(typename S::Key)) +
                              p.ibits / 8;
  if (fused && k == N && p.P <= kSortMax) return p;
  size_t o = 0;
  const auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 255) / 256 * 256;
    return at;
  };
  const size_t rows = static_cast<size_t>(R);
  p.st = take(rows * sizeof(SelRow<typename S::Key>));
  p.hist = take(rows * kBins * sizeof(unsigned));
  p.cnt = take(rows * 2 * sizeof(int));
  p.bnd = take(rows * p.cap * sizeof(typename S::Pair));
  p.big = take(p.P > kSortMax ? rows * p.P * sizeof(typename S::Pair) : 0);
  p.bytes = o;
  return p;
}

// Splits of N neighbours for the counting and emission passes: about
// kSelBlocksPerSm blocks an SM in all, each split at most kMaxSelChunk
// neighbours and, where more would be wanted, at least kMinSelChunk; 0 on
// a device query failure.
int sel_splits(int R, int N, int* chunk) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const int row_blocks = (R + kCountRows - 1) / kCountRows;
  const int want = (kSelBlocksPerSm * sms + row_blocks - 1) / row_blocks;
  const int splits = std::max({1, (N + kMaxSelChunk - 1) / kMaxSelChunk,
                               std::min(want, N / kMinSelChunk)});
  *chunk = split_chunk(N, splits);
  return (N + *chunk - 1) / *chunk;
}

// Each row's state at the start: no digit fixed, all N pairs share the
// empty prefix (done at once where k = N, or N fits the boundary buffer);
// its histogram and counts zeroed.
template <typename K>
__global__ void sel_init(int R, int N, int k, int cap, SelRow<K>* st,
                         unsigned* hist, int* cnt) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t q0 = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  for (size_t q = q0; q < static_cast<size_t>(R) * kBins; q += stride)
    hist[q] = 0;
  for (size_t r = q0; r < static_cast<size_t>(R); r += stride) {
    st[r] = SelRow<K>{K(0), 0u, 0, 0, N,
                      k == N ? kTakeAll : N <= cap ? kToBoundary : kCounting};
    cnt[2 * r] = cnt[2 * r + 1] = 0;
  }
}

// One counting pass: each counting row's histogram of digit `level` (the
// key's 8 bits from the top, then the index's) over the pairs of its
// prefix, in the neighbours [split * chunk, + chunk).  A block holds
// kCountRows rows, kCountRT a lane (lane l of every warp rows l, l + 32,
// ...), and its four warps take a quarter of each staged tile each,
// scored as the scans score (the same staged tile, the same function,
// the same bits; one load of a neighbour serves the lane's rows); a pair
// outside its row's prefix bounds (sel_bounds) costs its score and two
// compares, a pair inside forms its key and digit and adds one to the
// row's counters in shared memory (two 16-bit counts a word), which the
// block adds to the row's global histogram after the split.  The
// counters of kCountRows rows take 33 KB, so several blocks share an SM.
// ByIndex: the digit is the index's (the key fixed); else the key's, and
// the index is not compared.  Blocks whose rows are all done leave at once.
template <typename T, int D, bool ByIndex>
__global__ void __launch_bounds__(kThreads)
sel_count(const T* __restrict__ ref, const T* __restrict__ nbr, int R,
          int N, int chunk, int level, int ibits,
          const SelRow<typename Sel<T>::Key>* __restrict__ st,
          unsigned* __restrict__ ghist) {
  using S = Sel<T>;
  using K = typename S::Key;
  constexpr int kd = sizeof(K);
  constexpr int kWarps = kThreads / 32;
  __shared__ Tile<T, D> tl;
  extern __shared__ unsigned hist[];  // kCountRows * kHistStride
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int row[kCountRT];
  bool live[kCountRT];
  bool any = false;
#pragma unroll
  for (int r = 0; r < kCountRT; ++r) {
    row[r] = blockIdx.x * kCountRows + lane + 32 * r;
    live[r] = row[r] < R && st[row[r]].mode == kCounting;
    any |= live[r];
  }
  if (!__syncthreads_or(any)) return;
  for (int w = threadIdx.x; w < kCountRows * kHistStride; w += kThreads)
    hist[w] = 0u;
  T a[kCountRT][D];
  SelBounds<T> bd[kCountRT];
#pragma unroll
  for (int r = 0; r < kCountRT; ++r) {
#pragma unroll
    for (int c = 0; c < D; ++c)
      a[r][c] = live[r] ? ref[static_cast<size_t>(row[r]) * D + c] : T(0);
    // a row that does not count keeps bounds no score meets
    bd[r] = live[r] ? sel_bounds<T, K>(st[row[r]].pk, st[row[r]].pj, level,
                                       ibits)
                    : SelBounds<T>{inf<T>(), -inf<T>(), 1u, 0u};
  }
  const int sh = ByIndex ? ibits - 8 * (level - kd + 1)
                        : 8 * (kd - 1 - level);
  const int j_begin = blockIdx.y * chunk;
  const int j_end = min(N, j_begin + chunk);
  for (int t0 = j_begin; t0 < j_end; t0 += tile_len<T>()) {
    const int n = min(tile_len<T>(), j_end - t0);
    const int n_pad = (n + 7) / 8 * 8;
    __syncthreads();  // the previous tile has been read
    stage<T, D>(nbr, t0, n, n_pad, tl);
    __syncthreads();
    if (!any) continue;
    // this warp's quarter of the tile, in batches of 8
    const int q = (n_pad / 8 + kWarps - 1) / kWarps * 8;
    const int s_end = min(n_pad, (warp + 1) * q);
    for (int s0 = warp * q; s0 < s_end; s0 += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = s0 + u;
        const Nbr<T> b = load<T, D>(tl, s);
        const unsigned j = t0 + s;
#pragma unroll
        for (int r = 0; r < kCountRT; ++r) {
          const T sc = score<T, D>(a[r], b);
          if (s < n && sc >= bd[r].lo && sc <= bd[r].hi &&
              (!ByIndex || (j >= bd[r].jlo && j <= bd[r].jhi))) {
            const unsigned d = (ByIndex ? j >> sh
                                        : static_cast<unsigned>(
                                              S::key(sc) >> sh)) &
                               (kBins - 1);
            atomicAdd(&hist[(lane + 32 * r) * kHistStride + (d >> 1)],
                      1u << ((d & 1u) * 16));
          }
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kCountRT; ++r) {
    if (!live[r]) continue;
    const unsigned* h = hist + (lane + 32 * r) * kHistStride;
    unsigned* g = ghist + static_cast<size_t>(row[r]) * kBins;
    for (int w = warp; w < kBins / 2; w += kWarps) {
      const unsigned v = h[w];
      if (v & 0xffffu) atomicAdd(&g[2 * w], v & 0xffffu);
      if (v >> 16) atomicAdd(&g[2 * w + 1], v >> 16);
    }
  }
}

// After counting pass `level`: each counting row's digit, the bin where
// its k-th pair falls (a warp a row, 8 bins a lane, a scan over lanes),
// fixed into its prefix; the row is done where that bin's pairs complete
// its k, or fit `cap`.  The histogram is zeroed for the next pass.  Counts
// are integers, the same in any order of the atomics: the threshold does
// not depend on the blocks' order.
// level < 0: each row's own level (the float32 wide family, whose rows
// may guess their first digit, below).  A guessing row (kGuess) takes its
// guess where the pairs before the guessed bin (`below` [R, 2]: the
// count in below[2 row], zeroed here) fall short of its k and those in it
// reach it, and then fixes its next digit as any row; else it starts over
// from no digit.
template <typename K>
__global__ void sel_pick(int R, int k, int level, int ibits, int cap,
                         SelRow<K>* st, unsigned* ghist,
                         int* below = nullptr) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= R) return;
  SelRow<K> r = st[row];
  if (r.mode != kCounting && r.mode != kGuess) return;
  if (level < 0) level = r.level;
  unsigned* g = ghist + static_cast<size_t>(row) * kBins;
  unsigned c[8], sum = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    c[e] = g[lane * 8 + e];
    sum += c[e];
  }
  unsigned inc = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  if (r.mode == kGuess) {
    const int b = below[2 * row];
    const unsigned in_bin = __shfl_sync(0xffffffffu, inc, 31);
    __syncwarp();
    if (lane == 0) below[2 * row] = 0;
    if (!(b < k && static_cast<unsigned>(k - b) <= in_bin)) {
#pragma unroll
      for (int e = 0; e < 8; ++e) g[lane * 8 + e] = 0u;
      if (lane == 0) st[row] = SelRow<K>{K(0), 0u, 0, 0, 0, kCounting};
      return;
    }
    r.below = b;
  }
  const unsigned need = static_cast<unsigned>(k - r.below);
  const unsigned excl = inc - sum;
  const unsigned owner =
      __ballot_sync(0xffffffffu, excl < need && need <= inc);
  if (!owner) __trap();  // the counts do not hold the row's k-th pair
  const int o = __ffs(owner) - 1;
  unsigned d = 0, before = 0, cnt = 0, acc = excl;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    if (lane == o && !cnt && acc + c[e] >= need) {
      d = lane * 8 + e;
      before = acc;
      cnt = c[e];
    }
    acc += c[e];
  }
  d = __shfl_sync(0xffffffffu, d, o);
  before = __shfl_sync(0xffffffffu, before, o);
  cnt = __shfl_sync(0xffffffffu, cnt, o);
#pragma unroll
  for (int e = 0; e < 8; ++e) g[lane * 8 + e] = 0u;
  if (lane == 0) {
    constexpr int kd = sizeof(K);
    if (level < kd)
      r.pk |= static_cast<K>(d) << (8 * (kd - 1 - level));
    else
      r.pj |= d << (ibits - 8 * (level - kd + 1));
    r.level = level + 1;
    r.below += static_cast<int>(before);
    r.count = static_cast<int>(cnt);
    r.mode = r.below + r.count == k ? kTakeAll
             : r.count <= cap       ? kToBoundary
                                    : kCounting;
    st[row] = r;
  }
}

// The emission: every pair before its row's prefix, and those that share
// it where they complete the k, into the row's slots of the outputs (as
// pairs, Sel<T>::put); the others that share it into the row's boundary
// buffer.  A pair is held to the prefix's bounds (sel_bounds), so most
// cost their score and two compares.  Slots come from atomics, in no
// order: the sort orders them.
template <typename T, int D>
__global__ void __launch_bounds__(kSelRows)
sel_emit(const T* __restrict__ ref, const T* __restrict__ nbr, int R, int N,
         int k, int chunk, int ibits, int cap,
         const SelRow<typename Sel<T>::Key>* __restrict__ st,
         int* __restrict__ cnt, typename Sel<T>::Pair* __restrict__ bnd,
         T* __restrict__ d2, long long* __restrict__ idx) {
  using S = Sel<T>;
  using K = typename S::Key;
  __shared__ Tile<T, D> tl;
  const int row = blockIdx.x * kSelRows + threadIdx.x;
  const bool live = row < R;
  const SelRow<K> r = live ? st[row] : SelRow<K>{};
  T a[D];
#pragma unroll
  for (int c = 0; c < D; ++c)
    a[c] = live ? ref[static_cast<size_t>(row) * D + c] : T(0);
  const SelBounds<T> bd = sel_bounds<T, K>(r.pk, r.pj, r.level, ibits);
  const bool take = r.mode == kTakeAll;
  int* oc = cnt + 2 * static_cast<size_t>(live ? row : 0);
  const size_t out0 = static_cast<size_t>(live ? row : 0) * k;
  typename S::Pair* b = bnd + static_cast<size_t>(live ? row : 0) * cap;
  const int j_begin = blockIdx.y * chunk;
  const int j_end = min(N, j_begin + chunk);
  for (int t0 = j_begin; t0 < j_end; t0 += tile_len<T>()) {
    const int n = min(tile_len<T>(), j_end - t0);
    const int n_pad = (n + 7) / 8 * 8;
    __syncthreads();  // the previous tile has been read
    stage<T, D>(nbr, t0, n, n_pad, tl);
    __syncthreads();
    if (!live) continue;
    for (int s0 = 0; s0 < n_pad; s0 += 8) {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int s = s0 + u;
        const T sc = score<T, D>(a, load<T, D>(tl, s));
        const unsigned j = t0 + s;
        // before the prefix: a lower score, or the prefix's score (index
        // digits fixed: lo = hi) at a lower index
        if (s < n && sc <= bd.hi && (sc < bd.lo || j <= bd.jhi)) {
          const bool before = sc < bd.lo || j < bd.jlo;
          if (before || take)
            S::put(d2, idx, out0 + atomicAdd(oc, 1), S::pair(S::key(sc), j));
          else
            b[atomicAdd(oc + 1, 1)] = S::pair(S::key(sc), j);
        }
      }
    }
  }
}

// ---- the sort: a bitonic network a block, pairs in registers --------------

// A block sorts Pb = kSortE * blockDim.x pairs, element i at shared-memory
// slot spos(i) (one padding slot every 16: no bank conflict in the
// layouts below).  Thread t holds kSortE elements, in layout b: b = 0, the
// blocked layout, i = t * kSortE + e; b >= 3, the elements whose bits
// [b, b + 3) are e and whose other bits are t's.  A step of stride 2^q
// runs in registers in the layout that holds bit q; the layouts change
// through shared memory, one barrier each: ~log2(Pb) / 3 + 1 a merge.
__device__ __forceinline__ int spos(int i) { return i + (i >> 4); }

__device__ __forceinline__ int lay_index(int t, int e, int b) {
  return b == 0 ? t * kSortE + e
                : (t & ((1 << b) - 1)) | (e << b) | ((t >> b) << (b + 3));
}

template <typename S, typename P>
__device__ __forceinline__ void lay_put(const P (&x)[kSortE], P* sh, int b) {
#pragma unroll
  for (int e = 0; e < kSortE; ++e)
    sh[spos(lay_index(threadIdx.x, e, b))] = x[e];
}

template <typename S, typename P>
__device__ __forceinline__ void lay_get(P (&x)[kSortE], const P* sh, int b) {
#pragma unroll
  for (int e = 0; e < kSortE; ++e)
    x[e] = sh[spos(lay_index(threadIdx.x, e, b))];
}

// Elements e and e + 2^q of layout b (i the first's index from `base`),
// in order: ascending where ((base + i) & s) == 0, as the bitonic network
// of the whole row sorts them at size s.
template <typename S, typename P>
__device__ __forceinline__ void cmpx(P (&x)[kSortE], int e, int q, int b,
                                     long long base, long long s) {
  P& lo = x[e];
  P& hi = x[e | (1 << q)];
  const bool up = ((base + lay_index(threadIdx.x, e, b)) & s) == 0;
  if (up ? S::less(hi, lo) : S::less(lo, hi)) {
    const P t = lo;
    lo = hi;
    hi = t;
  }
}

// The bitonic network's sizes s_from..s_to (powers of 2) over the block's
// Pb elements, element i being element base + i of its row; each size's
// strides from min(s, Pb) / 2 down to 1.  x holds the thread's elements
// in the blocked layout on entry and on return; sh is Pb + Pb / 16 slots.
template <typename S, typename P>
__device__ void bitonic(P (&x)[kSortE], P* sh, long long base,
                        long long s_from, long long s_to) {
  const long long half = static_cast<long long>(kSortE) * blockDim.x / 2;
  int lay = 0;
  for (long long s = s_from; s <= s_to; s <<= 1) {
    int cur = 63 - __clzll(min(s / 2, half));
    while (cur >= 3) {
      const int b = max(3, cur - 2);
      if (lay != b) {
        lay_put<S>(x, sh, lay);
        __syncthreads();
        lay_get<S>(x, sh, b);
        lay = b;
      }
#pragma unroll
      for (int q = 2; q >= 0; --q) {
        if (q > cur - b) continue;
#pragma unroll
        for (int e = 0; e < kSortE; ++e)
          if (!(e & (1 << q))) cmpx<S>(x, e, q, b, base, s);
      }
      cur = b - 1;
    }
    if (lay != 0) {
      lay_put<S>(x, sh, lay);
      __syncthreads();
      lay_get<S>(x, sh, 0);
      lay = 0;
    }
#pragma unroll
    for (int q = 2; q >= 0; --q) {
      if (q > cur) continue;
#pragma unroll
      for (int e = 0; e < kSortE; ++e)
        if (!(e & (1 << q))) cmpx<S>(x, e, q, 0, base, s);
    }
  }
}

// The block's sorted pairs [base, base + Pb) of row `row` (in sh) written
// where they are among the row's first k: d^2 = s + |a|^2 clamped at 0,
// and the index.
template <typename T>
__device__ void sel_finish(const typename Sel<T>::Pair* sh, const T* ref,
                           int dim, int row, int k, long long base, T* d2,
                           long long* idx) {
  using S = Sel<T>;
  const T an = ref_sqnorm<T, 0>(ref, row, dim);
  const int Pb = kSortE * blockDim.x;
  const size_t out = static_cast<size_t>(row) * k;
  for (int i = threadIdx.x; i < Pb && base + i < k; i += blockDim.x) {
    const typename S::Pair p = sh[spos(i)];
    d2[out + base + i] = max_of(add_rn(S::score(p), an), T(0));
    idx[out + base + i] = S::index(p);
  }
}

template <typename P>
size_t sort_smem(long long Pb) {
  return static_cast<size_t>(Pb + Pb / 16) * sizeof(P);
}

// k = N within one block (N <= kSortMax): a block a row scores its N
// pairs itself, a staged tile at a time (stage and score: the scans'
// bits), sorts them and writes them.  No select pass, no scratch.
template <typename T, int D>
__global__ void __launch_bounds__(kSortMax / kSortE)
sel_sort_all(const T* __restrict__ ref, const T* __restrict__ nbr, int N,
             T* __restrict__ d2, long long* __restrict__ idx) {
  using S = Sel<T>;
  using P = typename S::Pair;
  __shared__ Tile<T, D> tl;
  extern __shared__ __align__(16) unsigned char sel_sort_smem[];
  P* sh = reinterpret_cast<P*>(sel_sort_smem);
  const int row = blockIdx.x;
  const int Pb = kSortE * blockDim.x;
  T a[D];
#pragma unroll
  for (int c = 0; c < D; ++c) a[c] = ref[static_cast<size_t>(row) * D + c];
  for (int i = threadIdx.x; i < Pb; i += blockDim.x)
    if (i >= N) sh[spos(i)] = S::last();
  for (int t0 = 0; t0 < N; t0 += tile_len<T>()) {
    const int n = min(tile_len<T>(), N - t0);
    __syncthreads();  // the previous tile has been read
    stage<T, D>(nbr, t0, n, n, tl, blockDim.x);
    __syncthreads();
    for (int s = threadIdx.x; s < n; s += blockDim.x)
      sh[spos(t0 + s)] = S::pair(S::key(score<T, D>(a, load<T, D>(tl, s))),
                                 static_cast<unsigned>(t0 + s));
  }
  __syncthreads();
  P x[kSortE];
  lay_get<S>(x, sh, 0);
  bitonic<S>(x, sh, 0, 2, Pb);
  lay_put<S>(x, sh, 0);
  __syncthreads();
  sel_finish<T>(sh, ref, D, row, N, 0, d2, idx);
}

// The pair at position i of row `row`'s list after the emission: its
// `n_out` pairs in the outputs' slots, then its boundary pairs, then
// padding that sorts last.
template <typename T>
__device__ __forceinline__ typename Sel<T>::Pair sel_item(
    long long i, int n_out, int n_b, const T* d2, const long long* idx,
    const typename Sel<T>::Pair* bnd, int row, int k, int cap) {
  using S = Sel<T>;
  return i < n_out ? S::get(d2, idx, static_cast<size_t>(row) * k + i)
         : i < n_out + n_b
             ? bnd[static_cast<size_t>(row) * cap + (i - n_out)]
             : S::last();
}

// A block of Pb pairs of row blockIdx.x, pairs [base, base + Pb) with
// base = blockIdx.y * Pb: read from the emission's slots and boundary
// buffer (from_big = 0, one block a row) or the row's sort buffer; the
// network's sizes s_from..s_to; then the row's first k written as
// results (finish) or the pairs put back into the sort buffer.
template <typename T>
__global__ void __launch_bounds__(kSortMax / kSortE)
sel_sort(const T* __restrict__ ref, int dim, int k, int cap, long long P,
         const SelRow<typename Sel<T>::Key>* __restrict__ st,
         const int* __restrict__ cnt,
         const typename Sel<T>::Pair* __restrict__ bnd,
         typename Sel<T>::Pair* __restrict__ big, T* __restrict__ d2,
         long long* __restrict__ idx, long long s_from, long long s_to,
         int from_big, int finish) {
  using S = Sel<T>;
  using Pr = typename S::Pair;
  extern __shared__ __align__(16) unsigned char sel_sort_smem[];
  Pr* sh = reinterpret_cast<Pr*>(sel_sort_smem);
  const int row = blockIdx.x;
  const int Pb = kSortE * blockDim.x;
  const long long base = static_cast<long long>(blockIdx.y) * Pb;
  const size_t at = static_cast<size_t>(row) * P + base;
  if (from_big) {
    for (int i = threadIdx.x; i < Pb; i += blockDim.x)
      sh[spos(i)] = big[at + i];
  } else {
    const int n_out = cnt[2 * row];
    const int n_b = st[row].mode == kToBoundary ? cnt[2 * row + 1] : 0;
    for (int i = threadIdx.x; i < Pb; i += blockDim.x)
      sh[spos(i)] = sel_item<T>(i, n_out, n_b, d2, idx, bnd, row, k, cap);
  }
  __syncthreads();
  Pr x[kSortE];
  lay_get<S>(x, sh, 0);
  bitonic<S>(x, sh, base, s_from, s_to);
  lay_put<S>(x, sh, 0);
  __syncthreads();
  if (finish)
    sel_finish<T>(sh, ref, dim, row, k, base, d2, idx);
  else
    for (int i = threadIdx.x; i < Pb; i += blockDim.x)
      big[at + i] = sh[spos(i)];
}

// Past kSortMax: each row's list copied into its sort buffer of P pairs,
// padded with pairs that sort last.
template <typename T>
__global__ void sel_gather(int R, int k, int cap, long long P,
                           const SelRow<typename Sel<T>::Key>* st,
                           const int* cnt, const typename Sel<T>::Pair* bnd,
                           typename Sel<T>::Pair* big, const T* d2,
                           const long long* idx) {
  const size_t total = static_cast<size_t>(R) * P;
  for (size_t q = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       q < total; q += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int row = static_cast<int>(q / P);
    const int n_out = cnt[2 * row];
    const int n_b = st[row].mode == kToBoundary ? cnt[2 * row + 1] : 0;
    big[q] = sel_item<T>(static_cast<long long>(q % P), n_out, n_b, d2, idx,
                         bnd, row, k, cap);
  }
}

// One step of the network past a block's pairs: stride j >= kSortMax at
// size s, in the rows' sort buffers.
template <typename T>
__global__ void sel_step(typename Sel<T>::Pair* big, int R, long long P,
                         long long s, long long j) {
  using S = Sel<T>;
  const long long half = P / 2, total = static_cast<long long>(R) * half;
  for (long long q = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       q < total; q += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long i = q % half;
    const long long lo = i / j * 2 * j + i % j;
    typename S::Pair* b = big + q / half * P;
    const typename S::Pair x = b[lo], y = b[lo + j];
    if ((lo & s) == 0 ? S::less(y, x) : S::less(x, y)) {
      b[lo] = y;
      b[lo + j] = x;
    }
  }
}

// After the emission: one block a row sorts its pairs (past kSortMax,
// blocks of the row's tiles and network steps in global memory) and
// writes its first k.
template <typename T>
cudaError_t launch_sel_sort(const T* ref, int D, int R, int k,
                            const SelPlan& p,
                            const SelRow<typename Sel<T>::Key>* st,
                            const int* cnt, const typename Sel<T>::Pair* bnd,
                            typename Sel<T>::Pair* big, T* d2, long long* idx,
                            cudaStream_t stream) {
  using Pr = typename Sel<T>::Pair;
  const long long Pb = std::min<long long>(p.P, kSortMax);
  const size_t smem = sort_smem<Pr>(Pb);
  cudaError_t e = cudaFuncSetAttribute(
      sel_sort<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int threads = static_cast<int>(Pb / kSortE);
  if (p.P <= kSortMax) {
    sel_sort<T><<<dim3(R, 1), threads, smem, stream>>>(
        ref, D, k, p.cap, p.P, st, cnt, bnd, big, d2, idx, 2, p.P, 0, 1);
    return cudaGetLastError();
  }
  const dim3 tiles(R, static_cast<unsigned>(p.P / kSortMax));
  const int blocks = static_cast<int>(std::min<long long>(
      65535, (static_cast<long long>(R) * p.P / 2 + 255) / 256));
  sel_gather<T><<<blocks, 256, 0, stream>>>(R, k, p.cap, p.P, st, cnt, bnd,
                                            big, d2, idx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  sel_sort<T><<<tiles, threads, smem, stream>>>(
      ref, D, k, p.cap, p.P, st, cnt, bnd, big, d2, idx, 2, kSortMax, 1, 0);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  for (long long s = 2LL * kSortMax; s <= p.P; s <<= 1) {
    for (long long j = s / 2; j >= kSortMax; j >>= 1) {
      sel_step<T><<<blocks, 256, 0, stream>>>(big, R, p.P, s, j);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
    sel_sort<T><<<tiles, threads, smem, stream>>>(
        ref, D, k, p.cap, p.P, st, cnt, bnd, big, d2, idx, s, s, 1,
        s == p.P);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// k >= kSelectK or k = N: select, then sort.  The counting passes fix the
// (key, index) threshold of each row digit by digit until the pairs in
// its bin complete its k or fit its boundary buffer; the emission writes
// the row's pairs before it, and the bin's, once; one block a row sorts
// them (past kSortMax, blocks of the row's tiles and network steps in
// global memory).  k = N within a block: the sort alone, scoring its own
// pairs.
template <typename T, int D>
cudaError_t launch_nnk_select(const T* ref, const T* nbr, int R, int N,
                              int k, void* scratch, T* d2, long long* idx,
                              cudaStream_t stream) {
  using S = Sel<T>;
  using K = typename S::Key;
  using Pr = typename S::Pair;
  const SelPlan p = sel_plan<T>(R, N, k);
  cudaError_t e;
  if (k == N && p.P <= kSortMax) {
    const size_t smem = sort_smem<Pr>(p.P);
    e = cudaFuncSetAttribute(sel_sort_all<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    sel_sort_all<T, D><<<R, static_cast<int>(p.P / kSortE), smem, stream>>>(
        ref, nbr, N, d2, idx);
    return cudaGetLastError();
  }
  if (scratch == nullptr) return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  auto* st = reinterpret_cast<SelRow<K>*>(base + p.st);
  auto* hist = reinterpret_cast<unsigned*>(base + p.hist);
  auto* cnt = reinterpret_cast<int*>(base + p.cnt);
  auto* bnd = reinterpret_cast<Pr*>(base + p.bnd);
  auto* big = reinterpret_cast<Pr*>(base + p.big);
  int chunk = 0;
  const int splits = sel_splits(R, N, &chunk);
  if (splits < 1) return cudaErrorInvalidValue;
  const dim3 grid((R + kSelRows - 1) / kSelRows, splits);
  const dim3 count_grid((R + kCountRows - 1) / kCountRows, splits);
  const int fill = static_cast<int>(std::min<size_t>(
      65535, (static_cast<size_t>(R) * kBins + 255) / 256));
  sel_init<K><<<fill, 256, 0, stream>>>(R, N, k, p.cap, st, hist, cnt);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t hist_smem = sizeof(unsigned) * kCountRows * kHistStride;
  for (auto* count : {sel_count<T, D, false>, sel_count<T, D, true>}) {
    e = cudaFuncSetAttribute(count,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(hist_smem));
    if (e != cudaSuccess) return e;
  }
  for (int level = 0; level < p.levels; ++level) {
    auto* count = level < static_cast<int>(sizeof(K))
                      ? sel_count<T, D, false>
                      : sel_count<T, D, true>;
    count<<<count_grid, kThreads, hist_smem, stream>>>(
        ref, nbr, R, N, chunk, level, p.ibits, st, hist);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    sel_pick<K><<<(R + 7) / 8, 256, 0, stream>>>(R, k, level, p.ibits,
                                                 p.cap, st, hist);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  sel_emit<T, D><<<grid, kSelRows, 0, stream>>>(
      ref, nbr, R, N, k, chunk, p.ibits, p.cap, st, cnt, bnd, d2, idx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_sel_sort<T>(ref, D, R, k, p, st, cnt, bnd, big, d2, idx,
                            stream);
}

// The crossover k of nnk's register-tiled family (D <= 8) for R rows,
// and whether a call takes the select path.
int select_k(int R, bool f64) {
  return R <= kSmallR ? (f64 ? kSelectKSmallR64 : kSelectKSmallR)
                      : f64 ? kSelectK64 : kSelectK;
}
bool takes_select(int R, int N, int k, bool f64) {
  return k >= select_k(R, f64) || k == N;
}

template <typename T, int D>
cudaError_t launch_nnk(const T* ref, const T* nbr, int R, int N, int k,
                       int splits, void* scratch, T* part_s, int* part_i,
                       T* d2, long long* idx, cudaStream_t stream) {
  if (takes_select(R, N, k, sizeof(T) == sizeof(double)))
    return launch_nnk_select<T, D>(ref, nbr, R, N, k, scratch, d2, idx,
                                   stream);
  if (k > kMaxK)
    return launch_nnk_warp<T, D>(ref, nbr, R, N, k, splits, scratch,
                                 part_s, part_i, d2, idx, stream);
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

// The wide families (below): on the tensor cores through `scratch` at
// every k, float32 in three-pass TF32, float64 on DMMA.
template <typename T>
cudaError_t launch_nnk_wide(const T* ref, const T* nbr, int R, int N, int D,
                            int k, int splits, void* scratch, T* part_s,
                            int* part_i, T* d2, long long* idx,
                            cudaStream_t stream, bool merge = false);

template <typename T>
cudaError_t nnk_any(const void* ref, const void* nbr, int R, int N, int D,
                    int k, int splits, void* scratch, void* part_s,
                    int* part_i, void* d2, long long* idx,
                    cudaStream_t stream) {
  if (D > kMaxDim)
    return launch_nnk_wide(
        static_cast<const T*>(ref), static_cast<const T*>(nbr), R, N, D, k,
        splits, scratch, static_cast<T*>(part_s), part_i,
        static_cast<T*>(d2), idx, stream);
  cudaError_t (*launch[kMaxDim])(const T*, const T*, int, int, int, int,
                                 void*, T*, int*, T*, long long*,
                                 cudaStream_t) = {
      launch_nnk<T, 1>, launch_nnk<T, 2>, launch_nnk<T, 3>, launch_nnk<T, 4>,
      launch_nnk<T, 5>, launch_nnk<T, 6>, launch_nnk<T, 7>, launch_nnk<T, 8>};
  return launch[D - 1](static_cast<const T*>(ref), static_cast<const T*>(nbr),
                       R, N, k, splits, scratch, static_cast<T*>(part_s),
                       part_i, static_cast<T*>(d2), idx, stream);
}

// ---- D > 8: the wide scans on the tensor cores ------------------------------
// float32 at every k in three-pass TF32 (wgmma); float64 past k = 16 on
// the FP64 tensor cores (DMMA, mma.sync)

constexpr int kPanel = 64;          // rows a panel: a warpgroup's rows, a tile
constexpr int kGroups = 2;          // consumer warpgroups a block
constexpr int kTcRows = kPanel * kGroups;       // reference rows a block
constexpr int kTcThreads = 128 * kGroups + 32;  // and one producer warp
static_assert(128 * kGroups == 256, "kConsumers below assumes two groups");
constexpr int kTcChunk = 64;        // coordinates a stage holds, most
constexpr int kBlockDim = 32;       // coordinates a fresh sum, 40 at most
constexpr int kMaxStages = 8;       // stages a ring, most (a block a stage)
constexpr int kMaxChunkStages = 4;  // and a chunk a stage
constexpr int kResidentDim = 128;   // padded D up to which rows stay resident
constexpr int kBarBytes = 256;      // the mbarriers, at the head of the smem
constexpr int kMinTcSplitTiles = 8; // tiles a split, least
// bytes a coordinate of a panel's 64 rows takes in both types: a float32
// coordinate's hi and lo words, a float64 coordinate's value
constexpr int kCoordBytes = 512;

// The layout of one panel of 64 rows (tf32_split writes it, the stages
// receive it as it is): for each chunk c of kc = min(64, Dp - 64 c)
// coordinates, at 128 * 64 c floats, the hi words and then the lo words,
// each as kc / 8 k-steps of [64 rows][8 coordinates] in wgmma's K-major
// 32-byte swizzle (row r's 32 bytes at 32 r, its two 16-byte halves
// swapped where bit 2 of r is set, so that a k-step's rows read from
// distinct banks); then 64 floats of |row|^2.  Float64 (f64_panels): the
// same bytes a chunk, the values as Dp / 8 k-steps of [64 rows][8
// coordinates], then 64 doubles of |row|^2.
__host__ __device__ constexpr size_t panel_floats(int Dp) {
  return 2 * static_cast<size_t>(kPanel) * Dp + kPanel;
}
template <typename T>
__host__ __device__ constexpr size_t panel_bytes(int Dp) {
  return static_cast<size_t>(kCoordBytes) * Dp + kPanel * sizeof(T);
}
__host__ __device__ constexpr int chunk_dim(int Dp, int c) {
  return Dp - kTcChunk * c < kTcChunk ? Dp - kTcChunk * c : kTcChunk;
}

__device__ __forceinline__ float tf32_rna(float x) {
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// Splits rows [0, panels * 64) of x [n, D] (zero past n and past D) into
// the panels above; |row|^2 is the FMA chain from the first coordinate
// (ref_sqnorm's: in float64 past kLongNorm coordinates), +inf past n.
// One thread a row.
__global__ void tf32_split(const float* __restrict__ x, int n, int D, int Dp,
                           int panels, float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= panels * kPanel) return;
  const int r = row % kPanel;
  float* panel = out + static_cast<size_t>(row / kPanel) * panel_floats(Dp);
  const float* src = x + static_cast<size_t>(row) * D;
  const bool live = row < n;
  float sq = 0.f;
  double sq64 = 0.0;
  for (int g = 0; g < Dp / 4; ++g) {
    float v[4], hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * g + e;
      v[e] = live && c < D ? src[c] : 0.f;
      sq = c == 0 ? __fmul_rn(v[e], v[e]) : __fmaf_rn(v[e], v[e], sq);
      sq64 = __fma_rn(static_cast<double>(v[e]), static_cast<double>(v[e]),
                      sq64);
      hi[e] = tf32_rna(v[e]);
      lo[e] = tf32_rna(__fsub_rn(v[e], hi[e]));
    }
    const int c = g / (kTcChunk / 4), kc = chunk_dim(Dp, c);
    float4* h = reinterpret_cast<float4*>(panel + 2 * kPanel * kTcChunk * c);
    float4* l = h + kPanel * kc / 4;
    const int o = (g % (kTcChunk / 4)) / 2 * 2 * kPanel + 2 * r +
                  ((g % 2) ^ ((r >> 2) & 1));
    h[o] = make_float4(hi[0], hi[1], hi[2], hi[3]);
    l[o] = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
  panel[2 * kPanel * Dp + r] =
      !live ? CUDART_INF_F : D > kLongNorm ? static_cast<float>(sq64) : sq;
}

// Lays rows [0, panels * 64) of float64 x [n, D] (zero past n and past D)
// out in the DMMA scan's panels: each k-step's row holds its 8 coordinates
// in the order 0 4 1 5 2 6 3 7, so that the thread of an mma's k-column t
// reads coordinates t and t + 4 by one 16-byte load (a quarter-warp's
// eight loads: two rows' 128 contiguous bytes, no bank conflict); |row|^2
// is the FMA chain from the first coordinate, +inf past n.  One thread a
// row.
__global__ void f64_panels(const double* __restrict__ x, int n, int D, int Dp,
                           int panels, double* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= panels * kPanel) return;
  const int r = row % kPanel;
  double* panel = out + static_cast<size_t>(row / kPanel) *
                            (panel_bytes<double>(Dp) / sizeof(double));
  const double* src = x + static_cast<size_t>(row) * D;
  const bool live = row < n;
  double sq = 0.0;
  for (int j = 0; j < Dp / 8; ++j) {
    double v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = 8 * j + e;
      v[e] = live && c < D ? src[c] : 0.0;
      sq = c == 0 ? __dmul_rn(v[e], v[e]) : __fma_rn(v[e], v[e], sq);
    }
    double2* o = reinterpret_cast<double2*>(panel + kPanel * 8 * j + 8 * r);
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = make_double2(v[u], v[u + 4]);
  }
  panel[kPanel * Dp + r] = live ? sq : CUDART_INF;
}

// wgmma's descriptor of a k-step of a panel in shared memory (256-byte
// aligned): K-major, 32-byte swizzle (layout type 3), groups of 8 rows 256
// bytes apart (the stride byte offset; the leading one is unused).
__device__ __forceinline__ uint64_t operand_desc(const float* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         uint64_t{1} << 16 | static_cast<uint64_t>(256 >> 4) << 32 |
         uint64_t{3} << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving accumulator accesses across a wgmma fence
// or wait
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d = A B^T (+ d if accumulate) for a 64 x 8 A and a 64 x 8 B (64
// neighbours), TF32 in, float32 accumulators in wgmma's layout.
__device__ __forceinline__ void wgmma_64x64x8(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// The DMMA scan's products.  Hopper has no float64 wgmma, so each warp of
// a consumer warpgroup forms its 16 rows x 64 neighbours by
// mma.sync.m16n8k8, as eight column slices of 8: an m16n8 accumulator puts
// rows g and g + 8, columns 2t and 2t + 1 of its slice on thread 4g + t,
// the layout that wgmma.m64n64 gives each warp of a warpgroup, so every
// selection mode reads either.  Alone m16n8k4, m16n8k8 and m16n8k16 run at
// 66.1-66.4 TFLOP/s (m8n8k4 at 33.3; probes/dmma_rate.cu); in the scan
// m16n8k8 took the least time (PERF.md).
__device__ __forceinline__ void dmma_m16n8k8(double* d, double a0, double a1,
                                             double a2, double a3, double b0,
                                             double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// d += the products of a stage unit's `steps` k-steps of 8 coordinates: a
// the warpgroup's 64 rows, b the tile's 64 neighbours, each k-step
// [64][8] doubles in f64_panels' order; warp w's rows 16 w + g (+ 8), and
// column slice n's neighbour 8 n + g, each at coordinates (t, t + 4) of
// the k-step; k-steps in ascending order.  Operands by 16-byte loads (no
// 64-bit ldmatrix exists).
__device__ __forceinline__ void dmma_unit(double (&d)[32],
                                          const double* __restrict__ a,
                                          const double* __restrict__ b,
                                          int steps, int w, int lane) {
  constexpr int kStep = kPanel * 8;  // doubles a k-step
  const double* ar = a + 8 * (16 * w + lane / 4) + 2 * (lane % 4);
  const double* br = b + 8 * (lane / 4) + 2 * (lane % 4);
  __syncwarp();  // mma.sync is .aligned: the warp's lanes together
  // rolled: unrolled, ptxas spilled every float64 mode (40-652 bytes)
#pragma unroll 1
  for (int j = 0; j < steps; ++j) {
    const double2 x0 = *reinterpret_cast<const double2*>(ar + kStep * j);
    const double2 x1 = *reinterpret_cast<const double2*>(ar + kStep * j + 64);
    double2 y[8];
#pragma unroll
    for (int n = 0; n < 8; ++n)
      y[n] = *reinterpret_cast<const double2*>(br + kStep * j + 64 * n);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      dmma_m16n8k8(d + 4 * n, x0.x, x1.x, x0.y, x1.y, y[n].x, y[n].y);
  }
}

// The two scores a thread reads of |b|^2: a float2, or its float64 peer.
template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// insert<K> in (s, index) order, for lists whose indices interleave
template <int K, typename T>
__device__ __forceinline__ void insert_lex(T d, int j, T* v, int* id) {
  if (!lex_less(d, j, v[K - 1], id[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (lex_less(d, j, v[s - 1], id[s - 1])) {
      v[s] = v[s - 1];
      id[s] = id[s - 1];
    } else if (lex_less(d, j, v[s], id[s])) {
      v[s] = d;
      id[s] = j;
    }
  }
  if (lex_less(d, j, v[0], id[0])) {
    v[0] = d;
    id[0] = j;
  }
}

// Whether the tensor-core scan of mode K keeps its consumers' K-lists in
// shared memory: float64 from K = 4, whose 2 x K pairs a thread do not fit
// beside the 32 float64 accumulators and the DMMA operands in the 168
// registers a thread of 9 warps gets (ptxas spilled 60-652 bytes).
// Entry e of row h of consumer thread t sits at (h K + e) kConsumers + t.
constexpr int kConsumers = 128 * 2;  // consumer threads a block (kGroups)
template <typename T, int K>
__host__ __device__ constexpr bool smem_lists() {
  return sizeof(T) == sizeof(double) && K >= 4;
}

// insert<K> on a list whose entries lie `stride` apart
template <int K, typename T>
__device__ __forceinline__ void insert_strided(T d, int j, T* v, int* id,
                                               int stride) {
  if (!(d < v[(K - 1) * stride])) return;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    const T prev = v[(s - 1) * stride];
    if (d < prev) {
      v[s * stride] = prev;
      id[s * stride] = id[(s - 1) * stride];
    } else if (d < v[s * stride]) {
      v[s * stride] = d;
      id[s * stride] = j;
    }
  }
  if (d < v[0]) {
    v[0] = d;
    id[0] = j;
  }
}

// How a call of the tensor-core scans is cut: Dp coordinates in chunks;
// the block's rows resident or streamed with each stage; a stage's unit,
// a chunk of up to 64 coordinates or one block of a fresh sum (32, or 40
// where 8 are left: `blocks`), whose widest is unit_max; the ring's stages
// (as many as fit beside `extra` bytes after the ring, at most
// max_stages) and the dynamic shared memory.
struct TcPlan {
  int Dp, resident, blocks, unit_max, stages, tiles, row_panels;
  size_t pb, smem;  // a panel's bytes, the dynamic shared memory's
};

// The end of the fresh sum's block of coordinates that starts at k0 in a
// chunk of kc: 32 on, or the chunk's end where at most 40 are left.
__host__ __device__ __forceinline__ int block_end(int kc, int k0) {
  return kc - k0 <= kBlockDim + 8 ? kc : k0 + kBlockDim;
}

// The end of the stage unit that starts at u0 in a chunk of kc: the
// chunk's, or the block's.
__host__ __device__ __forceinline__ int unit_end(int kc, int u0,
                                                 int blocks) {
  return blocks ? block_end(kc, u0) : kc;
}

int unit_dim_max(int Dp, int blocks) {
  int m = 0;
  for (int c = 0; kTcChunk * c < Dp; ++c) {
    const int kc = chunk_dim(Dp, c);
    for (int u0 = 0, u1; u0 < kc; u0 = u1) {
      u1 = unit_end(kc, u0, blocks);
      m = std::max(m, u1 - u0);
    }
  }
  return m;
}

template <typename T>
TcPlan tc_plan(int R, int N, int D, int smem_max, int max_stages,
               size_t extra = 0, int resident = 1, int blocks = 0) {
  TcPlan p;
  p.Dp = (D + 7) / 8 * 8;
  p.resident = resident && p.Dp <= kResidentDim;
  p.blocks = blocks;
  p.unit_max = unit_dim_max(p.Dp, blocks);
  p.tiles = (N + kPanel - 1) / kPanel;
  p.row_panels = kGroups * ((R + kTcRows - 1) / kTcRows);
  p.pb = panel_bytes<T>(p.Dp);
  // a stage: a tile's unit (hi, lo; float64: the values) and its |b|^2;
  // streamed rows: the block's two panels' unit too (the same bytes in
  // both types but the 64 norms)
  const size_t u = p.unit_max;
  const size_t stage = kCoordBytes * u + kPanel * sizeof(T) +
                       (p.resident ? 0 : kGroups * kCoordBytes * u);
  // and 256 bytes to align the base
  const size_t fixed = 256 + kBarBytes + (p.resident ? kGroups * p.pb : 0) +
                       extra;
  const size_t fit = static_cast<size_t>(smem_max) > fixed
                         ? (smem_max - fixed) / stage : 0;
  p.stages = static_cast<int>(std::min<size_t>(max_stages, fit));
  p.smem = fixed + stage * p.stages;
  return p;
}

// The select path's arguments of the tensor-core scan in its counting and
// emission modes (launch_nnk_wide_select): the rows' states, their global
// histograms [R, 256], the emission's counts [R, 2], the boundary buffers
// [R, cap], the outputs (whose slots hold the pairs until the sort,
// Sel<T>::put) and k.
template <typename T>
struct TcSelect {
  const SelRow<typename Sel<T>::Key>* st;
  unsigned* hist;
  int* cnt;
  typename Sel<T>::Pair* bnd;
  T* d2;
  long long* idx;
  int ibits, cap, k;
};

// wide_tc_scan's K past the lists: the select path's counting passes (a
// digit of each counting row, at the row's own level: of the key, then of
// the index) and its emission.
constexpr int kCount = -1;
constexpr int kEmit = -2;

// The scan of nn1 (K = 1), nnk (K the list length, kBig past 16) or the
// select path's passes (kCount, kEmit) on the tensor cores: rows
// [128 blockIdx.x, + 128) against every tile_step-th tile of
// [split_tiles blockIdx.y, + split_tiles), each row's best into part_s /
// part_i [splits, k, R]
// (nn1: [splits, R]; kBig: [splits, R, k]), or its counts into
// sel.hist, or its pairs into the outputs' slots.  Threads 0-255: two
// consumer warpgroups; warp 8: the producer.  Every mode scores a pair
// with the same products in the same order, so every mode sees the same
// s.  T: float32 (three-pass TF32 wgmma from the split panels) or float64
// (DMMA from f64_panels), every K; the products are the only part that
// differs.
template <typename T, int K>
__global__ void __launch_bounds__(kTcThreads, 1)
wide_tc_scan(const unsigned char* __restrict__ ref_pan,
             const unsigned char* __restrict__ nbr_pan, int R, int Dp,
             int resident, int blocks, int unit_max, int stages, int tiles,
             int split_tiles, int tile_step, int k,
             T* __restrict__ part_s, int* __restrict__ part_i, int N,
             TcSelect<T> sel) {
  using S = Sel<T>;
  using Key = typename S::Key;
  constexpr bool kF64 = sizeof(T) == sizeof(double);
  constexpr int kd = sizeof(Key);  // the key's digits
  constexpr bool kCounts = K == kCount;
  extern __shared__ __align__(256) unsigned char smem_raw[];
  if constexpr (kCounts) {
    // blocks whose rows all have their threshold leave at once
    const int row = kTcRows * blockIdx.x + threadIdx.x;
    const bool live = threadIdx.x < kTcRows && row < R &&
                      (sel.st[row].mode == kCounting ||
                       sel.st[row].mode == kGuess);
    if (!__syncthreads_or(live)) return;
  }
  // the swizzle pattern repeats every 256 bytes of shared address
  unsigned char* smem = smem_raw + (256 - smem_addr(smem_raw) % 256) % 256;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint64_t* rows_in = empty + kMaxStages;
  const size_t pb = panel_bytes<T>(Dp);
  const int chunks = (Dp + kTcChunk - 1) / kTcChunk;
  unsigned char* rows = smem + kBarBytes;
  unsigned char* ring = rows + (resident ? kGroups * pb : 0);
  // a stage: the tile's unit and |b|^2, then (streamed) the rows' unit
  const size_t b_bytes =
      static_cast<size_t>(kCoordBytes) * unit_max + kPanel * sizeof(T);
  const size_t stage_bytes =
      b_bytes +
      (resident ? 0 : static_cast<size_t>(kGroups) * kCoordBytes * unit_max);
  const int tile0 = blockIdx.y * split_tiles;
  const int tile1 = min(tiles, tile0 + split_tiles);
  const unsigned char* my_rows =
      ref_pan + static_cast<size_t>(kGroups) * blockIdx.x * pb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the warpgroup, by a shuffle so that ptxas sees it uniform: the role
  // branch below must not make the consumers' wgmmas divergent (C7520)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kGroups);
    }
    mbar_init(rows_in, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (role == kGroups) {
    // the producer: one thread keeps the ring full
    if (lane != 0) return;
    if (resident) {
      mbar_expect_tx(rows_in, kGroups * pb);
      bulk_load(rows, my_rows, kGroups * pb, rows_in);
    }
    int it = 0;
    for (int t = tile0; t < tile1; t += tile_step) {
      const unsigned char* tile = nbr_pan + static_cast<size_t>(t) * pb;
      for (int c = 0; c < chunks; ++c) {
        const int kc = chunk_dim(Dp, c);
        const size_t off = static_cast<size_t>(kCoordBytes) * kTcChunk * c;
        for (int u0 = 0, u1; u0 < kc; u0 = u1, ++it) {
          u1 = unit_end(kc, u0, blocks);
          const int kw = u1 - u0, s = it % stages;
          if (it >= stages) mbar_wait(&empty[s], ((it / stages) - 1) & 1);
          unsigned char* st = ring + s * stage_bytes;
          // the last unit (float32: its lo words) runs on into the
          // panel's |b|^2
          const bool last = c == chunks - 1 && u1 == kc;
          const uint32_t unit = kCoordBytes * kw;  // a panel's unit
          const uint32_t norms = last ? kPanel * sizeof(T) : 0;
          mbar_expect_tx(&full[s],
                         unit + norms + (resident ? 0 : kGroups * unit));
          if (kF64 || kw == kc) {
            // float64: a unit's k-steps are contiguous; float32: a whole
            // chunk's hi and lo are
            const size_t at = off + (kF64 ? kCoordBytes * u0 : 0);
            bulk_load(st, tile + at, unit + norms, &full[s]);
            if (!resident) {
              for (int g = 0; g < kGroups; ++g)
                bulk_load(st + b_bytes + g * unit, my_rows + g * pb + at,
                          unit, &full[s]);
            }
          } else {
            // a float32 block: its k-steps of the hi words, of the lo words
            const uint32_t half = unit / 2;
            const size_t hi = off + kCoordBytes / 2 * u0,
                         lo = hi + kCoordBytes / 2 * kc;
            bulk_load(st, tile + hi, half, &full[s]);
            bulk_load(st + half, tile + lo, half + norms, &full[s]);
            if (!resident) {
              for (int g = 0; g < kGroups; ++g) {
                unsigned char* a = st + b_bytes + g * unit;
                bulk_load(a, my_rows + g * pb + hi, half, &full[s]);
                bulk_load(a + half, my_rows + g * pb + lo, half, &full[s]);
              }
            }
          }
        }
      }
    }
    return;
  }

  // a consumer warpgroup g: rows 64 g + 16 w + lane / 4 (+ 8) of the block
  const int g = role, w = warp % 4, q = lane % 4;
  const int r0 = kTcRows * blockIdx.x + kPanel * g + 16 * w + lane / 4;
  // k > kMaxK: the block's buffers past the ring, the lists in part_s /
  // part_i; the state of each of this thread's rows (its list's length,
  // its buffer's count and its k-th pair), the same on the row's four
  // threads
  unsigned char* past_ring = ring + stages * stage_bytes;
  const BigLists<T> L(past_ring, kTcRows, k, part_s, part_i, R,
                      kTcRows * blockIdx.x);
  if constexpr (K == kBig) L.init();
  // the select path: the bounds of each of this thread's rows' prefix
  // (bounds no score meets where the row does not count or emit); in the
  // counting passes each row's digit (its shift, of the key or of the
  // index), whether it guesses, its pairs before the prefix so far, and
  // its counters past the ring (two 16-bit counts a word; a warp's 16
  // rows are its own)
  SelBounds<T> bd[2];
  bool take[2] = {false, false}, by_index[2] = {false, false};
  bool guess[2] = {false, false};
  int sh[2] = {0, 0};
  unsigned below[2] = {0u, 0u};
  unsigned emit_out[2] = {0u, 0u}, emit_bnd[2] = {0u, 0u};
  unsigned* counters = reinterpret_cast<unsigned*>(past_ring);
  if constexpr (kCounts || K == kEmit) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const SelRow<Key> r =
          row < R ? sel.st[row] : SelRow<Key>{Key(0), 0u, 0, 0, 0, -1};
      const bool live =
          kCounts ? r.mode == kCounting || r.mode == kGuess : row < R;
      bd[h] = live ? sel_bounds<T, Key>(r.pk, r.pj, r.level, sel.ibits)
                   : SelBounds<T>{inf<T>(), -inf<T>(), 1u, 0u};
      take[h] = r.mode == kTakeAll;
      guess[h] = r.mode == kGuess;
      by_index[h] = r.level >= kd;
      sh[h] = by_index[h] ? sel.ibits - 8 * (r.level - kd + 1)
                          : 8 * (kd - 1 - r.level);
    }
  }
  if constexpr (kCounts) {
    unsigned* mine = counters + (kPanel * g + 16 * w) * kHistStride;
    for (int e = lane; e < 16 * kHistStride; e += 32) mine[e] = 0u;
    __syncwarp();
  }
  int big_n[2] = {0, 0}, big_cnt[2] = {0, 0}, thr_i[2] = {INT_MAX, INT_MAX};
  T thr_s[2] = {inf<T>(), inf<T>()};
  T best[2] = {inf<T>(), inf<T>()};
  int bidx[2] = {0, 0};
  // the K-lists: in registers, or (smem_lists) past the ring with each
  // row's K-th s in vk
  constexpr bool kSmemList = smem_lists<T, K>();
  constexpr int KL = K > 1 && !kSmemList ? K : 1;
  T v[2][KL], vk[2] = {inf<T>(), inf<T>()}, vj[2] = {inf<T>(), inf<T>()};
  int id[2][KL];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < KL; ++e) {
      v[h][e] = inf<T>();
      id[h][e] = 0;
    }
  T* const lst_v = reinterpret_cast<T*>(past_ring) + threadIdx.x;
  int* const lst_i = reinterpret_cast<int*>(
      reinterpret_cast<T*>(past_ring) + 2 * (K > 1 ? K : 1) * kConsumers) +
      threadIdx.x;
  if constexpr (kSmemList) {
#pragma unroll
    for (int e = 0; e < 2 * K; ++e) {
      lst_v[e * kConsumers] = inf<T>();
      lst_i[e * kConsumers] = 0;
    }
  }
  if (resident) mbar_wait(rows_in, 0);
  // float32: a block's sum (fresh each block of coordinates); the tile's
  // total (float64: the DMMA accumulators themselves)
  float acc[32];
  T total[32], bn[16];
  if constexpr (!kF64) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  }
  int it = 0;
  for (int t = tile0; t < tile1; t += tile_step) {
#pragma unroll
    for (int i = 0; i < 32; ++i) total[i] = T(0);
    for (int c = 0; c < chunks; ++c) {
      const int kc = chunk_dim(Dp, c);
      const size_t off = static_cast<size_t>(kCoordBytes) * kTcChunk * c;
      for (int u0 = 0, u1; u0 < kc; u0 = u1, ++it) {
        u1 = unit_end(kc, u0, blocks);
        const int kw = u1 - u0, s = it % stages;
        mbar_wait(&full[s], (it / stages) & 1);
        const unsigned char* st = ring + s * stage_bytes;
        // the unit's first k-step of the rows (float32: of their hi words)
        const unsigned char* a_unit =
            resident ? rows + g * pb + off +
                           (kF64 ? kCoordBytes : kCoordBytes / 2) * u0
                     : st + b_bytes + g * kCoordBytes * kw;
        if constexpr (kF64) {
          dmma_unit(total, reinterpret_cast<const double*>(a_unit),
                    reinterpret_cast<const double*>(st), kw / 8, w, lane);
        } else {
          const float* a_hi = reinterpret_cast<const float*>(a_unit);
          const float* a_lo =
              resident ? a_hi + kPanel * kc : a_hi + kPanel * kw;
          const float* b_hi = reinterpret_cast<const float*>(st);
          const float* b_lo = b_hi + kPanel * kw;
          // a k-step of 8 coordinates is a [64][8] block: 512 floats.  Each
          // block of 32 coordinates (40 where 8 are left) is summed fresh,
          // small products first, big ones last, and added to `total`
          // rounded to nearest
          for (int k0 = u0, k1; k0 < u1; k0 = k1) {
            k1 = block_end(kc, k0);
            __syncwarp();
            fence_operands(acc);
            wgmma_fence();
            for (int j = (k0 - u0) / 8; j < (k1 - u0) / 8; ++j)
              wgmma_64x64x8(acc, operand_desc(a_lo + 512 * j),
                            operand_desc(b_hi + 512 * j), j > (k0 - u0) / 8);
            for (int j = (k0 - u0) / 8; j < (k1 - u0) / 8; ++j)
              wgmma_64x64x8(acc, operand_desc(a_hi + 512 * j),
                            operand_desc(b_lo + 512 * j), 1);
            for (int j = (k0 - u0) / 8; j < (k1 - u0) / 8; ++j)
              wgmma_64x64x8(acc, operand_desc(a_hi + 512 * j),
                            operand_desc(b_hi + 512 * j), 1);
            wgmma_commit();
            wgmma_wait_all();
            fence_operands(acc);
#pragma unroll
            for (int i = 0; i < 32; ++i)
              total[i] = __fadd_rn(total[i], acc[i]);
          }
        }
        if (c == chunks - 1 && u1 == kc) {
          // |b|^2 of this thread's columns 8 j + 2 q (+ 1)
          const auto* bn2 = reinterpret_cast<const typename Vec2<T>::type*>(
              st + kCoordBytes * kw);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const auto x = bn2[4 * j + q];
            bn[2 * j] = x.x;
            bn[2 * j + 1] = x.y;
          }
          if constexpr (!kF64) fence_proxy_async();
        }
        // float64 reads every operand by plain loads: all of them before
        // the next bulk copy into the stage
        if constexpr (kF64) fence_proxy_async();
        mbar_arrive(&empty[s]);
      }
    }
    // accumulator i holds row r0 + 8 ((i >> 1) & 1), column
    // 8 (i >> 2) + 2 q + (i & 1): each row's 16 in ascending column.  The
    // scores replace the sums, s = |b|^2 - 2 a.b (|b|^2 dead after: fewer
    // registers live through the selection)
#pragma unroll
    for (int i = 0; i < 32; ++i)
      total[i] = fma_rn(T(-2), total[i], bn[2 * (i >> 2) + (i & 1)]);
    const int col0 = kPanel * t + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T sc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e)
        sc[e] = total[4 * (e >> 1) + 2 * h + (e & 1)];
      if constexpr (K == 1) {
        // min first, its first index only where it improves
        T m = sc[0];
#pragma unroll
        for (int e = 1; e < 16; ++e) m = min_of(m, sc[e]);
        if (m < best[h]) {
          int f = 15;
#pragma unroll
          for (int e = 14; e >= 0; --e) f = sc[e] == m ? e : f;
          best[h] = m;
          bidx[h] = col0 + 8 * (f >> 1) + (f & 1);
        }
      } else if constexpr (kCounts) {
        // the digit of each pair that shares the row's prefix into the
        // row's counters; the pairs before the prefix counted alone
        unsigned* hr =
            counters + (kPanel * g + 16 * w + lane / 4 + 8 * h) * kHistStride;
        const bool whole = kPanel * (t + 1) <= N;  // no column past N
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const unsigned col = col0 + 8 * (e >> 1) + (e & 1);
          const bool real = whole || col < static_cast<unsigned>(N);
          below[h] += real && sc[e] < bd[h].lo ? 1u : 0u;
          if (real && sc[e] >= bd[h].lo && sc[e] <= bd[h].hi &&
              col >= bd[h].jlo && col <= bd[h].jhi) {
            const unsigned d =
                (by_index[h] ? col >> sh[h]
                             : static_cast<unsigned>(S::key(sc[e]) >> sh[h])) &
                (kBins - 1);
            atomicAdd(&hr[d >> 1], 1u << ((d & 1u) * 16));
          }
        }
      } else if constexpr (K == kEmit) {
        // the pairs before the row's prefix (and the prefix's own where
        // they complete the k), for the row's slots, and the others that
        // share it, for its boundary buffer (written below)
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const unsigned col = col0 + 8 * (e >> 1) + (e & 1);
          if (col < static_cast<unsigned>(N) && sc[e] <= bd[h].hi &&
              (sc[e] < bd[h].lo || col <= bd[h].jhi)) {
            if (take[h] || sc[e] < bd[h].lo || col < bd[h].jlo)
              emit_out[h] |= 1u << e;
            else
              emit_bnd[h] |= 1u << e;
          }
        }
      } else if constexpr (K == kBig) {
        // the row's candidates: every neighbour until its list holds k,
        // then those before its k-th pair in (s, index) order (the row's
        // four threads see its columns interleaved)
        const int rb = kPanel * g + 16 * w + lane / 4 + 8 * h;
        unsigned cand = 0;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int col = col0 + 8 * (e >> 1) + (e & 1);
          cand |= col < N && (big_n[h] < k ||
                              lex_less(sc[e], col, thr_s[h], thr_i[h]))
                      ? 1u << e : 0u;
        }
        if (r0 + 8 * h >= R) cand = 0;
        // this thread's place among the row's candidates, and their count
        const int pc = __popc(cand);
        int incl = pc;
        int up = __shfl_up_sync(0xffffffffu, incl, 1, 4);
        if (q >= 1) incl += up;
        up = __shfl_up_sync(0xffffffffu, incl, 2, 4);
        if (q >= 2) incl += up;
        const int total_c = __shfl_sync(0xffffffffu, incl, 3, 4);
        // rows whose buffer would overflow merge it into their list first
        for (unsigned todo = __ballot_sync(
                 0xffffffffu, q == 0 && big_cnt[h] + total_c > kBuf);
             todo; todo &= todo - 1) {
          const int o = __ffs(todo) - 1;
          const int n2 = L.flush(rb - lane / 4 + o / 4,
                                 __shfl_sync(0xffffffffu, big_cnt[h], o),
                                 __shfl_sync(0xffffffffu, big_n[h], o));
          if (lane / 4 == o / 4) {
            big_n[h] = n2;
            big_cnt[h] = 0;
            if (n2 == k) {
              thr_s[h] = L.list_s(rb)[k - 1];
              thr_i[h] = L.list_i(rb)[k - 1];
            }
          }
        }
        // one append site, candidates in ascending column
        int at = big_cnt[h] + incl - pc;
        while (cand) {
          const int e = __ffs(cand) - 1;
          cand &= cand - 1;
          T x = sc[0];
#pragma unroll
          for (int f = 1; f < 16; ++f) x = f == e ? sc[f] : x;
          L.put(rb, at++, x, col0 + 8 * (e >> 1) + (e & 1));
        }
        big_cnt[h] += total_c;
      } else {
        // the row's threshold: the least of its four threads' K-th s, and
        // no more than the largest of their ceil(K / 4)-th s (the four
        // lists hold K pairs at or under it, so the row's K-th is too); a
        // candidate equal to it may still win on its index
        constexpr int kJ = (K + 3) / 4 - 1;
        T last, jth;
        if constexpr (kSmemList) {
          last = vk[h];
          jth = vj[h];
        } else {
          last = v[h][K - 1];
          jth = v[h][kJ];
        }
        T thr = last;
        thr = min_of(thr, __shfl_xor_sync(0xffffffffu, thr, 1));
        thr = min_of(thr, __shfl_xor_sync(0xffffffffu, thr, 2));
        jth = max_of(jth, __shfl_xor_sync(0xffffffffu, jth, 1));
        jth = max_of(jth, __shfl_xor_sync(0xffffffffu, jth, 2));
        thr = min_of(thr, jth);
        unsigned cand = 0;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          cand |= sc[e] <= thr && sc[e] < last ? 1u << e : 0u;
        // one insert site, candidates in ascending column: a warp runs as
        // many rounds as its busiest lane has candidates
        while (cand) {
          const int e = __ffs(cand) - 1;
          cand &= cand - 1;
          T x = sc[0];
#pragma unroll
          for (int f = 1; f < 16; ++f) x = f == e ? sc[f] : x;
          if constexpr (kSmemList) {
            insert_strided<K>(x, col0 + 8 * (e >> 1) + (e & 1),
                              lst_v + h * K * kConsumers,
                              lst_i + h * K * kConsumers, kConsumers);
            vk[h] = lst_v[(h * K + K - 1) * kConsumers];
            vj[h] = lst_v[(h * K + (K + 3) / 4 - 1) * kConsumers];
          } else {
            insert<K>(x, col0 + 8 * (e >> 1) + (e & 1), v[h], id[h]);
          }
        }
      }
    }
    if constexpr (K == kEmit) {
      // a row's pairs of the tile take their slots by one atomic a kind
      // (the four threads' counts scanned by shuffles), both rows' in
      // flight at once; then each thread writes its own
      int at[2][2], first[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int pc = __popc(b ? emit_bnd[h] : emit_out[h]);
          int incl = pc;
          int up = __shfl_up_sync(0xffffffffu, incl, 1, 4);
          if (q >= 1) incl += up;
          up = __shfl_up_sync(0xffffffffu, incl, 2, 4);
          if (q >= 2) incl += up;
          at[h][b] = incl - pc;
          first[h][b] = 0;
          if (q == 3 && incl > 0)
            first[h][b] = atomicAdd(&sel.cnt[2 * (r0 + 8 * h) + b], incl);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t row = static_cast<size_t>(r0 + 8 * h);
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          unsigned m = b ? emit_bnd[h] : emit_out[h];
          int o = __shfl_sync(0xffffffffu, first[h][b], 3, 4) + at[h][b];
          while (m) {
            const int e = __ffs(m) - 1;
            m &= m - 1;
            // the pair's s, picked without indexing the array by a
            // variable (which would put it in local memory)
            const int i = 4 * (e >> 1) + 2 * h + (e & 1);
            T tv = total[0];
#pragma unroll
            for (int f = 1; f < 32; ++f) tv = f == i ? total[f] : tv;
            const typename S::Pair p =
                S::pair(S::key(tv), col0 + 8 * (e >> 1) + (e & 1));
            if (b)
              sel.bnd[row * sel.cap + o++] = p;
            else
              S::put(sel.d2, sel.idx, row * sel.k + o++, p);
          }
        }
        emit_out[h] = emit_bnd[h] = 0u;
      }
    }
  }
  if constexpr (kCounts) {
    // a guessing row's pairs before its prefix, summed over its four
    // threads, into its count for sel_pick; then the warp adds its 16
    // rows' counts to their global histograms
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned b = below[h];
      b += __shfl_xor_sync(0xffffffffu, b, 1);
      b += __shfl_xor_sync(0xffffffffu, b, 2);
      if (q == 0 && guess[h] && b)
        atomicAdd(&sel.cnt[2 * (r0 + 8 * h)], static_cast<int>(b));
    }
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int rb = kPanel * g + 16 * w + r;
      const int row = kTcRows * blockIdx.x + rb;
      if (row >= R) break;
      const unsigned* hr = counters + rb * kHistStride;
      unsigned* gh = sel.hist + static_cast<size_t>(row) * kBins;
      for (int x = lane; x < kBins / 2; x += 32) {
        const unsigned c = hr[x];
        if (c & 0xffffu) atomicAdd(&gh[2 * x], c & 0xffffu);
        if (c >> 16) atomicAdd(&gh[2 * x + 1], c >> 16);
      }
    }
    return;
  }
  if constexpr (K == kEmit) return;
  if constexpr (K == kBig) {
    // the last merges
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rb = kPanel * g + 16 * w + 8 * h;  // the warp's first row
      for (unsigned todo = __ballot_sync(0xffffffffu,
                                         q == 0 && big_cnt[h] > 0);
           todo; todo &= todo - 1) {
        const int o = __ffs(todo) - 1;
        const int n2 = L.flush(rb + o / 4,
                               __shfl_sync(0xffffffffu, big_cnt[h], o),
                               __shfl_sync(0xffffffffu, big_n[h], o));
        if (lane / 4 == o / 4) big_n[h] = n2;
      }
      for (unsigned todo = __ballot_sync(
               0xffffffffu, q == 0 && r0 + 8 * h < R && big_n[h] < k);
           todo; todo &= todo - 1) {
        const int o = __ffs(todo) - 1;
        L.pad(rb + o / 4, __shfl_sync(0xffffffffu, big_n[h], o));
      }
    }
  }
  // the four threads of a row merge in (s, index) order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if constexpr (K == 1) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const T ob = __shfl_xor_sync(0xffffffffu, best[h], off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx[h], off);
        if (lex_less(ob, oi, best[h], bidx[h])) {
          best[h] = ob;
          bidx[h] = oi;
        }
      }
      if (q == 0 && row < R) {
        part_s[static_cast<size_t>(blockIdx.y) * R + row] = best[h];
        part_i[static_cast<size_t>(blockIdx.y) * R + row] = bidx[h];
      }
    } else if constexpr (K > 1) {
      // this thread's list of the row (the products are done: registers
      // hold it now)
      T mv[K];
      int mi[K];
#pragma unroll
      for (int e = 0; e < K; ++e) {
        if constexpr (kSmemList) {
          mv[e] = lst_v[(h * K + e) * kConsumers];
          mi[e] = lst_i[(h * K + e) * kConsumers];
        } else {
          mv[e] = v[h][e];
          mi[e] = id[h][e];
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        // the partner's list as it was, then merged into this one
        T ov[K];
        int oi[K];
#pragma unroll
        for (int e = 0; e < K; ++e) {
          ov[e] = __shfl_xor_sync(0xffffffffu, mv[e], off);
          oi[e] = __shfl_xor_sync(0xffffffffu, mi[e], off);
        }
#pragma unroll
        for (int e = 0; e < K; ++e) insert_lex<K>(ov[e], oi[e], mv, mi);
      }
      if (q == 0 && row < R) {
#pragma unroll
        for (int e = 0; e < K; ++e) {
          if (e < k) {
            const size_t o =
                (static_cast<size_t>(blockIdx.y) * k + e) * R + row;
            part_s[o] = mv[e];
            part_i[o] = mi[e];
          }
        }
      }
    }
  }
}

// Blocks of the scan of type T and mode K an SM holds with `smem` bytes of
// dynamic shared memory (0 on a query failure).
template <typename T, int K>
int blocks_per_sm(size_t smem) {
  int n = 0;
  if (cudaFuncSetAttribute(wide_tc_scan<T, K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wide_tc_scan<T, K>, kTcThreads, smem) != cudaSuccess)
    return 0;
  return n;
}

// The bytes past the ring of the scan of mode K: at k > kMaxK the buffers
// and the warps' counters (66 KB in float32, 99 KB in float64: an entry
// is its score and its index), in the counting passes 256 counters a row
// (66 KB in both), float64's K-lists from 4 (smem_lists: 24-96 KB).
template <typename T, int K>
size_t tc_extra() {
  return K == kBig ? big_bytes(kTcRows, kTcThreads, sizeof(T))
         : K == kCount ? sizeof(unsigned) * kTcRows * kHistStride
         : smem_lists<T, K>()
             ? static_cast<size_t>(2) * K * kConsumers * (sizeof(T) + sizeof(int))
             : 0;
}

// The plan of the scan of mode K: the first of these that holds two
// stages and a block an SM, with the most stages among those that let the
// most blocks share an SM (at D = 33 two blocks of two stages took 2.37 ms
// where one of four took 3.27, PERF.md): the rows resident (to 128 padded
// coordinates) and a chunk a stage, as every mode up to k = 16 at every D;
// resident and a block a stage; streamed and a chunk; streamed and a
// block.  Past k = 16 and in the select path's counting passes the bytes
// past the ring leave no room for the first at D = 128, and the last
// holds at any D (float64's stages take float32's bytes but 256 of |b|^2,
// PERF.md).  *per_sm gets the blocks an SM (0: none fits).
template <typename T, int K>
TcPlan tc_plan_k(int R, int N, int D, int* per_sm) {
  const int smem_max = smem_optin();
  const size_t extra = tc_extra<T, K>();
  TcPlan best{};
  *per_sm = 0;
  for (const int layout : {0, 1, 2, 3}) {
    const int resident = layout < 2, blocks = layout % 2;
    const int most = blocks ? kMaxStages : kMaxChunkStages;
    best = tc_plan<T>(R, N, D, smem_max, most, extra, resident, blocks);
    *per_sm = best.stages < 2 ? 0 : blocks_per_sm<T, K>(best.smem);
    for (int st = best.stages - 1; st >= 2; --st) {
      const TcPlan p =
          tc_plan<T>(R, N, D, smem_max, st, extra, resident, blocks);
      const int n = blocks_per_sm<T, K>(p.smem);
      if (n > *per_sm) {
        best = p;
        *per_sm = n;
      }
    }
    if (*per_sm >= 1) break;
  }
  return best;
}

// Splits of the tiles for the tensor-core scan of mode K: the count (each
// split at least kMinTcSplitTiles tiles, at most max_tiles) whose waves of
// blocks, at the blocks an SM the kernel holds, take the fewest tile-steps
// (two more a block for its start); at k > kMaxK at most kMaxBigSplits
// and what kPartBudget holds; 0 where no plan fits or on a device query
// failure.
template <typename T, int K>
int tc_splits(int R, int N, int D, int k = 0, int max_tiles = INT_MAX) {
  int dev = 0, sms = 0, per_sm = 0;
  const TcPlan p = tc_plan_k<T, K>(R, N, D, &per_sm);
  if (per_sm < 1 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  const long long row_blocks = p.row_panels / kGroups;
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int most = std::max({1, std::min(64, p.tiles / kMinTcSplitTiles),
                             p.tiles / max_tiles + 1});
  const size_t pair = sizeof(T) + sizeof(int);  // a list entry's bytes
  int best = 0;
  long long best_cost = -1;
  for (int s = 1; s <= most; ++s) {
    const int per = (p.tiles + s - 1) / s;
    const int used = (p.tiles + per - 1) / per;
    if (per > max_tiles) continue;
    if (K == kBig &&
        (used > kMaxBigSplits ||
         static_cast<size_t>(used) * R * k * pair > std::max<size_t>(
             kPartBudget, static_cast<size_t>(R) * k * pair)))
      continue;
    const long long cost = (row_blocks * used + slots - 1) / slots * (per + 2);
    if (best_cost < 0 || cost < best_cost) {
      best = used;
      best_cost = cost;
    }
  }
  return best;
}

// The pre-pass of both clouds into `scratch` (the reference rows' panels,
// then the neighbours': tf32_split in float32, f64_panels in float64),
// then the scan of mode K on `splits` splits of the tiles, every
// tile_step-th tile of each.
template <typename T, int K>
cudaError_t launch_tc_scan(const T* ref, const T* nbr, int R, int N, int D,
                           int k, int splits, void* scratch, T* part_s,
                           int* part_i, const TcSelect<T>& sel,
                           bool split_clouds, cudaStream_t stream,
                           int tile_step = 1) {
  int per_sm = 0;
  const TcPlan p = tc_plan_k<T, K>(R, N, D, &per_sm);
  if (scratch == nullptr || per_sm < 1 || splits < 1)
    return cudaErrorInvalidValue;
  unsigned char* ref_pan = static_cast<unsigned char*>(scratch);
  unsigned char* nbr_pan = ref_pan + static_cast<size_t>(p.row_panels) * p.pb;
  cudaError_t e;
  if (split_clouds) {
    if constexpr (sizeof(T) == sizeof(double)) {
      f64_panels<<<(p.row_panels * kPanel + 127) / 128, 128, 0, stream>>>(
          ref, R, D, p.Dp, p.row_panels, reinterpret_cast<double*>(ref_pan));
      f64_panels<<<(p.tiles * kPanel + 127) / 128, 128, 0, stream>>>(
          nbr, N, D, p.Dp, p.tiles, reinterpret_cast<double*>(nbr_pan));
    } else {
      tf32_split<<<(p.row_panels * kPanel + 127) / 128, 128, 0, stream>>>(
          ref, R, D, p.Dp, p.row_panels, reinterpret_cast<float*>(ref_pan));
      tf32_split<<<(p.tiles * kPanel + 127) / 128, 128, 0, stream>>>(
          nbr, N, D, p.Dp, p.tiles, reinterpret_cast<float*>(nbr_pan));
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  e = cudaFuncSetAttribute(wide_tc_scan<T, K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(p.smem));
  if (e != cudaSuccess) return e;
  const int split_tiles = (p.tiles + splits - 1) / splits;
  const dim3 grid(p.row_panels / kGroups, splits);
  wide_tc_scan<T, K><<<grid, kTcThreads, p.smem, stream>>>(
      ref_pan, nbr_pan, R, p.Dp, p.resident, p.blocks, p.unit_max, p.stages,
      p.tiles, split_tiles, tile_step, k, part_s, part_i, N, sel);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t launch_tc(const T* ref, const T* nbr, int R, int N, int D, int k,
                      int splits, void* scratch, T* part_s, int* part_i,
                      T* d2, long long* idx, cudaStream_t stream) {
  cudaError_t e = launch_tc_scan<T, K>(ref, nbr, R, N, D, k, splits, scratch,
                                       part_s, part_i, TcSelect<T>{}, true,
                                       stream);
  if (e != cudaSuccess) return e;
  if constexpr (K == 1)
    nn1_merge<T, 0><<<(R + 255) / 256, 256, 0, stream>>>(
        ref, R, D, splits, part_s, part_i, d2, idx);
  else if constexpr (K == kBig)
    nnk_merge_big<T, 0><<<(R + 7) / 8, 256, 0, stream>>>(
        ref, R, D, k, splits, part_s, part_i, d2, idx);
  else
    nnk_merge<T, 0, K><<<(R + 255) / 256, 256, 0, stream>>>(
        ref, R, D, k, splits, part_s, part_i, d2, idx);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_nn1_wide(const T* ref, const T* nbr, int R, int N, int D,
                            int splits, void* scratch, T* part_s,
                            int* part_i, T* d2, long long* idx,
                            cudaStream_t stream) {
  return launch_tc<T, 1>(ref, nbr, R, N, D, 1, splits, scratch, part_s,
                         part_i, d2, idx, stream);
}

// The crossover k of the wide families (D > 8), and whether a call takes
// the select path: float32 at k >= kWideSelectK (one k at both measured
// widths and rows: 50,000 at D = 33, 20,000 at 128), float64 at
// k >= kWideSelectK64 (kWideSelectK64Long past kShortDim64 coordinates),
// and both at k = N.
int wide_select_k(int R, int D, bool f64) {
  (void)R;
  return !f64 ? kWideSelectK
         : D <= kShortDim64 ? kWideSelectK64 : kWideSelectK64Long;
}
bool wide_takes_select(int R, int N, int D, int k, bool f64) {
  return k >= wide_select_k(R, D, f64) || k == N;
}

// The wide select path's sample: every kSampleStride-th tile of each
// counting split, taken where the rank of the k-th pair in it is at least
// kMinSampleRank; from it each row's first digit is guessed.  A float64
// key's first digit, the sign and 7 of 11 exponent bits, takes one or two
// values a row on descriptor clouds, and its second holds 16 bins a
// binade where float32's holds 128, so the digit walk takes a row three
// full passes where float32's takes two (PERF.md); the guess spares the
// first.  Two digits guessed spared none: the sample's rank of the k-th
// pair missed the second digit's bin of 1/16 binade on many rows, which
// then started over (PERF.md).
constexpr int kSampleStride = 8;
constexpr int kMinSampleRank = 32;

// After the sample pass: each counting row's first digit guessed, the bin
// of its ks-th sampled pair (ks = k sampled / N rounded up: the bin where
// its k-th pair would fall were the sample the whole), which the next
// pass checks (sel_pick); the histogram zeroed.  A row whose sample holds
// fewer than ks pairs keeps counting.
template <typename K>
__global__ void sel_guess(int R, int ks, SelRow<K>* st, unsigned* ghist) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= R || st[row].mode != kCounting) return;
  unsigned* g = ghist + static_cast<size_t>(row) * kBins;
  unsigned c[8], sum = 0;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    c[e] = g[lane * 8 + e];
    sum += c[e];
    g[lane * 8 + e] = 0u;
  }
  unsigned inc = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  const unsigned need = static_cast<unsigned>(ks), excl = inc - sum;
  const unsigned owner =
      __ballot_sync(0xffffffffu, excl < need && need <= inc);
  if (!owner || lane != __ffs(owner) - 1) return;
  unsigned d = 0, acc = excl;
  bool got = false;
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    acc += c[e];
    if (!got && acc >= need) {
      d = lane * 8 + e;
      got = true;
    }
  }
  st[row] = SelRow<K>{static_cast<K>(d) << (8 * (sizeof(K) - 1)), 0u, 1, 0,
                      0, kGuess};
}

// Bytes of the split clouds (ppt_knn_scratch's floats), rounded up to 256.
template <typename T>
size_t tc_panel_bytes(int R, int N, int D) {
  const TcPlan p = tc_plan<T>(R, N, D, 0, kMaxStages);
  return (static_cast<size_t>(p.row_panels + p.tiles) * p.pb + 255) / 256 *
         256;
}

// The wide families at k >= wide_select_k or k = N: select, then sort, as
// launch_nnk_select, with every pass a mode of the tensor-core scan (the
// merge scan's products, sums and s: the same bits).  Each full counting
// pass costs its scan and ~10 SIMT instructions a pair (PERF.md), so the
// first digit, which a row's key takes few values of, is guessed from a
// sample (sel_guess) and checked by the full pass that counts the second
// (sel_pick): a random float32 cloud then takes one full counting pass
// where the digit walk took two.  The counting passes run every row at its own
// level (a failed guess starts over), as many as the digits and one
// more.  The scratch holds the split clouds (tc_panel_bytes), then the
// select path's state (sel_plan, with no fused k = N).  The counting
// passes' splits hold at most kMaxSelChunk neighbours (a 16-bit count
// never carries).
template <typename T>
cudaError_t launch_nnk_wide_select(const T* ref, const T* nbr, int R, int N,
                                   int D, int k, void* scratch, T* d2,
                                   long long* idx, cudaStream_t stream) {
  using S = Sel<T>;
  using Key = typename S::Key;
  using Pr = typename S::Pair;
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const SelPlan p = sel_plan<T>(R, N, k, false);
  unsigned char* base =
      static_cast<unsigned char*>(scratch) + tc_panel_bytes<T>(R, N, D);
  auto* st = reinterpret_cast<SelRow<Key>*>(base + p.st);
  auto* hist = reinterpret_cast<unsigned*>(base + p.hist);
  auto* cnt = reinterpret_cast<int*>(base + p.cnt);
  auto* bnd = reinterpret_cast<Pr*>(base + p.bnd);
  auto* big = reinterpret_cast<Pr*>(base + p.big);
  const int count_splits =
      tc_splits<T, kCount>(R, N, D, 0, kMaxSelChunk / kPanel);
  const int emit_splits = tc_splits<T, kEmit>(R, N, D);
  if (count_splits < 1 || emit_splits < 1) return cudaErrorInvalidValue;
  const int fill = static_cast<int>(std::min<size_t>(
      65535, (static_cast<size_t>(R) * kBins + 255) / 256));
  sel_init<Key><<<fill, 256, 0, stream>>>(R, N, k, p.cap, st, hist, cnt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const TcSelect<T> sel{st, hist, cnt, bnd, d2, idx, p.ibits, p.cap, k};
  bool split = true;
  if (p.levels > 0) {
    // the pairs a row's sample holds: every kSampleStride-th tile of each
    // counting split (launch_tc_scan's cut)
    const int tiles = (N + kPanel - 1) / kPanel;
    const int split_tiles = (tiles + count_splits - 1) / count_splits;
    long long sampled = 0;
    for (int t0 = 0; t0 < tiles; t0 += split_tiles)
      for (int t = t0; t < std::min(tiles, t0 + split_tiles);
           t += kSampleStride)
        sampled += std::min(kPanel, N - kPanel * t);
    const long long ks = (static_cast<long long>(k) * sampled + N - 1) / N;
    int passes = p.levels;
    if (ks >= kMinSampleRank && sampled < N) {
      e = launch_tc_scan<T, kCount>(ref, nbr, R, N, D, k, count_splits,
                                    scratch, nullptr, nullptr, sel, split,
                                    stream, kSampleStride);
      if (e != cudaSuccess) return e;
      split = false;
      sel_guess<Key><<<(R + 7) / 8, 256, 0, stream>>>(
          R, static_cast<int>(ks), st, hist);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
      ++passes;  // a failed guess starts over
    }
    for (int i = 0; i < passes; ++i, split = false) {
      e = launch_tc_scan<T, kCount>(ref, nbr, R, N, D, k, count_splits,
                                    scratch, nullptr, nullptr, sel, split,
                                    stream);
      if (e != cudaSuccess) return e;
      sel_pick<Key><<<(R + 7) / 8, 256, 0, stream>>>(
          R, k, -1, p.ibits, p.cap, st, hist, cnt);
      if ((e = cudaGetLastError()) != cudaSuccess) return e;
    }
  }
  e = launch_tc_scan<T, kEmit>(ref, nbr, R, N, D, k, emit_splits, scratch,
                               nullptr, nullptr, sel, split, stream);
  if (e != cudaSuccess) return e;
  return launch_sel_sort<T>(ref, D, R, k, p, st, cnt, bnd, big, d2, idx,
                            stream);
}

// The wide families: the select path at k >= wide_select_k and k = N,
// else (or where `merge`) the tensor-core scans.
template <typename T>
cudaError_t launch_nnk_wide(const T* ref, const T* nbr, int R, int N, int D,
                            int k, int splits, void* scratch, T* part_s,
                            int* part_i, T* d2, long long* idx,
                            cudaStream_t stream, bool merge) {
  if (!merge && wide_takes_select(R, N, D, k, sizeof(T) == sizeof(double)))
    return launch_nnk_wide_select<T>(ref, nbr, R, N, D, k, scratch, d2, idx,
                                     stream);
  switch (k > kMaxK ? kBig : list_len(k)) {
    case kBig: return launch_tc<T, kBig>(ref, nbr, R, N, D, k, splits,
                                         scratch, part_s, part_i, d2, idx,
                                         stream);
    case 2: return launch_tc<T, 2>(ref, nbr, R, N, D, k, splits, scratch,
                                   part_s, part_i, d2, idx, stream);
    case 4: return launch_tc<T, 4>(ref, nbr, R, N, D, k, splits, scratch,
                                   part_s, part_i, d2, idx, stream);
    case 8: return launch_tc<T, 8>(ref, nbr, R, N, D, k, splits, scratch,
                                   part_s, part_i, d2, idx, stream);
    default: return launch_tc<T, kMaxK>(ref, nbr, R, N, D, k, splits,
                                        scratch, part_s, part_i, d2, idx,
                                        stream);
  }
}

// Splits of the wide families' tensor-core scans (1 on the select paths).
template <typename T>
int nnk_tc_splits(int R, int N, int D, int k, bool merge = false) {
  if (!merge && wide_takes_select(R, N, D, k, sizeof(T) == sizeof(double)))
    return 1;
  switch (k > kMaxK ? kBig : list_len(k)) {
    case kBig: return tc_splits<T, kBig>(R, N, D, k);
    case 2: return tc_splits<T, 2>(R, N, D);
    case 4: return tc_splits<T, 4>(R, N, D);
    case 8: return tc_splits<T, 8>(R, N, D);
    default: return tc_splits<T, kMaxK>(R, N, D);
  }
}

}  // namespace

extern "C" {

// Splits of the neighbour range that nn1 uses for R rows of D coordinates
// (float64 if f64, else float32) and N neighbours on the current device:
// the register-tiled scan aims at ~16 blocks an SM, at least 2048
// neighbours each; the wide scan at whole waves of blocks (tc_splits).  ppt_nn1's part_s / part_i hold splits * R values of
// the clouds' type and splits * R ints.  Returns 0 on invalid sizes or a
// device query failure.
int ppt_nn1_splits(int R, int N, int D, int f64) {
  if (D < 1 || R <= 0 || N <= 0) return 0;
  if (D > kMaxDim)
    return f64 ? tc_splits<double, 1>(R, N, D) : tc_splits<float, 1>(R, N, D);
  return splits_for(R, N,
                    kThreads * (f64 ? nn1_rt<double>(D) : nn1_rt<float>(D)),
                    kNn1BlocksPerSm);
}

// The float32 scratch (*floats of them) that ppt_nn1 (k = 1) and ppt_nnk
// need for R rows, N neighbours of D coordinates and k (float64 if f64)
// on their merge scans: the split clouds of the wide scans on the tensor
// cores past 8 coordinates, the staged neighbours of the warp merge scan
// (up to 8, k > 16 below the select path), 0 elsewhere.  Returns
// cudaErrorInvalidValue on invalid sizes.
int ppt_knn_scratch(int R, int N, int D, int k, int f64, long long* floats) {
  *floats = 0;
  if (R <= 0 || N <= 0 || D < 1 || k < 1 || k > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D > kMaxDim) {
    const TcPlan p = f64 ? tc_plan<double>(R, N, D, 0, kMaxStages)
                         : tc_plan<float>(R, N, D, 0, kMaxStages);
    *floats = static_cast<long long>(p.row_panels + p.tiles) *
              static_cast<long long>(p.pb / sizeof(float));
  } else if (k > kMaxK && !takes_select(R, N, k, f64)) {
    *floats = static_cast<long long>(
        (f64 ? warp_scratch<double>(N, D) : warp_scratch<float>(N, D)) /
        sizeof(float));
  }
  return 0;
}

// The nearest of N neighbours (nbr [N, D]) of each of R reference rows
// (ref [R, D]), both row-major float64 if f64, else float32: d2 [R] of
// the same type, clamped at 0, and idx [R] int64, on `stream`, through
// `splits` (ppt_nn1_splits) partial results in part_s [splits, R] (the
// clouds' type) / part_i [splits, R]: the register-tiled scan for
// D <= 8, the wide scan past it (on the tensor cores, through `scratch`,
// ppt_knn_scratch's floats).
// Returns cudaGetLastError() (0 on success); invalid sizes (R, N,
// splits >= 1, D >= 1) or a missing scratch return cudaErrorInvalidValue
// without launching.
int ppt_nn1(const void* ref, const void* nbr, int R, int N, int D, int f64,
            int splits, void* scratch, void* part_s, int* part_i, void* d2,
            long long* idx, void* stream) {
  if (R <= 0 || N <= 0 || splits < 1 || splits > N || D < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f64 ? nn1_any<double>(ref, nbr, R, N, D, splits, scratch, part_s,
                            part_i, d2, idx, s)
          : nn1_any<float>(ref, nbr, R, N, D, splits, scratch, part_s,
                           part_i, d2, idx, s));
}

// Splits of the neighbour range that nnk uses for R rows of D coordinates,
// N neighbours and k (float64 if f64, else float32) on the current device:
// the register-tiled scans up to k = 16 aim at ~4 blocks an SM, at least
// 2048 neighbours each, the warp merge scan past it at the least cost of
// its waves (warp_plan), the wide scans on the tensor cores at whole
// waves; past k = 16 at most 32, within kPartBudget's bytes of lists.
// ppt_nnk's part_s / part_i hold splits * k * R values of the clouds' type
// and as many ints (none where the warp merge scan takes one split); on
// the select paths (ppt_nnk_select_scratch) 1 and no lists.  Returns 0 on
// invalid sizes (1 <= k <= N) or a device query failure.
int ppt_nnk_splits(int R, int N, int D, int k, int f64) {
  if (D < 1 || R <= 0 || N <= 0 || k < 1 || k > N) return 0;
  if (D <= kMaxDim && takes_select(R, N, k, f64)) return 1;
  if (D > kMaxDim)
    return f64 ? nnk_tc_splits<double>(R, N, D, k)
               : nnk_tc_splits<float>(R, N, D, k);
  if (k > kMaxK)
    return f64 ? warp_splits<double>(R, N, D, k)
               : warp_splits<float>(R, N, D, k);
  const int K = list_len(k);
  return splits_for(R, N,
                    kThreads * (f64 ? nnk_rows<double>(K) : nnk_rows<float>(K)),
                    kNnkBlocksPerSm);
}

// The least k from which nnk takes a select path below k = N for R rows
// of D coordinates (float64 if f64): the register-tiled family's
// crossover (kSelectK, kSelectK64 past kSmallR rows, kSelectKSmallR,
// kSelectKSmallR64 up to them), the wide families' (kWideSelectK,
// kWideSelectK64); -1 on invalid sizes.
int ppt_nnk_select_k(int R, int D, int f64) {
  if (R <= 0 || D < 1) return -1;
  if (D <= kMaxDim) return select_k(R, f64);
  return wide_select_k(R, D, f64);
}

// Which kernels nnk runs for R rows, N neighbours of D coordinates and k
// (float64 if f64): 0 the register-tiled merge scans, 1 the register-
// tiled select path, 2 the tensor-core scans, 3 the tensor-core select
// path, 4 the float64 DMMA scans, 5 the float64 DMMA select path; -1 on
// invalid sizes.
int ppt_nnk_family(int R, int N, int D, int k, int f64) {
  if (R <= 0 || N <= 0 || D < 1 || k < 1 || k > N) return -1;
  if (D <= kMaxDim) return takes_select(R, N, k, f64) ? 1 : 0;
  return (wide_takes_select(R, N, D, k, f64) ? 3 : 2) + (f64 ? 2 : 0);
}

// The select paths' scratch for R rows of D coordinates, N neighbours and
// k (float64 if f64, else float32): *bytes = -1 where nnk takes no select
// path (k < N below ppt_nnk_select_k), else its bytes, the scratch ppt_nnk then reads: for D <= 8, 0
// for k = N up to 8192 pairs a row; else per row a state (24 bytes, 32 in
// float64), a histogram of 256 counts (1 KB), two counts, a boundary
// buffer of min(512, P - k + 1) pairs (8 bytes a pair, 16 in float64),
// and past 8192 a sort buffer of P pairs, P the least power of 2 >= k - 1
// + 256 (>= k at k = N), each part rounded up to 256 bytes; for the wide
// families the split clouds (ppt_knn_scratch's floats, rounded up to 256
// bytes) and then those parts, at k = N too.  k = 4096 at R = 100,000 in
// float32, D <= 8: 0.52 GB beside the outputs' 4.9 GB.  Returns
// cudaErrorInvalidValue on invalid sizes.
int ppt_nnk_select_scratch(int R, int N, int D, int k, int f64,
                           long long* bytes) {
  *bytes = -1;
  if (R <= 0 || N <= 0 || D < 1 || k < 1 || k > N)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= kMaxDim && takes_select(R, N, k, f64))
    *bytes = static_cast<long long>(
        f64 ? sel_plan<double>(R, N, k).bytes
            : sel_plan<float>(R, N, k).bytes);
  else if (D > kMaxDim && wide_takes_select(R, N, D, k, f64))
    *bytes = static_cast<long long>(
        f64 ? tc_panel_bytes<double>(R, N, D) +
                  sel_plan<double>(R, N, k, false).bytes
            : tc_panel_bytes<float>(R, N, D) +
                  sel_plan<float>(R, N, k, false).bytes);
  return 0;
}

// The k nearest of N neighbours (nbr [N, D]) of each of R reference rows
// (ref [R, D]), both row-major float64 if f64, else float32: d2 [R, k] of
// the same type, ascending by (d^2, index), clamped at 0, and idx [R, k]
// int64, on `stream`, through `splits` (ppt_nnk_splits) partial lists in
// part_s / part_i (splits * k * R each; [splits, k, R] up to k = 16,
// [splits, R, k] past it; none where the warp merge scan takes one
// split): the register-tiled scan for D <= 8, the wide
// scan past it (on the tensor cores through `scratch`, as ppt_nn1); the
// select paths (D <= 8 at
// k >= kSelectK (kSelectK64), the wide ones from their crossovers, and
// k = N) through `scratch` (ppt_nnk_select_scratch's bytes; part_s /
// part_i unused).  Returns cudaGetLastError() (0 on success); invalid
// sizes (R >= 1, 1 <= k <= N, D >= 1, 1 <= splits <= N) or a missing
// scratch return cudaErrorInvalidValue without launching.
int ppt_nnk(const void* ref, const void* nbr, int R, int N, int D, int k,
            int f64, int splits, void* scratch, void* part_s, int* part_i,
            void* d2, long long* idx, void* stream) {
  if (R <= 0 || N <= 0 || k < 1 || k > N || D < 1 || splits < 1 ||
      splits > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f64 ? nnk_any<double>(ref, nbr, R, N, D, k, splits, scratch, part_s,
                            part_i, d2, idx, s)
          : nnk_any<float>(ref, nbr, R, N, D, k, splits, scratch, part_s,
                           part_i, d2, idx, s));
}

// The wide families' merge scan (the tensor-core scans, float32 in
// three-pass TF32, float64 (f64) on DMMA: K-lists up to k = 16, buffers
// merged into lists past it) at any
// 1 <= k <= N of D > 8 coordinates, whatever ppt_nnk_select_k says: the
// yardstick the wide select paths are held to bit for bit.  Its splits
// (0 on invalid sizes), and the call, as ppt_nnk's (scratch:
// ppt_knn_scratch's floats; part_s / part_i: splits * k * R each).
int ppt_nnk_wide_merge_splits(int R, int N, int D, int k, int f64) {
  if (D <= kMaxDim || R <= 0 || N <= 0 || k < 1 || k > N) return 0;
  return f64 ? nnk_tc_splits<double>(R, N, D, k, true)
             : nnk_tc_splits<float>(R, N, D, k, true);
}

int ppt_nnk_wide_merge(const void* ref, const void* nbr, int R, int N, int D,
                       int k, int f64, int splits, void* scratch,
                       void* part_s, int* part_i, void* d2, long long* idx,
                       void* stream) {
  if (D <= kMaxDim || R <= 0 || N <= 0 || k < 1 || k > N || splits < 1 ||
      splits > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      f64 ? launch_nnk_wide(static_cast<const double*>(ref),
                            static_cast<const double*>(nbr), R, N, D, k,
                            splits, scratch, static_cast<double*>(part_s),
                            part_i, static_cast<double*>(d2), idx, s, true)
          : launch_nnk_wide(static_cast<const float*>(ref),
                            static_cast<const float*>(nbr), R, N, D, k,
                            splits, scratch, static_cast<float*>(part_s),
                            part_i, static_cast<float*>(d2), idx, s, true));
}

const char* ppt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

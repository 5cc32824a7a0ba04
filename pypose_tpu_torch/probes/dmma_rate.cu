// Throughput of back-to-back float64 mma.sync (DMMA) of each shape Hopper
// has: m8n8k4 (sm_80 on), m16n8k4, m16n8k8 and m16n8k16 (sm_90).  Each
// warp keeps a 16 x 64 tile of float64 accumulators (the DMMA knn scan's,
// csrc/knn.cu:dmma_unit) and, a round, adds one 8-coordinate k-step to it:
// eight independent column slices of 8, each one m16n8k8, two m16n8k4 or
// four m8n8k4 (m16n8k16: two k-steps, half as many rounds), operands in
// registers.  Its clock64 span over `rounds` rounds, `warps` warps a block,
// one block an SM.  dmma_layout checks the fragment layouts the scan
// assumes: a 16 x 16 by 16 x 8 product of small integers (exact in any
// order), each thread loading coordinates t and t + 4 of a k-step by one
// 16-byte load, as the scan's panels (csrc/knn.cu:f64_panels) lay them out.
// lds_rate times those fragment loads alone (a warp's two rows and eight
// neighbours of one k-step from shared memory, as csrc/knn.cu:dmma_unit
// loads them), in the panels' order by 16-byte loads or in coordinate
// order by two 8-byte loads: the shared-memory bytes an SM moves a cycle
// (128 without bank conflicts) show the conflicts no profiler reads here.
// Built and run by pypose_tpu_torch/probes/knn_probes.py --dmma.
#include <cuda_runtime.h>

namespace {

// d (4: rows g, g + 8; columns 2t, 2t + 1) += a b
__device__ __forceinline__ void m16n8k8(double* d, double a0, double a1,
                                        double a2, double a3, double b0,
                                        double b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}
__device__ __forceinline__ void m16n8k4(double* d, double a0, double a1,
                                        double b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}
__device__ __forceinline__ void m8n8k4(double* d, double a0, double b0) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a0), "d"(b0));
}
__device__ __forceinline__ void m16n8k16(double* d, const double (&a)[8],
                                         const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, "
      "{%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// One k-step (two for S = 16) of the warp's 16 x 64 tile: x0, x1 rows g and
// g + 8, coordinates (t, t + 4) of each k-step; y[n] column slice n's.
template <int S>
__device__ __forceinline__ void kstep(double (&d)[32], const double2* x0,
                                      const double2* x1, double2 (*y)[8]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    double* dn = d + 4 * n;
    if constexpr (S == 16) {
      const double a[8] = {x0[0].x, x1[0].x, x0[0].y, x1[0].y,
                           x0[1].x, x1[1].x, x0[1].y, x1[1].y};
      const double b[4] = {y[0][n].x, y[0][n].y, y[1][n].x, y[1][n].y};
      m16n8k16(dn, a, b);
    } else if constexpr (S == 8) {
      m16n8k8(dn, x0[0].x, x1[0].x, x0[0].y, x1[0].y, y[0][n].x, y[0][n].y);
    } else if constexpr (S == 4) {
      m16n8k4(dn, x0[0].x, x1[0].x, y[0][n].x);
      m16n8k4(dn, x0[0].y, x1[0].y, y[0][n].y);
    } else {
      m8n8k4(dn, x0[0].x, y[0][n].x);
      m8n8k4(dn + 2, x1[0].x, y[0][n].x);
      m8n8k4(dn, x0[0].y, y[0][n].y);
      m8n8k4(dn + 2, x1[0].y, y[0][n].y);
    }
  }
}

template <int S>
__global__ void __launch_bounds__(256, 1)
dmma_rate(int rounds, long long* cycles, double* sink) {
  constexpr int kSteps = S == 16 ? 2 : 1;
  const int lane = threadIdx.x % 32;
  double d[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.0;
  double2 x0[kSteps], x1[kSteps], y[kSteps][8];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    x0[j] = make_double2(1e-3 * lane, 2e-3 * lane);
    x1[j] = make_double2(3e-3 * lane, 4e-3 * lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) y[j][n] = make_double2(1e-3 * n, 2e-3 * j);
  }
  __syncthreads();
  const long long t0 = clock64();
  for (int r = 0; r < rounds; r += kSteps) kstep<S>(d, x0, x1, y);
  const long long t1 = clock64();
  if (lane == 0) cycles[blockIdx.x * 32 + threadIdx.x / 32] = t1 - t0;
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < 32; ++i) s += d[i];
  if (s == 1.2345) sink[0] = s;
}

// a [16][16] row-major times b [8][16] (column n's 16 coordinates) into
// d [16][8]; one warp; the operands staged as the scan's panels stage them
// (a k-step of 8 coordinates a row in the order 0 4 1 5 2 6 3 7)
template <int S>
__global__ void dmma_layout(const double* a, const double* b, double* d) {
  __shared__ __align__(16) double pa[2][16][8], pb[2][8][8];
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  for (int e = lane; e < 256; e += 32) {
    const int r = e / 16, c = e % 16, j = c / 8, u = c % 8;
    pa[j][r][2 * (u % 4) + u / 4] = a[e];
    if (r < 8) pb[j][r][2 * (u % 4) + u / 4] = b[e];
  }
  __syncwarp();
  double acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0;
  double2 x0[2], x1[2], y[2][8];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    x0[j] = *reinterpret_cast<const double2*>(&pa[j][g][2 * t]);
    x1[j] = *reinterpret_cast<const double2*>(&pa[j][g + 8][2 * t]);
#pragma unroll
    for (int n = 0; n < 8; ++n)
      y[j][n] = *reinterpret_cast<const double2*>(&pb[j][g][2 * t]);
  }
  if constexpr (S == 16) {
    kstep<16>(acc, x0, x1, y);
  } else {
    kstep<S>(acc, x0, x1, y);
    kstep<S>(acc, x0 + 1, x1 + 1, y + 1);
  }
  // slice 0 only (every slice read the same columns)
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

// `rounds` times, a warp's fragments of one k-step ([64][8] doubles of
// rows and of neighbours): Permuted, by 16-byte loads of (t, t + 4) in
// the panels' order 0 4 1 5 2 6 3 7; else in coordinate order, by two
// 8-byte loads, each an ld.volatile.shared so that none leaves the loop
// (ptxas hoists plain loads of memory the loop never writes).
__device__ __forceinline__ double2 lds128(const double* p) {
  double2 v;
  asm volatile("ld.volatile.shared.v2.f64 {%0, %1}, [%2];"
               : "=d"(v.x), "=d"(v.y)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}
__device__ __forceinline__ double lds64(const double* p) {
  double v;
  asm volatile("ld.volatile.shared.f64 %0, [%1];"
               : "=d"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

template <bool Permuted>
__global__ void __launch_bounds__(256, 1)
lds_rate(int rounds, long long* cycles, double* sink) {
  __shared__ __align__(16) double pa[64 * 8], pb[64 * 8];
  for (int i = threadIdx.x; i < 64 * 8; i += blockDim.x) {
    pa[i] = 1e-3 * i;
    pb[i] = 2e-3 * i;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
  const int g = lane / 4, t = lane % 4;
  double acc[10];
#pragma unroll
  for (int i = 0; i < 10; ++i) acc[i] = 0.0;
  const double* ar = pa + 8 * (16 * w + g);
  const double* br = pb + 8 * g;
  const long long t0 = clock64();
  for (int r = 0; r < rounds; ++r) {
    double2 x[10];
    if constexpr (Permuted) {
      x[0] = lds128(ar + 2 * t);
      x[1] = lds128(ar + 64 + 2 * t);
#pragma unroll
      for (int n = 0; n < 8; ++n) x[2 + n] = lds128(br + 64 * n + 2 * t);
    } else {
      x[0] = make_double2(lds64(ar + t), lds64(ar + t + 4));
      x[1] = make_double2(lds64(ar + 64 + t), lds64(ar + 64 + t + 4));
#pragma unroll
      for (int n = 0; n < 8; ++n)
        x[2 + n] = make_double2(lds64(br + 64 * n + t),
                                lds64(br + 64 * n + t + 4));
    }
#pragma unroll
    for (int i = 0; i < 10; ++i) acc[i] += x[i].x + x[i].y;
  }
  const long long t1 = clock64();
  if (lane == 0) cycles[blockIdx.x * 32 + threadIdx.x / 32] = t1 - t0;
  double s = 0.0;
#pragma unroll
  for (int i = 0; i < 10; ++i) s += acc[i];
  if (s == 1.2345) sink[0] = s;
}

}  // namespace

// shape: 0 (m8n8k4), 4, 8 or 16 (m16n8kS)
extern "C" int ppt_dmma_rate(int shape, int warps, int rounds,
                             long long* cycles, double* sink, int blocks) {
  const dim3 grid(blocks), block(32 * warps);
  switch (shape) {
    case 0: dmma_rate<0><<<grid, block>>>(rounds, cycles, sink); break;
    case 4: dmma_rate<4><<<grid, block>>>(rounds, cycles, sink); break;
    case 8: dmma_rate<8><<<grid, block>>>(rounds, cycles, sink); break;
    default: dmma_rate<16><<<grid, block>>>(rounds, cycles, sink); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ppt_lds_rate(int permuted, int warps, int rounds,
                            long long* cycles, double* sink, int blocks) {
  const dim3 grid(blocks), block(32 * warps);
  if (permuted)
    lds_rate<true><<<grid, block>>>(rounds, cycles, sink);
  else
    lds_rate<false><<<grid, block>>>(rounds, cycles, sink);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ppt_dmma_layout(int shape, const double* a, const double* b,
                               double* d) {
  switch (shape) {
    case 0: dmma_layout<0><<<1, 32>>>(a, b, d); break;
    case 4: dmma_layout<4><<<1, 32>>>(a, b, d); break;
    case 8: dmma_layout<8><<<1, 32>>>(a, b, d); break;
    default: dmma_layout<16><<<1, 32>>>(a, b, d); break;
  }
  return static_cast<int>(cudaGetLastError());
}

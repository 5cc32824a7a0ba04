// Whole-solve block-Jacobi PCG on stencil-form normal equations, in one
// launch of one thread-block cluster.
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
// Layouts: stencil_common.cuh.
//
// Design: one cluster of kCluster = 16 CTAs (a non-portable size, on 16
// SMs of one GPC) of up to 1024 threads runs the whole loop.  CTA c owns
// nodes [c*NL, c*NL + NL), NL = ceil(N / 16), one thread per (node, block
// row).  Only 6-float vectors cross SMs, never 36-float blocks: node n
// needs p at n + d_k and the back-product q_k = C_k^T p at n - d_k, both
// computed by their owners.  Two modes, one template:
//   kSmemOps = true   A, Minv, every C_k and x, z, Ap live in shared
//                     memory, copied there once per solve (sphere2500: 792
//                     B a node, 125 KB a CTA).  After updating p, each
//                     owner pushes p and q_k of its rows into the CTAs that
//                     need them (st.async into their buffers pf, qg, each
//                     store completing on the receiver's mbarrier); a CTA
//                     waits on its own mbarrier before the matvec.
//   kSmemOps = false  the operands stay in global memory (L2-resident
//                     within the 25 MB budget of ops/stencil_cg.py) and
//                     x, z, Ap in global scratch; p and q stay in shared
//                     memory, published by one cluster barrier an
//                     iteration, and readers fetch them remotely.
// The wrapper's predicates (ops/stencil_cg.py: stencil_cg_smem_fits,
// stencil_cg_fits) repeat the byte sums of smem_floats() below.
//
// Dot products: each CTA sums its threads' partials in a fixed order
// (shuffles, then warp 0 over the warps) and pushes its sum into slot
// [rank] of every CTA (st.async on the receiver's mbarrier); each thread
// then adds the kCluster slots in rank order.  Every CTA so gets the same
// alpha and beta bits and takes the same branch, and the iteration count
// repeats from run to run.  Why no cluster barriers: barrier.cluster's
// release/acquire compiles to MEMBAR.ALL.GPU and an L1 invalidation and
// costs ~0.9 us an exchange on an H100, an st.async exchange ~0.37 us
// (pypose_tpu_torch/probes/cluster_exchange.cu).  No buffer needs double
// buffering: a CTA pushes the next iteration's data only after a
// reduction to which every receiver contributed after its last read.
//
// What bounds it on an H100: the chain of dependent steps, not bytes or
// FLOPs.  The arithmetic is ~252 FMA per node per iteration (2500 nodes:
// 2.8 us for 150 iterations at 67 TFLOP/s) and the operands are 1.56 MB;
// each iteration waits for three cluster-wide exchanges and four in-CTA
// barriers, and with ~30 warps an SM each phase's instructions take
// hundreds of issue cycles (pypose_tpu_torch/probes/cluster_probes.py
// times the phases).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see pypose_tpu_torch/ops/_build.py)

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "stencil_common.cuh"

namespace cg = cooperative_groups;

namespace {

using ppt::Offsets;

constexpr int kT = 6;
constexpr int kTT = kT * kT;
constexpr int kCluster = 16;
constexpr int kMaxThreads = 1024;
// floats ahead of the vectors: the p.Ap slots [16], the r.z / |r|^2 slots
// [2][16], three mbarriers (8 bytes each) and the per-warp partials [2][32]
constexpr int kHeader = 128;
constexpr int kSlotA = 0, kSlotB = 16, kMbar = 48, kWarpPart = 64;
constexpr int kMbarA = 0, kMbarB = 1, kMbarG = 2;

// Floats of dynamic shared memory per CTA: p, r (2t) in both modes; q
// (n_off t) with the operands in L2; with the operands in shared memory,
// x, z, Ap (3t), the pushed p at n + d_k and q_k at n - d_k (2 n_off t),
// A, Minv (2tt) and every C_k (n_off tt).
size_t smem_floats(bool smem_ops, int NL, int n_off) {
  const size_t k = static_cast<size_t>(n_off);
  size_t per_node = 2 * kT;
  per_node += smem_ops ? 3 * kT + 2 * k * kT + 2 * kTT + k * kTT : k * kT;
  return kHeader + per_node * NL;
}

// ---- st.async and mbarriers (PTX) ----------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// The same shared-memory address in the CTA of cluster rank `rank`.
__device__ __forceinline__ unsigned in_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Stores v at `addr` of another CTA (or this one), completing 4 bytes of
// the transaction count of the mbarrier at `mbar` in that CTA.
__device__ __forceinline__ void push(unsigned addr, float v, unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];"
      :: "r"(addr), "r"(__float_as_uint(v)), "r"(mbar) : "memory");
}

// This CTA's one arrival on its mbarrier for the current phase, expecting
// `bytes` of pushes.
__device__ __forceinline__ void expect(unsigned mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(mbar), "r"(bytes) : "memory");
}

// Waits until the mbarrier's phase of parity `phase` completes.  A wait
// that polls kMaxPolls times (seconds; a solve waits microseconds) means
// pushes went missing: it traps, so the launch fails instead of hanging.
constexpr unsigned kMaxPolls = 1u << 26;
__device__ __forceinline__ void wait_phase(unsigned mbar, int phase) {
  unsigned done = 0;
  for (unsigned polls = 0; !done; ++polls) {
    if (polls == kMaxPolls) __trap();
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(mbar), "r"(phase) : "memory");
  }
}

// Cluster-wide sums of NV values, the same bits in every thread of every
// CTA (see the file comment); `phase` is the mbarrier's, flipped here.
template <int NV>
__device__ __forceinline__ void cluster_sum(float (&v)[NV], float* sm,
                                            int slot, int mbar, int& phase,
                                            int rank) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned bar = smem_addr(sm + kMbar) + 8 * mbar;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    for (int o = 16; o > 0; o >>= 1)
      v[c] += __shfl_down_sync(0xffffffffu, v[c], o);
    if (lane == 0) sm[kWarpPart + 32 * c + warp] = v[c];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      float a = lane < nwarps ? sm[kWarpPart + 32 * c + lane] : 0.f;
      for (int o = 16; o > 0; o >>= 1)
        a += __shfl_down_sync(0xffffffffu, a, o);
      a = __shfl_sync(0xffffffffu, a, 0);
      if (lane < kCluster)
        push(in_rank(smem_addr(sm + slot + kCluster * c + rank), lane), a,
             in_rank(bar, lane));
    }
    if (lane == 0) expect(bar, 4 * kCluster * NV);
  }
  wait_phase(bar, phase);
  phase ^= 1;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    const float4* s4 =
        reinterpret_cast<const float4*>(sm + slot + kCluster * c);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster / 4; ++q) {
      const float4 w = s4[q];
      s += w.x;
      s += w.y;
      s += w.z;
      s += w.w;
    }
    v[c] = s;
  }
}

template <bool kSmemOps>
__global__ void __launch_bounds__(kMaxThreads, 1)
stencil_pcg_cluster(const float* __restrict__ b, const float* __restrict__ A,
                    const float* __restrict__ Minv,
                    const float* __restrict__ C, Offsets offs, int n_off,
                    int N, int NL, int maxiter, float tol2_scale,
                    float* x_out, float* scratch, int* it_out) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int n0 = rank * NL;
  const int n_own = max(0, min(NL, N - n0));
  const size_t NN = static_cast<size_t>(N);

  float* p = sm + kHeader;  // [t][NL]
  float* r = p + kT * NL;   // [t][NL]
  float* q = nullptr;       // [n_off][t][NL], operands in L2: read remotely
  float* pf = nullptr;      // [n_off][t][NL]: p at n + d_k, pushed here
  float* qg = nullptr;      // [n_off][t][NL]: q_k at n - d_k, pushed here
  float *x, *z, *Ap;        // [t][vs]
  const float *Ao, *Mo, *Co;  // [tt][os], [tt][os], [n_off*tt][os]
  int vs, os;               // row strides (N < 2^31 / (16 tt) here)
  if constexpr (kSmemOps) {
    x = r + kT * NL;
    z = x + kT * NL;
    Ap = z + kT * NL;
    pf = Ap + kT * NL;
    qg = pf + n_off * kT * NL;
    float* a = qg + n_off * kT * NL;
    float* m = a + kTT * NL;
    float* c = m + kTT * NL;
    for (int e = threadIdx.x; e < kTT * n_own; e += blockDim.x) {
      const int i = e / n_own, nl = e - i * n_own;
      a[i * NL + nl] = A[i * NN + n0 + nl];
      m[i * NL + nl] = Minv[i * NN + n0 + nl];
    }
    for (int e = threadIdx.x; e < n_off * kTT * n_own; e += blockDim.x) {
      const int i = e / n_own, nl = e - i * n_own;
      c[i * NL + nl] = C[i * NN + n0 + nl];
    }
    Ao = a;
    Mo = m;
    Co = c;
    vs = os = NL;
  } else {
    q = r + kT * NL;
    x = x_out + n0;
    z = scratch + n0;
    Ap = scratch + kT * NN + n0;
    Ao = A + n0;
    Mo = Minv + n0;
    Co = C + n0;
    vs = os = N;
  }
  const unsigned mbar0 = smem_addr(sm + kMbar);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(mbar0 + 8 * k));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();  // every mbarrier is initialised before the first push
  int phase_a = 0, phase_b = 0, phase_g = 0;

  // This thread's rows j = threadIdx.x + m * blockDim.x, as (block row i,
  // local node nl) with j = i * n_own + nl, stepped without divisions.
  const int i0 = n_own > 0 ? static_cast<int>(threadIdx.x) / n_own : kT;
  const int nl0 = n_own > 0 ? static_cast<int>(threadIdx.x) - i0 * n_own : 0;
  const int di = n_own > 0 ? static_cast<int>(blockDim.x) / n_own : 0;
  const int dnl = static_cast<int>(blockDim.x) - di * n_own;
  auto for_rows = [&](auto&& f) {
    int i = i0, nl = nl0;
    while (i < kT) {
      f(i, nl);
      i += di;
      nl += dnl;
      if (nl >= n_own) {
        nl -= n_own;
        ++i;
      }
    }
  };
  // owner CTA of node m: m / NL through a float reciprocal (exact with the
  // 0.5 margin for N < 2^20)
  const float inv_nl = 1.f / static_cast<float>(NL);
  auto owner = [&](int m) {
    return min(kCluster - 1,
               __float2int_rd((static_cast<float>(m) + 0.5f) * inv_nl));
  };
  // q_k = C_k^T p at row (i, nl), from this CTA's p
  auto back = [&](int k, int i, int nl) {
    const float* ck = Co + k * kTT * os;
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < kT; ++u)
      acc += ck[(u * kT + i) * os + nl] * p[u * NL + nl];
    return acc;
  };
  // operands in shared memory: push p_i at node n0 + nl to the node at
  // -d_k and q_k,i to the node at +d_k, for every k
  auto push_p = [&](int i, int nl) {
    const int m = n0 + nl;
    const float v = p[i * NL + nl];
    for (int k = 0; k < n_off; ++k) {
      int n = m - offs.d[k];
      if (n < 0) n += N;
      const int o = owner(n);
      push(in_rank(smem_addr(pf + (k * kT + i) * NL + n - o * NL), o), v,
           in_rank(mbar0 + 8 * kMbarG, o));
    }
  };
  auto push_q = [&](int i, int nl) {
    const int m = n0 + nl;
    for (int k = 0; k < n_off; ++k) {
      int n = m + offs.d[k];
      if (n >= N) n -= N;
      const int o = owner(n);
      push(in_rank(smem_addr(qg + (k * kT + i) * NL + n - o * NL), o),
           back(k, i, nl), in_rank(mbar0 + 8 * kMbarG, o));
    }
  };
  // operands in L2: store q for the readers
  auto store_q = [&](int i, int nl) {
    for (int k = 0; k < n_off; ++k) q[(k * kT + i) * NL + nl] = back(k, i, nl);
  };
  // z = Minv r at row (i, nl)
  auto precond = [&](int i, int nl) {
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < kT; ++u)
      acc += Mo[(i * kT + u) * os + nl] * r[u * NL + nl];
    return acc;
  };

  // x = 0, r = b, z = Minv r, p = z; r.z and |b|^2
  float part[2] = {0.f, 0.f};
  for_rows([&](int i, int nl) {
    const float bv = b[i * NN + n0 + nl];
    r[i * NL + nl] = bv;
    x[i * vs + nl] = 0.f;
    part[1] += bv * bv;
  });
  __syncthreads();
  for_rows([&](int i, int nl) {
    const float zi = precond(i, nl);
    z[i * vs + nl] = zi;
    p[i * NL + nl] = zi;
    part[0] += r[i * NL + nl] * zi;
  });
  cluster_sum<2>(part, sm, kSlotB, kMbarB, phase_b, rank);
  float gamma = part[0];
  float rr = part[1];
  const float tol2 = tol2_scale * part[1];
  // p and q for the first matvec (pushed only if it runs: every push is
  // waited for)
  if (maxiter > 0 && rr > tol2) {
    if constexpr (kSmemOps) {
      for_rows([&](int i, int nl) {
        push_p(i, nl);
        push_q(i, nl);
      });
    } else {
      for_rows(store_q);
      cl.sync();
    }
  }
  int it = 0;

  while (it < maxiter && rr > tol2) {
    // Ap = A p (p at n + d_k, q_k at n - d_k) and p.Ap
    if constexpr (kSmemOps) {
      if (threadIdx.x == 0)
        expect(mbar0 + 8 * kMbarG, 4 * 2 * n_off * kT * n_own);
      wait_phase(mbar0 + 8 * kMbarG, phase_g);
      phase_g ^= 1;
    }
    float pap[1] = {0.f};
    for_rows([&](int i, int nl) {
      const int n = n0 + nl;
      float y = 0.f;
#pragma unroll
      for (int u = 0; u < kT; ++u)
        y += Ao[(i * kT + u) * os + nl] * p[u * NL + nl];
      for (int k = 0; k < n_off; ++k) {
        const float* pk;
        float qb;
        if constexpr (kSmemOps) {
          pk = pf + k * kT * NL + nl;
          qb = qg[(k * kT + i) * NL + nl];
        } else {
          const int d = offs.d[k];
          int nf = n + d;
          if (nf >= N) nf -= N;
          int nb = n - d;
          if (nb < 0) nb += N;
          const int of = owner(nf), ob = owner(nb);
          pk = cl.map_shared_rank(p, of) + nf - of * NL;
          qb = cl.map_shared_rank(q, ob)[(k * kT + i) * NL + nb - ob * NL];
        }
        const float* ck = Co + (k * kT + i) * kT * os;
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < kT; ++u) acc += ck[u * os + nl] * pk[u * NL];
        y += acc;
        y += qb;
      }
      Ap[i * vs + nl] = y;
      pap[0] += p[i * NL + nl] * y;
    });
    cluster_sum<1>(pap, sm, kSlotA, kMbarA, phase_a, rank);
    const float alpha = gamma / (pap[0] == 0.f ? 1e-31f : pap[0]);

    // x += alpha p, r -= alpha Ap, z = Minv r; new r.z and |r|^2
    float nxt[2] = {0.f, 0.f};
    for_rows([&](int i, int nl) {
      x[i * vs + nl] += alpha * p[i * NL + nl];
      const float rv = r[i * NL + nl] - alpha * Ap[i * vs + nl];
      r[i * NL + nl] = rv;
      nxt[1] += rv * rv;
    });
    __syncthreads();
    for_rows([&](int i, int nl) {
      const float zi = precond(i, nl);
      z[i * vs + nl] = zi;
      nxt[0] += r[i * NL + nl] * zi;
    });
    cluster_sum<2>(nxt, sm, kSlotB, kMbarB, phase_b, rank);
    const float beta = nxt[0] / (gamma == 0.f ? 1e-31f : gamma);
    const bool more = it + 1 < maxiter && nxt[1] > tol2;

    // p = z + beta p; p and q = C^T p to the next matvec, if there is one
    for_rows([&](int i, int nl) {
      p[i * NL + nl] = z[i * vs + nl] + beta * p[i * NL + nl];
    });
    __syncthreads();
    if (more) {
      if constexpr (kSmemOps) {
        for_rows([&](int i, int nl) {
          push_p(i, nl);
          push_q(i, nl);
        });
      } else {
        for_rows(store_q);
        cl.sync();
      }
    }
    gamma = nxt[0];
    rr = nxt[1];
    ++it;
  }
  if constexpr (kSmemOps) {
    for_rows([&](int i, int nl) {
      x_out[i * NN + n0 + nl] = x[i * NL + nl];
    });
  }
  if (rank == 0 && threadIdx.x == 0) *it_out = it;
  cl.sync();  // no CTA leaves while another may still read its memory
}

// Largest dynamic shared memory a block may opt into on this device.
int smem_optin_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

template <bool kSmemOps>
cudaError_t launch(const float* b, const float* A, const float* Minv,
                   const float* C, const Offsets& offs, int n_off, int N,
                   int NL, int maxiter, float tol2_scale, float* x,
                   float* scratch, int* it, size_t bytes,
                   cudaStream_t stream) {
  auto kernel = stencil_pcg_cluster<kSmemOps>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  // one thread per (node, block row) of the largest CTA, whole warps
  const int threads =
      std::min(kMaxThreads, std::max(32, (kT * NL + 31) / 32 * 32));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorInvalidClusterSize;
  e = cudaLaunchKernelEx(&cfg, kernel, b, A, Minv, C, offs, n_off, N, NL,
                         maxiter, tol2_scale, x, scratch, it);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the solve on `stream` and returns a CUDA error code (0 on
// success).  `offsets` is a host array of n_off circular offsets in
// [0, N); `scratch` holds 2*t*N floats (z and Ap when the operands do not
// fit shared memory); `it` receives the iteration count.  Only t = 6 is
// instantiated.  The operands go to shared memory when smem_floats(true)
// fits the device's opt-in limit, else the state alone must fit
// (cudaErrorInvalidValue if not); a cluster of 16 that cannot be placed
// returns cudaErrorInvalidClusterSize.
int ppt_stencil_pcg(int t, const float* b, const float* A, const float* Minv,
                    const float* C, const int* offsets, int n_off, int N,
                    int maxiter, double tol, float* x, float* scratch,
                    int* it, void* stream) {
  Offsets offs;
  if (!ppt::make_offsets(offsets, n_off, &offs) || N <= 0 || t != kT)
    return static_cast<int>(cudaErrorInvalidValue);
  // same rounding as (tol * tol) * |b|^2 with a float32 |b|^2
  const float tol2_scale = static_cast<float>(tol * tol);
  const int NL = (N + kCluster - 1) / kCluster;
  const size_t limit = static_cast<size_t>(smem_optin_bytes());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t with_ops = sizeof(float) * smem_floats(true, NL, n_off);
  if (with_ops <= limit)
    return static_cast<int>(launch<true>(b, A, Minv, C, offs, n_off, N, NL,
                                         maxiter, tol2_scale, x, scratch, it,
                                         with_ops, s));
  const size_t state = sizeof(float) * smem_floats(false, NL, n_off);
  if (state > limit) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<false>(b, A, Minv, C, offs, n_off, N, NL,
                                        maxiter, tol2_scale, x, scratch, it,
                                        state, s));
}

const char* ppt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Chronopoulos-Gear block-Jacobi PCG on stencil-form normal equations: the
// whole solve in one persistent, cooperative launch over all SMs.
//
// Replaces the TPU kernels of pypose_tpu/ops/pallas_cg.py:stencil_cg_fused,
// and the while_loop that drives them (:408-444):
//   _fused_axpy_kernel (:253)  pass 1: given (alpha, beta),
//                              p = u + beta p, s = w + beta s,
//                              x += alpha p, r -= alpha s, u = Minv r,
//                              and the dots gamma = (r, u), rr = (r, r);
//   _fused_mv_kernel (:290)    pass 2: w = A u and the dot delta = (w, u).
// It computes what that loop computes: an init pass 1 with alpha = beta = 0
// on zero u, p, s, w, x and r = b (x0 = 0, r0 = b, u0 = Minv b, gamma0,
// rr0 = |b|^2) and its pass 2 (w0, delta0); then, while it < maxiter and
// rr > tol^2 rr0, beta = gamma / gamma_prev (0 at it = 0), alpha = gamma /
// (delta - beta gamma / alpha_prev) (gamma / delta at it = 0), with the
// 1e-31 guards on every divisor.  The last pass 2, whose w no iterate
// reads, is skipped.  Operands are float32 or bf16 (operand_dtype of the
// JAX function: each entry widened exactly, all arithmetic float32).
//
// Design: G co-resident CTAs, one per SM (G = ceil(N / NL), NL =
// ceil(N / SMs), fewer CTAs for systems under 8 nodes a CTA), launched
// cooperatively so that every CTA is resident.  CTA c owns nodes
// [c NL, c NL + NL) for the whole solve, one thread per node.  Only u
// crosses CTAs (the matvec reads u at n +- d_k), through a global [t, N]
// copy read past L1.  Two grid-wide exchanges an iteration:
//   after pass 1   u, and each CTA's gamma and rr partials;
//   after pass 2   each CTA's delta partial.
// An exchange is its own barrier: each CTA sums its threads' partials in a
// fixed order (stencil_common.cuh), and one thread posts them to the CTA's
// mailbox as 64-bit words (partial, exchange number) by release stores;
// every CTA polls all G mailboxes by acquire loads, one a lane spread over
// its warps so that the polls wait at once, until each shows the
// exchange's number, and adds the partials in an order fixed by G, so
// every CTA computes the same alpha, beta and stop decision bit for bit,
// and two launches give the same bits.  No atomics, and the sums arrive
// with the barrier.  Mailboxes alternate between two sets (pass 1 and
// pass 2), so a CTA never overwrites a post another CTA has yet to read.
// A poll that spins 2^26 times traps, so a lost post fails the launch
// instead of hanging.
// The block size t is a template parameter, instantiated for 3, 4, 6 and 7
// (the tangent dimensions of SO3, RxSO3, SE3 and Sim3; the Pallas kernels
// take any static t).  Two modes, one template:
//   kSmem = true   x, r, p, s, w, this CTA's u (6t floats a node) and its
//                  Minv, widened to float32 (tt floats), live in shared
//                  memory: at t = 6 288 B a node, 218 KB a CTA at the
//                  100k-pose graph (N = 100,000 on 132 SMs: NL = 758); at
//                  t = 7 364 B a node, so at most 637 nodes a CTA and the
//                  100k-pose graph takes the second mode;
//   kSmem = false  past that, they stay in global memory (x in the output,
//                  r, p, s, w in scratch, u in the global copy), each
//                  thread touching only its own nodes.
// A and C are read from L2 / device memory on every pass 2.
//
// The loop moves the recursion's p = u + beta p, s = w + beta s to the end
// of the previous iteration (beta needs gamma alone), so they run while a
// CTA waits for the delta exchange, and computes A u at its own nodes
// while it waits for the others' u: the same operations in the same order
// per node.
//
// What bounds it on an H100 (probes/fused_probes.py, cycles of thread 0 a
// CTA per iteration; t = 6): in float32 at the 100k shape, device memory:
// A and C (43.2 MB) do not stay in the 50 MB L2 from one iteration to the next
// (L2 eviction hints and prefetches did not change that), and the
// couplings of pass 2 take ~27k of ~47k cycles; in bf16 (21.6 MB, L2-
// resident) the latency of each thread's chain of operand loads in pass 2
// (~15k cycles); under both, ~6-7k cycles of exchanges, and at N=53, a
// latency floor of ~18k cycles an iteration.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see pypose_tpu_torch/ops/_build.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "stencil_common.cuh"

namespace {

using ppt::Offsets;

// 85 registers a thread: enough loads in flight for the matvec
constexpr int kMaxThreads = 768;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMinNodes = 8;  // nodes a CTA, least
// bytes of static shared memory kept clear of the dynamic allocation
constexpr int kStaticBytes = 512;
constexpr unsigned kMaxPolls = 1u << 26;

// Floats of dynamic shared memory a CTA holds in the first mode.
size_t smem_floats(int NL, int t) {
  return static_cast<size_t>(NL) * (6 * t + t * t);
}

__device__ __forceinline__ float guard(float v) {
  return v == 0.f ? 1e-31f : v;
}

__device__ __forceinline__ unsigned long long word(float v, unsigned e) {
  return (static_cast<unsigned long long>(e) << 32) | __float_as_uint(v);
}

// Posts this CTA's partials (v0, v1) of exchange e to its mailbox `mb`
// (two words); one thread, after a barrier that follows every write the
// exchange publishes (the release covers them).
__device__ __forceinline__ void post(unsigned long long* mb, float v0,
                                     float v1, unsigned e) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(mb + 1), "l"(word(v1, e)) : "memory");
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(mb), "l"(word(v0, e)) : "memory");
}

// Waits for exchange e in all G mailboxes of `set` and returns, in every
// thread, the sums of their NV partials: mailbox m is polled by lane
// m % 32 of warp (m / 32) % W (W warps a CTA), so that the polls of up to
// 32 W mailboxes wait at once; each lane adds its mailboxes in order, each
// warp shuffles its lanes' sums down, and every thread adds the warps'
// sums in warp order (through `tot`, kMaxWarps * NV floats).  The order is
// fixed by G and W alone, the same in every CTA.
template <int NV>
__device__ __forceinline__ void gather(const unsigned long long* set, int G,
                                       unsigned e, float (&v)[NV],
                                       float* tot) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float a[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) a[c] = 0.f;
  for (int m = threadIdx.x; m < G; m += blockDim.x) {
    const unsigned long long* mb = set + 2 * m;
    unsigned long long w0;
    for (unsigned polls = 0;; ++polls) {
      if (polls == kMaxPolls) __trap();
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
                   : "=l"(w0) : "l"(mb) : "memory");
      if (static_cast<unsigned>(w0 >> 32) == e) break;
    }
    a[0] += __uint_as_float(static_cast<unsigned>(w0));
    if (NV > 1) {
      unsigned long long w1;
      asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                   : "=l"(w1) : "l"(mb + 1) : "memory");
      a[NV - 1] += __uint_as_float(static_cast<unsigned>(w1));
    }
  }
  const int warps = min(static_cast<int>(blockDim.x) >> 5, (G + 31) >> 5);
  if (warp < warps) {
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      for (int o = 16; o > 0; o >>= 1)
        a[c] += __shfl_down_sync(0xffffffffu, a[c], o);
      if (lane == 0) tot[warp * NV + c] = a[c];
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    float sum = 0.f;
    for (int k = 0; k < warps; ++k) sum += tot[k * NV + c];
    v[c] = sum;
  }
}

template <int T, typename OpT, bool kSmem>
__global__ void __launch_bounds__(kMaxThreads, 1)
fused_pcg(const float* __restrict__ b, const OpT* __restrict__ A,
          const OpT* __restrict__ Minv, const OpT* __restrict__ C,
          Offsets offs, int n_off, int N, int NL, int maxiter,
          float tol2_scale, float* __restrict__ x_out, float* u,
          float* __restrict__ scratch, unsigned long long* mail,
          int* it_out) {
  extern __shared__ __align__(16) float sm[];
  constexpr int TT = T * T;
  __shared__ float red[66];  // ppt::block_sum2
  __shared__ float tot[kMaxWarps * 2];
  const int G = static_cast<int>(gridDim.x);
  const int n0 = static_cast<int>(blockIdx.x) * NL;
  const int n_own = max(0, min(NL, N - n0));
  const size_t NN = static_cast<size_t>(N);

  // x, r, p, s, w and this CTA's u as [t][vs] (node nl of this CTA at
  // i * vs + nl)
  float *x, *r, *p, *s, *w, *uo;
  const float* Ms = nullptr;  // this CTA's Minv, [tt][NL], first mode
  int vs;
  if constexpr (kSmem) {
    x = sm;
    vs = NL;
    float* m = sm + 6 * T * NL;
    for (int e = threadIdx.x; e < TT * n_own; e += blockDim.x) {
      const int i = e / n_own, nl = e - i * n_own;
      m[i * NL + nl] = ppt::to_f32(Minv[i * NN + n0 + nl]);
    }
    Ms = m;
  } else {
    x = x_out + n0;
    vs = N;
  }
  r = (kSmem ? x + T * NL : scratch + n0);
  p = r + T * static_cast<size_t>(vs);
  s = p + T * static_cast<size_t>(vs);
  w = s + T * static_cast<size_t>(vs);
  uo = kSmem ? w + T * NL : u + n0;

  // x = p = s = w = u = 0, r = b: pass 1 with alpha = 0 then gives the
  // init pass's x0, r0, u0
  for (int nl = threadIdx.x; nl < n_own; nl += blockDim.x) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const int j = i * vs + nl;
      r[j] = b[i * NN + n0 + nl];
      x[j] = p[j] = s[j] = w[j] = uo[j] = 0.f;
    }
  }
  __syncthreads();  // Minv staged

  unsigned long long* mail_1 = mail + 2 * G;  // pass 1's mailboxes
  unsigned long long* mail_2 = mail;          // pass 2's mailboxes
  unsigned e = 0;                             // exchanges so far
  float alpha = 0.f, gamma = 0.f, tol2 = 0.f;
  int it = 0;
  for (bool init = true;; init = false) {
    // pass 1: x += alpha p, r -= alpha s, u = Minv r, (r, u) and (r, r)
    float part[2] = {0.f, 0.f};
    for (int nl = threadIdx.x; nl < n_own; nl += blockDim.x) {
      const size_t n = static_cast<size_t>(n0 + nl);
      float rv[T], zv[T];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int j = i * vs + nl;
        x[j] = x[j] + alpha * p[j];
        rv[i] = r[j] - alpha * s[j];
        r[j] = rv[i];
        zv[i] = 0.f;
      }
      if constexpr (kSmem)
        ppt::block_mul_add<T, false>(Ms, NL, nl, rv, zv);
      else
        ppt::block_mul_add<T, false>(Minv, NN, static_cast<int>(n), rv, zv);
#pragma unroll
      for (int i = 0; i < T; ++i) {
        uo[i * vs + nl] = zv[i];
        if (kSmem) u[i * NN + n] = zv[i];
        part[0] += rv[i] * zv[i];
        part[1] += rv[i] * rv[i];
      }
    }
    ppt::block_sum2(part[0], part[1], red);  // after every u write
    ++e;
    if (threadIdx.x == 0) post(mail_1 + 2 * blockIdx.x, part[0], part[1], e);

    // while the others post: w = A u at this CTA's nodes (own u only)
    for (int nl = threadIdx.x; nl < n_own; nl += blockDim.x) {
      float un[T], y[T];
#pragma unroll
      for (int i = 0; i < T; ++i) {
        un[i] = uo[i * vs + nl];
        y[i] = 0.f;
      }
      ppt::block_mul_add<T, false>(A, NN, n0 + nl, un, y);
#pragma unroll
      for (int i = 0; i < T; ++i) w[i * vs + nl] = y[i];
    }
    float dots[2];
    gather<2>(mail_1, G, e, dots, tot);
    if (init)
      tol2 = tol2_scale * dots[1];
    else
      ++it;
    if (!(it < maxiter && dots[1] > tol2)) break;

    // pass 2: w += the couplings (u at n +- d_k), (w, u)
    float wu = 0.f, unused = 0.f;
    for (int nl = threadIdx.x; nl < n_own; nl += blockDim.x) {
      const int n = n0 + nl;
      float y[T], q[T];
#pragma unroll
      for (int i = 0; i < T; ++i) y[i] = w[i * vs + nl];
      for (int k = 0; k < n_off; ++k) {
        const int d = offs.d[k];
        const OpT* Ck = C + k * TT * NN;
        int nf = n + d;
        if (nf >= N) nf -= N;
        int nb = n - d;
        if (nb < 0) nb += N;
#pragma unroll
        for (int v = 0; v < T; ++v) q[v] = __ldcg(u + v * NN + nf);
        ppt::block_mul_add<T, false>(Ck, NN, n, q, y);
#pragma unroll
        for (int v = 0; v < T; ++v) q[v] = __ldcg(u + v * NN + nb);
        ppt::block_mul_add<T, true>(Ck, NN, nb, q, y);
      }
#pragma unroll
      for (int i = 0; i < T; ++i) {
        w[i * vs + nl] = y[i];
        wu += y[i] * uo[i * vs + nl];
      }
    }
    ppt::block_sum2(wu, unused, red);
    ++e;
    if (threadIdx.x == 0) post(mail_2 + 2 * blockIdx.x, wu, 0.f, e);

    // while the others post: beta (0 in the first iteration), then
    // p = u + beta p, s = w + beta s
    const float beta = init ? 0.f : dots[0] / guard(gamma);
    for (int nl = threadIdx.x; nl < n_own; nl += blockDim.x) {
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int j = i * vs + nl;
        p[j] = uo[j] + beta * p[j];
        s[j] = w[j] + beta * s[j];
      }
    }
    float delta[1];
    gather<1>(mail_2, G, e, delta, tot);
    // alpha = gamma / delta in the first iteration, else gamma / (delta -
    // beta gamma / alpha_prev)
    const float den =
        init ? delta[0] : delta[0] - beta * dots[0] / guard(alpha);
    alpha = dots[0] / guard(den);
    gamma = dots[0];
  }
  if constexpr (kSmem) {
    for (int nl = threadIdx.x; nl < n_own; nl += blockDim.x) {
#pragma unroll
      for (int i = 0; i < T; ++i) x_out[i * NN + n0 + nl] = x[i * vs + nl];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *it_out = it;
}

struct Plan {
  int grid, NL, threads, smem;
};

// The layout of a solve of N nodes on the current device (see the file
// comment); false if the device query fails.
bool make_plan(int N, int t, Plan* out) {
  int dev = 0, sms = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  const int want = std::max(1, std::min(sms, N / kMinNodes));
  const int NL = (N + want - 1) / want;
  out->NL = NL;
  out->grid = (N + NL - 1) / NL;
  out->threads = std::min(kMaxThreads, (NL + 31) / 32 * 32);
  out->smem = sizeof(float) * smem_floats(NL, t) + kStaticBytes <=
              static_cast<size_t>(optin);
  return true;
}

template <int T, typename OpT, bool kSmem>
cudaError_t launch(const Plan& plan, const float* b, const OpT* A,
                   const OpT* Minv, const OpT* C, Offsets offs, int n_off,
                   int N, int maxiter, float tol2_scale, float* x, float* u,
                   float* scratch, unsigned long long* mail, int* it,
                   cudaStream_t stream) {
  auto kernel = fused_pcg<T, OpT, kSmem>;
  const size_t bytes = kSmem ? sizeof(float) * smem_floats(plan.NL, T) : 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  // every CTA must be resident at once: an exchange waits for all of them
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      plan.threads, bytes);
  if (e != cudaSuccess) return e;
  if (per_sm * sms < plan.grid) return cudaErrorCooperativeLaunchTooLarge;
  int NL = plan.NL;
  void* args[] = {&b, &A, &Minv, &C, &offs, &n_off, &N, &NL, &maxiter,
                  &tol2_scale, &x, &u, &scratch, &mail, &it};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                  dim3(plan.grid), dim3(plan.threads), args,
                                  bytes, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int T, typename OpT>
int solve(const float* b, const void* A, const void* Minv, const void* C,
          const int* offsets, int n_off, int N, int maxiter, double tol,
          float* x, float* u, float* scratch, unsigned long long* mail,
          int* it, void* stream) {
  Offsets offs;
  Plan plan;
  if (!ppt::make_offsets(offsets, n_off, &offs) || N <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!make_plan(N, T, &plan))
    return static_cast<int>(cudaErrorInvalidDevice);
  // same rounding as (tol * tol) * |b|^2 with a float32 |b|^2
  const float tol2_scale = static_cast<float>(tol * tol);
  const auto* a = static_cast<const OpT*>(A);
  const auto* m = static_cast<const OpT*>(Minv);
  const auto* c = static_cast<const OpT*>(C);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      plan.smem
          ? launch<T, OpT, true>(plan, b, a, m, c, offs, n_off, N, maxiter,
                                 tol2_scale, x, u, scratch, mail, it, s)
          : launch<T, OpT, false>(plan, b, a, m, c, offs, n_off, N, maxiter,
                                  tol2_scale, x, u, scratch, mail, it, s);
  return static_cast<int>(e);
}

// True for the block sizes the kernel is instantiated for.
bool block_size_ok(int t) { return t == 3 || t == 4 || t == 6 || t == 7; }

template <typename OpT>
int solve_t(int t, const float* b, const void* A, const void* Minv,
            const void* C, const int* offsets, int n_off, int N, int maxiter,
            double tol, float* x, float* u, float* scratch,
            unsigned long long* mail, int* it, void* stream) {
  switch (t) {
    case 3:
      return solve<3, OpT>(b, A, Minv, C, offsets, n_off, N, maxiter, tol, x,
                           u, scratch, mail, it, stream);
    case 4:
      return solve<4, OpT>(b, A, Minv, C, offsets, n_off, N, maxiter, tol, x,
                           u, scratch, mail, it, stream);
    case 6:
      return solve<6, OpT>(b, A, Minv, C, offsets, n_off, N, maxiter, tol, x,
                           u, scratch, mail, it, stream);
    case 7:
      return solve<7, OpT>(b, A, Minv, C, offsets, n_off, N, maxiter, tol, x,
                           u, scratch, mail, it, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// The layout of a solve of N nodes of block size t on the current device:
// out[0] CTAs, out[1] nodes a CTA, out[2] threads a CTA, out[3] 1 if the
// state and Minv live in shared memory (6t + tt floats a node).
// ppt_fused_pcg's mailboxes hold 4 * out[0] 64-bit words.  Returns a CUDA
// error code (0 on success).
int ppt_fused_plan(int N, int t, int* out) {
  Plan plan;
  if (N <= 0 || !block_size_ok(t))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!make_plan(N, t, &plan))
    return static_cast<int>(cudaErrorInvalidDevice);
  out[0] = plan.grid;
  out[1] = plan.NL;
  out[2] = plan.threads;
  out[3] = plan.smem;
  return 0;
}

// The whole solve in one launch on `stream`; returns a CUDA error code (0
// on success; a launch the device cannot hold all at once returns
// cudaErrorCooperativeLaunchTooLarge).  b, x, u [t, N] float32; A, Minv
// [t*t, N] and C [n_off*t*t, N] float32 (bf16 = 0) or bf16 (bf16 = 1);
// `offsets` a host array of n_off circular offsets in [0, N); scratch
// 4*t*N floats (r, p, s, w, used past the shared-memory mode); `mail`
// 4 * ppt_fused_plan's CTAs 64-bit words, zero; `it` receives the
// iteration count.  Instantiated for t = 3, 4, 6 and 7 (any other t:
// cudaErrorInvalidValue).
int ppt_fused_pcg(int t, int bf16, const float* b, const void* A,
                  const void* Minv, const void* C, const int* offsets,
                  int n_off, int N, int maxiter, double tol, float* x,
                  float* u, float* scratch, unsigned long long* mail,
                  int* it, void* stream) {
  return bf16 ? solve_t<__nv_bfloat16>(t, b, A, Minv, C, offsets, n_off, N,
                                       maxiter, tol, x, u, scratch, mail,
                                       it, stream)
              : solve_t<float>(t, b, A, Minv, C, offsets, n_off, N, maxiter,
                               tol, x, u, scratch, mail, it, stream);
}

const char* ppt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

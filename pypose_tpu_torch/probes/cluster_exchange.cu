// Cost of one cluster-wide exchange on this card, 16 CTAs of `threads`
// threads in one cluster (a non-portable size): each CTA writes one float
// into every CTA's shared memory, the cluster synchronises, and each CTA
// reads the 16 floats back.  Variants of the synchronisation:
//   0  cooperative_groups cluster.sync()  (what csrc/stencil_cg.cu uses
//      with its operands in L2: barrier.cluster.arrive.release +
//      wait.acquire)
//   1  the same barrier written in PTX
//   2  barrier.cluster.arrive.relaxed + wait: no memory ordering, so not a
//      correct exchange; the barrier's own floor
//   3  st.async into the remote CTAs' shared memory, each completing on the
//      receiver's mbarrier (complete_tx), the receiver waiting on its
//      mbarrier's phase: no cluster barrier at all (what csrc/stencil_cg.cu
//      uses with its operands in shared memory)
//   4  as 3, but only warp 0 polls the mbarrier, then __syncthreads()
// Prints ns per exchange (CUDA events over 20,000 exchanges) and, for the
// correct variants, the value of a 10-exchange recurrence against the host.
//
// Build and run (pypose_tpu_torch/probes/cluster_probes.py does both):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o cluster_exchange cluster_exchange.cu && ./cluster_exchange

#include <cooperative_groups.h>
#include <cstdio>

namespace cg = cooperative_groups;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ unsigned remote(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

template <int V>
__global__ void exchange(int iters, float* out) {
  __shared__ __align__(16) float slots[2][16];
  __shared__ __align__(8) unsigned long long mbar[2];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  if (V >= 3 && threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(&mbar[b])));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cl.sync();
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int b = it & 1;
    const float v = acc + it + rank;
    if (V >= 3) {
      if (threadIdx.x < 16)
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
            "[%0], %1, [%2];"
            :: "r"(remote(smem_u32(&slots[b][rank]), threadIdx.x)),
               "r"(__float_as_uint(v)),
               "r"(remote(smem_u32(&mbar[b]), threadIdx.x)) : "memory");
      if (threadIdx.x == 0)
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], 64;"
                     :: "r"(smem_u32(&mbar[b])) : "memory");
      unsigned done = V == 4 && threadIdx.x >= 32;
      while (!done)
        asm volatile(
            "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, "
            "[%1], %2; selp.u32 %0, 1, 0, p; }"
            : "=r"(done) : "r"(smem_u32(&mbar[b])), "r"((it >> 1) & 1)
            : "memory");
      if (V == 4) __syncthreads();
    } else {
      if (threadIdx.x < 16)
        cl.map_shared_rank(&slots[b][0], threadIdx.x)[rank] = v;
      if (V == 0) {
        cl.sync();
      } else if (V == 1) {
        asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
        asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
      } else {
        asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
        asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
      }
    }
    float s = 0.f;
    for (int q = 0; q < 16; ++q) s += slots[b][q];
    acc = s * 1e-3f;
  }
  cl.sync();
  if (threadIdx.x == 0 && rank == 0) out[0] = acc;
}

template <int V>
void run(int threads) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(16);
  cfg.blockDim = dim3(threads);
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = 16;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  cudaFuncSetAttribute(exchange<V>,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  float* out;
  cudaMalloc(&out, 4);
  cudaLaunchKernelEx(&cfg, exchange<V>, 10, out);
  cudaError_t e = cudaDeviceSynchronize();
  float got = 0.f, ref = 0.f;
  cudaMemcpy(&got, out, 4, cudaMemcpyDeviceToHost);
  for (int it = 0; it < 10; ++it) {
    float s = 0.f;
    for (int r = 0; r < 16; ++r) s += ref + it + r;
    ref = s * 1e-3f;
  }
  const int iters = 20000;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  cudaLaunchKernelEx(&cfg, exchange<V>, iters, out);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  printf("variant %d, %d threads a CTA: %.1f ns per exchange; value %g, "
         "host %g; %s\n", V, threads, 1e6 * ms / iters, got, ref,
         cudaGetErrorString(e));
  cudaFree(out);
}

int main() {
  setvbuf(stdout, nullptr, _IONBF, 0);
  for (int threads : {960, 128}) {
    run<0>(threads);
    run<1>(threads);
    run<2>(threads);
    run<3>(threads);
    run<4>(threads);
  }
  return 0;
}

// The rate at which 1-D bulk copies (cp.async.bulk, global to shared,
// behind mbarriers: csrc/bulk_copy.cuh) fill shared memory, by the size of
// a copy: each block keeps a ring of `stages` stages of `stage_bytes`,
// filled by `warps` producer warps in turn (each stage's copies spread
// over the warp's lanes, `copy_bytes` each, from consecutive addresses of
// `src` modulo `src_bytes`) and released by one consumer warp that only
// waits for them.  The host times `rounds` stages a block; bytes over time
// is the rate.  It bounds any kernel that streams through such a ring, as
// csrc/stencil_cg_tiled.cu does with windows of one row of a tile.
// Built and run by pypose_tpu_torch/probes/stencil_probes.py --bulk-rate.
#include <cuda_runtime.h>

#include <cstdint>

#include "../csrc/bulk_copy.cuh"

namespace {

constexpr int kMaxStages = 8;

__global__ void bulk_rate(const char* __restrict__ src, size_t src_bytes,
                          int copy_bytes, int stage_bytes, int stages,
                          int rounds, int warps) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + 128;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      ppt::mbar_init(&full[s], 1);
      ppt::mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int copies = stage_bytes / copy_bytes;
  if (warp == 0) {  // the consumer
    for (int it = 0; it < rounds; ++it) {
      const int s = it % stages;
      ppt::mbar_wait(&full[s], (it / stages) & 1);
      __syncwarp();
      if (lane == 0) ppt::mbar_arrive(&empty[s]);
    }
    return;
  }
  const int pw = warp - 1;
  for (int it = pw; it < rounds; it += warps) {
    const int s = it % stages;
    if (it >= stages) ppt::mbar_wait(&empty[s], ((it / stages) + 1) & 1);
    if (lane == 0)
      ppt::mbar_expect_tx(&full[s], static_cast<uint32_t>(stage_bytes));
    __syncwarp();
    const size_t base =
        (static_cast<size_t>(blockIdx.x) * rounds + it) * stage_bytes;
    for (int c = lane; c < copies; c += 32)
      ppt::bulk_load(ring + static_cast<size_t>(s) * stage_bytes +
                         static_cast<size_t>(c) * copy_bytes,
                     src + (base + static_cast<size_t>(c) * copy_bytes) %
                               src_bytes,
                     copy_bytes, &full[s]);
  }
}

}  // namespace

extern "C" {

// One launch of `grid` blocks on `stream`; returns a CUDA error code.
// stage_bytes a multiple of copy_bytes, both of 16; stages <= 8, their
// bytes within the opt-in shared memory; warps producer warps (<= stages).
int ppt_bulk_rate(const void* src, size_t src_bytes, int copy_bytes,
                  int stage_bytes, int stages, int rounds, int warps,
                  int grid, void* stream) {
  const int smem = 128 + stages * stage_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      bulk_rate, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bulk_rate<<<grid, 32 * (1 + warps), smem,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), src_bytes, copy_bytes, stage_bytes,
      stages, rounds, warps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

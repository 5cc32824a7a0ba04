// Batched SE3 composition and point action, one thread per element.
//
// Replaces the TPU kernels of pypose_tpu/ops/pallas_se3.py:
//   _se3_mul_kernel (:51)  Z = X * Y for [N, 7] poses [t, q (xyzw)];
//   _se3_act_kernel (:68)  o = X . p for [N, 7] poses and [N, 3] points.
// The Pallas kernels transpose the batch to [7, N] component planes to fill
// the TPU's 128 lanes.  Here each thread reads its own row of the [N, 7]
// and [N, 3] storage directly (a warp's loads cover one contiguous span, so
// no transpose pass is needed) and applies the same formulas as
// _qmul_planes/_qrot_planes: a Hamilton product, and a rotation by two
// cross products.
//
// What bounds it on an H100: device-memory bandwidth.  Composition moves
// 84 bytes an element (two poses in, one out), the action 52; at N = 100k
// that is ~8 MB, so a launch is a few microseconds of HBM time plus its
// launch cost, against the plain version's ~20 elementwise launches.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC (see pypose_tpu_torch/ops/_build.py)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// o = p rotated by the unit quaternion q = (v, w): p + w u + v x u with
// u = 2 v x p (pallas_se3.py:40)
__device__ __forceinline__ void qrot(const float* q, const float* p,
                                     float* o) {
  const float u0 = 2.f * (q[1] * p[2] - q[2] * p[1]);
  const float u1 = 2.f * (q[2] * p[0] - q[0] * p[2]);
  const float u2 = 2.f * (q[0] * p[1] - q[1] * p[0]);
  o[0] = p[0] + q[3] * u0 + (q[1] * u2 - q[2] * u1);
  o[1] = p[1] + q[3] * u1 + (q[2] * u0 - q[0] * u2);
  o[2] = p[2] + q[3] * u2 + (q[0] * u1 - q[1] * u0);
}

__global__ void __launch_bounds__(kThreads)
se3_mul_kernel(const float* __restrict__ X, const float* __restrict__ Y,
               int N, float* __restrict__ Z) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const float* x = X + static_cast<size_t>(n) * 7;
  const float* y = Y + static_cast<size_t>(n) * 7;
  float* z = Z + static_cast<size_t>(n) * 7;
  const float q[4] = {x[3], x[4], x[5], x[6]};
  const float r[4] = {y[3], y[4], y[5], y[6]};
  const float s[3] = {y[0], y[1], y[2]};
  float a[3];
  qrot(q, s, a);
  z[0] = x[0] + a[0];
  z[1] = x[1] + a[1];
  z[2] = x[2] + a[2];
  // Hamilton product, xyzw (pallas_se3.py:31)
  z[3] = q[3] * r[0] + q[0] * r[3] + q[1] * r[2] - q[2] * r[1];
  z[4] = q[3] * r[1] + q[1] * r[3] + q[2] * r[0] - q[0] * r[2];
  z[5] = q[3] * r[2] + q[2] * r[3] + q[0] * r[1] - q[1] * r[0];
  z[6] = q[3] * r[3] - q[0] * r[0] - q[1] * r[1] - q[2] * r[2];
}

__global__ void __launch_bounds__(kThreads)
se3_act_kernel(const float* __restrict__ X, const float* __restrict__ P,
               int N, float* __restrict__ O) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const float* x = X + static_cast<size_t>(n) * 7;
  const float* p = P + static_cast<size_t>(n) * 3;
  const float q[4] = {x[3], x[4], x[5], x[6]};
  const float pt[3] = {p[0], p[1], p[2]};
  float a[3];
  qrot(q, pt, a);
  float* o = O + static_cast<size_t>(n) * 3;
  o[0] = x[0] + a[0];
  o[1] = x[1] + a[1];
  o[2] = x[2] + a[2];
}

int blocks_for(int N) { return (N + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Z = X * Y for N poses (float32, [N, 7] row-major) on `stream`; returns
// cudaGetLastError() (0 on success).
int ppt_se3_mul(const float* X, const float* Y, int N, float* Z,
                void* stream) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  se3_mul_kernel<<<blocks_for(N), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(X, Y, N, Z);
  return static_cast<int>(cudaGetLastError());
}

// O = X . P for N poses [N, 7] and points [N, 3] on `stream`; returns
// cudaGetLastError().
int ppt_se3_act(const float* X, const float* P, int N, float* O,
                void* stream) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  se3_act_kernel<<<blocks_for(N), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(X, P, N, O);
  return static_cast<int>(cudaGetLastError());
}

const char* ppt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

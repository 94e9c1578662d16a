// Fused f32 projection residuals for sm_90a.
//
// Replaces calibration_tpu/ops/pallas_kernels.py::_residual_kernel (launched
// by projection_residuals_f32 there). Per point: R [x, y, 0] + t, the
// perspective divide (inverse depth, then multiply, as the TPU kernel does),
// Brown-Conrady k1, k2, k3, p1, p2, then K (fx, fy, cx, cy, skew), then
// (u_hat - u, v_hat - v) * mask. One row is one (problem, view) pair.
//
// What bounds it: about 28 bytes of device memory per point (8 B object
// point, 8 B observation, 4 B mask in; 8 B residual out) against about 30
// flops, so it is bandwidth-bound; at the main-path size (2560 rows x 88
// points = 225k points, 6.3 MB) one launch moves less than the time the
// launch itself costs, so it is launch-bound.
//
// Design: the natural row-major layout the caller already holds (no TPU
// (8, 128) tiling, no 32-wide parameter packing, no SoA padding). One block
// per row, grid-stride over rows so any row count fits in gridDim.x; the
// block stages its row's 22 parameters in shared memory once, and each
// thread handles one point with 8-byte float2 loads and stores, consecutive
// threads on consecutive points. The block masks the ragged end of N
// itself (88 is not a multiple of 32). Built without --use_fast_math.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kParams = 22;  // 9 rot + 3 tra + 10 intr

__global__ void projection_residuals_kernel(const float* __restrict__ rot,
                                            const float* __restrict__ tra,
                                            const float* __restrict__ intr,
                                            const float2* __restrict__ obj,
                                            const float2* __restrict__ uv,
                                            const float* __restrict__ mask,
                                            float2* __restrict__ out, int rows,
                                            int n) {
  __shared__ float p[kParams];
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    __syncthreads();  // every thread is done with the previous row's p
    const int t = threadIdx.x;
    if (t < 9) {
      p[t] = rot[static_cast<int64_t>(row) * 9 + t];
    } else if (t < 12) {
      p[t] = tra[static_cast<int64_t>(row) * 3 + (t - 9)];
    } else if (t < kParams) {
      p[t] = intr[static_cast<int64_t>(row) * 10 + (t - 12)];
    }
    __syncthreads();

    const float fx = p[12], fy = p[13], cx = p[14], cy = p[15], skew = p[16];
    const float k1 = p[17], k2 = p[18], k3 = p[19], p1 = p[20], p2 = p[21];
    const int64_t base = static_cast<int64_t>(row) * n;
    for (int i = t; i < n; i += blockDim.x) {
      const float2 o = obj[base + i];
      const float xc = p[0] * o.x + p[1] * o.y + p[9];
      const float yc = p[3] * o.x + p[4] * o.y + p[10];
      const float zc = p[6] * o.x + p[7] * o.y + p[11];
      const float inv_z = 1.0f / zc;
      const float xn = xc * inv_z;
      const float yn = yc * inv_z;
      const float r2 = xn * xn + yn * yn;
      const float radial = 1.0f + r2 * (k1 + r2 * (k2 + r2 * k3));
      const float xd = xn * radial + 2.0f * p1 * xn * yn + p2 * (r2 + 2.0f * xn * xn);
      const float yd = yn * radial + p1 * (r2 + 2.0f * yn * yn) + 2.0f * p2 * xn * yn;
      const float upred = fx * xd + skew * yd + cx;
      const float vpred = fy * yd + cy;
      const float2 obs = uv[base + i];
      const float m = mask[base + i];
      out[base + i] = make_float2((upred - obs.x) * m, (vpred - obs.y) * m);
    }
  }
}

}  // namespace

// rot (rows, 9), tra (rows, 3), intr (rows, 10), mask (rows, n) float32;
// obj, uv, out (rows, n, 2) float32, 8-byte aligned; all contiguous on the
// current device. Launches on `stream` and returns cudaGetLastError().
extern "C" int projection_residuals_f32_launch(const float* rot, const float* tra,
                                               const float* intr, const float* obj,
                                               const float* uv, const float* mask,
                                               float* out, int rows, int n,
                                               void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  int threads = ((n + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  const int max_grid = 1 << 20;
  const int grid = rows < max_grid ? rows : max_grid;
  projection_residuals_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      rot, tra, intr, reinterpret_cast<const float2*>(obj),
      reinterpret_cast<const float2*>(uv), mask, reinterpret_cast<float2*>(out), rows, n);
  return static_cast<int>(cudaGetLastError());
}

// K1: fused projection residuals and per-row reprojection RMS for sm_90a.
//
// Replaces calibration_tpu/ops/pallas_kernels.py::_residual_kernel (launched
// by projection_residuals_f32 there) and, in RMS mode, the whole QA recheck
// around it, calibration_tpu/parallel/batched.py::reprojection_rms_batch
// (the f32 casts, the residual kernel and _rms_from_residuals).
//
// Per point: R [x, y, 0] + t, the perspective divide (inverse depth, then
// multiply, as the TPU kernel does), Brown-Conrady k1, k2, k3, p1, p2, then
// K (fx, fy, cx, cy, skew), then r = (u_hat - u, v_hat - v) * mask. One row
// is one (problem, view) pair, row = b * V + v. Two modes of one template:
//   residual mode writes r, (rows, N, 2) float32;
//   RMS mode writes sqrt(sum(rx^2 + ry^2) / (2 max(sum(mask), 1))), (rows,)
//   float32, the function of the reference's reprojection_rms_batch.
// Inputs are float32 or float64 (one type for poses, intrinsics and points)
// and a mask of bool, uint8, float32 or float64, each read in place through
// the strides the wrapper passes (the intrinsics of (B, 10) with a view
// stride of 0, so the broadcast over views is an index, not a copy) and
// rounded to float32 in registers, as .to(torch.float32) rounds. Built
// without --use_fast_math; the arithmetic is the previous f32 kernel's, so
// residual mode gives its residuals.
//
// What bounds it: device memory. RMS mode from float64 at the facade's
// 2560 rows x 88 points moves 40 B per point (16 B object point, 16 B
// observation, 8 B mask) plus 96 B of pose per row, 80 B of intrinsics per
// camera and 4 B out per row: 9.29 MB, 2.77 us at 3.35 TB/s; about 59 flops
// per point is 0.2 us at 67 TFLOP/s f32. Residual mode from float32 moves
// 28 B per point: 6.5 MB, 1.9 us.
//
// Design: one warp per row, 4 rows per 128-thread block. Each lane first
// issues the loads of its first kBatch = 4 points (16 bytes per point and
// input: double2 from float64, float2 from float32; neighbouring lanes on
// neighbouring points), then lanes 0-21 load one each of the row's 22
// parameters (9 rotation, 3 translation, 10 intrinsics), so all of a row's
// loads are in flight together; __shfl_sync broadcasts the parameters (no
// shared memory, no __syncthreads). 88 points are one batch (lane l takes
// l, l + 32, l + 64). The float64 instantiations hold 4 points in 92-96
// registers; 128-thread blocks still fit 5 to an SM, so the facade's 2560
// rows (640 blocks) are one wave over the 132 SMs. RMS mode keeps a float32
// sum of squares and mask count per lane and combines them with a
// __shfl_xor_sync butterfly in a fixed order (no atomics: repeated runs give
// the same bits); lane 0 writes the row.
//
// ptxas (sm_90a, -O3, CUDA 12.8; chip_smoke.py prints it): RMS mode 96
// registers from float64 inputs, 72-80 from float32; residual mode 92-96
// and 73-80; no spills in any of the 12 instantiations.
//
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, L2-cold): RMS
// mode 2560 x 88 from float64 5.9-6.3 us, 0.44-0.47 of the bound; residual
// mode from float32 4.7 us, 0.41-0.42 of the bound. One row per warp with
// 88 points is short work: the launch and the first DRAM round trip are
// most of it.

#include <cuda_runtime.h>

#include <cstdint>

// The wrapper's ctypes.Structure (ops/projection_residuals.py::LaunchArgs)
// mirrors this field for field; every field is 8 bytes. Strides count
// elements. Element (b, v, i, j) of the rotation is
// rot[b * rot_b + v * rot_v + i * rot_i + j * rot_j]; translation (b, v, i)
// and intrinsics (b, v, k) likewise; point n of row (b, v) is the pair at
// obj[b * obj_b + v * obj_v + 2 n] (and uv); mask (b, v, n) is
// mask[b * mask_b + v * mask_v + n * mask_n]. out is contiguous float32.
struct LaunchArgs {
  const void* rot;
  const void* tra;
  const void* intr;
  const void* obj;
  const void* uv;
  const void* mask;
  void* out;
  int64_t batch;
  int64_t views;
  int64_t points;
  int64_t rot_b;
  int64_t rot_v;
  int64_t rot_i;
  int64_t rot_j;
  int64_t tra_b;
  int64_t tra_v;
  int64_t tra_i;
  int64_t intr_b;
  int64_t intr_v;
  int64_t intr_k;
  int64_t obj_b;
  int64_t obj_v;
  int64_t uv_b;
  int64_t uv_v;
  int64_t mask_b;
  int64_t mask_v;
  int64_t mask_n;
  int64_t scalar;     // 0: float32, 1: float64
  int64_t mask_kind;  // 0: bool or uint8, 1: float32, 2: float64
};

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kBatch = 4;  // points per lane whose loads are in flight together
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct PairOf;
template <>
struct PairOf<float> {
  using type = float2;
};
template <>
struct PairOf<double> {
  using type = double2;
};

template <typename T>
__device__ __forceinline__ float load_f32(const void* base, int64_t idx) {
  return static_cast<float>(__ldg(static_cast<const T*>(base) + idx));
}

// One point's inputs, as loaded.
template <typename T, typename M>
struct Point {
  typename PairOf<T>::type obj, obs;
  M mask;
};

template <typename T, typename M, bool kRms>
__global__ void __launch_bounds__(kRowsPerBlock * 32) projection_kernel(const LaunchArgs a) {
  using T2 = typename PairOf<T>::type;
  const int lane = threadIdx.x & 31;
  // the wrapper keeps B * V and N below 2^31, so row indices are 32-bit
  const int row = static_cast<int>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  const int views = static_cast<int>(a.views);
  if (row >= static_cast<int>(a.batch) * views) return;  // the whole warp leaves together
  const int64_t b = row / views;
  const int64_t v = row - static_cast<int>(b) * views;

  // the first kBatch points of each lane are loaded before the parameters,
  // so their loads and the parameters' are in flight together
  const T2* obj = reinterpret_cast<const T2*>(static_cast<const T*>(a.obj) + b * a.obj_b + v * a.obj_v);
  const T2* uv = reinterpret_cast<const T2*>(static_cast<const T*>(a.uv) + b * a.uv_b + v * a.uv_v);
  const M* mask = static_cast<const M*>(a.mask) + b * a.mask_b + v * a.mask_v;
  const int n = static_cast<int>(a.points);
  Point<T, M> pts[kBatch];
  auto load = [&](int first) {
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = first + 32 * k;
      if (i < n) pts[k] = {__ldg(obj + i), __ldg(uv + i), __ldg(mask + i * a.mask_n)};
    }
  };
  load(lane);

  float p = 0.0f;
  if (lane < 9) {
    p = load_f32<T>(a.rot, b * a.rot_b + v * a.rot_v + (lane / 3) * a.rot_i + (lane % 3) * a.rot_j);
  } else if (lane < 12) {
    p = load_f32<T>(a.tra, b * a.tra_b + v * a.tra_v + (lane - 9) * a.tra_i);
  } else if (lane < 22) {
    p = load_f32<T>(a.intr, b * a.intr_b + v * a.intr_v + (lane - 12) * a.intr_k);
  }
  const float r00 = __shfl_sync(kFull, p, 0), r01 = __shfl_sync(kFull, p, 1);
  const float r10 = __shfl_sync(kFull, p, 3), r11 = __shfl_sync(kFull, p, 4);
  const float r20 = __shfl_sync(kFull, p, 6), r21 = __shfl_sync(kFull, p, 7);
  const float t0 = __shfl_sync(kFull, p, 9), t1 = __shfl_sync(kFull, p, 10);
  const float t2 = __shfl_sync(kFull, p, 11);
  const float fx = __shfl_sync(kFull, p, 12), fy = __shfl_sync(kFull, p, 13);
  const float cx = __shfl_sync(kFull, p, 14), cy = __shfl_sync(kFull, p, 15);
  const float skew = __shfl_sync(kFull, p, 16);
  const float k1 = __shfl_sync(kFull, p, 17), k2 = __shfl_sync(kFull, p, 18);
  const float k3 = __shfl_sync(kFull, p, 19), p1 = __shfl_sync(kFull, p, 20);
  const float p2 = __shfl_sync(kFull, p, 21);

  float sum = 0.0f, count = 0.0f;
  for (int first = lane; first < n; first += 32 * kBatch) {
    if (first != lane) load(first);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = first + 32 * k;
      if (i >= n) break;
      const float ox = static_cast<float>(pts[k].obj.x), oy = static_cast<float>(pts[k].obj.y);
      const float xc = r00 * ox + r01 * oy + t0;
      const float yc = r10 * ox + r11 * oy + t1;
      const float zc = r20 * ox + r21 * oy + t2;
      const float inv_z = 1.0f / zc;
      const float xn = xc * inv_z;
      const float yn = yc * inv_z;
      const float r2 = xn * xn + yn * yn;
      const float radial = 1.0f + r2 * (k1 + r2 * (k2 + r2 * k3));
      const float xd = xn * radial + 2.0f * p1 * xn * yn + p2 * (r2 + 2.0f * xn * xn);
      const float yd = yn * radial + p1 * (r2 + 2.0f * yn * yn) + 2.0f * p2 * xn * yn;
      const float upred = fx * xd + skew * yd + cx;
      const float vpred = fy * yd + cy;
      const float m = static_cast<float>(pts[k].mask);
      const float rx = (upred - static_cast<float>(pts[k].obs.x)) * m;
      const float ry = (vpred - static_cast<float>(pts[k].obs.y)) * m;
      if constexpr (kRms) {
        sum += rx * rx + ry * ry;
        count += m;
      } else {
        static_cast<float2*>(a.out)[static_cast<int64_t>(row) * n + i] = make_float2(rx, ry);
      }
    }
  }
  if constexpr (kRms) {
    for (int offset = 16; offset > 0; offset >>= 1) {
      sum += __shfl_xor_sync(kFull, sum, offset);
      count += __shfl_xor_sync(kFull, count, offset);
    }
    if (lane == 0) static_cast<float*>(a.out)[row] = sqrtf(sum / (2.0f * fmaxf(count, 1.0f)));
  }
}

template <typename T, typename M, bool kRms>
int launch(const LaunchArgs& a, cudaStream_t stream) {
  const int64_t blocks = (a.batch * a.views + kRowsPerBlock - 1) / kRowsPerBlock;
  projection_kernel<T, M, kRms><<<static_cast<unsigned>(blocks), kRowsPerBlock * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kRms>
int launch_for_mask(const LaunchArgs& a, cudaStream_t stream) {
  switch (a.mask_kind) {
    case 0:
      return launch<T, uint8_t, kRms>(a, stream);
    case 1:
      return launch<T, float, kRms>(a, stream);
    case 2:
      return launch<T, double, kRms>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kRms>
int launch_mode(const LaunchArgs* a, void* stream) {
  if (a->batch * a->views <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a->scalar) {
    case 0:
      return launch_for_mask<float, kRms>(*a, s);
    case 1:
      return launch_for_mask<double, kRms>(*a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Residual mode: out (rows, N, 2) float32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int projection_residuals_launch(const LaunchArgs* a, void* stream) {
  return launch_mode<false>(a, stream);
}

// RMS mode: out (rows,) float32. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int projection_rms_launch(const LaunchArgs* a, void* stream) {
  return launch_mode<true>(a, stream);
}

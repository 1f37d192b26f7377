// ORB keypoint orientation (intensity centroid) on Hopper.
//
// Replaces no TPU kernel. The JAX detector computes the angle from two
// dense moment maps of the level image (compv_tpu/features/orb.py:158-167):
// about 90 vector passes that XLA fuses inside one jit. The port's twin
// (ops/kernels/orient_kernel.py: _m10_map, _orientation_ref) is those
// passes written out, and run eagerly on the card each pass is a launch of
// its own: some 380 launches an image and level, 6,096 a match_pair, more
// than half of the frame's host time, for maps of which only the values at
// the level's <= 439 keypoints are read. This kernel computes the two
// moments at the keypoints alone, in one launch an image and level.
//
// The contract is the twin's, bit for bit, for u8 and f32 images:
//   * (x, y) rounded half to even, converted to int64 (NaN to 0, out of
//     range saturated), clamped to [15, w - 16] / [15, h - 16] as
//     min(max(v, 15), w - 16); a negative index counts from the end, as
//     torch indexing does (the wrapper raises IndexError before the launch
//     where that still leaves the image, as the twin does).
//   * m10: for each disc row d in -15..15 the row moment, built in the
//     twin's order M_e = M_{e-1} + e * (I(y+d, x+e) - I(y+d, x-e)) for
//     e = 1..E(|d|), E(d) = floor(sqrt(15^2 - d^2)); then folded as
//     out = M(0); out = (out + M(+d)) + M(-d) for d = 1..15.
//   * m01: the same with rows and columns swapped.
//   * Pixels outside the image read as 0, as the twin's zero padding does.
//   * deg = atan2f(m01, m10) * f32(180 / pi); + 360 where deg < 0; 0 where
//     the keypoint is not valid.
// Each add, subtract and multiply is an explicit round-to-nearest
// intrinsic, so nvcc cannot contract a multiply and an add into an FMA
// that the twin's separate operations do not make. For u8 images every
// partial sum is an integer below 2^24 and any order is exact; for f32
// images the order above is what makes the result the twin's.
//
// What bounds it: the launch. A keypoint reads its 709-pixel disc twice
// (once by rows, once by columns), ~1.4 k reads that stay in L1 / L2, and a
// level has at most 439 keypoints, so the bytes are ~0.3 MB (~0.1 us of
// HBM time) and the work is under one wave of warps.
//
// Design: one warp a keypoint, 4 warps a block. Lane i < 31 builds the
// moment of disc row i - 15 in order (at most 15 steps, loads unrolled),
// the warp folds the 31 row moments in the twin's order by shuffles; then
// the same over columns for m01. A keypoint that is not valid writes 0 and
// reads nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 15;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;
// f32(180 / pi), the twin's _RAD2DEG
constexpr float kRad2Deg = 0x1.ca5dc2p+5f;

// E(d) = floor(sqrt(15^2 - d^2)): the disc's half-width at offset d
__constant__ int kHalfWidth[kRadius + 1] = {15, 14, 14, 14, 14, 14, 13, 13,
                                            12, 12, 11, 10, 9,  7,  5,  0};

template <typename T>
__device__ __forceinline__ float at(const T* __restrict__ img, int h, int w,
                                    int r, int c) {
  return (r >= 0 && r < h && c >= 0 && c < w)
             ? static_cast<float>(__ldg(img + static_cast<size_t>(r) * w + c))
             : 0.0f;
}

// One lane's line moment: sum over e = 1..e_max of e * (I(+e) - I(-e))
// along a row (by_rows) or a column, in the twin's order.
template <typename T>
__device__ __forceinline__ float line_moment(const T* __restrict__ img, int h,
                                             int w, int r, int c, int d,
                                             int e_max, bool by_rows) {
  float m = 0.0f;
#pragma unroll
  for (int e = 1; e <= kRadius; ++e) {
    if (e <= e_max) {
      const float a = by_rows ? at(img, h, w, r + d, c + e)
                              : at(img, h, w, r + e, c + d);
      const float b = by_rows ? at(img, h, w, r + d, c - e)
                              : at(img, h, w, r - e, c + d);
      m = __fadd_rn(m, __fmul_rn(static_cast<float>(e), __fsub_rn(a, b)));
    }
  }
  return m;
}

// The disc moment from the lanes' line moments (lane 15 + d holds offset
// d): out = M(0), then (out + M(+d)) + M(-d) for d = 1..15. Every lane
// gets the result.
__device__ __forceinline__ float fold(float m) {
  float out = __shfl_sync(kFull, m, kRadius);
#pragma unroll
  for (int d = 1; d <= kRadius; ++d) {
    const float up = __shfl_sync(kFull, m, kRadius + d);
    const float down = __shfl_sync(kFull, m, kRadius - d);
    out = __fadd_rn(__fadd_rn(out, up), down);
  }
  return out;
}

// The twin's index: round half to even, to int64, clamp, from the end
// where negative.
__device__ __forceinline__ int index_of(float v, int n) {
  long long i = static_cast<long long>(rintf(v));
  i = min(max(i, static_cast<long long>(kRadius)),
          static_cast<long long>(n - 1 - kRadius));
  return static_cast<int>(i < 0 ? i + n : i);
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
orb_orient(const T* __restrict__ img, int h, int w,
           const float* __restrict__ x, const float* __restrict__ y,
           const uint8_t* __restrict__ valid, float* __restrict__ out,
           int k) {
  const int lane = threadIdx.x % 32;
  const int kp = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (kp >= k) return;  // the whole warp
  if (!valid[kp]) {
    if (lane == 0) out[kp] = 0.0f;
    return;
  }
  const int c = index_of(x[kp], w);
  const int r = index_of(y[kp], h);
  const int d = lane - kRadius;
  const int e_max = lane < 2 * kRadius + 1 ? kHalfWidth[abs(d)] : 0;
  const float m10 = fold(line_moment(img, h, w, r, c, d, e_max, true));
  const float m01 = fold(line_moment(img, h, w, r, c, d, e_max, false));
  if (lane == 0) {
    float deg = __fmul_rn(atan2f(m01, m10), kRad2Deg);
    if (deg < 0.0f) deg = __fadd_rn(deg, 360.0f);
    out[kp] = deg;
  }
}

}  // namespace

extern "C" {

// img: (h, w) u8 (is_f32 == 0) or f32, contiguous; x, y: (k,) f32; valid:
// (k,) bytes of 0 / 1; out: (k,) f32 angles in degrees [0, 360). k >= 1,
// and every keypoint's clamped index lies in the image (h, w >= 8). Returns
// the launch's cudaError_t (0 on success).
int compv_orb_orient(const void* img, int is_f32, int h, int w,
                     const float* x, const float* y, const uint8_t* valid,
                     float* out, int k, void* stream) {
  const int blocks = (k + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_f32)
    orb_orient<float><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const float*>(img), h, w, x, y, valid, out, k);
  else
    orb_orient<uint8_t><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        static_cast<const uint8_t*>(img), h, w, x, y, valid, out, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

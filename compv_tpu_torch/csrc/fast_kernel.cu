// FAST-n corner strengths + strict 3x3 non-maxima suppression on Hopper.
//
// Replaces compv_tpu/ops/pallas/fast_kernel.py:fast_strengths_nms_pallas
// (K1). The contract is that of the XLA twin the JAX detector runs,
// compv_tpu/features/fast.py:_strengths_f32 + _nms_f32:
//   * strength: with the signed darker (p - t - c_i) and brighter
//     (c_i - p - t) diffs to the 16 circle pixels c_i in CIRCLE_OFFSETS
//     order, take for each of the 16 arc starts the min over N consecutive
//     diffs (mod 16); the max over starts and both sides, clipped at 0.
//     Zero outside rows and columns [3, dim - 3).
//   * NMS: keep s only if s > 0 and all 8 neighbours are strictly less;
//     neighbours outside the image count as 0.
// Integer diffs are exact, like the twin's f32 arithmetic on u8 values, so
// kernel and twin agree bit for bit.
//
// What bounds it: each pixel is read once (1 B) and written as one f32 map
// or, for the ORB level loop, two (8 B): about 8 MB for a 720p level pair,
// a few microseconds of HBM time at 3.35 TB/s. At 720p the kernel is bound
// by launch overhead and latency, not bandwidth. The arc minima cost about
// 2 x (16 x log2(N) + 16) integer min/max per pixel.
//
// Design: one 32x8 block per output tile. The block stages the u8 tile
// with a 4-pixel halo (3 for the circle, 1 for NMS) in shared memory, so
// each input byte is read from HBM once per tile and the 16 circle taps hit
// shared memory; it computes int32 strengths for the tile plus a 1-pixel
// ring into shared memory, synchronises, and runs NMS from there, so the
// raw map never goes through HBM between the two stages. Ragged edges are
// masked in the kernel; any H and W work. wgmma/TMA play no part in a
// stencil of this size; tuning the tile is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kHalo = 4;
constexpr int kPixW = kTileW + 2 * kHalo;
constexpr int kPixH = kTileH + 2 * kHalo;
constexpr int kStrW = kTileW + 2;
constexpr int kStrH = kTileH + 2;
constexpr int kThreads = kTileW * kTileH;

// Windowed minimum over N consecutive entries (mod 16) by doubling, the
// same schedule as the twin: after the last step m[k] = min(v[k..k+N-1]).
template <int N, int SPAN = 1>
__device__ __forceinline__ void window_min(int (&m)[16]) {
  if constexpr (SPAN < N) {
    constexpr int STEP = SPAN < N - SPAN ? SPAN : N - SPAN;
    int t[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) t[k] = min(m[k], m[(k + STEP) & 15]);
#pragma unroll
    for (int k = 0; k < 16; ++k) m[k] = t[k];
    window_min<N, SPAN + STEP>(m);
  }
}

template <int N>
__device__ __forceinline__ int arc_strength(int (&v)[16]) {
  window_min<N>(v);
  int best = v[0];
#pragma unroll
  for (int k = 1; k < 16; ++k) best = max(best, v[k]);
  return best;
}

// Strength of the pixel at (py, px) of the shared tile.
template <int N>
__device__ __forceinline__ int strength_at(const uint8_t (*pix)[kPixW],
                                           int py, int px, int threshold) {
  // (dy, dx) of the r=3 Bresenham circle, reference order
  // (fast_dete.cxx:221-238): index 0 at (-3, 0), clockwise.
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int p = pix[py][px];
  const int darker = p - threshold;
  const int brighter = p + threshold;
  int d[16], b[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int c = pix[py + dy[k]][px + dx[k]];
    d[k] = darker - c;
    b[k] = c - brighter;
  }
  return max(max(arc_strength<N>(d), arc_strength<N>(b)), 0);
}

// out_u8 or out_f32 receives the NMS map (nms != 0) or the strengths;
// raw_f32, when not null, also receives the strengths.
template <int N>
__global__ void __launch_bounds__(kThreads)
fast_kernel(const uint8_t* __restrict__ img, int h, int w, int threshold,
            int nms, uint8_t* __restrict__ out_u8, float* __restrict__ out_f32,
            float* __restrict__ raw_f32) {
  __shared__ uint8_t pix[kPixH][kPixW];
  __shared__ int str[kStrH][kStrW];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  for (int i = tid; i < kPixH * kPixW; i += kThreads) {
    const int gy = y0 - kHalo + i / kPixW;
    const int gx = x0 - kHalo + i % kPixW;
    const bool in = gy >= 0 && gy < h && gx >= 0 && gx < w;
    pix[i / kPixW][i % kPixW] = in ? img[(size_t)gy * w + gx] : 0;
  }
  __syncthreads();

  // strengths of the tile plus a 1-pixel ring; str[ly][lx] holds global
  // (y0 - 1 + ly, x0 - 1 + lx), which is pix[ly + 3][lx + 3]
  for (int i = tid; i < kStrH * kStrW; i += kThreads) {
    const int ly = i / kStrW;
    const int lx = i % kStrW;
    const int gy = y0 - 1 + ly;
    const int gx = x0 - 1 + lx;
    int s = 0;
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3)
      s = strength_at<N>(pix, ly + kHalo - 1, lx + kHalo - 1, threshold);
    str[ly][lx] = s;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x;
  const int gy = y0 + threadIdx.y;
  if (gx >= w || gy >= h) return;
  const int cy = threadIdx.y + 1;
  const int cx = threadIdx.x + 1;
  const int s = str[cy][cx];
  const size_t o = (size_t)gy * w + gx;
  if (raw_f32 != nullptr) raw_f32[o] = (float)s;
  int v = s;
  if (nms) {
    int nmax = max(max(str[cy - 1][cx - 1], str[cy - 1][cx]),
                   max(str[cy - 1][cx + 1], str[cy][cx - 1]));
    nmax = max(nmax, max(max(str[cy][cx + 1], str[cy + 1][cx - 1]),
                         max(str[cy + 1][cx], str[cy + 1][cx + 1])));
    v = (s > 0 && nmax < s) ? s : 0;
  }
  if (out_u8 != nullptr)
    out_u8[o] = (uint8_t)v;
  else
    out_f32[o] = (float)v;
}

int launch(const void* img, int h, int w, int threshold, int n, int nms,
           void* out_u8, void* out_f32, void* raw_f32, void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(img);
  uint8_t* ou = static_cast<uint8_t*>(out_u8);
  float* of = static_cast<float*>(out_f32);
  float* raw = static_cast<float*>(raw_f32);
  if (n == 9)
    fast_kernel<9><<<grid, block, 0, s>>>(in, h, w, threshold, nms, ou, of, raw);
  else if (n == 12)
    fast_kernel<12><<<grid, block, 0, s>>>(in, h, w, threshold, nms, ou, of, raw);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (h, w) u8 -> (h, w) strengths map, NMS applied when nms != 0; the map is
// u8 when as_f32 == 0, else f32. Returns the launch's cudaError_t.
int compv_fast_strengths_nms(const void* img, void* out, int h, int w,
                             int threshold, int n, int nms, int as_f32,
                             void* stream) {
  return launch(img, h, w, threshold, n, nms, as_f32 ? nullptr : out,
                as_f32 ? out : nullptr, nullptr, stream);
}

// (h, w) u8 -> the f32 strengths map and its f32 NMS map in one launch.
int compv_fast_strengths_and_nms(const void* img, void* raw, void* nms_out,
                                 int h, int w, int threshold, int n,
                                 void* stream) {
  return launch(img, h, w, threshold, n, 1, nullptr, nms_out, raw, stream);
}

}  // extern "C"

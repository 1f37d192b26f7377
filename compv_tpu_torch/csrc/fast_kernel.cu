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
// Every value is a small integer, exact here and in the twin's f32, so
// kernel and twin agree bit for bit.
//
// What bounds it: a pixel is read once (1 B) and written as one map or two
// f32 maps (8 B), about 8 MB for a 720p level: 2.5 us of HBM time. The arc
// minima are integer min / max work of the same order (below), so the
// kernel sits where bytes, integer rate, shared-memory loads and the
// launch itself all count; none of it is matrix work and the rows are
// unaligned bytes, so wgmma and TMA play no part.
//
// Design, for the card's integer pipes:
//   * Arithmetic. Adding a constant commutes with min and max, so the
//     windows run on the raw circle pixels and the centre enters once:
//       brighter side  max_s min_arc (c - p - t) = Mb - p - t,
//       darker side    max_s min_arc (p - t - c) = p - t - Md,
//     with Mb = max over the 16 starts of the min over the arc of c, Md =
//     min over starts of the max over the arc. No per-tap subtraction.
//   * Two pixels an instruction. A thread owns horizontally adjacent pixel
//     pairs as two 16-bit lanes of a word (values 0..511: no lane
//     overflows, and the three places that add or subtract are arranged so
//     that no lane borrows). The tile is staged into shared memory already
//     widened to 16 bits, so the pair of an even tap offset is one 32-bit
//     shared load and the pair of an odd offset is one __byte_perm of two.
//   * Hopper's DPX three-way min / max (__vimin3_s16x2, __vimax3_s16x2):
//     window min over 9 is m3[k] = min3(v[k], v[k+1], v[k+2]) then
//     min3(m3[k], m3[k+3], m3[k+6]); over 12 one more min with m3[k+9];
//     the max over the 16 starts is 8 three-way maxima. Min and max are
//     associative and exact, so any tree gives the twin's value. At N = 9:
//     40 packed instructions a side and pair, 43 a pixel with the final
//     clip, against about 200 32-bit ones a pixel for the doubling
//     schedule on unpacked diffs.
//   * An exact early-out, a warp wide. Lemma: for N >= 9, every arc of N
//     contiguous circle points holds k or k + 8 for each k in 0..7. Proof:
//     the points the arc leaves out are 16 - N <= 7 contiguous ones, any
//     two of which are at most 6 apart on the circle, while k and k + 8
//     are 8 apart; so the arc cannot leave out both. Hence if every point
//     of some arc is brighter than p + t, then max(c[k], c[k+8]) > p + t
//     for all k: when A = min_k max(c[k], c[k+8]) <= p + t, no arc is
//     brighter and Mb - p - t <= 0. Likewise when B = max_k min(c[k],
//     c[k+8]) >= p - t no arc is darker. When both hold the strength is
//     exactly 0, the final clip. A and B cost 24 packed instructions a
//     pair; a side is computed only when some interior lane of the warp
//     passes its test (__any_sync), so flat regions cost the test alone
//     and noise costs test plus arcs: the kernel is exact on both.
//   * Little ring work. NMS needs the strengths one pixel around its
//     output, so a block of 8 warps computes a 64 x 32 strength region
//     (one pixel pair a lane, one row a warp and trip, four trips: none
//     runs part of a warp) for a 62 x 30 output tile: 10 % more strengths
//     than outputs. A block's time is a chain of latencies (staging, four
//     rows, four NMS rows), which an SM hides by overlapping blocks; an
//     image under 400,000 pixels (the upper pyramid levels) has too few
//     for that and takes 64 x 16 regions instead, half the chain for 18 %
//     of ring. The strengths go to shared memory as 16-bit lanes and NMS
//     runs packed from there, so the raw map never goes through HBM
//     between the two stages, and both outputs of the two-output entry
//     leave in the one launch. Output lanes are transposed by two shuffles
//     so that a warp stores 32 neighbouring pixels an instruction.
//   * Staging by aligned 32-bit loads: a task takes one aligned word of an
//     image row and scatters its bytes as 16-bit shared stores; a thread
//     starts the loads of its three tasks before it uses any. The ragged
//     head and tail of a row, rows and columns outside the image (zero)
//     and the ends of the buffer (byte loads) are masked per byte. Any H,
//     W and base alignment work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStrW = 64;             // strengths a row: one pair a lane
constexpr int kTall = 32;             // strength rows a block, large images
constexpr int kShort = 16;            // and small ones
constexpr int kSmallPixels = 400000;  // below this many pixels: kShort
constexpr int kOutW = kStrW - 2;      // the NMS ring comes off
constexpr int kPixW = kStrW + 8;      // 3 circle pixels + 1 to align, a side
constexpr int kPixWords = kPixW / 2;
constexpr int kStrWords = kStrW / 2 + 2;   // a pad word each side for NMS
constexpr int kRowWords = (kPixW + 3) / 4 + 1;   // aligned words over a row
constexpr uint32_t kFull = 0xffffffffu;
constexpr uint32_t kBias = 0x01000100u;    // 256 in both lanes

__device__ __forceinline__ uint32_t min3(uint32_t a, uint32_t b, uint32_t c) {
  return __vimin3_s16x2(a, b, c);
}
__device__ __forceinline__ uint32_t max3(uint32_t a, uint32_t b, uint32_t c) {
  return __vimax3_s16x2(a, b, c);
}
__device__ __forceinline__ uint32_t min2(uint32_t a, uint32_t b) {
  return __vmins2(a, b);
}
__device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
  return __vmaxs2(a, b);
}
// (a.hi, b.lo): the pair one pixel to the right of the pair in a
__device__ __forceinline__ uint32_t odd_pair(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5432);
}

// Md (MAX_INSIDE) or Mb: the min / max over the 16 arc starts of the max /
// min over the N circle values from each start.
template <int N, bool MAX_INSIDE>
__device__ __forceinline__ uint32_t arc_extreme(const uint32_t (&v)[16]) {
  uint32_t m3[16], m[16];
#pragma unroll
  for (int k = 0; k < 16; ++k)
    m3[k] = MAX_INSIDE ? max3(v[k], v[(k + 1) & 15], v[(k + 2) & 15])
                       : min3(v[k], v[(k + 1) & 15], v[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    m[k] = MAX_INSIDE ? max3(m3[k], m3[(k + 3) & 15], m3[(k + 6) & 15])
                      : min3(m3[k], m3[(k + 3) & 15], m3[(k + 6) & 15]);
    if constexpr (N == 12)
      m[k] = MAX_INSIDE ? max2(m[k], m3[(k + 9) & 15])
                        : min2(m[k], m3[(k + 9) & 15]);
  }
  uint32_t r[6];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    r[k] = MAX_INSIDE ? min3(m[3 * k], m[3 * k + 1], m[3 * k + 2])
                      : max3(m[3 * k], m[3 * k + 1], m[3 * k + 2]);
  r[5] = m[15];
  if constexpr (MAX_INSIDE)
    return min2(min3(r[0], r[1], r[2]), min3(r[3], r[4], r[5]));
  else
    return max2(max3(r[0], r[1], r[2]), max3(r[3], r[4], r[5]));
}

// out_u8 or out_f32 receives the NMS map (nms != 0) or the strengths;
// raw_f32, when not null, also receives the strengths. With STATS, counts
// gains one per tested warp row: [0] tested, [1] left with neither side
// computed, [2] brighter side computed, [3] darker side computed.
template <int N, int STR_H, bool STATS>
__global__ void __launch_bounds__(kThreads)
fast_kernel(const uint8_t* __restrict__ img, int h, int w, int threshold,
            int nms, uint8_t* __restrict__ out_u8, float* __restrict__ out_f32,
            float* __restrict__ raw_f32, unsigned long long* counts) {
  constexpr int kStrH = STR_H;
  constexpr int kOutH = kStrH - 2;
  constexpr int kPixH = kStrH + 6;
  constexpr int kStageTrips = (kPixH * kRowWords + kThreads - 1) / kThreads;
  __shared__ uint32_t pix[kPixH][kPixWords];
  __shared__ uint32_t str[kStrH][kStrWords];
  // strength (sr, sc) of the block is pixel (sy0 + sr, sx0 + sc); the
  // output tile is its rows 1..kOutH and columns 1..kOutW
  const int sx0 = blockIdx.x * kOutW - 1;
  const int sy0 = blockIdx.y * kOutH - 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // stage pixels (sy0 - 3 + r, sx0 - 4 + c), widened to 16 bits; zero
  // outside the image. A task is one aligned word of a tile row; a thread
  // starts the loads of all its tasks before it uses any.
  {
    uint16_t* pix16 = reinterpret_cast<uint16_t*>(&pix[0][0]);
    const uintptr_t lo = reinterpret_cast<uintptr_t>(img);
    const uintptr_t hi = lo + static_cast<size_t>(h) * w;
    uint32_t word[kStageTrips];
#pragma unroll
    for (int u = 0; u < kStageTrips; ++u) {
      const int i = threadIdx.x + u * kThreads;
      const int r = i / kRowWords;
      const int gy = sy0 - 3 + r;
      word[u] = 0;
      if (i < kPixH * kRowWords && gy >= 0 && gy < h) {
        // address of local column 0 (dereferenced only inside the buffer)
        const intptr_t a0 = static_cast<intptr_t>(lo)
            + static_cast<intptr_t>(gy) * w + (sx0 - 4);
        const intptr_t wa = (a0 & ~static_cast<intptr_t>(3))
            + 4 * (i - r * kRowWords);
        if (static_cast<uintptr_t>(wa) >= lo
            && static_cast<uintptr_t>(wa) + 4 <= hi) {
          word[u] = *reinterpret_cast<const uint32_t*>(wa);
        } else {   // the first or last bytes of the buffer
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uintptr_t a = static_cast<uintptr_t>(wa + b);
            if (a >= lo && a < hi)
              word[u] |= static_cast<uint32_t>(
                  *reinterpret_cast<const uint8_t*>(a)) << (8 * b);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStageTrips; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i >= kPixH * kRowWords) continue;
      const int r = i / kRowWords;
      const int gy = sy0 - 3 + r;
      const bool row_in = gy >= 0 && gy < h;
      const intptr_t a0 = static_cast<intptr_t>(lo)
          + static_cast<intptr_t>(row_in ? gy : 0) * w + (sx0 - 4);
      // local column of the word's byte 0
      const int c0 = 4 * (i - r * kRowWords) - static_cast<int>(a0 & 3);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = c0 + b;
        const int gx = sx0 - 4 + c;
        if (c >= 0 && c < kPixW) {
          const bool in = row_in && gx >= 0 && gx < w;
          pix16[r * kPixW + c] =
              in ? static_cast<uint16_t>((word[u] >> (8 * b)) & 0xffu) : 0;
        }
      }
    }
  }
  __syncthreads();

  // strengths: lane l of a warp owns the pixel pair at columns 2l, 2l + 1
  // of a strength row, which is word l + 2 of the pixel row
  const uint32_t t2 = static_cast<uint32_t>(threshold) * 0x00010001u;
  const int gx_lo = sx0 + 2 * lane;
  const uint32_t col_mask =
      ((gx_lo >= 3 && gx_lo < w - 3) ? 0x0000ffffu : 0u)
      | ((gx_lo + 1 >= 3 && gx_lo + 1 < w - 3) ? 0xffff0000u : 0u);
  for (int sr = warp; sr < kStrH; sr += kWarps) {
    const int gy = sy0 + sr;
    uint32_t s = 0;
    if (gy >= 3 && gy < h - 3) {
      // circle taps in reference order (fast_dete.cxx:221-238): index 0 at
      // (-3, 0), clockwise; pixel row gy + dy is tile row sr + 3 + dy
      uint32_t v[16];
      const uint32_t* r = &pix[sr][lane];
      v[15] = odd_pair(r[1], r[2]);
      v[0] = r[2];
      v[1] = odd_pair(r[2], r[3]);
      r += kPixWords;
      v[14] = r[1];
      v[2] = r[3];
      r += kPixWords;
      v[13] = odd_pair(r[0], r[1]);
      v[3] = odd_pair(r[3], r[4]);
      r += kPixWords;
      v[12] = odd_pair(r[0], r[1]);
      const uint32_t p = r[2];
      v[4] = odd_pair(r[3], r[4]);
      r += kPixWords;
      v[11] = odd_pair(r[0], r[1]);
      v[5] = odd_pair(r[3], r[4]);
      r += kPixWords;
      v[10] = r[1];
      v[6] = r[3];
      r += kPixWords;
      v[9] = odd_pair(r[1], r[2]);
      v[8] = r[2];
      v[7] = odd_pair(r[2], r[3]);

      // the early-out (see the lemma above)
      uint32_t hi8[8], lo8[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        hi8[k] = max2(v[k], v[k + 8]);
        lo8[k] = min2(v[k], v[k + 8]);
      }
      const uint32_t a = min2(
          min3(min3(hi8[0], hi8[1], hi8[2]), min3(hi8[3], hi8[4], hi8[5]),
               hi8[6]), hi8[7]);
      const uint32_t b = max2(
          max3(max3(lo8[0], lo8[1], lo8[2]), max3(lo8[3], lo8[4], lo8[5]),
               lo8[6]), lo8[7]);
      const uint32_t pt = p + t2;              // lanes <= 510
      // a lane of max(a, pt) differs from pt iff a > p + t there; a lane
      // of min(b + t, p) differs from p iff b + t < p
      const bool brighter =
          __any_sync(kFull, ((max2(a, pt) ^ pt) & col_mask) != 0);
      const bool darker =
          __any_sync(kFull, ((min2(b + t2, p) ^ p) & col_mask) != 0);
      if constexpr (STATS) {
        if (lane == 0) {
          atomicAdd(&counts[0], 1ull);
          if (!brighter && !darker) atomicAdd(&counts[1], 1ull);
          if (brighter) atomicAdd(&counts[2], 1ull);
          if (darker) atomicAdd(&counts[3], 1ull);
        }
      }
      // max(Mb - p - t, p - t - Md, 0), every lane kept in 1..511 by the
      // bias so that the 32-bit adds and subtractions never cross lanes
      const uint32_t floor2 = kBias + t2;
      uint32_t z = floor2;
      if (brighter)
        z = max2(z, arc_extreme<N, false>(v) + kBias - p);
      if (darker)
        z = max2(z, p + kBias - arc_extreme<N, true>(v));
      s = (z - floor2) & col_mask;
    }
    str[sr][lane + 1] = s;
  }
  __syncthreads();

  // NMS, packed, and the stores: output rows are strength rows 1..kOutH
  const uint16_t* str16 = reinterpret_cast<const uint16_t*>(&str[0][0]);
  for (int sr = 1 + warp; sr <= kOutH; sr += kWarps) {
    const int gy = sy0 + sr;
    if (gy >= h) break;
    uint32_t val = 0;
    if (nms) {
      // for the pair (x, x + 1) in r[1]: odd_pair(r[0], r[1]) is
      // (x - 1, x) and odd_pair(r[1], r[2]) is (x + 1, x + 2)
      const uint32_t* r = &str[sr - 1][lane];
      const uint32_t up = max3(odd_pair(r[0], r[1]), r[1],
                               odd_pair(r[1], r[2]));
      r += kStrWords;
      const uint32_t s = r[1];
      const uint32_t mid = max2(odd_pair(r[0], r[1]), odd_pair(r[1], r[2]));
      r += kStrWords;
      const uint32_t down = max3(odd_pair(r[0], r[1]), r[1],
                                 odd_pair(r[1], r[2]));
      const uint32_t nmax = max3(up, mid, down);
      // strengths are >= 0, so s > nmax implies s > 0
      val = s & __vcmpgtu2(s, nmax);
    }
    // column c of the row is lane c / 2, half c & 1; this lane stores
    // columns lane and lane + 32
    const uint32_t va = __shfl_sync(kFull, val, lane >> 1);
    const uint32_t vb = __shfl_sync(kFull, val, 16 + (lane >> 1));
    const int shift = (lane & 1) * 16;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = lane + 32 * half;
      const int gx = sx0 + c;
      if (c < 1 || c > kOutW || gx >= w) continue;
      const int raw = str16[sr * (2 * kStrWords) + 2 + c];
      const int sup = ((half ? vb : va) >> shift) & 0xffff;
      const int v = nms ? sup : raw;
      const size_t o = static_cast<size_t>(gy) * w + gx;
      if (raw_f32 != nullptr) raw_f32[o] = static_cast<float>(raw);
      if (out_u8 != nullptr)
        out_u8[o] = static_cast<uint8_t>(v);
      else
        out_f32[o] = static_cast<float>(v);
    }
  }
}

// strength rows a block takes for an (h, w) image: a block's time is a
// chain of latencies that grows with its rows, and a small image has too
// few blocks to hide it behind one another
int rows_for(int h, int w) {
  return static_cast<long long>(h) * w < kSmallPixels ? kShort : kTall;
}

template <int N, int STR_H>
int launch_rows(const uint8_t* img, int h, int w, int threshold, int nms,
                uint8_t* out_u8, float* out_f32, float* raw_f32,
                unsigned long long* counts, cudaStream_t s) {
  const dim3 grid((w + kOutW - 1) / kOutW, (h + STR_H - 3) / (STR_H - 2));
  if (counts != nullptr)
    fast_kernel<N, STR_H, true><<<grid, kThreads, 0, s>>>(
        img, h, w, threshold, nms, out_u8, out_f32, raw_f32, counts);
  else
    fast_kernel<N, STR_H, false><<<grid, kThreads, 0, s>>>(
        img, h, w, threshold, nms, out_u8, out_f32, raw_f32, counts);
  return (int)cudaGetLastError();
}

int launch(const void* img, int h, int w, int threshold, int n, int nms,
           void* out_u8, void* out_f32, void* raw_f32, void* counts,
           void* stream) {
  if (h <= 0 || w <= 0) return (int)cudaSuccess;
  if (n != 9 && n != 12) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(img);
  uint8_t* ou = static_cast<uint8_t*>(out_u8);
  float* of = static_cast<float*>(out_f32);
  float* raw = static_cast<float*>(raw_f32);
  unsigned long long* cn = static_cast<unsigned long long*>(counts);
  const bool tall = rows_for(h, w) == kTall;
  if (n == 9)
    return tall ? launch_rows<9, kTall>(in, h, w, threshold, nms, ou, of, raw,
                                        cn, s)
                : launch_rows<9, kShort>(in, h, w, threshold, nms, ou, of,
                                         raw, cn, s);
  return tall ? launch_rows<12, kTall>(in, h, w, threshold, nms, ou, of, raw,
                                       cn, s)
              : launch_rows<12, kShort>(in, h, w, threshold, nms, ou, of, raw,
                                        cn, s);
}

}  // namespace

extern "C" {

// (h, w) u8 -> (h, w) strengths map, NMS applied when nms != 0; the map is
// u8 when as_f32 == 0, else f32. Returns the launch's cudaError_t.
int compv_fast_strengths_nms(const void* img, void* out, int h, int w,
                             int threshold, int n, int nms, int as_f32,
                             void* stream) {
  return launch(img, h, w, threshold, n, nms, as_f32 ? nullptr : out,
                as_f32 ? out : nullptr, nullptr, nullptr, stream);
}

// (h, w) u8 -> the f32 strengths map and its f32 NMS map in one launch.
int compv_fast_strengths_and_nms(const void* img, void* raw, void* nms_out,
                                 int h, int w, int threshold, int n,
                                 void* stream) {
  return launch(img, h, w, threshold, n, 1, nullptr, nms_out, raw, nullptr,
                stream);
}

// The two-output launch once more, also adding to counts[0..4) (u64, not
// zeroed here) what the early-out did with each warp row it tested:
// tested, left with neither side computed, brighter side computed, darker
// side computed. A measurement aid; the maps are the same.
int compv_fast_early_out_counts(const void* img, void* raw, void* nms_out,
                                void* counts, int h, int w, int threshold,
                                int n, void* stream) {
  return launch(img, h, w, threshold, n, 1, nullptr, nms_out, raw, counts,
                stream);
}

// The strength region of a block (width, height) and its output tile
// (width, height) for an (h, w) image, for models of the kernel's geometry.
void compv_fast_geometry(int h, int w, int* out4) {
  out4[0] = kStrW;
  out4[1] = rows_for(h, w);
  out4[2] = kOutW;
  out4[3] = rows_for(h, w) - 2;
}

}  // extern "C"

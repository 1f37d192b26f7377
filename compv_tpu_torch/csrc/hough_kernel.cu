// Standard Hough transform vote accumulator on Hopper.
//
// Replaces compv_tpu/ops/pallas/hough_kernel.py:sht_accumulate_pallas (K4).
// For every edge point e with weight w[e] != 0 and every theta row t, add
// w[e] to rho bin rint((cos_t[t] * x[e] + sin_t[t] * y[e] + rho_max) /
// rho_step), clipped to [0, n_rho): an (n_theta, n_rho) i32 accumulator
// equal to the twin (ops/kernels/hough_kernel.py) bit for bit. The wrapper
// hands over the reference's f32 cos/sin table, rho_max rounded to f32 and
// the f32 reciprocal of rho_step.
//
// Numerics: the reference, jitted on XLA:CPU, computes the rho of a vote as
// one fused multiply-add fma(cos, x, sin*y) and replaces the division by
// the constant rho_step with a multiplication by its f32 reciprocal. Each
// step here is an explicit round-to-nearest intrinsic (__fmul_rn,
// __fmaf_rn, __fadd_rn), so nvcc can neither contract nor reassociate
// them, and rintf rounds half to even as jnp.round does. Votes are integer
// atomics, so their order does not enter the result.
//
// What bounds it: at 720p (65,536 edge slots of which some 25,000 hold an
// edge, 180 thetas, n_rho 2942) the bytes are the 768 KB list and the 2.1 MB
// accumulator, under a microsecond of HBM time, and the real work 4.5 M
// votes of seven fp32 operations each, half a microsecond. What a kernel
// pays here is something else: a thread that walks the list slot by slot
// waits for L2 once a slot, and a CTA a theta re-reads the whole list 180
// times; and the votes themselves, shared-memory atomics, run at about
// 4.5 a clock an SM here whatever the split of the work and whether or not
// neighbouring slots vote for neighbouring bins (measured with the list
// shuffled), so 4.5 M votes over 132 SMs are some 3.5 us. The Pallas
// kernel's MXU one-hot contraction and per-theta rho window were devices
// for the TPU's VMEM and MXU and are not kept.
//
// Design: theta-blocked, edge-split, reduced inside a thread-block cluster.
//   * A CTA takes a block of T thetas and one S-th of the edge list: of the
//     groups of 128 slots (four a lane, one 16-byte load per array) those
//     whose number is its rank modulo S, dealt round its 16 warps, so that
//     a list whose edges are a prefix spreads evenly over CTAs and warps.
//     A warp loads four groups with independent vector loads, all started
//     before any is used, and keeps them in registers; groups without a
//     weight are dropped at once (w is any i32 vector: nothing relies on
//     the edges being a prefix; the groups that hold one are moved to the
//     front). So the list is read once per theta block, not once per
//     theta, and no load waits for another.
//   * It votes for its T thetas from registers into T histograms of n_rho
//     i32 bins in dynamic shared memory: per theta all bins of the live
//     groups first, then their atomics, no branch between (a zero weight
//     adds nothing), rounding by a magic-number add in place of rintf and
//     the float-to-int conversion.
//   * Why clusters: the S CTAs of a cluster hold S partial histograms of
//     the same T thetas. After cluster.sync() each CTA sums its S-th of
//     the T x n_rho bins over the S peers through distributed shared
//     memory, 16 bytes a load, and writes that slice of acc coalesced.
//     Every element of acc is written exactly once, so the accumulator
//     needs no zeroing pass and the call is one device operation; global
//     atomics onto a zeroed accumulator would cost a second one.
//   * T and S come from the shapes (plan()): one CTA an SM in one wave.
//     Zeroing and reducing the histograms costs in proportion to T x
//     n_rho a CTA, which grows with S when the grid is to fill the card,
//     while a small S means more passes over a longer share of the list:
//     S = 4 measured best at 720p (8 when the thetas are too few to fill
//     the card otherwise), and T is the least for which the theta blocks
//     times S fit the SMs, within the shared memory a block may opt into
//     (180 thetas on 132 SMs: T = 6, 30 blocks, 120 CTAs).
//   * Wide accumulators: where one theta row of n_rho bins is more than a
//     block's shared memory (some 58,000 bins: a 2160x3840 image at a rho
//     step of 0.1 has 88,118), a CTA owns a rho range of its thetas, a tile
//     of 2^k bins, and the grid gains a rho-tile dimension. Every CTA still
//     walks its share of the list; a vote lands at its bin modulo the tile
//     width and adds its weight where the bin's tile is the CTA's own, 0
//     elsewhere, so the loop stays free of branches and the misses spread
//     over the banks. Reduction and write go tile by tile, every element of
//     acc still written exactly once by one device operation. The thetas
//     times the tiles then fill the card without an edge split (S = 1
//     where they outnumber the SMs), in several waves. The narrow case
//     compiles to the code it was (kTiled = false).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                     // slots of a group a thread
constexpr int kGroup = 32 * kVec;           // slots a warp takes at once
constexpr int kPass = 4;                    // groups a warp and pass
constexpr int kMaxT = 16;
constexpr int kMaxS = 8;

// The votes of the first L of a warp's register-held groups for thetas
// t0 .. t0 + nt: all 4 L bins of a theta first, then the 4 L atomics, no
// branch between them. A zero weight adds nothing wherever its bin lies.
// kTiled: hist rows are `pitch` = 2^shift bins wide and hold the bins of
// rho tile `tile`; a vote for another tile adds 0 at its bin modulo pitch.
template <int L, bool kTiled>
__device__ __forceinline__ void vote(
    int32_t* hist, const float (&xs)[kPass][kVec],
    const float (&ys)[kPass][kVec], const int32_t (&ws)[kPass][kVec],
    const float* __restrict__ cos_t, const float* __restrict__ sin_t, int nt,
    int n_rho, float rho_max, float inv_step, int pitch, int shift,
    int tile) {
  // rint(clamp(v)) == clamp(rint(v)) for integer bounds, and adding
  // 1.5 * 2^23 to a float in [0, 2^22) rounds it to the nearest integer,
  // ties to even, into the low mantissa bits: rintf and the conversion
  // without the conversion unit. fmaxf sends a NaN to bin 0, like the
  // conversion does.
  constexpr float kMagic = 12582912.0f;
  const float top = static_cast<float>(n_rho - 1);
#pragma unroll 2
  for (int t = 0; t < nt; ++t) {
    const float c = __ldg(cos_t + t);
    const float s = __ldg(sin_t + t);
    const int row = t * pitch - (kTiled ? 0 : __float_as_int(kMagic));
    int bin[L][kVec];
#pragma unroll
    for (int k = 0; k < L; ++k) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float rho = __fmaf_rn(c, xs[k][j], __fmul_rn(s, ys[k][j]));
        const float v = __fmul_rn(__fadd_rn(rho, rho_max), inv_step);
        bin[k][j] = __float_as_int(
            __fadd_rn(fminf(fmaxf(v, 0.0f), top), kMagic));
      }
    }
#pragma unroll
    for (int k = 0; k < L; ++k) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (kTiled) {
          const int b = bin[k][j] - __float_as_int(kMagic);
          atomicAdd(&hist[row + (b & (pitch - 1))],
                    (b >> shift) == tile ? ws[k][j] : 0);
        } else {
          atomicAdd(&hist[row + bin[k][j]], ws[k][j]);
        }
      }
    }
  }
}

// shift: kTiled, the log2 of the rho tile's width (blockIdx.z is the tile).
template <bool kTiled>
__global__ void __launch_bounds__(kThreads, 1)
    sht_accumulate(const float* __restrict__ x, const float* __restrict__ y,
                   const int32_t* __restrict__ w,
                   const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, int32_t* __restrict__ acc,
                   int n_edges, int n_theta, int n_rho, float rho_max,
                   float inv_step, int n_t, int vec_ok, int shift) {
  extern __shared__ __align__(16) int32_t hist[];   // (n_t, pitch)
  const int pitch = kTiled ? 1 << shift : n_rho;
  const int tile = kTiled ? static_cast<int>(blockIdx.z) : 0;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_s = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = blockIdx.x * n_t;
  const int nt = min(n_t, n_theta - t0);
  const int bins = nt * pitch;
  {
    int4* h4 = reinterpret_cast<int4*>(hist);
    for (int b = tid; b < bins / 4; b += kThreads)
      h4[b] = make_int4(0, 0, 0, 0);
    if (tid < (bins & 3)) hist[(bins & ~3) + tid] = 0;
  }
  __syncthreads();

  // group q (slots [q * kGroup, (q + 1) * kGroup)) belongs to the CTA of
  // rank q % S and there to warp (q / S) % kWarps: neighbouring groups go
  // to different CTAs, so a list whose edges are a prefix spreads evenly
  const long long n_groups = (static_cast<long long>(n_edges) + kGroup - 1)
                             / kGroup;
  const long long stride = static_cast<long long>(n_s) * kWarps;
  for (long long q0 = static_cast<long long>(warp) * n_s + rank;
       q0 < n_groups; q0 += stride * kPass) {
    float xs[kPass][kVec], ys[kPass][kVec];
    int32_t ws[kPass][kVec];
    if (vec_ok && (q0 + stride * (kPass - 1) + 1) * kGroup <= n_edges) {
#pragma unroll
      for (int k = 0; k < kPass; ++k) {
        const long long e = (q0 + stride * k) * kGroup + lane * kVec;
        const int4 wv = *reinterpret_cast<const int4*>(w + e);
        const float4 xv = *reinterpret_cast<const float4*>(x + e);
        const float4 yv = *reinterpret_cast<const float4*>(y + e);
        ws[k][0] = wv.x, ws[k][1] = wv.y, ws[k][2] = wv.z, ws[k][3] = wv.w;
        xs[k][0] = xv.x, xs[k][1] = xv.y, xs[k][2] = xv.z, xs[k][3] = xv.w;
        ys[k][0] = yv.x, ys[k][1] = yv.y, ys[k][2] = yv.z, ys[k][3] = yv.w;
      }
    } else {   // the ragged end of the list, or arrays off 16 bytes
#pragma unroll
      for (int k = 0; k < kPass; ++k) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const long long e = (q0 + stride * k) * kGroup + lane * kVec + j;
          const bool in = e < n_edges;
          ws[k][j] = in ? w[e] : 0;
          xs[k][j] = in ? x[e] : 0.0f;
          ys[k][j] = in ? y[e] : 0.0f;
        }
      }
    }
    // the groups of the warp that hold a weight move to the front (a list
    // whose edges are a prefix has them there already) and only they vote
    bool live[kPass];
#pragma unroll
    for (int k = 0; k < kPass; ++k)
      live[k] = __any_sync(0xffffffffu,
                           (ws[k][0] | ws[k][1] | ws[k][2] | ws[k][3]) != 0);
#pragma unroll
    for (int a = 0; a < kPass - 1; ++a) {
#pragma unroll
      for (int b = kPass - 1; b > a; --b) {
        if (live[b] && !live[b - 1]) {
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const float tx = xs[b][j], ty = ys[b][j];
            const int32_t tw = ws[b][j];
            xs[b][j] = xs[b - 1][j], ys[b][j] = ys[b - 1][j];
            ws[b][j] = ws[b - 1][j];
            xs[b - 1][j] = tx, ys[b - 1][j] = ty, ws[b - 1][j] = tw;
          }
          live[b] = false, live[b - 1] = true;
        }
      }
    }
    int n_live = 0;
#pragma unroll
    for (int k = 0; k < kPass; ++k) n_live += live[k];
    static_assert(kPass == 4, "the dispatch below lists the live counts");
    if (n_live == 4)
      vote<4, kTiled>(hist, xs, ys, ws, cos_t + t0, sin_t + t0, nt, n_rho,
                       rho_max, inv_step, pitch, shift, tile);
    else if (n_live == 3)
      vote<3, kTiled>(hist, xs, ys, ws, cos_t + t0, sin_t + t0, nt, n_rho,
                       rho_max, inv_step, pitch, shift, tile);
    else if (n_live == 2)
      vote<2, kTiled>(hist, xs, ys, ws, cos_t + t0, sin_t + t0, nt, n_rho,
                       rho_max, inv_step, pitch, shift, tile);
    else if (n_live == 1)
      vote<1, kTiled>(hist, xs, ys, ws, cos_t + t0, sin_t + t0, nt, n_rho,
                       rho_max, inv_step, pitch, shift, tile);
  }

  // the S partial histograms become this theta block's rows of acc: each
  // CTA sums and writes its slice, four bins a load
  cluster.sync();
  const int per = ((bins + n_s - 1) / n_s + 3) & ~3;
  const int b0 = min(bins, rank * per);
  const int b1 = min(bins, b0 + per);
  int32_t* out = acc + static_cast<size_t>(t0) * n_rho;
  const bool out_vec = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int32_t* peers[kMaxS];
#pragma unroll
  for (int i = 0; i < kMaxS; ++i)
    peers[i] = cluster.map_shared_rank(hist, (rank + i) % n_s);
  if constexpr (kTiled) {
    // hist row t holds bins [r0, r0 + pitch) of theta t0 + t; pitch and
    // the slices are multiples of 4, so a group of 4 stays in one row
    const int r0 = tile << shift;
    for (int b = b0 + 4 * tid; b < b1; b += 4 * kThreads) {
      const int col = r0 + (b & (pitch - 1));
      if (col >= n_rho) continue;
      int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int i = 0; i < kMaxS; ++i) {
        if (i < n_s) {
          const int4 v = *reinterpret_cast<const int4*>(peers[i] + b);
          sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
        }
      }
      int32_t* o = out + static_cast<size_t>(b >> shift) * n_rho + col;
      if (col + 4 <= n_rho && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
        *reinterpret_cast<int4*>(o) = sum;
      } else {
        const int32_t part[4] = {sum.x, sum.y, sum.z, sum.w};
        for (int e = 0; e < 4 && col + e < n_rho; ++e) o[e] = part[e];
      }
    }
  } else {
    for (int b = b0 + 4 * tid; b < b1; b += 4 * kThreads) {
      if (b + 4 <= b1) {
        int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
        for (int i = 0; i < kMaxS; ++i) {
          if (i < n_s) {
            const int4 v = *reinterpret_cast<const int4*>(peers[i] + b);
            sum.x += v.x, sum.y += v.y, sum.z += v.z, sum.w += v.w;
          }
        }
        if (out_vec) {
          *reinterpret_cast<int4*>(out + b) = sum;
        } else {
          out[b] = sum.x, out[b + 1] = sum.y;
          out[b + 2] = sum.z, out[b + 3] = sum.w;
        }
      } else {
        for (int e = b; e < b1; ++e) {   // the slice's last bins
          int32_t sum = 0;
#pragma unroll
          for (int i = 0; i < kMaxS; ++i)
            if (i < n_s) sum += peers[i][e];
          out[e] = sum;
        }
      }
    }
  }
  cluster.sync();   // no CTA leaves while a peer still reads its bins
}

int attribute(cudaDeviceAttr what) {
  int device = 0, v = 0;
  if (cudaGetDevice(&device) != cudaSuccess
      || cudaDeviceGetAttribute(&v, what, device) != cudaSuccess)
    return -1;
  return v;
}

// pitch: the bins of a histogram row (n_rho, or the rho tile's width).
cudaLaunchConfig_t config(int n_theta, int pitch, int n_t, int n_s,
                          int n_tiles, cudaLaunchAttribute* attr,
                          cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_theta + n_t - 1) / n_t, n_s, n_tiles);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(n_t) * pitch * sizeof(int32_t);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = n_s;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

struct Plan {
  int n_t;      // thetas a CTA
  int n_s;      // CTAs a cluster (the split of the edge list)
  int n_tiles;  // rho tiles; 1: a CTA holds whole rows (kTiled = false)
  int shift;    // log2 of a tile's width where n_tiles > 1
};

// Tries (t, s) and smaller until the device takes the cluster; the kernel's
// shared-memory attribute is left set for what it took.
template <bool kTiled>
cudaError_t fit(int n_theta, int pitch, int n_tiles, int* t, int* s) {
  for (;;) {
    cudaError_t err = cudaFuncSetAttribute(
        sht_accumulate<kTiled>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(*t * pitch * sizeof(int32_t)));
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg =
        config(n_theta, pitch, *t, *s, n_tiles, &attr, nullptr);
    int resident = 0;
    err = cudaOccupancyMaxActiveClusters(&resident, sht_accumulate<kTiled>,
                                         &cfg);
    if (err == cudaSuccess && resident > 0) return cudaSuccess;
    cudaGetLastError();   // a refused shape is tried smaller, not reported
    if (*s > 1)
      *s /= 2;
    else if (*t > 1)
      *t /= 2;
    else
      return err != cudaSuccess ? err : cudaErrorLaunchOutOfResources;
  }
}

// The plan for an (n_theta, n_rho) accumulator on the current device. Kept
// for the last shape asked.
cudaError_t plan(int n_theta, int n_rho, Plan* out) {
  static int key[3] = {-1, -1, -1};
  static Plan val = {0, 0, 0, 0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (key[0] == device && key[1] == n_theta && key[2] == n_rho) {
    *out = val;
    return cudaSuccess;
  }
  const int optin = attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int sms = attribute(cudaDevAttrMultiProcessorCount);
  if (optin < 0 || sms < 0) return cudaErrorInvalidDevice;
  const long long row = static_cast<long long>(n_rho) * sizeof(int32_t);
  Plan p = {1, 1, 1, 0};
  if (row > optin) {
    // rho tiles of the largest power of two of bins a block can hold, one
    // theta a CTA: the fewest passes over the list. The edge split is kept
    // only where thetas times tiles leave SMs empty.
    while ((8ll << p.shift) <= optin) ++p.shift;
    p.n_tiles = (n_rho + (1 << p.shift) - 1) >> p.shift;
    const long long ctas = static_cast<long long>(n_theta) * p.n_tiles;
    p.n_s = ctas >= sms ? 1 : ctas * 4 * 2 <= sms ? kMaxS : 4;
    err = fit<true>(n_theta, 1 << p.shift, p.n_tiles, &p.n_t, &p.n_s);
  } else {
    // one CTA an SM and one wave: with S CTAs a cluster, T is the least
    // for which the theta blocks times S fit the SMs. S = 4 unless the
    // thetas are so few that 8 are needed to spread the list.
    const int t_max = static_cast<int>(
        optin / row < kMaxT ? optin / row : kMaxT);
    p.n_s = n_theta * 4 * 2 <= sms ? kMaxS : 4;
    const long long need =
        (static_cast<long long>(n_theta) * p.n_s + sms - 1) / sms;
    p.n_t = static_cast<int>(need > t_max ? t_max : need);
    err = fit<false>(n_theta, n_rho, 1, &p.n_t, &p.n_s);
  }
  if (err != cudaSuccess) return err;
  key[0] = device, key[1] = n_theta, key[2] = n_rho;
  *out = val = p;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of `device` may opt into, in bytes
// (above n_rho * 4 of it the accumulator is rho-tiled); -1 when the query
// fails.
int compv_sht_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// The thetas a CTA (ts[0]), the CTAs a cluster (ts[1]) and the rho tiles
// (ts[2]; 1 where a CTA holds whole theta rows) that compv_sht_accumulate
// takes for this shape on the current device. Returns a cudaError_t.
int compv_sht_plan(int n_theta, int n_rho, int* ts) {
  if (n_theta <= 0 || n_rho <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t err = plan(n_theta, n_rho, &p);
  if (err == cudaSuccess) ts[0] = p.n_t, ts[1] = p.n_s, ts[2] = p.n_tiles;
  return static_cast<int>(err);
}

// x, y: (n_edges,) f32; w: (n_edges,) i32; cos_t, sin_t: (n_theta,) f32;
// inv_step: f32(1) / f32(rho_step); acc: (n_theta, n_rho) i32, every
// element written. Returns the cudaError_t of the launch (0 on success).
int compv_sht_accumulate(const float* x, const float* y, const int32_t* w,
                         const float* cos_t, const float* sin_t, int32_t* acc,
                         int n_edges, int n_theta, int n_rho, float rho_max,
                         float inv_step, cudaStream_t stream) {
  if (n_theta <= 0) return static_cast<int>(cudaSuccess);
  Plan p;
  cudaError_t err = plan(n_theta, n_rho, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_ok = ((reinterpret_cast<uintptr_t>(x)
                       | reinterpret_cast<uintptr_t>(y)
                       | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  cudaLaunchAttribute attr;
  const bool tiled = p.n_tiles > 1;
  cudaLaunchConfig_t cfg = config(n_theta, tiled ? 1 << p.shift : n_rho,
                                  p.n_t, p.n_s, p.n_tiles, &attr, stream);
  err = cudaLaunchKernelEx(
      &cfg, tiled ? sht_accumulate<true> : sht_accumulate<false>, x, y, w,
      cos_t, sin_t, acc, n_edges, n_theta, n_rho, rho_max, inv_step, p.n_t,
      vec_ok, p.shift);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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
// them, and rintf rounds half to even as jnp.round does.
//
// What bounds it: at 720p (65,536 edge slots, 180 thetas, n_rho 2942) the
// work is 11.8 M votes, each a few flops and one shared-memory atomic; the
// edge list (768 KB) is re-read once per theta from L2. The Pallas kernel's
// MXU one-hot contraction and its per-theta rho window were devices for
// the TPU's VMEM and MXU and are not kept: on Hopper the histogram fits in
// shared memory (11.8 KB at 720p, ~35 KB at 4K) and integer shared atomics
// are cheap and order-free, so the result is deterministic.
//
// Design: one CTA per theta row; its int32 histogram of n_rho bins lives in
// dynamic shared memory; threads stride over the edge list (neighbouring
// threads on neighbouring edges, so loads coalesce), skip zero weights and
// atomicAdd into shared memory; then the row is written out coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
    sht_accumulate(const float* __restrict__ x, const float* __restrict__ y,
                   const int32_t* __restrict__ w,
                   const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, int32_t* __restrict__ acc,
                   int n_edges, int n_rho, float rho_max, float inv_step) {
  extern __shared__ int32_t hist[];
  const int t = blockIdx.x;
  for (int b = threadIdx.x; b < n_rho; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const float c = cos_t[t];
  const float s = sin_t[t];
  for (int e = threadIdx.x; e < n_edges; e += blockDim.x) {
    const int32_t we = w[e];
    if (we == 0) continue;
    const float rho = __fmaf_rn(c, x[e], __fmul_rn(s, y[e]));
    const float v = __fmul_rn(__fadd_rn(rho, rho_max), inv_step);
    int bin = static_cast<int>(rintf(v));
    bin = min(max(bin, 0), n_rho - 1);
    atomicAdd(&hist[bin], we);
  }
  __syncthreads();
  int32_t* row = acc + static_cast<size_t>(t) * n_rho;
  for (int b = threadIdx.x; b < n_rho; b += blockDim.x) row[b] = hist[b];
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of `device` may opt into, in bytes
// (the wrapper's bound on n_rho); -1 when the query fails.
int compv_sht_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// x, y: (n_edges,) f32; w: (n_edges,) i32; cos_t, sin_t: (n_theta,) f32;
// inv_step: f32(1) / f32(rho_step); acc: (n_theta, n_rho) i32, every
// element written. Returns the cudaError_t
// of the launch (0 on success).
int compv_sht_accumulate(const float* x, const float* y, const int32_t* w,
                         const float* cos_t, const float* sin_t, int32_t* acc,
                         int n_edges, int n_theta, int n_rho, float rho_max,
                         float inv_step, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_rho) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      sht_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  sht_accumulate<<<n_theta, kThreads, smem, stream>>>(
      x, y, w, cos_t, sin_t, acc, n_edges, n_rho, rho_max, inv_step);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

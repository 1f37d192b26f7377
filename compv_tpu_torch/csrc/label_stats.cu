// Per-strip distinct labels and their pixel counts on Hopper.
//
// Replaces compv_tpu/ops/pallas/label_stats.py:strip_label_counts (K5). An
// (H, W) i32 label map (background < 0) is cut into strips of strip_rows
// rows; for strip s the kernel writes, in ascending label order, the first
// `rounds` distinct labels and how many pixels of the strip carry each:
// records[s][0][k] = label, records[s][1][k] = count for k < used[s],
// used[s] = min(distinct, rounds), truncated[s] = distinct > rounds. Slots
// k >= used[s] are written as 0.
//
// What bounds it: on bench.py's 1122x1182 text scene a strip is 8 x 1122
// labels (35.9 KB), 148 strips in all: 5.3 MB read once, ~1 MB written.
// The work is the in-block sort, bound by shared-memory bandwidth: a
// bitonic network over n keys makes ~n log2(n)^2 / 2 shared accesses. The
// TPU kernel enumerated a strip's labels by "next = min of labels >
// current", one full-strip reduction per distinct label; that loop is not
// kept.
//
// Design: one CTA per strip. The strip's foreground labels are compacted
// into dynamic shared memory (a warp ballot and one shared atomicAdd per
// warp; their order does not matter, they are sorted next), padded with
// INT32_MAX to the next power of two of their count, and sorted there by a
// bitonic network, so a sparse strip sorts few keys (a full 8 x 1122
// strip sorts 16,384 = 64 KB). Run heads of the sorted keys are the
// distinct labels; a block-wide exclusive scan of each thread's head count
// ranks them, the first rounds + 1 head positions go to shared memory, and
// a run's count is the distance to the next head (or to the foreground
// count).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int32_t kSentinel = INT32_MAX;

__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x >> 5;
    int ws = lane < n_warps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, ws, d);
      if (lane >= d) ws += o;
    }
    if (lane < n_warps) warp_sums[lane] = ws;   // inclusive over warps
    if (lane == 31) *total = ws;
  }
  __syncthreads();
  return incl - v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

__global__ void __launch_bounds__(kThreads)
    strip_counts(const int32_t* __restrict__ labels, int h, int w,
                 int strip_rows, int n_pow2, int rounds,
                 int32_t* __restrict__ records, int32_t* __restrict__ used,
                 int32_t* __restrict__ truncated) {
  extern __shared__ int32_t smem[];
  int32_t* keys = smem;            // n_pow2 sorted keys
  int32_t* pos = smem + n_pow2;    // rounds + 1 head positions
  __shared__ int warp_sums[32];
  __shared__ int distinct;
  __shared__ int n_fg;

  const int s = blockIdx.x;
  const int row0 = s * strip_rows;
  const int n = min(strip_rows, h - row0) * w;
  const int32_t* src = labels + static_cast<size_t>(row0) * w;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) n_fg = 0;
  __syncthreads();
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const int32_t l = i < n ? src[i] : -1;
    const unsigned fg = __ballot_sync(0xffffffffu, l >= 0);
    int slot = 0;
    if (lane == 0 && fg) slot = atomicAdd(&n_fg, __popc(fg));
    slot = __shfl_sync(0xffffffffu, slot, 0);
    if (l >= 0) keys[slot + __popc(fg & ((1u << lane) - 1u))] = l;
  }
  __syncthreads();
  const int n_valid = n_fg;
  int m = 2;  // sort size: a power of two >= n_valid, <= n_pow2
  while (m < n_valid) m <<= 1;
  for (int i = n_valid + threadIdx.x; i < m; i += blockDim.x)
    keys[i] = kSentinel;
  __syncthreads();

  // bitonic sort, ascending; pair p of a step compares i and i | j
  for (int k = 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (m >> 1); p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i | j;
        const int32_t a = keys[i];
        const int32_t b = keys[l];
        if ((a > b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[l] = a;
        }
      }
      __syncthreads();
    }
  }

  // heads: each thread owns a contiguous chunk of the sorted labels
  const int per = (n_valid + blockDim.x - 1) / blockDim.x;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n_valid);
  const int hi = min(lo + per, n_valid);
  int heads = 0;
  for (int i = lo; i < hi; ++i) heads += (i == 0 || keys[i - 1] != keys[i]);
  int k = block_exclusive_scan(heads, warp_sums, &distinct);
  for (int i = lo; i < hi && k <= rounds; ++i)
    if (i == 0 || keys[i - 1] != keys[i]) pos[k++] = i;
  __syncthreads();
  const int d = distinct;
  const int u = min(d, rounds);
  if (threadIdx.x == 0 && d <= rounds) pos[d] = n_valid;
  __syncthreads();

  int32_t* rec_label = records + static_cast<size_t>(s) * 2 * rounds;
  int32_t* rec_count = rec_label + rounds;
  for (int r = threadIdx.x; r < rounds; r += blockDim.x) {
    const bool in = r < u;
    rec_label[r] = in ? keys[pos[r]] : 0;
    rec_count[r] = in ? pos[r + 1] - pos[r] : 0;
  }
  if (threadIdx.x == 0) {
    used[s] = u;
    truncated[s] = d > rounds;
  }
}

}  // namespace

extern "C" {

// Largest dynamic shared memory a block of `device` may opt into, in bytes;
// -1 when the query fails.
int compv_strip_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// labels: (h, w) i32, contiguous; n_pow2: a power of two >= strip_rows * w;
// records: (n_strips, 2, rounds) i32; used, truncated: (n_strips,) i32.
// Returns the cudaError_t of the launch (0 on success).
int compv_strip_label_counts(const int32_t* labels, int h, int w,
                             int strip_rows, int n_strips, int n_pow2,
                             int rounds, int32_t* records, int32_t* used,
                             int32_t* truncated, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(n_pow2) + rounds + 1) * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      strip_counts, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  strip_counts<<<n_strips, kThreads, smem, stream>>>(
      labels, h, w, strip_rows, n_pow2, rounds, records, used, truncated);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

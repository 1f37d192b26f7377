// Ragged row compaction of two record tables on Hopper, offsets included.
//
// Replaces compv_tpu/ops/pallas/compact_kernel.py:compact_rows (K3). Row i
// of two (H, K) i32 tables holds count[i] valid records in its first
// slots; the row's first nch[i] * 8 records (nch = ceil(min(count, K) / 8))
// of both tables go to slot off8[i] * 8 of two flat outputs, off8 being the
// exclusive prefix sum of nch, clamped so that an overflowing frame still
// writes in bounds. Slots past the ragged total are left unwritten. The
// kernel also writes the 8-aligned ragged total and whether it fits.
//
// What bounds it: pure data movement. At the text scene's 1182 rows of
// K = 128 records, both tables are 1.2 MB, and the copy moves at most that
// in and out: well under a microsecond of HBM time, below one launch. Under
// jax.jit the reference's prefix sum and clamp fuse into the program around
// its kernel; in eager PyTorch the same lines were about 13 separate
// launches, each dearer than the copy. So the design is one launch.
//
// Design: one warp per row, 8 rows per block. A block does not wait on
// other blocks: it recomputes the prefix it needs from `counts` (H i32
// values from L2; the last block sums H - 8 of them with 256 threads and one
// block reduction), then adds the chunk counts of its own rows before each
// row. Since K and the chunking are multiples of 8 records, every row and
// every destination starts on a 32-byte boundary, and each lane moves
// 16-byte int4 vectors, neighbouring lanes on neighbouring addresses. The
// block that owns the last row writes total and ok. Rows are independent;
// offsets clamped for an overflowing frame may overlap, and there the
// surviving record is unspecified (the caller discards such a frame).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ int chunks(int count, int k) {
  return (min(count, k) + 7) / 8;
}

__global__ void __launch_bounds__(kThreads)
compact(const int4* __restrict__ a, const int4* __restrict__ b,
        const int32_t* __restrict__ counts, int4* __restrict__ oa,
        int4* __restrict__ ob, int32_t* __restrict__ total,
        uint8_t* __restrict__ ok, int h, int k, int cap8) {
  __shared__ int warp_sum[kWarpsPerBlock];
  __shared__ int row_nch[kWarpsPerBlock];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * kWarpsPerBlock;

  // chunks of all rows before this block's first
  int part = 0;
  for (int r = threadIdx.x; r < row0; r += kThreads)
    part += chunks(counts[r], k);
#pragma unroll
  for (int d = 16; d > 0; d /= 2) part += __shfl_xor_sync(0xffffffffu, part, d);
  if (lane == 0) warp_sum[warp] = part;
  if (threadIdx.x < kWarpsPerBlock) {
    const int r = row0 + threadIdx.x;
    row_nch[threadIdx.x] = r < h ? chunks(counts[r], k) : 0;
  }
  __syncthreads();
  int off8 = 0;
#pragma unroll
  for (int i = 0; i < kWarpsPerBlock; ++i) off8 += warp_sum[i];
#pragma unroll
  for (int i = 0; i < kWarpsPerBlock; ++i)
    if (i < warp) off8 += row_nch[i];

  const int row = row0 + warp;
  if (row >= h) return;
  const int nch = row_nch[warp];
  if (row == h - 1 && lane == 0) {
    const int total8 = off8 + nch;
    *total = total8 * 8;
    *ok = total8 <= cap8 ? 1 : 0;
  }
  // an overflowing frame still writes in bounds (cap8 >= K / 8)
  off8 = max(min(off8, cap8 - max(nch, 1)), 0);
  const int len4 = nch * 2;  // 8 records = two int4
  const size_t src = static_cast<size_t>(row) * (k / 4);
  const size_t dst = static_cast<size_t>(off8) * 2;
  for (int j = lane; j < len4; j += 32) {
    oa[dst + j] = a[src + j];
    ob[dst + j] = b[src + j];
  }
}

}  // namespace

extern "C" {

// a, b: (h, k) i32 with k % 8 == 0, 16-byte aligned; counts: (h,) i32;
// oa, ob: the flat (cap8 * 8,) outputs, cap8 >= k / 8; total: one i32;
// ok: one byte, set to 0 or 1. h >= 1. Returns the cudaError_t of the launch
// (0 on success).
int compv_compact_rows(const int32_t* a, const int32_t* b,
                       const int32_t* counts, int32_t* oa, int32_t* ob,
                       int32_t* total, uint8_t* ok, int h, int k, int cap8,
                       cudaStream_t stream) {
  const int blocks = (h + kWarpsPerBlock - 1) / kWarpsPerBlock;
  compact<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(a), reinterpret_cast<const int4*>(b),
      counts, reinterpret_cast<int4*>(oa), reinterpret_cast<int4*>(ob), total,
      ok, h, k, cap8);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

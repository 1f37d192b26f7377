// Ragged row compaction of two record tables on Hopper.
//
// Replaces compv_tpu/ops/pallas/compact_kernel.py:compact_rows (K3). Row i
// of two (H, K) i32 tables holds count[i] valid records in its first
// slots; the kernel copies the row's first nch[i] * 8 records
// (nch = ceil(min(count, K) / 8)) of both tables to slot off8[i] * 8 of two
// flat outputs. The wrapper computes nch, the exclusive prefix sum off8
// and the capacity clamp outside the kernel, as the JAX wrapper does;
// slots past the ragged total are left unwritten.
//
// What bounds it: pure data movement. At the text scene's 1182 rows of
// K = 128 records, both tables are 1.2 MB, and the copy moves at most that
// in and out: well under a microsecond of HBM time, so the launch and the
// few dependent loads per row (nch, off8) set its time.
//
// Design: one warp per row; since K and the chunking are multiples of 8
// records, every row and every destination starts on a 32-byte boundary,
// and each lane moves 16-byte int4 vectors, neighbouring lanes on
// neighbouring addresses. Rows are independent; offsets clamped for an
// overflowing frame may overlap, and there the surviving record is
// unspecified (the caller discards such a frame).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void compact(const int4* __restrict__ a, const int4* __restrict__ b,
                        const int32_t* __restrict__ off8,
                        const int32_t* __restrict__ nch,
                        int4* __restrict__ oa, int4* __restrict__ ob, int h,
                        int k4) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= h) return;
  const int lane = threadIdx.x % 32;
  const int len4 = nch[row] * 2;  // 8 records = two int4
  const size_t src = static_cast<size_t>(row) * k4;
  const size_t dst = static_cast<size_t>(off8[row]) * 2;
  for (int j = lane; j < len4; j += 32) {
    oa[dst + j] = a[src + j];
    ob[dst + j] = b[src + j];
  }
}

}  // namespace

extern "C" {

// a, b: (h, k) i32 with k % 8 == 0, 16-byte aligned; off8, nch: (h,) i32
// from the wrapper (off8 already clamped to the capacity); oa, ob: the flat
// outputs. Returns the cudaError_t of the launch (0 on success).
int compv_compact_rows(const int32_t* a, const int32_t* b, const int32_t* off8,
                       const int32_t* nch, int32_t* oa, int32_t* ob, int h,
                       int k, cudaStream_t stream) {
  const int blocks = (h + kWarpsPerBlock - 1) / kWarpsPerBlock;
  compact<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      reinterpret_cast<const int4*>(a), reinterpret_cast<const int4*>(b),
      off8, nch, reinterpret_cast<int4*>(oa), reinterpret_cast<int4*>(ob), h,
      k / 4);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// MSER ladder level areas (K7) on Hopper.
//
// Replaces no TPU kernel. The JAX ladder gets each level's exact component
// areas from run records (compv_tpu/features/mser.py: extract_runs, a packed
// key sort, a cumsum, a reversed cummin and a stable sort to compact), ops
// that XLA fuses inside one jit. The port's twin
// (ops/kernels/level_areas.py: _level_candidates_ref) is that chain written
// out, and run eagerly on the card it is ~115 launches a changed level, an
// int64 cummin of ~0.4 ms and two radix sorts, plus a device-to-host read of
// the widest row to choose the sorts' run capacity: 49 times a 1182 x 1122
// text page. Its only output is the candidate table of the level. The labels
// K2b writes are the minimum flat index of each pixel's component, so the
// area of a component is a count of its pixels by label into an n-long
// table (exact in int32, independent of the atomics' order), and the
// candidates in ascending root order are an ordered compaction of that
// table. No run capacity, so no sort and no host read.
//
// The contract is the twin's, bit for bit, on a labelling whose horizontal
// runs of foreground pixels each carry one label in [0, n) (as K2b's and
// K2a's do), -1 at background, at every cap >= 1 and amin >= 1:
//   * root[0 .. k): the labels whose pixel count is >= amin, ascending, the
//     first k = min(cap, their number); -1 in root[k .. cap);
//   * area[0 .. k): their pixel counts; 0 after them;
//   * *over = 1 when more than cap labels qualify, else 0.
// A label outside [-1, n) is not counted (the twin's run keys would not hold
// it either). One deviation from the twin, in its favour: where its exact run
// tier is clamped by the int32 bound on the sum of run lengths (H * W *
// ceil(W / 2) >= 2^31), the twin clips runs, sets over and misses their
// pixels; this kernel counts every pixel and sets over only for cap.
//
// What bounds it: bytes. A level reads its n i32 labels once (5.3 MB at
// 1182 x 1122) and the table is counted into, read back and cleared where it
// is not zero; the table (5.3 MB) stays in the 50 MB L2 between the passes.
// At 3.35 TB/s the labels' read and the table's write and read take ~5 us.
//
// Design, three launches on the caller's stream, allocating nothing:
//   level_areas (the counted launch): a warp counts 1,024 consecutive pixels,
//     32 coalesced steps; at each step __match_any_sync groups the lanes by
//     label and the group's first lane takes the group's popcount. A lane
//     holds one pending (label, count) and adds it to the table with one
//     atomic only when it leads a group of another label, or at the end. On
//     the upper levels one background component covers ~10^6 pixels: a warp
//     then adds to its label once, not once a pixel (~1,300 same-address
//     atomics a level, not 10^6).
//   candidate_counts: a block counts the entries >= amin of its 4,096 table
//     entries (16 consecutive a thread) into block_counts.
//   candidate_scatter: a block sums block_counts below it (its offset) and in
//     all (the total), ranks its qualifying entries in ascending order by a
//     block scan, writes those with rank < cap, clears every entry it read
//     that is not zero (so the table is zero again for the next level), and
//     fills the slots from min(total, cap) to cap; block 0 writes over.
// The table and block_counts are one scratch buffer the caller allocates
// zeroed once and passes to every level.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kCountThreads = 256;
constexpr int kCountSteps = 32;                       // pixels a lane counts
constexpr int kWarpPixels = 32 * kCountSteps;         // 1,024 a warp
constexpr int kBlockPixels = kCountThreads / 32 * kWarpPixels;
constexpr int kScanThreads = 256;
constexpr int kScanItems = 16;                        // entries a thread
constexpr int kScanBlock = kScanThreads * kScanItems; // 4,096 a block
constexpr int kScanWarps = kScanThreads / 32;

__global__ void __launch_bounds__(kCountThreads)
level_areas(const int* __restrict__ lbl, int n, int* __restrict__ table) {
  const int lane = threadIdx.x & 31;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kCountThreads +
       (threadIdx.x & ~31)) * kCountSteps;
  if (base >= n) return;  // the whole warp
  int v[kCountSteps];
#pragma unroll
  for (int s = 0; s < kCountSteps; ++s) {
    const long long p = base + s * 32 + lane;
    v[s] = p < n ? __ldg(lbl + p) : -1;
  }
  int held = -1, count = 0;  // this lane's pending (label, pixels)
#pragma unroll
  for (int s = 0; s < kCountSteps; ++s) {
    const int l = v[s] < n ? v[s] : -1;
    const unsigned same = __match_any_sync(kFull, l);
    if (l >= 0 && lane == __ffs(same) - 1) {
      const int c = __popc(same);
      if (l == held) {
        count += c;
      } else {
        if (held >= 0) atomicAdd(table + held, count);
        held = l;
        count = c;
      }
    }
  }
  if (held >= 0) atomicAdd(table + held, count);
}

// The kScanItems consecutive entries of one thread from `begin`; 0 past n.
__device__ __forceinline__ void load_items(const int* table, int n,
                                           long long begin,
                                           int (&a)[kScanItems]) {
  if (begin + kScanItems <= n) {  // 64-byte aligned: four 16-byte loads
    const int4* p = reinterpret_cast<const int4*>(table + begin);
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      const int4 x = p[q];
      a[4 * q] = x.x;
      a[4 * q + 1] = x.y;
      a[4 * q + 2] = x.z;
      a[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k)
      a[k] = begin + k < n ? table[begin + k] : 0;
  }
}

__device__ __forceinline__ int qualifying(const int (&a)[kScanItems],
                                          int amin) {
  int c = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) c += a[k] >= amin;
  return c;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The block's sum of v, in every thread.
__device__ __forceinline__ int block_sum(int v, int* part) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = (threadIdx.x & 31) < kScanWarps ? part[threadIdx.x & 31] : 0;
  return warp_sum(v);
}

__global__ void __launch_bounds__(kScanThreads)
candidate_counts(const int* __restrict__ table, int n, int amin,
                 int* __restrict__ block_counts) {
  __shared__ int part[kScanWarps];
  int a[kScanItems];
  load_items(table, n,
             static_cast<long long>(blockIdx.x) * kScanBlock +
                 threadIdx.x * kScanItems,
             a);
  const int c = block_sum(qualifying(a, amin), part);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = c;
}

__global__ void __launch_bounds__(kScanThreads)
candidate_scatter(int* __restrict__ table, int n, int amin,
                  const int* __restrict__ block_counts, int nb, int cap,
                  int* __restrict__ root, int* __restrict__ area,
                  int* __restrict__ over) {
  __shared__ int part_below[kScanWarps], part_total[kScanWarps];
  __shared__ int scan[kScanWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int below = 0, total = 0;
  for (int b = threadIdx.x; b < nb; b += kScanThreads) {
    const int c = block_counts[b];
    total += c;
    below += b < static_cast<int>(blockIdx.x) ? c : 0;
  }
  below = block_sum(below, part_below);
  total = block_sum(total, part_total);

  const long long begin =
      static_cast<long long>(blockIdx.x) * kScanBlock +
      threadIdx.x * kScanItems;
  int a[kScanItems];
  load_items(table, n, begin, a);
#pragma unroll
  for (int k = 0; k < kScanItems; ++k)
    if (a[k] != 0) table[begin + k] = 0;  // zero again for the next level

  // exclusive scan of the threads' qualifying counts, in thread order
  const int mine = qualifying(a, amin);
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += scan[w];
  int rank = below + before + incl - mine;
  if (mine && rank < cap) {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (a[k] >= amin) {
        if (rank < cap) {
          root[rank] = static_cast<int>(begin + k);
          area[rank] = a[k];
        }
        ++rank;
      }
    }
  }
  const int filled = min(total, cap);
  for (long long s = filled + static_cast<long long>(blockIdx.x) *
                                  kScanThreads + threadIdx.x;
       s < cap; s += static_cast<long long>(gridDim.x) * kScanThreads) {
    root[s] = -1;
    area[s] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *over = total > cap ? 1 : 0;
}

int scan_blocks(int n) { return n > 0 ? (n + kScanBlock - 1) / kScanBlock : 1; }

}  // namespace

extern "C" {

// The length of the scratch buffer for n labels: the n-entry table and the
// candidate passes' block counts. Allocate it zeroed, once for every level
// of that size.
int compv_level_areas_scratch(int n) { return n + scan_blocks(n); }

// lbl: n i32 labels (-1 at background), contiguous; scratch: the buffer
// above, zeroed before the first call and left zeroed by every call; root,
// area: cap i32 each; over: one i32. 0 <= n < 2^30, cap >= 1, amin >= 1.
// Returns the launches' cudaError_t (0 on success).
int compv_level_areas(const int* lbl, int n, int amin, int cap, int* scratch,
                      int* root, int* area, int* over, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = scan_blocks(n);
  int* block_counts = scratch + n;
  if (n > 0)
    level_areas<<<(n + kBlockPixels - 1) / kBlockPixels, kCountThreads, 0,
                  s>>>(lbl, n, scratch);
  candidate_counts<<<nb, kScanThreads, 0, s>>>(scratch, n, amin,
                                               block_counts);
  candidate_scatter<<<nb, kScanThreads, 0, s>>>(scratch, n, amin,
                                                block_counts, nb, cap, root,
                                                area, over);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

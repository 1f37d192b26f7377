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
// labels (35.9 KB), 148 strips in all: 5.3 MB read once, ~1 MB written,
// 1.7 us of HBM time. The TPU kernel enumerated a strip's labels by "next =
// min of labels > current", one full-strip reduction per distinct label;
// that loop is not kept. What a kernel pays above the bytes is the sort
// that brings equal labels together: a chain of barrier-separated steps
// whose length grows with the logarithm squared of the number of keys. Two
// facts of the problem keep that number small and the memory bounded.
//
// Design: one CTA per strip, a run-compressed bounded merge.
//   * Labels come in runs. The strip is read as one flat array, kStep
//     labels a step, four independent coalesced loads a thread. A warp
//     ballots where a label differs from its predecessor; every foreground
//     pixel at such a break is the head of a run and appends one key,
//     (label << 32) | run length, to a buffer in shared memory (one shared
//     atomicAdd a warp and load). A run cut by a 32-pixel boundary is two
//     keys of the same label. A map of per-pixel distinct labels is the
//     worst case, one key a pixel: exact all the same, only slower.
//   * Only the `rounds + 1` smallest distinct labels matter: used and
//     truncated need the distinct count only up to rounds + 1, and a label
//     with rounds + 1 smaller ones beside it never enters the result. So
//     the CTA keeps a sorted list of at most cap + 1 (label, count) pairs,
//     cap = min(rounds, pixels of a strip). Whenever the buffer could not
//     take another step, and at the end, it flushes: the list's pairs are
//     appended as keys, the buffer is sorted, equal labels are combined by
//     a block-wide prefix sum of the counts, and the first cap + 1 distinct
//     labels become the new list. A label among the cap + 1 smallest at the
//     end is among them at every flush, so none is lost and every count is
//     whole. Shared memory is the buffer (a power of two >= cap + 1 +
//     kStep keys) and the list, whatever strip_rows and W.
//   * Equal labels meet before the sort where they can: a run head first
//     tries a small hash table in shared memory (kSlots labels, linear
//     probing, kProbes tries: an atomicCAS on the label, an atomicAdd on its
//     count) and goes to the buffer only when it finds no slot. A flush
//     empties the table into the buffer. A strip of text has some 1,500
//     run heads and a few hundred labels, so its one sort takes a few
//     hundred keys; a strip with more labels than slots overflows into the
//     buffer and is sorted as before.
//   * The sort is a bitonic network over the next power of two of the
//     keys present (64 at least), so a sparse strip sorts few. What it
//     costs is the latency of a step times the steps, so the steps whose
//     partners lie within 64 keys, two thirds of them, run in registers: a
//     warp takes 64 keys, two a lane, and exchanges them by shuffles; only
//     the wider steps go through shared memory and a __syncthreads.
//   * Reading is a chain of latencies too: the loads of the next step are
//     in flight while this step's labels are balloted, and a warp takes its
//     room in the buffer with one atomicAdd a step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long pair_t;   // (label << 32) | count

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                  // loads a thread and step
constexpr int kStep = kThreads * kVec;   // labels a step
constexpr int kSlots = 1024;             // hash table slots, a power of two
constexpr int kProbes = 4;
constexpr pair_t kSentinel = ~0ull;       // above every key

__device__ __forceinline__ int label_of(pair_t k) {
  return static_cast<int>(k >> 32);
}
__device__ __forceinline__ int count_of(pair_t k) {
  return static_cast<int>(k & 0xffffffffull);
}
__device__ __forceinline__ pair_t make_key(int label, int count) {
  return (static_cast<pair_t>(static_cast<uint32_t>(label)) << 32)
         | static_cast<uint32_t>(count);
}

// Exclusive prefix over the block of a pair of counts packed into 64 bits
// (neither half overflows 32 bits); *total gets the sum.
__device__ pair_t block_exclusive_scan(pair_t v, pair_t* warp_sums,
                                      pair_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  pair_t incl = v;
  for (int d = 1; d < 32; d <<= 1) {
    const pair_t o = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    pair_t ws = lane < kWarps ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const pair_t o = __shfl_up_sync(0xffffffffu, ws, d);
      if (lane >= d) ws += o;
    }
    if (lane < kWarps) warp_sums[lane] = ws;   // inclusive over warps
    if (lane == kWarps - 1) *total = ws;
  }
  __syncthreads();
  return incl - v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// Pair p of a bitonic step (j, k): keys i and i | j, ascending where
// (i & k) == 0.
__device__ __forceinline__ void compare_exchange(pair_t* keys, int p, int j,
                                                 int k) {
  const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
  const int l = i | j;
  const pair_t a = keys[i];
  const pair_t b = keys[l];
  if ((a > b) == ((i & k) == 0)) {
    keys[i] = b;
    keys[l] = a;
  }
}

// The steps j_from, j_from / 2, .., 1 (j_from <= 32) of stage k on the 64
// keys from e0 - lane on, of which this lane holds a = keys[e0] and b =
// keys[e0 + 32]: partners 32 apart are the lane's own two, nearer ones
// another lane's.
__device__ __forceinline__ void warp_steps(pair_t& a, pair_t& b, int e0,
                                           int k, int j_from) {
  for (int j = j_from; j > 0; j >>= 1) {
    if (j == 32) {
      if ((a > b) == ((e0 & k) == 0)) {
        const pair_t t = a;
        a = b;
        b = t;
      }
      continue;
    }
    const pair_t oa = __shfl_xor_sync(0xffffffffu, a, j);
    const pair_t ob = __shfl_xor_sync(0xffffffffu, b, j);
    const bool low = (e0 & j) == 0;    // this lane holds the pair's first
    a = low == ((e0 & k) == 0) ? min(a, oa) : max(a, oa);
    b = low == (((e0 + 32) & k) == 0) ? min(b, ob) : max(b, ob);
  }
}

// Bitonic sort of keys[0, m), ascending; m a power of two >= 64. Called by
// the whole block after a barrier; ends with one.
__device__ void sort_keys(pair_t* keys, int m) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // stages 2 .. 64 stay inside aligned chunks of 64 keys
  for (int c = warp; c * 64 < m; c += kWarps) {
    const int e0 = c * 64 + lane;
    pair_t a = keys[e0], b = keys[e0 + 32];
    for (int k = 2; k <= 64; k <<= 1) warp_steps(a, b, e0, k, k >> 1);
    keys[e0] = a, keys[e0 + 32] = b;
  }
  __syncthreads();
  for (int k = 128; k <= m; k <<= 1) {
    for (int j = k >> 1; j >= 64; j >>= 1) {
      for (int p = threadIdx.x; p < (m >> 1); p += kThreads)
        compare_exchange(keys, p, j, k);
      __syncthreads();
    }
    for (int c = warp; c * 64 < m; c += kWarps) {
      const int e0 = c * 64 + lane;
      pair_t a = keys[e0], b = keys[e0 + 32];
      warp_steps(a, b, e0, k, 32);
      keys[e0] = a, keys[e0 + 32] = b;
    }
    __syncthreads();
  }
}

// The (label, count) table that takes run heads before the buffer does.
struct Table {
  int32_t* labels;   // kSlots, -1 where empty
  int32_t* counts;
};

// Adds `count` pixels of `label`; false where kProbes slots held others.
__device__ __forceinline__ bool table_add(const Table& t, int label,
                                          int count) {
  unsigned slot = static_cast<unsigned>(label) * 2654435761u >> 12;
  for (int probe = 0; probe < kProbes; ++probe) {
    slot &= kSlots - 1;
    const int32_t old = atomicCAS(t.labels + slot, -1, label);
    if (old == -1 || old == label) {
      atomicAdd(t.counts + slot, count);
      return true;
    }
    ++slot;
  }
  return false;
}

struct State {
  pair_t warp_sums[kWarps];
  pair_t total;
  int n_buf;    // keys in the buffer
  int n_list;   // pairs in the list, <= cap + 1
};

// list[k] = (label_k << 32) | pixels of the labels before label_k, for
// k < n_list, and list[n_list] = (anything << 32) | all pixels when
// n_list <= cap: pair k's count is the difference of two neighbours. The
// pair at index cap, where there is one, only says that more than cap
// labels were seen; its count is never read.
__device__ __forceinline__ int list_count(const pair_t* list, int k, int cap) {
  return k < cap ? count_of(list[k + 1]) - count_of(list[k]) : 0;
}

// Sorts table + buffer + list, combines equal labels, leaves the cap + 1
// smallest in the list and the table and the buffer empty. Called by the
// whole block after a barrier; ends with one.
__device__ void flush(pair_t* buf, pair_t* list, const Table& table,
                      State* st, int cap) {
  const int lane = threadIdx.x & 31;
  for (int slot = threadIdx.x; slot < kSlots; slot += kThreads) {
    const int32_t label = table.labels[slot];
    const unsigned full = __ballot_sync(0xffffffffu, label >= 0);
    if (!full) continue;
    int at = 0;
    if (lane == 0) at = atomicAdd(&st->n_buf, __popc(full));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (label >= 0) {
      buf[at + __popc(full & ((1u << lane) - 1u))] =
          make_key(label, table.counts[slot]);
      table.labels[slot] = -1;
      table.counts[slot] = 0;
    }
  }
  __syncthreads();
  const int nb = st->n_buf, nl = st->n_list;
  const int n = nb + nl;
  for (int k = threadIdx.x; k < nl; k += kThreads)
    buf[nb + k] = make_key(label_of(list[k]), list_count(list, k, cap));
  int m = 64;
  while (m < n) m <<= 1;
  for (int i = n + threadIdx.x; i < m; i += kThreads) buf[i] = kSentinel;
  __syncthreads();
  sort_keys(buf, m);
  // each thread owns a contiguous chunk of the sorted keys; heads of equal-
  // label runs in the high half of the scanned pair, pixels in the low
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n);
  const int hi = min(lo + per, n);
  pair_t mine = 0;
  for (int i = lo; i < hi; ++i) {
    const bool head = i == 0 || label_of(buf[i - 1]) != label_of(buf[i]);
    mine += make_key(head, count_of(buf[i]));
  }
  const pair_t before = block_exclusive_scan(mine, st->warp_sums, &st->total);
  int rank = label_of(before), pixels = count_of(before);
  for (int i = lo; i < hi; ++i) {
    if (i == 0 || label_of(buf[i - 1]) != label_of(buf[i])) {
      if (rank <= cap) list[rank] = make_key(label_of(buf[i]), pixels);
      ++rank;
    }
    pixels += count_of(buf[i]);
  }
  if (threadIdx.x == 0) {
    const int distinct = label_of(st->total);
    if (distinct <= cap) list[distinct] = make_key(0, count_of(st->total));
    st->n_list = min(distinct, cap + 1);
    st->n_buf = 0;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    strip_counts(const int32_t* __restrict__ labels, int h, int w,
                 int strip_rows, int rounds, int cap, int buf_keys,
                 int32_t* __restrict__ records, int32_t* __restrict__ used,
                 int32_t* __restrict__ truncated) {
  extern __shared__ __align__(8) pair_t smem[];
  pair_t* buf = smem;               // buf_keys keys
  pair_t* list = smem + buf_keys;   // cap + 1 pairs
  Table table;
  table.labels = reinterpret_cast<int32_t*>(list + cap + 1);
  table.counts = table.labels + kSlots;
  __shared__ State st;

  const int s = blockIdx.x;
  const int row0 = s * strip_rows;
  const int n = min(strip_rows, h - row0) * w;
  const int32_t* src = labels + static_cast<size_t>(row0) * w;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) st.n_buf = st.n_list = 0;
  for (int slot = threadIdx.x; slot < kSlots; slot += kThreads) {
    table.labels[slot] = -1;
    table.counts[slot] = 0;
  }
  __syncthreads();
  int32_t ahead[kVec];   // the next step's labels, asked for a step early
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int i = k * kThreads + threadIdx.x;
    ahead[k] = i < n ? src[i] : -1;
  }
  for (int base = 0; base < n; base += kStep) {
    int32_t l[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      l[k] = max(ahead[k], -1);
      const int i = base + kStep + k * kThreads + threadIdx.x;
      ahead[k] = i < n ? src[i] : -1;
    }
    // every thread reads the fill before any warp appends to it
    const bool full = st.n_buf + st.n_list + kStep + kSlots > buf_keys;
    __syncthreads();
    if (full) flush(buf, list, table, &st, cap);
    unsigned heads[kVec];
    int run[kVec], mine = 0;
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int32_t prev = __shfl_up_sync(0xffffffffu, l[k], 1);
      const bool brk = lane == 0 || l[k] != prev;
      const unsigned breaks = __ballot_sync(0xffffffffu, brk);
      const unsigned later = breaks & ~((2u << lane) - 1u);
      run[k] = (later ? __ffs(later) - 1 : 32) - lane;
      // the heads the table has no slot for go to the buffer
      const bool head = brk && l[k] >= 0;
      heads[k] = __ballot_sync(0xffffffffu,
                               head && !table_add(table, l[k], run[k]));
      mine += __popc(heads[k]);
    }
    int slot = 0;
    if (lane == 0 && mine) slot = atomicAdd(&st.n_buf, mine);
    slot = __shfl_sync(0xffffffffu, slot, 0);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if ((heads[k] >> lane) & 1u)
        buf[slot + __popc(heads[k] & ((1u << lane) - 1u))] =
            make_key(l[k], run[k]);
      slot += __popc(heads[k]);
    }
    __syncthreads();
  }
  flush(buf, list, table, &st, cap);

  const int nl = st.n_list;
  const int u = min(nl, rounds);
  int32_t* rec_label = records + static_cast<size_t>(s) * 2 * rounds;
  int32_t* rec_count = rec_label + rounds;
  for (int r = threadIdx.x; r < rounds; r += kThreads) {
    const bool in = r < u;
    rec_label[r] = in ? label_of(list[r]) : 0;
    rec_count[r] = in ? list_count(list, r, cap) : 0;
  }
  if (threadIdx.x == 0) {
    used[s] = u;
    truncated[s] = nl > rounds;
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

// The keys the buffer must take beside the list: a step's run heads and
// the hash table's labels.
int compv_strip_step() { return kStep + kSlots; }

// The hash table's slots, 8 bytes of dynamic shared memory each.
int compv_strip_slots() { return kSlots; }

// labels: (h, w) i32, contiguous; cap: min(rounds, strip_rows * w);
// buf_keys: a power of two >= 64 and cap + 1 + compv_strip_step(); records:
// (n_strips, 2, rounds) i32; used, truncated: (n_strips,) i32. Returns the
// cudaError_t of the launch (0 on success).
int compv_strip_label_counts(const int32_t* labels, int h, int w,
                             int strip_rows, int n_strips, int rounds, int cap,
                             int buf_keys, int32_t* records, int32_t* used,
                             int32_t* truncated, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(buf_keys) + cap + 1 + kSlots) * sizeof(pair_t);
  cudaError_t err = cudaFuncSetAttribute(
      strip_counts, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  strip_counts<<<n_strips, kThreads, smem, stream>>>(
      labels, h, w, strip_rows, rounds, cap, buf_keys, records, used,
      truncated);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

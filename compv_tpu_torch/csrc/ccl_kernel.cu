// Connected-component labeling on Hopper: a lock-free union-find.
//
// Replaces compv_tpu/ops/pallas/ccl_kernel.py:pallas_label (K2a) and
// pallas_label_seeded (K2b). The contract is the label values, not the TPU
// algorithm: at each foreground pixel, the minimum of `init` over the
// pixel's 4- or 8-connected component; -1 at background. Unseeded (K2a),
// init is the flat index row * W + col. The TPU kernel iterates a
// neighbour-min propagation over the whole image held in VMEM, bounded by
// max_iter / jump_every / jump_dists knobs; nothing of that loop is kept.
//
// Design, one pass each, any H and W:
//   1. init_runs: one warp per 32-pixel row segment. A ballot of the
//      segment's foreground bits gives every foreground pixel the flat
//      index of the first pixel of its run inside the segment, so trees
//      start one level deep. Background gets -1 (K2b: minv = INT_MAX).
//   2. merge: union of each run with its neighbours in the row above,
//      linking the larger root under the smaller with atomicCAS. Only the
//      unions that the run structure does not already imply are made: a
//      run's first pixel unites with the run above it (or, 8-connected,
//      with the runs up-left and up-right when the pixel above is
//      background); a later pixel only where a new run above begins; a run
//      continuing across a segment seam unites with its left half.
//   3. flatten: every pixel's parent becomes its root. Path splitting in
//      the merge pass keeps the trees shallow; this pass only reads the
//      chains, so no late write can replace a stored root. Links always
//      point to smaller indices, so each component's root is its minimum
//      flat index: that is K2a's answer. K2b also takes
//      atomicMin(minv[root], init[p]) here.
//   4. (K2b only) gather: out[p] = minv[root(p)].
// The result depends only on the partition, so it is the same from run to
// run however the atomics interleave.
//
// What bounds it: 1122x1182 (the text scene) is 1.3 M pixels, a 1.3 MB u8
// mask and a 5.3 MB i32 map that each pass reads or writes once, and the
// map stays in the 50 MB L2 between passes: a few microseconds of HBM time.
// The cost is the global atomics and the dependent pointer chases of the
// finds in merge and flatten, whose number is set by the runs (a few per
// row segment), not by the pixels; the ballot init makes the pixel-level
// work a handful of coalesced loads and stores. A block-local pass in
// shared memory before the global merge is later work.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kSegW = 32;  // one warp per row segment
constexpr int kRows = 8;   // rows (warps) per block
constexpr int kThreads1d = 256;

// Root of x. Path splitting: each visited node is re-pointed at its
// grandparent. Only non-roots are written, and only to an ancestor, so this
// is safe against the concurrent atomicCAS links of unite().
__device__ __forceinline__ int find_root(int32_t* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    const int gp = __ldcg(parent + p);
    if (gp != p) __stcg(parent + x, gp);
    x = p;
    p = gp;
  }
  return x;
}

// Root of x, read only. The flatten pass must not split paths: another
// thread's splitting write could land on a pixel after that pixel stored
// its root, leaving an inner node there.
__device__ __forceinline__ int find_root_ro(const int32_t* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ void unite(int32_t* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    // link the larger root a under b, if a is still a root
    const int old = atomicCAS(parent + a, a, b);
    if (old == a) return;
    a = old;
  }
}

__global__ void init_runs(const uint8_t* __restrict__ fg,
                          int32_t* __restrict__ parent,
                          int32_t* __restrict__ minv, int h, int w) {
  const int lane = threadIdx.x;
  const int x = blockIdx.x * kSegW + lane;
  const int y = blockIdx.y * kRows + threadIdx.y;
  if (y >= h) return;  // the whole warp shares y
  const size_t i = static_cast<size_t>(y) * w + x;
  const bool on = x < w && fg[i] != 0;
  const unsigned mask = __ballot_sync(0xffffffffu, on);
  if (x >= w) return;
  if (minv != nullptr) minv[i] = INT_MAX;
  if (!on) {
    parent[i] = -1;
    return;
  }
  // background lanes at or left of this one; the run starts after the last
  const unsigned bg_left = ~mask & (0xffffffffu >> (31 - lane));
  const int start = bg_left ? 32 - __clz(bg_left) : 0;
  parent[i] = static_cast<int32_t>(static_cast<size_t>(y) * w
                                   + blockIdx.x * kSegW + start);
}

__global__ void merge(const uint8_t* __restrict__ fg, int32_t* parent, int h,
                      int w, int conn8) {
  const int x = blockIdx.x * kSegW + threadIdx.x;
  const int y = blockIdx.y * kRows + threadIdx.y;
  if (x >= w || y >= h) return;
  const int i = y * w + x;
  if (!fg[i]) return;
  const bool west = x > 0 && fg[i - 1];
  if (west && (x % kSegW) == 0) unite(parent, i, i - 1);
  if (y == 0) return;
  const int up = i - w;
  const bool n = fg[up] != 0;
  if (!conn8) {
    // the run's pixel under the start of each run above
    if (n && !(west && fg[up - 1])) unite(parent, i, up);
    return;
  }
  const bool ne = x + 1 < w && fg[up + 1];
  if (west) {
    // NW and N are covered by the west pixel; NE starts a new run above
    if (!n && ne) unite(parent, i, up + 1);
    return;
  }
  if (n) {
    unite(parent, i, up);  // N's run holds NW and NE where they are set
    return;
  }
  if (x > 0 && fg[up - 1]) unite(parent, i, up - 1);
  if (ne) unite(parent, i, up + 1);
}

__global__ void flatten(int32_t* parent, const int32_t* __restrict__ init,
                        int32_t* minv, int n) {
  const int i = blockIdx.x * kThreads1d + threadIdx.x;
  if (i >= n || __ldcg(parent + i) < 0) return;
  const int r = find_root_ro(parent, i);
  __stcg(parent + i, r);
  if (minv != nullptr) atomicMin(minv + r, init[i]);
}

__global__ void gather_min(int32_t* __restrict__ out,
                           const int32_t* __restrict__ minv, int n) {
  const int i = blockIdx.x * kThreads1d + threadIdx.x;
  if (i >= n) return;
  const int r = out[i];
  if (r >= 0) out[i] = minv[r];
}

int label(const uint8_t* fg, const int32_t* init, int32_t* out, int32_t* minv,
          int h, int w, int connectivity, cudaStream_t stream) {
  const int n = h * w;
  const dim3 block(kSegW, kRows);
  const dim3 grid((w + kSegW - 1) / kSegW, (h + kRows - 1) / kRows);
  const int grid1d = (n + kThreads1d - 1) / kThreads1d;
  init_runs<<<grid, block, 0, stream>>>(fg, out, minv, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge<<<grid, block, 0, stream>>>(fg, out, h, w, connectivity == 8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flatten<<<grid1d, kThreads1d, 0, stream>>>(out, init, minv, n);
  err = cudaGetLastError();
  if (err != cudaSuccess || minv == nullptr) return static_cast<int>(err);
  gather_min<<<grid1d, kThreads1d, 0, stream>>>(out, minv, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2a. fg: (h, w) bytes, non-zero = foreground; out: (h, w) i32. Returns
// the cudaError_t of the launches (0 on success).
int compv_ccl_label(const uint8_t* fg, int32_t* out, int h, int w,
                    int connectivity, cudaStream_t stream) {
  return label(fg, nullptr, out, nullptr, h, w, connectivity, stream);
}

// K2b. init: (h, w) i32; minv: (h, w) i32 scratch.
int compv_ccl_label_seeded(const uint8_t* fg, const int32_t* init,
                           int32_t* out, int32_t* minv, int h, int w,
                           int connectivity, cudaStream_t stream) {
  return label(fg, init, out, minv, h, w, connectivity, stream);
}

}  // extern "C"

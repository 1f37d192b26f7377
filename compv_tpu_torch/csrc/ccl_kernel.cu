// Connected-component labeling on Hopper: a lock-free union-find.
//
// Replaces compv_tpu/ops/pallas/ccl_kernel.py:pallas_label (K2a) and
// pallas_label_seeded (K2b). The contract is the label values, not the TPU
// algorithm: at each foreground pixel, the minimum flat index (row * W + col)
// of the pixel's 4- or 8-connected component; -1 at background. The TPU
// kernel iterates a neighbour-min propagation over the whole image held in
// VMEM, bounded by max_iter / jump_every / jump_dists knobs; nothing of
// that loop is kept. What is kept of K2b is its idea, the warm start.
//
// K2a (compv_ccl_label), one pass each, any H and W:
//   1. init_runs: one warp per 32-pixel row segment. A ballot of the
//      segment's foreground bits gives every foreground pixel the flat
//      index of the first pixel of its run inside the segment, so trees
//      start one level deep. Background gets -1.
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
//      flat index.
//
// K2b (compv_ccl_label_seeded) takes a seed map `init` that holds, at each
// foreground pixel p, p itself or the label p had on a foreground subset of
// this mask (MSER's ladder: the previous, nested level). Then init[p] <= p,
// init[init[p]] == init[p], and init[p] lies in p's component: the seed is
// already a forest of depth <= 1 whose links point to smaller indices, and
// the minimum of init over a component is the component's minimum flat
// index, i.e. K2a's answer on the same mask. So K2b starts from the seed
// instead of from single runs:
//   1. seed: one warp per 32-pixel row segment. parent[p] = init[p] at
//      foreground, -1 at background. For memory safety a seed outside
//      [0, p] or on a background pixel is replaced by p. A seed that names
//      a pixel of another component gives an undefined (but in-bounds,
//      terminating) labeling. Pixels that are their own seed (new at this
//      level, or the root of an earlier component) get, by a ballot, the
//      first pixel of their run of such pixels inside the segment: still a
//      link to a smaller index of the same component, and a level that
//      brings many new pixels starts from their runs, not from single
//      pixels.
//   2. merge (seeded): the same unions with the row above, plus a union of
//      every foreground pixel with its west neighbour, because no init pass
//      has linked the runs; the rules for the row above stay valid since
//      each run is connected through its west links by the end of the
//      pass. Every union first compares the two parents (two coalesced
//      loads): equal parents mean one tree already, which holds for every
//      edge inside one earlier component, and unions never separate nodes,
//      so a stale read can only miss a reject, never make a wrong one.
//      Finds and atomicCAS are left for the level's new pixels and for the
//      seams between components that merge at this level.
//   3. flatten, as above.
// Either result depends only on the partition, so it is the same from run
// to run however the atomics interleave.
//
// What bounds it: 1122x1182 (the text scene) is 1.3 M pixels, a 1.3 MB u8
// mask and a 5.3 MB i32 map (K2b: one more 5.3 MB read of the seed), each
// moved once: 2.0 us (K2a) and 3.6 us (K2b) of HBM time at 3.35 TB/s, less
// than the three launches themselves. The map stays in the 50 MB L2
// between passes. The cost above that floor is the global atomics and the
// dependent pointer chases of the finds; K2a sets their number by the runs,
// K2b by what changed since the seed. flatten stores only where the parent
// was not yet the root, which on a warm start is a small share of the map.
// A block-local pass in shared memory before the global merge is later
// work for K2a.
#include <cuda_runtime.h>
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

// kReject: return at once when a and b have one parent (the warm start's
// common case); both are foreground, so neither parent is -1.
template <bool kReject>
__device__ void unite(int32_t* parent, int a, int b) {
  if (kReject && __ldcg(parent + a) == __ldcg(parent + b)) return;
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
                          int32_t* __restrict__ parent, int h, int w) {
  const int lane = threadIdx.x;
  const int x = blockIdx.x * kSegW + lane;
  const int y = blockIdx.y * kRows + threadIdx.y;
  if (y >= h) return;  // the whole warp shares y
  const size_t i = static_cast<size_t>(y) * w + x;
  const bool on = x < w && fg[i] != 0;
  const unsigned mask = __ballot_sync(0xffffffffu, on);
  if (x >= w) return;
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

__global__ void seed(const uint8_t* __restrict__ fg,
                     const int32_t* __restrict__ init,
                     int32_t* __restrict__ parent, int h, int w) {
  const int lane = threadIdx.x;
  const int x = blockIdx.x * kSegW + lane;
  const int y = blockIdx.y * kRows + threadIdx.y;
  if (y >= h) return;  // the whole warp shares y
  const int i = y * w + x;
  const bool on = x < w && fg[i] != 0;
  int s = on ? init[i] : -1;
  // one unsigned compare covers s < 0 and s > i
  if (on && (static_cast<unsigned>(s) > static_cast<unsigned>(i) || !fg[s]))
    s = i;
  // own-seed pixels point at the first of their run of such pixels
  const bool fresh = on && s == i;
  const unsigned mask = __ballot_sync(0xffffffffu, fresh);
  if (x >= w) return;
  if (fresh) {
    const unsigned stale_left = ~mask & (0xffffffffu >> (31 - lane));
    const int start = stale_left ? 32 - __clz(stale_left) : 0;
    s = y * w + blockIdx.x * kSegW + start;
  }
  parent[i] = s;
}

// kSeeded: no init pass has linked the runs, so every pixel unites with its
// west neighbour, and every union starts with the parent compare.
template <bool kSeeded>
__global__ void merge(const uint8_t* __restrict__ fg, int32_t* parent, int h,
                      int w, int conn8) {
  const int x = blockIdx.x * kSegW + threadIdx.x;
  const int y = blockIdx.y * kRows + threadIdx.y;
  if (x >= w || y >= h) return;
  const int i = y * w + x;
  if (!fg[i]) return;
  const bool west = x > 0 && fg[i - 1];
  if (west && (kSeeded || (x % kSegW) == 0))
    unite<kSeeded>(parent, i, i - 1);
  if (y == 0) return;
  const int up = i - w;
  const bool n = fg[up] != 0;
  if (!conn8) {
    // the run's pixel under the start of each run above
    if (n && !(west && fg[up - 1])) unite<kSeeded>(parent, i, up);
    return;
  }
  const bool ne = x + 1 < w && fg[up + 1];
  if (west) {
    // NW and N are covered by the west pixel; NE starts a new run above
    if (!n && ne) unite<kSeeded>(parent, i, up + 1);
    return;
  }
  if (n) {
    // N's run holds NW and NE where they are set
    unite<kSeeded>(parent, i, up);
    return;
  }
  if (x > 0 && fg[up - 1]) unite<kSeeded>(parent, i, up - 1);
  if (ne) unite<kSeeded>(parent, i, up + 1);
}

__global__ void flatten(int32_t* parent, int n) {
  const int i = blockIdx.x * kThreads1d + threadIdx.x;
  if (i >= n) return;
  const int p = __ldcg(parent + i);
  if (p < 0) return;
  const int r = find_root_ro(parent, p);
  if (r != p) __stcg(parent + i, r);
}

// Launches the passes; init == nullptr is K2a.
int label(const uint8_t* fg, const int32_t* init, int32_t* out, int h, int w,
          int connectivity, cudaStream_t stream) {
  const int n = h * w;
  const dim3 block(kSegW, kRows);
  const dim3 grid((w + kSegW - 1) / kSegW, (h + kRows - 1) / kRows);
  const int grid1d = (n + kThreads1d - 1) / kThreads1d;
  const int conn8 = connectivity == 8;
  if (init == nullptr)
    init_runs<<<grid, block, 0, stream>>>(fg, out, h, w);
  else
    seed<<<grid, block, 0, stream>>>(fg, init, out, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (init == nullptr)
    merge<false><<<grid, block, 0, stream>>>(fg, out, h, w, conn8);
  else
    merge<true><<<grid, block, 0, stream>>>(fg, out, h, w, conn8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flatten<<<grid1d, kThreads1d, 0, stream>>>(out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2a. fg: (h, w) bytes, non-zero = foreground; out: (h, w) i32. Returns
// the cudaError_t of the launches (0 on success).
int compv_ccl_label(const uint8_t* fg, int32_t* out, int h, int w,
                    int connectivity, cudaStream_t stream) {
  return label(fg, nullptr, out, h, w, connectivity, stream);
}

// K2b. init: (h, w) i32 seed, read at foreground pixels only.
int compv_ccl_label_seeded(const uint8_t* fg, const int32_t* init,
                           int32_t* out, int h, int w, int connectivity,
                           cudaStream_t stream) {
  return label(fg, init, out, h, w, connectivity, stream);
}

}  // extern "C"

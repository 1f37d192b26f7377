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
// K2a (compv_ccl_label), any H and W: the image is cut into tiles of 32 x
// 32 pixels, and every union between two pixels of one tile is made in
// shared memory, before anything touches the global map.
//   1. tiles: a warp takes a tile, a CTA kTileWarps of them. With a lane a
//      column, the warp asks for all its mask bytes at once and ballots them
//      into one word of foreground bits a row; from there a lane is a row
//      and works on words, not pixels: the runs of its row and the pixels
//      that the row rules below make unite with the row above are bit
//      expressions of its word and the word of the lane before. A run is
//      named by the tile-local index of its first pixel. Every lane writes
//      the unions of its row as (run, run above) pairs into a list in
//      shared memory, at offsets from a warp prefix sum, and the warp then
//      makes them 32 at a time on a tile-local parent array with shared-
//      memory atomicCAS: a lane that made its own row's unions one after
//      the other left the other lanes waiting for the longest row. The
//      list takes the rows in the order of their lowest set bit, so that
//      the trees stay shallow. Then every parent becomes its root by
//      pointer jumping, and with a lane a column again the warp writes to
//      the global map the flat index of each pixel's tile-local root (-1
//      at background): trees one level deep, all unions inside a tile
//      done. Local indices grow with flat indices, so a tile-local root is
//      the least flat index of its piece.
//   2. seams: only the pixels on a tile's first row, first column and (8-
//      connected) last column unite across tiles, in global memory with
//      atomicCAS, some (H / 32) * W + 2 * (W / 32) * H threads instead
//      of H * W. A first-row pixel follows the row rules below against the
//      row above. A first-column pixel unites with its west neighbour
//      unless both pixels above them are set in the same tile row (then
//      that pair carries the link), and with its north-west neighbour where
//      neither west nor north is set; a last-column pixel with its
//      north-east neighbour where neither north nor east is set. A thread
//      asks for all the mask bytes it may need before it tests any.
//   3. flatten: every pixel's parent becomes its root, two loads for
//      almost all, and a store only where the parent was not yet the root.
//      This pass only reads the chains, so no late write can replace a
//      stored root. Links always point to smaller indices, so each
//      component's root is its minimum flat index.
// Three launches: seams and flatten behind a grid barrier in one
// cooperative launch measured slower than the two launches (PERF.md).
//
// The row rules, the unions of a pixel with the row above that the run
// structure does not already imply: a run's first pixel unites with the run
// above it (or, 8-connected, with the runs up-left and up-right when the
// pixel above is background); a later pixel only where a new run above
// begins.
//
// K2b (compv_ccl_label_seeded) takes a seed map `init` that holds, at each
// foreground pixel p, p itself or the label p had on a foreground subset of
// this mask (MSER's ladder: the previous, nested level). Then init[p] <= p,
// init[init[p]] == init[p], and init[p] lies in p's component: the seed is
// already a forest of depth <= 1 whose links point to smaller indices, and
// the minimum of init over a component is the component's minimum flat
// index, i.e. K2a's answer on the same mask. So K2b starts from the seed
// instead of from single runs, over the whole map in global memory:
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
//   2. merge: the row rules for every pixel, plus a union of every
//      foreground pixel with its west neighbour, because no init pass has
//      linked the runs; the rules for the row above stay valid since each
//      run is connected through its west links by the end of the pass.
//      Every union first compares the two parents (two coalesced loads):
//      equal parents mean one tree already, which holds for every edge
//      inside one earlier component, and unions never separate nodes, so a
//      stale read can only miss a reject, never make a wrong one. Finds
//      and atomicCAS are left for the level's new pixels and for the seams
//      between components that merge at this level.
//   3. flatten, as above.
// Either result depends only on the partition, so it is the same from run
// to run however the atomics interleave.
//
// What bounds it: 1122x1182 (the text scene) is 1.3 M pixels, a 1.3 MB u8
// mask and a 5.3 MB i32 map (K2b: one more 5.3 MB read of the seed), each
// moved once: 2.0 us (K2a) and 3.6 us (K2b) of HBM time at 3.35 TB/s, less
// than the launches themselves. The map stays in the 50 MB L2 between
// passes. The cost above that floor is the global atomics and the
// dependent pointer chases of the finds, a few hundred nanoseconds a hop in
// L2: K2a keeps them to the seams, K2b to what changed since the seed.
// Inside a tile the cost is latency too, of shared memory: with a thread a
// pixel the threads mostly wait, so K2a's tile pass gives a thread a row of
// bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSegW = 32;  // one warp per row segment
constexpr int kRows = 8;   // rows (warps) per block
constexpr int kThreads1d = 256;
constexpr int kTile = 32;      // K2a's tile: a row a lane, a column a bit
constexpr int kTileWarps = 4;  // tiles (warps) a CTA
constexpr int kSeamJobs = 3 * kTile;   // a tile's seam pixels
// a row has at most 16 runs and 16 pixels under the end of a run above
constexpr int kTileUnions = kTile * kTile;

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

// K2b's merge: the row rules for every pixel and, because no init pass has
// linked the runs, a union with the west neighbour; every union starts with
// the parent compare.
__global__ void merge_seeded(const uint8_t* __restrict__ fg, int32_t* parent,
                             int h, int w, int conn8) {
  const int x = blockIdx.x * kSegW + threadIdx.x;
  const int y = blockIdx.y * kRows + threadIdx.y;
  if (x >= w || y >= h) return;
  const int i = y * w + x;
  if (!fg[i]) return;
  const bool west = x > 0 && fg[i - 1];
  if (west) unite<true>(parent, i, i - 1);
  if (y == 0) return;
  const int up = i - w;
  const bool n = fg[up] != 0;
  if (!conn8) {
    // the run's pixel under the start of each run above
    if (n && !(west && fg[up - 1])) unite<true>(parent, i, up);
    return;
  }
  const bool ne = x + 1 < w && fg[up + 1];
  if (west) {
    // NW and N are covered by the west pixel; NE starts a new run above
    if (!n && ne) unite<true>(parent, i, up + 1);
    return;
  }
  if (n) {
    // N's run holds NW and NE where they are set
    unite<true>(parent, i, up);
    return;
  }
  if (x > 0 && fg[up - 1]) unite<true>(parent, i, up - 1);
  if (ne) unite<true>(parent, i, up + 1);
}

// ---- K2a: tile-local union-find in shared memory, seams in global memory

// Root of x on the tile-local parent array, with path splitting (safe
// against unite_local's atomicCAS for the reason given at find_root).
__device__ __forceinline__ int find_local(volatile int32_t* par, int x) {
  int p = par[x];
  while (p != x) {
    const int gp = par[p];
    if (gp != p) par[x] = gp;
    x = p;
    p = gp;
  }
  return x;
}

__device__ void unite_local(int32_t* par, int a, int b) {
  while (true) {
    a = find_local(par, a);
    b = find_local(par, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicCAS(par + a, a, b);
    if (old == a) return;
    a = old;
  }
}

// First column of the run of `row` (a tile row's foreground bits, bit x
// for column x) that holds its set bit x: one past the last clear bit below.
__device__ __forceinline__ int run_start(uint32_t row, int x) {
  const uint32_t clear_below = ~row & ((1u << x) - 1u);
  return clear_below ? 32 - __clz(clear_below) : 0;
}

// Pass 1 for the tile at (ty0, tx0), by one warp. par: kTile * kTile tile-
// local parents, of which the unions touch those of the first pixels of
// runs and the others stay their own; jobs: the tile's unions, (run << 16)
// | run above.
__device__ void label_tile(const uint8_t* __restrict__ fg,
                           int32_t* __restrict__ out, int h, int w, int conn8,
                           int ty0, int tx0, int32_t* par, uint32_t* jobs) {
  const int lane = threadIdx.x & 31;
  // a lane a column: all mask bytes are asked for before any is balloted
  // (at addresses clamped into the map, so that no load hangs on a test),
  // and lane r keeps row r's word, cut to the map
  uint8_t mask[kTile];
  const bool x_in = tx0 + lane < w;
  const uint8_t* column = fg + (x_in ? tx0 + lane : w - 1);
#pragma unroll
  for (int r = 0; r < kTile; ++r)
    mask[r] = column[static_cast<size_t>(min(ty0 + r, h - 1)) * w];
  const uint32_t cols_in = __ballot_sync(0xffffffffu, x_in);
  uint32_t rows[kTile];   // every lane keeps all the words, for the labels
  uint32_t cur = 0;
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
    const uint32_t bits = __ballot_sync(0xffffffffu, mask[r] != 0);
    rows[r] = ty0 + r < h ? bits & cols_in : 0u;
    if (lane == r) cur = rows[r];
    par[r * kTile + lane] = r * kTile + lane;
  }

  // a lane a row. The pixels that unite with the row above, by the row
  // rules, as bit expressions: with north; with north-west; with north-east
  const int r = lane;
  uint32_t up = __shfl_up_sync(0xffffffffu, cur, 1);
  if (r == 0) up = 0;
  const uint32_t west = cur << 1, nw = up << 1, ne = up >> 1;
  uint32_t to_n, to_nw = 0, to_ne = 0;
  if (conn8) {
    to_n = cur & ~west & up;
    to_nw = cur & ~west & ~up & nw;
    to_ne = cur & ~up & ne;
  } else {
    to_n = cur & up & ~(west & nw);
  }
  // The list takes the rows in the order of their lowest set bit (the odd
  // rows, then 2, 6, 10, .., then 4, 12, .., 8, 24, 16): pieces of 2, 4, 8,
  // .. rows grow together, and the trees stay a few links deep. Row by
  // row, each row would hang under the one before it and every later find
  // would walk the whole column of links. at: this row's place in that
  // order; row_at: the row whose place this lane's number is.
  const int low = __ffs(r) - 1;
  const int at = r ? 32 - (32 >> low) + (r >> (low + 1)) : 31;
  const int low_at = __clz(31 - lane) - 27;
  const int row_at = lane == 31 ? 0
      : ((lane - 32 + (32 >> low_at)) << (low_at + 1)) + (1 << low_at);
  const int mine = __popc(to_n | to_nw) + __popc(to_ne);
  int before = __shfl_sync(0xffffffffu, mine, row_at);   // inclusive prefix
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, before, d);
    if (lane >= d) before += o;
  }
  const int n_jobs = __shfl_sync(0xffffffffu, before, 31);
  int slot = __shfl_sync(0xffffffffu, before, at) - mine;
  for (uint32_t m = to_n | to_nw; m; m &= m - 1) {
    const int x = __ffs(m) - 1;
    const int above = (to_n >> x) & 1 ? x : x - 1;
    jobs[slot++] = ((r * kTile + run_start(cur, x)) << 16)
                   | ((r - 1) * kTile + run_start(up, above));
  }
  for (uint32_t m = to_ne; m; m &= m - 1) {
    const int x = __ffs(m) - 1;
    jobs[slot++] = ((r * kTile + run_start(cur, x)) << 16)
                   | ((r - 1) * kTile + run_start(up, x + 1));
  }
  __syncwarp();
  for (int j = lane; j < n_jobs; j += 32)
    unite_local(par, jobs[j] >> 16, jobs[j] & 0xffffu);
  __syncwarp();
  // every parent becomes its root by pointer jumping over the whole
  // array, a lane a column again: the loads of a round are independent, so
  // a round costs little more than one trip to shared memory, and a chain
  // of depth d is gone after log2(d) rounds, whichever lane's it is
  for (bool changed = true; changed;) {
    int32_t p[kTile];
#pragma unroll
    for (int k = 0; k < kTile; ++k) p[k] = par[k * kTile + lane];
    bool mine = false;
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const int32_t pp = par[p[k]];
      mine |= pp != p[k];
      p[k] = pp;
    }
#pragma unroll
    for (int k = 0; k < kTile; ++k) par[k * kTile + lane] = p[k];
    __syncwarp();
    changed = __any_sync(0xffffffffu, mine);
  }
  // the flat index of every pixel's tile-local root goes to the global
  // map: all of a lane's labels first, without a branch (a background lane
  // reads some parent of its row and drops it), then the stores
  int32_t label[kTile];
#pragma unroll
  for (int k = 0; k < kTile; ++k)
    label[k] = par[k * kTile + run_start(rows[k], lane)];
#pragma unroll
  for (int k = 0; k < kTile; ++k)
    label[k] = (rows[k] >> lane) & 1
                   ? (ty0 + label[k] / kTile) * w + tx0 + label[k] % kTile
                   : -1;
  if (!x_in) return;
  int32_t* column_out = out + tx0 + lane;
#pragma unroll
  for (int k = 0; k < kTile; ++k)
    if (ty0 + k < h)
      column_out[static_cast<size_t>(ty0 + k) * w] = label[k];
}

// Pass 2 for seam pixel `job` (kSeamJobs a tile: its first row, its first
// column, its last column), by one thread. The mask bytes around the pixel
// are asked for together, at addresses clamped into the map, before any is
// tested.
__device__ void unite_seam(const uint8_t* __restrict__ fg, int32_t* parent,
                           int h, int w, int conn8, int tiles_x, int job) {
  const int tile = job / kSeamJobs, k = job % kSeamJobs;
  const int ty0 = (tile / tiles_x) * kTile, tx0 = (tile % tiles_x) * kTile;
  const bool first_row = k < kTile;
  const bool first_col = !first_row && k < 2 * kTile;
  const int r = first_row ? 0 : k % kTile;
  const int y = ty0 + r;
  const int x = first_row ? tx0 + k : first_col ? tx0 : tx0 + kTile - 1;
  if (y >= h || x >= w) return;
  const int i = y * w + x;
  const bool has_w = x > 0, has_n = y > 0, has_e = x + 1 < w;
  const uint8_t at = fg[i];
  const uint8_t at_w = fg[has_w ? i - 1 : i];
  const uint8_t at_e = fg[has_e ? i + 1 : i];
  const uint8_t at_n = fg[has_n ? i - w : i];
  const uint8_t at_nw = fg[has_n && has_w ? i - w - 1 : i];
  const uint8_t at_ne = fg[has_n && has_e ? i - w + 1 : i];
  if (!at) return;
  const bool west = has_w && at_w, n = has_n && at_n;
  const bool nw = has_n && has_w && at_nw, ne = has_n && has_e && at_ne;
  if (first_row) {                       // the row rules
    if (!has_n) return;
    const int up = i - w;
    if (!conn8) {
      if (n && !(west && nw)) unite<false>(parent, i, up);
    } else if (west) {
      if (!n && ne) unite<false>(parent, i, up + 1);
    } else if (n) {
      unite<false>(parent, i, up);
    } else {
      if (nw) unite<false>(parent, i, up - 1);
      if (ne) unite<false>(parent, i, up + 1);
    }
  } else if (first_col) {                // west, north-west
    if (tx0 == 0) return;
    const bool above = r > 0;            // the row above is in this tile row
    // both pixels above set, in this tile row: they carry the link
    if (west && !(above && n && nw)) unite<false>(parent, i, i - 1);
    if (conn8 && above && nw && !west && !n)
      unite<false>(parent, i, i - w - 1);
  } else if (conn8 && r > 0 && ne && !n && !(has_e && at_e)) {
    unite<false>(parent, i, i - w + 1);  // last column: north-east
  }
}

__device__ __forceinline__ void flatten_pixel(int32_t* parent, int i) {
  const int p = __ldcg(parent + i);
  if (p < 0) return;
  const int r = find_root_ro(parent, p);
  if (r != p) __stcg(parent + i, r);
}

__global__ void __launch_bounds__(kTileWarps * 32)
    label_tiles(const uint8_t* __restrict__ fg, int32_t* __restrict__ out,
                int h, int w, int conn8, int tiles_x, int tiles) {
  __shared__ int32_t par[kTileWarps][kTile * kTile];
  __shared__ uint32_t jobs[kTileWarps][kTileUnions];
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x * kTileWarps + warp;
  if (tile < tiles)
    label_tile(fg, out, h, w, conn8, (tile / tiles_x) * kTile,
               (tile % tiles_x) * kTile, par[warp], jobs[warp]);
}

__global__ void unite_seams(const uint8_t* __restrict__ fg, int32_t* parent,
                            int h, int w, int conn8, int tiles_x, int jobs) {
  const int job = blockIdx.x * kThreads1d + threadIdx.x;
  if (job < jobs) unite_seam(fg, parent, h, w, conn8, tiles_x, job);
}

__global__ void flatten(int32_t* parent, int n) {
  const int i = blockIdx.x * kThreads1d + threadIdx.x;
  if (i < n) flatten_pixel(parent, i);
}

// K2a's passes.
int label(const uint8_t* fg, int32_t* out, int h, int w, int connectivity,
          cudaStream_t stream) {
  const int n = h * w;
  const int tiles_x = (w + kTile - 1) / kTile;
  const int tiles = tiles_x * ((h + kTile - 1) / kTile);
  const int conn8 = connectivity == 8;
  label_tiles<<<(tiles + kTileWarps - 1) / kTileWarps, kTileWarps * 32, 0,
                stream>>>(fg, out, h, w, conn8, tiles_x, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int jobs = tiles * kSeamJobs;
  unite_seams<<<(jobs + kThreads1d - 1) / kThreads1d, kThreads1d, 0,
                stream>>>(fg, out, h, w, conn8, tiles_x, jobs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flatten<<<(n + kThreads1d - 1) / kThreads1d, kThreads1d, 0, stream>>>(out,
                                                                        n);
  return static_cast<int>(cudaGetLastError());
}

// K2b's passes.
int label_seeded(const uint8_t* fg, const int32_t* init, int32_t* out, int h,
                 int w, int connectivity, cudaStream_t stream) {
  const int n = h * w;
  const dim3 block(kSegW, kRows);
  const dim3 grid((w + kSegW - 1) / kSegW, (h + kRows - 1) / kRows);
  seed<<<grid, block, 0, stream>>>(fg, init, out, h, w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_seeded<<<grid, block, 0, stream>>>(fg, out, h, w,
                                           connectivity == 8);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flatten<<<(n + kThreads1d - 1) / kThreads1d, kThreads1d, 0, stream>>>(out,
                                                                        n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K2a. fg: (h, w) bytes, non-zero = foreground; out: (h, w) i32. Returns
// the cudaError_t of the launches (0 on success).
int compv_ccl_label(const uint8_t* fg, int32_t* out, int h, int w,
                    int connectivity, cudaStream_t stream) {
  return label(fg, out, h, w, connectivity, stream);
}

// K2b. init: (h, w) i32 seed, read at foreground pixels only.
int compv_ccl_label_seeded(const uint8_t* fg, const int32_t* init,
                           int32_t* out, int h, int w, int connectivity,
                           cudaStream_t stream) {
  return label_seeded(fg, init, out, h, w, connectivity, stream);
}

}  // extern "C"

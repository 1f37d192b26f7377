"""Build-time variants of the FAST kernel (K1), the CCL labeler (K2a), the
SHT accumulator (K4) and the strip label counter (K5) timed against the
shipped ones on one NVIDIA GPU, and the phases of K2a, K4 and K5.

The design choices of the sources under csrc/ that were settled by
measurement (K1: warps a block and strength rows a block; K2a: the tile's
shape and whether its three passes are three, two or one launch; K4: thetas
a CTA and CTAs a cluster, the cluster reduction against global atomics onto
a zeroed accumulator; K5: threads a CTA and labels a thread and step) are
re-measured here: the script patches a copy of the source (it fails if the
text it replaces is gone), builds each variant with nvcc into
build/variants/, checks it against the twin, and prints one JSON line per
variant with its device time (torch.profiler, as chip_smoke.py's
device_ms). The copies of K2a, K4 and K5 also stamp clock64 at their phase
boundaries, so each line carries the mean cycles a CTA spends in each phase
(K4: zeroing, loading, voting, waiting at the first cluster barrier,
reducing and waiting at the second). From the repository root, on a machine
with one GPU and nvcc:

    python3 scripts/hopper_kernel_variants.py [K1] [K2a] [K4] [K5] [--log FILE]

With --log the lines are also appended to FILE.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

OUT = os.path.join(ROOT, "build", "variants")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

STAMP = (
    '#define STAMP(i) if (prof && threadIdx.x == 0) { prof[(blockIdx.x * '
    'gridDim.y + blockIdx.y) * 8 + (i)] = clock64(); }\n')   # K4's own


LOG = None   # --log FILE


def emit(obj) -> None:
    """The line to standard output and, with --log, to that file."""
    cs.emit(obj)
    if LOG:
        os.makedirs(os.path.dirname(os.path.abspath(LOG)), exist_ok=True)
        with open(LOG, "a") as f:
            f.write((obj if isinstance(obj, str) else json.dumps(obj)) + "\n")


def patched(source: str, edits) -> str:
    for old, new in edits:
        if old not in source:
            raise SystemExit(f"the source no longer holds: {old!r}")
        source = source.replace(old, new, 1)
    return source


def k4_source() -> str:
    """hough_kernel.cu with T / S overrides (-DFORCE_T, -DFORCE_S), the
    global-atomics epilogue (-DGLOBAL_ATOMICS) and phase stamps."""
    with open(os.path.join(ROOT, "compv_tpu_torch/csrc/hough_kernel.cu")) as f:
        src = f.read()
    return patched(src, [
        ("float inv_step, int n_t, int vec_ok, int shift) {",
         "float inv_step, int n_t, int vec_ok, int shift,\n"
         "                   long long* prof) {\n" + STAMP + "  STAMP(0)"),
        ("  }\n  __syncthreads();\n\n  // group q",
         "  }\n  __syncthreads();\n  STAMP(1)\n\n  // group q"),
        ("    bool live[kPass];",
         "    if (q0 < stride) STAMP(2)\n    bool live[kPass];"),
        ("  cluster.sync();\n  const int per",
         "  __syncthreads();\n  STAMP(3)\n"
         "#ifdef GLOBAL_ATOMICS\n"
         "  {\n"
         "    int32_t* sum = acc + static_cast<size_t>(t0) * n_rho;\n"
         "    for (int b = tid; !kTiled && b < bins; b += kThreads)\n"
         "      if (hist[b] != 0) atomicAdd(sum + b, hist[b]);\n"
         "    return;\n"
         "  }\n"
         "#endif\n"
         "  cluster.sync();\n  STAMP(4)\n  const int per"),
        ("  cluster.sync();   // no CTA",
         "  __syncthreads();\n  STAMP(5)\n  cluster.sync();\n  STAMP(6)\n"
         "  // no CTA"),
        ("    err = fit<false>(n_theta, n_rho, 1, &p.n_t, &p.n_s);",
         "#ifdef FORCE_T\n"
         "    p.n_t = FORCE_T, p.n_s = FORCE_S;\n"
         "#endif\n"
         "    err = fit<false>(n_theta, n_rho, 1, &p.n_t, &p.n_s);"),
        ("                         float inv_step, cudaStream_t stream) {",
         "                         float inv_step, cudaStream_t stream,\n"
         "                         long long* prof) {"),
        ("      vec_ok, p.shift);", "      vec_ok, p.shift, prof);"),
    ])


# Stamps through a device-side pointer that the copy's compv_set_prof sets:
# no kernel signature changes. The clock is read in an asm statement that
# takes `dep`, a value the phase before it produced, and clobbers memory, so
# that the compiler can move neither the phase's work below the stamp nor the
# next phase's above it.
PROF = (
    'namespace {\n__device__ long long* g_prof = nullptr;\n'
    '#define STAMP(i, dep) { long long t_; asm volatile('
    '"mov.u64 %0, %%clock64;" : "=l"(t_) : "r"(static_cast<int>(dep)) : '
    '"memory"); if (g_prof && threadIdx.x == 0) '
    'g_prof[blockIdx.x * 8 + (i)] = t_; }\n')
SET_PROF = (
    '\nextern "C" int compv_set_prof(long long* p) {\n'
    '  return static_cast<int>(cudaMemcpyToSymbol(g_prof, &p, sizeof(p)));\n'
    '}\n')


def read_source(name: str) -> str:
    with open(os.path.join(ROOT, "compv_tpu_torch", "csrc", name)) as f:
        return f.read()


def overridable(constant: str, value: str, macro: str):
    """An edit that lets -D<macro> replace a constexpr int's value."""
    return (f"constexpr int {constant} = {value};",
            f"#ifndef {macro}\n#define {macro} {value}\n#endif\n"
            f"constexpr int {constant} = {macro};")


# Seams and flatten in one cooperative launch, a grid barrier between them
# (-DFUSED): the alternative to two launches that csrc/ccl_kernel.cu names.
FUSED = """
#ifdef FUSED
}  // namespace
#include <cooperative_groups.h>
namespace {
__global__ void __launch_bounds__(kThreads1d)
    seams_flatten(const uint8_t* __restrict__ fg, int32_t* out, int h, int w,
                  int conn8, int tiles_x, int jobs) {
  const int stride = gridDim.x * kThreads1d;
  const int first = blockIdx.x * kThreads1d + threadIdx.x;
  for (int job = first; job < jobs; job += stride)
    unite_seam(fg, out, h, w, conn8, tiles_x, job);
  cooperative_groups::this_grid().sync();
  for (int i = first; i < h * w; i += stride) flatten_pixel(out, i);
}

cudaError_t launch_seams_flatten(const uint8_t* fg, int32_t* out, int h,
                                 int w, int conn8, int tiles_x, int jobs,
                                 cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, seams_flatten,
                                                kThreads1d, 0);
  const int want = (h * w + kThreads1d - 1) / kThreads1d;
  const int ctas = want < sms * per_sm ? want : sms * per_sm;
  void* args[] = {&fg, &out, &h, &w, &conn8, &tiles_x, &jobs};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(seams_flatten), dim3(ctas), dim3(kThreads1d),
      args, 0, stream);
}
#endif

// K2a's passes.
"""


# Flatten with -DFLAT_ILP pixels a thread, a block's width apart: all their
# parents asked for together, then all the first hops, then the chains.
FLAT_ILP = """
#ifdef FLAT_ILP
__global__ void flatten(int32_t* parent, int n) {
  const int base = blockIdx.x * (kThreads1d * FLAT_ILP) + threadIdx.x;
  int p[FLAT_ILP], q[FLAT_ILP];
#pragma unroll
  for (int k = 0; k < FLAT_ILP; ++k) {
    const int i = base + k * kThreads1d;
    p[k] = __ldcg(parent + min(i, n - 1));
    if (i >= n) p[k] = -1;
  }
#pragma unroll
  for (int k = 0; k < FLAT_ILP; ++k) q[k] = __ldcg(parent + max(p[k], 0));
#pragma unroll
  for (int k = 0; k < FLAT_ILP; ++k) {
    if (p[k] < 0) continue;
    int x = p[k], y = q[k];
    while (y != x) {
      x = y;
      y = __ldcg(parent + x);
    }
    if (x != p[k]) __stcg(parent + base + k * kThreads1d, x);
  }
}
#define FLAT_SPAN (kThreads1d * FLAT_ILP)
#else
#define FLAT_SPAN kThreads1d
__global__ void flatten(int32_t* parent, int n) {"""


def k2a_source() -> str:
    """ccl_kernel.cu with the tiles a CTA (-DTILE_WARPS), the threads a CTA
    of the seam pass (-DSEAM_THREADS) and the pixels a thread of flatten
    (-DFLAT_ILP) overridable, seams and flatten as one cooperative launch
    (-DFUSED), and stamps at the phases of the tile pass."""
    launch = ("flatten<<<(n + kThreads1d - 1) / kThreads1d, kThreads1d, 0, "
              "stream>>>(")
    source = read_source("ccl_kernel.cu")
    if source.count(launch) != 2:
        raise SystemExit(f"the source no longer holds twice: {launch!r}")
    source = source.replace(
        launch, "flatten<<<(n + FLAT_SPAN - 1) / FLAT_SPAN, kThreads1d, 0, "
                "stream>>>(")
    return patched(source, [
        ("\n__global__ void flatten(int32_t* parent, int n) {", FLAT_ILP),
        ("  if (i < n) flatten_pixel(parent, i);\n}\n",
         "  if (i < n) flatten_pixel(parent, i);\n}\n#endif\n"),
        ("constexpr int kSeamJobs",
         "#ifndef SEAM_THREADS\n#define SEAM_THREADS kThreads1d\n#endif\n"
         "constexpr int kSeamJobs"),
        ("  const int job = blockIdx.x * kThreads1d + threadIdx.x;\n"
         "  if (job < jobs) unite_seam",
         "  const int job = blockIdx.x * SEAM_THREADS + threadIdx.x;\n"
         "  if (job < jobs) unite_seam"),
        ("unite_seams<<<(jobs + kThreads1d - 1) / kThreads1d, kThreads1d, 0,",
         "unite_seams<<<(jobs + SEAM_THREADS - 1) / SEAM_THREADS, "
         "SEAM_THREADS, 0,"),
        ("namespace {\n", PROF),
        overridable("kTileWarps", "4", "TILE_WARPS"),
        ("  // a lane a column: all mask bytes are asked for",
         "  STAMP(0, lane)\n"
         "  // a lane a column: all mask bytes are asked for"),
        ("  // a lane a row. The pixels that unite",
         "  STAMP(1, cur)\n  // a lane a row. The pixels that unite"),
        ("  __syncwarp();\n  for (int j = lane; j < n_jobs; j += 32)",
         "  __syncwarp();\n  STAMP(2, slot)\n"
         "  for (int j = lane; j < n_jobs; j += 32)"),
        ("  // every parent becomes its root by pointer jumping",
         "  STAMP(3, par[lane])\n"
         "  // every parent becomes its root by pointer jumping"),
        ("  // the flat index of every pixel's tile-local root goes",
         "  STAMP(4, par[lane])\n"
         "  // the flat index of every pixel's tile-local root goes"),
        ("  if (!x_in) return;\n", "  STAMP(5, label[0])\n"
         "  if (!x_in) return;\n"),
        ("\n// K2a's passes.\n", FUSED),
        ("  const int jobs = tiles * kSeamJobs;\n",
         "  const int jobs = tiles * kSeamJobs;\n#ifdef FUSED\n"
         "  return static_cast<int>(launch_seams_flatten(\n"
         "      fg, out, h, w, conn8, tiles_x, jobs, stream));\n#endif\n"),
    ]) + SET_PROF


def k5_source() -> str:
    """label_stats.cu with the threads a CTA (-DTHREADS), the labels a
    thread loads a step (-DVEC), the hash table's slots (-DSLOTS) and its
    tries a run head (-DPROBES; 0: no table, every head is sorted)
    overridable, and stamps at its phases."""
    return patched(read_source("label_stats.cu"), [
        ("namespace {\n", PROF),
        overridable("kThreads", "512", "THREADS"),
        overridable("kVec", "4", "VEC"),
        overridable("kSlots", "1024", "SLOTS"),
        overridable("kProbes", "4", "PROBES"),
        ("  if (threadIdx.x == 0) st.n_buf = st.n_list = 0;",
         "  STAMP(0, s)\n  if (threadIdx.x == 0) st.n_buf = st.n_list = 0;"),
        ("  flush(buf, list, table, &st, cap);\n\n  const int nl",
         "  STAMP(1, st.n_buf)\n  flush(buf, list, table, &st, cap);\n"
         "  STAMP(4, st.n_list)\n\n"
         "  const int nl"),
        ("  sort_keys(buf, m);\n",
         "  STAMP(2, m)\n  sort_keys(buf, m);\n  STAMP(3, buf[0])\n"),
        ("  if (threadIdx.x == 0) {\n    used[s] = u;",
         "  STAMP(5, u)\n  if (threadIdx.x == 0) {\n    used[s] = u;"),
    ]) + SET_PROF


def k1_source() -> str:
    """fast_kernel.cu with the warps a block (-DWARPS) and the pixel count
    below which it takes 16-row regions (-DSMALL_PIXELS) overridable."""
    with open(os.path.join(ROOT, "compv_tpu_torch/csrc/fast_kernel.cu")) as f:
        src = f.read()
    return patched(src, [
        ("constexpr int kWarps = 8;",
         "#ifndef WARPS\n#define WARPS 8\n#endif\nconstexpr int kWarps = WARPS;"),
        ("constexpr int kSmallPixels = 400000;",
         "#ifndef SMALL_PIXELS\n#define SMALL_PIXELS 400000\n#endif\n"
         "constexpr int kSmallPixels = SMALL_PIXELS;"),
    ])


def build_all(stem: str, source: str, variants: dict) -> dict:
    """One nvcc per variant, all started together; {name: (library, ptxas
    register lines)}."""
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{stem}.cu")
    with open(path, "w") as f:
        f.write(source)
    from compv_tpu_torch.ops.kernels import _build

    nvcc = _build.find_nvcc()
    procs = {}
    for name, flags in variants.items():
        lib = os.path.join(OUT, f"{stem}_{name}.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *flags.split(), "-o", lib, path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {stem} {name}:\n{log[-3000:]}")
        built[name] = (ctypes.CDLL(lib), [
            ln.replace("ptxas info    :", "").strip()
            for ln in log.splitlines()
            if "registers" in ln or "spill" in ln])
    return built


def k4_variants(dev, scene: np.ndarray, card: str) -> None:
    from compv_tpu_torch.features.canny import CannyConfig, canny
    from compv_tpu_torch.ops.kernels import hough_kernel as hk

    args = cs.sht_args(canny(torch.from_numpy(scene).to(dev), CannyConfig()),
                       1.0, 1.0)
    # the same list with its edges in shuffled order (still a prefix):
    # neighbouring slots no longer vote for neighbouring bins
    gen = torch.Generator(device="cpu").manual_seed(1)
    perm = torch.randperm(65536, generator=gen).to(dev)
    order = torch.cat([perm[args[2][perm] != 0], perm[args[2][perm] == 0]])
    shuffled = tuple(t[order].contiguous() for t in args[:3]) + args[3:]
    variants = {"shipped": "", "T8_S8": "-DFORCE_T=8 -DFORCE_S=8",
                "T4_S4": "-DFORCE_T=4 -DFORCE_S=4",
                "T8_S4": "-DFORCE_T=8 -DFORCE_S=4",
                "T12_S8": "-DFORCE_T=12 -DFORCE_S=8",
                "T3_S2": "-DFORCE_T=3 -DFORCE_S=2",
                "global_atomics": "-DGLOBAL_ATOMICS",
                "global_atomics_T8_S8": "-DGLOBAL_ATOMICS -DFORCE_T=8 "
                                        "-DFORCE_S=8"}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    inv = float(np.float32(1) / np.float32(args[5]))
    stream = torch.cuda.current_stream().cuda_stream
    for name, (lib, regs) in build_all("hough_kernel", k4_source(),
                                       variants).items():
        lib.compv_sht_accumulate.argtypes = [p, p, p, p, p, p, i, i, i, f, f,
                                             p, p]
        lib.compv_sht_plan.argtypes = [i, i, ctypes.POINTER(i)]
        for label, a in (("scene_720p", args), ("scene_720p_shuffled",
                                                shuffled)):
            x, y, w, n_theta, rho_max, _, cos_t, sin_t = a
            want = hk.sht_accumulate_ref(*a)
            n_rho = want.shape[1]
            ts = (i * 3)()
            cs.check(lib.compv_sht_plan(n_theta, n_rho, ts) == 0, "plan")
            ctas = -(-n_theta // ts[0]) * ts[1]
            acc = torch.empty_like(want)
            prof = torch.zeros((ctas, 8), dtype=torch.int64, device=dev)

            def run(stamps=None):
                if "global_atomics" in name:
                    acc.zero_()           # the second device operation
                cs.check(lib.compv_sht_accumulate(
                    x.data_ptr(), y.data_ptr(), w.data_ptr(),
                    cos_t.data_ptr(), sin_t.data_ptr(), acc.data_ptr(),
                    x.numel(), n_theta, n_rho, float(np.float32(rho_max)),
                    inv, stream, stamps) == 0, f"launch of {name}")

            run()
            torch.cuda.synchronize()
            cs.check(torch.equal(acc, want), f"K4 {name} != twin on {label}")
            us = cs.device_ms(run) * 1e3
            run(prof.data_ptr())
            torch.cuda.synchronize()
            cyc = np.diff(prof.cpu().numpy()[:, :7], axis=1).mean(0)
            phases = dict(zip(("zero", "load", "vote", "barrier_1", "reduce",
                               "barrier_2"), (float(c) for c in cyc)))
            if "global_atomics" in name:      # it returns after the vote
                phases = {k: phases[k] for k in ("zero", "load", "vote")}
            emit({"kernel": "K4", "variant": name, "input": label,
                     "card": card, "thetas_per_cta": ts[0],
                     "ctas_per_cluster": ts[1], "ctas": ctas,
                     "device_us": us, "device_ops_per_call":
                         2 if "global_atomics" in name else 1,
                     "mean_cycles_per_cta": phases, "ptxas": regs})


def phase_cycles(lib, run, ctas: int, names, dev) -> dict:
    """Cycles a CTA between the stamps of one call of ``run``: the mean over
    the CTAs and, under "<phase>_of_slowest", those of the CTA that took
    longest from its first stamp to its last."""
    prof = torch.zeros((ctas, 8), dtype=torch.int64, device=dev)
    lib.compv_set_prof.argtypes = [ctypes.c_void_p]
    cs.check(lib.compv_set_prof(prof.data_ptr()) == 0, "set_prof")
    run()
    torch.cuda.synchronize()
    cs.check(lib.compv_set_prof(None) == 0, "set_prof")
    stamps = prof.cpu().numpy()[:, :len(names) + 1]
    stamps = stamps[(stamps > 0).all(1)]
    spans = np.diff(stamps, axis=1)
    out = dict(zip(names, (float(c) for c in spans.mean(0))))
    if len(spans):
        slowest = spans[spans.sum(1).argmax()]
        out.update({f"{n}_of_slowest": float(c)
                    for n, c in zip(names, slowest)})
        out["ctas_stamped"] = len(spans)
    return out


def k2a_variants(dev, text: np.ndarray, card: str) -> None:
    rs = np.random.default_rng(2)
    images = {"text": (text < 128).astype(np.uint8) * 255,
              "small_64x80": (rs.random((64, 80)) < 0.5).astype(np.uint8),
              "dense_1285": (rs.random((1285, 1285)) < 0.5).astype(np.uint8),
              "full_1122x1182": np.ones((1182, 1122), np.uint8)}
    variants = {"shipped": "", "fused": "-DFUSED",
                "tile_warps_1": "-DTILE_WARPS=1",
                "tile_warps_2": "-DTILE_WARPS=2",
                "tile_warps_5": "-DTILE_WARPS=5",
                "flat_ilp_2": "-DFLAT_ILP=2", "flat_ilp_4": "-DFLAT_ILP=4",
                "flat_ilp_8": "-DFLAT_ILP=8",
                "seam_threads_64": "-DSEAM_THREADS=64",
                "seam_threads_128": "-DSEAM_THREADS=128"}
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name, (lib, regs) in build_all("ccl_kernel", k2a_source(),
                                       variants).items():
        lib.compv_ccl_label.argtypes = [p, p, i, i, i, p]
        times, phases = {}, {}
        for label, im in images.items():
            h, w = im.shape
            fg = torch.from_numpy(im).to(dev)
            for conn in (8, 4):
                out = torch.empty((h, w), dtype=torch.int32, device=dev)

                def run():
                    cs.check(lib.compv_ccl_label(
                        fg.data_ptr(), out.data_ptr(), h, w, conn, stream)
                        == 0, f"launch of {name}")

                run()
                torch.cuda.synchronize()
                cs.check(np.array_equal(out.cpu().numpy(),
                                        cs.oracle_labels(im, conn)),
                         f"K2a {name} != scipy on {label}, {conn}-connected")
                if conn == 4 and label != "text":
                    continue
                key = f"{label}_{conn}"
                events = cs.device_events(run, 10)[0]
                times[key] = {"device_us": sum(us for _, us in events) / 10}
                for kernel, us in events:
                    short = kernel.split("::")[-1].split("(")[0]
                    times[key][short] = times[key].get(short, 0.0) + us / 10
                phases[key] = phase_cycles(
                    lib, run, -(-h // 32) * -(-w // 32),
                    ("load_ballot", "list_unions", "unions", "roots", "labels"),
                    dev)
        emit({"kernel": "K2a", "variant": name, "card": card,
                 "times": times, "tile_pass_mean_cycles_per_cta": phases,
                 "ptxas": regs})


def k5_variants(dev, text: np.ndarray, card: str) -> None:
    from compv_tpu_torch.ops.kernels import ccl_kernel as ck
    from compv_tpu_torch.ops.kernels import label_stats as ls

    labels = ck.ccl_label(torch.from_numpy(
        (text < 128).astype(np.uint8) * 255).to(dev), 8)
    rs = np.random.default_rng(3)
    maps = {"text_rounds_256": (labels, 256),
            "text_rounds_640": (labels, 640),
            "dense_random_300x1122": (ck.ccl_label(torch.from_numpy(
                (rs.random((300, 1122)) < 0.45).astype(np.uint8)).to(dev)),
                256),
            "per_pixel_64x1122": (torch.arange(
                64 * 1122, dtype=torch.int32, device=dev).reshape(64, 1122),
                256)}
    variants = {"shipped": "", "threads_256": "-DTHREADS=256",
                "threads_1024": "-DTHREADS=1024", "vec_2": "-DVEC=2",
                "vec_8": "-DVEC=8",
                "threads_1024_vec_2": "-DTHREADS=1024 -DVEC=2",
                "no_hash_table": "-DPROBES=0", "slots_256": "-DSLOTS=256",
                "slots_4096": "-DSLOTS=4096", "probes_1": "-DPROBES=1",
                "probes_16": "-DPROBES=16"}
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name, (lib, regs) in build_all("label_stats", k5_source(),
                                       variants).items():
        lib.compv_strip_label_counts.argtypes = [p, i, i, i, i, i, i, i, p, p,
                                                 p, p]
        lib.compv_strip_step.restype = i
        lib.compv_strip_slots.restype = i
        times, phases = {}, {}
        for label, (lbl, rounds) in maps.items():
            h, w = lbl.shape
            n_strips = -(-h // 8)
            cap, buf_keys, _ = ls.kernel_plan(rounds, 8, w,
                                              lib.compv_strip_step(),
                                              lib.compv_strip_slots())
            want = ls.strip_label_counts_ref(lbl, rounds, 8)
            got = tuple(torch.empty_like(t) for t in want)

            def run():
                cs.check(lib.compv_strip_label_counts(
                    lbl.data_ptr(), h, w, 8, n_strips, rounds, cap, buf_keys,
                    *(t.data_ptr() for t in got), stream) == 0,
                    f"launch of {name}")

            run()
            torch.cuda.synchronize()
            cs.check(all(torch.equal(g, w_) for g, w_ in zip(got, want)),
                     f"K5 {name} != twin on {label}")
            times[label] = cs.device_ms(run) * 1e3
            if label.startswith("text"):      # one flush a strip
                phases[label] = phase_cycles(
                    lib, run, n_strips, ("read_runs", "append_list_pad",
                                         "sort", "combine", "records"), dev)
        emit({"kernel": "K5", "variant": name, "card": card,
                 "device_us": times, "mean_cycles_per_cta": phases,
                 "ptxas": regs})


def k1_variants(dev, scene: np.ndarray, card: str) -> None:
    from compv_tpu_torch.image.pyramid import pyramid_sizes
    from compv_tpu_torch.image.scale import scale_bilinear
    from compv_tpu_torch.ops.kernels import fast_kernel as fk

    img = torch.from_numpy(scene).to(dev)
    rs = np.random.default_rng(1)
    images = {"noise_720p": torch.from_numpy(
        rs.integers(0, 256, (720, 1282), dtype=np.uint8)).to(dev)}
    for lv, (lh, lw) in enumerate(pyramid_sizes(720, 1282, 8, 0.83)):
        images[f"level_{lv}"] = img if lv == 0 else scale_bilinear(img, lh, lw)
    variants = {"shipped": "", "rows_32_always": "-DSMALL_PIXELS=0",
                "rows_16_always": "-DSMALL_PIXELS=2000000000",
                "warps_4": "-DWARPS=4", "warps_16": "-DWARPS=16"}
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name, (lib, regs) in build_all("fast_kernel", k1_source(),
                                       variants).items():
        lib.compv_fast_strengths_and_nms.argtypes = [p, p, p, i, i, i, i, p]
        times = {}
        for label, im in images.items():
            h, w = im.shape
            raw = torch.empty((h, w), dtype=torch.float32, device=dev)
            sup = torch.empty_like(raw)

            def run():
                cs.check(lib.compv_fast_strengths_and_nms(
                    im.data_ptr(), raw.data_ptr(), sup.data_ptr(), h, w, 20,
                    9, stream) == 0, f"launch of {name}")

            run()
            torch.cuda.synchronize()
            want = fk._strengths_ref(im, 20, 9)
            cs.check(torch.equal(raw, want)
                     and torch.equal(sup, fk._nms_ref(want)),
                     f"K1 {name} != twin on {label}")
            times[label] = cs.device_ms(run) * 1e3
        emit({"kernel": "K1", "variant": name, "card": card,
                 "device_us": times,
                 "device_us_8_levels": sum(v for k, v in times.items()
                                           if k.startswith("level_")),
                 "ptxas": regs})


def main() -> int:
    from compv_tpu_torch.device import require_cuda

    global LOG
    if "--log" in sys.argv[1:-1]:
        LOG = sys.argv[sys.argv.index("--log") + 1]
    dev = require_cuda()
    card = cs.card_line()
    scene, text = cs.scenes()
    which = [a for a in sys.argv[1:] if a in ("K1", "K2a", "K4", "K5")] or [
        "K4", "K1", "K2a", "K5"]
    if "K4" in which:
        k4_variants(dev, scene, card)
    if "K1" in which:
        k1_variants(dev, scene, card)
    if "K2a" in which:
        k2a_variants(dev, text, card)
    if "K5" in which:
        k5_variants(dev, text, card)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    emit(clocks.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

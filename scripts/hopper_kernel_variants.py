"""Build-time variants of the FAST kernel (K1) and the SHT accumulator (K4)
timed against the shipped ones on one NVIDIA GPU, and K4's phases.

The design choices of csrc/fast_kernel.cu and csrc/hough_kernel.cu that
were settled by measurement (K1: warps a block and strength rows a block;
K4: thetas a CTA and CTAs a cluster, the cluster reduction against global
atomics onto a zeroed accumulator) are re-measured here: the script patches
a copy of the source (it fails if the text it replaces is gone), builds
each variant with nvcc into build/variants/, checks it against the twin,
and prints one JSON line per variant with its device time (torch.profiler,
as chip_smoke.py's device_ms). K4's copy also stamps clock64 at its phase
boundaries, so each line carries the mean cycles a CTA spends zeroing,
loading, voting, waiting at the first cluster barrier, reducing and waiting
at the second. From the repository root, on a machine with one GPU and nvcc:

    python3 scripts/hopper_kernel_variants.py
"""
from __future__ import annotations

import ctypes
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
    'gridDim.y + blockIdx.y) * 8 + (i)] = clock64(); }\n')


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
        ("float inv_step, int n_t, int vec_ok) {",
         "float inv_step, int n_t, int vec_ok, long long* prof) {\n" + STAMP
         + "  STAMP(0)"),
        ("  }\n  __syncthreads();\n\n  // group q",
         "  }\n  __syncthreads();\n  STAMP(1)\n\n  // group q"),
        ("    bool live[kPass];",
         "    if (q0 < stride) STAMP(2)\n    bool live[kPass];"),
        ("  cluster.sync();\n  const int per",
         "  __syncthreads();\n  STAMP(3)\n"
         "#ifdef GLOBAL_ATOMICS\n"
         "  {\n"
         "    int32_t* sum = acc + static_cast<size_t>(t0) * n_rho;\n"
         "    for (int b = tid; b < bins; b += kThreads)\n"
         "      if (hist[b] != 0) atomicAdd(sum + b, hist[b]);\n"
         "    return;\n"
         "  }\n"
         "#endif\n"
         "  cluster.sync();\n  STAMP(4)\n  const int per"),
        ("  cluster.sync();   // no CTA",
         "  __syncthreads();\n  STAMP(5)\n  cluster.sync();\n  STAMP(6)\n"
         "  // no CTA"),
        ("  key[0] = device, key[1] = n_theta, key[2] = n_rho;",
         "#ifdef FORCE_T\n"
         "  t = FORCE_T, s = FORCE_S;\n"
         "  cudaFuncSetAttribute(sht_accumulate,\n"
         "      cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
         "      static_cast<int>(t * row));\n"
         "#endif\n"
         "  key[0] = device, key[1] = n_theta, key[2] = n_rho;"),
        ("                         float inv_step, cudaStream_t stream) {",
         "                         float inv_step, cudaStream_t stream,\n"
         "                         long long* prof) {"),
        ("n_t,\n                           vec_ok);",
         "n_t,\n                           vec_ok, prof);"),
    ])


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
            ts = (i * 2)()
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
            cs.emit({"kernel": "K4", "variant": name, "input": label,
                     "card": card, "thetas_per_cta": ts[0],
                     "ctas_per_cluster": ts[1], "ctas": ctas,
                     "device_us": us, "device_ops_per_call":
                         2 if "global_atomics" in name else 1,
                     "mean_cycles_per_cta": phases, "ptxas": regs})


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
        cs.emit({"kernel": "K1", "variant": name, "card": card,
                 "device_us": times,
                 "device_us_8_levels": sum(v for k, v in times.items()
                                           if k.startswith("level_")),
                 "ptxas": regs})


def main() -> int:
    from compv_tpu_torch.device import require_cuda

    dev = require_cuda()
    card = cs.card_line()
    scene, _ = cs.scenes()
    k4_variants(dev, scene, card)
    k1_variants(dev, scene, card)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    cs.emit(clocks.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

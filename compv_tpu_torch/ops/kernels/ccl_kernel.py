"""Connected-component labeling: the Hopper kernel (``csrc/ccl_kernel.cu``)
that replaces ``compv_tpu/ops/pallas/ccl_kernel.py:pallas_label`` (K2a) and
``pallas_label_seeded`` (K2b), and its plain PyTorch twin.

Contract of both: a (H, W) foreground mask and an i32 ``init`` map give a
(H, W) i32 map holding, at each foreground pixel, the minimum of ``init``
over the pixel's 4- or 8-connected component, and -1 at background. K2a is
the case ``init = row * W + col``: each component is labelled by its
minimum flat index.

Precondition of K2b, the JAX function's own: at each foreground pixel p,
``init[p]`` is p's flat index or the converged label p had at an earlier
level of a nested ladder (MSER's use), i.e. the minimum flat index of a
foreground subset of p's component that contains p. Then ``init[p] <= p``,
``init[init[p]] == init[p]``, and the minimum of ``init`` over a component
is the component's minimum flat index: the seeded answer equals the
unseeded one on the same mask, and the seed only says how much of the work
is already done. The twin's pointer jumping reads labels as pixel addresses
and relies on this; the kernel takes the seed as its starting forest (a
warm-started union-find) and relies on it too. For memory safety the
kernel replaces a seed outside ``[0, p]`` or on a background pixel by p; a
seed that names a pixel of another component gives an undefined labeling in
the kernel, the twin and the TPU kernel alike.

The twin is the XLA solver the JAX package runs off the TPU
(``compv_tpu/features/ccl.py:79-164``) op for op: segmented run-min sweeps
(``_SWEEP_CAP`` of them), then gather-based pointer jumping when the sweeps
have not converged. Both reach the unique fixed point above, so kernel and
twin agree exactly; the twin raises where the pointer stage does not
converge within ``max_iterations`` rounds instead of returning a partial
labeling. The kernel is a union-find and always converges; it ignores
``max_iterations``. K2a makes every union between two pixels of one 32 x 32
tile in shared memory (a warp a tile, a lane a row of foreground bits) and
only the unions of the tiles' seam pixels in global memory, then points
every pixel at its root; K2b starts from its seed over the whole map.

Dispatch has no fallback: a CUDA tensor goes to the kernel (built at first
use) or the call raises; a CPU tensor goes to the twin. K2a's launches are
counted under ``label_tiles``, K2b's under ``merge_seeded``
(``_build.launch_counts``).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from compv_tpu_torch.ops.kernels import _build

__all__ = ["ccl_label", "ccl_label_seeded", "label_ref"]

_SWEEP_CAP = 12      # run-min sweep iterations of the twin's first stage
_SENT = 1 << 30      # scan sentinel above every offset-inflated key

_lib = _build.Library("ccl_kernel")
_p, _i = ctypes.c_void_p, ctypes.c_int
_label = _lib.entry("compv_ccl_label", [_p, _p, _i, _i, _i, _p],
                    counts="label_tiles")
_label_seeded = _lib.entry("compv_ccl_label_seeded",
                           [_p, _p, _p, _i, _i, _i, _p],
                           counts="merge_seeded")


# --------------------------------------------------------------- the twin

def _shift(x: torch.Tensor, axis: int, step: int, fill) -> torch.Tensor:
    """x moved by ``step`` (+1: toward higher indices) along ``axis``,
    ``fill`` entering at the edge."""
    pad = [0, 0, 0, 0]
    pad[2 * (1 - axis) + (0 if step > 0 else 1)] = abs(step)
    out = F.pad(x, pad, value=fill)
    return out.narrow(axis, 0 if step > 0 else abs(step), x.shape[axis])


def _run_min(lbl, fg, axis, big):
    """Min over each maximal foreground run along ``axis``: cummin with
    direction-matched monotone per-run offsets so background blocks
    propagation. Requires n * (axis_len / 2 + 2) < 2^30."""
    m = lbl.shape[0] * lbl.shape[1]
    start = fg & ~_shift(fg, axis, 1, False)
    b = torch.cumsum(start, dim=axis, dtype=torch.int32)
    rmax = fg.shape[axis] // 2 + 2
    offs_f = (rmax - b) * m
    offs_b = b * m
    a1 = torch.cummin(torch.where(fg, lbl + offs_f, _SENT),
                      dim=axis).values - offs_f
    a2 = torch.cummin(torch.where(fg, lbl + offs_b, _SENT).flip(axis),
                      dim=axis).values.flip(axis) - offs_b
    return torch.where(fg, torch.minimum(a1, a2), big)


def _window(padded: torch.Tensor, dy: int, dx: int, h: int, w: int):
    return padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _diag_min(lbl, fg, big):
    h, w = lbl.shape
    p = F.pad(lbl, (1, 1, 1, 1), value=_SENT)
    mm = lbl
    for dy, dx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
        mm = torch.minimum(mm, _window(p, dy, dx, h, w))
    return torch.where(fg, mm, big)


def _sweep_stage(lbl, fg, connectivity, big, cap):
    """Returns (labels, converged)."""
    changed, i = True, 0
    while changed and i < cap:
        new = _diag_min(lbl, fg, big) if connectivity == 8 else lbl
        new = _run_min(new, fg, 0, big)
        new = _run_min(new, fg, 1, big)
        changed = bool((new != lbl).any())
        lbl, i = new, i + 1
    return lbl, not changed


def _neighbor_min(lbl, fg, connectivity, big):
    h, w = lbl.shape
    p = F.pad(lbl, (1, 1, 1, 1), value=_SENT)
    offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 8:
        offs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    m = lbl
    for dy, dx in offs:
        m = torch.minimum(m, _window(p, dy, dx, h, w))
    return torch.where(fg, m, big)


def _pointer_step(lbl, fg, connectivity, big):
    h, w = lbl.shape
    new = _neighbor_min(lbl, fg, connectivity, big)
    flat = new.reshape(-1)
    jumped = torch.where(flat < big, flat[flat.clamp(max=big - 1)], big)
    jumped = torch.where(jumped < big, flat[jumped.clamp(max=big - 1)], jumped)
    new = torch.minimum(new, jumped.reshape(h, w))
    return torch.where(fg, new, big)


def _pointer_stage(lbl, fg, connectivity, big, max_iterations):
    for _ in range(max_iterations):
        new = _pointer_step(lbl, fg, connectivity, big)
        if not bool((new != lbl).any()):
            return new
        lbl = new
    # the last allowed round may have been the one that converged
    if bool((_pointer_step(lbl, fg, connectivity, big) != lbl).any()):
        raise RuntimeError(f"CCL pointer jumping did not converge within "
                           f"{max_iterations} rounds; raise max_iterations")
    return lbl


def label_ref(fg: torch.Tensor, init: torch.Tensor, connectivity: int = 8,
              max_iterations: int = 64) -> torch.Tensor:
    """The twin: (H, W) bool foreground + (H, W) i32 init -> (H, W) i32
    minimum of init over each component, -1 at background."""
    h, w = fg.shape
    big = h * w
    lbl = torch.where(fg, init, big)
    # the run-min offset trick needs n * (axis/2 + 2) in i32
    converged = False
    if h * w * (max(h, w) // 2 + 2) < 2 ** 30:
        lbl, converged = _sweep_stage(lbl, fg, connectivity, big, _SWEEP_CAP)
    if not converged:
        lbl = _pointer_stage(lbl, fg, connectivity, big, max_iterations)
    return torch.where(fg, lbl, -1)


def _flat_index(h: int, w: int, device) -> torch.Tensor:
    return torch.arange(h * w, dtype=torch.int32, device=device).reshape(h, w)


# ------------------------------------------------------------- the wrappers

def _foreground(binary: torch.Tensor) -> torch.Tensor:
    """(H, W) mask the kernel reads as bytes (non-zero = foreground): the
    input itself when it is u8 or bool, else ``binary > 0`` (uint16 and
    uint32 compared in int64: PyTorch has no ``>`` for them)."""
    if not isinstance(binary, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(binary).__name__}")
    if binary.ndim != 2:
        raise ValueError(f"expected a 2-D image, got {binary.ndim}-D")
    if binary.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {binary.device}")
    h, w = binary.shape
    if h * w >= _SENT:
        raise ValueError("image too large for i32 flat labels")
    if binary.dtype in (torch.uint8, torch.bool):
        return binary.contiguous()
    if binary.dtype in (torch.uint16, torch.uint32):
        binary = binary.to(torch.int64)
    return (binary > 0).contiguous()


def _connectivity(connectivity: int) -> int:
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    return connectivity


def ccl_label(binary: torch.Tensor, connectivity: int = 8,
              max_iter: int = 96, jump_every: int = 3, jump_dists: tuple = (),
              *, max_iterations: int = 64) -> torch.Tensor:
    """K2a: (H, W) mask (foreground where non-zero) -> (H, W) i32 labels,
    the minimum flat index of each component, -1 at background.
    ``max_iter``, ``jump_every`` and ``jump_dists`` (the Pallas labeler's
    iteration cap and pointer-jump schedule) are accepted and ignored: K2a
    runs until its union-find converges. ``max_iterations`` caps the CPU
    twin's pointer stage, which raises past it."""
    fg = _foreground(binary)
    _connectivity(connectivity)
    h, w = fg.shape
    if fg.device.type == "cpu":
        return label_ref(fg != 0, _flat_index(h, w, fg.device), connectivity,
                         max_iterations)
    out = torch.empty((h, w), dtype=torch.int32, device=fg.device)
    if h * w == 0:
        return out
    _label.launch(fg.device, fg.data_ptr(), out.data_ptr(), h, w,
                  connectivity)
    return out


def ccl_label_seeded(binary: torch.Tensor, init: torch.Tensor,
                     connectivity: int = 8, max_iter: int = 96,
                     jump_every: int = 3, jump_dists: tuple = (), *,
                     max_iterations: int = 64) -> torch.Tensor:
    """K2b: (H, W) mask + (H, W) i32 init (own flat index, or the label of
    an earlier nested level, at each foreground pixel) -> (H, W) i32 minimum
    of init over each component, -1 at background. The Pallas labeler's
    ``max_iter``, ``jump_every`` and ``jump_dists`` are accepted and
    ignored, ``max_iterations`` as in ``ccl_label``."""
    fg = _foreground(binary)
    _connectivity(connectivity)
    h, w = fg.shape
    if (not isinstance(init, torch.Tensor) or init.dtype != torch.int32
            or tuple(init.shape) != (h, w) or init.device != fg.device):
        raise ValueError(f"init must be an i32 tensor of shape {(h, w)} on "
                         f"{fg.device}")
    init = init.contiguous()
    if fg.device.type == "cpu":
        return label_ref(fg != 0, init, connectivity, max_iterations)
    out = torch.empty((h, w), dtype=torch.int32, device=fg.device)
    if h * w == 0:
        return out
    _label_seeded.launch(fg.device, fg.data_ptr(), init.data_ptr(),
                         out.data_ptr(), h, w, connectivity)
    return out

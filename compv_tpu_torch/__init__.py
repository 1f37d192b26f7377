"""compv_tpu_torch — the PyTorch / CUDA port of compv_tpu for NVIDIA Hopper.

Each module mirrors its counterpart in ``compv_tpu`` (same module layout,
public names, frozen config dataclasses and fixed-capacity NamedTuple
results with ``valid`` masks), so a test can feed one numpy input to both
packages and compare the results field by field. ``compv_tpu`` stays the
reference; this package imports neither it nor JAX.

Functions run on the device of their input tensors. Plain tensor code is
PyTorch; each Pallas kernel of ``compv_tpu`` on a ported path becomes a
kernel written by hand for ``sm_90a`` (``csrc/``), built at first use and
called through a wrapper that launches it for CUDA tensors and runs its
plain PyTorch twin for CPU tensors.

TF32 is switched off for float32 matmuls and cuDNN here: the homography's
f32 products (DLT normal equations, 4-point solves, transfer errors) are
not exact in TF32.

``import compv_tpu_torch`` imports the subpackages (``image``, ``features``,
``matchers``, ``calib``, ``math``, ``ml``, ``io``, ``viz``, ``slam``,
``parallel``) and the registry's factories, as ``compv_tpu`` does; it
starts no process group (``parallel.init_distributed`` does).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from compv_tpu_torch.core.types import (  # noqa: E402,F401
    Keypoints, Lines, Matches)
from compv_tpu_torch.device import require_cuda  # noqa: E402,F401
from compv_tpu_torch import image  # noqa: E402,F401
from compv_tpu_torch import features  # noqa: E402,F401
from compv_tpu_torch import matchers  # noqa: E402,F401
from compv_tpu_torch import calib  # noqa: E402,F401
from compv_tpu_torch import math  # noqa: E402,F401
from compv_tpu_torch import ml  # noqa: E402,F401
from compv_tpu_torch import io  # noqa: E402,F401
from compv_tpu_torch import viz  # noqa: E402,F401
from compv_tpu_torch import slam  # noqa: E402,F401
from compv_tpu_torch import parallel  # noqa: E402,F401
from compv_tpu_torch.registry import (  # noqa: E402,F401
    create_detector, create_edge_detector, create_matcher, list_algorithms,
)


def init(num_threads: int | None = None) -> None:
    """Framework bring-up, analogous to CompVInit()
    (api/include/compv/compv_api.h:126-146). Nothing on the card needs
    eager set-up (kernels are built at first use); ``num_threads``, when
    given, sets PyTorch's host threads for CPU tensor work
    (``torch.set_num_threads``), the reference's thread-dispatcher size."""
    if num_threads is not None:
        torch.set_num_threads(num_threads)


def deinit() -> None:
    """Analogous to CompVDeInit() (api/include/compv/compv_api.h:136-146)."""
    return None

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
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from compv_tpu_torch.core.types import Keypoints, Matches  # noqa: E402,F401
from compv_tpu_torch.device import require_cuda  # noqa: E402,F401

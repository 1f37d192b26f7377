"""Core result containers (mirror of compv_tpu.core)."""
from compv_tpu_torch.core.types import Keypoints, Lines, Matches  # noqa: F401

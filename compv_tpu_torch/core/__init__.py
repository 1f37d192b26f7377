"""Core result containers (mirror of compv_tpu.core)."""
from compv_tpu_torch.core.types import Keypoints, Matches  # noqa: F401

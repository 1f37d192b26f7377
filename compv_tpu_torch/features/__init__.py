"""Feature detection and description (mirror of compv_tpu.features)."""
from compv_tpu_torch.features.fast import (  # noqa: F401
    CIRCLE_OFFSETS, FastConfig, fast_detect, fast_nms, fast_strengths,
)
from compv_tpu_torch.features.orb import (  # noqa: F401
    OrbConfig, OrbResult, brief_describe, brief_pattern, orb_detect_describe,
    patch_orientation,
)

"""SLAM frontend (mirror of compv_tpu.slam)."""
from compv_tpu_torch.slam.frontend import (  # noqa: F401
    FrontendConfig, PairResult, detect_describe, match_pair,
)

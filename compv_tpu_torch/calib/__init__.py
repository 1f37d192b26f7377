"""Geometric estimation (mirror of compv_tpu.calib)."""
from compv_tpu_torch.calib.homography import (  # noqa: F401
    HomographyConfig, HomographyResult, compute_homography_dlt,
    find_homography, symmetric_transfer_error,
)

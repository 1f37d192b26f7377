"""Geometric estimation (mirror of compv_tpu.calib)."""
from compv_tpu_torch.calib.checkerboard import (  # noqa: F401
    CheckerboardConfig, CheckerboardResult, find_chessboard_corners,
    line_intersections,
)
from compv_tpu_torch.calib.homography import (  # noqa: F401
    HomographyConfig, HomographyResult, compute_homography_dlt,
    find_homography, symmetric_transfer_error,
)
from compv_tpu_torch.calib.epipolar import (  # noqa: F401
    EssentialConfig, EssentialResult, compute_fundamental_8pt,
    decompose_essential, find_essential, sampson_error, triangulate_points,
)
from compv_tpu_torch.calib.pnp import (  # noqa: F401
    PnpConfig, PnpResult, pnp_dlt, solve_pnp,
)

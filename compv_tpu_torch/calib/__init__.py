"""Robust estimation and camera calibration (mirror of compv_tpu.calib)."""
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
from compv_tpu_torch.calib.ransac import (  # noqa: F401
    RansacConfig, RansacResult, ransac,
)
from compv_tpu_torch.calib.camera import (  # noqa: F401
    CalibrationConfig, CalibrationResult, calibrate_camera,
    checkerboard_object_points,
)
from compv_tpu_torch.calib.lm import LMConfig, LMResult, levenberg_marquardt  # noqa: F401
from compv_tpu_torch.calib.utils import (  # noqa: F401
    build_undistort_map, distort_normalized, project_points_dist,
    reproj_error_rms, undistort_image, undistort_points,
)

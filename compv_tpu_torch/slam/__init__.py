"""SLAM / SfM layer (mirror of compv_tpu.slam): the frontend pair, bundle
adjustment (CG and Schur), the pose graph, planar tracking, trajectory
evaluation and incremental SfM."""
from compv_tpu_torch.slam.frontend import (  # noqa: F401
    FrontendConfig, PairResult, detect_describe, match_pair,
)
from compv_tpu_torch.slam.ba import (  # noqa: F401
    BAConfig, BAProblem, ba_residuals, ba_solve, ba_step,
    matrix_to_rodrigues, project_points, reproj_rmse, rodrigues_to_matrix,
)
from compv_tpu_torch.slam.posegraph import (  # noqa: F401
    PoseGraph, PoseGraphConfig, compose, invert, optimize_pose_graph,
    relative_pose,
)
from compv_tpu_torch.slam.pipeline import (  # noqa: F401
    KeyframeStore, PlanarTrackerConfig, PlanarTrackResult,
    decompose_homography, track_planar_sequence,
)
from compv_tpu_torch.slam.evaluate import (  # noqa: F401
    ate_rmse, rpe_rmse, umeyama_alignment,
)
from compv_tpu_torch.slam.ba_schur import (  # noqa: F401
    SchurConfig, ba_solve_schur, ba_step_schur,
)
from compv_tpu_torch.slam.sfm import (  # noqa: F401
    SfmConfig, SfmResult, render_orbit_sequence, resume_sfm, run_sfm,
    sfm_ate,
)

"""Feature detection and description (mirror of compv_tpu.features)."""
from compv_tpu_torch.features.canny import CannyConfig, canny  # noqa: F401
from compv_tpu_torch.features.ccl import (  # noqa: F401
    CclConfig, CclResult, ccl_features, ccl_features_from_labels,
    extract_runs, label_components, label_components_seeded,
)
from compv_tpu_torch.features.fast import (  # noqa: F401
    CIRCLE_OFFSETS, FastConfig, fast_detect, fast_nms, fast_strengths,
)
from compv_tpu_torch.features.orb import (  # noqa: F401
    OrbConfig, OrbResult, brief_describe, brief_pattern, orb_detect_describe,
    patch_orientation,
)
from compv_tpu_torch.features.mser import (  # noqa: F401
    MserConfig, MserResult, mser_detect, mser_region_mask, mser_region_points,
)
from compv_tpu_torch.features.edges import (  # noqa: F401
    KERNELS, edge_detect, gradient_magnitude_direction, sobel_gradients,
)
from compv_tpu_torch.features.hough import (  # noqa: F401
    HoughKhtConfig, HoughShtConfig, hough_kht, hough_lines_to_cartesian,
    hough_sht, hough_sht_stats,
)
from compv_tpu_torch.features.hog import (  # noqa: F401
    HogConfig, gradient_fast, hog_descriptor,
)

"""Image ops on the ported path (mirror of compv_tpu.image)."""
from compv_tpu_torch.image.color import rgb_to_gray, to_gray  # noqa: F401
from compv_tpu_torch.image.histogram import histogram256  # noqa: F401
from compv_tpu_torch.image.pyramid import (  # noqa: F401
    Pyramid, build_pyramid, pyramid_sizes, scale_factors, scale_factors_sum,
)
from compv_tpu_torch.image.remap import (  # noqa: F401
    remap_bilinear, remap_nearest, warp_affine, warp_perspective,
)
from compv_tpu_torch.image.scale import (  # noqa: F401
    rotate_bilinear, rotate_fast, scale, scale_bicubic, scale_bilinear,
    scale_nearest,
)
from compv_tpu_torch.image.threshold import (  # noqa: F401
    otsu_value, threshold_global, threshold_otsu,
)

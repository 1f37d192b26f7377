"""Image pipeline (mirror of compv_tpu.image): conversion, scaling,
pyramid, threshold, integral, remap, histogram, morphology."""
from compv_tpu_torch.image.color import (  # noqa: F401
    bgr_to_gray, i420_to_rgb, i422_to_rgb, merge_channels, nv12_to_rgb,
    nv21_to_rgb, rgb565_to_rgb, rgb_to_gray, rgb_to_hsl, rgb_to_hsv,
    rgb_to_i420, rgb_to_rgb565, rgb_to_yuv444, rgba_to_gray, split_channels,
    to_gray, uyvy_to_rgb, yuv444_to_hsv, yuv_to_rgb, yuyv_to_rgb,
)
from compv_tpu_torch.image.histogram import (  # noqa: F401
    apply_lut256, equalize, histogram256, projection_x, projection_y,
)
from compv_tpu_torch.image.integral import (  # noqa: F401
    box_sum, integral, integral_squared,
)
from compv_tpu_torch.image.morph import (  # noqa: F401
    black_hat, close_, dilate, erode, morph_gradient, open_, strel, top_hat,
)
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
    otsu_value, threshold_adaptive, threshold_global, threshold_otsu,
    threshold_wolf,
)

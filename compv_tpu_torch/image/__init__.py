"""Image ops on the ported path (mirror of compv_tpu.image)."""
from compv_tpu_torch.image.color import rgb_to_gray, to_gray  # noqa: F401
from compv_tpu_torch.image.histogram import histogram256  # noqa: F401
from compv_tpu_torch.image.pyramid import (  # noqa: F401
    pyramid_sizes, scale_factors, scale_factors_sum,
)
from compv_tpu_torch.image.scale import scale, scale_bilinear  # noqa: F401
from compv_tpu_torch.image.threshold import (  # noqa: F401
    otsu_value, threshold_global, threshold_otsu,
)

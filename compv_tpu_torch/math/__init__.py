"""Dense math layer (mirror of compv_tpu.math): transforms, point-set
statistics, distances and robust curve fits."""
from compv_tpu_torch.math.transform import (  # noqa: F401
    apply_homography, homogeneous_to_cartesian_2d, perspective_2d,
    to_homogeneous,
)
from compv_tpu_torch.math.stats import (  # noqa: F401
    hartley_normalize, masked_mean, masked_variance, mse_2d,
)
from compv_tpu_torch.math.distance import (  # noqa: F401
    dist_line, dist_parabola, hamming, hamming_packed, l2, squared_l2,
)
from compv_tpu_torch.math.fit import (  # noqa: F401
    LineFit, ParabolaFit, fit_line, fit_parabola,
)

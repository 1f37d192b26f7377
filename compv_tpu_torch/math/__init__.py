"""Dense math layer (mirror of compv_tpu.math): transforms, point-set
statistics, matrices, distances, robust curve fits, PCA and element-wise
ops."""
from compv_tpu_torch.math.transform import (  # noqa: F401
    apply_homography, homogeneous_to_cartesian_2d, perspective_2d,
    to_homogeneous,
)
from compv_tpu_torch.math.stats import (  # noqa: F401
    hartley_normalize, masked_mean, masked_variance, mse_2d,
)
from compv_tpu_torch.math.matrix import (  # noqa: F401
    determinant, eigen_symm, inverse_3x3, inverse_diagonal, is_colinear_2d,
    is_symmetric, mul_ab, mul_abt, mul_ag, mul_ata, mul_ga, pseudo_inverse,
    rank, svd, trace, transpose,
)
from compv_tpu_torch.math.distance import (  # noqa: F401
    dist_line, dist_parabola, hamming, hamming_packed, l2, squared_l2,
)
from compv_tpu_torch.math.fit import (  # noqa: F401
    LineFit, ParabolaFit, fit_line, fit_parabola,
)
from compv_tpu_torch.math.pca import (  # noqa: F401
    PcaModel, pca_backproject, pca_compute, pca_load_json, pca_project,
    pca_save_json,
)
from compv_tpu_torch.math.ops import (  # noqa: F401
    abs_, add, atan2_deg_exact, cast, clip, fast_atan2_deg, fast_exp,
    hu_moments, hypot_, image_moments, logistic_activation, minmax,
    mul_elementwise, relu, scale_values, sub, tanh_activation,
)

"""Tensor ops: top-k, threefry, convolution, bit ops (mirror of
compv_tpu.ops)."""
from compv_tpu_torch.ops.conv import (  # noqa: F401
    convolve2d, convolve_separable, gaussian_blur, gaussian_kernel1d,
    gaussian_kernel2d,
)
from compv_tpu_torch.ops.bitops import (  # noqa: F401
    pack_bits_to_bytes, popcount_bytes, unpack_bytes_to_bits,
)

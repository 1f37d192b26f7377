"""Tensor ops: top-k, threefry, convolution, bit ops (mirror of compv_tpu.ops)."""

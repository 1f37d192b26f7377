"""Hand-written Hopper kernels (sources in compv_tpu_torch/csrc) with their
plain PyTorch twins; the port's counterpart of compv_tpu.ops.pallas."""

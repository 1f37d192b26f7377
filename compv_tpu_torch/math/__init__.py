"""Point-set math on the ported path (mirror of compv_tpu.math)."""

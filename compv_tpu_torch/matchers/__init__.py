"""Matchers (mirror of compv_tpu.matchers)."""
from compv_tpu_torch.matchers.bruteforce import (  # noqa: F401
    MatcherConfig, hamming_distance_matrix, knn_match, match_bruteforce,
    ratio_test,
)

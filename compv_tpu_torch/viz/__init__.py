"""Visualization (mirror of compv_tpu.viz; replaces the reference's gl/ +
drawing/, SURVEY.md §2.5). Results may live on the card: each field is
copied to the host once and drawn there."""
from compv_tpu_torch.viz.draw import (  # noqa: F401
    to_rgb, draw_keypoints, draw_matches, draw_lines, draw_boxes,
    draw_text, text_size, figure_keypoints, figure_matches,
)
from compv_tpu_torch.viz.stream import MjpegServer, run_live  # noqa: F401

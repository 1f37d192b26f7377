"""Work models of the ``text_blobs`` configuration's modelled stages, for
the roofline readers (``metrics/*_roofline_pct.text.py``); each maps one
call's positional arguments to (bytes, {unit: operations}) and is named
in the configuration's ``models``."""
from __future__ import annotations


def k2b_seeded_label(args) -> tuple:
    """One call of ``label_components_seeded(mask, init, connectivity)``:
    each byte once, the u8 mask and the i32 seed in and the i32 labels out,
    9 bytes a pixel (11.9 MB at 1122x1182); no operations counted beyond
    them."""
    n = args[0].numel()
    return n * (1 + 4 + 4), {}


MODELS = {"k2b_seeded_label": k2b_seeded_label}

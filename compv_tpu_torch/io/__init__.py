"""Host-side IO (mirror of compv_tpu.io): serialization and checkpoints."""
from compv_tpu_torch.io.serialize import (  # noqa: F401
    array_from_json, array_to_json, load_checkpoint, load_mat_json,
    load_npz, save_checkpoint, save_mat_json, save_npz,
)

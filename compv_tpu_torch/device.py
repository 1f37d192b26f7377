"""Device helpers. The port never picks a device on its own: functions run
where their input tensors live, and code that needs the card asks for it
here and fails without one."""
from __future__ import annotations

import torch

__all__ = ["require_cuda"]


def require_cuda() -> torch.device:
    """The first CUDA device; raises RuntimeError when no GPU is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device is required, and torch sees none "
                           f"(torch {torch.__version__}, "
                           f"built for CUDA {torch.version.cuda})")
    return torch.device("cuda", 0)

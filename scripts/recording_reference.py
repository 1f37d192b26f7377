"""The reference's results on chip_smoke.py's recording path.

The path (phase 19) reads 32 frames of bench.py's 720x1282 scene, frame t
rolled by (2t, 3t), and matches each later frame against the first with
``match_pair`` at phase 4's configuration
(``FrontendConfig(orb=OrbConfig(max_features=2000, levels=8))``). This
script runs the same 31 pairs through ``compv_tpu.slam.frontend.match_pair``
with JAX on the CPU and prints one JSON line: for each frame t, the
reference's match and inlier counts, its H (row-major, 7 significant
digits) and how far that H moves the interior grid of phase 4 from the true
shift (3t, 2t), in pixels. These are the ``RECORDING_REF`` constants of
chip_smoke.py. From the repository root, on a machine with JAX (about a
minute and a half):

    python3 scripts/recording_reference.py
"""
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from compv_tpu.features.orb import OrbConfig  # noqa: E402
from compv_tpu.slam.frontend import FrontendConfig, match_pair  # noqa: E402


def grid_error(h: np.ndarray, t: int) -> float:
    """Largest distance, over phase 4's interior grid of the 720x1282
    scene, between where ``h`` moves a point and the true shift (3t, 2t)."""
    gy, gx = np.mgrid[100:641:40, 100:1181:60].astype(np.float64)
    p = np.stack([gx.ravel(), gy.ravel(), np.ones(gx.size)])
    q = h @ p
    return float(np.abs(q[:2] / q[2] - (p[:2] + np.array([[3.0 * t],
                                                          [2.0 * t]]))).max())


def main() -> None:
    spec = importlib.util.spec_from_file_location(
        "compv_bench", os.path.join(ROOT, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    scene = bench._images()[0]
    cfg = FrontendConfig(orb=OrbConfig(max_features=2000, levels=8))
    frames = []
    for t in range(1, 32):
        res = match_pair(jnp.asarray(scene),
                         jnp.asarray(np.roll(scene, (2 * t, 3 * t), (0, 1))),
                         cfg)
        h = np.asarray(res.h, np.float64)
        frames.append([t, int(res.num_matches), int(res.num_inliers),
                       [float(f"{v:.7g}") for v in h.ravel()],
                       round(grid_error(h, t), 3)])
    print(json.dumps({"frames": frames}))


if __name__ == "__main__":
    main()

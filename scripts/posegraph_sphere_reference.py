"""The reference's cost ratio on chip_smoke.py's sphere graph.

Builds ``chip_smoke.sphere_graph()`` (2,500 poses on 50 rings, 4,949
edges, seed 0) and runs ``compv_tpu.slam.posegraph.optimize_pose_graph``
with ``PoseGraphConfig()`` on the CPU; prints the initial cost, the final
cost, their ratio (the ``POSEGRAPH_REF_RATIO`` that chip_smoke.py's phase
15 holds the port to) and the cost at the true poses, as one JSON line.
From the repository root, on a machine with JAX:

    python3 scripts/posegraph_sphere_reference.py
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

from compv_tpu.slam.posegraph import (PoseGraph, PoseGraphConfig,  # noqa: E402
                                      graph_residuals, optimize_pose_graph)


def main() -> int:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g, true = smoke.sphere_graph()
    graph = PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()})
    initial = float(jnp.sum(graph_residuals(graph.poses, graph) ** 2))
    at_truth = float(jnp.sum(graph_residuals(jnp.asarray(true), graph) ** 2))
    _, final = optimize_pose_graph(graph, PoseGraphConfig())
    final = float(final)
    print(json.dumps({"jax": jax.__version__, "poses": int(g["poses"].shape[0]),
                      "edges": int(g["edge_i"].shape[0]),
                      "cost_initial": initial, "cost_final": final,
                      "cost_ratio": final / initial,
                      "cost_at_truth": at_truth}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-process parallel layer on ``torch.distributed`` (mirror of
``compv_tpu/parallel``): process-group meshes, bring-up, and the sharded
detect / all-pairs matching / distributed BA pipelines. Importing it starts
no process group."""
from compv_tpu_torch.parallel.mesh import (  # noqa: F401
    FrameMesh, P, frame_sharding, make_mesh, make_mesh_2d, replicated)
from compv_tpu_torch.parallel.distributed import (  # noqa: F401
    global_frame_mesh, init_distributed, process_frame_slice)
from compv_tpu_torch.parallel.sharded import (  # noqa: F401
    distributed_ba_solve, make_distributed_ba_step,
    make_distributed_schur_step, ring_all_pairs_match,
    sharded_all_pairs_match, sharded_detect, sharded_orb_detect)

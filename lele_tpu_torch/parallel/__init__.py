"""Multi-device scaling: mesh construction, sharding rules, the planner,
the GPipe pipeline and compiled graphs over a mesh (counterpart of
lele_tpu/parallel).

A mesh is a DeviceMesh over processes (gloo for CPU tensors, NCCL on
cards); placed params and batches are DTensors, each rank holding its
shard. The collectives that GSPMD inserts for the JAX package are written
out in `spmd.py` (the train step) and `placement.py` (compiled graphs).
"""

from .mesh import init_distributed, make_mesh, mesh_axes  # noqa: F401
from .pipeline import pipeline_apply, stack_stage_params  # noqa: F401
from .planner import (  # noqa: F401
    EncoderSpec,
    plan_encoder,
    plan_mesh,
    recommend_plan,
    recommend_serving_plan,
)
from .sharding import (  # noqa: F401
    batch_sharding,
    replicate,
    shard_params,
    sensevoice_param_rules,
)

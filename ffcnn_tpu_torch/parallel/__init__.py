"""Multi-device inference, the port of ``ffcnn_tpu/parallel/``: device
meshes (``mesh.py``), data parallelism over Net replicas and the row- and
filter-sharded forward (``dp.py``), pipeline stages (``pp.py``) and data
parallelism across processes (``multiprocess.py``)."""

from .mesh import (DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SPATIAL_AXIS,
                   activation_sharding, batch_sharding, make_mesh,
                   replicated)
from .dp import DPNet, build_dp_pipeline, build_sharded_pipeline
from .pp import build_pp_pipeline, plan_stages

__all__ = ["DATA_AXIS", "MODEL_AXIS", "SPATIAL_AXIS", "PIPE_AXIS",
           "make_mesh", "batch_sharding", "activation_sharding",
           "replicated", "DPNet", "build_dp_pipeline",
           "build_sharded_pipeline", "build_pp_pipeline", "plan_stages"]

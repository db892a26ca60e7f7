"""Data, spatial and tensor parallelism across processes (port of extdm_tpu/parallel)."""
from extdm_tpu_torch.parallel.mesh import (  # noqa: F401
    DataGroup,
    World,
    all_mean,
    all_mean_autograd,
    average_gradients,
    broadcast_module,
    data_ranks,
    gather_batch,
    init_data_group,
    make_data_group,
    rank_generator,
    shard_batch,
)
from extdm_tpu_torch.parallel.spatial import SpatialMesh, make_spatial_mesh  # noqa: F401
from extdm_tpu_torch.parallel.tensor import (  # noqa: F401
    TensorParallel,
    make_hybrid_mesh,
    param_plan,
    resident_bytes,
    shard_params,
)

from neddf_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    broadcast_parameters,
    field_param_specs,
    gather_state,
    group_world,
    init_rank,
    launch,
    launcher_world,
    make_mesh,
    make_sharded_grads,
    make_sharded_render,
    resolve_world,
    shard_parameters,
)
from neddf_tpu_torch.parallel.tp import tp_gather  # noqa: F401

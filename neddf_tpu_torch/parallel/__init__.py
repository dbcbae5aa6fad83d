from neddf_tpu_torch.parallel.mesh import (  # noqa: F401
    broadcast_parameters,
    group_world,
    init_rank,
    launch,
    launcher_world,
    make_sharded_grads,
    make_sharded_render,
    resolve_world,
)

from .distributed import (
    all_reduce_sum,
    any_rank,
    barrier,
    get_rank,
    get_world_size,
    global_batch_draws,
    init_distributed_mode,
    is_main_process,
)
from .mesh import AXES, create_mesh, wrap_data_parallel

__all__ = [
    "init_distributed_mode",
    "get_rank",
    "get_world_size",
    "is_main_process",
    "barrier",
    "all_reduce_sum",
    "any_rank",
    "global_batch_draws",
    "create_mesh",
    "wrap_data_parallel",
    "AXES",
]

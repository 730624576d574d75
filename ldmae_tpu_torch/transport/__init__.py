from .paths import GVPCPlan, ICPlan, VPCPlan, expand_t_like_x
from .samplers import Sampler, forward_with_cfg, make_time_grid, ode_sample, sde_sample
from .transport import ModelType, PathType, Transport, WeightType, create_transport, mean_flat
from .utils import EasyDict, log_state

__all__ = [
    "Transport",
    "ModelType",
    "PathType",
    "WeightType",
    "create_transport",
    "mean_flat",
    "ICPlan",
    "VPCPlan",
    "GVPCPlan",
    "expand_t_like_x",
    "Sampler",
    "ode_sample",
    "sde_sample",
    "make_time_grid",
    "forward_with_cfg",
    "EasyDict",
    "log_state",
]

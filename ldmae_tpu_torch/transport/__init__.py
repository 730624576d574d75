from .samplers import Sampler, forward_with_cfg, make_time_grid, ode_sample
from .transport import ModelType, PathType, Transport, WeightType, create_transport

__all__ = [
    "Sampler",
    "forward_with_cfg",
    "make_time_grid",
    "ode_sample",
    "ModelType",
    "PathType",
    "Transport",
    "WeightType",
    "create_transport",
]

"""Flow-matching transport, sampling side (port of
``ldmae_tpu/transport/transport.py``): ``check_interval``, ``get_drift`` and
``create_transport``. Training losses and the VP/GVP paths come with the
DiT training slice."""

from __future__ import annotations

import enum
from typing import Optional, Sequence, Tuple

from . import paths
from .paths import expand_t_like_x


class ModelType(enum.Enum):
    NOISE = enum.auto()
    SCORE = enum.auto()
    VELOCITY = enum.auto()


class PathType(enum.Enum):
    LINEAR = enum.auto()
    GVP = enum.auto()
    VP = enum.auto()


class WeightType(enum.Enum):
    NONE = enum.auto()
    VELOCITY = enum.auto()
    LIKELIHOOD = enum.auto()


class Transport:
    def __init__(
        self,
        *,
        model_type: ModelType,
        path_type: PathType,
        loss_type: WeightType,
        train_eps: float,
        sample_eps: float,
    ):
        if path_type != PathType.LINEAR:
            raise NotImplementedError(
                f"path {path_type.name} is not ported yet (Linear only; VP/GVP come "
                "with the DiT training slice)"
            )
        self.loss_type = loss_type
        self.model_type = model_type
        self.path_sampler = paths.ICPlan()
        self.train_eps = train_eps
        self.sample_eps = sample_eps

    def check_interval(
        self,
        train_eps: float,
        sample_eps: float,
        *,
        diffusion_form: str = "SBDM",
        sde: bool = False,
        reverse: bool = False,
        eval: bool = False,
        last_step_size: float = 0.0,
    ) -> Tuple[float, float]:
        t0, t1 = 0.0, 1.0
        eps = train_eps if not eval else sample_eps
        if self.model_type != ModelType.VELOCITY or sde:
            t0 = (
                eps
                if (diffusion_form == "SBDM" and sde) or self.model_type != ModelType.VELOCITY
                else 0
            )
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        if reverse:
            t0, t1 = 1 - t0, 1 - t1
        return t0, t1

    def get_drift(self):
        def score_ode(x, t, model, **kwargs):
            drift_mean, drift_var = self.path_sampler.compute_drift(x, t)
            return -drift_mean + drift_var * model(x, t, **kwargs)

        def noise_ode(x, t, model, **kwargs):
            drift_mean, drift_var = self.path_sampler.compute_drift(x, t)
            sigma_t, _ = self.path_sampler.compute_sigma_t(expand_t_like_x(t, x))
            return -drift_mean + drift_var * (model(x, t, **kwargs) / -sigma_t)

        def velocity_ode(x, t, model, **kwargs):
            return model(x, t, **kwargs)

        if self.model_type == ModelType.NOISE:
            return noise_ode
        if self.model_type == ModelType.SCORE:
            return score_ode
        return velocity_ode


def create_transport(
    path_type: str = "Linear",
    prediction: str = "velocity",
    loss_weight: Optional[str] = None,
    train_eps: Optional[float] = None,
    sample_eps: Optional[float] = None,
    use_cosine_loss: Optional[bool] = None,
    use_lognorm: Optional[bool] = None,
    partitial_train: Optional[Sequence[float]] = None,
    partial_ratio: float = 1.0,
    shift_lg: bool = False,
) -> Transport:
    """Factory with the reference's signature and eps-default quirk (sample_eps
    inherits the *train_eps is None* test). The training-only arguments are
    accepted so configs map one to one; they do not affect sampling."""
    model_type = {"noise": ModelType.NOISE, "score": ModelType.SCORE}.get(
        prediction, ModelType.VELOCITY
    )
    loss_type = {"velocity": WeightType.VELOCITY, "likelihood": WeightType.LIKELIHOOD}.get(
        loss_weight, WeightType.NONE
    )
    ptype = {"Linear": PathType.LINEAR, "GVP": PathType.GVP, "VP": PathType.VP}[path_type]
    if ptype == PathType.VP:
        train_eps = 1e-5 if train_eps is None else train_eps
        sample_eps = 1e-3 if train_eps is None else sample_eps
    elif model_type != ModelType.VELOCITY:
        train_eps = 1e-3 if train_eps is None else train_eps
        sample_eps = 1e-3 if train_eps is None else sample_eps
    else:
        train_eps = 0
        sample_eps = 0
    return Transport(
        model_type=model_type, path_type=ptype, loss_type=loss_type,
        train_eps=train_eps, sample_eps=sample_eps,
    )

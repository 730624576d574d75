"""Flow-matching transport (port of ``ldmae_tpu/transport/transport.py``):
the training losses, the t sampling they use, ``check_interval``,
``get_drift``, ``get_score`` and ``create_transport``.

Randomness comes from an explicit ``torch.Generator``; torch and JAX draw
different numbers from one seed, so the tests inject the noise ``x0`` and
pin t (``sp_timesteps=(c, c)``, or ``t=`` directly). The logit-normal t is
sigmoid(mu + sigma * normal); on a partial range it is the exact inverse-CDF
truncation of the JAX package (``logit_normal_in_range``), not the
reference's rejection loop.
"""

from __future__ import annotations

import enum
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

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


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=tuple(range(1, x.dim())))


def logit_normal_in_range(u: torch.Tensor, mu: float, sigma: float, lo: float, hi: float) -> torch.Tensor:
    """The logit-normal(mu, sigma) law truncated to [lo, hi] by inverse CDF,
    from u ~ uniform[0, 1): u is mapped onto [cdf(lo), cdf(hi)) as JAX's
    ``uniform(minval, maxval)`` maps its draw, then through ndtri."""
    def cdf(x: float) -> torch.Tensor:
        x = torch.tensor(x, dtype=torch.float32, device=u.device)
        return torch.special.ndtr((torch.log(x) - torch.log1p(-x) - mu) / sigma)

    c_lo, c_hi = cdf(lo), cdf(hi)
    u = torch.maximum(u.float() * (c_hi - c_lo) + c_lo, c_lo)
    return torch.sigmoid(mu + sigma * torch.special.ndtri(u))


class Transport:
    def __init__(
        self,
        *,
        model_type: ModelType,
        path_type: PathType,
        loss_type: WeightType,
        train_eps: float,
        sample_eps: float,
        use_cosine_loss: bool = False,
        use_lognorm: bool = False,
        partitial_train: Optional[Sequence[float]] = None,
        partial_ratio: float = 1.0,
        shift_lg: bool = False,
    ):
        path_options = {
            PathType.LINEAR: paths.ICPlan,
            PathType.GVP: paths.GVPCPlan,
            PathType.VP: paths.VPCPlan,
        }
        self.loss_type = loss_type
        self.model_type = model_type
        self.path_sampler = path_options[path_type]()
        self.train_eps = train_eps
        self.sample_eps = sample_eps
        self.use_cosine_loss = bool(use_cosine_loss)
        self.use_lognorm = bool(use_lognorm)
        self.partitial_train = partitial_train
        self.partial_ratio = partial_ratio
        self.shift_lg = shift_lg

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
        if isinstance(self.path_sampler, paths.VPCPlan):
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        elif self.model_type != ModelType.VELOCITY or sde:  # ICPlan, GVPCPlan
            t0 = (
                eps
                if (diffusion_form == "SBDM" and sde) or self.model_type != ModelType.VELOCITY
                else 0
            )
            t1 = 1 - eps if (not sde or last_step_size == 0) else 1 - last_step_size
        if reverse:
            t0, t1 = 1 - t0, 1 - t1
        return t0, t1

    # -- t sampling ----------------------------------------------------------
    def sample(
        self,
        x1: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        sp_timesteps: Optional[Sequence[float]] = None,
        shifted_mu: float = 0.0,
        x0: Optional[torch.Tensor] = None,
        t: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(t, x0, x1). ``x0`` overrides the noise and ``t`` the timesteps
        (deterministic injection for the tests)."""
        dev = x1.device
        if x0 is None:
            x0 = torch.randn(x1.shape, generator=generator, device=dev, dtype=x1.dtype)
        b = x1.shape[0]
        if t is not None:
            return t.to(device=dev, dtype=x1.dtype), x0, x1

        def uniform(shape=(b,)):
            return torch.rand(shape, generator=generator, device=dev)

        if sp_timesteps is not None:
            lo, hi = sp_timesteps
            return uniform() * (hi - lo) + lo, x0, x1

        t0, t1 = self.check_interval(self.train_eps, self.sample_eps)
        if self.shift_lg and self.use_lognorm:
            if self.partitial_train is not None:
                raise ValueError("Shifted lognormal distribution is not compatible with partial training")
            t = torch.sigmoid(shifted_mu + torch.randn(b, generator=generator, device=dev)) * (t1 - t0) + t0
            return t.to(x1.dtype), x0, x1
        if self.use_lognorm:
            t = torch.sigmoid(torch.randn(b, generator=generator, device=dev)) * (t1 - t0) + t0
        else:
            u = uniform()
            t = u * (t1 - t0) + t0
        if self.partitial_train is not None:
            lo, hi = self.partitial_train
            # the JAX package draws the partial-range t from the same key as t
            if self.use_lognorm:
                t_part = logit_normal_in_range(uniform(), 0.0, 1.0, lo, hi)
            else:
                t_part = u * (hi - lo) + lo
            t = torch.where(uniform(()) < self.partial_ratio, t_part, t)
        return t.to(x1.dtype), x0, x1

    # -- losses ----------------------------------------------------------------
    def training_losses(
        self,
        model_fn: Callable[..., torch.Tensor],
        x1: torch.Tensor,
        model_kwargs: Optional[Dict[str, Any]] = None,
        generator: Optional[torch.Generator] = None,
        sp_timesteps: Optional[Sequence[float]] = None,
        shifted_mu: float = 0.0,
        x0: Optional[torch.Tensor] = None,
        t: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Velocity / noise / score flow-matching loss terms per sample:
        ``loss`` and, with ``use_cosine_loss``, ``cos_loss``; ``pred`` is the
        model output."""
        model_kwargs = model_kwargs or {}
        t, x0, x1 = self.sample(x1, generator, sp_timesteps, shifted_mu, x0=x0, t=t)
        t, xt, ut = self.path_sampler.plan(t, x0, x1)
        model_output = model_fn(xt, t, **model_kwargs)
        if model_output.shape != xt.shape:
            raise ValueError(f"model output {tuple(model_output.shape)} != x_t {tuple(xt.shape)}")

        terms: Dict[str, torch.Tensor] = {"pred": model_output}
        out_f32, ut_f32 = model_output.float(), ut.float()
        if self.model_type == ModelType.VELOCITY:
            terms["loss"] = mean_flat((out_f32 - ut_f32) ** 2)
            if self.use_cosine_loss:
                # cosine similarity over the channels with safe norms
                # sqrt(max(sumsq, tiny)): the gradient at an all-zero output
                # (the zero-initialised final layer at step 1) is 0, not NaN
                num = (out_f32 * ut_f32).sum(dim=1)
                norm_out = torch.sqrt(torch.clamp_min((out_f32 * out_f32).sum(dim=1), 1e-30))
                norm_ut = torch.sqrt(torch.clamp_min((ut_f32 * ut_f32).sum(dim=1), 1e-30))
                cos = num / torch.clamp_min(norm_out * norm_ut, 1e-8)
                terms["cos_loss"] = mean_flat(1 - cos)
        else:
            _, drift_var = self.path_sampler.compute_drift(xt, t)
            sigma_t, _ = self.path_sampler.compute_sigma_t(expand_t_like_x(t, xt))
            if self.loss_type == WeightType.VELOCITY:
                weight = (drift_var / sigma_t) ** 2
            elif self.loss_type == WeightType.LIKELIHOOD:
                weight = drift_var / (sigma_t**2)
            else:
                weight = 1
            if self.model_type == ModelType.NOISE:
                terms["loss"] = mean_flat(weight * (out_f32 - x0) ** 2)
            else:
                terms["loss"] = mean_flat(weight * (out_f32 * sigma_t + x0) ** 2)
        return terms

    # -- drift -----------------------------------------------------------------
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

    def get_score(self):
        """score(x, t, model, **kwargs): the model's output as a score."""
        def noise_score(x, t, model, **kwargs):
            return model(x, t, **kwargs) / -self.path_sampler.compute_sigma_t(expand_t_like_x(t, x))[0]

        def score(x, t, model, **kwargs):
            return model(x, t, **kwargs)

        def velocity_score(x, t, model, **kwargs):
            return self.path_sampler.get_score_from_velocity(model(x, t, **kwargs), x, t)

        if self.model_type == ModelType.NOISE:
            return noise_score
        if self.model_type == ModelType.SCORE:
            return score
        return velocity_score

    def get_drift_and_score(self):
        """(drift, score)(x, t, model, **kwargs) from ONE model evaluation.
        The JAX sampler calls ``get_drift()`` and ``get_score()`` apart, each
        evaluating the model, and under ``jax.jit`` XLA merges the two
        identical forwards; run eagerly they would be two DiT forwards. Both
        formulas here read the one output, so the numbers are the same and
        the forwards halve."""
        drift, score = self.get_drift(), self.get_score()

        def drift_and_score(x, t, model, **kwargs):
            out = model(x, t, **kwargs)

            def evaluated(*args, **kw):
                return out

            return drift(x, t, evaluated), score(x, t, evaluated)

        return drift_and_score


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
    inherits the *train_eps is None* test)."""
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
        train_eps=train_eps, sample_eps=sample_eps, use_cosine_loss=bool(use_cosine_loss),
        use_lognorm=bool(use_lognorm), partitial_train=partitial_train,
        partial_ratio=partial_ratio, shift_lg=shift_lg,
    )

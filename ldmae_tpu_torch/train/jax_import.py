"""A JAX train state as the port's ``.pt`` checkpoint (the other direction
of ``ldmae_tpu/train/torch_import.py``).

The JAX package's CLIs checkpoint into Orbax directories, which the port
cannot read (it imports neither jax nor orbax). ``scripts/convert_orbax.py``
restores one in the JAX environment, maps each tree to reference-layout
state dicts with ``convert.py``'s maps (weights, EMA and AdamW's two
moments alike), and hands them here as numpy arrays or tensors. This module
builds the port's own model and optimizer on the CPU, as its training CLIs
build them, loads the weights with ``load_state_dict(strict=True)``, puts
the moments into the optimizer's state by parameter name, and writes the
file with ``train.state.save_checkpoint``: ``<base_dir>/checkpoints/
<step:07d>.pt`` holding ``{model, ema, opt, config, step}`` (no ``ema`` for
the VMAE), the file a port run of the same state writes. A run in the
half-split RoPE layout is given in that layout and ``save_checkpoint``
permutes the weights and moments to the canonical one, as it does for the
port's own runs.

Steps: ``step`` is the train state's step (the data stream's position, and
the VMAE epoch's), ``count`` is optax's Adam count, the updates applied
(it becomes every parameter's AdamW ``step``, so the first resumed update
takes count + 1 in both bias corrections, and the VMAE's learning rate is
the schedule at count, as optax's is). They differ where the VMAE skipped
a non-finite update.

Nothing is dropped silently: a parameter without a moment, a moment
without a parameter, or a shape that differs raises. ``convert.py``'s maps
rearrange elements only (transposes, reshapes, stacking, the patch
embedding's conv-from-linear reshape, the gradual blocks' renumbering) and
add the fixed tables (``pos_embed``, ``decoder_pos_embed``, the RoPE
tables) from the spec; those are buffers, not parameters, so the entries
the maps give them in a moment dict are ignored here.
"""

from __future__ import annotations

import argparse
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.config import LDMAEConfig
from ..models.lightningdit import LightningDiT
from .state import TrainState, init_train_state, save_checkpoint

StateDict = Mapping[str, Any]


def _tensor(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.float32)).clone()


def _moments_into_(optimizer: torch.optim.Optimizer, model: nn.Module, mu: StateDict, nu: StateDict,
                   count: int) -> None:
    """``optimizer.state[p]`` of every parameter it holds, by name:
    ``step`` (float32, as torch keeps it), ``exp_avg`` = mu, ``exp_avg_sq``
    = nu."""
    held = {id(p) for group in optimizer.param_groups for p in group["params"]}
    params = {n: p for n, p in model.named_parameters() if id(p) in held}
    buffers = set(dict(model.named_buffers()))
    for what, m in (("mu", mu), ("nu", nu)):
        missing = sorted(set(params) - set(m))
        unknown = sorted(set(m) - set(params) - buffers)
        if missing or unknown:
            raise KeyError(f"AdamW {what}: no moment for {missing[:5]}, no trained parameter for {unknown[:5]}")
    for name, p in params.items():
        state = {"step": torch.tensor(float(count), dtype=torch.float32)}
        for key, m in (("exp_avg", mu), ("exp_avg_sq", nu)):
            t = _tensor(m[name])
            if t.shape != p.shape:
                raise ValueError(f"{key} of {name}: shape {tuple(t.shape)} != the parameter's {tuple(p.shape)}")
            state[key] = t
        optimizer.state[p] = state


def write_dit_checkpoint(base_dir: str, config: Mapping[str, Any], params: StateDict, ema: StateDict,
                         mu: StateDict, nu: StateDict, *, step: int, count: int,
                         rope_layout: str = "interleaved") -> str:
    """The port's DiT checkpoint of a JAX train state: ``params``, ``ema``,
    ``mu`` and ``nu`` are reference-layout state dicts in the run's RoPE
    layout (``rope_layout``, as the run's saved YAML says); ``config`` is
    the run's YAML as a dict. Builds the model and optimizer as
    ``cli.train_dit`` does (``make_optimizer`` with the YAML's lr and
    beta2) and returns the written path."""
    from .train_dit import make_optimizer, spec_from_config

    cfg = LDMAEConfig.from_dict(dict(config))
    spec = spec_from_config(cfg)
    model = LightningDiT(spec, device="cpu")
    model.load_state_dict({k: _tensor(v) for k, v in params.items()}, strict=True)
    state = init_train_state(model, make_optimizer(model.parameters(), cfg.optimizer.lr, cfg.optimizer.beta2))
    state.ema.load_state_dict({k: _tensor(v) for k, v in ema.items()}, strict=True)
    _moments_into_(state.optimizer, model, mu, nu, count)
    state.step = int(step)
    return save_checkpoint(base_dir, state, config=cfg.to_dict(), half_rope=rope_layout == "half" and spec.use_rope)


def vmae_args(saved: Mapping[str, Any]) -> argparse.Namespace:
    """The port CLI's flags with the values a JAX run saved (its ``vars(args)``
    in ``NNNNNNN.config.yaml``); flags the port does not have are dropped."""
    from ..cli.train_vmae import get_args_parser

    args = get_args_parser().parse_args(["--data_path", str(saved.get("data_path", ""))])
    for key, value in saved.items():
        if hasattr(args, key):
            setattr(args, key, value)
    return args


def write_vmae_checkpoint(base_dir: str, saved_args: Mapping[str, Any], params: StateDict, mu: StateDict,
                          nu: StateDict, *, step: int, count: int,
                          gradual: Optional[Tuple[int, int]] = None) -> str:
    """The port's VMAE checkpoint of a JAX train state (stage 1 or 3, or
    with ``gradual`` = (downsample_after, upsample_after) the gradual
    model's): ``params``, ``mu`` and ``nu`` are reference-layout state
    dicts; ``saved_args`` the run's flags. The optimizer is
    ``make_vmae_optimizer``'s (the decay and no-decay groups; under
    ``--tune_decoder`` the frozen parameters hold no state, as optax's
    ``set_to_zero`` branch holds no moments). The JAX state's EMA is not
    carried: the VMAE trainer keeps none and the port's file has none."""
    from ..cli.train_vmae import model_spec
    from ..models.vmae import VMAE
    from ..models.vmae_variants import GradualVMAE
    from .train_vmae import make_vmae_optimizer

    args = vmae_args(saved_args)
    if bool(args.gradual_resol) != (gradual is not None):
        raise ValueError(f"--gradual_resol {args.gradual_resol} in the saved flags, gradual layout {gradual}")
    spec = model_spec(args)
    model = VMAE(spec, device="cpu") if gradual is None else GradualVMAE(spec, *gradual, device="cpu")
    model.load_state_dict({k: _tensor(v) for k, v in params.items()}, strict=True)
    optimizer = make_vmae_optimizer(model, weight_decay=args.weight_decay, tune_decoder=args.tune_decoder)
    _moments_into_(optimizer, model, mu, nu, count)
    state = TrainState(step=int(step), model=model, ema=None, optimizer=optimizer)
    return save_checkpoint(base_dir, state, config=vars(args))


"""Train state and ``.pt`` checkpoints (port of ``ldmae_tpu/train/state.py``).

A checkpoint is the reference's DiT layout, ``{model, ema, opt, config,
step}`` (the JAX package's Orbax checkpoints mirror it; a VMAE state has no
EMA and its checkpoint no ``ema``), written to
``<exp_dir>/checkpoints/<step:07d>.pt``: ``model`` and ``ema`` are state
dicts in the canonical interleaved RoPE layout, so the inference CLI and the
reference load them as they are; ``opt`` is the AdamW state dict, its
moments re-indexed the same way. A run in the half-split layout is
permuted back on save and forward again on restore. Resume picks the
largest step. Orbax checkpoints are not read or written here.
"""

from __future__ import annotations

import copy
import os
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from ..models.lightningdit import LightningDiT, permute_qk_for_half_rope


@dataclass
class TrainState:
    """The step, the model (a ``LightningDiT`` or a ``VMAE``), its EMA (None
    for the VMAE, whose trainer keeps none) and the optimizer."""

    step: int
    model: nn.Module
    ema: Optional[nn.Module]
    optimizer: torch.optim.Optimizer


def init_train_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> TrainState:
    """Step 0, with the EMA a copy of the model that takes no gradient."""
    ema = copy.deepcopy(model).requires_grad_(False)
    return TrainState(step=0, model=model, ema=ema, optimizer=optimizer)


def _ckpt_dir(base: str) -> str:
    return os.path.abspath(os.path.join(base, "checkpoints"))


def list_checkpoints(base_dir: str) -> List[int]:
    d = _ckpt_dir(base_dir)
    if not os.path.isdir(d):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(d) if (m := re.fullmatch(r"(\d{7})\.pt", name)))


def _permute_opt_state(opt_sd: Dict[str, Any], model: LightningDiT, inverse: bool) -> Dict[str, Any]:
    """The AdamW moments of the q/k channels moved between the RoPE layouts
    (optimizer state is indexed by the parameters' order in the model)."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    state = opt_sd["state"]
    out = {"state": {i: dict(s) for i, s in state.items()}, "param_groups": opt_sd["param_groups"]}
    for key in ("exp_avg", "exp_avg_sq"):
        by_name = {names[i]: s[key] for i, s in state.items() if key in s}
        if len(by_name) != len(names):  # no step taken yet
            continue
        moved = permute_qk_for_half_rope(by_name, model.spec, inverse=inverse)
        for i in state:
            out["state"][i][key] = moved[names[i]]
    return out


def save_checkpoint(base_dir: str, state: TrainState, config: Optional[Dict] = None,
                    half_rope: bool = False) -> str:
    """Write ``<base_dir>/checkpoints/<step:07d>.pt`` (atomically) and return
    its path; ``half_rope``: the run trains in the half-split layout."""
    spec = state.model.spec

    def canonical(sd):
        sd = {k: v.detach().cpu() for k, v in sd.items()}
        return permute_qk_for_half_rope(sd, spec, inverse=True) if half_rope else sd

    opt = state.optimizer.state_dict()
    if half_rope:
        opt = _permute_opt_state(opt, state.model, inverse=True)
    ckpt = {"model": canonical(state.model.state_dict())}
    if state.ema is not None:
        ckpt["ema"] = canonical(state.ema.state_dict())
    ckpt |= {"opt": opt, "config": config, "step": int(state.step)}
    d = _ckpt_dir(base_dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{int(state.step):07d}.pt")
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(ckpt, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(base_dir: str, state: TrainState, step: Optional[int] = None,
                       half_rope: bool = False) -> Optional[TrainState]:
    """Load the latest (or the given) checkpoint into ``state`` in place and
    return it; None when there is none."""
    steps = list_checkpoints(base_dir)
    if not steps:
        return None
    step = steps[-1] if step is None else step
    path = os.path.join(_ckpt_dir(base_dir), f"{step:07d}.pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    spec = state.model.spec
    for module, key in ((state.model, "model"), (state.ema, "ema")):
        if module is None:
            continue
        sd = ckpt[key]
        module.load_state_dict(permute_qk_for_half_rope(sd, spec) if half_rope else sd, strict=True)
    opt = ckpt["opt"]
    if half_rope:
        opt = _permute_opt_state(opt, state.model, inverse=False)
    state.optimizer.load_state_dict(opt)
    state.step = int(ckpt["step"])
    return state

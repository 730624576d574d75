"""Small transport utilities (port of ``ldmae_tpu/transport/utils.py``)."""

from __future__ import annotations

from collections.abc import Mapping

import torch


class EasyDict(dict):
    """Attribute-access dict."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]


def _describe(value) -> str:
    if isinstance(value, torch.Tensor):
        return f"Tensor{tuple(value.shape)} {str(value.dtype).removeprefix('torch.')} on {value.device}"
    if "object at 0x" in repr(value):  # an instance: its class, not its address
        return f"[{type(value).__name__}]"
    return str(value)


def log_state(state) -> str:
    """Readable dump, one sorted ``key: value`` line each, of a state dict or
    other mapping, of a module (its ``state_dict()``: tensors as shape,
    dtype and device), or of any other object's public non-callable
    attributes (a transport's or sampler's configuration, as the JAX
    package's ``log_state`` prints it)."""
    if isinstance(state, torch.nn.Module):
        items = state.state_dict().items()
    elif isinstance(state, Mapping):
        items = state.items()
    else:
        items = ((k, v) for k, v in vars(state).items() if not callable(v) and not k.startswith("_"))
    lines = [f"{type(state).__name__}:"]
    lines += [f"  {k}: {_describe(v)}" for k, v in sorted(items, key=lambda kv: str(kv[0]))]
    return "\n".join(lines)

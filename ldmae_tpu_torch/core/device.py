"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means this process's card, ``cuda:<current device>``: after
    ``parallel.init_distributed_mode`` that is the rank's ``LOCAL_RANK``
    card. A CUDA device without a card raises: the port runs on the CPU only
    when the caller asks for it (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ldmae_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if device is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev

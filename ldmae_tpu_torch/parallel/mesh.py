"""Device mesh and data parallelism (port of ``ldmae_tpu/parallel/mesh.py``).

The JAX package lays a ``(dp, fsdp, tp)`` mesh over every device and lets
pjit insert the gradient all-reduce from the shardings. The port runs one
process per card: the mesh is a ``DeviceMesh`` over the ranks with the same
axis names, and the dp axis is ``DistributedDataParallel`` (the reference's
DDP), which takes the place of ``shard_params`` there.

Gradient averaging: DDP averages the ranks' gradients, each the gradient of
the mean loss over that rank's local batch. The local batches are equal, so
that average is the gradient of the mean loss over the global batch, which is
what the JAX step differentiates.

``fsdp`` and ``tp`` above 1 are not ported (ROADMAP.md Queue 1, item 15):
under tp the merged SwiGLU weight is sharded on its contracting dim, which
splits #4's fused epilogue, so it is kernel work of its own.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist
import torch.nn as nn

from .distributed import get_world_size

AXES = ("dp", "fsdp", "tp")


def create_mesh(dp: int = -1, fsdp: int = 1, tp: int = 1, device_type: Optional[str] = None):
    """The ``(dp, fsdp, tp)`` mesh over the ranks: ``dp = -1`` takes what
    fsdp x tp leaves, and dp x fsdp x tp must equal the world size (the JAX
    function's assertions and messages, a rank standing for a device).
    Returns a ``DeviceMesh`` with ``AXES`` as its dim names when a process
    group exists, else None (one process: nothing to lay out).
    ``fsdp`` or ``tp`` above 1 raises ``NotImplementedError``."""
    if fsdp > 1 or tp > 1:
        raise NotImplementedError(
            f"--fsdp {fsdp} --tp {tp}: parameter and tensor parallelism are not ported yet (ROADMAP.md Queue 1 "
            "item 15); the port runs data parallelism only")
    n = get_world_size()
    if dp == -1:
        if n % (fsdp * tp) != 0:
            raise AssertionError(f"{n} devices not divisible by fsdp*tp={fsdp * tp}")
        dp = n // (fsdp * tp)
    if dp * fsdp * tp != n:
        raise AssertionError(f"mesh {dp}x{fsdp}x{tp} != {n} devices")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    device_type = device_type or ("cuda" if dist.get_backend() == "nccl" else "cpu")
    return init_device_mesh(device_type, (dp, fsdp, tp), mesh_dim_names=AXES)


def wrap_data_parallel(module: nn.Module, device: Optional[Union[str, torch.device]] = None
                       ) -> Optional[nn.parallel.DistributedDataParallel]:
    """``module`` in ``DistributedDataParallel`` whenever a process group
    exists (at world 1 too, so one card runs DDP's buckets and all-reduce),
    else None. Every parameter takes a gradient in each step
    (``find_unused_parameters=False``); the buffers are constants that every
    rank computes alike, so they are not broadcast before each forward."""
    if not dist.is_initialized():
        return None
    device = torch.device(device) if device is not None else next(module.parameters()).device
    return nn.parallel.DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        find_unused_parameters=False, broadcast_buffers=False)

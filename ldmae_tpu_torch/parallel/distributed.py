"""Process groups (port of ``ldmae_tpu/parallel/distributed.py``).

``init_distributed_mode`` is the reference's process-group bootstrap
(``VMAE/util/misc.py:367-402``): the env:// rendezvous of ``torchrun``
(``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT`` /
``LOCAL_RANK``), SLURM (``SLURM_PROCID`` / ``SLURM_NTASKS`` /
``SLURM_LOCALID``) or Open MPI (``OMPI_COMM_WORLD_*``), read in that order,
as the JAX function reads them. The group is NCCL on CUDA and gloo on the
CPU, with the reference's 30-minute timeout, and each process is pinned to
its ``LOCAL_RANK`` card. One process with none of that environment starts no
group, and every helper below then answers for a world of one.

Host-side collectives (the barriers, the CLIs' metric sums, the training
CLIs' stop flag) go through gloo on CPU tensors: the default group when it is
gloo, else a gloo group beside the NCCL one. So they never wait for the card,
and a rank that dies closes its gloo sockets, which fails the others' next
collective at once instead of leaving them at a barrier.

``global_batch_draws`` makes a data-parallel rank draw its random numbers as
a one-process run on the global batch would (see its docstring). Under
tensor parallelism the ranks of a tp group (consecutive: tp is the mesh's
innermost axis) share one slice of the batch: a rank's data index is
``rank // tp`` among ``world // tp`` (``data_index``, ``data_world``).

Device-side collectives on a group (tensor parallelism's partial sums, row
maxima and gathered modulations): ``group_all_reduce_`` (sum or max, in
place) and ``group_all_gather`` (concatenated along a dim). They run on
whatever backend the group has, NCCL across cards or gloo for ranks that
share one, and a failed collective raises; ``COLLECTIVES`` counts them and
their bytes. Under autograd (tp training) three Functions carry them, each
the identity without a group:

* ``copy_to_tp``: identity forward, the gradient all-reduced backward (the
  replicated input of a column-parallel layer, whose rank gets only its
  rows' share of dx);
* ``reduce_from_tp``: all-reduce forward (in place), identity backward
  (the partial products of a row-parallel layer);
* ``gather_from_tp``: all-gather forward, this rank's slice of the
  gradient backward (everything downstream is replicated, so every rank
  holds the whole gradient already: a reduce-scatter would multiply it by
  the group's size).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode

TIMEOUT_S = 1800  # the reference's init_process_group timeout

_host_group = None  # gloo group for the host-side collectives when the default group is not gloo


def _from_env() -> Optional[Tuple[int, int, int]]:
    """(rank, world, local rank) from the launcher's environment, or None for
    a single process."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env and int(env["WORLD_SIZE"]) > 1:
        return int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0))
    if "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        return int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]), int(env.get("SLURM_LOCALID", 0))
    if "OMPI_COMM_WORLD_SIZE" in env and int(env["OMPI_COMM_WORLD_SIZE"]) > 1:
        return (int(env["OMPI_COMM_WORLD_RANK"]), int(env["OMPI_COMM_WORLD_SIZE"]),
                int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", 0)))
    return None


def init_distributed_mode(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    local_rank: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
    timeout_s: int = TIMEOUT_S,
) -> None:
    """Start the process group; a no-op for one process without a launcher's
    environment, and when a group already exists.

    Explicit ``world_size`` and ``rank`` win over the environment (with
    ``init_method`` defaulting to ``tcp://MASTER_ADDR:MASTER_PORT``).
    ``backend`` defaults to NCCL where CUDA is available and ``device`` is
    not the CPU, else gloo. On CUDA the process is pinned to its local rank's
    card before the group starts. Ends with a barrier while the ranks are
    still close together (the JAX function's reason: a first collective
    behind minutes of per-rank set-up meets a loaded host)."""
    global _host_group
    if dist.is_initialized():
        return
    env = os.environ
    if world_size is None:
        found = _from_env()
        if found is None:
            return
        rank, world_size, env_local = found
        local_rank = env_local if local_rank is None else local_rank
    if rank is None:
        raise ValueError("init_distributed_mode: world_size given without rank")
    if init_method is None:
        init_method = f"tcp://{env.get('MASTER_ADDR', '127.0.0.1')}:{env.get('MASTER_PORT', '29500')}"
    local_rank = int(env.get("LOCAL_RANK", 0)) if local_rank is None else local_rank
    use_cuda = torch.cuda.is_available() and (device is None or torch.device(device).type == "cuda")
    backend = backend or ("nccl" if use_cuda else "gloo")
    if use_cuda:
        torch.cuda.set_device(local_rank)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank, timeout=timeout)
    _host_group = None if dist.get_backend() == "gloo" else dist.new_group(backend="gloo", timeout=timeout)
    barrier("init_distributed_mode")


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def barrier(name: str = "barrier", timeout_s: int = TIMEOUT_S) -> None:
    """Wait for every rank (the reference's ``dist.barrier``), up to
    ``timeout_s``.

    ``monitored_barrier`` on the gloo group, not a collective with a timeout
    of seconds: the JAX docstring records the gloo ``DEADLINE_EXCEEDED``
    cascade that a short one caused while rank 0 scanned shards or ran a
    trailing FID. On a timeout rank 0 names the ranks that did not arrive."""
    if get_world_size() == 1:
        return
    try:
        dist.monitored_barrier(group=_host_group, timeout=datetime.timedelta(seconds=timeout_s),
                               wait_all_ranks=True)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r} failed on rank {get_rank()}: {e}") from e


def all_reduce_sum(x) -> np.ndarray:
    """The elementwise sum over ranks of a host array (a copy for one
    process); float64 and int64 stay exact for the CLIs' sums and counts."""
    x = np.asarray(x)
    if get_world_size() == 1:
        return x.copy()
    t = torch.from_numpy(np.array(x, copy=True))
    dist.all_reduce(t, group=_host_group)
    return t.numpy()


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (the training CLIs'
    stop signal, so that every rank checkpoints at the same step)."""
    return bool(all_reduce_sum(np.array([int(flag)], np.int64))[0])


def data_index(tp: int = 1) -> int:
    """This rank's share of the batch: ranks of one tp group (consecutive)
    read and draw the same rows."""
    return get_rank() // tp


def data_world(tp: int = 1) -> int:
    """The number of distinct batch shares (data-parallel ranks x fsdp
    ranks)."""
    return get_world_size() // tp


class _GlobalBatchDraws(TorchFunctionMode):
    _DRAWS = (torch.rand, torch.randn)

    def __init__(self, generator: torch.Generator, local: int, rank: int, world: int):
        super().__init__()
        self.generator, self.local, self.rank, self.world = generator, local, rank, world

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self._DRAWS and kwargs.get("generator") is self.generator:
            size = tuple(args[0]) if len(args) == 1 and not isinstance(args[0], int) else tuple(args)
            if size and size[0] == self.local:
                out = func((self.local * self.world, *size[1:]), **kwargs)
                return out[self.rank * self.local:(self.rank + 1) * self.local]
        return func(*args, **kwargs)


@contextlib.contextmanager
def global_batch_draws(generator: Optional[torch.Generator], local_batch: int, tp: int = 1):
    """Inside it, a ``torch.rand`` / ``torch.randn`` from ``generator`` whose
    leading dim is ``local_batch`` is drawn for the global batch (``local_batch``
    x ``data_world(tp)`` rows) and this rank's rows kept: data index i gets
    rows [i m, (i + 1) m), so the ranks of a tp group draw alike.

    Every rank seeds ``generator`` alike, so the ranks' noise, timesteps,
    label drops and masks are the rows that one process training on the
    concatenated global batch draws, as the JAX step draws them for its
    global batch. Draws of another generator or another leading dim pass
    through. A no-op for one data share."""
    world = data_world(tp)
    if world == 1 or generator is None:
        yield
        return
    with _GlobalBatchDraws(generator, local_batch, data_index(tp), world):
        yield


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# the group collectives run (the tp path's all-reduces and all-gathers) and
# the bytes each rank sent into them; reset by the caller
COLLECTIVES = {"all_reduce": 0, "all_gather": 0, "bytes": 0}


def reset_collectives() -> None:
    COLLECTIVES.update(all_reduce=0, all_gather=0, bytes=0)


def group_size(group) -> int:
    """Ranks in ``group`` (1 for None: no group, nothing to reduce)."""
    return 1 if group is None else dist.get_world_size(group)


def group_all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``group``'s ranks in place (``op`` 'sum' or 'max')
    and returned; every rank ends with the same values. No-op without a
    group. Integer sums are exact; a float sum's order is the backend's."""
    if group_size(group) > 1:
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=group)
        COLLECTIVES["all_reduce"] += 1
        COLLECTIVES["bytes"] += t.numel() * t.element_size()
    return t


def group_all_gather(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in group-rank order (the
    shards of a tensor split contiguously along ``dim``)."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    out = torch.empty((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["bytes"] += t.numel() * t.element_size()
    return torch.cat(out.view(n, *t.shape).unbind(0), dim=dim)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return group_all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        return group_all_reduce_(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group_all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        rank = dist.get_rank(ctx.group) if n > 1 else 0
        return g.chunk(n, dim=ctx.dim)[rank].contiguous(), None, None


def copy_to_tp(x: Optional[torch.Tensor], group) -> Optional[torch.Tensor]:
    """x itself, whose gradient is summed over ``group`` in the backward:
    the replicated input of a column-parallel layer (each rank's dx holds
    only its output rows' share), or a replicated weight that each rank
    uses on its own slice. Without a group (or for None), x."""
    return x if x is None or group_size(group) == 1 else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """x (contiguous) summed over ``group`` in place and returned; the
    gradient passes through unchanged (the transpose of a sum of partials
    that every rank then holds whole). Without a group, x."""
    return x if group_size(group) == 1 else _ReduceFromTP.apply(x, group)


def gather_from_tp(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """``group_all_gather`` under autograd: the backward keeps this rank's
    slice of the (replicated) gradient along ``dim``. Without a group, x."""
    return x if group_size(group) == 1 else _GatherFromTP.apply(x, group, dim)

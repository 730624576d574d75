#!/usr/bin/env python3
"""Which collectives a gloo group carries on CUDA tensors, with every rank
on one card (NCCL refuses two ranks on one device, so gloo is how one card
runs a world of 2 or 4).

    python3 scripts/gloo_cuda_probe.py [--world 2] [--only fsdp2,reduce_scatter]

Each rank tries, on CUDA tensors: all_reduce (sum of fp32, bf16, int32 and
int64; max of fp32), all_gather_into_tensor and all_gather of bf16 and fp32,
reduce_scatter_tensor of fp32 (sum and avg), broadcast; then FSDP2
(``fully_shard`` on a ``cuda`` device mesh) for two forwards, backwards and
AdamW steps of a small MLP, at world 2 on one shard dim and, at world 4,
hybrid (2 x 2), and after them a weight's ``full_tensor`` and the model's
full state dict (``torch.distributed.checkpoint.state_dict``). It prints one line a case, ``ok`` or the error, rank 0's
results as a JSON line, and the seconds of an fp32 all_reduce of
16,384 x 1,536 (a row-parallel partial of LightningDiT-1p0B/1 at batch 8
under CFG). Needs a CUDA card; runs nothing without one.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, out: str, only: list) -> None:
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.enable()  # a crash inside a collective prints the Python stack
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    dev = torch.device("cuda", 0)
    res = {}

    def case(name, fn):
        if only and not any(name.startswith(o) for o in only):
            return
        try:
            res[name] = fn()
        except Exception as e:  # the probe's result: what gloo refused
            res[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
        print(f"[rank {rank}] {name}: {res[name]}", flush=True)

    def all_reduce(dtype, op):
        t = torch.full((1024,), rank + 1, device=dev).to(dtype)
        dist.all_reduce(t, op=op)
        want = sum(range(1, world + 1)) if op == dist.ReduceOp.SUM else world
        return "ok" if bool((t.float() == want).all()) else f"wrong: {t[:4].tolist()}"

    for dt in (torch.float32, torch.bfloat16, torch.int32, torch.int64):
        case(f"all_reduce_sum_{dt}".replace("torch.", ""), lambda dt=dt: all_reduce(dt, dist.ReduceOp.SUM))
    case("all_reduce_max_float32", lambda: all_reduce(torch.float32, dist.ReduceOp.MAX))

    def gather_into(dtype):
        t = torch.full((8, 16), rank, device=dev, dtype=dtype)
        o = torch.empty(8 * world, 16, device=dev, dtype=dtype)
        dist.all_gather_into_tensor(o, t)
        return "ok" if all(bool((o[8 * r:8 * r + 8] == r).all()) for r in range(world)) else "wrong"

    def gather_list(dtype):
        t = torch.full((8, 16), rank, device=dev, dtype=dtype)
        o = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(o, t)
        return "ok" if all(bool((o[r] == r).all()) for r in range(world)) else "wrong"

    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).replace("torch.", "")
        case(f"all_gather_into_tensor_{name}", lambda dt=dt: gather_into(dt))
        case(f"all_gather_{name}", lambda dt=dt: gather_list(dt))

    def reduce_scatter(op):
        t = torch.full((8 * world,), rank + 1.0, device=dev)
        o = torch.empty(8, device=dev)
        dist.reduce_scatter_tensor(o, t, op=op)
        s = sum(range(1, world + 1))
        want = s if op == dist.ReduceOp.SUM else s / world
        return "ok" if bool((o == want).all()) else f"wrong: {o[:4].tolist()}"

    case("reduce_scatter_tensor_sum_float32", lambda: reduce_scatter(dist.ReduceOp.SUM))
    case("reduce_scatter_tensor_avg_float32", lambda: reduce_scatter(dist.ReduceOp.AVG))

    def broadcast():
        t = torch.full((16,), float(rank), device=dev)
        dist.broadcast(t, 0)
        return "ok" if bool((t == 0).all()) else "wrong"

    case("broadcast_float32", broadcast)

    def fsdp(shape, then=None):
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        torch.manual_seed(0)
        mesh = init_device_mesh("cuda", shape, mesh_dim_names=("dp", "fsdp")[-len(shape):])
        model = torch.nn.Sequential(torch.nn.Linear(64, 256), torch.nn.GELU(), torch.nn.Linear(256, 64)).to(dev)
        for layer in (model[0], model[2]):
            fully_shard(layer, mesh=mesh)
        fully_shard(model, mesh=mesh)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
        x = torch.randn(4, 64, device=dev)
        for _ in range(2):
            model(x).square().mean().backward()
            opt.step()
            opt.zero_grad()
        local = model[0].weight.to_local()
        msg = f"ok (local shard {tuple(local.shape)} finite {bool(torch.isfinite(local).all())})"
        if then == "full_tensor":
            msg += f"; full_tensor {tuple(model[0].weight.full_tensor().shape)}"
        elif then == "state_dict":
            from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

            sd = get_model_state_dict(model, options=StateDictOptions(full_state_dict=True, cpu_offload=True))
            msg += f"; full state dict of {len(sd)} tensors on rank {rank}"
        return msg

    # the training step, then the two ways to a whole tensor: DTensor's
    # full_tensor and torch.distributed.checkpoint's full state dict
    case("fsdp2_shard", lambda: fsdp((world,)))
    case("fsdp2_full_tensor", lambda: fsdp((world,), "full_tensor"))
    case("fsdp2_state_dict", lambda: fsdp((world,), "state_dict"))
    if world == 4:
        case("fsdp2_hybrid_2x2", lambda: fsdp((2, 2)))

    def partial_seconds():
        t = torch.ones(16384, 1536, device=dev)
        dist.all_reduce(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3

    case("all_reduce_fp32_16384x1536_s", partial_seconds)
    dist.barrier()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    import tempfile

    import torch.multiprocessing as mp

    world = int(sys.argv[sys.argv.index("--world") + 1]) if "--world" in sys.argv else 2
    # --only a,b: the cases whose names start with a or b (a crash ends the
    # run, so the cases after it are probed by their own runs)
    only = sys.argv[sys.argv.index("--only") + 1].split(",") if "--only" in sys.argv else []
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, world {world}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "probe.json")
        mp.start_processes(_rank, args=(world, _free_port(), out, only), nprocs=world, join=True, start_method="spawn")
        with open(out) as f:
            print(json.dumps({"gloo_cuda": {"world": world} | json.load(f)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Ranks of the port's multi-process tests, and the helpers that spawn them.

``spawn`` starts one process per argv on the CPU with the env:// variables
that ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT`` on a free port), waits for every rank and
only then asserts, printing every rank's stderr: when one rank dies, the
others fail at their next collective, and the first traceback is the one to
read.

Run as a script (``python tests/torch_mp_worker.py <case> <dir> ...``) it
is one rank of a case:

* ``dit_steps``: the DiT train step under DDP on this rank's slice of the
  global batch in ``<dir>/inputs.pt``, writing the final weights and EMA;
* ``cli <module>``: ``ldmae_tpu_torch.cli.<module>.main`` on the rest of
  the arguments, without TensorBoard;
* ``gloo_cli <module>``: the same under a gloo group started first (two
  ranks on one card);
* ``nccl_dit_steps``: on the card, the DiT step without a group and under
  DDP in an NCCL group of one;
* ``train_vmae_fp32``: ``cli.train_vmae.main`` with the step in float32
  (``vmae_step_in_fp32``);
* ``evaluate_tokenizer``: ``cli.evaluate_tokenizer.main`` with the rFID
  replaced by a count of the PNGs rank 0 sees (the FID's own tests are
  elsewhere; on the CPU it takes scipy's sqrtm of 2048 x 2048 matrices);
* ``tp_forward``: the DiT forward of ``<dir>/inputs.pt`` with its weights
  sharded over a tp group of every rank, one leg a dtype / quantization
  (and a control leg with w12 sharded contiguously, not gate-aligned), and
  the sampling chain of ``make_sample_fn`` from the given noise, writing
  each leg's output;
* ``fsdp_steps``: the DiT train step of ``<dir>/inputs.pt`` under FSDP2
  (``wrap_fsdp`` over a (dp, fsdp) mesh, ``--fsdp`` taken from the file),
  writing the full weights, EMA and AdamW state as a checkpoint holds them;
* ``tp_train``: the legs of ``<dir>/inputs.pt`` in turn, each on its own
  (dp, fsdp, tp) mesh over every rank: train steps (DDP over dp, or FSDP2
  over fsdp, on each tp slice), writing the gathered checkpoint, optionally
  with the gather's backward replaced by a reduce-scatter (a control); one
  backward whose gathered gradients rank 0 writes; or ``cli.train_dit`` on
  the leg's arguments.

Imports torch and the port only, so the GPU tests can use it where JAX is
not installed.
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argvs, timeout: float = 240, env=None):
    """Run ``python <argv>`` once a rank (rank r gets ``argvs[r]``); returns
    the ranks' stdout. Raises with every rank's output if any fails."""
    return join(start(argvs, env), timeout)


def start(argvs, env=None):
    """``spawn``'s ranks started, not waited for (``join`` waits): the caller
    computes its references meanwhile."""
    port, world = free_port(), len(argvs)
    procs = []
    for rank, argv in enumerate(argvs):
        e = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port), OMP_NUM_THREADS="2", PYTHONPATH=REPO)
        e.update(env or {})
        procs.append(subprocess.Popen([sys.executable, *argv], cwd=REPO, env=e, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    return procs


def join(procs, timeout: float = 240):
    """Wait for ``start``'s ranks; returns their stdout, or raises with every
    rank's output if any failed."""
    results = []
    for p in procs:
        try:
            results.append(p.communicate(timeout=timeout))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            results.append(p.communicate())
    if any(p.returncode != 0 for p in procs):
        report = "\n".join(f"--- rank {r} rc={p.returncode} ---\n{err[-4000:]}\n{out[-2000:]}"
                           for r, (p, (out, err)) in enumerate(zip(procs, results)))
        raise AssertionError(f"multi-process run failed:\n{report}")
    return [out for out, _ in results]


def _dit_steps(d: str) -> None:
    import torch

    from ldmae_tpu_torch.models import lightningdit as tdit
    from ldmae_tpu_torch.parallel import get_rank, get_world_size, init_distributed_mode, wrap_data_parallel
    from ldmae_tpu_torch.train import init_train_state, make_optimizer, make_train_step
    from ldmae_tpu_torch.transport import create_transport

    init_distributed_mode(device="cpu")
    rank, world = get_rank(), get_world_size()
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    model = tdit.LightningDiT(tdit.DiTSpec(**inp["dims"]), device="cpu")
    model.load_state_dict(inp["sd"])
    state = init_train_state(model, make_optimizer(model.parameters(), inp["lr"], inp["beta2"]))
    state.ddp = wrap_data_parallel(model, "cpu")
    step = make_train_step(model.spec, create_transport(**inp["transport"]), grad_accum=inp["accum"],
                           max_grad_norm=inp["clip"], **inp["impls"])
    m = inp["x"].shape[2] // world
    rows = slice(rank * m, (rank + 1) * m)
    gen = torch.Generator()
    losses = []
    for s in range(inp["x"].shape[0]):
        noise = {k: inp[k][s][:, rows] for k in ("x0", "t", "drop_ids") if k in inp}
        gen.manual_seed(1000 + s)
        out = step(state, {"x": inp["x"][s][:, rows], "y": inp["y"][s][:, rows]}, gen, **noise)
        losses.append(float(out["loss"]))
    torch.save({"model": model.state_dict(), "ema": state.ema.state_dict(), "losses": losses},
               os.path.join(d, f"rank{rank}.pt"))


def _evaluate_tokenizer(d: str, argv) -> None:
    from ldmae_tpu_torch.cli import evaluate_tokenizer

    def count_pngs(paths, **kw):
        # rank 0 alone calls it, once every rank's PNGs are written
        return float(sum(len([f for f in os.listdir(p) if f.endswith(".png")]) for p in paths))

    evaluate_tokenizer.calculate_fid_given_paths = count_pngs
    reports = evaluate_tokenizer.main(argv)
    with open(os.path.join(d, f"reports_rank{os.environ['RANK']}.json"), "w") as f:
        json.dump(reports, f)


def _cli(module: str, argv) -> None:
    """A CLI's ``main(argv)``, without TensorBoard (importing it pulls in
    TensorFlow on some images, seconds of start-up a rank)."""
    import importlib

    sys.modules["torch.utils.tensorboard"] = None
    importlib.import_module(f"ldmae_tpu_torch.cli.{module}").main(argv)


def _gloo_cli(module: str, argv) -> None:
    """``_cli`` under a gloo group started first: two ranks can share one
    card (NCCL refuses two ranks on one device); the CLI's own
    ``init_distributed_mode`` then returns at once."""
    from ldmae_tpu_torch.parallel import init_distributed_mode

    init_distributed_mode(backend="gloo")
    _cli(module, argv)


def _nccl_dit_steps(d: str) -> None:
    """On the card: the DiT train step of ``<dir>/inputs.pt`` without a
    process group, then from the same weights under DDP in an NCCL group of
    one (tcp on ``MASTER_PORT``); writes both results."""
    import torch

    from ldmae_tpu_torch.models import lightningdit as tdit
    from ldmae_tpu_torch.parallel import init_distributed_mode, wrap_data_parallel
    from ldmae_tpu_torch.train import init_train_state, make_optimizer, make_train_step
    from ldmae_tpu_torch.transport import create_transport

    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    dev = torch.device("cuda", 0)
    out = {}
    for leg in ("plain", "ddp"):
        if leg == "ddp":
            init_distributed_mode(backend="nccl", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
                                  world_size=1, rank=0, local_rank=0)
        model = tdit.LightningDiT(tdit.DiTSpec(**inp["dims"]), device=dev)
        model.load_state_dict(inp["sd"])
        state = init_train_state(model, make_optimizer(model.parameters(), inp["lr"], inp["beta2"]))
        if leg == "ddp":
            state.ddp = wrap_data_parallel(model, dev)
        step = make_train_step(model.spec, create_transport(**inp["transport"]), grad_accum=inp["accum"],
                               max_grad_norm=inp["clip"], **inp["impls"])
        gen = torch.Generator(device=dev)
        for s in range(inp["x"].shape[0]):
            gen.manual_seed(1000 + s)
            step(state, {"x": inp["x"][s].to(dev), "y": inp["y"][s].to(dev)}, gen)
        out[leg] = {k: v.cpu() for k, v in model.state_dict().items()}
    torch.save(out, os.path.join(d, "nccl.pt"))


def tp_model(inp: dict, leg: dict, group):
    """The leg's DiT for sampling (half-split RoPE, quantized if the leg
    says so) with this rank's slices kept; ``leg["control"]``: w12 then
    holds contiguous rows of the packed [w1; w2] instead of its
    gate-aligned rows."""
    import torch

    from ldmae_tpu_torch.models import LightningDiT, permute_qk_for_half_rope, quantize_dit_
    from ldmae_tpu_torch.models import lightningdit as tdit
    from ldmae_tpu_torch.parallel import shard_dit_for_tp_

    spec = tdit.DiTSpec(**inp["dims"])
    model = LightningDiT(spec, device="cpu")
    model.load_state_dict(permute_qk_for_half_rope(inp["sd"], spec))
    if leg["quant"]:
        quantize_dit_(model)
    full_w12 = [b.mlp.w12.state_dict() for b in model.blocks]
    shard_dit_for_tp_(model, group)
    if leg.get("control"):
        n, r = torch.distributed.get_world_size(group), torch.distributed.get_rank(group)
        for blk, full in zip(model.blocks, full_w12):
            rows = full[next(iter(full))].shape[0] // n
            blk.mlp.w12.load_state_dict({k: v[r * rows:(r + 1) * rows] for k, v in full.items()})
    return model


def _tp_forward(d: str) -> None:
    import torch

    from ldmae_tpu_torch.eval.sampling import make_sample_fn
    from ldmae_tpu_torch.parallel import create_mesh, get_rank, init_distributed_mode
    from ldmae_tpu_torch.transport import create_transport

    init_distributed_mode(device="cpu")
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    group = create_mesh(dp=1, tp=int(os.environ["WORLD_SIZE"])).get_group("tp")
    out = {}
    for leg in inp["legs"]:
        model = tp_model(inp, leg, group)
        dt = getattr(torch, leg["dtype"])
        kw = dict(compute_dtype=dt, quant_mode=leg["quant"], **inp["impls"])
        with torch.no_grad():
            out[leg["name"]] = model(inp["x"], inp["t"].to(dt), inp["y"], **kw)
        if leg.get("chain"):
            fn = make_sample_fn(model.spec, create_transport(), device="cpu", **inp["chain"], **kw)
            out[leg["name"] + "_chain"] = fn({"dit": model, "vae": None}, inp["y_chain"], z=inp["z"])
    torch.save(out, os.path.join(d, f"rank{get_rank()}.pt"))


def _fsdp_steps(d: str) -> None:
    import torch

    from ldmae_tpu_torch.models import lightningdit as tdit
    from ldmae_tpu_torch.parallel import create_mesh, get_rank, get_world_size, init_distributed_mode
    from ldmae_tpu_torch.train import init_sharded_train_state, make_optimizer, make_train_step, save_checkpoint
    from ldmae_tpu_torch.transport import create_transport

    init_distributed_mode(device="cpu")
    rank, world = get_rank(), get_world_size()
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    mesh = create_mesh(dp=-1, fsdp=inp["fsdp"], device_type="cpu")
    model = tdit.LightningDiT(tdit.DiTSpec(**inp["dims"]), device="cpu")
    model.load_state_dict(inp["sd"])
    state = init_sharded_train_state(model, mesh, lambda p: make_optimizer(p, inp["lr"], inp["beta2"]))
    step = make_train_step(model.spec, create_transport(**inp["transport"]), grad_accum=inp["accum"],
                           max_grad_norm=inp["clip"], **inp["impls"])
    m = inp["x"].shape[2] // world
    rows = slice(rank * m, (rank + 1) * m)
    gen = torch.Generator()
    for s in range(inp["x"].shape[0]):
        gen.manual_seed(1000 + s)
        step(state, {"x": inp["x"][s][:, rows], "y": inp["y"][s][:, rows]}, gen)
    save_checkpoint(d, state)  # the full model, EMA and AdamW state, as one process writes them


def _reduce_scatter_backward(ctx, g):
    """The control's backward of ``gather_from_tp``: a reduce-scatter of the
    replicated gradient (so every slice comes back multiplied by n)."""
    import torch.distributed as dist

    from ldmae_tpu_torch.parallel.distributed import group_all_reduce_

    n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
    return group_all_reduce_(g.contiguous().clone(), ctx.group).chunk(n, dim=ctx.dim)[r].contiguous(), None, None


def _tp_train(d: str) -> None:
    import torch

    from ldmae_tpu_torch.models import lightningdit as tdit
    from ldmae_tpu_torch.parallel import (all_gather_tp_state, create_mesh, data_index, data_world, get_rank,
                                          init_distributed_mode, tp_group_of, wrap_data_parallel)
    from ldmae_tpu_torch.parallel import distributed
    from ldmae_tpu_torch.train import dit_loss, init_sharded_train_state, make_optimizer, make_train_step
    from ldmae_tpu_torch.train import save_checkpoint
    from ldmae_tpu_torch.transport import create_transport

    init_distributed_mode(device="cpu")
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    real_backward = distributed._GatherFromTP.backward
    for leg in inp["legs"]:
        if leg["kind"] == "cli":
            _cli("train_dit", leg["argv"])
            continue
        mesh = create_mesh(dp=leg["dp"], fsdp=leg["fsdp"], tp=leg["tp"], device_type="cpu")
        src = inp[leg["kind"]]
        model = tdit.LightningDiT(tdit.DiTSpec(**src["dims"]), device="cpu")
        model.load_state_dict(src["sd"])
        state = init_sharded_train_state(model, mesh, lambda p: make_optimizer(p, inp["lr"], inp["beta2"]))
        transport = create_transport(**src["transport"])
        if leg["kind"] == "grads":  # one backward on the whole batch, the gradients gathered
            loss = dit_loss(model, transport, src["x1"], src["y"], x0=src["x0"], t=src["t"], drop_ids=src["drop"],
                            **src["impls"])
            loss.backward()
            grads = all_gather_tp_state({n: p.grad for n, p in model.named_parameters()}, model.spec,
                                        tp_group_of(model))
            if get_rank() == 0:
                torch.save({"loss": float(loss.detach()), "grads": grads}, os.path.join(d, f"{leg['name']}.pt"))
            continue
        if leg["fsdp"] == 1:
            state.ddp = wrap_data_parallel(model, "cpu", mesh["dp"].get_group())
        step = make_train_step(model.spec, transport, grad_accum=inp["accum"], max_grad_norm=inp["clip"],
                               **src["impls"])
        m = src["x"].shape[2] // data_world(leg["tp"])
        rows = slice(data_index(leg["tp"]) * m, (data_index(leg["tp"]) + 1) * m)
        gen = torch.Generator()
        if leg.get("control"):
            distributed._GatherFromTP.backward = _reduce_scatter_backward
        try:
            for s in range(src["x"].shape[0]):
                gen.manual_seed(1000 + s)
                step(state, {"x": src["x"][s][:, rows], "y": src["y"][s][:, rows]}, gen)
        finally:
            distributed._GatherFromTP.backward = real_backward
        save_checkpoint(os.path.join(d, leg["name"]), state)  # gathered over fsdp and tp: the one-process file


def vmae_step_in_fp32(train_vmae) -> None:
    """``cli.train_vmae`` with its train step computing in float32 (the CLI
    runs bf16): then two runs that split a batch differently agree to the
    float32 summation order."""
    import torch

    real = train_vmae.make_vmae_train_step
    train_vmae.make_vmae_train_step = lambda *a, **kw: real(*a, **(kw | {"compute_dtype": torch.float32}))


if __name__ == "__main__":
    case, d = sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else ""
    if case == "cli":
        _cli(d, sys.argv[3:])
    elif case == "gloo_cli":
        _gloo_cli(d, sys.argv[3:])
    elif case == "nccl_dit_steps":
        _nccl_dit_steps(d)
    elif case == "train_vmae_fp32":
        from ldmae_tpu_torch.cli import train_vmae

        vmae_step_in_fp32(train_vmae)
        _cli("train_vmae", sys.argv[2:])
    elif case == "dit_steps":
        _dit_steps(d)
    elif case == "fsdp_steps":
        _fsdp_steps(d)
    elif case == "tp_train":
        _tp_train(d)
    elif case == "tp_forward":
        _tp_forward(d)
    elif case == "evaluate_tokenizer":
        _evaluate_tokenizer(d, sys.argv[3:])
    else:
        raise SystemExit(f"unknown case {case!r}")

"""DiT training CLI (port of ``ldmae_tpu/cli/train_dit.py``).

Loads a reference-layout YAML, builds the model (reference initialisation,
or a warm start from the ``model`` weights of a ``.pt`` named by
``train.weight_init``), the transport and AdamW, streams latent shards, and
runs the train step, logging ``(step=NNNNNNN) Train Loss: x, Train
Steps/Sec: y`` with TFLOP/s and MFU every ``log_every`` steps to stderr and
``<exp_dir>/log.txt`` (and TensorBoard when it imports). It checkpoints
every ``ckpt_every`` steps, on SIGTERM/SIGINT and at the end, and resumes
from the latest checkpoint ("resumed from step N"). With ``rope_layout:
half`` the q/k channels are permuted to the half-split layout for training
and back on export, so checkpoints are in the canonical layout.

It runs on the card unless ``--device cpu`` is given. Across processes
(``torchrun``, SLURM or Open MPI; ``--dp`` defaults to the world size) the
model runs in ``DistributedDataParallel``: each micro-batch of the global
batch is split over the ranks (``micro // world`` each), rank r reads every
world-th latent from r with the resume offset of its own stream, the noise
is the global batch's rows (``train.train_dit.make_train_step``), the logged
loss is the mean over the ranks, the TFLOP/s and MFU count the global batch
over every rank's card, and rank 0 alone logs, writes TensorBoard and the
checkpoints (the EMA and weights of the module itself, so a checkpoint is a
one-process run's). A signal on any rank stops every rank at the same step
with a checkpoint. A background thread reads the next batch.

``--fsdp N`` (with ``--dp`` x N = the world size) shards the model, its
gradients, the EMA and the AdamW state over N ranks with FSDP2
(``parallel.wrap_fsdp``; with ``--dp`` above 1 hybrid sharding, replicated
over dp) in place of DDP. The batch is split over (dp, fsdp) jointly, as in
the JAX step, so each rank reads, draws and steps as under DDP, and the
checkpoints are the full state dicts a one-process run writes (every rank
takes part in gathering them; rank 0 writes), so a run resumes across
``--fsdp`` settings. ``--fsdp N`` at a world size that N does not divide
raises the JAX ``create_mesh``'s AssertionError.

``--tp N`` shards every block over a group of N consecutive ranks
(``parallel.shard_dit_for_tp_``, the JAX tp rules: a rank's heads, its
slice of the MLP's hidden dim and of adaLN's outputs, proj and w3
row-parallel), after every rank has built and seeded the whole model alike.
The ranks of a tp group read the same rows and draw the same noise (their
data index is ``rank // N`` among ``world // N``), with DDP over the dp
ranks, or with ``--fsdp`` FSDP2 over the fsdp ranks of each tp slice
(fsdp x tp). Checkpoints stay the one-process file (gathered over fsdp and
tp; a restore slices), so a run resumes across ``--tp`` settings. A JAX
run continues here from the same YAML once ``scripts/convert_orbax.py dit``
(run in the JAX environment) has written ``checkpoints/<step:07d>.pt``
beside its Orbax step, with the weights, the EMA, AdamW's moments and the
step; an Orbax step later than every ``.pt`` raises and names the script
(``train.state``).

``--profile_dir`` writes a ``torch.profiler`` trace (CPU and CUDA
activities, one Chrome / TensorBoard file a rank) of steps
[``--profile_start``, ``--profile_start`` + ``--profile_steps``) of the
run's step counter, closed early at ``max_steps`` or on a signal, as the JAX
CLI traces.

Usage:
    python -m ldmae_tpu_torch.cli.train_dit --config configs/imagenet/lightningdit_b_vmae_f8d16.yaml
    torchrun --nproc_per_node 8 -m ldmae_tpu_torch.cli.train_dit --config ....yaml
    torchrun --nproc_per_node 8 -m ldmae_tpu_torch.cli.train_dit --config ....yaml --dp 2 --fsdp 4
    torchrun --nproc_per_node 8 -m ldmae_tpu_torch.cli.train_dit --config ....yaml --dp 2 --fsdp 2 --tp 2
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import time
from typing import Any, Dict, List, Optional

import torch

from ..core.config import LDMAEConfig
from ..core.device import resolve_device
from ..data.latent_dataset import ImgLatentDataset
from ..models.lightningdit import LightningDiT, permute_qk_for_half_rope
from ..parallel import (all_reduce_sum, any_rank, barrier, create_mesh, data_index, data_world, get_rank,
                        get_world_size, init_distributed_mode, wrap_data_parallel)
from ..train.state import init_sharded_train_state, init_train_state, restore_checkpoint, save_checkpoint
from ..train.train_dit import COMPUTE_DTYPES, build_from_config, evaluate_step, make_optimizer
from ..utils.prefetch import Prefetcher
from ..utils.profiling import TraceWindow, dit_forward_flops, format_tflops_mfu, resolve_peak_flops


def setup_logger(exp_dir: str) -> logging.Logger:
    """Timestamped lines to stderr and ``<exp_dir>/log.txt``, on rank 0 (the
    other ranks' logger has no handler and prints nothing)."""
    os.makedirs(exp_dir, exist_ok=True)
    logger = logging.getLogger("ldmae_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    if get_rank() != 0:
        logger.addHandler(logging.NullHandler())
        return logger
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter("[\033[34m%(asctime)s\033[0m] %(message)s", datefmt="%Y-%m-%d %H:%M:%S"))
    fh = logging.FileHandler(os.path.join(exp_dir, "log.txt"))
    fh.setFormatter(logging.Formatter("[%(asctime)s] %(message)s"))
    logger.addHandler(sh)
    logger.addHandler(fh)
    return logger


def warm_start_(model: LightningDiT, path: str) -> int:
    """Load the ``model`` weights of a reference ``.pt`` (canonical layout)
    where the shapes match, the rest keeping their initialisation; a wider
    patch embedding is cut to the model's input channels. Returns the number
    of tensors loaded."""
    # a checkpoint is a trusted file the user points at, as in the JAX CLI
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = dict(ckpt["model"] if "model" in ckpt else ckpt)
    c = model.spec.in_channels
    w = sd.get("x_embedder.proj.weight")
    if w is not None and w.shape[1] > c:
        sd["x_embedder.proj.weight"] = w[:, :c]
    own = model.state_dict()
    keep = {k: v for k, v in sd.items() if k in own and tuple(own[k].shape) == tuple(v.shape)}
    model.load_state_dict(keep, strict=False)
    return len(keep)


def _data_dir(config: LDMAEConfig) -> str:
    path = config.data.data_path
    if config.data.sample and not path.endswith("_sample") and os.path.isdir(path + "_sample"):
        path += "_sample"  # the reference's naming of moment-latent shards
    return path


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train as the config says; returns {"state", "history", "exp_dir"}:
    the final TrainState and one record per log line (step, loss, grad_norm,
    steps_per_sec, seconds)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--dp", type=int, default=-1, help="data-parallel ranks (-1: the world size)")
    parser.add_argument("--fsdp", type=int, default=1,
                        help="ranks the parameters, gradients, EMA and AdamW state are sharded over (FSDP2)")
    parser.add_argument("--tp", type=int, default=1,
                        help="ranks (consecutive) each block's heads and hidden dims are split over")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace (Chrome / TensorBoard) of --profile_steps steps here")
    parser.add_argument("--profile_start", type=int, default=10, help="optimizer step at which the trace starts")
    parser.add_argument("--profile_steps", type=int, default=5, help="number of steps to trace")
    parser.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    parser.add_argument("--peak_tflops", type=float, default=None,
                        help="peak bf16 TFLOP/s of the device for the MFU log (default: from the "
                             "CUDA device name; unknown devices log 'MFU n/a')")
    args = parser.parse_args(argv)
    # the rendezvous (torchrun, SLURM or Open MPI environment) before any
    # device work; a no-op for one process
    init_distributed_mode(device=args.device)
    device = resolve_device(args.device)
    # checks the degrees against the world (the JAX assertions); FSDP's mesh
    # is on the parameters' device type
    mesh = create_mesh(dp=args.dp, fsdp=args.fsdp, tp=args.tp, device_type=device.type if args.fsdp > 1 else None)
    rank, world = get_rank(), get_world_size()
    # this rank's share of the batch (the ranks of a tp group share one)
    shard, shards = data_index(args.tp), data_world(args.tp)

    config = LDMAEConfig.from_yaml(args.config)
    if args.max_steps is not None:
        config.train.max_steps = args.max_steps
    tc = config.train
    exp_dir = os.path.join(tc.output_dir, tc.exp_name)
    logger = setup_logger(exp_dir)
    logger.info(f"Experiment directory: {exp_dir}")
    logger.info(f"device: {device}" + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else "")
                + f", {world} process(es)" + (f", FSDP over {args.fsdp} ranks" if args.fsdp > 1 else "")
                + (f", tp {args.tp} (each block split over {args.tp} ranks)" if args.tp > 1 else ""))

    writer = None
    if rank == 0:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(os.path.join(exp_dir, "tensorboard"))
        except ImportError:
            logger.info("tensorboard unavailable; scalar logs go to log.txt only")

    spec, model, transport, step_fn = build_from_config(
        config, device, torch.Generator().manual_seed(tc.global_seed))
    # the warm start precedes the half-RoPE permutation: imported weights are
    # in the canonical layout
    if tc.weight_init:
        n = warm_start_(model, tc.weight_init)
        logger.info(f"warm-started {n} tensors from {tc.weight_init}")
    half = config.parallel.rope_layout == "half" and spec.use_rope
    if half:
        model.load_state_dict(permute_qk_for_half_rope(model.state_dict(), spec), strict=True)
        logger.info("using half-split RoPE layout (checkpoints are saved in the canonical one)")
    opt = config.optimizer
    if args.fsdp > 1 or args.tp > 1:
        state = init_sharded_train_state(model, mesh, lambda params: make_optimizer(params, opt.lr, opt.beta2))
    else:
        state = init_train_state(model, make_optimizer(model.parameters(), opt.lr, opt.beta2))
    if restore_checkpoint(exp_dir, state, half_rope=half) is not None:
        logger.info(f"resumed from step {state.step}")

    if args.fsdp == 1:  # DDP whenever a process group exists, over the dp ranks
        state.ddp = wrap_data_parallel(model, device, mesh["dp"].get_group() if args.tp > 1 else None)

    def load_dataset():
        return ImgLatentDataset(_data_dir(config), latent_norm=config.data.latent_norm,
                                latent_multiplier=config.data.latent_multiplier,
                                sample=config.data.sample, seed=tc.global_seed)

    # rank 0 first: where latents_stats.pt is missing it computes and writes
    # it, and then every rank reads it. Computing the statistics draws from
    # the dataset's generator, which also picks each latent's flip, so rank
    # 0 then builds its dataset again: the ranks of a tp group must read the
    # same latents
    dataset = load_dataset() if rank == 0 else None
    barrier("train_dit_stats")
    if world > 1 or dataset is None:
        dataset = load_dataset()
    logger.info(f"dataset: {len(dataset)} latents from {_data_dir(config)}")
    accum = tc.gradient_accumulation_steps
    micro = tc.global_batch_size // accum
    assert micro % shards == 0, f"per-accum batch {micro} must divide across {shards} data shards"
    micro_local = micro // shards  # this rank's slice of each micro-batch
    # resume the data stream where the restored step left off (each epoch
    # reshuffles with seed + epoch, so the step maps to an exact position);
    # data index i reads every shards-th latent from i
    n_host = len(range(shard, len(dataset), shards))
    per_epoch = max(n_host // (micro_local * accum), 1)
    batches = Prefetcher(dataset.iter_batches(
        micro_local * accum, shuffle=True, seed=tc.global_seed, process_index=shard, process_count=shards,
        start_epoch=state.step // per_epoch, skip_batches=state.step % per_epoch), buffer_size=4)

    cd = COMPUTE_DTYPES[config.parallel.compute_dtype]
    val_batch = None
    if config.data.valid_path and os.path.isdir(config.data.valid_path):
        vds = ImgLatentDataset(config.data.valid_path, latent_norm=config.data.latent_norm,
                               latent_multiplier=config.data.latent_multiplier, sample=config.data.sample)
        raw = next(vds.iter_batches(min(micro_local, len(vds)), shuffle=False, epochs=1, drop_last=False))
        val_batch = {k: torch.from_numpy(v).to(device) for k, v in raw.items()}

    step_flops = 3 * dit_forward_flops(spec, tc.global_batch_size)  # forward + ~2x backward, global batch
    peak = resolve_peak_flops(args.peak_tflops, device)
    peak = peak * world if peak else None  # every rank's card
    stop_signal: List[int] = []

    def request_stop(signum, frame):
        if stop_signal:  # a second signal: give up on the graceful path
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
        stop_signal.append(signum)

    def save(what: str) -> None:
        path = save_checkpoint(exp_dir, state, config=config.to_dict(), half_rope=half)
        logger.info(f"Saved {what}checkpoint to {path}")

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, request_stop)
        except ValueError:
            pass  # not the main thread (embedded use)
    gen = torch.Generator(device=device)
    trace = TraceWindow(args.profile_dir, args.profile_start, args.profile_steps, device, logger.info)
    history: List[Dict[str, float]] = []
    pending, log_steps = [], 0
    logger.info(f"training for {tc.max_steps} steps (global_batch={tc.global_batch_size}, accum={accum})")
    start = time.time()
    try:
        while state.step < tc.max_steps:
            host = next(batches)
            x = torch.from_numpy(host["x"]).to(device).reshape(accum, micro_local, *host["x"].shape[1:])
            y = torch.from_numpy(host["y"]).to(device).reshape(accum, micro_local)
            # one seed per step, alike on every rank, so a resumed run draws
            # its noise, t and label dropout as the uninterrupted one would
            gen.manual_seed((tc.global_seed + 1) * 1_000_003 + state.step)
            trace.before_step(state.step)
            metrics = step_fn(state, {"x": x, "y": y}, gen)
            trace.after_step(state.step)
            pending.append(torch.stack([metrics["loss"], metrics["grad_norm"]]))
            log_steps += 1

            if state.step % tc.log_every == 0:
                # the mean over this rank's steps (synchronises), then over the ranks
                loss, gnorm = all_reduce_sum(torch.stack(pending).mean(0).double().cpu().numpy()) / world
                dt = time.time() - start
                logger.info(f"(step={state.step:07d}) Train Loss: {loss:.4f}, Train Steps/Sec: "
                            f"{log_steps / dt:.2f}, " + format_tflops_mfu(step_flops * log_steps, dt, peak)
                            + f", Grad Norm: {gnorm:.4f}")
                history.append(dict(step=state.step, loss=loss, grad_norm=gnorm,
                                    steps_per_sec=log_steps / dt, seconds=dt))
                if writer is not None:
                    writer.add_scalar("Loss/train", loss, state.step)
                    writer.add_scalar("Perf/tflops", step_flops * log_steps / dt / 1e12, state.step)
                pending, log_steps, start = [], 0, time.time()

            # a signal on any rank stops every rank at this step (the
            # checkpoint is collective: rank 0 writes, all wait)
            if any_rank(bool(stop_signal)):
                trace.close()  # flush a trace in flight
                logger.info(f"received signal {stop_signal[0] if stop_signal else 'on another rank'}; saving a "
                            f"preemption checkpoint at step {state.step}")
                save("preemption ")
                break

            if state.step % tc.ckpt_every == 0:
                save("")
                # under FSDP or tp every rank runs the sharded forward (its
                # collectives take every rank); rank 0 logs
                if val_batch is not None and (rank == 0 or args.fsdp > 1 or args.tp > 1):
                    val = float(evaluate_step(
                        state.model, transport, val_batch, torch.Generator(device=device).manual_seed(0),
                        compute_dtype=cd, attn_impl=config.parallel.train_attention_impl,
                        rope_layout=config.parallel.rope_layout))
                    logger.info(f"Validation Loss: {val:.4f}")  # rank 0's logger alone prints
                    if writer is not None:
                        writer.add_scalar("Loss/validation", val, state.step)
        else:
            trace.close()  # max_steps ended inside the trace window
            save("final ")
    finally:  # an embedding program gets its own handlers back
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        if writer is not None:
            writer.close()
    return {"state": state, "history": history, "exp_dir": exp_dir}


if __name__ == "__main__":
    main()

"""VMAE tokenizer training CLI (port of ``ldmae_tpu/cli/train_vmae.py``).

The reference recipe (``scripts/train_ae.sh``) runs it twice:

  * stage 1, masked pretraining at 128^2: ``--batch_size 128 --accum_iter 2
    --mask_ratio 0.25 --visible_loss_ratio 0.75 --no_cls --smooth_output
    --perceptual_loss_ratio 0.5 --fixed_std 1e-3 --kl_loss_weight 1e-6``;
  * stage 2 is ``cli.pe_reset`` (the port's tables are recomputed for any
    resolution, so stage 3 can take the stage-1 checkpoint as it is);
  * stage 3, decoder tuning at 256^2: ``--batch_size 16 --accum_iter 16
    --mask_ratio 0 --perceptual_loss_ratio 10 --kl_loss_weight 0
    --tune_decoder --resume <stage 1>/checkpoints/checkpoint-90.pth``.

Flags and defaults are the JAX CLI's. lr = blr x effective batch / 256 with
a per-step half-cosine schedule; images are cropped, resized and flipped on
a thread pool (``data.augment.train_augment``, one ``default_rng`` per image
seeded from the run's data generator) one step ahead of the card, and
normalised on the device. Each epoch appends a JSON line of its mean
losses, lr, images/s, TFLOP/s and MFU to ``<output_dir>/log.txt`` (and
TensorBoard scalars when ``torch.utils.tensorboard`` imports). Checkpoints
(``<output_dir>/checkpoints/<step:07d>.pt``, with a ``checkpoint-<epoch>.pth``
link) are written at epochs 0, save_epochs, 2 save_epochs, ... and the last,
and on SIGTERM/SIGINT; a rerun resumes from this stage's latest, which
overrides ``--resume``. ``--resume x.pth`` merges a reference-layout
``model`` state dict (missing names and other shapes keep the
initialisation, and are printed).

``--gradual_resol`` trains stage 1 on the gradual-resolution model
(``models.vmae_variants.GradualVMAE``): the arch's patch halved, a token
downsample mid-encoder and an upsample mid-decoder, built from ``--seed``;
``--resume`` merges a gradual ``.pth`` of the reference's layout (the two
convolutions inside the block lists) the same way. It trains stage 1 only
(with ``--tune_decoder`` it raises ``ValueError``).

It runs on the card unless ``--device cpu`` is given. Across processes
(``torchrun``, SLURM or Open MPI; ``--dp`` defaults to the world size, and
another value must equal it) the model trains in
``DistributedDataParallel``: the effective batch (for the learning rate and
the epoch length) is batch_size x accum_iter x world, rank r loads the r-th
contiguous slice of each global batch (``local_batch_indices``) with the
image seeds a one-process run at the global batch draws for those images,
the masks and latent noise are the global batch's rows, and the epoch's
mean losses are averaged over the ranks; rank 0 alone writes log.txt,
TensorBoard, the checkpoints and their links. So with accum_iter 1 a run
on two ranks equals one process with ``--batch_size`` doubled.

``--profile_dir`` writes a ``torch.profiler`` trace (CPU and CUDA
activities, one Chrome / TensorBoard file a rank) of steps
[``--profile_start``, ``--profile_start`` + ``--profile_steps``) of this
run (counted from 0 at its start, as the JAX CLI counts them), closed early
at an epoch's end or on a signal.

Not ported (ROADMAP.md Queue 1 item 15): ``--resume`` of an Orbax directory
raises ``NotImplementedError`` and names the conversion route.

Usage:
    python -m ldmae_tpu_torch.cli.train_vmae --model mae_for_ldmae_f8d16_prev \\
        --data_path /data/imagenet/train --output_dir out/stage1 --input_size 128 ...
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..data.augment import train_augment
from ..data.images import ImageFolderDataset
from ..models.vmae import VMAE, init_vmae_weights_, load_vmae_weights_, vmae_spec
from ..models.vmae_variants import GradualVMAE, init_gradual_weights_
from ..parallel import any_rank, create_mesh, get_rank, get_world_size, init_distributed_mode, wrap_data_parallel
from ..train.state import TrainState, restore_checkpoint, save_checkpoint
from ..train.train_vmae import (
    METRIC_KEYS,
    VMAELoss,
    cosine_lr,
    lr_schedule,
    make_vmae_optimizer,
    make_vmae_train_step,
)
from ..utils.meters import all_reduce_mean
from ..utils.profiling import TraceWindow, resolve_peak_flops, vmae_forward_flops


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("VMAE pretraining")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--accum_iter", type=int, default=1)
    p.add_argument("--model", type=str, default="mae_vit_large_patch16")
    p.add_argument("--input_size", type=int, default=256)
    p.add_argument("--mask_ratio", type=float, default=0.75)
    p.add_argument("--visible_loss_ratio", type=float, default=0.5)
    p.add_argument("--norm_pix_loss", action="store_true")
    p.add_argument("--no_cls", action="store_true")
    p.add_argument("--kl_loss_weight", type=float, default=None)
    p.add_argument("--fixed_std", type=float, default=None)
    p.add_argument("--smooth_output", action="store_true")
    p.add_argument("--pred_with_conv", action="store_true")
    p.add_argument("--down_nonlinear", action="store_true")
    # LPIPS is on whenever the ratio is given; --use_lpips forces it at 1.0
    p.add_argument("--perceptual_loss_ratio", type=float, default=None)
    p.add_argument("--use_lpips", action="store_true")
    p.add_argument("--tune_decoder", action="store_true")
    p.add_argument("--gradual_resol", action="store_true",
                   help="gradual-resolution variant (halved patch, token down/upsample mid-encoder/decoder)")
    p.add_argument("--use_checkpoint", action="store_true", help="recompute each block in the backward")
    p.add_argument("--fixed_lr", action="store_true")
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--blr", type=float, default=1e-3)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--warmup_epochs", type=int, default=40)
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="./output_dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", type=str, default="")
    p.add_argument("--save_epochs", type=int, default=10)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--steps_per_epoch", type=int, default=None, help="override for small datasets / smoke runs")
    p.add_argument("--dp", type=int, default=-1, help="data-parallel ranks (-1: the world size)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace (Chrome / TensorBoard) of --profile_steps steps here")
    p.add_argument("--profile_start", type=int, default=10, help="step of this run at which the trace starts")
    p.add_argument("--profile_steps", type=int, default=5)
    p.add_argument("--peak_tflops", type=float, default=None,
                   help="peak bf16 TFLOP/s of the device for the MFU log (default: from the CUDA device "
                        "name; unknown devices log mfu null)")
    p.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    return p


def _refuse_unported(args) -> None:
    if args.gradual_resol and args.tune_decoder:
        raise ValueError("--gradual_resol trains stage 1; the decoder-tuning forward has no gradual form")
    if args.resume and os.path.isdir(args.resume):
        raise NotImplementedError(f"--resume {args.resume}: Orbax checkpoint directories are not read yet "
                                  "(ROADMAP.md Queue 1 item 15); name a .pth / .pt file")


def step_indices(order: np.ndarray, step: int, per_step: int) -> np.ndarray:
    """Global batch ``step`` of an epoch: ``order[step per_step:][:per_step]``,
    wrapping to the start of ``order`` when it runs out."""
    idx = order[(step * per_step) % len(order):][:per_step]
    if len(idx) < per_step:
        idx = np.concatenate([idx, order[: per_step - len(idx)]])
    return idx


def local_batch_indices(order: np.ndarray, step: int, per_step: int, process_index: int,
                        process_count: int) -> np.ndarray:
    """This process's slice of global batch ``step`` (the JAX CLI's rule): the
    global batch split into ``process_count`` contiguous equal parts."""
    local = per_step // process_count
    return step_indices(order, step, per_step)[process_index * local:(process_index + 1) * local]


def _link_epoch(path: str, epoch: int) -> None:
    """``checkpoint-<epoch>.pth`` beside the step checkpoint, a relative link
    (the reference's epoch naming, which train_ae.sh hands to stage 3)."""
    alias = os.path.join(os.path.dirname(path), f"checkpoint-{epoch}.pth")
    if os.path.lexists(alias):
        os.unlink(alias)
    os.symlink(os.path.basename(path), alias)


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Train as the flags say; returns {"state", "history", "output_dir"}:
    the final TrainState and one record per epoch (the log line's values)."""
    args = get_args_parser().parse_args(argv)
    _refuse_unported(args)
    # the rendezvous (torchrun, SLURM or Open MPI environment) before any
    # device work; a no-op for one process
    init_distributed_mode(device=args.device)
    create_mesh(dp=args.dp)  # checks the degree against the world
    rank, world = get_rank(), get_world_size()
    device = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)

    spec = vmae_spec(
        args.model, img_size=args.input_size, no_cls=args.no_cls, kl_loss_weight=args.kl_loss_weight,
        fixed_std=args.fixed_std, smooth_output=args.smooth_output, pred_with_conv=args.pred_with_conv,
        down_nonlinear=args.down_nonlinear, norm_pix_loss=args.norm_pix_loss,
        perceptual_loss_ratio=1.0 if args.perceptual_loss_ratio is None else args.perceptual_loss_ratio,
        ldmae_mode=args.tune_decoder, use_checkpoint=args.use_checkpoint,
    )
    if args.gradual_resol:
        # the reference halves the patch in the gradual model's constructor
        spec = dataclasses.replace(spec, patch_size=spec.patch_size // 2)
        model = init_gradual_weights_(GradualVMAE(spec, device=device), torch.Generator().manual_seed(args.seed))
    else:
        model = init_vmae_weights_(VMAE(spec, device=device), torch.Generator().manual_seed(args.seed))
    if args.resume:
        if not os.path.exists(args.resume):
            raise FileNotFoundError(f"--resume {args.resume}: not found")
        merged = load_vmae_weights_(model, args.resume)
        print(f"resumed weights from torch checkpoint {args.resume} "
              f"(missing={merged['missing']}, unexpected={merged['unexpected']})")

    eff_batch = args.batch_size * args.accum_iter * world  # the reference's batch x accum x world size
    lr = args.lr if args.lr is not None else args.blr * eff_batch / 256
    if rank == 0:
        print(f"actual lr: {lr:.2e}  effective batch size: {eff_batch}")
    dataset = ImageFolderDataset(args.data_path, args.input_size)
    per_step = eff_batch  # one update takes accum_iter micro-batches on every rank
    steps_per_epoch = args.steps_per_epoch or max(len(dataset) // per_step, 1)

    optimizer = make_vmae_optimizer(model, weight_decay=args.weight_decay, tune_decoder=args.tune_decoder)
    schedule = lr_schedule(steps_per_epoch, lr, args.min_lr, args.warmup_epochs, args.epochs, args.fixed_lr)
    perceptual = None
    if args.use_lpips or args.perceptual_loss_ratio is not None:
        from ..models.lpips import load_lpips, make_lpips_fn

        perceptual = make_lpips_fn(load_lpips(device))
    step_fn = make_vmae_train_step(
        schedule, mask_ratio=args.mask_ratio, visible_loss_ratio=args.visible_loss_ratio,
        tune_decoder=args.tune_decoder, perceptual_loss_fn=perceptual, compute_dtype=torch.bfloat16,
        grad_accum=args.accum_iter,
    )
    state = TrainState(step=0, model=model, ema=None, optimizer=optimizer)
    if restore_checkpoint(args.output_dir, state) is not None:
        # this stage's own checkpoint is later progress than a --resume warm start
        print(f"resumed from step {state.step}" + (" (overrides --resume warm start)" if args.resume else ""))
    state.ddp = wrap_data_parallel(VMAELoss(model), device)  # DDP whenever a process group exists

    gen = torch.Generator(device=device)
    data_rng = np.random.default_rng(args.seed)
    log_path = os.path.join(args.output_dir, "log.txt")
    writer = None
    if rank == 0:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(os.path.join(args.output_dir, "tensorboard"))
        except ImportError:
            pass

    def load_one(i: int, seed: int) -> np.ndarray:
        from PIL import Image

        with Image.open(dataset.samples[i][0]) as img:
            return train_augment(img, np.random.default_rng(seed), args.input_size, raw_uint8=True)

    def epoch_batches(pool, order, skip):
        """This rank's uint8 (per_step / world, H, W, 3) slices of the global
        batches; the next one loads while the caller trains on this one.
        Every rank draws the whole global batch's image seeds here, in order
        (so the stream does not depend on the threads), and keeps its
        slice's: each rank's images are a one-process run's at the global
        batch."""
        def submit(s):
            idx = local_batch_indices(order, s, per_step, rank, world)
            seeds = [int(data_rng.integers(2**31)) for _ in range(per_step)][rank * len(idx):(rank + 1) * len(idx)]
            return [pool.submit(load_one, int(i), seed) for i, seed in zip(idx, seeds)]

        pending = submit(skip) if skip < steps_per_epoch else None
        for s in range(skip, steps_per_epoch):
            futures, pending = pending, (submit(s + 1) if s + 1 < steps_per_epoch else None)
            yield np.stack([f.result() for f in futures])

    stop_signal: List[int] = []

    def request_stop(signum, frame):
        if stop_signal:  # a second signal: give up on the graceful path
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
        stop_signal.append(signum)

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, request_stop)
        except ValueError:
            pass  # not the main thread (embedded use)

    # forward + ~2x backward of the analytic forward; LPIPS is not counted
    # (the gradual model is counted as the JAX CLI counts it: its halved-patch
    # spec as a plain VMAE)
    step_flops = 3 * vmae_forward_flops(spec, per_step, mask_ratio=0.0 if args.tune_decoder else args.mask_ratio)
    peak = resolve_peak_flops(args.peak_tflops, device)
    epoch_lr = cosine_lr(lr, args.min_lr, args.warmup_epochs, args.epochs, args.fixed_lr)
    history: List[Dict[str, Any]] = []
    start_epoch, resume_skip = divmod(state.step, steps_per_epoch)
    trace = TraceWindow(args.profile_dir, args.profile_start, args.profile_steps, device,
                        print if rank == 0 else (lambda msg: None))
    run_steps = 0  # this run's steps: the trace window's counter
    try:
        with ThreadPoolExecutor(max_workers=args.num_workers) as pool:
            for epoch in range(start_epoch, args.epochs):
                sums = dict.fromkeys(METRIC_KEYS, 0.0)
                t0 = time.time()
                order = data_rng.permutation(len(dataset))
                n_steps = 0
                for imgs in epoch_batches(pool, order, resume_skip if epoch == start_epoch else 0):
                    x = torch.from_numpy(imgs).to(device).reshape(args.accum_iter, args.batch_size, *imgs.shape[1:])
                    # one seed per step: a resumed run draws as the uninterrupted one
                    gen.manual_seed((args.seed + 1) * 1_000_003 + state.step)
                    trace.before_step(run_steps)
                    metrics = step_fn(state, {"x": x}, gen)
                    run_steps += 1
                    trace.after_step(run_steps)
                    host = {k: float(v) for k, v in metrics.items()}
                    for k in METRIC_KEYS:
                        sums[k] += host[k]
                    n_steps += 1
                    if not host["loss_finite"]:
                        print(f"WARNING: non-finite loss at step {state.step} (update skipped)")
                    if any_rank(bool(stop_signal)):  # every rank stops at this step
                        trace.close()
                        path = save_checkpoint(args.output_dir, state, config=vars(args))
                        print(f"received signal {stop_signal[0] if stop_signal else 'on another rank'}; saved "
                              f"preemption checkpoint {path}")
                        return {"state": state, "history": history, "output_dir": args.output_dir}
                trace.close()  # the epoch ended inside the trace window
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                # the epoch's mean losses over the ranks (equal local batches)
                stats: Dict[str, Any] = {k: all_reduce_mean(v / max(n_steps, 1)) for k, v in sums.items()}
                stats["lr"] = epoch_lr(epoch + 0.5)  # the schedule at the epoch's midpoint
                stats.update(epoch=epoch, time=time.time() - t0)
                stats["img_per_sec"] = n_steps * per_step / stats["time"]
                stats["tflops"] = step_flops * n_steps / stats["time"] / 1e12
                stats["mfu"] = step_flops * n_steps / stats["time"] / (peak * world) if peak else None
                line = json.dumps({f"train_{k}": v for k, v in stats.items()})
                if rank == 0:
                    print(line)
                    with open(log_path, "a") as f:
                        f.write(line + "\n")
                history.append(stats)
                if writer is not None:
                    x_axis = int((epoch + 1) * 1000)  # the reference's epoch_1000x axis
                    for name, tb in (("loss", "train_loss"), ("vis_loss", "vis_loss"), ("mask_loss", "mask_loss"),
                                     ("kl_loss", "kl_loss"), ("p_loss", "p_loss"), ("lr", "lr")):
                        writer.add_scalar(tb, stats[name], x_axis)
                if epoch % args.save_epochs == 0 or epoch + 1 == args.epochs:
                    path = save_checkpoint(args.output_dir, state, config=vars(args))
                    if rank == 0:
                        _link_epoch(path, epoch)
                        print(f"saved checkpoint {path} (checkpoint-{epoch})")
    finally:  # an embedding program gets its own handlers back
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        if writer is not None:
            writer.close()
    return {"state": state, "history": history, "output_dir": args.output_dir}


if __name__ == "__main__":
    main()

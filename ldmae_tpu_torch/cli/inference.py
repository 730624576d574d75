"""Sampling CLI (reduced port of ``ldmae_tpu/cli/inference.py``).

Builds the sampling pipeline from a reference-layout YAML exactly as the JAX
CLI's ``_build_pipeline`` does (half-split RoPE layout, bf16, the
configured attention / adaLN / MLP impls, int8 quantization when
``parallel.quant`` or ``--quant`` asks for it), loads the DiT EMA weights from
``ckpt_path`` (a reference ``.pt``) when that file exists, and otherwise
uses seeded random weights (a directory, the JAX package's Orbax
checkpoint, raises and names its conversion); the tokenizer that ``vae.model_name`` names
(``models.tokenizers.build_tokenizer_fns``: the VMAE, the SD-VAE, VA-VAE or
MAR-VAE; an unknown name raises) from ``vae.weight_path`` (a path that names
no file raises, an empty one means seeded weights), which decodes under
``parallel.attention_impl``. Samples in the YAML's ``sample.mode`` (ODE or
SDE) and ``sample.sampling_method`` (ODE: euler, heun, rk4, dopri5 at
``Sampler.sample_ode``'s rtol/atol, as the JAX CLI runs it; SDE: euler,
heun). Writes PNGs (``--demo``: the reference's 2x4 demo grid).

After sampling (not with ``--demo`` or ``--skip_fid``) it computes the FID
of the samples against ``data.fid_reference_file`` where that file exists.
The latent statistics are ``latents_stats.pt`` in ``data.data_path``,
computed from the shards there where the file is missing.

Across processes (``torchrun``, SLURM or Open MPI; ``parallel.
init_distributed_mode``) rank r samples batches r, r + world, ... with
labels from ``default_rng(seed + rank)`` and noise seeded by the batch
index, the last batch cut to ``fid_num``; each rank logs ``[rank r] batch
i/n ...``; the FID runs on rank 0 after a barrier, and every rank waits for
it. The run resumes at batch granularity: a folder holding ``fid_num`` PNGs
is skipped whole before the pipeline is built, else every batch whose PNGs
are all on disk is skipped (its labels still drawn), and
``resume_manifest.json`` stops a resume whose batch size, world size, seed
or class count differ from the first leg's. PNGs are written by the native
encoder on a background thread, each renamed from a ``.tmp`` file.

``--tp N`` samples each batch on a group of N consecutive ranks, each
holding 1/N of the DiT's weights (``parallel.shard_dit_for_tp_``: heads,
the MLP's hidden dim and the adaLN outputs; the JAX CLI lays the same tp
axis over one process's devices, the port one process a card). Group g =
rank // N takes the batches g, g + world/N, ... with labels from
``default_rng(seed + g)``, so ``--tp 2`` at world 2 writes the names and
labels of world 1; every rank of the group runs the same DiT calls in the
same order, and only its first rank decodes (no collective there), writes
the PNGs and counts toward the FID. ``resume_manifest.json`` records tp.
At a world size that N does not divide the JAX CLI's warning is printed
and sampling runs at tp 1, as the JAX CLI does.

The JAX package's Orbax checkpoints are sampled through a conversion run in
the JAX environment: ``scripts/convert_orbax.py dit`` writes
``checkpoints/<step:07d>.pt`` beside the Orbax step, in the canonical RoPE
layout, and ``--ckpt`` takes that file (a directory as ``--ckpt`` raises
and names the script).

Usage:
    python -m ldmae_tpu_torch.cli.inference --config configs/imagenet/....yaml [--demo] [--quant w8a8]
    torchrun --nproc_per_node 8 -m ldmae_tpu_torch.cli.inference --config ....yaml
    torchrun --nproc_per_node 8 -m ldmae_tpu_torch.cli.inference --config ....yaml --tp 2
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from ..core.config import LDMAEConfig
from ..core.device import resolve_device
from ..data.latent_dataset import ImgLatentDataset
from ..data.native_io import write_pngs
from ..eval.sampling import DEMO_LABELS, make_sample_fn
from ..eval.save_npz import folder_name_from_config as folder_name
from ..models import LightningDiT, dit_spec, permute_qk_for_half_rope, quantize_dit_, seeded_init_
from ..models.tokenizers import build_tokenizer_fns
from ..parallel import (barrier, create_mesh, get_rank, get_world_size, group_all_reduce_, init_distributed_mode,
                        shard_dit_for_tp_)
from ..train.state import ORBAX_HINT
from ..transport import create_transport


def _load_checkpoint(path: str, key: str):
    # A checkpoint is a trusted file the user points at, as in the JAX
    # CLI; reference VMAE checkpoints pickle an argparse Namespace, so a
    # weights-only load would refuse them.
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt[key] if key in ckpt else ckpt


def build_pipeline(config: LDMAEConfig, ckpt_path=None, demo: bool = False, device=None):
    """(sample_fn, bundle, spec) for ``config``. ``demo`` applies the
    reference's demo overrides: CFG interval off, timestep shift 0. A
    checkpoint that is a directory (the JAX package's Orbax layout) raises
    ``NotImplementedError`` naming its conversion, before any model is
    built."""
    ckpt = ckpt_path or config.ckpt_path
    if ckpt and os.path.isdir(str(ckpt)):
        raise NotImplementedError(f"--ckpt {ckpt} is a directory (an Orbax checkpoint of the JAX package): "
                                  f"{ORBAX_HINT}")
    device = resolve_device(device)
    m, d = config.model, config.data
    spec = dit_spec(
        m.model_type,
        input_size=d.image_size // config.vae.downsample_ratio,
        in_channels=m.in_chans,
        num_classes=d.num_classes,
        class_dropout_prob=0.0 if d.num_classes == 1 else 0.1,
        learn_sigma=m.learn_sigma,
        use_qknorm=m.use_qknorm,
        use_swiglu=m.use_swiglu,
        use_rope=m.use_rope,
        use_rmsnorm=m.use_rmsnorm,
        wo_shift=m.wo_shift,
    )
    seed = config.train.global_seed
    dit = LightningDiT(spec, device=device)
    if ckpt and os.path.exists(str(ckpt)) and str(ckpt).endswith((".pt", ".pth")):
        sd = _load_checkpoint(str(ckpt), "ema")
    else:
        print(f"no DiT checkpoint at {ckpt!r}: using seeded random weights (seed {seed})")
        sd = seeded_init_(dit, seed).state_dict()
    # sampling always runs in the half-split RoPE layout, quantized after it
    dit.load_state_dict(permute_qk_for_half_rope(sd, spec), strict=True)
    quant = config.parallel.quant
    if quant:
        quantize_dit_(dit)

    # the tokenizer config.vae.model_name names; a path that names no file
    # raises, an empty one means seeded weights
    tok = build_tokenizer_fns(config.vae.model_name, config.vae.weight_path or "", d.image_size, device, seed + 1)

    # the training latents' statistics: latents_stats.pt, computed from the
    # shards (and saved) where it is missing
    latent_mean = latent_std = None
    if d.latent_norm and os.path.isdir(d.data_path):
        try:
            ds = ImgLatentDataset(d.data_path, latent_norm=True, sample=d.sample)
            latent_mean = torch.from_numpy(ds._latent_mean).float()
            latent_std = torch.from_numpy(ds._latent_std).float()
        except FileNotFoundError:  # a folder without shards
            pass

    t = config.transport
    transport = create_transport(t.path_type, t.prediction, t.loss_weight, t.train_eps, t.sample_eps)
    s, par = config.sample, config.parallel
    sample_fn = make_sample_fn(
        spec, transport,
        num_steps=s.num_sampling_steps,
        sampling_method=s.sampling_method,
        timestep_shift=0.0 if demo else s.timestep_shift,
        cfg_scale=s.cfg_scale,
        cfg_interval=not demo,
        cfg_interval_start=s.cfg_interval_start,
        cfg_channels=s.cfg_channels,
        truncation=s.truncation_bound,
        mode=s.mode,
        latent_multiplier=d.latent_multiplier,
        compute_dtype=torch.bfloat16,
        attn_impl=par.attention_impl,
        rope_layout="half",
        adaln_impl=par.adaln_impl,
        quant_mode=quant,
        mlp_impl=par.mlp_impl,
        vae_decode_images_fn=lambda vae, z: tok.decode_to_images(
            vae, z, compute_dtype=torch.bfloat16, attn_impl=par.attention_impl),
        device=device,
    )
    bundle = {"dit": dit, "vae": tok.model, "latent_mean": latent_mean, "latent_std": latent_std}
    return sample_fn, bundle, spec


def _write_png(img: np.ndarray, path: str) -> None:
    from PIL import Image

    tmp = path + ".tmp"
    Image.fromarray(img).save(tmp, format="PNG")
    os.replace(tmp, path)


class AsyncPngWriter:
    """The JAX CLI's PNG writer: one dispatcher thread hands each batch to
    the native encoder (``data.native_io.write_pngs``, its own threads), so
    the writes overlap the next batch's device work. Each image is written
    to ``<index>.png.tmp`` and renamed, so a kill mid-write never leaves a
    truncated ``.png`` (the batch-level resume takes any ``.png`` as
    complete). A failed write is raised by ``close``."""

    def __init__(self, out_dir: str, workers: int = 8):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir, self.workers = out_dir, workers
        self.q: "queue.Queue" = queue.Queue(maxsize=8)
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while True:
            item = self.q.get()
            if item is None:
                break
            if self.error is not None:
                continue  # drain; close() raises the first error
            images, indices = item
            try:
                names = [f"{int(i):06d}.png" for i in indices]
                tmp = [os.path.join(self.out_dir, n + ".tmp") for n in names]
                write_pngs(images, tmp, level=1, num_threads=self.workers)
                for t, n in zip(tmp, names):
                    os.replace(t, os.path.join(self.out_dir, n))
            except Exception as e:  # raised by close() on the caller's thread
                self.error = e

    def submit(self, images: np.ndarray, indices) -> None:
        self.q.put((np.ascontiguousarray(images), np.asarray(indices)))

    def close(self) -> None:
        self.q.put(None)
        self.thread.join()
        if self.error is not None:
            raise self.error


_MANIFEST_DEFAULTS = {"tp": 1}  # recorded only when it differs (the JAX CLI's file has no tp)


def _check_manifest(out_dir: str, stream_id: dict) -> None:
    """``resume_manifest.json``: the batch grid, world size, tp (when above
    1), seed and class count that the PNGs in ``out_dir`` were sampled
    under (the folder name pins the model, solver, CFG and shift, not
    these). A resume under other settings would mix two label streams, so it
    stops with the JAX CLI's message; rank 0 writes the file on the first
    leg."""
    path = os.path.join(out_dir, "resume_manifest.json")
    if os.path.exists(path):
        with open(path) as f:
            recorded = _MANIFEST_DEFAULTS | json.load(f)
        current = _MANIFEST_DEFAULTS | stream_id
        diff = {k: (recorded.get(k), v) for k, v in current.items() if recorded.get(k) != v}
        if diff:
            raise SystemExit(
                f"resume settings mismatch in {out_dir}: "
                + ", ".join(f"{k} was {a}, now {b}" for k, (a, b) in diff.items())
                + f" — existing pngs were sampled from a different "
                f"label stream; delete {path} (and the pngs) "
                f"to restart, or rerun with the recorded settings"
            )
    elif get_rank() == 0:
        os.makedirs(out_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(stream_id, f)
        os.replace(tmp, path)


def _tp_layout(tp: int, per_batch: int):
    """(tp, group, index in it, group id, groups) for ``--tp``: the JAX CLI's
    warning, and tp 1, where the world size is not a multiple of tp."""
    world = get_world_size()
    if tp > 1 and world % tp != 0:
        print(f"WARNING: --tp {tp} ignored (n_local={world}, per_proc_batch_size={per_batch} not divisible)")
        tp = 1
    if tp == 1:
        return 1, None, 0, get_rank(), world
    group = create_mesh(dp=-1, tp=tp).get_group("tp")  # tp innermost: ranks [g tp, (g + 1) tp)
    return tp, group, get_rank() % tp, get_rank() // tp, world // tp


def do_sample(config: LDMAEConfig, demo: bool = False, out_root=None, demo_out=None, device=None, tp: int = 1):
    """Sample (``demo``: the 2x4 grid, on rank 0's tp group) or write this
    rank's share of ``sample.fid_num`` PNGs; returns the output folder."""
    s = config.sample
    seed = config.train.global_seed
    per_batch = s.per_proc_batch_size
    tp, group, index, gid, groups = _tp_layout(tp, per_batch)
    lead = index == 0  # decodes, writes and counts toward the FID
    if demo:
        if gid != 0:
            return demo_out or "demo_images"
        sample_fn, bundle, _ = build_pipeline(config, demo=True, device=device)
        if group is not None:  # after build_pipeline's permutation and quantization
            shard_dit_for_tp_(bundle["dit"], group)
        device = resolve_device(device)
        y = torch.tensor(DEMO_LABELS if s.cfg_scale > 1.0 else [0] * 8)
        gen = torch.Generator(device=device).manual_seed(seed)
        imgs = sample_fn(bundle if lead else dict(bundle, vae=None), y, generator=gen)
        if not lead:
            return demo_out or "demo_images"
        imgs = imgs.cpu().numpy()
        grid = imgs.reshape(2, 4, *imgs.shape[1:]).transpose(0, 2, 1, 3, 4)
        grid = grid.reshape(2 * imgs.shape[1], 4 * imgs.shape[2], 3)
        demo_dir = demo_out or "demo_images"
        os.makedirs(demo_dir, exist_ok=True)
        ckpt_iter = os.path.basename(str(config.ckpt_path or "random"))
        ckpt_iter = ckpt_iter[:-3] if ckpt_iter.endswith(".pt") else os.path.splitext(ckpt_iter)[0]
        path = os.path.join(
            demo_dir,
            f"{os.path.basename(config.train.exp_name)}_cfg{s.cfg_scale}_{ckpt_iter}_demo_samples.png",
        )
        _write_png(grid, path)
        print(f"demo grid -> {path}")
        return demo_dir

    out_dir = os.path.join(
        out_root or os.path.join(config.train.output_dir, config.train.exp_name), folder_name(config)
    )
    fid_num = s.fid_num
    # the resume, before the pipeline is built: all-or-nothing when the
    # folder holds fid_num PNGs, else batch by batch below
    have = set()
    if os.path.isdir(out_dir):
        have = {int(f[:-4]) for f in os.listdir(out_dir) if f.endswith(".png") and f[:-4].isdigit()}
        # under tp the group decides together below: a rank returning here
        # alone would leave its partners waiting in a collective
        if len(have) >= fid_num and group is None:
            print(f"{out_dir} already has {len(have)} >= {fid_num} pngs, skipping")
            return out_dir
    _check_manifest(out_dir, {"per_proc_batch_size": int(per_batch), "world": int(get_world_size()),
                              **({"tp": tp} if tp > 1 else {}), "global_seed": int(seed),
                              "num_classes": int(config.data.num_classes)})

    # group g (rank g under tp 1) owns batches g, g + groups, ...; its labels
    # come from default_rng(seed + g), drawn for every batch it owns, sampled
    # or resumed, so a resumed run's label stream is the fresh run's
    n_batches = (fid_num + per_batch - 1) // per_batch
    rng = np.random.default_rng(seed + gid)
    owned = []
    for i in range(gid, n_batches, groups):
        y = rng.integers(0, config.data.num_classes, size=per_batch)
        indices = np.arange(i * per_batch, (i + 1) * per_batch)
        keep = indices < fid_num
        owned.append((i, y, indices[keep], bool(have) and all(int(j) in have for j in indices[keep])))
    if group is not None:
        # the group samples a batch when any of its ranks misses a PNG of it,
        # so its ranks make the same DiT calls in the same order
        missing = torch.tensor([not done for *_, done in owned], dtype=torch.int32,
                               device=resolve_device(device))
        missing = group_all_reduce_(missing, group, "max").tolist()
        owned = [(i, y, idx, not m) for (i, y, idx, _), m in zip(owned, missing)]
    todo = [(i, y, idx) for i, y, idx, done in owned if not done]
    skipped = sum(len(idx) for i, y, idx, done in owned if done)

    done = 0
    t0 = time.time()
    if todo:  # a group whose batches are all on disk builds nothing
        device = resolve_device(device)
        sample_fn, bundle, _ = build_pipeline(config, device=device)
        if group is not None:  # after build_pipeline's permutation and quantization
            shard_dit_for_tp_(bundle["dit"], group)
        if not lead:
            bundle = dict(bundle, vae=None)  # the latents alone: the first rank decodes
        writer = AsyncPngWriter(out_dir) if lead else None
        try:
            for i, y, indices in todo:
                gen = torch.Generator(device=device).manual_seed(seed * 100003 + i)
                tb = time.time()
                out = sample_fn(bundle, torch.from_numpy(y), generator=gen).cpu().numpy()
                dt = time.time() - tb
                if writer is not None:
                    writer.submit(out[:len(indices)], indices)
                done += len(indices)
                print(f"[rank {get_rank()}] batch {i + 1}/{n_batches} ({done} imgs, "
                      f"{done / (time.time() - t0):.2f} img/s, last {per_batch / dt:.2f} img/s"
                      + (f", {skipped} resumed" if skipped else "") + f") {time.strftime('%H:%M:%S')}",
                      flush=True)
        finally:
            if writer is not None:
                writer.close()
    dt = max(time.time() - t0, 1e-9)
    print(f"[rank {get_rank()}] sampling done: {done} generated" + (f" + {skipped} resumed" if skipped else "")
          + f" in {dt / 3600:.2f} h ({done / dt:.3f} img/s sustained incl. compile)"
          + ("" if lead else f" (tp rank {index}: no PNGs)"), flush=True)
    return out_dir


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True)
    parser.add_argument("--demo", action="store_true")
    parser.add_argument("--demo_out", default=None)
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--skip_fid", action="store_true")
    parser.add_argument(
        "--quant", default=None, choices=["w8", "w8a8"],
        help="int8-quantize the DiT for sampling (overrides parallel.quant)",
    )
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree: consecutive groups of this many ranks sample a batch "
                             "together, each holding 1/tp of the DiT's weights")
    parser.add_argument("--device", default=None, help="default cuda; 'cpu' runs the plain path")
    args = parser.parse_args(argv)
    # the rendezvous (torchrun, SLURM or Open MPI environment) before any
    # device work; a no-op for one process
    init_distributed_mode(device=args.device)
    config = LDMAEConfig.from_yaml(args.config)
    if args.ckpt:
        config.ckpt_path = args.ckpt
    if args.quant:
        config.parallel.quant = args.quant
    out_dir = do_sample(config, demo=args.demo, demo_out=args.demo_out, device=args.device, tp=args.tp)
    # FID against the reference statistics, on rank 0 once every rank's
    # PNGs are written
    ref = config.data.fid_reference_file
    if not args.demo and not args.skip_fid and ref and os.path.exists(ref):
        barrier("inference_sampled")
        if get_rank() == 0:
            from ..eval.fid import calculate_fid_given_paths

            fid = calculate_fid_given_paths([ref, out_dir], sp_len=config.sample.fid_num, device=args.device)
            print(f"FID: {fid:.6f}")
    # the other ranks wait for rank 0's FID (the reference's trailing barrier)
    barrier("inference_done")
    return out_dir


if __name__ == "__main__":
    main()

"""FSDP (``--fsdp``, DiT training) of the port on the CPU: two and four gloo
ranks held against one process on the global batch.

* The train step under FSDP2 (``parallel.wrap_fsdp``; ``torch_mp_worker.py
  fsdp_steps``): two steps of two micro-batches at fsdp 2, and at dp 2 x
  fsdp 2 (hybrid sharding, world 4), with clipping binding (max_grad_norm
  0.05 against gradient norms of about 1.5): the model, the EMA and the
  AdamW moments of the checkpoint the ranks write equal one process's
  stepping on the whole batch within relative L2 1e-5 per entry (float32,
  the rule of ``test_two_rank_ddp_dit_steps_equal_one_process_on_the_
  global_batch``), and its AdamW step counts and parameter groups are one
  process's.
* ``cli.train_dit --fsdp 2``: a one-process run's step-2 checkpoint resumed
  under --fsdp 2 to step 4 ("resumed from step 2") equals the same
  checkpoint resumed under --dp 2 (DDP: the same rank batches and noise
  rows; model, EMA, AdamW moments within 1e-5), and the checkpoint that
  --fsdp 2 wrote restores in one process.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

from torch_mp_worker import REPO, join, start

WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")

DIMS = dict(input_size=8, patch_size=1, in_channels=4, hidden_size=64, depth=2, num_heads=4, num_classes=10,
            class_dropout_prob=0.1, learn_sigma=False, use_qknorm=True, use_swiglu=True, use_rope=True,
            use_rmsnorm=True, use_checkpoint=True, remat_policy="attn")
IMPLS = dict(compute_dtype=torch.float32, attn_impl="flash", adaln_impl="fused")
LR, BETA2, CLIP = 1e-3, 0.95, 0.05


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(got: dict, ref: dict, tol: float = 1e-5) -> None:
    errs = {k: _rel_l2(got[k].float().numpy(), ref[k].float().numpy()) for k in ref}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst])


def _ckpt_close(got: dict, ref: dict) -> None:
    """Two checkpoints' model, EMA and AdamW state within 1e-5 per entry;
    the step counts and parameter groups equal."""
    _close(got["model"], ref["model"])
    _close(got["ema"], ref["ema"])
    assert got["step"] == ref["step"]
    assert got["opt"]["param_groups"] == ref["opt"]["param_groups"]
    for key in ("exp_avg", "exp_avg_sq"):
        _close({i: s[key] for i, s in got["opt"]["state"].items()},
               {i: s[key] for i, s in ref["opt"]["state"].items()})
    assert all(float(got["opt"]["state"][i]["step"]) == float(s["step"]) for i, s in ref["opt"]["state"].items())


@pytest.mark.parametrize("world,fsdp", [(2, 2), (4, 2)], ids=["fsdp2", "dp2xfsdp2"])
def test_fsdp_dit_steps_equal_one_process_on_the_global_batch(tmp_path, world, fsdp):
    from ldmae_tpu_torch.models import lightningdit as tdit
    from ldmae_tpu_torch.models import seeded_init_
    from ldmae_tpu_torch.train import init_train_state, make_optimizer, make_train_step
    from ldmae_tpu_torch.transport import create_transport

    rng = np.random.default_rng(3)
    spec = tdit.DiTSpec(**DIMS)
    sd = seeded_init_(tdit.LightningDiT(spec, device="cpu"), 3, std=0.05).state_dict()
    lead = (2, 2, 8)  # steps, micro-batches, global micro-batch
    inp = dict(dims=DIMS, sd=sd, lr=LR, beta2=BETA2, clip=CLIP, accum=2, impls=IMPLS, fsdp=fsdp,
               transport=dict(use_cosine_loss=True, use_lognorm=True),
               x=torch.from_numpy(rng.standard_normal(lead + (4, 8, 8)).astype(np.float32)),
               y=torch.from_numpy(rng.integers(0, 10, lead)))
    torch.save(inp, tmp_path / "inputs.pt")
    procs = start([[WORKER, "fsdp_steps", str(tmp_path)]] * world)

    model = tdit.LightningDiT(spec, device="cpu")
    model.load_state_dict(sd)
    state = init_train_state(model, make_optimizer(model.parameters(), LR, BETA2))
    step = make_train_step(spec, create_transport(**inp["transport"]), grad_accum=2, max_grad_norm=CLIP, **IMPLS)
    gen = torch.Generator()
    for s in range(lead[0]):
        gen.manual_seed(1000 + s)
        assert float(step(state, {"x": inp["x"][s], "y": inp["y"][s]}, gen)["grad_norm"]) > 10 * CLIP  # clipping binds
    join(procs)

    got = torch.load(tmp_path / "checkpoints" / f"{lead[0]:07d}.pt", weights_only=False)
    _ckpt_close(got, {"model": model.state_dict(), "ema": state.ema.state_dict(), "step": lead[0],
                      "opt": state.optimizer.state_dict()})


@pytest.fixture(scope="module")
def latent_dir(tmp_path_factory):
    """20 latents (16 ch, 4 x 4) in two shards, with their statistics file
    written first, so that no rank's dataset draws for them."""
    from ldmae_tpu_torch.data import ImgLatentDataset, LatentShardWriter

    d = str(tmp_path_factory.mktemp("fsdp_latents") / "lat")
    rng = np.random.default_rng(12)
    w = LatentShardWriter(d, shard_size=10)
    for _ in range(2):
        lat = rng.standard_normal((10, 16, 4, 4)).astype(np.float32)
        w.add(lat, lat[..., ::-1].copy(), rng.integers(0, 10, 10))
    ImgLatentDataset(d, latent_norm=True)  # writes latents_stats.pt
    return d


def _train_config(tmp_path, data, name):
    cfg = {
        "data": {"data_path": data, "image_size": 32, "num_classes": 10, "latent_norm": True},
        "vae": {"model_name": "vmae_f8d16", "weight_path": ""},
        "model": {"model_type": "LightningDiT-debug", "in_chans": 16, "remat_policy": "attn"},
        "train": {"max_steps": 2, "global_batch_size": 4, "global_seed": 1, "output_dir": str(tmp_path / "out"),
                  "exp_name": name, "log_every": 1, "ckpt_every": 100, "use_checkpoint": True},
        "optimizer": {"lr": 2e-4, "beta2": 0.95, "max_grad_norm": 1.0},
        "transport": {"use_lognorm": True},
        # float32: a batch split over ranks agrees with one process to the
        # summation order
        "parallel": {"train_attention_impl": "flash_rope", "train_adaln_impl": "fused", "rope_layout": "half",
                     "compute_dtype": "float32"},
    }
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_cli_fsdp2_resumes_a_one_process_checkpoint_as_ddp_does(tmp_path, latent_dir, monkeypatch):
    from ldmae_tpu_torch.cli import train_dit
    from ldmae_tpu_torch.core.config import LDMAEConfig
    from ldmae_tpu_torch.models import permute_qk_for_half_rope
    from ldmae_tpu_torch.train import init_train_state, make_optimizer, restore_checkpoint
    from ldmae_tpu_torch.train.train_dit import build_from_config

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # TensorFlow's import takes seconds
    out = tmp_path / "out"
    train_dit.main(["--config", _train_config(tmp_path, latent_dir, "one"), "--device", "cpu"])  # to step 2
    procs, cfgs = [], {}
    for name, flags in (("fsdp", ["--fsdp", "2"]), ("ddp", ["--dp", "2"])):
        shutil.copytree(out / "one" / "checkpoints", out / name / "checkpoints")
        cfgs[name] = _train_config(tmp_path, latent_dir, name)
        procs.append(start([[WORKER, "cli", "train_dit", "--config", cfgs[name], "--device", "cpu", *flags,
                             "--max_steps", "4"]] * 2))
    for p in procs:
        join(p)
    log = (out / "fsdp" / "log.txt").read_text()
    assert "resumed from step 2" in log and "FSDP over 2 ranks" in log and log.count("(step=0000004)") == 1

    ckpts = [torch.load(out / name / "checkpoints" / "0000004.pt", weights_only=False) for name in ("fsdp", "ddp")]
    _ckpt_close(*ckpts)
    # the --fsdp 2 checkpoint restores in one process
    model = build_from_config(LDMAEConfig.from_yaml(cfgs["fsdp"]), "cpu")[1]
    state = init_train_state(model, make_optimizer(model.parameters(), 2e-4, 0.95))
    assert restore_checkpoint(str(out / "fsdp"), state, half_rope=True) is not None and state.step == 4
    _close(permute_qk_for_half_rope(state.model.state_dict(), model.spec, inverse=True), ckpts[0]["model"], 0.0)

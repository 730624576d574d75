"""The port's multi-process layer on the CPU (gloo): process groups, the
mesh, DDP training and the rank interleave of extraction and tokenizer
evaluation, held against the JAX package's rules and one-process runs.

* ``init_distributed_mode``: a no-op without a launcher's environment; the
  torchrun, SLURM and Open MPI variables read as the JAX function reads
  them; on CUDA the rank is pinned to its ``LOCAL_RANK`` card and
  ``resolve_device`` answers that card.
* ``create_mesh``: the JAX function's assertions (same messages), for fsdp
  and tp as for dp; the CLIs' answers to --fsdp / --tp at world 1.
* The rules that are pure functions in the JAX package, in process: the
  image interleave, ``local_batch_indices``; ``_prune_rank_files`` against
  the JAX CLI's rule (a closure there, restated here).
* Two ranks, each a process with the torchrun environment (``spawn``, every
  rank's stderr gathered before asserting): DDP DiT steps equal one
  process's step on the concatenated batch within relative L2 1e-5 per
  leaf, and with the noise passed in, also the JAX gradients of the full
  batch through optax (the training parity tolerance, 1e-5); the DiT
  training CLI at --dp 2 equals a one-process replay of its ranks' batches;
  ``cli.train_vmae --dp 2`` equals one process with ``--batch_size``
  doubled (1e-5); extraction and tokenizer evaluation split the global
  ``--limit`` and name their files by rank, and their latents, statistics
  and all-reduced metrics equal a one-process run's (metrics within 1e-6
  relative).
"""

import datetime
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from torch_mp_worker import REPO, spawn

from ldmae_tpu_torch.parallel import distributed as tdist
from ldmae_tpu_torch.parallel import mesh as tmesh

WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _state_close(sd, ref, tol):
    errs = {k: _rel_l2(sd[k].numpy(), ref[k].numpy()) for k in ref}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol, (worst, errs[worst])


# ---------------------------------------------------------------------------
# process groups and the mesh
# ---------------------------------------------------------------------------

_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID", "SLURM_NTASKS", "SLURM_LOCALID",
                "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in _LAUNCH_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_init_distributed_mode_is_a_noop_without_the_environment(clean_env):
    clean_env.setenv("WORLD_SIZE", "1")  # a one-process torchrun: nothing to start either
    clean_env.setenv("RANK", "0")
    tdist.init_distributed_mode()
    assert not torch.distributed.is_initialized()
    assert (tdist.get_rank(), tdist.get_world_size(), tdist.is_main_process()) == (0, 1, True)
    tdist.barrier("alone")
    np.testing.assert_array_equal(tdist.all_reduce_sum(np.array([1.5, 2.0])), [1.5, 2.0])
    assert tdist.any_rank(True) and not tdist.any_rank(False)


@pytest.mark.parametrize("env,want", [
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1"}, (3, 4, 1)),
    ({"SLURM_PROCID": "5", "SLURM_NTASKS": "8", "SLURM_LOCALID": "1"}, (5, 8, 1)),
    ({"OMPI_COMM_WORLD_RANK": "2", "OMPI_COMM_WORLD_SIZE": "3", "OMPI_COMM_WORLD_LOCAL_RANK": "2"}, (2, 3, 2)),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}, None),
], ids=["torchrun", "slurm", "ompi", "slurm-one-task"])
def test_launcher_environment_is_read_as_the_jax_function_reads_it(clean_env, env, want):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert tdist._from_env() == want


def test_init_pins_the_local_rank_card_and_resolve_device_answers_it(clean_env):
    """On CUDA: set_device(LOCAL_RANK) before an NCCL group with the 30-minute
    timeout, then ``resolve_device(None)`` is that card (recorded calls; the
    CPU image has no card)."""
    from ldmae_tpu_torch.core.device import resolve_device

    calls, current = {}, [0]
    clean_env.setenv("RANK", "1")
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("LOCAL_RANK", "1")
    clean_env.setenv("MASTER_PORT", "12345")
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(torch.cuda, "set_device", lambda i: current.__setitem__(0, i))
    clean_env.setattr(torch.cuda, "current_device", lambda: current[0])
    clean_env.setattr(tdist.dist, "init_process_group", lambda *a, **k: calls.update(init=(a, k)))
    clean_env.setattr(tdist.dist, "get_backend", lambda *a: "nccl")
    clean_env.setattr(tdist.dist, "new_group", lambda **k: calls.update(new_group=k) or "gloo-group")
    clean_env.setattr(tdist, "barrier", lambda name: calls.update(barrier=name))
    clean_env.setattr(tdist, "_host_group", None)
    tdist.init_distributed_mode()
    assert calls["init"] == (("nccl",), dict(init_method="tcp://127.0.0.1:12345", world_size=2, rank=1,
                                               timeout=datetime.timedelta(seconds=1800)))
    assert calls["new_group"]["backend"] == "gloo" and calls["barrier"] == "init_distributed_mode"
    assert current[0] == 1 and resolve_device(None) == torch.device("cuda", 1)


def _jax_mesh_error(**kw) -> str:
    """The JAX ``create_mesh``'s AssertionError message for one device, as a
    pattern that matches it literally."""
    import jax
    from ldmae_tpu.parallel.mesh import create_mesh as jcreate_mesh

    with pytest.raises(AssertionError) as jerr:
        jcreate_mesh(devices=jax.devices()[:1], **kw)
    return re.escape(str(jerr.value))


@pytest.mark.parametrize("kw", [dict(dp=4), dict(dp=2, fsdp=1, tp=1), dict(dp=-1, fsdp=2), dict(dp=1, tp=2)],
                         ids=["dp4", "dp2", "fsdp2", "tp2"])
def test_create_mesh_raises_as_the_jax_function(kw):
    """A product that is not the world size raises the JAX ``create_mesh``'s
    AssertionError with its message (one process: one device), for fsdp and
    tp as for dp."""
    with pytest.raises(AssertionError, match=_jax_mesh_error(**kw)):
        tmesh.create_mesh(**kw)


@pytest.mark.parametrize("cli,flags", [("train_dit", ["--fsdp", "2"]), ("train_dit", ["--tp", "2"]),
                                       ("inference", ["--tp", "2"])], ids=["train_dit-fsdp", "train_dit-tp",
                                                                           "inference-tp"])
def test_clis_raise_for_fsdp_and_tp(cli, flags, tmp_path, capsys):
    """At world 1: ``train_dit --fsdp 2`` and ``train_dit --tp 2`` raise
    the JAX ``create_mesh``'s AssertionError before they read the config;
    ``inference --tp 2`` prints the JAX CLI's warning and samples at tp 1."""
    import importlib

    main = importlib.import_module(f"ldmae_tpu_torch.cli.{cli}").main
    unread = ["--config", str(tmp_path / "unread.yaml"), "--device", "cpu", *flags]
    if cli == "train_dit":
        degrees = {flags[0][2:]: int(flags[1])}
        with pytest.raises(AssertionError, match=_jax_mesh_error(dp=-1, **degrees)):
            main(unread)
    else:
        from ldmae_tpu_torch.core.config import LDMAEConfig

        cfg = str(tmp_path / "tiny.yaml")
        LDMAEConfig.from_dict({
            "data": {"image_size": 32, "num_classes": 10, "data_path": str(tmp_path / "none")},
            "vae": {"model_name": "vmae_f8d16", "weight_path": ""},
            "model": {"model_type": "LightningDiT-debug", "in_chans": 16},
            "train": {"exp_name": "tiny", "output_dir": str(tmp_path)},
            "sample": {"num_sampling_steps": 2, "cfg_scale": 4.0, "per_proc_batch_size": 2, "fid_num": 2},
        }).to_yaml(cfg)
        folder = main(["--config", cfg, "--device", "cpu", "--skip_fid", *flags])
        assert "WARNING: --tp 2 ignored (n_local=1, per_proc_batch_size=2 not divisible)" in capsys.readouterr().out
        assert sorted(f for f in os.listdir(folder) if f.endswith(".png")) == ["000000.png", "000001.png"]


def test_create_mesh_without_a_group():
    assert tmesh.create_mesh() is None and tmesh.create_mesh(dp=1) is None
    assert tmesh.wrap_data_parallel(torch.nn.Linear(2, 2)) is None


def test_global_batch_draws_give_each_rank_its_rows_of_the_global_draw(monkeypatch):
    g = torch.Generator()
    ref = [torch.rand(6, 3, generator=g.manual_seed(0)), torch.randn(6, generator=g)]
    for rank in range(3):
        monkeypatch.setattr(tdist, "get_world_size", lambda: 3)
        monkeypatch.setattr(tdist, "get_rank", lambda: rank)
        g.manual_seed(0)
        other = torch.Generator().manual_seed(5)
        with tdist.global_batch_draws(g, 2):
            a, b = torch.rand((2, 3), generator=g), torch.randn(2, generator=g)
            c = torch.rand(4, generator=g)  # another leading dim: drawn as asked
            e = torch.rand(2, generator=other)  # another generator
        torch.testing.assert_close(a, ref[0][2 * rank:2 * rank + 2], rtol=0, atol=0)
        torch.testing.assert_close(b, ref[1][2 * rank:2 * rank + 2], rtol=0, atol=0)
        assert c.shape == (4,) and e.shape == (2,)


# ---------------------------------------------------------------------------
# the JAX rules in process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """9 PNGs in two classes (5 + 4), 40 x 44."""
    root = tmp_path_factory.mktemp("mp_imgs")
    rng = np.random.default_rng(11)
    for c, n in (("a", 5), ("b", 4)):
        (root / c).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)).save(root / c / f"{i}.png")
    return str(root)


@pytest.mark.parametrize("world,rank,drop_last", [(2, 0, False), (2, 1, False), (3, 2, True), (4, 1, False)])
def test_image_interleave_matches_jax(images, world, rank, drop_last):
    from ldmae_tpu.data import images as jimages

    from ldmae_tpu_torch.data import images as timages

    kw = dict(raw_uint8=True, process_index=rank, process_count=world, drop_last=drop_last)
    ours = list(timages.ImageFolderDataset(images, 32).iter_batches(2, **kw))
    theirs = list(jimages.ImageFolderDataset(images, 32).iter_batches(2, **kw))
    assert len(ours) == len(theirs) > 0
    seen = np.concatenate([jx for _, _, jx in theirs])
    want = list(range(rank, 9, world))
    assert list(seen) == (want[:len(want) - len(want) % 2] if drop_last else want)
    for (ti, tl), (ji, jl, _) in zip(ours, theirs):
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("n,step,per_step,world", [(10, 0, 4, 2), (10, 2, 4, 2), (7, 1, 6, 3), (5, 3, 2, 1)])
def test_local_batch_indices_match_jax(n, step, per_step, world):
    from ldmae_tpu.cli.train_vmae import local_batch_indices as jlocal

    from ldmae_tpu_torch.cli.train_vmae import local_batch_indices

    order = np.random.default_rng(n + step).permutation(n)
    parts = [local_batch_indices(order, step, per_step, r, world) for r in range(world)]
    for r in range(world):
        np.testing.assert_array_equal(parts[r], jlocal(order, step, per_step, r, world))
    from ldmae_tpu_torch.cli.train_vmae import step_indices

    np.testing.assert_array_equal(np.concatenate(parts), step_indices(order, step, per_step))


def _jax_prune_rule(stem, keep, rank, world):
    """The JAX CLI's ``_prune_rank_files`` rule (``ldmae_tpu/cli/
    evaluate_tokenizer.py``), a closure there."""
    if "_rank_" in stem:
        try:
            r = int(stem.split("_rank_")[1].split("_")[0])
            i = int(stem.rsplit("_", 1)[-1])
        except (ValueError, IndexError):
            return False
        return (r == rank and i >= keep) or (r >= world and rank == 0)
    return rank == 0 and stem.rsplit("_", 1)[-1].isdigit()


@pytest.mark.parametrize("rank", [0, 1])
def test_prune_rank_files_follows_the_jax_rule(tmp_path, rank):
    from ldmae_tpu_torch.cli.evaluate_tokenizer import _prune_rank_files

    names = [f"decoded_image_rank_{r}_{i}" for r in range(4) for i in range(5)]
    names += ["decoded_image_3", "ref_image_12", "notes_rank_x_y", "image_rank_1_z"]
    for n in names:
        (tmp_path / f"{n}.png").write_bytes(b"")
    (tmp_path / "keep.txt").write_text("")
    _prune_rank_files(str(tmp_path), 3, rank, 2)
    left = {f[:-4] for f in os.listdir(tmp_path) if f.endswith(".png")}
    assert left == {n for n in names if not _jax_prune_rule(n, 3, rank, 2)}
    assert (tmp_path / "keep.txt").exists()


# ---------------------------------------------------------------------------
# two ranks: DDP training
# ---------------------------------------------------------------------------

DIT_DIMS = dict(input_size=8, patch_size=1, in_channels=4, hidden_size=64, depth=2, num_heads=4, num_classes=10,
                class_dropout_prob=0.1, learn_sigma=False, use_qknorm=True, use_swiglu=True, use_rope=True,
                use_rmsnorm=True)
LR, BETA2, CLIP = 1e-3, 0.95, 0.5
T_FIXED = 0.37
IMPLS = dict(compute_dtype=torch.float32, attn_impl="flash", adaln_impl="fused")


def _dit_inputs(steps, accum, batch, explicit_noise, seed=3):
    from ldmae_tpu_torch.models import lightningdit as tdit
    from ldmae_tpu_torch.models import seeded_init_

    rng = np.random.default_rng(seed)
    sd = seeded_init_(tdit.LightningDiT(tdit.DiTSpec(**DIT_DIMS), device="cpu"), seed, std=0.05).state_dict()
    lead = (steps, accum, batch)
    inp = dict(dims=DIT_DIMS, sd=sd, lr=LR, beta2=BETA2, clip=CLIP, accum=accum, impls=IMPLS,
               transport=dict(use_cosine_loss=True, use_lognorm=True),
               x=torch.from_numpy(rng.standard_normal(lead + (4, 8, 8)).astype(np.float32)),
               y=torch.from_numpy(rng.integers(0, 10, lead)))
    if explicit_noise:
        inp |= dict(x0=torch.from_numpy(rng.standard_normal(lead + (4, 8, 8)).astype(np.float32)),
                    t=torch.full(lead, T_FIXED),  # the JAX transport takes one t, as sp_timesteps
                    drop_ids=torch.from_numpy((rng.uniform(size=lead) < 0.2).astype(np.int64)))
    return inp


def _one_process_steps(inp):
    from ldmae_tpu_torch.models import lightningdit as tdit
    from ldmae_tpu_torch.train import init_train_state, make_optimizer, make_train_step
    from ldmae_tpu_torch.transport import create_transport

    model = tdit.LightningDiT(tdit.DiTSpec(**inp["dims"]), device="cpu")
    model.load_state_dict(inp["sd"])
    state = init_train_state(model, make_optimizer(model.parameters(), LR, BETA2))
    step = make_train_step(model.spec, create_transport(**inp["transport"]), grad_accum=inp["accum"],
                           max_grad_norm=CLIP, **IMPLS)
    gen = torch.Generator()
    for s in range(inp["x"].shape[0]):
        gen.manual_seed(1000 + s)
        step(state, {"x": inp["x"][s], "y": inp["y"][s]}, gen,
             **{k: inp[k][s] for k in ("x0", "t", "drop_ids") if k in inp})
    return model.state_dict(), state.ema.state_dict()


def _jax_steps(inp):
    """The JAX gradients of each step's full batch with the noise passed in
    (``dit_forward`` + ``training_losses``, averaged over the micro-batches)
    through the JAX package's optimizer (clip + AdamW) and EMA. The JAX side
    runs its ``xla`` impls, the math that the port's flash and fused paths
    compute on the CPU (their parity is ``test_torch_port_train.py``'s)."""
    import jax
    import jax.numpy as jnp
    import optax

    from ldmae_tpu.models import lightningdit as jdit
    from ldmae_tpu.train import torch_import
    from ldmae_tpu.train.train_dit import make_optimizer as jmake_optimizer
    from ldmae_tpu.transport.transport import create_transport as jcreate_transport

    from ldmae_tpu_torch.convert import dit_state_dict_from_jax
    from ldmae_tpu_torch.models import lightningdit as tdit

    js, ts = jdit.DiTSpec(**DIT_DIMS), tdit.DiTSpec(**DIT_DIMS)
    consts = jdit.DiTConsts(js)
    transport = jcreate_transport(use_cosine_loss=True, use_lognorm=True)
    params = torch_import.import_dit_state_dict({k: v.numpy() for k, v in inp["sd"].items()}, js)
    tx = jmake_optimizer(LR, BETA2, max_grad_norm=CLIP)
    opt_state, ema = tx.init(params), params

    def loss_fn(p, x1, x0, t, y, drop):
        def model_fn(xt, tt, yk):
            return jdit.dit_forward(p, js, consts, xt, tt, yk, train=True, force_drop_ids=drop,
                                    compute_dtype=jnp.float32, attn_impl="xla", adaln_impl="xla")

        terms = transport.training_losses(model_fn, jax.random.key(0), x1, dict(yk=y), x0=x0,
                                          sp_timesteps=(T_FIXED, T_FIXED))
        return terms["loss"].mean() + terms["cos_loss"].mean()

    @jax.jit
    def step(params, opt_state, ema, batch):
        gs = [jax.grad(loss_fn)(params, *(batch[k][a] for k in ("x", "x0", "t", "y", "drop_ids")))
              for a in range(inp["accum"])]
        g = jax.tree_util.tree_map(lambda *a: sum(a) / len(a), *gs)
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, jax.tree_util.tree_map(lambda e, p: 0.9999 * e + 1e-4 * p, ema, params)

    for s in range(inp["x"].shape[0]):
        batch = {k: jnp.asarray(inp[k][s].numpy()) for k in ("x", "x0", "t", "y", "drop_ids")}
        params, opt_state, ema = step(params, opt_state, ema, batch)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return dit_state_dict_from_jax(to_np(params), ts), dit_state_dict_from_jax(to_np(ema), ts)


@pytest.mark.parametrize("noise", ["drawn", "passed"])
def test_two_rank_ddp_dit_steps_equal_one_process_on_the_global_batch(tmp_path, noise):
    """Two steps of two micro-batches of 4 (2 a rank). ``drawn``: every rank
    seeds the generator alike and keeps its rows of the global draw.
    ``passed``: the noise, t and label drops passed in, the JAX step too."""
    inp = _dit_inputs(steps=2, accum=2, batch=4, explicit_noise=noise == "passed")
    torch.save(inp, tmp_path / "inputs.pt")
    spawn([[WORKER, "dit_steps", str(tmp_path)]] * 2)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    for key in ("model", "ema"):  # DDP keeps the ranks' weights equal
        for k, v in ranks[0][key].items():
            torch.testing.assert_close(ranks[1][key][k], v, rtol=0, atol=0)
    ref_model, ref_ema = _one_process_steps(inp)
    _state_close(ranks[0]["model"], ref_model, 1e-5)
    _state_close(ranks[0]["ema"], ref_ema, 1e-5)
    assert all(np.isfinite(r["losses"]).all() for r in ranks)
    if noise == "passed":
        jmodel, jema = _jax_steps(inp)
        names = [k for k in jmodel if k in ranks[0]["model"]]
        _state_close(ranks[0]["model"], {k: jmodel[k] for k in names}, 1e-5)
        _state_close(ranks[0]["ema"], {k: jema[k] for k in names}, 1e-5)


@pytest.fixture(scope="module")
def latent_dir(tmp_path_factory):
    """20 latents (16 ch, 4 x 4) in two shards, with their statistics file
    written first, so that no rank's dataset draws for them."""
    from ldmae_tpu_torch.data import ImgLatentDataset, LatentShardWriter

    d = str(tmp_path_factory.mktemp("mp_latents") / "lat")
    rng = np.random.default_rng(12)
    w = LatentShardWriter(d, shard_size=10)
    for _ in range(2):
        lat = rng.standard_normal((10, 16, 4, 4)).astype(np.float32)
        w.add(lat, lat[..., ::-1].copy(), rng.integers(0, 10, 10))
    ImgLatentDataset(d, latent_norm=True)  # writes latents_stats.pt
    return d


def _train_config(tmp_path, data, steps):
    cfg = {
        "data": {"data_path": data, "image_size": 32, "num_classes": 10, "latent_norm": True},
        "vae": {"model_name": "vmae_f8d16", "weight_path": ""},
        "model": {"model_type": "LightningDiT-debug", "in_chans": 16, "remat_policy": "attn"},
        "train": {"max_steps": steps, "global_batch_size": 4, "global_seed": 1, "output_dir": str(tmp_path / "out"),
                  "exp_name": "ddp", "log_every": 1, "ckpt_every": 100, "use_checkpoint": True},
        "optimizer": {"lr": 2e-4, "beta2": 0.95, "max_grad_norm": 1.0},
        "transport": {"use_lognorm": True},
        # float32: then a batch split over two ranks agrees with one process
        # to the summation order (in bf16, AdamW's first steps turn the
        # rounding of near-zero gradients into updates of either sign)
        "parallel": {"train_attention_impl": "flash_rope", "train_adaln_impl": "fused", "rope_layout": "half",
                     "compute_dtype": "float32"},
    }
    path = tmp_path / "ddp.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_two_rank_train_dit_cli_equals_a_replay_of_its_ranks_batches(tmp_path, latent_dir):
    """``cli.train_dit --dp 2``: 3 steps at global batch 4; the checkpoint
    (rank 0's) equals one process stepping on each step's two rank slices
    concatenated, drawn with the CLI's per-step seed; log.txt is rank 0's
    alone; a restart to step 4 resumes at 3."""
    from ldmae_tpu_torch.core.config import LDMAEConfig
    from ldmae_tpu_torch.data import ImgLatentDataset
    from ldmae_tpu_torch.models import permute_qk_for_half_rope
    from ldmae_tpu_torch.train import init_train_state, make_optimizer, restore_checkpoint
    from ldmae_tpu_torch.train.train_dit import build_from_config

    cfg = _train_config(tmp_path, latent_dir, 3)
    argv = [WORKER, "cli", "train_dit", "--config", cfg, "--device", "cpu", "--dp", "2"]
    spawn([argv] * 2)
    exp = tmp_path / "out" / "ddp"
    log = (exp / "log.txt").read_text()
    assert log.count("(step=0000003) Train Loss:") == 1 and "2 process(es)" in log

    config = LDMAEConfig.from_yaml(cfg)
    spec, model, _, step_fn = build_from_config(config, "cpu", torch.Generator().manual_seed(1))
    model.load_state_dict(permute_qk_for_half_rope(model.state_dict(), spec))
    state = init_train_state(model, make_optimizer(model.parameters(), 2e-4, 0.95))
    streams = [ImgLatentDataset(latent_dir, latent_norm=True, latent_multiplier=config.data.latent_multiplier,
                                sample=config.data.sample, seed=1).iter_batches(
        2, shuffle=True, seed=1, process_index=r, process_count=2) for r in range(2)]
    gen = torch.Generator()
    for s in range(3):
        parts = [next(it) for it in streams]
        x = torch.from_numpy(np.concatenate([p["x"] for p in parts]))[None]
        y = torch.from_numpy(np.concatenate([p["y"] for p in parts]))[None]
        gen.manual_seed(2 * 1_000_003 + s)
        step_fn(state, {"x": x, "y": y}, gen)
    fresh = build_from_config(config, "cpu")[1]
    got = init_train_state(fresh, make_optimizer(fresh.parameters(), 2e-4, 0.95))
    restore_checkpoint(str(exp), got, half_rope=True)
    assert got.step == 3
    _state_close(got.model.state_dict(), model.state_dict(), 1e-5)
    _state_close(got.ema.state_dict(), state.ema.state_dict(), 1e-5)

    spawn([argv + ["--max_steps", "4"]] * 2)
    assert "resumed from step 3" in (exp / "log.txt").read_text()


TINY_VMAE = ["--model", "mae_for_ldmae_f8d16_small", "--input_size", "32", "--steps_per_epoch", "2",
             "--num_workers", "2", "--epochs", "2", "--save_epochs", "10", "--mask_ratio", "0.25",
             "--visible_loss_ratio", "0.75", "--no_cls", "--smooth_output", "--perceptual_loss_ratio", "0.5",
             "--fixed_std", "1e-3", "--kl_loss_weight", "1e-6", "--warmup_epochs", "1", "--blr", "1e-3",
             "--device", "cpu"]


def _without_key_bias(sd):
    """The state dict with the key third of each attention's qkv bias left
    out: a bias on k shifts every logit of a query alike, which the softmax
    ignores, so its gradient is 0 in exact arithmetic and rounding noise in
    fact, and AdamW turns noise below its eps into updates of either sign."""
    out = dict(sd)
    for k, v in sd.items():
        if k.endswith("qkv.bias"):
            d = v.shape[-1] // 3
            out[k] = torch.cat([v[..., :d], v[..., 2 * d:]], -1)
    return out


def test_two_rank_train_vmae_equals_one_process_at_twice_the_batch(tmp_path, images, monkeypatch):
    """``--dp 2 --batch_size 2`` on two ranks against ``--batch_size 4`` in
    one process: 2 epochs of 2 steps (LPIPS and the KL term on), the step in
    float32 on both sides (``torch_mp_worker.vmae_step_in_fp32``; the CLI
    computes in bf16, where another split of the batch rounds otherwise): the
    final checkpoints within relative L2 1e-5 a leaf (``_without_key_bias``),
    log.txt's epoch losses within 1e-5 relative, and rank 0 alone writes
    log.txt."""
    from torch_mp_worker import vmae_step_in_fp32

    from ldmae_tpu_torch.cli import train_vmae

    spawn([[WORKER, "train_vmae_fp32", "--data_path", images, "--output_dir", str(tmp_path / "dp2"),
            "--batch_size", "2", "--dp", "2", *TINY_VMAE]] * 2)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(train_vmae, "make_vmae_train_step", train_vmae.make_vmae_train_step)
    vmae_step_in_fp32(train_vmae)
    train_vmae.main(["--data_path", images, "--output_dir", str(tmp_path / "one"), "--batch_size", "4", *TINY_VMAE])
    ckpt = [torch.load(tmp_path / d / "checkpoints" / "0000004.pt", weights_only=True) for d in ("dp2", "one")]
    _state_close(_without_key_bias(ckpt[0]["model"]), _without_key_bias(ckpt[1]["model"]), 1e-5)
    logs = [[json.loads(ln) for ln in (tmp_path / d / "log.txt").read_text().splitlines()] for d in ("dp2", "one")]
    assert len(logs[0]) == len(logs[1]) == 2
    for a, b in zip(*logs):
        for k in ("train_loss", "train_vis_loss", "train_mask_loss", "train_kl_loss", "train_p_loss"):
            assert abs(a[k] - b[k]) <= 1e-5 * abs(b[k]) + 1e-12, k


# ---------------------------------------------------------------------------
# two ranks: extraction and tokenizer evaluation
# ---------------------------------------------------------------------------


def _eval_config(tmp_path, images):
    cfg = {
        "data": {"origin_path": images, "data_path": str(tmp_path / "latents"), "image_size": 32,
                 "num_classes": 2, "sample": True},
        "vae": {"model_name": "vmae_f8d16", "weight_path": ""},
        "train": {"global_seed": 0},
    }
    path = tmp_path / "eval.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_two_rank_extraction_splits_the_global_limit(tmp_path, images):
    """--limit 7 over two ranks: rank 0 encodes images 0, 2, 4, 6 and rank 1
    images 1, 3, 5, into ``latents_rank{R:02d}_shard000``; each image's
    latents equal a one-process extraction's, and the statistics rank 0
    wrote equal their recomputation over both ranks' shards."""
    from ldmae_tpu_torch.cli import extract_features
    from ldmae_tpu_torch.data import ImgLatentDataset, read_safetensors

    cfg = _eval_config(tmp_path, images)
    outs = spawn([["-m", "ldmae_tpu_torch.cli.extract_features", "--config", cfg, "--batch", "2", "--limit", "7",
                   "--device", "cpu", "--out", str(tmp_path / "two")]] * 2)
    assert "(4 on rank 0)" in outs[0] and "(3 on rank 1)" in outs[1]
    assert "latent stats cached" in outs[0] and "latent stats cached" not in outs[1]
    names = sorted(f for f in os.listdir(tmp_path / "two") if f.endswith(".safetensors"))
    assert names == ["latents_rank00_shard000.safetensors", "latents_rank01_shard000.safetensors"]
    extract_features.main(["--config", cfg, "--batch", "7", "--limit", "7", "--device", "cpu",
                           "--out", str(tmp_path / "one")])
    one = read_safetensors(str(tmp_path / "one" / "latents_rank00_shard000.safetensors"))
    for r, name in enumerate(names):
        part = read_safetensors(str(tmp_path / "two" / name))
        for key in ("latents", "latents_flip", "labels"):
            np.testing.assert_allclose(part[key], one[key][r::2], rtol=1e-5, atol=1e-5, err_msg=key)
    stats = torch.load(tmp_path / "two" / "latents_stats.pt", weights_only=True)
    again = ImgLatentDataset(str(tmp_path / "two"), latent_norm=False, sample=True).compute_latent_stats()
    for k in ("mean", "std"):
        np.testing.assert_array_equal(stats[k].numpy(), again[k])


def test_two_rank_tokenizer_evaluation_all_reduces_the_metrics(tmp_path, images):
    """8 of the 9 images at batch 2 (full batches on both sides, so the mean
    of batch means is the same quantity): rank-named PNGs, 4 a rank; PSNR,
    LPIPS and SSIM summed over the ranks equal one process's within 1e-6
    relative; rank 0 alone reports, after every rank's PNGs are written."""
    from ldmae_tpu_torch.cli import evaluate_tokenizer

    cfg = _eval_config(tmp_path, images)
    argv = ["--config", cfg, "--data_path", images, "--batch", "2", "--limit", "8", "--device", "cpu"]
    outs = spawn([[WORKER, "evaluate_tokenizer", str(tmp_path), *argv, "--output_path", str(tmp_path / "two")]] * 2)
    assert "Final Metrics:" in outs[0] and "Final Metrics:" not in outs[1]
    reports = [json.loads((tmp_path / f"reports_rank{r}.json").read_text()) for r in range(2)]
    assert reports[1] == [None]
    for sub, prefix in (("reference", "ref_image"), ("vmae_f8d16_0.0", "decoded_image")):
        got = sorted(os.listdir(tmp_path / "two" / sub))
        assert got == sorted(f"{prefix}_rank_{r}_{i}.png" for r in range(2) for i in range(4)), sub
    (two,) = reports[0]
    assert two["rfid"] == 16.0  # the stub's count: both folders complete when rank 0 reads them
    monkey = pytest.MonkeyPatch()
    monkey.setattr(evaluate_tokenizer, "calculate_fid_given_paths", lambda paths, **kw: 0.0)
    try:
        (one,) = evaluate_tokenizer.main(argv + ["--output_path", str(tmp_path / "one")])
    finally:
        monkey.undo()
    for k in ("psnr", "lpips", "ssim"):
        assert abs(two[k] - one[k]) <= 1e-6 * abs(one[k]), (k, two[k], one[k])

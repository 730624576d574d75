"""The JAX package's Orbax checkpoints carried into the port through
``scripts/convert_orbax.py`` and ``ldmae_tpu_torch.train.jax_import``, on the
CPU at debug size.

Each Orbax tree is written by ``ldmae_tpu.train.state.save_checkpoint`` from
seeded numpy weights, EMA and AdamW moments (mu ~ N(0, 1e-3), nu = mu^2 +
1e-8) at Adam count 37, with no JAX train step; the templates' initial
draws are traced for their shapes alone, to keep the file's time down.

* DiT, half and interleaved RoPE layouts: the converted file's weights, EMA,
  ``exp_avg``, ``exp_avg_sq``, steps and groups equal ``convert.py``'s maps
  of the JAX trees exactly (in the canonical layout on disk). One update
  after resume, from the same gradients (clipped), against the JAX
  ``restore_checkpoint`` and one optax update: every leaf of the weights and
  the EMA within relative L2 error 1e-5 (fp32 on both sides); the control,
  the same weights with AdamW restarted (the old ``export_torch`` route,
  ``"opt": {}``), must read above that bound.
* ``cli.train_dit --device cpu`` on the converted JAX experiment resumes at
  the JAX step; an Orbax step newer than every ``.pt`` is still refused.
* Sampling: the port's ``build_pipeline(ckpt_path=<converted .pt>)`` against
  the JAX ``build_pipeline`` on the Orbax directory, ``z`` given, 4 steps:
  the tolerances of ``tests/test_torch_port_sampling.py`` for the same bf16
  chain (latents within 2e-2 of their scale, images within 2 levels).
* VMAE: the stage-1 -> stage-3 handoff (``--weights_only`` .pth through the
  port's ``--resume``) equals the JAX CLI's strict=False merge of the Orbax
  directory exactly; a preempted stage (plain stage 1, stage 3 under
  ``--tune_decoder``, gradual stage 1) restores with the JAX weights,
  moments, step 38 and Adam count 37 exactly, and its first resumed update
  (the learning rate of count 37, within float32 resolution of optax's)
  agrees with optax within 1e-6 of the largest value of each leaf, the
  frozen leaves unchanged.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from ldmae_tpu.core.config import LDMAEConfig as JConfig
from ldmae_tpu.data.latent_dataset import LatentShardWriter
from ldmae_tpu.models import lightningdit as jdit
from ldmae_tpu.models import vmae as jvmae
from ldmae_tpu.train import state as jstate
from ldmae_tpu.train import train_vmae as jtrain
from ldmae_tpu.train.train_dit import build_from_config as jbuild_from_config

from torch_port_helpers import REPO, image_folder, randomize, to_numpy  # noqa: F401 (a fixture)

from ldmae_tpu_torch.cli import train_vmae
from ldmae_tpu_torch.convert import (dit_state_dict_from_jax, vmae_gradual_state_dict_from_jax,
                                     vmae_state_dict_from_jax)
from ldmae_tpu_torch.core.config import LDMAEConfig
from ldmae_tpu_torch.models import LightningDiT, VMAE, permute_qk_for_half_rope
from ldmae_tpu_torch.models.vmae_variants import GradualVMAE
from ldmae_tpu_torch.train import TrainState, apply_update_, init_train_state, make_optimizer, restore_checkpoint
from ldmae_tpu_torch.train import train_vmae as ttrain
from ldmae_tpu_torch.train.jax_import import vmae_args
from ldmae_tpu_torch.train.train_dit import spec_from_config

STEP, COUNT = 37, 37  # the DiT's train step and Adam count
VSTEP = 38  # the VMAE's train step: one update was skipped (non-finite), so its count is 37
UPDATE_REL_L2 = 1e-5


@pytest.fixture(scope="module")
def convert():
    """``scripts/convert_orbax.py`` as a module (it is not in a package)."""
    spec = importlib.util.spec_from_file_location("convert_orbax", os.path.join(REPO, "scripts", "convert_orbax.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-3))


def _seeded_adam(opt_state, seed, count):
    """``opt_state`` with Adam's moments drawn like a trained run's (mu ~
    N(0, 1e-3), nu = mu^2 + 1e-8; a frozen ``MaskedNode`` stays one) and
    every count (Adam's, the schedule's) set to ``count``."""
    rng = np.random.default_rng(seed)

    def moments(adam):
        mu = jax.tree_util.tree_map(lambda z: rng.standard_normal(z.shape).astype(np.float32) * np.float32(1e-3),
                                    adam.mu)
        nu = jax.tree_util.tree_map(lambda m: m * m + np.float32(1e-8), mu)
        return adam._replace(mu=jax.tree_util.tree_map(jnp.asarray, mu), nu=jax.tree_util.tree_map(jnp.asarray, nu),
                             count=jnp.asarray(count, jnp.int32))

    kinds = (optax.ScaleByAdamState, optax.ScaleByScheduleState)

    def fix(s):
        if isinstance(s, optax.ScaleByAdamState):
            return moments(s)
        if isinstance(s, optax.ScaleByScheduleState):
            return s._replace(count=jnp.asarray(count, jnp.int32))
        return s

    return jax.tree_util.tree_map(fix, opt_state, is_leaf=lambda x: isinstance(x, kinds))


def _zeros_of_shapes(init):
    """``init(key, spec, ...)`` as zeros of its shapes, traced with
    ``jax.eval_shape`` (nothing is drawn or compiled): the tests overwrite
    every value it gives."""
    def shapes(key, spec, *args):
        out = jax.eval_shape(lambda k: init(k, spec, *args), key)
        return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), out)

    return shapes


def _init_state(params, tx):
    """``init_train_state(params, tx)`` with its optimizer state as zeros of
    their shapes (traced with ``jax.eval_shape``: eager, each of its ops
    would compile alone; ``_seeded_adam`` then sets the moments and counts)."""
    shapes = jax.eval_shape(lambda p: jstate.init_train_state(p, tx), params)
    opt_state = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes.opt_state)
    return jstate.TrainState(jnp.zeros((), jnp.int32), params, params, opt_state)


def _update(tx, grads, opt_state, params):
    """One optax update, applied, as one program."""
    def step(g, o, p):
        updates, _ = tx.update(g, o, p)
        return optax.apply_updates(p, updates)

    return jax.jit(step)(grads, opt_state, params)


def _adam(opt_state):
    (adam,) = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
               if isinstance(s, optax.ScaleByAdamState)]
    return adam


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    rng = np.random.default_rng(10)
    root = tmp_path_factory.mktemp("lat")
    w = LatentShardWriter(str(root), shard_size=8)
    for _ in range(2):
        lat = rng.standard_normal((8, 16, 4, 4)).astype(np.float32)
        w.add(lat, lat[..., ::-1].copy(), rng.integers(0, 10, 8))
    w.flush()
    return str(root)


def _dit_config(root, layout, shards, vae):
    cfg = {
        "data": {"data_path": shards, "image_size": 32, "num_classes": 10, "latent_norm": False},
        "vae": {"model_name": "vmae_f8d16", "downsample_ratio": 8, "weight_path": vae},
        "model": {"model_type": "LightningDiT-debug", "in_chans": 16},
        "train": {"max_steps": STEP + 1, "global_batch_size": 4, "global_seed": 1, "output_dir": str(root),
                  "exp_name": "run", "log_every": 1, "ckpt_every": 1000},
        "optimizer": {"lr": 1e-3, "beta2": 0.95, "max_grad_norm": 1.0},
        "transport": {"use_lognorm": True},
        "sample": {"num_sampling_steps": 4, "cfg_scale": 4.0, "per_proc_batch_size": 2},
        "parallel": {"rope_layout": layout},
    }
    path = os.path.join(root, "run.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def vae_weights(tmp_path_factory):
    """A production-arch VMAE at 32^2 with seeded weights, written by the JAX
    package's exporter (``torch_port_helpers.vmae_ckpt``'s, its template
    traced for shapes alone)."""
    from ldmae_tpu.train.torch_export import save_vmae_torch_checkpoint

    spec = jvmae.vmae_spec("mae_for_ldmae_f8d16_prev", img_size=32, ldmae_mode=True, no_cls=True,
                           kl_loss_weight=True, smooth_output=True)
    params = randomize(_zeros_of_shapes(jvmae.init_vmae_params)(jax.random.key(0), spec), 11)
    return save_vmae_torch_checkpoint(str(tmp_path_factory.mktemp("vae") / "vmae.pth"), params, spec)


@pytest.fixture(scope="module", params=["half", "interleaved"])
def dit_run(request, tmp_path_factory, shards, vae_weights, convert):
    """A JAX DiT experiment with an Orbax checkpoint at step 37 (seeded
    weights, EMA and moments; the weights stand for the run's own layout),
    converted by the script. Returns a dict of what the tests read."""
    layout = request.param
    root = tmp_path_factory.mktemp(f"dit_{layout}")
    cfg_path = _dit_config(str(root), layout, shards, vae_weights)
    config = JConfig.from_yaml(cfg_path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdit, "init_dit_params", _zeros_of_shapes(jdit.init_dit_params))
        _, _, params, _, tx, _ = jbuild_from_config(config, jax.random.key(0))
    params = randomize(params, 1, std=0.05)
    ema = randomize(params, 2, std=0.05)
    state = _init_state(params, tx)
    state = state._replace(step=jnp.asarray(STEP, jnp.int32), ema_params=ema,
                           opt_state=_seeded_adam(state.opt_state, 3, COUNT))
    exp = os.path.join(str(root), "run")
    jstate.save_checkpoint(exp, state, config=config.to_dict())
    out = convert.main(["dit", "--config", cfg_path, "--ckpt", exp])
    return dict(layout=layout, cfg=cfg_path, exp=exp, out=out, params=params, ema=ema, tx=tx,
                template=state, adam=_adam(state.opt_state), spec=spec_from_config(LDMAEConfig.from_yaml(cfg_path)))


def _canonical(sd, run):
    return permute_qk_for_half_rope(sd, run["spec"], inverse=True) if run["layout"] == "half" else sd


def test_dit_file_holds_the_jax_trees_exactly(dit_run):
    run, spec = dit_run, dit_run["spec"]
    assert run["out"] == os.path.join(run["exp"], "checkpoints", f"{STEP:07d}.pt")
    ckpt = torch.load(run["out"], map_location="cpu", weights_only=True)
    assert set(ckpt) == {"model", "ema", "opt", "config", "step"} and ckpt["step"] == STEP
    for key, tree in (("model", run["params"]), ("ema", run["ema"])):
        want = _canonical(dit_state_dict_from_jax(to_numpy(tree), spec), run)
        assert set(ckpt[key]) == set(want)
        for k, v in want.items():
            assert torch.equal(ckpt[key][k], v), (key, k)
    model = LightningDiT(spec, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert ckpt["opt"]["param_groups"] == make_optimizer(model.parameters(), 1e-3, 0.95).state_dict()["param_groups"]
    assert sorted(ckpt["opt"]["state"]) == list(range(len(names)))
    for key, tree in (("exp_avg", run["adam"].mu), ("exp_avg_sq", run["adam"].nu)):
        want = _canonical(dit_state_dict_from_jax(to_numpy(tree), spec), run)
        for i, name in enumerate(names):
            assert torch.equal(ckpt["opt"]["state"][i][key], want[name]), (key, name)
    for s in ckpt["opt"]["state"].values():
        assert s["step"].dtype == torch.float32 and float(s["step"]) == COUNT


def _port_resumed(run, restart_adamw=False):
    """The port's train state from the converted file, as ``cli.train_dit``
    restores it; ``restart_adamw``: the weights and EMA alone (an empty
    ``opt``, the old ``export_torch`` route)."""
    model = LightningDiT(run["spec"], device="cpu")
    state = init_train_state(model, make_optimizer(model.parameters(), 1e-3, 0.95))
    half = run["layout"] == "half"
    if not restart_adamw:
        restore_checkpoint(run["exp"], state, half_rope=half)
        return state
    ckpt = torch.load(run["out"], map_location="cpu", weights_only=True)
    for module, key in ((state.model, "model"), (state.ema, "ema")):
        sd = ckpt[key]
        module.load_state_dict(permute_qk_for_half_rope(sd, run["spec"]) if half else sd)
    return state


def test_dit_first_resumed_update_matches_the_jax_resume(dit_run):
    run, spec = dit_run, dit_run["spec"]
    restored = jstate.restore_checkpoint(run["exp"], run["template"])
    assert int(restored.step) == STEP
    grads = randomize(run["params"], 4, std=0.05)  # global norm above 1: the clip acts
    params = _update(run["tx"], grads, restored.opt_state, restored.params)
    ema = jax.tree_util.tree_map(lambda e, p: 0.9999 * e + 1e-4 * p, restored.ema_params, params)
    want = {k: dit_state_dict_from_jax(to_numpy(t), spec) for k, t in (("model", params), ("ema", ema))}
    gsd = dit_state_dict_from_jax(to_numpy(grads), spec)

    errs = []
    for restart in (False, True):
        state = _port_resumed(run, restart)
        for n, p in state.model.named_parameters():
            p.grad = gsd[n].clone()
        apply_update_(state, max_grad_norm=1.0)
        errs.append({(key, n): _rel_l2(p.detach().numpy(), want[key][n].numpy())
                     for key, module in (("model", state.model), ("ema", state.ema))
                     for n, p in module.named_parameters()})
        if not restart:
            assert state.step == STEP + 1
    resumed, control = errs
    worst = max(resumed, key=resumed.get)
    assert resumed[worst] <= UPDATE_REL_L2, (worst, resumed[worst])
    worst = max(control, key=control.get)
    assert control[worst] > UPDATE_REL_L2, (worst, control[worst])


def test_train_cli_resumes_a_converted_jax_run(dit_run, tmp_path, monkeypatch):
    """A copy of the converted experiment (its YAML pointed at the copy)."""
    import shutil

    from ldmae_tpu_torch.cli import train_dit

    run = dit_run
    with open(run["cfg"]) as f:
        raw = yaml.safe_load(f)
    raw["train"]["output_dir"] = str(tmp_path)
    cfg = str(tmp_path / "run.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(raw, f)
    exp = str(tmp_path / "run")
    shutil.copytree(run["exp"], exp, symlinks=True)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    out = train_dit.main(["--config", cfg, "--device", "cpu"])
    assert out["state"].step == STEP + 1 and [h["step"] for h in out["history"]] == [STEP + 1]
    with open(os.path.join(exp, "log.txt")) as f:
        assert f"resumed from step {STEP}" in f.read()
    last = torch.load(os.path.join(exp, "checkpoints", f"{STEP + 1:07d}.pt"), weights_only=True)
    assert all(float(s["step"]) == COUNT + 1 for s in last["opt"]["state"].values())
    # an Orbax step later than every .pt is still refused
    jstate.save_checkpoint(exp, run["template"]._replace(step=jnp.asarray(STEP + 5, jnp.int32)))
    with pytest.raises(NotImplementedError, match="scripts/convert_orbax.py"):
        train_dit.main(["--config", cfg, "--device", "cpu", "--max_steps", str(STEP + 6)])


@pytest.mark.parametrize("dit_run", ["half"], indirect=True)
def test_sampling_from_the_converted_file_matches_the_jax_cli(dit_run):
    from ldmae_tpu.cli.inference import build_pipeline as jbuild_pipeline

    from ldmae_tpu_torch.cli.inference import build_pipeline

    """The half-layout run: the JAX CLI reads the layout from the saved YAML,
    the port permutes the canonical file."""
    run = dit_run
    with pytest.MonkeyPatch.context() as mp:  # its initial DiT is replaced by the restored EMA
        mp.setattr(jdit, "init_dit_params", _zeros_of_shapes(jdit.init_dit_params))
        jfn, jbundle, _ = jbuild_pipeline(JConfig.from_yaml(run["cfg"]),
                                          ckpt_path=os.path.join(run["exp"], "checkpoints", f"{STEP:07d}"))
    tfn, tbundle, _ = build_pipeline(LDMAEConfig.from_yaml(run["cfg"]), ckpt_path=run["out"], device="cpu")
    z = np.random.default_rng(7).standard_normal((2, 16, 4, 4)).astype(np.float32)
    y = np.array([1, 7])
    jimgs = np.asarray(jfn(jbundle, jax.random.key(0), jnp.asarray(y), z=jnp.asarray(z)))
    timgs = tfn(tbundle, torch.from_numpy(y), z=torch.from_numpy(z)).numpy()
    assert timgs.shape == jimgs.shape == (2, 32, 32, 3) and timgs.dtype == np.uint8
    assert np.abs(timgs.astype(int) - jimgs.astype(int)).max() <= 2
    jlat = np.asarray(jfn(dict(jbundle, vae=None), jax.random.key(0), jnp.asarray(y), z=jnp.asarray(z)))
    tlat = tfn(dict(tbundle, vae=None), torch.from_numpy(y), z=torch.from_numpy(z)).numpy()
    assert np.abs(tlat - jlat).max() <= 2e-2 * np.abs(jlat).max()
    assert np.abs(tlat - z).max() > 1e-2  # the DiT moved the latents


# ---------------------------------------------------------------------------
# VMAE
# ---------------------------------------------------------------------------

VMAE_TINY = ["--model", "mae_for_ldmae_f8d16_small", "--input_size", "32", "--batch_size", "2", "--steps_per_epoch",
             "4", "--epochs", "20", "--warmup_epochs", "2", "--blr", "1e-3", "--min_lr", "1e-5", "--no_cls",
             "--smooth_output"]
STAGES = {
    "stage1": ["--mask_ratio", "0.25", "--kl_loss_weight", "1e-6", "--fixed_std", "1e-3"],
    "stage3": ["--mask_ratio", "0.0", "--kl_loss_weight", "0.0", "--tune_decoder"],
    "gradual": ["--mask_ratio", "0.25", "--kl_loss_weight", "1e-6", "--fixed_std", "1e-3", "--gradual_resol"],
}
EPOCH = VSTEP // 4  # the epoch the preempted step is in (4 steps an epoch)


class _Built(Exception):
    """Raised in place of the JAX CLI's optimizer: everything before it ran."""


def _jax_cli_until_the_optimizer(argv):
    """``ldmae_tpu.cli.train_vmae.main`` run in this process up to
    ``make_vmae_optimizer``: (its params, after any ``--resume`` merge;
    the optimizer it builds; that call's keyword arguments; its args).
    Its initial draws are zeros of their shapes (``_zeros_of_shapes``), and
    its compilation-cache setting is kept out of this process."""
    from ldmae_tpu.cli import train_vmae as jcli

    real, got = jtrain.make_vmae_optimizer, {}

    def capture(params, steps_per_epoch, **kw):
        got.update(params=params, tx=real(params, steps_per_epoch, **kw), kw=dict(kw, steps_per_epoch=steps_per_epoch))
        raise _Built

    update = jax.config.update
    args = jcli.get_args_parser().parse_args(argv)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "make_vmae_optimizer", capture)
        mp.setattr(jvmae, "init_vmae_params", _zeros_of_shapes(jvmae.init_vmae_params))
        mp.setattr(jax.config, "update", lambda name, value: None if name == "jax_compilation_cache_dir"
                   else update(name, value))
        mp.setenv("JAX_COMPILATION_CACHE_DIR", args.output_dir)
        with pytest.raises(_Built):
            jcli.main(args)
    params = jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x)), got["params"])  # one device
    return params, got["tx"], got["kw"], args


def _vmae_to_sd(tree, spec, gradual):
    tree = to_numpy(tree)
    return vmae_state_dict_from_jax(tree, spec) if gradual is None else vmae_gradual_state_dict_from_jax(
        tree, spec, *gradual)


@pytest.fixture(scope="module", params=list(STAGES))
def vmae_stage(request, tmp_path_factory, image_folder, convert):  # noqa: F811
    """A preempted JAX VMAE stage: an Orbax checkpoint at step 38 (Adam count
    37: one update skipped) in the middle of epoch 9, its params seeded on
    the template the JAX CLI builds from the flags, written with the flags
    beside it and a checkpoint-9 alias, then converted by the script."""
    root = tmp_path_factory.mktemp(request.param)
    stage = str(root / "stage")
    params, tx, kw, args = _jax_cli_until_the_optimizer(
        ["--data_path", image_folder, "--output_dir", stage, *VMAE_TINY, *STAGES[request.param]])
    params = randomize(params, 21)
    state = _init_state(params, tx)
    state = state._replace(step=jnp.asarray(VSTEP, jnp.int32), opt_state=_seeded_adam(state.opt_state, 22, COUNT))
    path = jstate.save_checkpoint(stage, state, config=vars(args))
    os.symlink(os.path.basename(path), os.path.join(stage, "checkpoints", f"checkpoint-{EPOCH}"))
    port_args = vmae_args(vars(args))
    spec = train_vmae.model_spec(port_args)
    gradual = (spec.depth // 2, spec.decoder_depth - spec.depth // 2) if port_args.gradual_resol else None
    return dict(dir=stage, out=convert.main(["vmae", "--ckpt", stage]), params=params, tx=tx, kw=kw,
                template=state, adam=_adam(state.opt_state), args=port_args,
                spec=spec, gradual=gradual)


def test_preempted_vmae_stage_resumes_with_the_jax_state(vmae_stage):
    """The port's restore (as ``cli.train_vmae`` makes its model, optimizer
    and state) of the converted stage: weights, moments, step and count
    exactly; then one update from the same gradients against optax."""
    st, args, spec = vmae_stage, vmae_stage["args"], vmae_stage["spec"]
    assert st["out"] == os.path.join(st["dir"], "checkpoints", f"{VSTEP:07d}.pt")
    model = VMAE(spec, device="cpu") if st["gradual"] is None else GradualVMAE(spec, *st["gradual"], device="cpu")
    opt = ttrain.make_vmae_optimizer(model, weight_decay=args.weight_decay, tune_decoder=args.tune_decoder)
    state = TrainState(step=0, model=model, ema=None, optimizer=opt)
    restore_checkpoint(st["dir"], state)
    assert state.step == VSTEP and ttrain.applied_updates(opt) == COUNT
    want = _vmae_to_sd(st["params"], spec, st["gradual"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    names = {p: n for n, p in model.named_parameters()}
    assert sorted(names[p] for p in opt.state) == sorted(n for n, p in model.named_parameters() if p.requires_grad)
    assert bool(args.tune_decoder) == (len(opt.state) < len(names))
    for key, tree in (("exp_avg", st["adam"].mu), ("exp_avg_sq", st["adam"].nu)):
        # frozen leaves are MaskedNodes: zeros in the map's input, and no state in the port
        filled = jax.tree_util.tree_map(lambda p, m: np.zeros(p.shape, np.float32)
                                        if isinstance(m, optax.MaskedNode) else m, st["params"], tree)
        moments = _vmae_to_sd(filled, spec, st["gradual"])
        for p, s in opt.state.items():
            assert torch.equal(s[key], moments[names[p]]), (key, names[p])
            assert float(s["step"]) == COUNT

    # the first resumed update: the rate of count 37 (optax's schedule), Adam's moments, weight decay
    kw = st["kw"]
    schedule = ttrain.lr_schedule(kw["steps_per_epoch"], kw["base_lr"], kw["min_lr"], kw["warmup_epochs"],
                                  kw["total_epochs"], kw["fixed_lr"])
    jlr = float(jtrain.cosine_lr(kw["base_lr"], kw["min_lr"], kw["warmup_epochs"], kw["total_epochs"],
                                 kw["fixed_lr"])(jnp.float32(COUNT / kw["steps_per_epoch"])))
    # the JAX schedule is float32, the port's float64
    assert jlr > 0 and abs(schedule(ttrain.applied_updates(opt)) - jlr) <= 1e-6 * jlr
    restored = jstate.restore_checkpoint(st["dir"], st["template"])
    grads = randomize(st["params"], 23, std=1.0)
    ref = _vmae_to_sd(_update(st["tx"], grads, restored.opt_state, restored.params), spec, st["gradual"])
    gsd = _vmae_to_sd(grads, spec, st["gradual"])
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    for n, p in model.named_parameters():
        p.grad = gsd[n].clone() if p.requires_grad else None
    ttrain.apply_vmae_update_(state, schedule, True)
    assert state.step == VSTEP + 1
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
            continue
        r = ref[n].numpy().astype(np.float64)
        err = np.abs(p.detach().numpy() - r).max() / np.abs(r).max()
        assert err <= 1e-6, (n, err)


@pytest.mark.parametrize("vmae_stage", ["stage1"], indirect=True)
def test_stage1_to_stage3_handoff_matches_the_jax_merge(vmae_stage, image_folder, tmp_path, convert,  # noqa: F811
                                                        capsys):
    """``--weights_only`` of stage 1's ``checkpoint-9`` alias, merged by the
    port's stage 3 (``--resume x.pth``), equals the JAX CLI's strict=False
    merge of the Orbax alias itself."""
    alias = os.path.join(vmae_stage["dir"], "checkpoints", f"checkpoint-{EPOCH}")
    pth = convert.main(["vmae", "--ckpt", alias, "--weights_only", str(tmp_path / "stage1.pth")])
    saved = torch.load(pth, weights_only=False)
    assert set(saved) == {"model", "epoch", "args"} and saved["epoch"] == EPOCH and "mask_token" in saved["model"]
    stage3 = [*VMAE_TINY, *STAGES["stage3"], "--epochs", "0"]
    res = train_vmae.main(["--data_path", image_folder, "--output_dir", str(tmp_path / "port"), "--device", "cpu",
                           "--resume", pth, *stage3])
    assert "unexpected=['mask_token']" in capsys.readouterr().out
    merged, *_ = _jax_cli_until_the_optimizer(["--data_path", image_folder, "--output_dir", str(tmp_path / "jax"),
                                               "--resume", alias, *stage3])
    out = capsys.readouterr().out
    assert "unexpected=['mask_token']" in out and "missing=[]" in out
    want = vmae_state_dict_from_jax(to_numpy(merged), res["state"].model.spec)
    for k, v in res["state"].model.state_dict().items():
        assert torch.equal(v, want[k]), k

#!/usr/bin/env python3
"""Convert a JAX run's Orbax checkpoint into the PyTorch port's ``.pt``, so
the port's CLIs continue the run on the GPU from the same YAML or flags.

Runs where ``jax``, ``orbax`` and ``ldmae_tpu`` are installed (the TPU host);
the port cannot read Orbax itself. It restores the train state with the JAX
package's own code against a template built from the run's config (the
DiT's YAML; the VMAE's flags, from the ``NNNNNNN.config.yaml`` its trainer
writes beside each step), maps the weights, the EMA and AdamW's two moments
to reference-layout state dicts with ``ldmae_tpu_torch.convert``'s maps,
and writes the port's checkpoint through ``ldmae_tpu_torch.train.jax_import``:
``<out>/checkpoints/<step:07d>.pt``, by default in the experiment (or
stage) directory itself, beside ``checkpoints/<step:07d>/``.

    # DiT: then `python -m ldmae_tpu_torch.cli.train_dit --config cfg.yaml`
    # resumes at the JAX step, and `cli.inference --ckpt .../NNNNNNN.pt` samples
    python scripts/convert_orbax.py dit --config cfg.yaml --ckpt <exp dir | step dir> [--out <dir>]
    # VMAE: a stage directory, a step directory or a checkpoint-E alias; a
    # rerun of `cli.train_vmae` with --output_dir <out> resumes there
    python scripts/convert_orbax.py vmae --ckpt <dir> [--out <dir>] [--weights_only x.pth]

``--weights_only x.pth`` writes the reference VMAE ``{'model', 'epoch',
'args'}`` file in place of the full state: ``cli.train_vmae --resume x.pth``
merges it, which is the stage-1 to stage-3 handoff of
``scripts/train_ae.sh``. Without ``--config`` the DiT's YAML is the one
saved beside the step; the RoPE layout always comes from that saved YAML
when it exists, as ``ldmae_tpu.cli.export_torch`` reads it.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def step_dir(path: str) -> str:
    """The Orbax step directory ``path`` names: itself (a step directory or
    a ``checkpoint-E`` alias, resolved), or the latest step of the
    experiment or stage directory it is, as the JAX VMAE CLI's ``--resume``
    takes the three forms."""
    from ldmae_tpu.train.state import list_checkpoints

    path = os.path.abspath(path)
    if os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA")):
        return os.path.realpath(path)
    steps = list_checkpoints(path)
    if not steps:
        raise FileNotFoundError(f"{path}: no Orbax checkpoint found")
    return os.path.join(path, "checkpoints", f"{steps[-1]:07d}")


def saved_yaml(step_path: str) -> dict:
    """The ``NNNNNNN.config.yaml`` the JAX trainers write beside a step ({}
    where there is none)."""
    import yaml

    path = step_path + ".config.yaml"
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return yaml.safe_load(f) or {}


def restore(step_path: str, params, tx):
    """The train state at ``step_path``, restored by the JAX package against
    the template ``init_train_state(params, tx)`` (``params`` may be shapes:
    the template is traced with ``jax.eval_shape``, so nothing is drawn or
    allocated for it)."""
    import jax

    from ldmae_tpu.train.state import init_train_state, restore_checkpoint

    template = jax.eval_shape(lambda p: init_train_state(p, tx), params)._replace(step=0)
    base = os.path.dirname(os.path.dirname(step_path))
    state = restore_checkpoint(base, template, step=int(os.path.basename(step_path)))
    if state is None:
        raise FileNotFoundError(f"{step_path}: no Orbax checkpoint found")
    return state


def adam_moments(opt_state, params):
    """(mu, nu, count) of optax's Adam state, found by its type wherever the
    optimizer's structure puts it (behind a clip, inside ``multi_transform``).
    A leaf frozen under ``--tune_decoder`` (``set_to_zero``'s label, a
    ``MaskedNode`` in Adam's trees) has no moment: it is None here. Raises
    unless there is exactly one Adam state, and unless every schedule count
    in the optimizer state equals Adam's (the VMAE's learning rate is the
    schedule at that count)."""
    import jax
    import optax

    def of_type(kind):
        leaves = jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, kind))
        return [x for x in leaves if isinstance(x, kind)]

    adam = of_type(optax.ScaleByAdamState)
    if len(adam) != 1:
        raise ValueError(f"expected one optax ScaleByAdamState in the optimizer state, found {len(adam)}")
    (adam,) = adam
    count = int(adam.count)
    schedules = {int(s.count) for s in of_type(optax.ScaleByScheduleState)}
    if schedules - {count}:
        raise ValueError(f"schedule counts {sorted(schedules)} differ from Adam's count {count}")

    def leaves(tree):
        return jax.tree_util.tree_map(lambda p, m: None if isinstance(m, optax.MaskedNode) else np.asarray(m),
                                      params, tree)

    return leaves(adam.mu), leaves(adam.nu), count


def moment_state_dict(tree, params, to_state_dict):
    """A moment tree as a reference-layout state dict through the weights'
    map; the frozen (None) leaves are mapped as zeros and then left out, so
    only the parameters with a moment remain."""
    import jax

    def filled(fill):
        return jax.tree_util.tree_map(lambda p, m: fill(np.shape(p), m), params, tree)

    sd = to_state_dict(filled(lambda shape, m: np.zeros(shape, np.float32) if m is None else m))
    frozen = to_state_dict(filled(lambda shape, m: np.full(shape, m is None, np.float32)))
    return {k: v for k, v in sd.items() if not bool(frozen[k].all())}


def convert_dit(a) -> str:
    import jax
    import yaml

    from ldmae_tpu.core.config import LDMAEConfig
    from ldmae_tpu.train.train_dit import build_from_config
    from ldmae_tpu_torch.convert import dit_state_dict_from_jax
    from ldmae_tpu_torch.core.config import LDMAEConfig as PortConfig
    from ldmae_tpu_torch.train.jax_import import write_dit_checkpoint
    from ldmae_tpu_torch.train.train_dit import spec_from_config

    path = step_dir(a.ckpt)
    saved = saved_yaml(path)
    if a.config:
        with open(a.config) as f:
            raw = yaml.safe_load(f) or {}
    elif saved:
        raw = saved
    else:
        raise FileNotFoundError(f"{path}.config.yaml does not exist: name the run's YAML with --config")
    config = LDMAEConfig.from_dict(raw)
    layout = saved.get("parallel", {}).get("rope_layout", config.parallel.rope_layout)
    built = {}

    def shapes(key):  # the parameters' shapes and the optimizer, as the JAX CLI builds them
        _, _, params, _, built["tx"], _ = build_from_config(config, key)
        return params

    state = restore(path, jax.eval_shape(shapes, jax.random.key(0)), built["tx"])
    spec = spec_from_config(PortConfig.from_dict(raw))

    def to_sd(tree):
        return dit_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree), spec)

    mu, nu, count = adam_moments(state.opt_state, state.params)
    out = write_dit_checkpoint(
        a.out or os.path.dirname(os.path.dirname(path)), raw, to_sd(state.params), to_sd(state.ema_params),
        moment_state_dict(mu, state.params, to_sd), moment_state_dict(nu, state.params, to_sd),
        step=int(state.step), count=count, rope_layout=layout)
    print(f"{path} (step {int(state.step)}, Adam count {count}, rope_layout {layout}) -> {out}")
    return out


def epoch_alias(path: str):
    """E of the ``checkpoint-E`` alias that names the step directory
    ``path`` (the JAX VMAE trainer's epoch links), None without one."""
    d = os.path.dirname(path)
    for name in os.listdir(d):
        if name.startswith("checkpoint-") and os.path.realpath(os.path.join(d, name)) == path:
            return int(name.split("-", 1)[1])
    return None


def convert_vmae(a) -> str:
    import jax

    from ldmae_tpu.models.vmae import init_vmae_params, vmae_spec
    from ldmae_tpu.models.vmae_variants import init_gradual_params
    from ldmae_tpu.train.train_vmae import make_vmae_optimizer
    from ldmae_tpu_torch.cli.train_vmae import model_spec
    from ldmae_tpu_torch.convert import vmae_gradual_state_dict_from_jax, vmae_state_dict_from_jax
    from ldmae_tpu_torch.train.jax_import import vmae_args, write_vmae_checkpoint

    path = step_dir(a.ckpt)
    saved = saved_yaml(path)
    if not saved:
        raise FileNotFoundError(f"{path}.config.yaml (the run's flags) does not exist")
    args = vmae_args(saved)
    # the template, as the JAX CLI builds it from the same flags
    jspec = vmae_spec(
        args.model, img_size=args.input_size, no_cls=args.no_cls, kl_loss_weight=args.kl_loss_weight,
        fixed_std=args.fixed_std, smooth_output=args.smooth_output, pred_with_conv=args.pred_with_conv,
        down_nonlinear=args.down_nonlinear, norm_pix_loss=args.norm_pix_loss,
        perceptual_loss_ratio=1.0 if args.perceptual_loss_ratio is None else args.perceptual_loss_ratio,
        ldmae_mode=args.tune_decoder, use_checkpoint=args.use_checkpoint)
    spec = model_spec(args)
    if args.gradual_resol:
        import dataclasses

        jspec = dataclasses.replace(jspec, patch_size=jspec.patch_size // 2)
    built = {}

    def shapes(key):  # the parameters' shapes (and the gradual blocks' layout), as the JAX CLI builds them
        if not args.gradual_resol:
            return init_vmae_params(key, jspec)
        params, *built["gradual"] = init_gradual_params(key, jspec)
        return params

    params = jax.eval_shape(shapes, jax.random.key(args.seed))
    gradual = tuple(built["gradual"]) if "gradual" in built else None

    def to_sd(tree):
        tree = jax.tree_util.tree_map(np.asarray, tree)
        return vmae_state_dict_from_jax(tree, spec) if gradual is None else vmae_gradual_state_dict_from_jax(
            tree, spec, *gradual)

    tx = make_vmae_optimizer(params, 1, base_lr=0.0, weight_decay=args.weight_decay, tune_decoder=args.tune_decoder)
    state = restore(path, params, tx)
    if a.weights_only:  # the reference VMAE file, as ldmae_tpu.train.torch_export writes it
        import torch

        torch.save({"model": to_sd(state.params), "epoch": epoch_alias(path), "args": saved}, a.weights_only)
        out = a.weights_only
    else:
        mu, nu, count = adam_moments(state.opt_state, state.params)
        out = write_vmae_checkpoint(
            a.out or os.path.dirname(os.path.dirname(path)), saved, to_sd(state.params),
            moment_state_dict(mu, state.params, to_sd), moment_state_dict(nu, state.params, to_sd),
            step=int(state.step), count=count, gradual=gradual)
    print(f"{path} (step {int(state.step)}) -> {out}")
    return out


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="Convert a JAX run's Orbax checkpoint into the PyTorch port's .pt")
    sub = p.add_subparsers(dest="model", required=True)
    dit = sub.add_parser("dit", help="a DiT experiment's checkpoint (cli.train_dit, cli.inference)")
    dit.add_argument("--config", default=None, help="the run's YAML (default: the one saved beside the step)")
    vmae = sub.add_parser("vmae", help="a VMAE stage's checkpoint (cli.train_vmae)")
    for q in (dit, vmae):
        q.add_argument("--ckpt", required=True, help="the experiment / stage directory (its latest step) or a step "
                                                      "directory (or checkpoint-E alias)")
        q.add_argument("--out", default=None, help="directory that gets checkpoints/<step>.pt (default: the "
                                                    "experiment / stage directory)")
    vmae.add_argument("--weights_only", default=None,
                      help="write the reference {'model', 'epoch', 'args'} .pth here instead (for --resume)")
    a = p.parse_args(argv)
    return convert_dit(a) if a.model == "dit" else convert_vmae(a)


if __name__ == "__main__":
    main()

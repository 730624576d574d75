"""The registry's training slice on the CPU: what ``cli.train_dit`` runs at
LightningDiT-L/2, XL/2 and 1p6B/1 through the port against ``ldmae_tpu``.

* One fp32 training step at a narrow spec that keeps what those archs bring
  to training: patch 2, head dim 72 (XL's; two heads, width 144), a SwiGLU
  width off a multiple of 8 (``mlp_ratio`` 2.9: int(2/3 * 417) = 278, as
  L's 2,730 and 1p6B's 4,778 are), remat 'attn', and the shipped YAML's
  training impls (flash_rope, half-split RoPE, fused adaLN) and transport,
  at depth 2 on 8^2 latents, from seeded numpy weights carried by
  ``dit_state_dict_from_jax`` and injected noise, t and label drops. The
  loss within 1e-5 relative and every leaf's gradient within relative L2
  2e-3 of ``jax.value_and_grad`` (the bounds of
  ``test_torch_port_train.py::test_dit_train_step_gradients_match_jax``:
  fp32 on both sides, summation order only); then ``apply_update_`` (the
  global-norm clip, AdamW at the YAML's lr and beta2, the EMA) against the
  JAX package's ``make_optimizer`` (optax) fed the same gradients, every
  leaf of the weights and of the EMA within relative L2 1e-5
  (``test_adamw_clip_ema_steps_match_optax``'s bound). The JAX side runs
  its Pallas kernels in interpret mode, as its own tests do on the CPU; the
  port's wrappers run their plain versions for CPU tensors.
* ``dit_forward_flops`` (the training legs' MFU) at the nine registry
  archs, patch 1 and 2, SwiGLU widths 2,048 to 4,778: equal to the JAX
  count.
* The YAML ``chip_smoke.train_yaml`` writes for the training legs: the
  same DiT spec from both config loaders (the port's ``spec_from_config``,
  the JAX package's ``build_from_config``), exact.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from ldmae_tpu.core.config import LDMAEConfig as JConfig
from ldmae_tpu.models import lightningdit as jdit
from ldmae_tpu.train import torch_import
from ldmae_tpu.train import train_dit as jtrain
from ldmae_tpu.transport import create_transport as jcreate_transport
from ldmae_tpu.utils import profiling as jprofiling

from torch_port_helpers import REPO, randomize, to_numpy

from ldmae_tpu_torch.convert import dit_state_dict_from_jax
from ldmae_tpu_torch.core.config import LDMAEConfig
from ldmae_tpu_torch.models import LightningDiT
from ldmae_tpu_torch.models import lightningdit as tdit
from ldmae_tpu_torch.train import apply_update_, dit_loss, init_train_state, make_optimizer
from ldmae_tpu_torch.train.train_dit import spec_from_config
from ldmae_tpu_torch.transport import create_transport
from ldmae_tpu_torch.utils import profiling as tprofiling

REGISTRY = ["LightningDiT-XL/1", "LightningDiT-XL/2", "LightningDiT-L/2", "LightningDiT-B/1", "LightningDiT-B/2",
            "LightningDiT-1p0B/1", "LightningDiT-1p0B/2", "LightningDiT-1p6B/1", "LightningDiT-1p6B/2"]
FLAGS = dict(in_channels=16, num_classes=1000, use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True)
NARROW = dict(depth=2, hidden_size=144, num_heads=2, patch_size=2, mlp_ratio=2.9, input_size=8, in_channels=16,
              num_classes=10, use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True,
              use_checkpoint=True, remat_policy="attn")
IMPLS = dict(attn_impl="flash_rope", rope_layout="half", adaln_impl="fused")
SHIPPED_YAML = os.path.join(REPO, "configs", "imagenet", "lightningdit_b_vmae_f8d16.yaml")
CLIP, EMA = 1e-3, 0.9999  # a clip that acts at these seeded weights; the train step's EMA decay


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-3))


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_train_step_at_patch2_d72_odd_swiglu_matches_jax():
    cfg = LDMAEConfig.from_yaml(SHIPPED_YAML)
    lr, beta2 = cfg.optimizer.lr, cfg.optimizer.beta2
    js, ts = jdit.dit_spec("LightningDiT-XL/2", **NARROW), tdit.dit_spec("LightningDiT-XL/2", **NARROW)
    assert (ts.patch_size, ts.head_dim, ts.swiglu_hidden, ts.num_patches) == (2, 72, 278, 16)
    assert (js.swiglu_hidden, js.remat_policy) == (278, "attn")
    shapes = jax.eval_shape(lambda key: jdit.init_dit_params(key, js), jax.random.key(0))
    jparams = jdit.permute_qk_for_half_rope(randomize(shapes, 0), js)
    model = LightningDiT(ts, device="cpu")
    model.load_state_dict(dit_state_dict_from_jax(to_numpy(jparams), ts), strict=True)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}

    rng = np.random.default_rng(4)
    x1, x0 = (rng.standard_normal((2, 16, 8, 8)).astype(np.float32) for _ in range(2))
    y, drop, t = np.array([3, 9]), np.array([1, 0], np.int32), 0.41
    kw = dict(use_cosine_loss=cfg.transport.use_cosine_loss, use_lognorm=cfg.transport.use_lognorm)
    transport, consts = jcreate_transport(**kw), jdit.DiTConsts(js)

    def loss_fn(p):
        def model_fn(xt, tt, yk):
            return jdit.dit_forward(p, js, consts, xt, tt, yk, train=True, force_drop_ids=jnp.asarray(drop),
                                    compute_dtype=jnp.float32, **IMPLS)

        terms = transport.training_losses(model_fn, jax.random.key(0), jnp.asarray(x1), dict(yk=jnp.asarray(y)),
                                          sp_timesteps=(t, t), x0=jnp.asarray(x0))
        return terms["loss"].mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    gref = dit_state_dict_from_jax(to_numpy(jgrads), ts)

    loss = dit_loss(model, create_transport(**kw), torch.from_numpy(x1), torch.from_numpy(y),
                    x0=torch.from_numpy(x0), t=torch.full((2,), t), drop_ids=torch.from_numpy(drop),
                    compute_dtype=torch.float32, **IMPLS)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    errs = {n: _rel_l2(g.numpy(), gref[n].numpy()) for n, g in grads.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 2e-3, (worst, errs[worst])
    for fam in ("x_embedder", "qkv", "proj", "adaLN", "w12", "w3", "q_norm", "final_layer"):
        assert any(fam in n and float(g.abs().max()) > 0 for n, g in grads.items()), fam

    # the update: clip + AdamW + EMA against optax fed the port's gradients
    state = init_train_state(model, make_optimizer(model.parameters(), lr, beta2))
    norm = float(apply_update_(state, max_grad_norm=CLIP, ema_decay=EMA))
    assert norm > CLIP  # the clip acts
    names = [n for n, _ in model.named_parameters()]
    params = torch_import.import_dit_state_dict({k: v.numpy() for k, v in sd0.items()}, js)
    full = {k: (grads[k] if k in names else torch.zeros_like(v)).numpy() for k, v in sd0.items()}
    tx = jtrain.make_optimizer(lr, beta2, max_grad_norm=CLIP)

    @jax.jit
    def reference_update(params, grads):
        updates, _ = tx.update(grads, tx.init(params), params)
        new = optax.apply_updates(params, updates)
        return new, jax.tree_util.tree_map(lambda e, p: EMA * e + (1 - EMA) * p, params, new)

    trees = reference_update(params, torch_import.import_dit_state_dict(full, js))
    ref_params, ref_ema = (dit_state_dict_from_jax(to_numpy(tree), ts) for tree in trees)
    for n, p in state.model.named_parameters():
        assert _rel_l2(p.detach().numpy(), ref_params[n].numpy()) <= 1e-5, n
        assert _rel_l2(state.ema.get_parameter(n).detach().numpy(), ref_ema[n].numpy()) <= 1e-5, n
    assert any(not torch.equal(p.detach(), sd0[n]) for n, p in state.model.named_parameters())


@pytest.mark.parametrize("arch", REGISTRY)
def test_flop_accounting_matches_jax_at_every_registry_arch(arch):
    js, ts = jdit.dit_spec(arch, input_size=32, **FLAGS), tdit.dit_spec(arch, input_size=32, **FLAGS)
    assert tprofiling.dit_forward_flops(ts, 32) == jprofiling.dit_forward_flops(js, 32) > 0


@pytest.mark.parametrize("arch", ["LightningDiT-L/2", "LightningDiT-XL/2", "LightningDiT-1p6B/1"])
def test_chip_smoke_train_yaml_gives_one_spec_in_both_packages(tmp_path, arch, monkeypatch):
    """The training legs' YAML: the shipped one with model.model_type, the
    data and the train section's leg settings changed, and nothing else; the
    port's ``spec_from_config`` and the JAX ``build_from_config`` (its weight
    init left out: the 1p6B/1 draw) read the same spec from it."""
    path = _chip_smoke().train_yaml(str(tmp_path / "train.yaml"), arch, str(tmp_path / "latents"),
                                    str(tmp_path / "gates.pt"), str(tmp_path), "leg")
    tcfg, jcfg = LDMAEConfig.from_yaml(path), JConfig.from_yaml(path)
    for cfg, ref in ((tcfg, LDMAEConfig.from_yaml(SHIPPED_YAML)), (jcfg, JConfig.from_yaml(SHIPPED_YAML))):
        assert (cfg.model.model_type, cfg.train.global_batch_size, cfg.data.sample) == (arch, 32, False)
        assert dataclasses.replace(cfg, model=ref.model, data=ref.data, train=ref.train) == ref
        assert dataclasses.replace(cfg.model, model_type=ref.model.model_type) == ref.model
    monkeypatch.setattr(jdit, "init_dit_params", lambda key, spec: None)
    jspec = jtrain.build_from_config(jcfg, jax.random.key(0))[0]
    tspec = spec_from_config(tcfg)
    fields = {f.name for f in dataclasses.fields(tspec)} & {f.name for f in dataclasses.fields(jspec)}
    assert {f: getattr(tspec, f) for f in fields} == {f: getattr(jspec, f) for f in fields}
    assert (tspec.depth, tspec.num_patches, tspec.use_checkpoint, tspec.remat_policy) == (
        {"LightningDiT-1p6B/1": 28, "LightningDiT-XL/2": 28, "LightningDiT-L/2": 24}[arch],
        1024 // tspec.patch_size**2, True, "attn")

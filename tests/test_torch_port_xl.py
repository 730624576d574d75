"""The XL slice on the CPU: LightningDiT-XL/1's head dim 72 through the
port against ``ldmae_tpu``, at an XL-shaped tiny size.

Every test builds ``dit_spec("LightningDiT-XL/1", depth=2, hidden_size=144,
num_heads=2, input_size=8, ...)`` with the shipped YAML's model flags
(qk-norm, SwiGLU, RoPE, RMSNorm), so the attention runs at d = 72 as in XL,
from seeded numpy weights carried by ``dit_state_dict_from_jax``. The JAX
side runs its Pallas kernels as its own tests do on the CPU (interpret
mode); the port's wrappers run their plain versions for CPU tensors. The
card's side (the wgmma kernels at d = 72) is in ``test_torch_port_gpu.py``
and ``chip_smoke.py --xl``.

Tolerances, each that of the B-shaped parity test it mirrors:

* the DiT forward (``test_torch_port_models.py``): max|port - jax| /
  max|jax| within 1e-5 in float32 (summation order only) and 2e-2 in bf16
  (bf16 roundings through the blocks);
* a 4-step CFG chain from an injected z (``test_torch_port_sampling.py``):
  latents within 2e-2 of their scale, decoded images within 2 of 255 levels;
* one fp32 training step (``test_torch_port_train.py``): the loss within
  1e-5 relative; every updated parameter within 1e-6 of its leaf's largest
  |value| (fp32 sums in another order), except where AdamW's first step,
  sign(g), takes the sign of a gradient that is a tie at fp32 resolution
  (|g| <= 1e-4 of the leaf's largest), where the two steps may part by 2 lr;
* the route (``_uses_lse``) and the XL YAML that ``chip_smoke.py`` writes:
  exact.
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
from ldmae_tpu.eval import sampling as jsampling
from ldmae_tpu.models import lightningdit as jdit
from ldmae_tpu.models import vmae as jvmae
from ldmae_tpu.train.train_dit import make_optimizer as jmake_optimizer
from ldmae_tpu.transport import create_transport as jcreate_transport

from torch_port_helpers import REPO, randomize, to_numpy

from ldmae_tpu_torch.convert import dit_state_dict_from_jax, vmae_state_dict_from_jax
from ldmae_tpu_torch.core.config import LDMAEConfig
from ldmae_tpu_torch.eval.sampling import make_sample_fn
from ldmae_tpu_torch.models import VMAE, LightningDiT
from ldmae_tpu_torch.models import lightningdit as tdit
from ldmae_tpu_torch.models import vmae as tvmae
from ldmae_tpu_torch.ops import flash_attention as tfa
from ldmae_tpu_torch.train import init_train_state, make_optimizer, make_train_step
from ldmae_tpu_torch.transport import create_transport

XL = "LightningDiT-XL/1"
# XL's head dim (1,152 / 16 = 72) at a tiny width and depth, the YAML's flags
XL_DIT = dict(depth=2, hidden_size=144, num_heads=2, input_size=8, in_channels=16, num_classes=10,
              use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True, wo_shift=False)
VAE = dict(img_size=64, depth=1, decoder_depth=2, ldmae_mode=True, no_cls=True,
           kl_loss_weight=True, smooth_output=True)
KERNEL_IMPLS = dict(attn_impl="flash_rope", rope_layout="half", adaln_impl="fused", mlp_impl="fused")
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FWD_REL = {"float32": 1e-5, "bfloat16": 2e-2}
SHIPPED_YAML = os.path.join(REPO, "configs", "imagenet", "lightningdit_b_vmae_f8d16.yaml")


def _rel_max(port, ref):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def _specs(**extra):
    js, ts = jdit.dit_spec(XL, **XL_DIT, **extra), tdit.dit_spec(XL, **XL_DIT, **extra)
    assert ts.hidden_size // ts.num_heads == 72
    return js, ts


def _half_models(js, ts, seed=0, std=0.02):
    """Seeded JAX parameters in the half RoPE layout (SwiGLU merged, as the
    JAX sampling path takes them) and the port's DiT carrying the same."""
    params = jdit.permute_qk_for_half_rope(randomize(jdit.init_dit_params(jax.random.key(0), js), seed, std), js)
    model = LightningDiT(ts, device="cpu")
    model.load_state_dict(dit_state_dict_from_jax(to_numpy(params), ts), strict=True)
    return params, model


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_xl_dit_forward_matches_jax(dt):
    """The eval forward under flash_rope (half-split RoPE, fused adaLN and
    SwiGLU), d = 72."""
    js, ts = _specs()
    params, model = _half_models(js, ts)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    t = np.array([0.3, 0.71], np.float32)
    y = np.array([3, 10])  # 10 = the null class
    jd, td = DT[dt]
    ref = jdit.dit_forward(jdit.merge_swiglu(params, js), js, jdit.DiTConsts(js), jnp.asarray(x),
                           jnp.asarray(t).astype(jd), jnp.asarray(y), compute_dtype=jd, **KERNEL_IMPLS)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t).to(td), torch.from_numpy(y), compute_dtype=td,
                    **KERNEL_IMPLS)
    assert out.shape == (2, 16, 8, 8)
    assert np.abs(np.asarray(ref)).max() > 1e-3  # the gates are non-zero
    assert _rel_max(out.numpy(), ref) < FWD_REL[dt]


def test_xl_sample_chain_matches_jax():
    """4 Euler steps, timestep shift 0.3, CFG 4 on [0.10, 1] (phased: the
    first steps single-batch), the first-3-channel guidance, the latent
    statistics, the VMAE decode to uint8, bf16, from one injected z."""
    js, ts = _specs()
    jparams, dit = _half_models(js, ts, std=0.05)
    jvs, tvs = jvmae.vmae_spec("mae_for_ldmae_f8d16_prev", **VAE), tvmae.vmae_spec("mae_for_ldmae_f8d16_prev", **VAE)
    jvparams = randomize(jvmae.init_vmae_params(jax.random.key(1), jvs), 1)
    vae = VMAE(tvs, device="cpu")
    vae.load_state_dict(vmae_state_dict_from_jax(to_numpy(jvparams), tvs))
    rng = np.random.default_rng(2)
    mean = (0.1 * rng.standard_normal((1, 16, 1, 1))).astype(np.float32)
    std = (1 + 0.1 * rng.standard_normal((1, 16, 1, 1))).astype(np.float32)
    jbundle = {"dit": jdit.merge_swiglu(jparams, js), "vae": jvparams, "latent_mean": jnp.asarray(mean),
               "latent_std": jnp.asarray(std)}
    tbundle = {"dit": dit, "vae": vae, "latent_mean": torch.from_numpy(mean), "latent_std": torch.from_numpy(std)}
    chain = dict(num_steps=4, sampling_method="euler", timestep_shift=0.3, cfg_scale=4.0, cfg_interval=True,
                 cfg_interval_start=0.10, cfg_channels=3, **KERNEL_IMPLS)
    jfn = jsampling.make_sample_fn(js, jdit.DiTConsts(js), jcreate_transport(), vae_spec=jvs,
                                   vae_consts=jvmae.VMAEConsts(jvs), compute_dtype=jnp.bfloat16, **chain)
    tfn = make_sample_fn(ts, create_transport(), compute_dtype=torch.bfloat16, device="cpu", **chain)
    z = np.random.default_rng(7).standard_normal((2, 16, 8, 8)).astype(np.float32)
    y = np.array([1, 7])
    jimgs = np.asarray(jfn(jbundle, jax.random.key(0), jnp.asarray(y), z=jnp.asarray(z)))
    timgs = tfn(tbundle, torch.from_numpy(y), z=torch.from_numpy(z)).numpy()
    assert timgs.dtype == np.uint8 and timgs.shape == (2, 64, 64, 3)
    assert np.abs(timgs.astype(int) - jimgs.astype(int)).max() <= 2
    assert timgs.std() > 1.0
    jlat = np.asarray(jfn(dict(jbundle, vae=None), jax.random.key(0), jnp.asarray(y), z=jnp.asarray(z)))
    tlat = tfn(dict(tbundle, vae=None), torch.from_numpy(y), z=torch.from_numpy(z)).numpy()
    assert np.abs(tlat - jlat).max() <= 2e-2 * np.abs(jlat).max()
    assert np.abs(tlat - (z * std + mean)).max() > 1e-2  # the DiT moved the latents


def test_xl_train_step_matches_jax():
    """One fp32 step of the shipped YAML's training configuration (flash_rope,
    half RoPE, fused adaLN, remat 'attn', AdamW at its lr and beta2) from
    injected noise, t and label drops: the port's ``make_train_step``
    against the JAX loss's ``jax.value_and_grad`` and the JAX package's
    optimizer (``make_optimizer``) applied to those gradients."""
    cfg = LDMAEConfig.from_yaml(SHIPPED_YAML)
    lr, beta2 = cfg.optimizer.lr, cfg.optimizer.beta2
    js, ts = _specs(use_checkpoint=True, remat_policy="attn")
    jparams, model = _half_models(js, ts)
    rng = np.random.default_rng(3)
    x1, x0 = (rng.standard_normal((2, 16, 8, 8)).astype(np.float32) for _ in range(2))
    y, drop, t = np.array([1, 9]), np.array([0, 1], np.int32), 0.37
    impls = dict(attn_impl="flash_rope", rope_layout="half", adaln_impl="fused")
    kw = dict(use_cosine_loss=cfg.transport.use_cosine_loss, use_lognorm=cfg.transport.use_lognorm)
    transport = jcreate_transport(**kw)
    consts = jdit.DiTConsts(js)

    def loss_fn(p):
        def model_fn(xt, tt, yk):
            return jdit.dit_forward(p, js, consts, xt, tt, yk, train=True, force_drop_ids=jnp.asarray(drop),
                                    compute_dtype=jnp.float32, **impls)

        terms = transport.training_losses(model_fn, jax.random.key(0), jnp.asarray(x1), dict(yk=jnp.asarray(y)),
                                          sp_timesteps=(t, t), x0=jnp.asarray(x0))
        return terms["loss"].mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    tx = jmake_optimizer(lr, beta2)
    updates, _ = tx.update(jgrads, tx.init(jparams), jparams)
    ref = dit_state_dict_from_jax(to_numpy(optax.apply_updates(jparams, updates)), ts)
    gref = dit_state_dict_from_jax(to_numpy(jgrads), ts)
    start = dit_state_dict_from_jax(to_numpy(jparams), ts)

    state = init_train_state(model, make_optimizer(model.parameters(), lr, beta2))
    step = make_train_step(ts, create_transport(**kw), compute_dtype=torch.float32, **impls)
    metrics = step(state, {"x": torch.from_numpy(x1), "y": torch.from_numpy(y)}, x0=torch.from_numpy(x0),
                   t=torch.full((2,), t), drop_ids=torch.from_numpy(drop))
    assert abs(float(metrics["loss"]) - float(jloss)) <= 1e-5 * abs(float(jloss))
    moved = 0
    for name, p in state.model.named_parameters():
        new, want, g = p.detach().numpy(), ref[name].numpy(), np.abs(gref[name].numpy())
        off = np.abs(new - want) > 1e-6 * np.abs(want).max()
        assert not (off & (g > 1e-4 * g.max())).any(), name
        assert np.abs(np.abs(new - want)[off]).max(initial=0) <= 2 * lr * (1 + 1e-3), name
        moved += int((new != start[name].numpy()).sum())
    assert moved > 0  # the step moved the weights


@pytest.mark.parametrize("dtype,d,vec,want", [
    (torch.bfloat16, 72, 8, True),   # XL, 16-byte aligned rows: the one-pass backward takes lse
    (torch.bfloat16, 64, 8, True),
    (torch.bfloat16, 72, 4, False),  # rows off 16 bytes: the three passes
    (torch.bfloat16, 80, 8, False),
    (torch.bfloat16, 16, 8, True),   # the VMAE's d = 16 (N <= RESIDENT_MAX_N, no RoPE): the one-pass backward
    (torch.bfloat16, 16, 4, False),
    (torch.float32, 72, 4, True),    # every fp32 backward takes lse
])
def test_uses_lse_route(dtype, d, vec, want):
    assert tfa._uses_lse(dtype, d, vec) is want


def test_lse_saved_at_d72_on_the_cpu():
    """The autograd Function saves the forward's output and the plain lse
    at d = 72 (the tensors the card's one-pass backward takes)."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 24, 72, generator=g).requires_grad_() for _ in range(3))
    out = tfa.flash_attention(q, k, v)
    saved = out.grad_fn.saved_tensors
    torch.testing.assert_close(saved[-1], tfa.flash_attention_lse_plain(q.detach(), k.detach()), rtol=0, atol=0)
    assert saved[-2].shape == (1, 2, 24, 72)


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def test_chip_smoke_xl_yaml_loads_in_both_packages(tmp_path):
    """The YAML that ``chip_smoke.py`` writes for its XL legs, before the legs'
    own train and sample sections: the shipped YAML with model.model_type
    LightningDiT-XL/1 and nothing else changed, in both config loaders; the
    DiT it names has head dim 72."""
    path = _chip_smoke().xl_yaml(str(tmp_path / "xl.yaml"))
    shipped_t, shipped_j = LDMAEConfig.from_yaml(SHIPPED_YAML), JConfig.from_yaml(SHIPPED_YAML)
    for loader, shipped in ((LDMAEConfig, shipped_t), (JConfig, shipped_j)):
        cfg = loader.from_yaml(path)
        assert cfg.model.model_type == XL
        assert dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, model_type=shipped.model.model_type)) \
            == shipped
    cfg = LDMAEConfig.from_yaml(path)
    spec = tdit.dit_spec(cfg.model.model_type)
    assert spec.hidden_size // spec.num_heads == 72 and (spec.depth, spec.hidden_size) == (28, 1152)
    jspec = jdit.dit_spec(JConfig.from_yaml(path).model.model_type)
    assert jspec.hidden_size // jspec.num_heads == 72

"""Port models vs ``ldmae_tpu.models`` on the CPU: the LightningDiT eval
forward, the VMAE decode, and the weight bridge (``convert``) against
``ldmae_tpu.train.torch_export`` key for key.

Every parameter is a seeded numpy draw (normal x 0.02; norm weights 1 +
that), the adaLN and final-layer weights included: with the reference's
zero init the DiT returns exactly 0 and the comparison would be empty.

Tolerances, as max|port - jax| / max|jax|: float32 1e-5 (same algorithm,
summation order only); bf16 2e-2 (bf16 roundings through several blocks;
the two packages round at the same points, so the measured error is far
below this).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ldmae_tpu.models import lightningdit as jdit
from ldmae_tpu.models import vmae as jvmae
from ldmae_tpu.train.torch_export import export_dit_state_dict, export_vmae_state_dict

from torch_port_helpers import randomize, to_numpy

from ldmae_tpu_torch.convert import dit_state_dict_from_jax, vmae_state_dict_from_jax
from ldmae_tpu_torch.models import VMAE, LightningDiT, permute_qk_for_half_rope
from ldmae_tpu_torch.models import lightningdit as tdit
from ldmae_tpu_torch.models import vmae as tvmae

REL = {"float32": 1e-5, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# small DiT that reaches all three DiT kernels: swiglu_hidden 1024, D % 128 == 0
SMALL_DIT = dict(input_size=16, in_channels=16, num_classes=10, depth=2, hidden_size=384,
                 num_heads=6, use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True)


def rel_err(port, ref):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def _dit(spec_kw, seed=0):
    js = jdit.dit_spec("LightningDiT-B/1", **spec_kw)
    ts = tdit.dit_spec("LightningDiT-B/1", **spec_kw)
    params = randomize(jdit.init_dit_params(jax.random.key(0), js), seed)
    return js, ts, params


@pytest.mark.parametrize(
    "impls", [("xla", "interleaved", "xla", "xla"), ("flash_rope", "half", "fused", "fused")],
    ids=["xla", "kernels"],
)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_dit_forward_matches_jax(dt, impls):
    attn, layout, adaln, mlp = impls
    js, ts, params = _dit(SMALL_DIT)
    sd = dit_state_dict_from_jax(to_numpy(params), ts)
    jp = params
    if layout == "half":
        jp = jdit.merge_swiglu(jdit.permute_qk_for_half_rope(params, js), js)
        sd = permute_qk_for_half_rope(sd, ts)
    model = LightningDiT(ts, device="cpu")
    model.load_state_dict(sd, strict=True)

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    t = np.array([0.3, 0.71], np.float32)
    y = np.array([3, 10])  # 10 = the null class
    jd, td = DT[dt]
    kw = dict(attn_impl=attn, rope_layout=layout, adaln_impl=adaln, mlp_impl=mlp)
    ref = jdit.dit_forward(jp, js, jdit.DiTConsts(js), jnp.asarray(x), jnp.asarray(t).astype(jd),
                           jnp.asarray(y), compute_dtype=jd, **kw)
    with torch.no_grad():  # sampling callers turn grad off themselves
        out = model(torch.from_numpy(x), torch.from_numpy(t).to(td), torch.from_numpy(y),
                    compute_dtype=td, **kw)
    assert out.dtype == torch.float32 and out.shape == (2, 16, 16, 16)
    assert np.abs(np.asarray(ref)).max() > 1e-3  # the gates are non-zero
    assert rel_err(out.numpy(), ref) < REL[dt]


def test_permute_qk_for_half_rope_roundtrip_and_match():
    js, ts, params = _dit(SMALL_DIT, seed=2)
    sd = dit_state_dict_from_jax(to_numpy(params), ts)
    half = permute_qk_for_half_rope(sd, ts)
    back = permute_qk_for_half_rope(half, ts, inverse=True)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    jhalf = dit_state_dict_from_jax(to_numpy(jdit.permute_qk_for_half_rope(params, js)), ts)
    for k in sd:
        torch.testing.assert_close(half[k], jhalf[k], rtol=0, atol=0)


@pytest.mark.parametrize(
    "spec_kw",
    [SMALL_DIT,
     dict(input_size=8, in_channels=4, num_classes=5, depth=1, hidden_size=64, num_heads=4,
          patch_size=2, use_qknorm=True, learn_sigma=True),
     dict(input_size=8, in_channels=4, num_classes=1, depth=1, hidden_size=64, num_heads=4,
          class_dropout_prob=0.0, wo_shift=True)],
    ids=["b1-like", "layernorm-qk-gelu-p2", "wo-shift"],
)
def test_dit_weight_bridge_matches_torch_export(spec_kw):
    js, ts, params = _dit(spec_kw, seed=3)
    ours = dit_state_dict_from_jax(to_numpy(params), ts)
    theirs = export_dit_state_dict(params, js)
    assert set(ours) == set(theirs)
    for k in theirs:
        assert ours[k].shape == theirs[k].shape, k
        torch.testing.assert_close(ours[k], theirs[k], rtol=0, atol=0)
    model = LightningDiT(ts, device="cpu")
    model.load_state_dict(ours, strict=True)
    assert set(model.state_dict()) == set(theirs)


VMAE_VARIANTS = {
    "prod": ("mae_for_ldmae_f8d16_prev", dict(smooth_output=True)),
    "pred_with_conv": ("mae_for_ldmae_f8d16_prev", dict(smooth_output=True, pred_with_conv=True)),
    "linear_head_cls": ("mae_for_ldmae_f8d16_prev", dict(no_cls=False, ldmae_mode=False)),
    "down_nonlinear": ("mae_for_ldmae_f8d16", dict(smooth_output=True)),
    # head dims the first CUDA kernels refused: 12 (decoder width 96, 8 heads), 24
    "small": ("mae_for_ldmae_f8d16_small", dict(smooth_output=True)),
    "prev_large": ("mae_for_ldmae_f8d16_prev_large", dict(smooth_output=True)),
    # patch 14: the linear head's 14 x 14 x 3 = 588 outputs, not a multiple of 8
    "huge_patch14": ("mae_vit_huge_patch14", dict(img_size=56)),
}


def _vmae(variant, seed=0):
    arch, kw = VMAE_VARIANTS[variant]
    kw = dict(dict(img_size=32, depth=1, decoder_depth=2, ldmae_mode=True, no_cls=True,
                   kl_loss_weight=True), **kw)
    js, ts = jvmae.vmae_spec(arch, **kw), tvmae.vmae_spec(arch, **kw)
    return js, ts, randomize(jvmae.init_vmae_params(jax.random.key(0), js), seed)


@pytest.mark.parametrize("variant", list(VMAE_VARIANTS))
def test_vmae_weight_bridge_matches_torch_export(variant):
    js, ts, params = _vmae(variant, seed=4)
    ours = vmae_state_dict_from_jax(to_numpy(params), ts)
    theirs = export_vmae_state_dict(params, js)
    assert set(ours) == set(theirs)
    for k in theirs:
        torch.testing.assert_close(ours[k], theirs[k], rtol=0, atol=0)
    model = VMAE(ts, device="cpu")
    model.load_state_dict(ours, strict=True)


@pytest.mark.parametrize(
    "variant,dt,impl",
    [("prod", "float32", "xla"), ("prod", "bfloat16", "flash_rope"),
     ("pred_with_conv", "float32", "flash"), ("linear_head_cls", "float32", "xla"),
     ("down_nonlinear", "bfloat16", "xla"), ("small", "float32", "flash"), ("small", "bfloat16", "flash"),
     ("prev_large", "float32", "flash"), ("huge_patch14", "float32", "xla"),
     ("huge_patch14", "bfloat16", "flash")],
)
def test_vmae_decode_matches_jax(variant, dt, impl):
    js, ts, params = _vmae(variant, seed=5)
    model = VMAE(ts, device="cpu")
    model.load_state_dict(vmae_state_dict_from_jax(to_numpy(params), ts), strict=True)
    z = np.random.default_rng(6).standard_normal((2, ts.latent_dim, 4, 4)).astype(np.float32)
    jd, td = DT[dt]
    ref = jvmae.decode(params, js, jvmae.VMAEConsts(js), jnp.asarray(z), compute_dtype=jd, attn_impl=impl)
    out = model.decode(torch.from_numpy(z), compute_dtype=td, attn_impl=impl)
    assert out.shape == (2, 3, ts.img_size, ts.img_size) and out.dtype == torch.float32
    assert rel_err(out.numpy(), ref) < REL[dt]
    if variant == "prod":
        imgs = model.decode_to_images(torch.from_numpy(z), compute_dtype=td, attn_impl=impl)
        jimgs = np.asarray(jvmae.decode_to_images(params, js, jvmae.VMAEConsts(js), jnp.asarray(z),
                                                  compute_dtype=jd, attn_impl=impl))
        assert imgs.dtype == torch.uint8 and imgs.shape == (2, 32, 32, 3)
        assert np.abs(imgs.numpy().astype(int) - jimgs.astype(int)).max() <= 1

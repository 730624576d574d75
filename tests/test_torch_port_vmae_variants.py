"""The port's VMAE variants (``models/vmae_variants.py``), the gradual
trainer and the dataset wrappers (``data/datasets.py``) against
``ldmae_tpu`` on the CPU.

The gradual arch is ``mae_for_ldmae_f8d16_small`` cut to depth 1 + 1 / 1 + 1
(the token downsample after the first encoder block, the upsample after the
first decoder block) at 32^2 with the patch halved to 4: 64 tokens of
width 96 (head dim 12) down to 16, batch 3, the stage-1 flags (no_cls,
smooth_output, KL with fixed_std 1e-3, mask ratio 0.25, visible_loss_ratio
0.75), seeded non-zero weights carried by
``convert.vmae_gradual_state_dict_from_jax``.

* ``token_downsample`` / ``token_upsample``: within 1e-5 (float32) and
  equal after the bf16 rounding but for one bf16 ulp.
* ``vit_block`` with LayerScale, and its attention maps (logits, context):
  within 1e-5; DropPath with the JAX package's masks (drawn from a JAX key)
  within 1e-5; in eval mode or without a generator it drops nothing; under
  ``use_checkpoint`` the same output and gradients (1e-6), the masks drawn
  once.
* ``forward_vanilla_gradual``: loss within 1e-5 relative and every gradient
  leaf within relative L2 2e-3 in float32 (``xla`` and ``flash``, the Pallas
  kernels in interpret mode; summation order only;
  ``tests/test_torch_port_vmae_train.py``'s bounds).
* A gradual ``.pth`` in the reference layout (the convolutions inside the
  block lists), written from the port's model, read by
  ``import_vmae_state_dict_gradual``: the same loss (1e-5); the weight
  bridge's output imports back to the JAX tree exactly; the weight-decay
  mask of the gradual tree leaf by leaf.
* The linear probes within 1e-5, their gradient reaching the head only.
* ``cli.train_vmae --gradual_resol`` trains (finite losses, the reference
  layout in its checkpoint, a ``--resume`` of it loads every tensor).
* The dataset wrappers on fixtures in ``tmp_path``: the same arrays,
  labels and substitutions as ``ldmae_tpu.data.datasets``.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldmae_tpu.models import vmae as jvmae
from ldmae_tpu.models import vmae_variants as jvv
from ldmae_tpu.train import torch_import as jimport
from ldmae_tpu.train import train_vmae as jtrain

from torch_port_helpers import randomize, to_numpy

from ldmae_tpu_torch.convert import vmae_gradual_state_dict_from_jax, vmae_state_dict_from_jax
from ldmae_tpu_torch.models import VMAE, seeded_init_
from ldmae_tpu_torch.models import vmae as tvmae
from ldmae_tpu_torch.models import vmae_variants as tvv
from ldmae_tpu_torch.train import train_vmae as ttrain

B, IMG = 3, 32
STAGE1 = dict(img_size=IMG, depth=2, decoder_depth=2, no_cls=True, smooth_output=True, kl_loss_weight=1e-6,
              fixed_std=1e-3)
MASK_RATIO, VIS_RATIO = 0.25, 0.75
GRAD_REL_L2, LOSS_REL = 2e-3, 1e-5


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-3))


def _specs(**kw):
    js = jvmae.vmae_spec("mae_for_ldmae_f8d16_small", **STAGE1, **kw)
    js = dataclasses.replace(js, patch_size=js.patch_size // 2)
    ts = tvmae.vmae_spec("mae_for_ldmae_f8d16_small", **STAGE1, **kw)
    return js, dataclasses.replace(ts, patch_size=ts.patch_size // 2)


def _gradual_pair(seed=0, **kw):
    js, ts = _specs(**kw)
    params, down, up = jvv.init_gradual_params(jax.random.key(0), js)
    params = randomize(params, 30 + seed)
    model = tvv.GradualVMAE(ts, down, up, device="cpu")
    model.load_state_dict(vmae_gradual_state_dict_from_jax(to_numpy(params), ts, down, up), strict=True)
    return js, params, (down, up), model


def _gradual_inputs(seed, js):
    rng = np.random.default_rng(seed)
    n_tok = js.grid**2
    imgs = rng.uniform(-1, 1, (B, 3, IMG, IMG)).astype(np.float32)
    mask_noise = rng.uniform(size=(B, n_tok)).astype(np.float32)
    latent_noise = rng.standard_normal((B, js.latent_dim, n_tok // 4)).astype(np.float32)
    return imgs, mask_noise, latent_noise


# ---------------------------------------------------------------------------
# Token convolutions, the block extras
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_token_downsample_upsample_match_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 8)).astype(np.float32)
    w = (0.2 * rng.standard_normal((8, 8, 3, 3))).astype(np.float32)
    b = (0.1 * rng.standard_normal(8)).astype(np.float32)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))
    down, up = tvv.TokenDownsample(8, "cpu"), tvv.TokenUpsample(8, "cpu")
    for m in (down, up):
        m.conv.weight.data, m.conv.bias.data = torch.from_numpy(w), torch.from_numpy(b)
    with torch.no_grad():
        got = (down(tx), up(tx))
    want = (jvv.token_downsample(jx, jp), jvv.token_upsample(jx, jp))
    for g, r, shape in zip(got, want, ((2, 16, 8), (2, 256, 8))):
        assert tuple(g.shape) == r.shape == shape and g.dtype == getattr(torch, dtype)
        tol = 1e-5 if dtype == "float32" else 2**-7 * float(np.abs(np.asarray(r, np.float32)).max())
        np.testing.assert_allclose(g.float().numpy(), np.asarray(r, np.float32), rtol=0, atol=tol)


def _block_pair(seed):
    """A JAX block with LayerScale and the port's VitBlock with the same
    weights (width 96, 8 heads), and an input."""
    js = jvmae.vmae_spec("mae_for_ldmae_f8d16_small", img_size=IMG, depth=1, decoder_depth=1)
    params = randomize(jvmae.init_vmae_params(jax.random.key(0), js), seed)
    rng = np.random.default_rng(seed)
    gammas = [(1 + 0.5 * rng.standard_normal(js.embed_dim)).astype(np.float32) for _ in range(2)]
    bp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"])
    bp = dict(bp, ls1={"gamma": jnp.asarray(gammas[0])}, ls2={"gamma": jnp.asarray(gammas[1])})
    model = VMAE(tvmae.vmae_spec("mae_for_ldmae_f8d16_small", img_size=IMG, depth=1, decoder_depth=1), device="cpu")
    model.load_state_dict(vmae_state_dict_from_jax(to_numpy(params), model.spec))
    block = tvv.add_layer_scale_(model.blocks[0])
    block.ls1.gamma.data, block.ls2.gamma.data = (torch.from_numpy(g) for g in gammas)
    x = rng.standard_normal((B, 16, js.embed_dim)).astype(np.float32)
    return bp, block, x, js.num_heads


def test_vit_block_layer_scale_and_attention_maps_match_jax():
    bp, block, x, heads = _block_pair(40)
    with torch.no_grad():
        out = tvv.vit_block(torch.from_numpy(x), block, heads)
        out_m, (logits, ctx) = tvv.vit_block(torch.from_numpy(x), block, heads, return_attn_map=True)
    jout = np.asarray(jvv.vit_block(jnp.asarray(x), bp, heads))
    jout_m, (jlogits, jctx) = jvv.vit_block(jnp.asarray(x), bp, heads, return_attn_map=True)
    assert np.abs(jout - x).max() > 0.1  # the residual branches moved x
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out_m.numpy(), np.asarray(jout_m), rtol=0, atol=1e-5)
    assert tuple(logits.shape) == jlogits.shape == (B, heads, 16, 16)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), rtol=0, atol=1e-5)


def test_drop_path_matches_jax_and_is_off_at_eval():
    bp, block, x, heads = _block_pair(41)
    rate = 0.5
    key = jax.random.key(3)
    jout = np.asarray(jvv.vit_block(jnp.asarray(x), bp, heads, drop_path_rate=rate, drop_key=key))
    # the JAX package's two masks, from the same key, through the port's block
    masks = [torch.from_numpy(np.asarray(jax.random.bernoulli(k, 1 - rate, (B, 1, 1)), np.float32) / (1 - rate))
             for k in jax.random.split(key)]
    assert 0 < sum(float((m == 0).sum()) for m in masks) < 2 * B  # some samples dropped, not all
    with torch.no_grad():
        out = tvv._block_body(torch.from_numpy(x), block, heads, masks, "xla", False)
        plain = tvv.vit_block(torch.from_numpy(x), block, heads)
        gen = torch.Generator().manual_seed(0)
        block.eval()
        assert torch.equal(tvv.vit_block(torch.from_numpy(x), block, heads, drop_path_rate=rate, generator=gen), plain)
        block.train()
        assert torch.equal(tvv.vit_block(torch.from_numpy(x), block, heads, drop_path_rate=rate), plain)
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=1e-5)
    m = tvv.drop_path_mask(10_000, rate, torch.Generator().manual_seed(1), "cpu", torch.float32)
    assert set(m.unique().tolist()) == {0.0, 2.0} and abs(float(m.mean()) - 1.0) < 0.05


def test_drop_path_under_checkpoint_keeps_its_masks():
    """The masks are drawn before the block, so the recomputation in the
    backward sees the forward's: the same output and gradients."""
    _, block, x, heads = _block_pair(42)

    def run(use_checkpoint):
        block.zero_grad(set_to_none=True)
        xt = torch.from_numpy(x).requires_grad_()
        out = tvv.vit_block(xt, block, heads, drop_path_rate=0.5, generator=torch.Generator().manual_seed(5),
                            use_checkpoint=use_checkpoint)
        (out * torch.linspace(-1, 1, out.numel()).reshape(out.shape)).sum().backward()
        return out.detach(), xt.grad, {n: p.grad.clone() for n, p in block.named_parameters()}

    out, gx, grads = run(False)
    out_c, gx_c, grads_c = run(True)
    assert torch.allclose(out, out_c, atol=1e-6) and torch.allclose(gx, gx_c, atol=1e-6)
    for n in grads:
        assert torch.allclose(grads[n], grads_c[n], atol=1e-6), n


# ---------------------------------------------------------------------------
# gradual_resol
# ---------------------------------------------------------------------------


def test_gradual_layout_and_consts():
    """The convolutions sit in the block lists at their indices (the
    reference's layout); the encoder's table is on the 8 x 8 grid, the
    decoder's on 4 x 4; the forward goes 64 -> 16 -> 64 tokens."""
    js, params, (down, up), model = _gradual_pair()
    assert (down, up) == (1, 1) and len(model.blocks) == 3 and len(model.decoder_blocks) == 3
    assert isinstance(model.blocks[1], tvv.TokenDownsample) and isinstance(model.decoder_blocks[1], tvv.TokenUpsample)
    consts = jvv.GradualConsts(js)
    np.testing.assert_array_equal(model.pos_embed[0].numpy(), np.asarray(consts.pos_embed))
    np.testing.assert_array_equal(model.decoder_pos_embed[0].numpy(), np.asarray(consts.decoder_pos_embed))
    imgs, noise, _ = _gradual_inputs(0, js)
    with torch.no_grad():
        x, mask, _ = model.forward_encoder_with_mask(torch.from_numpy(imgs), MASK_RATIO, torch.from_numpy(noise))
        pred = model.forward_decoder_without_mask(model._latent_proj(model._latent_proj(x, model.to_latent)[..., :16],
                                                                     model.from_latent))
    assert x.shape == (B, 16, 96) and mask.shape == (B, 64) and pred.shape == (B, 64, 48)


@pytest.mark.parametrize("impl,dtype", [("xla", "float32"), ("flash", "float32")])
def test_forward_vanilla_gradual_matches_jax(impl, dtype):
    js, params, (down, up), model = _gradual_pair(1)
    imgs, mask_noise, latent_noise = _gradual_inputs(2, js)
    consts = jvv.GradualConsts(js)

    def jloss(p):
        out = jvv.forward_vanilla_gradual(
            p, js, consts, jnp.asarray(imgs), jax.random.key(0), down, up, mask_ratio=MASK_RATIO,
            visible_loss_ratio=VIS_RATIO, compute_dtype=getattr(jnp, dtype), attn_impl=impl,
            mask_noise=jnp.asarray(mask_noise), latent_noise=jnp.asarray(latent_noise))
        return out["loss"], out

    (jl, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    out = tvv.forward_vanilla_gradual(
        model, torch.from_numpy(imgs), mask_ratio=MASK_RATIO, visible_loss_ratio=VIS_RATIO,
        compute_dtype=getattr(torch, dtype), attn_impl=impl, mask_noise=torch.from_numpy(mask_noise),
        latent_noise=torch.from_numpy(latent_noise))
    out["loss"].backward()
    out = {k: v.detach() for k, v in out.items()}
    assert abs(float(out["loss"]) - float(jl)) <= LOSS_REL * abs(float(jl))
    for k in ("vis_loss", "mask_loss", "kl_loss"):
        assert abs(float(out[k]) - float(jout[k])) <= LOSS_REL * abs(float(jout[k])) + 1e-12, k
    np.testing.assert_array_equal(out["mask"].numpy(), np.asarray(jout["mask"], np.float32))
    ref = vmae_gradual_state_dict_from_jax(to_numpy(jgrads), model.spec, down, up)
    checked = 0
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        err = _rel_l2(p.grad.numpy(), ref[name].numpy())
        assert err <= GRAD_REL_L2, (name, err)
        checked += 1
    assert checked == len(ref) - 2  # every parameter; the two positional tables are buffers


def test_gradual_reference_pth_loads_like_jax(tmp_path):
    """The port's gradual state dict is the reference's layout: the JAX
    importer reads a .pth written from it to the same loss, and the weight
    bridge's output imports back to the JAX tree exactly."""
    js, ts = _specs()
    model = seeded_init_(tvv.GradualVMAE(ts, device="cpu"), 7)
    path = str(tmp_path / "gradual.pth")
    torch.save({"model": model.state_dict()}, path)
    jparams = jimport.import_vmae_state_dict_gradual(jimport.load_torch_state_dict(path), js, 1, 1)
    jparams["mask_token"] = jnp.asarray(model.mask_token.detach().numpy().reshape(-1))  # ldmae_mode off: kept
    imgs, mask_noise, latent_noise = _gradual_inputs(3, js)
    jout = jvv.forward_vanilla_gradual(jparams, js, jvv.GradualConsts(js), jnp.asarray(imgs), jax.random.key(0), 1, 1,
                                       mask_ratio=MASK_RATIO, visible_loss_ratio=VIS_RATIO,
                                       mask_noise=jnp.asarray(mask_noise), latent_noise=jnp.asarray(latent_noise))
    with torch.no_grad():
        out = model.forward_vanilla(torch.from_numpy(imgs), mask_ratio=MASK_RATIO, visible_loss_ratio=VIS_RATIO,
                                    mask_noise=torch.from_numpy(mask_noise), latent_noise=torch.from_numpy(latent_noise))
    assert abs(float(out["loss"]) - float(jout["loss"])) <= LOSS_REL * abs(float(jout["loss"]))
    fresh = tvv.GradualVMAE(ts, device="cpu")
    merged = tvmae.load_vmae_weights_(fresh, path)
    assert merged["missing"] == [] and merged["unexpected"] == []

    _, params, (down, up), _ = _gradual_pair(2)
    sd = {k: v.numpy() for k, v in vmae_gradual_state_dict_from_jax(to_numpy(params), ts, down, up).items()}
    back = jimport.import_vmae_state_dict_gradual(sd, js, down, up)
    back["mask_token"] = jnp.asarray(sd["mask_token"].reshape(-1))
    flat, tree = jax.tree_util.tree_flatten_with_path(params)
    flat_back, tree_back = jax.tree_util.tree_flatten_with_path(back)
    assert tree == tree_back
    for (path_, a), (_, b) in zip(flat, flat_back):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path_))


def test_gradual_weight_decay_mask_matches_jax():
    """The gradual tree keeps its blocks in lists, so only its matrices and
    kernels decay (the stacked model's blocks decay whole)."""
    js, params, (down, up), model = _gradual_pair()
    mask = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, np.float32(m)), jtrain._decay_mask(params), params)
    ref = vmae_gradual_state_dict_from_jax(mask, model.spec, down, up)
    opt = ttrain.make_vmae_optimizer(model)
    decayed = {id(p) for p in opt.param_groups[0]["params"]}
    for name, p in model.named_parameters():
        assert (id(p) in decayed) == bool(ref[name].reshape(-1)[0]), name
    assert id(model.blocks[0].norm1.weight) not in decayed and id(model.blocks[1].conv.weight) in decayed


def test_gradual_init_distributions():
    _, ts = _specs()
    model = tvv.init_gradual_weights_(tvv.GradualVMAE(ts, device="cpu"), torch.Generator().manual_seed(0))
    w = model.blocks[1].conv.weight.detach()
    assert abs(float(w.std()) - (9 * 96) ** -0.5) < 0.05 * (9 * 96) ** -0.5 and not model.blocks[1].conv.bias.any()
    assert abs(float(model.mask_token.detach().std()) - 0.02) < 0.01


# ---------------------------------------------------------------------------
# Linear probes
# ---------------------------------------------------------------------------


def test_linear_probes_match_jax():
    kw = dict(img_size=IMG, depth=2, decoder_depth=1, no_cls=True, smooth_output=True, kl_loss_weight=True,
              ldmae_mode=True)
    js = jvmae.vmae_spec("mae_for_ldmae_f8d16_small", **kw)
    params = randomize(jvmae.init_vmae_params(jax.random.key(0), js), 50)
    model = VMAE(tvmae.vmae_spec("mae_for_ldmae_f8d16_small", **kw), device="cpu")
    model.load_state_dict(vmae_state_dict_from_jax(to_numpy(params), model.spec))
    jhead = jvv.init_probe_head(jax.random.key(1), 16, 5)
    jhead["norm"] = {"scale": jnp.linspace(0.5, 1.5, 16), "bias": jnp.linspace(-0.2, 0.2, 16)}
    head = tvv.init_probe_head(16, 5, torch.Generator().manual_seed(0), device="cpu")
    head.norm.weight.data = torch.from_numpy(np.array(jhead["norm"]["scale"]))
    head.norm.bias.data = torch.from_numpy(np.array(jhead["norm"]["bias"]))
    head.linear.weight.data = torch.from_numpy(np.asarray(jhead["linear"]["w"]).T.copy())
    imgs = np.random.default_rng(51).uniform(-1, 1, (B, 3, IMG, IMG)).astype(np.float32)
    consts = jvmae.VMAEConsts(js)
    for fn, jfn, shape in ((tvv.linear_probe, jvv.linear_probe, (B, 5)),
                           (tvv.linear_probe_seg, jvv.linear_probe_seg, (B * 16, 5))):
        out = fn(model, head, torch.from_numpy(imgs))
        ref = np.asarray(jfn(params, js, consts, jhead, jnp.asarray(imgs)))
        assert tuple(out.shape) == ref.shape == shape
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-5)
    model.zero_grad(set_to_none=True)
    tvv.linear_probe(model, head, torch.from_numpy(imgs)).square().sum().backward()
    assert head.linear.weight.grad.abs().sum() > 0
    assert all(p.grad is None for p in model.parameters())  # the encoder is frozen
    w = tvv.init_probe_head(64, 1000, torch.Generator().manual_seed(2)).linear.weight.detach()
    assert abs(float(w.std()) - 64**-0.5) < 0.02 * 64**-0.5


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_train_vmae_cli_gradual_resol(tmp_path, capsys):
    from PIL import Image

    from ldmae_tpu_torch.cli import train_vmae

    rng = np.random.default_rng(60)
    for c in range(2):
        (tmp_path / "imgs" / f"c{c}").mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)).save(
                tmp_path / "imgs" / f"c{c}" / f"{i}.png")
    flags = ["--model", "mae_for_ldmae_f8d16_small", "--data_path", str(tmp_path / "imgs"), "--input_size", "32",
             "--batch_size", "2", "--warmup_epochs", "1", "--save_epochs", "1", "--steps_per_epoch", "2",
             "--mask_ratio", "0.25", "--no_cls", "--smooth_output", "--kl_loss_weight", "1e-6", "--gradual_resol",
             "--device", "cpu", "--num_workers", "2"]
    res = train_vmae.main(flags + ["--output_dir", str(tmp_path / "a"), "--epochs", "1"])
    model = res["state"].model
    assert isinstance(model, tvv.GradualVMAE) and model.spec.patch_size == 4 and res["state"].step == 2
    assert all(np.isfinite(h[k]) for h in res["history"] for k in ("loss", "vis_loss", "mask_loss", "kl_loss"))
    lines = [json.loads(ln) for ln in open(tmp_path / "a" / "log.txt")]
    assert len(lines) == 1 and lines[0]["train_epoch"] == 0
    ckpt = str(tmp_path / "a" / "checkpoints" / "checkpoint-0.pth")
    sd = torch.load(ckpt, map_location="cpu", weights_only=False)["model"]
    assert sd["blocks.6.conv.weight"].shape == (96, 96, 3, 3) and "decoder_blocks.6.conv.bias" in sd
    assert sd["decoder_pos_embed"].shape == (1, 16, 96)
    capsys.readouterr()
    again = train_vmae.main(flags + ["--output_dir", str(tmp_path / "b"), "--resume", ckpt, "--epochs", "0"])
    assert "missing=[], unexpected=[]" in capsys.readouterr().out  # every tensor of the gradual .pth loaded
    for name, p in again["state"].model.state_dict().items():
        assert torch.equal(p, sd[name]), name
    with pytest.raises(ValueError, match="gradual_resol"):
        train_vmae.main(flags + ["--output_dir", str(tmp_path / "c"), "--tune_decoder"])


# ---------------------------------------------------------------------------
# Dataset wrappers
# ---------------------------------------------------------------------------


def _save(path, arr):
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def test_dataset_wrappers_match_jax(tmp_path):
    from PIL import Image

    from ldmae_tpu.data import datasets as jds
    from ldmae_tpu.data.images import ImageFolderDataset as JImageFolder

    from ldmae_tpu_torch.data import datasets as tds
    from ldmae_tpu_torch.data.images import ImageFolderDataset

    rng = np.random.default_rng(70)
    # CelebAMask: jpgs and part masks in a numbered folder
    for i in range(2):
        _save(tmp_path / "celeba" / "imgs" / f"{i}.jpg", rng.integers(0, 255, (64, 48, 3), dtype=np.uint8))
        _save(tmp_path / "celeba" / "annot" / "0" / f"{i:05d}_hair.png",
              ((rng.random((64, 48)) > 0.5) * 255).astype(np.uint8))
    args = (str(tmp_path / "celeba" / "imgs"), str(tmp_path / "celeba" / "annot"), ["hair", "nose"])
    for kw in ({"img_size": (32, 24), "mask_size": (8, 6)}, {"return_downsized_image": True}):
        a, b = tds.CelebAMaskDataset(*args, **kw), jds.CelebAMaskDataset(*args, **kw)
        assert len(a) == len(b) == 2
        for got, want in zip(a[1], b[1]):
            if isinstance(want, dict):
                assert sorted(got) == sorted(want) == ["hair"]
                np.testing.assert_array_equal(got["hair"], want["hair"])
            else:
                np.testing.assert_array_equal(got, want)
    # an ImageFolder cut to a class list
    for c in ("n01", "n02", "n03"):
        _save(tmp_path / "tiny" / c / "0.png", rng.integers(0, 255, (20, 20, 3), dtype=np.uint8))
    (tmp_path / "wnids.txt").write_text("n03\nn01\n")
    a = tds.filter_tiny_imagenet(ImageFolderDataset(str(tmp_path / "tiny"), 16), str(tmp_path / "wnids.txt"))
    b = jds.filter_tiny_imagenet(JImageFolder(str(tmp_path / "tiny"), 16), str(tmp_path / "wnids.txt"))
    assert a.samples == b.samples and a.classes == b.classes == ["n03", "n01"]
    # ADE20K: one image annotated, one not
    for n in ("a", "b"):
        _save(tmp_path / "ade" / "images" / f"{n}.jpg", rng.integers(0, 255, (40, 50, 3), dtype=np.uint8))
    _save(tmp_path / "ade" / "annotations" / "a.png", rng.integers(0, 150, (40, 50), dtype=np.uint8))
    a = tds.ADE20KPatchDataset(str(tmp_path / "ade" / "images"), str(tmp_path / "ade" / "annotations"), 32, 8)
    b = jds.ADE20KPatchDataset(str(tmp_path / "ade" / "images"), str(tmp_path / "ade" / "annotations"), 32, 8)
    for i in range(2):
        for got, want in zip(a[i], b[i]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    assert a[1][1].sum() == 0 and a[0][1].sum() > 0
    # iNat manifest
    manifest = {"images": [{"id": 1, "file_name": "tiny/n01/0.png"}, {"id": 2, "file_name": "tiny/n02/0.png"}],
                "annotations": [{"image_id": 1, "category_id": 9}, {"image_id": 2, "category_id": 4}]}
    (tmp_path / "inat.json").write_text(json.dumps(manifest))
    a, b = tds.InatDataset(str(tmp_path), str(tmp_path / "inat.json"), 16), jds.InatDataset(
        str(tmp_path), str(tmp_path / "inat.json"), 16)
    for i in range(2):
        np.testing.assert_array_equal(a[i][0], b[i][0])
        assert a[i][1] == b[i][1]
    manifest["annotations"].pop()
    (tmp_path / "inat.json").write_text(json.dumps(manifest))
    for pkg in (tds, jds):
        with pytest.raises(KeyError, match="no matching annotation"):
            pkg.InatDataset(str(tmp_path), str(tmp_path / "inat.json"))
    # a folder with corrupt files: the same substitutes from the same seed
    _save(tmp_path / "robust" / "c0" / "good.png", rng.integers(0, 255, (16, 16, 3), dtype=np.uint8))
    for n in ("bad0.png", "bad1.png"):
        (tmp_path / "robust" / "c0" / n).write_bytes(b"not an image")
    a, b = tds.RobustImageFolder(str(tmp_path / "robust"), 16), jds.RobustImageFolder(str(tmp_path / "robust"), 16)
    for i in range(3):
        got, want = a.get(i), b.get(i)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert a.num_corrupt == b.num_corrupt > 0
    # the transforms
    img = Image.fromarray(rng.integers(0, 255, (70, 90, 3), dtype=np.uint8))
    for size in (32, 256):
        np.testing.assert_array_equal(tds.build_transform(False, size)(img), jds.build_transform(False, size)(img))
    np.testing.assert_array_equal(tds.build_transform(True, 32)(img, np.random.default_rng(3)),
                                  jds.build_transform(True, 32)(img, np.random.default_rng(3)))


def test_hf_image_folder_matches_jax(tmp_path):
    pytest.importorskip("datasets")
    from ldmae_tpu.data.datasets import HFImageFolderDataset as JHF

    from ldmae_tpu_torch.data.datasets import HFImageFolderDataset

    rng = np.random.default_rng(80)
    for c in range(2):
        for i in range(2):
            _save(tmp_path / f"c{c}" / f"{i}.png", rng.integers(0, 255, (24, 20, 3), dtype=np.uint8))
    a, b = HFImageFolderDataset(str(tmp_path), image_size=16), JHF(str(tmp_path), image_size=16)
    assert len(a) == len(b) == 4 and a.classes == b.classes
    for i in range(4):
        for flip in (False, True):
            got, want = a.get(i, flip), b.get(i, flip)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
        np.testing.assert_array_equal(a.get_train(i, np.random.default_rng(i), 16)[0],
                                      b.get_train(i, np.random.default_rng(i), 16)[0])

"""The port's tokenizer family (``models/conv_vae.py``, ``models/sdvae_import.py``,
``models/tokenizers.py``) and the CLIs that dispatch on ``vae.model_name``,
against ``ldmae_tpu`` on the CPU.

* The extraction and tokenizer-evaluation entries of both packages raise
  ``ValueError`` for a ``vae.model_name`` that names no tokenizer (``bogus``,
  and ``sdvae``: the SD-VAE family's names are ``ae``, ``dae``, ``vae`` and
  ``sdv3``), and ``FileNotFoundError`` for a ``vae.weight_path`` that names
  no file.
* ``ConvVAE`` against the JAX functions at a small size of each spec
  (``ch`` 32, ``ch_mult`` (1, 2), 8 groups, 32^2, so the VA-VAE's and
  MAR-VAE's attention at 16^2 runs in a level; weights carried by
  ``convert.conv_vae_state_dict_from_jax``, the group norms' scales and
  biases off 1 and 0): the encoder, the decoder, ``encode_moments`` and
  ``decode`` within 1e-4 absolute (float32 on both sides: summation order
  only), ``decode_to_images`` within one level (a value on a rounding
  boundary); the nearest x2 upsample bit for bit.
* ``diffusers_to_ldm_state_dict`` on a synthetic diffusers dict, in the
  modern and the pre-0.17 attention naming: key for key and value for
  value the JAX function's, and the LDM dict it came from.
* ``build_tokenizer_fns``: the latent width and the moments', decode's and
  images' shapes of each family against the JAX package's; the SD-VAE's
  four names; the loaders (``load_sdvae``, ``load_vavae`` with its ``loss``
  keys, ``load_marvae``) through the dispatch at a small spec against the
  JAX package's (1e-4, one level); the wrappers' ``img_transform`` (the same
  floats), fresh posterior noise per encode and the SD-VAE's mode.
* ``make_sample_fn`` with ``vae_decode_images_fn`` (a small conv VAE)
  against the JAX chain given the same ``z``: images within 2 levels (the
  bf16 DiT chain's bound in ``tests/test_torch_port_sampling.py``).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldmae_tpu.models import conv_vae as jcv
from ldmae_tpu.models import sdvae_import as jsdvae
from ldmae_tpu.models import tokenizers as jtok

from torch_port_helpers import image_folder, to_numpy, write_config  # noqa: F401

from ldmae_tpu_torch.cli import evaluate_tokenizer as tevaluate_tokenizer
from ldmae_tpu_torch.cli import extract_features as textract_features
from ldmae_tpu_torch.convert import conv_vae_state_dict_from_jax
from ldmae_tpu_torch.core.config import LDMAEConfig
from ldmae_tpu_torch.models import conv_vae as tcv
from ldmae_tpu_torch.models import sdvae_import as tsdvae
from ldmae_tpu_torch.models import tokenizers as ttok

TOL = 1e-4
SPECS = {"sdvae": jcv.sdvae_spec, "vavae": jcv.vavae_spec, "marvae": jcv.marvae_spec}


def _small(spec_fn):
    """The spec cut to ch 32, ch_mult (1, 2), 8 groups, 32^2 (its attention
    resolutions kept: 16 is the second level's)."""
    return dataclasses.replace(spec_fn(), ch=32, ch_mult=(1, 2), num_groups=8, resolution=32)


def _port_spec(jspec):
    return tcv.ConvVAESpec(**dataclasses.asdict(jspec))


def _jax_params(spec, seed):
    """The JAX initialisation with the group norms' scales and biases moved
    off 1 and 0 (a swapped scale and bias would show)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']"):
            return jnp.asarray(1 + 0.1 * rng.standard_normal(leaf.shape), jnp.float32)
        if key.endswith("['bias']"):
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape), jnp.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, jcv.init_conv_vae_params(jax.random.key(seed), spec))


def _pair(name, seed=0):
    js = _small(SPECS[name])
    params = _jax_params(js, seed)
    ts = _port_spec(js)
    model = tcv.ConvVAE(ts, device="cpu")
    model.load_state_dict(conv_vae_state_dict_from_jax(to_numpy(params), ts), strict=True)
    return js, params, model


def _images(seed, n=2, size=32):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3, size, size)).astype(np.float32)


def _jax_extract(cfg_path, monkeypatch, tmp_path):
    """The JAX extraction CLI in this process (its argv from sys.argv, its
    compilation cache under ``tmp_path`` and set back afterwards)."""
    from ldmae_tpu.cli import extract_features as jextract_features

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(sys, "argv", ["extract_features", "--config", cfg_path, "--batch", "2"])
    saved = jax.config.jax_compilation_cache_dir
    try:
        jextract_features.main()
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


@pytest.mark.parametrize("model_name,weights,error", [
    ("bogus", "", ValueError),
    ("sdvae", "", ValueError),
    ("sdv3", "missing/sdvae.pt", FileNotFoundError),
], ids=["unknown", "sdvae-not-a-name", "missing-weights"])
def test_extract_and_evaluate_tokenizer_dispatch_on_model_name(tmp_path, monkeypatch, image_folder, model_name,
                                                              weights, error):
    """Both packages' extraction and tokenizer-evaluation entries build the
    tokenizer that ``vae.model_name`` names before they read an image: an
    unknown name raises ``ValueError``, a missing weight file
    ``FileNotFoundError`` (``ldmae_tpu/models/tokenizers.py``,
    ``build_tokenizer_fns`` and ``_load_or_init``)."""
    from ldmae_tpu.cli.evaluate_tokenizer import evaluate_tokenizer as jevaluate_tokenizer
    from ldmae_tpu.core.config import LDMAEConfig as JLDMAEConfig

    cfg_path = write_config(str(tmp_path / "c.yaml"), image_folder, str(tmp_path / "lat"),
                            str(tmp_path / weights) if weights else "", True)
    cfg = LDMAEConfig.from_yaml(cfg_path)
    cfg.vae.model_name = model_name
    cfg.to_yaml(cfg_path)
    match = "sdvae.pt" if error is FileNotFoundError else model_name
    with pytest.raises(error, match=match):
        _jax_extract(cfg_path, monkeypatch, tmp_path)
    with pytest.raises(error, match=match):
        jevaluate_tokenizer(JLDMAEConfig.from_yaml(cfg_path), image_folder, str(tmp_path / "jrfid"), batch=2)
    with pytest.raises(error, match=match):
        textract_features.main(["--config", cfg_path, "--batch", "2", "--device", "cpu"])
    with pytest.raises(error, match=match):
        tevaluate_tokenizer.main(["--config", cfg_path, "--data_path", image_folder, "--output_path",
                                  str(tmp_path / "rfid"), "--batch", "2", "--device", "cpu"])


# ---------------------------------------------------------------------------
# ConvVAE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SPECS))
def test_conv_vae_matches_jax(name):
    js, params, model = _pair(name)
    x = _images(1)
    with torch.no_grad():
        enc = model.encoder(torch.from_numpy(x))
    jenc = np.asarray(jcv.encoder_forward(params["encoder"], js, jnp.asarray(x)))
    assert enc.shape == jenc.shape == (2, 2 * js.z_channels, 16, 16)
    np.testing.assert_allclose(enc.numpy(), jenc, rtol=0, atol=TOL)

    moments = model.encode_moments(torch.from_numpy(x))
    jmom = np.asarray(jcv.encode_moments(params, js, jnp.asarray(x)))
    np.testing.assert_allclose(moments.numpy(), jmom, rtol=0, atol=TOL)
    post, jpost = model.encode(torch.from_numpy(x)), jcv.encode(params, js, jnp.asarray(x))
    np.testing.assert_allclose(post.mode().numpy(), np.asarray(jpost.mode()), rtol=0, atol=TOL)

    z = np.random.default_rng(2).standard_normal((2, js.embed_dim, 16, 16)).astype(np.float32)
    with torch.no_grad():
        dec = model.decoder(torch.from_numpy(z))
    np.testing.assert_allclose(dec.numpy(), np.asarray(jcv.decoder_forward(params["decoder"], js, jnp.asarray(z))),
                               rtol=0, atol=TOL)
    img = model.decode(torch.from_numpy(z))
    jimg = np.asarray(jcv.decode(params, js, jnp.asarray(z)))
    assert img.shape == (2, 3, 32, 32) and float(np.abs(jimg).max()) > 0.1
    np.testing.assert_allclose(img.numpy(), jimg, rtol=0, atol=TOL)
    u8 = model.decode_to_images(torch.from_numpy(z)).numpy()
    ju8 = np.asarray(jcv.decode_to_images(params, js, jnp.asarray(z)))
    assert u8.dtype == np.uint8 and u8.shape == (2, 32, 32, 3)
    assert np.abs(u8.astype(int) - ju8.astype(int)).max() <= 1


def test_nearest_upsample_and_asymmetric_downsample_match_jax():
    """``F.interpolate(mode="nearest")`` at x2 is ``jax.image.resize``'s
    nearest, bit for bit; the (0, 1, 0, 1) pad keeps the last row and column."""
    import torch.nn.functional as F

    x = np.random.default_rng(3).standard_normal((2, 4, 5, 5)).astype(np.float32)
    up = F.interpolate(torch.from_numpy(x), scale_factor=2.0, mode="nearest").numpy()
    np.testing.assert_array_equal(up, np.asarray(jax.image.resize(jnp.asarray(x), (2, 4, 10, 10), "nearest")))
    js = _small(jcv.sdvae_spec)
    params = _jax_params(js, 4)
    model = tcv.ConvVAE(_port_spec(js), device="cpu")
    model.load_state_dict(conv_vae_state_dict_from_jax(to_numpy(params), _port_spec(js)))
    x = np.random.default_rng(5).standard_normal((2, 32, 16, 16)).astype(np.float32)
    with torch.no_grad():
        out = model.encoder.down[0].downsample(torch.from_numpy(x)).numpy()
    ref = np.asarray(jcv._downsample(jnp.asarray(x), params["encoder"]["down"][0]["downsample"]))
    assert out.shape == (2, 32, 8, 8)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_conv_vae_init_distributions():
    """``init_conv_vae_weights_`` draws what the JAX initialisation draws:
    every convolution uniform in +-sqrt(1 / (C_in k k)) (weights and biases),
    group norms at 1 and 0; the same generator seed gives the same weights."""
    ts = _port_spec(_small(jcv.vavae_spec))
    m = tcv.init_conv_vae_weights_(tcv.ConvVAE(ts, device="cpu"), torch.Generator().manual_seed(0))
    again = tcv.init_conv_vae_weights_(tcv.ConvVAE(ts, device="cpu"), torch.Generator().manual_seed(0))
    for (name, p), q in zip(m.state_dict().items(), again.state_dict().values()):
        assert torch.equal(p, q), name
    conv = m.encoder.down[1].block[0].conv1
    a = (1.0 / (conv.in_channels * 9)) ** 0.5
    for t in (conv.weight.detach(), conv.bias.detach()):
        assert float(t.abs().max()) <= a and float(t.abs().max()) > 0.9 * a
    assert abs(float(conv.weight.detach().std()) - a / 3**0.5) < 0.05 * a
    assert torch.equal(m.encoder.norm_out.weight, torch.ones(64)) and not m.encoder.norm_out.bias.any()


# ---------------------------------------------------------------------------
# Diffusers import
# ---------------------------------------------------------------------------


def _to_diffusers(ldm_sd, n_lv, legacy):
    """An LDM-named state dict in diffusers naming (the inverse renames,
    written out here): the attention projections as (C, C) linears."""
    attn_names = ({"q": "query", "k": "key", "v": "value", "proj_out": "proj_attn", "norm": "norm"} if legacy else
                  {"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0", "norm": "group_norm"})
    out = {}
    for key, v in ldm_sd.items():
        v = v.numpy()
        side, kind, *rest = key.split(".")
        if kind == "down":
            i, what, *rest = rest
            name = (f"{side}.down_blocks.{i}.resnets.{rest[0]}.{'.'.join(rest[1:])}" if what == "block"
                    else f"{side}.down_blocks.{i}.downsamplers.0.{'.'.join(rest)}")
        elif kind == "up":
            i, what, *rest = rest
            j = n_lv - 1 - int(i)
            name = (f"{side}.up_blocks.{j}.resnets.{rest[0]}.{'.'.join(rest[1:])}" if what == "block"
                    else f"{side}.up_blocks.{j}.upsamplers.0.{'.'.join(rest)}")
        elif kind == "mid":
            part, *rest = rest
            if part == "attn_1":
                proj, leaf = rest
                name = f"{side}.mid_block.attentions.0.{attn_names[proj]}.{leaf}"
                if proj != "norm" and leaf == "weight":
                    v = v[:, :, 0, 0]
            else:
                name = f"{side}.mid_block.resnets.{int(part[-1]) - 1}.{'.'.join(rest)}"
        elif kind == "norm_out":
            name = f"{side}.conv_norm_out.{rest[0]}"
        else:
            name = key
        out[name.replace("nin_shortcut", "conv_shortcut")] = v
    return out


@pytest.mark.parametrize("legacy", [False, True], ids=["modern", "pre-0.17"])
def test_diffusers_to_ldm_state_dict_matches_jax(legacy):
    js, params, model = _pair("sdvae", seed=6)
    ldm = model.state_dict()
    diff = _to_diffusers(ldm, len(js.ch_mult), legacy)
    diff["encoder.mid_block.attentions.0.extra.weight"] = np.ones(3, np.float32)  # ignored by both
    got = tsdvae.diffusers_to_ldm_state_dict(diff, _port_spec(js))
    want = jsdvae.diffusers_to_ldm_state_dict(diff, js)
    assert sorted(got) == sorted(want) == sorted(ldm)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), ldm[k].numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# Dispatch, loaders and wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,latent,f", [("vmae_f8d16", 16, 8), ("sdv3", 16, 8), ("vavae", 32, 16),
                                           ("marvae", 16, 16)])
def test_build_tokenizer_fns_dispatch_matches_jax(monkeypatch, name, latent, f):
    """Each family at its full width (seeded weights) on 32^2 images: the
    latent width and the shapes out of encode_moments, decode and
    decode_to_images, as the JAX package's (whose parameters and outputs
    are traced abstractly here: only their shapes are compared)."""
    from functools import partial

    from ldmae_tpu.models import vmae as jvmae

    for mod, fn in ((jcv, "init_conv_vae_params"), (jvmae, "init_vmae_params")):
        monkeypatch.setattr(mod, fn, lambda key, spec, _f=getattr(mod, fn): jax.eval_shape(partial(_f, spec=spec), key))
    jt = jtok.build_tokenizer_fns(name, "", img_size=32)
    tt = ttok.build_tokenizer_fns(name, "", img_size=32, device="cpu")
    assert tt.latent_dim == jt.latent_dim == latent and tt.name == name
    x = _images(7, n=1)
    jm = jax.eval_shape(jt.encode_moments, jt.params, jnp.asarray(x))
    tm = tt.encode_moments(tt.model, torch.from_numpy(x))
    assert tuple(tm.shape) == jm.shape == (1, 2 * latent, 32 // f, 32 // f) and tm.dtype == torch.float32
    z = tm[:, :latent]
    jdec = jax.eval_shape(jt.decode, jt.params, jnp.asarray(z.numpy()))
    assert tuple(tt.decode(tt.model, z).shape) == jdec.shape == (1, 3, 32, 32)
    u8 = tt.decode_to_images(tt.model, z)
    assert u8.dtype == torch.uint8 and tuple(u8.shape) == (1, 32, 32, 3)


def test_sdvae_family_names_and_errors(tmp_path, monkeypatch):
    from types import SimpleNamespace

    # the family rule alone: a stand-in for the seeded model records the spec
    monkeypatch.setattr(ttok, "_seeded_conv", lambda spec, device, seed: SimpleNamespace(spec=spec))
    for name in ("ae", "dae", "vae", "sdv3", "ae_f8", "sdv3_x"):
        tt = ttok.build_tokenizer_fns(name, "", img_size=32, device="cpu")
        assert tt.model.spec == tcv.ConvVAESpec(**dataclasses.asdict(jcv.sdvae_spec())), name
    monkeypatch.undo()
    for pkg, kw in ((jtok, {}), (ttok, {"device": "cpu"})):
        for name in ("bogus", "sdvae", "vmaef8"):
            with pytest.raises(ValueError, match="unknown tokenizer"):
                pkg.build_tokenizer_fns(name, "", img_size=32, **kw)
        for name in ("vmae", "sdv3", "vavae", "marvae"):
            with pytest.raises(FileNotFoundError, match="nope.pt"):
                pkg.build_tokenizer_fns(name, str(tmp_path / "nope.pt"), img_size=32, **kw)
        with pytest.raises(ValueError, match="unknown VMAE tokenizer arch"):
            pkg.build_tokenizer("vmae_f16d32", **kw)
        with pytest.raises(ValueError, match="unknown tokenizer"):
            pkg.build_tokenizer("vmae_x".replace("vmae_", "sd"), **kw)
        with pytest.raises(FileNotFoundError):
            pkg.build_tokenizer("vavae", str(tmp_path / "nope.pt"), img_size=32, **kw)


def _small_specs(monkeypatch):
    """Both packages' spec factories cut to the small size, so the loaders
    and the dispatch build small models."""
    for mod in (jcv, tcv):
        for name, fn in SPECS.items():
            small = _small(fn)
            if mod is tcv:
                small = _port_spec(small)
            monkeypatch.setattr(mod, f"{name}_spec", lambda *a, s=small: s)
    monkeypatch.setattr(jsdvae, "sdvae_spec", jcv.sdvae_spec)
    monkeypatch.setattr(tsdvae, "sdvae_spec", tcv.sdvae_spec)


@pytest.mark.parametrize("name,spec", [("sdv3", "sdvae"), ("vavae", "vavae"), ("marvae", "marvae")])
def test_dispatch_loads_checkpoints_like_jax(tmp_path, monkeypatch, name, spec):
    """A checkpoint in each family's format (the SD-VAE's diffusers dict in
    bf16 under ``model``; VA-VAE's ``state_dict`` with a ``loss`` key;
    MAR-VAE's ``model``), at the small size, through both packages'
    dispatch: the moments within 1e-4, the images within one level."""
    _small_specs(monkeypatch)
    js, params, model = _pair(spec, seed=8)
    sd = model.state_dict()
    path = str(tmp_path / "tok.pt")
    if spec == "sdvae":
        diff = {k: torch.from_numpy(v).bfloat16() for k, v in _to_diffusers(sd, len(js.ch_mult), False).items()}
        torch.save({"model": diff}, path)
    elif spec == "vavae":
        torch.save({"state_dict": dict(sd, **{"loss.logvar": torch.zeros(())})}, path)
    else:
        torch.save({"model": sd}, path)
    jt = jtok.build_tokenizer_fns(name, path, img_size=32)
    tt = ttok.build_tokenizer_fns(name, path, img_size=32, device="cpu")
    x = _images(9)
    jm = np.asarray(jt.encode_moments(jt.params, jnp.asarray(x)))
    tm = tt.encode_moments(tt.model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(tm, jm, rtol=0, atol=TOL)
    z = np.array(jm[:, :js.embed_dim])
    ju8 = np.asarray(jt.decode_to_images(jt.params, jnp.asarray(z)))
    tu8 = tt.decode_to_images(tt.model, torch.from_numpy(z)).numpy()
    assert np.abs(tu8.astype(int) - ju8.astype(int)).max() <= 1 and tu8.std() > 1.0


def test_wrappers_match_jax(monkeypatch):
    """``build_tokenizer``'s wrappers: ``img_transform`` gives the JAX
    wrapper's floats (no flip, and a flip at p 1); a VMAE or conv encode
    draws fresh posterior noise each call; the SD-VAE encodes to the mode;
    ``decode_to_images`` returns uint8 HWC numpy."""
    from PIL import Image

    _small_specs(monkeypatch)
    img = Image.fromarray(np.random.default_rng(10).integers(0, 256, (40, 52, 3), dtype=np.uint8))
    jw, tw = jtok.build_tokenizer("vavae", img_size=32), ttok.build_tokenizer("vavae", img_size=32, device="cpu")
    for p in (0, 1):
        np.testing.assert_array_equal(tw.img_transform(p)(img), jw.img_transform(p)(img))
    assert not np.array_equal(tw.img_transform(1)(img), tw.img_transform(0)(img))
    x = _images(11)
    for name in ("vmae_mae_for_ldmae_f8d16_small", "vavae", "marvae"):
        tok = ttok.build_tokenizer(name, img_size=32, device="cpu")
        z1, z2 = tok.encode_images(x), tok.encode_images(x)
        assert z1.shape == z2.shape and not torch.allclose(z1, z2), name
        u8 = tok.decode_to_images(z1)
        assert isinstance(u8, np.ndarray) and u8.dtype == np.uint8 and u8.shape == (2, 32, 32, 3)
    sd = ttok.build_tokenizer("sdv3", img_size=32, device="cpu")
    mode = sd.model.encode(torch.from_numpy(x)).mode()
    assert torch.equal(sd.encode_images(x), mode) and torch.equal(sd.encode_images(x), mode)


def test_sample_fn_with_vae_decode_images_fn_matches_jax():
    """The sampling chain decoding through ``vae_decode_images_fn`` (a small
    conv VAE, f8 at 64^2) against the JAX chain with the same ``z``."""
    from ldmae_tpu.eval import sampling as jsampling
    from ldmae_tpu.models import lightningdit as jdit
    from ldmae_tpu.transport import create_transport as jcreate_transport

    from ldmae_tpu_torch.convert import dit_state_dict_from_jax
    from ldmae_tpu_torch.eval.sampling import make_sample_fn
    from ldmae_tpu_torch.models import LightningDiT, permute_qk_for_half_rope
    from ldmae_tpu_torch.models import lightningdit as tdit
    from ldmae_tpu_torch.transport import create_transport

    from torch_port_helpers import randomize

    dit_kw = dict(input_size=8, in_channels=16, num_classes=10, depth=2, hidden_size=64, num_heads=4,
                  use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True)
    chain = dict(num_steps=6, sampling_method="euler", timestep_shift=0.3, cfg_scale=4.0, cfg_interval=True,
                 cfg_interval_start=0.10, cfg_channels=3, attn_impl="flash_rope", rope_layout="half",
                 adaln_impl="fused", mlp_impl="fused")
    js, ts = jdit.dit_spec("LightningDiT-debug", **dit_kw), tdit.dit_spec("LightningDiT-debug", **dit_kw)
    jparams = randomize(jdit.init_dit_params(jax.random.key(0), js), 12, std=0.05)
    dit = LightningDiT(ts, device="cpu")
    dit.load_state_dict(permute_qk_for_half_rope(dit_state_dict_from_jax(to_numpy(jparams), ts), ts))
    jparams = jdit.merge_swiglu(jdit.permute_qk_for_half_rope(jparams, js), js)
    vs = dataclasses.replace(jcv.sdvae_spec(), ch=32, ch_mult=(1, 2, 2, 2), num_groups=8, resolution=64)
    vparams = _jax_params(vs, 13)
    vae = tcv.ConvVAE(_port_spec(vs), device="cpu")
    vae.load_state_dict(conv_vae_state_dict_from_jax(to_numpy(vparams), _port_spec(vs)))
    z = np.random.default_rng(14).standard_normal((2, 16, 8, 8)).astype(np.float32)
    y = np.array([1, 7])
    jfn = jsampling.make_sample_fn(js, jdit.DiTConsts(js), jcreate_transport(), compute_dtype=jnp.bfloat16,
                                   vae_decode_images_fn=lambda p, lat: jcv.decode_to_images(p, vs, lat), **chain)
    tfn = make_sample_fn(ts, create_transport(), compute_dtype=torch.bfloat16, device="cpu",
                         vae_decode_images_fn=lambda m, lat: m.decode_to_images(lat), **chain)
    jimgs = np.asarray(jfn({"dit": jparams, "vae": vparams}, jax.random.key(0), jnp.asarray(y), z=jnp.asarray(z)))
    timgs = tfn({"dit": dit, "vae": vae}, torch.from_numpy(y), z=torch.from_numpy(z)).numpy()
    assert timgs.dtype == np.uint8 and timgs.shape == (2, 64, 64, 3) and timgs.std() > 1.0
    assert np.abs(timgs.astype(int) - jimgs.astype(int)).max() <= 2

"""The port's extraction slice vs ``ldmae_tpu`` on the CPU: image decode and
normalisation, the Gaussian posterior, the VMAE encode, the shard writer
and its statistics, and ``cli.extract_features`` end to end.

The same seeded numpy inputs go to both packages. Tolerances:

* ``normalize_uint8_images``, ``center_crop_arr``, ``load_image``: exact
  (the same float32 operations and the same PIL calls).
* ``DiagonalGaussian``: float32, 1e-6 of the largest |value|.
* The VMAE encode: relative L2 error ||port - jax|| / ||jax|| at most 1e-5
  in float32 (summation order only) and 2e-2 in bf16 (the two packages
  round at the same points; the bound allows one bf16 ulp, 2^-8, to grow
  through the blocks).
* Shards the port writes: read by the JAX reader bit for bit; the latent
  statistics the port saves within 1e-6 of the JAX reader's own.

``cli.extract_features`` end to end is in ``test_torch_port_eval_cli.py``.
"""

import glob
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

from ldmae_tpu.data import images as jimages
from ldmae_tpu.data import latent_dataset as jld
from ldmae_tpu.models import vmae as jvmae
from ldmae_tpu.ops import gaussian as jgauss

from torch_port_helpers import randomize, to_numpy

from ldmae_tpu_torch.convert import vmae_state_dict_from_jax
from ldmae_tpu_torch.data import images as timages
from ldmae_tpu_torch.data import latent_dataset as tld
from ldmae_tpu_torch.models import VMAE
from ldmae_tpu_torch.models import vmae as tvmae
from ldmae_tpu_torch.ops import gaussian as tgauss

REL_L2 = {"float32": 1e-5, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def rel_l2(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(port - ref) / np.linalg.norm(ref))


def test_normalize_uint8_images_exact():
    u8 = np.random.default_rng(0).integers(0, 256, (3, 8, 6, 3), dtype=np.uint8)
    ref = np.asarray(jimages.normalize_uint8_images(jnp.asarray(u8)))
    out = timages.normalize_uint8_images(torch.from_numpy(u8)).numpy()
    assert out.shape == (3, 3, 8, 6) and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("size", [(600, 400), (300, 257)], ids=["halving", "bicubic"])
def test_center_crop_and_load_image_exact(tmp_path, size):
    """600 x 400 takes one halving BOX resize before the BICUBIC one at 128;
    300 x 257 only the BICUBIC one (an odd edge)."""
    arr = np.random.default_rng(1).integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
    ref = np.asarray(jimages.center_crop_arr(Image.fromarray(arr), 128))
    out = np.asarray(timages.center_crop_arr(Image.fromarray(arr), 128))
    assert out.shape == (128, 128, 3)
    np.testing.assert_array_equal(out, ref)
    path = str(tmp_path / "x.png")
    Image.fromarray(arr).save(path)
    for raw in (False, True):
        np.testing.assert_array_equal(timages.load_image(path, 128, raw), jimages.load_image(path, 128, False, raw))


def test_image_folder_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    for c in ("b", "a"):
        (tmp_path / c).mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (40, 36, 3), dtype=np.uint8)).save(tmp_path / c / f"{i}.png")
    (tmp_path / "a" / "notes.txt").write_text("not an image")
    jds, tds = jimages.ImageFolderDataset(str(tmp_path), 32), timages.ImageFolderDataset(str(tmp_path), 32)
    assert tds.samples == jds.samples and tds.classes == jds.classes == ["a", "b"]
    ours, theirs = list(tds.iter_batches(4, raw_uint8=True)), list(jds.iter_batches(4, raw_uint8=True))
    assert len(ours) == len(theirs) == 2
    start = 0
    for (ti, tl), (ji, jl, jx) in zip(ours, theirs):
        np.testing.assert_array_equal(jx, np.arange(start, start + len(jl)))  # the JAX batches are in folder order
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tl, jl)
        start += len(jl)


def test_diagonal_gaussian_matches_jax():
    rng = np.random.default_rng(3)
    params = rng.standard_normal((2, 8, 4, 4)).astype(np.float32) * 4  # logvar beyond the clip too
    noise = rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
    jg, tg = jgauss.diagonal_gaussian(jnp.asarray(params)), tgauss.diagonal_gaussian(torch.from_numpy(params))
    pairs = [(tg.mode(), jg.mode()), (tg.std, jg.std),
             (tg.sample(noise=torch.from_numpy(noise)), jg.sample(None, noise=jnp.asarray(noise))),
             (tg.kl(), jg.kl()), (tg.kl(include_mean=True), jg.kl(include_mean=True)),
             (tg.kl(fixed_std=0.5), jg.kl(fixed_std=0.5))]
    for out, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    g = torch.Generator().manual_seed(0)
    assert tg.sample(generator=g).shape == (2, 4, 4, 4)


ENCODE_VARIANTS = {
    "no_cls": ("mae_for_ldmae_f8d16_small", dict(no_cls=True)),
    "cls": ("mae_for_ldmae_f8d16_small", dict(no_cls=False)),
    "down_nonlinear": ("mae_for_ldmae_f8d16", dict(no_cls=True)),
}


def _encoder(variant, seed):
    arch, kw = ENCODE_VARIANTS[variant]
    kw = dict(img_size=32, depth=2, decoder_depth=1, ldmae_mode=True, kl_loss_weight=True,
              smooth_output=True, **kw)
    js, ts = jvmae.vmae_spec(arch, **kw), tvmae.vmae_spec(arch, **kw)
    params = randomize(jvmae.init_vmae_params(jax.random.key(0), js), seed)
    model = VMAE(ts, device="cpu")
    model.load_state_dict(vmae_state_dict_from_jax(to_numpy(params), ts), strict=True)
    return js, params, model


@pytest.mark.parametrize(
    "variant,dt,impl",
    [("no_cls", "float32", "xla"), ("no_cls", "float32", "flash"), ("no_cls", "bfloat16", "xla"),
     ("no_cls", "bfloat16", "flash"), ("cls", "float32", "xla"), ("cls", "float32", "flash"),
     ("cls", "bfloat16", "flash"), ("down_nonlinear", "float32", "xla"), ("down_nonlinear", "bfloat16", "xla")],
)
def test_vmae_encode_matches_jax(variant, dt, impl):
    js, params, model = _encoder(variant, seed=7)
    imgs = np.random.default_rng(8).uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    jd, td = DT[dt]
    consts = jvmae.VMAEConsts(js)
    ref = np.asarray(jvmae.ldmae_encode_moments(params, js, consts, jnp.asarray(imgs), jd, impl))
    out = model.ldmae_encode_moments(torch.from_numpy(imgs), td, impl)
    assert out.shape == (2, 32, 4, 4) and out.dtype == torch.float32
    assert rel_l2(out, ref) <= REL_L2[dt]
    jpost = jvmae.encode(params, js, consts, jnp.asarray(imgs), jd, impl)
    tpost = model.encode(torch.from_numpy(imgs), td, impl)
    assert rel_l2(tpost.mode(), jpost.mode()) <= REL_L2[dt]
    assert rel_l2(tpost.logvar, jpost.logvar) <= REL_L2[dt]


def test_vmae_encode_point_mass_without_kl():
    """An arch without the KL head encodes to a point mass (logvar -inf)."""
    spec = tvmae.vmae_spec("mae_for_ldmae_f8d16_small", img_size=32, depth=1, decoder_depth=1, ldmae_mode=True)
    post = VMAE(spec, device="cpu").encode(torch.zeros(1, 3, 32, 32))
    assert post.mean.shape == (1, 16, 4, 4) and torch.isneginf(post.logvar).all()


def _latents(n, c, seed):
    rng = np.random.default_rng(seed)
    lat = (rng.standard_normal((n, c, 4, 4)) * 1.5 + 0.3).astype(np.float32)
    return lat, (lat[..., ::-1] + 0.01).astype(np.float32), rng.integers(0, 1000, n).astype(np.int64)


@pytest.mark.parametrize("sample", [False, True], ids=["mode", "moments"])
def test_shard_writer_read_by_jax_dataset(tmp_path, sample):
    c = 32 if sample else 16
    lat, flip, lab = _latents(23, c, seed=9)
    writer = tld.LatentShardWriter(str(tmp_path), shard_size=10)
    for s in range(0, 23, 4):  # a shard of 12 (written at 10 or more), then the 11 flushed
        writer.add(lat[s:s + 4], flip[s:s + 4], lab[s:s + 4])
    writer.flush()
    names = sorted(os.path.basename(f) for f in glob.glob(str(tmp_path / "*.safetensors")))
    assert names == [f"latents_rank00_shard{i:03d}.safetensors" for i in range(2)]
    from safetensors import safe_open

    with safe_open(str(tmp_path / names[0]), framework="numpy") as f:
        assert f.metadata() == {"total_size": "12", "dtype": "float32"}
    # the port's reader computes and saves the statistics
    tds = tld.ImgLatentDataset(str(tmp_path), latent_norm=True, sample=sample)
    assert os.path.exists(tmp_path / "latents_stats.pt")
    jraw = jld.ImgLatentDataset(str(tmp_path), latent_norm=False, sample=sample)
    assert len(jraw) == 23
    for i in range(23):
        np.testing.assert_array_equal(jraw._raw(i, "latents"), lat[i])
        np.testing.assert_array_equal(jraw._raw(i, "latents_flip"), flip[i])
        assert jraw._raw(i, "labels") == lab[i]
    ref = jraw.compute_latent_stats()
    saved = jld._load_stats(str(tmp_path / "latents_stats.pt"))
    for k in ("mean", "std"):
        assert saved[k].shape == (1, c // 2 if sample else c, 1, 1)
        np.testing.assert_allclose(saved[k], ref[k], rtol=0, atol=1e-6)
    # both readers then give the same normalised batches from the saved file
    # (fresh readers: computing the statistics draws from the reader's generator)
    tds = tld.ImgLatentDataset(str(tmp_path), latent_norm=True, sample=sample)
    jds = jld.ImgLatentDataset(str(tmp_path), latent_norm=True, sample=sample)
    for tb, jb in zip(tds.iter_batches(5, seed=1, epochs=1), jds.iter_batches(5, seed=1, epochs=1)):
        np.testing.assert_allclose(tb["x"], jb["x"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tb["y"], jb["y"])


def test_stats_file_roundtrip_and_npz_fallback(tmp_path):
    stats = {"mean": np.arange(4, dtype=np.float32).reshape(1, 4, 1, 1), "std": np.ones((1, 4, 1, 1), np.float32)}
    tld._save_stats(str(tmp_path / "a.pt"), stats)
    for loaded in (tld._load_stats(str(tmp_path / "a.pt")), jld._load_stats(str(tmp_path / "a.pt"))):
        for k in stats:
            np.testing.assert_array_equal(loaded[k], stats[k])
    np.savez(str(tmp_path / "b.pt.npz"), **stats)
    np.testing.assert_array_equal(tld._load_stats(str(tmp_path / "b.pt"))["mean"], stats["mean"])
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]

"""The port's evaluation stack vs ``ldmae_tpu`` on the CPU: PSNR, SSIM,
LPIPS, the FID InceptionV3 (pooled and sFID features, the resize), the
Frechet distance, the Inception Score and precision/recall.

Both packages get the same seeded numpy inputs and the same weights (the
port's seeded random LPIPS and Inception weights are the JAX package's
draws; the weight bridges in ``convert`` are checked key for key).
Tolerances: PSNR 1e-5 relative; SSIM 1e-6 absolute; LPIPS 1e-5 absolute
(float32, summation order only); Inception features relative L2 error at
most 1e-5 (float32 through 94 convolutions); the resize exact to float32
rounding (1e-6); the Frechet distance 1e-6 relative (the same numpy/scipy
code); the Inception Score 1e-5 relative; precision and recall the same
fractions, the k-NN radii within 1e-4 relative (float32 distances
||u||^2 + ||v||^2 - 2 u.v summed in other orders, with cancellation: the
JAX package's own host and device paths differ by 1.3e-5).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ldmae_tpu.eval import evaluator as jev
from ldmae_tpu.eval import fid as jfid
from ldmae_tpu.eval import metrics as jmetrics
from ldmae_tpu.models import inception as jinc
from ldmae_tpu.models import lpips as jlpips

from ldmae_tpu_torch.convert import inception_state_dict_from_jax, lpips_state_dict_from_jax
from ldmae_tpu_torch.eval import evaluator as tev
from ldmae_tpu_torch.eval import fid as tfid
from ldmae_tpu_torch.eval import metrics as tmetrics
from ldmae_tpu_torch.models import inception as tinc
from ldmae_tpu_torch.models import lpips as tlpips


def rel_l2(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(port - ref) / np.linalg.norm(ref))


def _imgs(shape, seed, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def test_psnr_matches_jax():
    a = np.random.default_rng(0).integers(0, 256, (3, 16, 16, 3), dtype=np.uint8)
    b = np.clip(a.astype(int) + np.random.default_rng(1).integers(-9, 10, a.shape), 0, 255).astype(np.uint8)
    ref = float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(b)))
    assert abs(float(tmetrics.psnr(torch.from_numpy(a), torch.from_numpy(b))) - ref) <= 1e-5 * abs(ref)
    np.testing.assert_array_equal(tmetrics.psnr_batch_np(a, b), jmetrics.psnr_batch_np(a, b))
    assert np.isfinite(tmetrics.psnr_batch_np(a, a)).all()


@pytest.mark.parametrize("data_range", [2.0, (-1.0, 1.0)], ids=["scalar", "clamped"])
@pytest.mark.parametrize("per_image", [False, True])
def test_ssim_matches_jax(data_range, per_image):
    x = _imgs((2, 3, 24, 20), 2, -1.2, 1.2)  # beyond the range, for the clamp
    y = np.clip(x + _imgs(x.shape, 3, -0.2, 0.2), -1.3, 1.3)
    ref = np.asarray(jmetrics.ssim(jnp.asarray(x), jnp.asarray(y), data_range=data_range, per_image=per_image))
    out = tmetrics.ssim(torch.from_numpy(x), torch.from_numpy(y), data_range=data_range, per_image=per_image)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)
    same = tmetrics.ssim(torch.from_numpy(x), torch.from_numpy(x), data_range=data_range)
    assert abs(float(same) - 1.0) <= 1e-6


def test_lpips_weights_and_distance_match_jax():
    jparams = jlpips.import_lpips_weights()
    sd = tlpips.import_lpips_weights()
    bridged = lpips_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(bridged) == set(sd)
    for k in sd:
        torch.testing.assert_close(bridged[k], sd[k], rtol=0, atol=0)
    model = tlpips.LPIPS(device="cpu")
    model.load_state_dict(sd, strict=True)
    x, y = _imgs((2, 3, 48, 40), 4), _imgs((2, 3, 48, 40), 5)
    ref = np.asarray(jlpips.lpips(jparams, jnp.asarray(x), jnp.asarray(y)))
    out = tlpips.lpips(model, torch.from_numpy(x), torch.from_numpy(y))
    assert out.shape == ref.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert float(model(torch.from_numpy(x), torch.from_numpy(x)).abs().max()) == 0.0


def test_load_lpips_params_reads_weight_files(tmp_path):
    """torchvision's vgg16 and taming's vgg.pth files, where given, replace
    the random draws, in both packages alike."""
    rng = np.random.default_rng(6)
    vgg = {f"features.{idx}.{k}": torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.05)
           for convs in tlpips.VGG_SLICES for idx, cin, cout in convs
           for k, shape in (("weight", (cout, cin, 3, 3)), ("bias", (cout,)))}
    lins = {f"lin{k}.model.1.weight": torch.from_numpy(np.abs(rng.standard_normal((1, c, 1, 1))).astype(np.float32))
            for k, c in enumerate(tlpips.CHNS)}
    torch.save(vgg, tmp_path / "vgg16.pth")
    torch.save(lins, tmp_path / "vgg.pth")
    sd = tlpips.load_lpips_params(str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth"))
    jp = jlpips.load_lpips_params(str(tmp_path / "vgg16.pth"), str(tmp_path / "vgg.pth"))
    bridged = lpips_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for k in sd:
        torch.testing.assert_close(sd[k], bridged[k], rtol=0, atol=0)
    torch.testing.assert_close(sd["net.slice2.5.weight"], vgg["features.5.weight"], rtol=0, atol=0)
    with pytest.warns(UserWarning, match="VGG16 weights not found"):
        tlpips.load_lpips_params(str(tmp_path / "missing.pth"))


@pytest.mark.parametrize("src", [256, 37, 310, 299], ids=["256", "37", "310-down", "299"])
def test_inception_resize_matches_jax(src):
    """The bilinear resize without antialias equals jax.image.resize at the
    edges too (up from 256 and 37, down from 310, and the identity)."""
    x = _imgs((1, 3, src, src + 3), 7, 0, 1)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, 299, 299), method="bilinear", antialias=False))
    out = torch.nn.functional.interpolate(torch.from_numpy(x), size=(299, 299), mode="bilinear",
                                          align_corners=False, antialias=False).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    for edge in (np.s_[..., 0, :], np.s_[..., -1, :], np.s_[..., :, 0], np.s_[..., :, -1]):
        np.testing.assert_allclose(out[edge], ref[edge], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def inception_pair():
    jparams = jinc.init_random_inception_params(jax.random.key(0))
    sd = tinc.import_inception_torch_state_dict(tinc.random_inception_torch_state_dict())
    model = tinc.InceptionV3(device="cpu")
    model.load_state_dict(sd, strict=True)
    return jparams, sd, model


def test_inception_weights_match_jax(inception_pair):
    jparams, sd, _ = inception_pair
    bridged = inception_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert set(bridged) == set(sd) and len(sd) == 94 * 3
    for k in sd:
        torch.testing.assert_close(bridged[k], sd[k], rtol=0, atol=0)


def test_inception_features_match_jax(inception_pair):
    """Batch 2 at 64 x 80 (resized up to 299): pooled features and the sFID
    tap (Mixed_6d's first 192 channels), and a block-boundary tap."""
    jparams, _, model = inception_pair
    x = _imgs((2, 64, 80, 3), 8, 0, 1)
    jpool, jsp = jinc.inception_forward(jparams, jnp.asarray(x), return_spatial=True)
    pool, sp = model(torch.from_numpy(x), return_spatial=True)
    assert pool.shape == (2, 2048) and sp.shape == (2, 192, 17, 17)
    assert rel_l2(pool, jpool) <= 1e-5
    assert rel_l2(sp, jsp) <= 1e-5
    _, jtap = jinc.inception_forward(jparams, jnp.asarray(x), return_spatial=True, spatial_tap="Mixed_7b")
    _, tap = model(torch.from_numpy(x), return_spatial=True, spatial_tap="Mixed_7b")
    assert tap.shape == (2, 2048, 8, 8) and rel_l2(tap, jtap) <= 1e-5
    with pytest.raises(ValueError, match="unknown spatial_tap"):
        model(torch.from_numpy(x), return_spatial=True, spatial_tap="Mixed_9z")


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(9)
    a, b = rng.standard_normal((300, 16)), rng.standard_normal((300, 16)) * 1.3 + 0.2
    (m1, s1), (m2, s2) = tfid.calculate_activation_statistics(a), tfid.calculate_activation_statistics(b)
    ref = jfid.calculate_frechet_distance(m1, s1, m2, s2)
    assert abs(tfid.calculate_frechet_distance(m1, s1, m2, s2) - ref) <= 1e-6 * abs(ref)
    assert abs(tfid.calculate_frechet_distance(m1, s1, m1, s1)) < 1e-6
    # singular covariances (fewer samples than dimensions): the eps offset
    c, d = rng.standard_normal((5, 16)), rng.standard_normal((5, 16))
    (m3, s3), (m4, s4) = tfid.calculate_activation_statistics(c), tfid.calculate_activation_statistics(d)
    ref = jfid.calculate_frechet_distance(m3, s3, m4, s4)
    assert abs(tfid.calculate_frechet_distance(m3, s3, m4, s4) - ref) <= 1e-6 * abs(ref)


def test_inception_score_matches_jax(tmp_path, inception_pair):
    """compute_inception_score on softmax rows, and the Evaluator's IS from
    a weights file with an fc head, in both packages."""
    logits = np.random.default_rng(10).standard_normal((12, 1008)) * 3
    preds = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    ref = jev.compute_inception_score(preds, split_size=5)
    assert abs(tev.compute_inception_score(preds, split_size=5) - ref) <= 1e-5 * ref
    rng = np.random.default_rng(11)
    sd = {k: torch.from_numpy(v) for k, v in tinc.random_inception_torch_state_dict().items()}
    sd["fc.weight"] = torch.from_numpy(rng.standard_normal((1008, 2048)).astype(np.float32) * 0.01)
    sd["fc.bias"] = torch.from_numpy(rng.standard_normal(1008).astype(np.float32) * 0.1)
    path = str(tmp_path / "pt_inception.pth")
    torch.save(sd, path)
    pooled = np.abs(rng.standard_normal((10, 2048))).astype(np.float32)
    ref = jev.Evaluator(weights_path=path).compute_inception_score(pooled, split_size=4)
    ev = tev.Evaluator(weights_path=path, device="cpu")
    assert abs(ev.compute_inception_score(pooled, split_size=4) - ref) <= 1e-5 * ref
    # without the file there is no fc head, as in the JAX package
    with pytest.raises(RuntimeError, match="fc head"):
        tev.Evaluator(weights_path=str(tmp_path / "none.pth"), device="cpu").compute_inception_score(pooled)


@pytest.mark.parametrize("device", [None, "cpu"], ids=["host", "torch"])
def test_precision_recall_matches_jax(device):
    """Two clusters that overlap in part: the same radii and fractions as
    the JAX package's host and device paths, with blocks smaller than the
    sets (ragged edges)."""
    rng = np.random.default_rng(12)
    f1 = rng.standard_normal((70, 32)).astype(np.float32)
    f2 = np.concatenate([rng.standard_normal((30, 32)) + 0.3, rng.standard_normal((25, 32)) + 6]).astype(np.float32)
    kw = dict(row_batch_size=32, col_batch_size=24)
    ours = tev.ManifoldEstimator(device=device, **kw)
    r1, r2 = ours.manifold_radii(f1), ours.manifold_radii(f2)
    for jax_device in (False, True):
        theirs = jev.ManifoldEstimator(device=jax_device, **kw)
        j1, j2 = theirs.manifold_radii(f1), theirs.manifold_radii(f2)
        np.testing.assert_allclose(r1, j1, rtol=1e-4)
        np.testing.assert_allclose(r2, j2, rtol=1e-4)
        p, r = ours.evaluate_pr(f1, r1, f2, r2)
        jp, jr = theirs.evaluate_pr(f1, j1, f2, j2)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(r, jr)
    assert 0.3 < float(p[0]) < 0.9 and 0.0 < float(r[0]) <= 1.0


def test_npz_streaming_and_cache(tmp_path):
    """iter_npz_batches reads arr_0 in row batches; read_activations caches
    arr_1/arr_2/arr_tap and reads them back; a limit reads only that many."""
    imgs = np.random.default_rng(13).integers(0, 256, (5, 24, 24, 3), dtype=np.uint8)
    path = str(tmp_path / "batch.npz")
    np.savez(path, arr_0=imgs)
    got = list(tev.iter_npz_batches(path, "arr_0", 2))
    assert [len(b) for b in got] == [2, 2, 1]
    np.testing.assert_array_equal(np.concatenate(got), imgs)
    ev = tev.Evaluator(device="cpu", batch_size=2)
    pooled, spatial = ev.read_activations(path)
    assert pooled.shape == (5, 2048) and spatial.shape == (5, 17 * 17 * 7)
    with np.load(path) as f:
        assert str(f["arr_tap"]) == "mixed_6_conv"
        np.testing.assert_array_equal(f["arr_1"], pooled)
    again = ev.read_activations(path, limit=3)
    np.testing.assert_array_equal(again[0], pooled[:3])
    direct = ev.compute_activations(imgs[:2])
    np.testing.assert_allclose(direct[0], pooled[:2], rtol=1e-5, atol=1e-6)

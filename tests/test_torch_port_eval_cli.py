"""The port's extraction and evaluation CLIs end to end on the CPU, against
the JAX package's CLIs on the same files (``--device cpu`` for the port; the
JAX CLI runs in a subprocess beside it). ``evaluate_tokenizer`` is in
``test_torch_port_eval_tokenizer.py``.

* ``extract_features``: one tiny ImageFolder and one VMAE checkpoint
  written by ``ldmae_tpu/train/torch_export.py``; shard names and labels
  exact, latents (bf16 encode) and statistics within relative L2 2e-2.
* ``fid_stats`` on an ``arr_0`` npz: mu and mu_s within relative L2 1e-5
  (float32 Inception features), sigma and sigma_s within 1e-4 (the
  covariance of six images' deviations from their mean, which are a few
  hundredths of the features here: their relative error is tens of times
  the features').
* ``evaluate --fid`` on two statistics files: the same FID (1e-6).
* ``inference``: the FID pass after sampling (and ``--skip_fid``), and the
  latent statistics computed from the shards where the file is missing.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from ldmae_tpu.data import latent_dataset as jld
from ldmae_tpu.eval import fid as jfid

from torch_port_helpers import finish, image_folder, rel_l2, start_jax_cli, vmae_ckpt, write_config  # noqa: F401

from ldmae_tpu_torch.cli import evaluate, extract_features, fid_stats, inference
from ldmae_tpu_torch.data import latent_dataset as tld

BF16_REL_L2 = 2e-2


@pytest.mark.parametrize("sample", [True, False], ids=["moments", "mode"])
def test_extract_features_cli_matches_jax(tmp_path, image_folder, vmae_ckpt, sample):
    suffix = "_sample" if sample else ""
    jcfg = write_config(str(tmp_path / "j.yaml"), image_folder, str(tmp_path / "jax"), vmae_ckpt, sample)
    tcfg = write_config(str(tmp_path / "t.yaml"), image_folder, str(tmp_path / "port"), vmae_ckpt, sample)
    proc = start_jax_cli("ldmae_tpu.cli.extract_features", "--config", jcfg, "--batch", "4", "--limit", "5")
    out = extract_features.main(["--config", tcfg, "--batch", "4", "--limit", "5", "--device", "cpu"])
    finish(proc)
    assert out == str(tmp_path / "port") + suffix
    jdir = str(tmp_path / "jax") + suffix
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(jdir)) == ["latents_rank00_shard000.safetensors", "latents_stats.pt"]
    tsh = tld.read_safetensors(os.path.join(out, names[0]))
    jsh = tld.read_safetensors(os.path.join(jdir, names[0]))
    assert tsh["latents"].shape == (5, 32 if sample else 16, 4, 4)
    np.testing.assert_array_equal(tsh["labels"], jsh["labels"])
    np.testing.assert_array_equal(tsh["labels"], [0, 0, 0, 1, 1])
    for key in ("latents", "latents_flip"):
        assert rel_l2(tsh[key], jsh[key]) <= BF16_REL_L2
    tstats, jstats = tld._load_stats(os.path.join(out, names[1])), jld._load_stats(os.path.join(jdir, names[1]))
    for k in ("mean", "std"):
        assert rel_l2(tstats[k], jstats[k]) <= BF16_REL_L2
    # the unedited JAX reader takes the port's shards and statistics
    jds = jld.ImgLatentDataset(out, latent_norm=True, sample=sample)
    np.testing.assert_array_equal(jds._latent_std, tstats["std"])
    assert len(jds) == 5


def test_fid_stats_cli_matches_jax(tmp_path):
    imgs = np.random.default_rng(14).integers(0, 256, (6, 40, 40, 3), dtype=np.uint8)
    # one copy each: the evaluator caches activations into the npz it reads
    for side in ("jax", "port"):
        np.savez(str(tmp_path / f"{side}.npz"), arr_0=imgs)
    proc = start_jax_cli("ldmae_tpu.cli.fid_stats", "--input", str(tmp_path / "jax.npz"), "--out",
                         str(tmp_path / "jax_stats.npz"), "--batch_size", "4")
    out = fid_stats.main(["--input", str(tmp_path / "port.npz"), "--out", str(tmp_path / "port_stats.npz"),
                          "--batch_size", "4", "--device", "cpu"])
    finish(proc)
    with np.load(out) as t, np.load(str(tmp_path / "jax_stats.npz")) as j:
        assert t["mu"].shape == (2048,) and t["sigma_s"].shape == (2023, 2023)
        for k, tol in (("mu", 1e-5), ("sigma", 1e-4), ("mu_s", 1e-5), ("sigma_s", 1e-4)):
            assert rel_l2(t[k], j[k]) <= tol, k


def test_evaluate_fid_cli_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(15)
    paths = []
    for i, shift in enumerate((0.0, 0.4)):
        a = rng.standard_normal((200, 24)) + shift
        np.savez(str(tmp_path / f"s{i}.npz"), mu=a.mean(0), sigma=np.cov(a, rowvar=False))
        paths.append(str(tmp_path / f"s{i}.npz"))
    ref = jfid.calculate_fid_given_paths(paths, feature_fn=lambda x: x)
    out = evaluate.main([*paths, "--fid", "--device", "cpu"])
    assert abs(out["fid"] - ref) <= 1e-6 * ref
    assert f"FID: {ref:.6f}" in capsys.readouterr().out


def _shards(data_dir, seed=16):
    os.makedirs(data_dir)
    rng = np.random.default_rng(seed)
    lat = (rng.standard_normal((6, 16, 4, 4)) * 2 + 1).astype(np.float32)
    tld.write_safetensors(os.path.join(data_dir, "latents_rank00_shard000.safetensors"),
                          {"latents": lat, "latents_flip": lat[..., ::-1], "labels": np.arange(6)})


@pytest.mark.parametrize("skip", [False, True], ids=["fid", "skip_fid"])
def test_inference_fid_pass_and_computed_stats(tmp_path, monkeypatch, skip):
    """After sampling, the FID of the sample folder against
    data.fid_reference_file (not with --skip_fid); the latent statistics
    computed from the shards and saved where latents_stats.pt is missing."""
    from ldmae_tpu_torch.eval import fid as tfid

    calls = []
    monkeypatch.setattr(tfid, "calculate_fid_given_paths", lambda paths, **kw: calls.append((paths, kw)) or 1.5)
    data = str(tmp_path / "latents")
    _shards(data)
    ref = str(tmp_path / "ref.npz")
    np.savez(ref, mu=np.zeros(3), sigma=np.eye(3))
    cfg = {"data": {"image_size": 32, "num_classes": 1000, "data_path": data, "fid_reference_file": ref},
           "vae": {"model_name": "vmae_f8d16", "weight_path": ""},
           "model": {"model_type": "LightningDiT-debug", "in_chans": 16},
           "train": {"exp_name": "tiny", "output_dir": str(tmp_path)},
           "sample": {"num_sampling_steps": 2, "cfg_scale": 1.0, "per_proc_batch_size": 2, "fid_num": 2}}
    path = str(tmp_path / "c.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    out_dir = inference.main(["--config", path, "--device", "cpu"] + (["--skip_fid"] if skip else []))
    assert sorted(os.listdir(out_dir)) == ["000000.png", "000001.png"]
    assert calls == ([] if skip else [([ref, out_dir], {"sp_len": 2, "device": "cpu"})])
    stats = tld._load_stats(os.path.join(data, "latents_stats.pt"))
    expect = tld.ImgLatentDataset(data, latent_norm=False).compute_latent_stats()
    np.testing.assert_array_equal(stats["mean"], expect["mean"])
    _, bundle, _ = inference.build_pipeline(inference.LDMAEConfig.from_yaml(path), device="cpu")
    torch.testing.assert_close(bundle["latent_std"], torch.from_numpy(expect["std"]), rtol=0, atol=0)

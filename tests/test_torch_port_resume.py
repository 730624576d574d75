"""The sampling CLI across ranks and its batch-level resume, on the CPU.

* The stream against the JAX CLI's, in process for both (each with a fake
  pipeline that records its label batches and returns blank images, and its
  rank and world size set): rank r owns batches r, r + world, ..., labels
  from ``default_rng(seed + rank)`` drawn for every batch it owns, the PNG
  indices of its batches (the last cut to ``fid_num``), and
  ``resume_manifest.json`` byte for byte.
* Two ranks (gloo, the torchrun environment) through ``cli.inference``:
  ``fid_num`` 10 at batch 4 covers indices 0-9 exactly once (the JAX test's
  expectation); with one batch's PNGs deleted, a rerun samples that batch
  alone, pixel for pixel the first run's; a resume under another batch size
  or world size stops with the manifest's ``SystemExit``; the
  all-or-nothing skip and a rank with nothing left build no pipeline; a
  writer killed mid-write leaves no truncated ``.png``.
"""

import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import yaml
from PIL import Image

from torch_mp_worker import REPO, spawn

from ldmae_tpu_torch.cli import inference


def _config(tmp_path, **sample):
    cfg = {
        "data": {"image_size": 32, "num_classes": 1000, "data_path": str(tmp_path / "none")},
        "vae": {"model_name": "vmae_f8d16", "weight_path": ""},
        "model": {"model_type": "LightningDiT-debug", "in_chans": 16},
        "train": {"exp_name": "mp", "output_dir": str(tmp_path / "out"), "global_seed": 3},
        "sample": {"num_sampling_steps": 2, "cfg_scale": 4.0, "per_proc_batch_size": 4, "fid_num": 10, **sample},
    }
    path = tmp_path / "mp.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _pngs(d):
    return sorted(int(f[:-4]) for f in os.listdir(d) if f.endswith(".png"))


# ---------------------------------------------------------------------------
# the stream against the JAX CLI's
# ---------------------------------------------------------------------------


def _jax_stream(cfg_path, out_root, rank, world, monkeypatch):
    import jax
    import jax.numpy as jnp

    from ldmae_tpu.cli import inference as jinference
    from ldmae_tpu.core.config import LDMAEConfig as JConfig

    labels = []

    def fake(bundle, key, y):
        labels.append(np.asarray(y))
        return jnp.zeros((len(y), 8, 8, 3), jnp.uint8)

    def pil_pngs(images, paths, level=1, num_threads=0):  # the JAX writer without its g++ build
        for img, path in zip(images, paths):
            Image.fromarray(img).save(path, format="PNG")

    monkeypatch.setattr(jinference, "build_pipeline", lambda config, demo=False: (fake, {}, None))
    monkeypatch.setattr("ldmae_tpu.data.native_io.write_pngs", pil_pngs)
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: world)
    out = jinference.do_sample(JConfig.from_yaml(cfg_path), out_root=out_root)
    monkeypatch.undo()
    return out, labels


def _port_stream(cfg_path, out_root, rank, world, monkeypatch):
    import torch

    labels = []

    def fake(bundle, y, generator=None):
        labels.append(y.numpy())
        return torch.zeros((len(y), 8, 8, 3), dtype=torch.uint8)

    monkeypatch.setattr(inference, "build_pipeline", lambda config, demo=False, device=None: (fake, {}, None))
    monkeypatch.setattr(inference, "get_rank", lambda: rank)
    monkeypatch.setattr(inference, "get_world_size", lambda: world)
    out = inference.do_sample(inference.LDMAEConfig.from_yaml(cfg_path), out_root=out_root, device="cpu")
    monkeypatch.undo()
    return out, labels


@pytest.mark.parametrize("rank,world", [(0, 1), (0, 2), (1, 2), (2, 3)])
def test_sampling_stream_matches_jax(tmp_path, monkeypatch, rank, world):
    cfg = _config(tmp_path)
    jout, jlabels = _jax_stream(cfg, str(tmp_path / "jax"), rank, world, monkeypatch)
    tout, tlabels = _port_stream(cfg, str(tmp_path / "port"), rank, world, monkeypatch)
    assert os.path.basename(jout) == os.path.basename(tout)
    assert len(tlabels) == len(jlabels) == len(range(rank, 3, world))
    for a, b in zip(tlabels, jlabels):
        np.testing.assert_array_equal(a, b)
    assert _pngs(tout) == _pngs(jout) == [j for i in range(rank, 3, world) for j in range(4 * i, min(4 * i + 4, 10))]
    manifest = "resume_manifest.json"
    if rank == 0:
        with open(os.path.join(tout, manifest), "rb") as f, open(os.path.join(jout, manifest), "rb") as g:
            assert f.read() == g.read()
    else:  # rank 0 writes it
        assert not os.path.exists(os.path.join(tout, manifest))


def test_skip_before_the_pipeline_is_built(tmp_path, monkeypatch):
    """A folder with fid_num PNGs is skipped whole, and a rank whose batches
    are all on disk samples nothing: neither builds the pipeline."""
    cfg = inference.LDMAEConfig.from_yaml(_config(tmp_path))
    out = os.path.join(str(tmp_path / "out" / "mp"), inference.folder_name(cfg))
    os.makedirs(out)
    for i in (0, 1, 2, 3, 8, 9):  # rank 0's batches 0 and 2 of a world of 2
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(os.path.join(out, f"{i:06d}.png"))

    def no_build(*a, **kw):
        raise AssertionError("the pipeline was built")

    monkeypatch.setattr(inference, "build_pipeline", no_build)
    monkeypatch.setattr(inference, "get_world_size", lambda: 2)
    assert inference.do_sample(cfg, device="cpu") == out
    monkeypatch.setattr(inference, "get_world_size", lambda: 1)
    os.remove(os.path.join(out, "resume_manifest.json"))
    for i in (4, 5, 6, 7):
        Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(os.path.join(out, f"{i:06d}.png"))
    assert inference.do_sample(cfg, device="cpu") == out  # fid_num PNGs: skipped before the manifest
    assert not os.path.exists(os.path.join(out, "resume_manifest.json"))


# ---------------------------------------------------------------------------
# two ranks through the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_rank_run(tmp_path_factory):
    """One 2-rank run: fid_num 10 at batch 4, its output folder and stdout,
    and a copy of its PNGs."""
    tmp = tmp_path_factory.mktemp("mp_sample")
    cfg = _config(tmp)
    outs = spawn([["-m", "ldmae_tpu_torch.cli.inference", "--config", cfg, "--device", "cpu", "--skip_fid"]] * 2)
    out_dir = os.path.join(str(tmp / "out" / "mp"), inference.folder_name(inference.LDMAEConfig.from_yaml(cfg)))
    first = {i: np.asarray(Image.open(os.path.join(out_dir, f"{i:06d}.png"))) for i in _pngs(out_dir)}
    return cfg, out_dir, outs, first


def test_two_rank_sampling_covers_fid_num_exactly_once(two_rank_run):
    cfg, out_dir, outs, first = two_rank_run
    assert sorted(first) == list(range(10))
    # 3 batches: rank 0 batches 1 and 3 (cut to 2 images), rank 1 batch 2
    assert "[rank 0] batch 1/3" in outs[0] and "[rank 0] batch 3/3" in outs[0] and "batch 2/3" not in outs[0]
    assert "[rank 1] batch 2/3" in outs[1] and "[rank 0]" not in outs[1]
    assert "[rank 0] sampling done: 6 generated" in outs[0] and "[rank 1] sampling done: 4 generated" in outs[1]
    with open(os.path.join(out_dir, "resume_manifest.json")) as f:
        assert f.read() == '{"per_proc_batch_size": 4, "world": 2, "global_seed": 3, "num_classes": 1000}'
    assert not [f for f in os.listdir(out_dir) if f.endswith(".tmp")]


def test_resume_resamples_a_deleted_batch_with_the_same_pixels(two_rank_run, tmp_path):
    cfg, out_dir, _, first = two_rank_run
    for i in range(4, 8):  # batch 2 of 3, rank 1's
        os.remove(os.path.join(out_dir, f"{i:06d}.png"))
    outs = spawn([["-m", "ldmae_tpu_torch.cli.inference", "--config", cfg, "--device", "cpu", "--skip_fid"]] * 2)
    assert "[rank 0] sampling done: 0 generated + 6 resumed" in outs[0]
    assert "[rank 1] batch 2/3" in outs[1] and "[rank 1] sampling done: 4 generated" in outs[1]
    assert _pngs(out_dir) == list(range(10))
    for i, img in first.items():
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(out_dir, f"{i:06d}.png"))), img, str(i))


@pytest.mark.parametrize("change,match", [
    (dict(per_proc_batch_size=2), "per_proc_batch_size was 4, now 2"),
    (dict(), "world was 2, now 1"),
], ids=["batch", "world"])
def test_manifest_mismatch_stops_the_resume(two_rank_run, tmp_path, change, match):
    """One process on a copy of the two-rank folder with a PNG missing."""
    cfg, out_dir, _, _ = two_rank_run
    raw = yaml.safe_load(open(cfg))
    raw["sample"].update(change)
    raw["train"]["output_dir"] = str(tmp_path / "out")
    config = inference.LDMAEConfig.from_dict(raw)
    copy = os.path.join(str(tmp_path / "out" / "mp"), inference.folder_name(config))
    shutil.copytree(out_dir, copy)
    os.remove(os.path.join(copy, "000009.png"))
    with pytest.raises(SystemExit, match=match):
        inference.do_sample(config, device="cpu")


_KILLED_WRITER = """
import sys, numpy as np
from ldmae_tpu_torch.cli.inference import AsyncPngWriter
w = AsyncPngWriter(sys.argv[1], workers=2)
rng = np.random.default_rng(0)
imgs = rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)
for b in range(1000):
    w.submit(imgs, range(8 * b, 8 * b + 8))
"""


def _pngs_any(d):
    return [f for f in os.listdir(d) if f.endswith(".png")]


def test_a_kill_mid_write_leaves_no_truncated_png(tmp_path):
    """SIGKILL while the writer encodes: every ``.png`` on disk decodes whole
    (a kill leaves at most ``.tmp`` files, which the resume ignores)."""
    out = tmp_path / "pngs"
    p = subprocess.Popen([sys.executable, "-c", _KILLED_WRITER, str(out)], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not (out.exists() and len(_pngs_any(out)) >= 16):
            time.sleep(0.02)
    finally:
        p.send_signal(signal.SIGKILL)
        p.wait()
    names = os.listdir(out)
    done = _pngs_any(out)
    assert len(done) >= 16, names
    for f in done:
        assert np.asarray(Image.open(out / f)).shape == (256, 256, 3), f
    assert all(f.endswith((".png", ".png.tmp")) for f in names)

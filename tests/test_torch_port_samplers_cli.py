"""The sampling CLI's SDE, RK4 and dopri5 modes on the CPU at debug size.

* A YAML with ``sample.mode: SDE`` (and the noise-prediction transport an
  SDE from t0 > 0 needs: with the velocity transport's default eps of 0
  the SBDM drift's 1/t is infinite at t0 = 0, in the reference too), one
  with ``sampling_method: rk4`` and one with ``dopri5`` each write their
  PNGs, in the folder the JAX CLI names for the same YAML.
* An SDE run with one batch's PNGs deleted resamples that batch alone,
  pixel for pixel: the per-batch generator draws z, then the SDE's noise.
"""

import os

import numpy as np
import pytest
from PIL import Image

from ldmae_tpu.cli import inference as jinference
from ldmae_tpu.core.config import LDMAEConfig as JConfig

from ldmae_tpu_torch.cli import inference

MODES = {
    "sde": dict(mode="SDE", sampling_method="euler"),
    "sde_heun": dict(mode="SDE", sampling_method="heun"),
    "rk4": dict(sampling_method="rk4"),
    "dopri5": dict(sampling_method="dopri5"),
}


def _config(tmp_path, **sample):
    raw = {
        "data": {"image_size": 32, "num_classes": 1000, "data_path": str(tmp_path / "none")},
        "vae": {"model_name": "vmae_f8d16", "weight_path": ""},
        "model": {"model_type": "LightningDiT-debug", "in_chans": 16},
        "train": {"exp_name": "tiny", "output_dir": str(tmp_path / "out")},
        "transport": {"path_type": "Linear", "prediction": "noise", "train_eps": 1e-3, "sample_eps": 1e-3},
        "sample": {"num_sampling_steps": 4, "cfg_scale": 4.0, "per_proc_batch_size": 2, "fid_num": 3, **sample},
    }
    return inference.LDMAEConfig.from_dict(raw), raw


def _pngs(d):
    return {f: np.asarray(Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d)) if f.endswith(".png")}


@pytest.mark.parametrize("mode", list(MODES))
def test_cli_writes_pngs_in_each_mode(tmp_path, mode):
    cfg, raw = _config(tmp_path, **MODES[mode])
    out_dir = inference.do_sample(cfg, device="cpu")
    assert os.path.basename(out_dir) == jinference.folder_name(JConfig.from_dict(raw))
    imgs = _pngs(out_dir)
    assert sorted(imgs) == ["000000.png", "000001.png", "000002.png"]
    for img in imgs.values():
        assert img.shape == (32, 32, 3) and img.dtype == np.uint8 and img.std() > 1.0


def test_sde_resume_resamples_a_deleted_batch_with_the_same_pixels(tmp_path):
    cfg, _ = _config(tmp_path, mode="SDE", fid_num=4)
    out_dir = inference.do_sample(cfg, device="cpu")
    first = _pngs(out_dir)
    assert len(first) == 4
    for i in (2, 3):  # batch 2 of 2
        os.remove(os.path.join(out_dir, f"{i:06d}.png"))
    inference.do_sample(cfg, device="cpu")
    again = _pngs(out_dir)
    assert sorted(again) == sorted(first)
    for name, img in first.items():
        np.testing.assert_array_equal(again[name], img, name)
    assert not np.array_equal(first["000000.png"], first["000002.png"])

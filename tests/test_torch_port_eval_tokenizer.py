"""The port's ``evaluate_tokenizer`` CLI end to end on the CPU against the
JAX package's (epsilon 0, one tiny ImageFolder, one VMAE checkpoint written
by ``ldmae_tpu/train/torch_export.py``; the JAX CLI in a subprocess beside
the port's ``--device cpu`` run): the reference PNGs exact, the
reconstructions within 2 levels (bf16 encode and decode); the JAX CLI's
printed metrics (four decimals) and the port's: PSNR within 0.05 dB, LPIPS
and SSIM within 2e-4, rFID within 1e-2 relative (the square root of the
product of two singular 2,048-wide covariances, from six images, is
sensitive to the features' last bits).
"""

import os
import re

import numpy as np
from PIL import Image

from torch_port_helpers import finish, image_folder, start_jax_cli, vmae_ckpt, write_config  # noqa: F401

from ldmae_tpu_torch.cli import evaluate_tokenizer


def _metrics(stdout):
    return {k: float(v) for k, v in re.findall(r"^\s+(rfid|psnr|lpips|ssim): ([-\d.einf]+)$", stdout, re.M)}


def test_evaluate_tokenizer_cli_matches_jax(tmp_path, image_folder, vmae_ckpt):
    cfg = write_config(str(tmp_path / "c.yaml"), image_folder, str(tmp_path / "lat"), vmae_ckpt, True)
    proc = start_jax_cli("ldmae_tpu.cli.evaluate_tokenizer", "--config", cfg, "--data_path", image_folder,
                         "--output_path", str(tmp_path / "jax"), "--batch", "4", "--epsilon", "0.0")
    (report,) = evaluate_tokenizer.main(["--config", cfg, "--data_path", image_folder, "--output_path",
                                         str(tmp_path / "port"), "--batch", "4", "--device", "cpu"])
    ref = _metrics(finish(proc))
    assert set(ref) == {"rfid", "psnr", "lpips", "ssim"}
    assert abs(report["psnr"] - ref["psnr"]) <= 0.05
    assert abs(report["lpips"] - ref["lpips"]) <= 2e-4
    assert abs(report["ssim"] - ref["ssim"]) <= 2e-4
    assert abs(report["rfid"] - ref["rfid"]) <= 1e-2 * ref["rfid"] and report["epsilon"] == 0.0
    for sub, tol in (("reference", 0), ("vmae_f8d16_0.0", 2)):
        names = sorted(os.listdir(tmp_path / "port" / sub))
        assert names == sorted(os.listdir(tmp_path / "jax" / sub)) and len(names) == 6
        for n in names:
            a = np.asarray(Image.open(tmp_path / "port" / sub / n)).astype(int)
            b = np.asarray(Image.open(tmp_path / "jax" / sub / n)).astype(int)
            assert a.shape == (32, 32, 3) and np.abs(a - b).max() <= tol, (sub, n)

"""The port's VMAE training CLI (``ldmae_tpu_torch.cli.train_vmae``) on the
CPU, on a tiny PNG folder, beside the JAX CLI.

* Stage 1 (``mae_for_ldmae_f8d16_small`` at 32^2, the recipe's stage-1
  flags with LPIPS on seeded random weights), 2 epochs x 2 steps:
  ``log.txt`` has one line an epoch with the JAX CLI's keys (the JAX CLI
  runs the same flags in a subprocess), finite losses, and
  ``checkpoint-0.pth`` and ``checkpoint-1.pth``; a rerun with one more
  epoch resumes ("resumed from step 4").
* Stage 3 (``--tune_decoder --resume <stage 1>/checkpoints/checkpoint-0.pth``):
  only ``decoder*`` and ``from_latent`` change; every other parameter keeps
  the stage-1 checkpoint's bits.
* A diverging run (``--blr 1e18``) warns of the non-finite loss and skips
  the update; the options that are not ported raise ``NotImplementedError``
  (``--gradual_resol`` with ``--tune_decoder`` ``ValueError``);
  without ``--device cpu`` and without a card the CLI raises.
"""

import json
import os

import pytest
import torch

from torch_port_helpers import finish, image_folder, start_jax_cli  # noqa: F401 (fixture)

from ldmae_tpu_torch.cli import train_vmae

TINY = ["--model", "mae_for_ldmae_f8d16_small", "--input_size", "32", "--batch_size", "2",
        "--steps_per_epoch", "2", "--num_workers", "2"]
STAGE1 = ["--mask_ratio", "0.25", "--visible_loss_ratio", "0.75", "--no_cls", "--smooth_output",
          "--perceptual_loss_ratio", "0.5", "--fixed_std", "1e-3", "--kl_loss_weight", "1e-6",
          "--warmup_epochs", "1", "--blr", "1e-3"]
STAGE3 = ["--mask_ratio", "0.0", "--no_cls", "--smooth_output", "--perceptual_loss_ratio", "10.0",
          "--kl_loss_weight", "0.0", "--tune_decoder", "--warmup_epochs", "0", "--blr", "1e-3"]


def _log(out_dir):
    with open(os.path.join(out_dir, "log.txt")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def stage1(image_folder, tmp_path_factory):  # noqa: F811
    """The stage-1 run of each package (the JAX CLI in a subprocess, at the
    same time), 2 epochs; returns (port output dir, JAX log lines)."""
    root = tmp_path_factory.mktemp("vmae_cli")
    jax_out, out = str(root / "jax"), str(root / "port")
    # one JAX device (conftest gives the tests eight), so both take batches of 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
        proc = start_jax_cli("ldmae_tpu.cli.train_vmae", "--data_path", image_folder, "--output_dir", jax_out,
                             "--epochs", "2", "--save_epochs", "10", *TINY, *STAGE1)
    try:
        train_vmae.main(["--data_path", image_folder, "--output_dir", out, "--epochs", "2", "--save_epochs", "10",
                         "--device", "cpu", *TINY, *STAGE1])
    finally:
        finish(proc)
    return out, _log(jax_out)


def test_stage1_logs_the_jax_cli_keys_and_saves_epoch_checkpoints(stage1):
    out, jax_lines = stage1
    lines = _log(out)
    assert len(lines) == len(jax_lines) == 2
    assert [sorted(line) for line in lines] == [sorted(line) for line in jax_lines]
    assert [line["train_epoch"] for line in lines] == [0, 1]
    for line in lines:
        assert all(torch.isfinite(torch.tensor(line[k])) for k in
                   ("train_loss", "train_vis_loss", "train_mask_loss", "train_kl_loss", "train_p_loss"))
        assert line["train_p_loss"] > 0 and line["train_mfu"] is None and line["train_img_per_sec"] > 0
    ckpts = sorted(os.listdir(os.path.join(out, "checkpoints")))
    assert ckpts == ["0000002.pt", "0000004.pt", "checkpoint-0.pth", "checkpoint-1.pth"]
    assert os.readlink(os.path.join(out, "checkpoints", "checkpoint-0.pth")) == "0000002.pt"


def test_stage1_rerun_resumes(stage1, image_folder, capsys):  # noqa: F811
    out, _ = stage1
    res = train_vmae.main(["--data_path", image_folder, "--output_dir", out, "--epochs", "3", "--save_epochs", "10",
                           "--device", "cpu", *TINY, *STAGE1])
    assert "resumed from step 4" in capsys.readouterr().out
    assert res["state"].step == 6 and [h["epoch"] for h in res["history"]] == [2]
    assert [line["train_epoch"] for line in _log(out)] == [0, 1, 2]


def test_stage3_tunes_only_the_decoder(stage1, image_folder, tmp_path, capsys):  # noqa: F811
    out, _ = stage1
    start = os.path.join(out, "checkpoints", "checkpoint-0.pth")
    res = train_vmae.main(["--data_path", image_folder, "--output_dir", str(tmp_path / "s3"), "--epochs", "1",
                           "--save_epochs", "1", "--resume", start, "--device", "cpu", *TINY, *STAGE3])
    printed = capsys.readouterr().out
    assert "resumed weights from torch checkpoint" in printed and "unexpected=['mask_token']" in printed
    before = torch.load(start, weights_only=True)["model"]
    changed = []
    for name, p in res["state"].model.named_parameters():
        if name.split(".")[0].startswith(("decoder", "from_latent")):
            changed.append(not torch.equal(p, before[name]))
        else:
            assert torch.equal(p, before[name]) and not p.requires_grad, name
    assert any(changed)
    assert os.path.exists(tmp_path / "s3" / "checkpoints" / "checkpoint-0.pth")


def test_non_finite_loss_warns_and_skips(image_folder, tmp_path, capsys):  # noqa: F811
    res = train_vmae.main(["--data_path", image_folder, "--output_dir", str(tmp_path), "--epochs", "1",
                           "--device", "cpu", *TINY, "--steps_per_epoch", "3", "--mask_ratio", "0.25", "--no_cls",
                           "--warmup_epochs", "0", "--blr", "1e18"])
    assert "(update skipped)" in capsys.readouterr().out
    assert res["state"].step == 3


@pytest.mark.parametrize("flags,error,match", [
    (["--gradual_resol", "--tune_decoder"], ValueError, "gradual_resol"),
    (["--dp", "4"], AssertionError, "mesh 4x1x1 != 1 devices"),  # create_mesh's check, as in the JAX package
    (["--profile_dir", "trace", "--profile_start", "1", "--profile_steps", "2"], None, None),
    (["--resume", "."], NotImplementedError, "ROADMAP.md"),
], ids=["gradual_resol", "dp", "profile", "orbax_resume"])
def test_options_not_ported_raise(flags, error, match, image_folder, tmp_path, capsys, monkeypatch):  # noqa: F811
    """The options the port refuses. ``--gradual_resol`` is ported for stage
    1 (``tests/test_torch_port_vmae_variants.py``); with ``--tune_decoder``,
    which has no gradual form, it raises before any model is built. ``--dp
    4`` in one process is a mesh that does not match the world size.
    ``--profile_dir`` is ported: with the window at steps 1-2 and an epoch
    of 2 steps (the JAX CLI's window, closed at the epoch's end), it writes
    a ``torch.profiler`` trace holding the step's ops."""
    argv = ["--data_path", image_folder, "--output_dir", str(tmp_path), "--device", "cpu", *TINY, *flags]
    if error is not None:
        with pytest.raises(error, match=match):
            train_vmae.main(argv)
        return
    monkeypatch.chdir(tmp_path)  # the trace directory is relative
    train_vmae.main(argv + ["--epochs", "1", "--mask_ratio", "0.25", "--no_cls"])  # TINY: 2 steps an epoch
    out = capsys.readouterr().out
    assert "profiler trace started -> trace" in out and "profiler trace written to trace" in out
    (trace,) = os.listdir(tmp_path / "trace")
    text = (tmp_path / "trace" / trace).read_text()
    assert trace.endswith(".pt.trace.json") and "aten::" in text and "Optimizer.step#AdamW.step" in text


def test_cli_defaults_to_cuda_and_raises_without_it(image_folder, tmp_path, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vmae.main(["--data_path", image_folder, "--output_dir", str(tmp_path), *TINY])

"""Import hygiene, device defaults and the CLI of the PyTorch port, on the CPU.

* Every ``ldmae_tpu_torch`` module, and ``chip_smoke.py``, import without
  JAX or any ``ldmae_tpu`` module (checked in a fresh interpreter).
* Entry points (the sampling, training, extraction and evaluation CLIs and
  models) default to ``cuda`` and raise when there is no CUDA device unless
  the caller passes ``device="cpu"``; PIL and ``safetensors`` are not
  imported with the package.
* A kernel wrapper given a tensor that is not on the CPU takes the kernel
  path (and raises if it cannot launch), never the plain version.
* The forward-only attention kernels, and ``fused_matmul_silu`` off the
  CPU, raise when autograd would record them.
* ``python -m ldmae_tpu_torch.cli.inference --demo`` writes the demo grid,
  also with ``--quant w8a8``; a config's ``parallel.quant`` quantizes the DiT.
* A config naming a VMAE checkpoint that does not exist stops both packages'
  sampling pipeline builders with ``FileNotFoundError``.
* The JAX package's Orbax checkpoints (directories) are refused, naming
  their conversion: the sampling pipeline given one as its checkpoint, and
  the DiT training CLI in an experiment directory whose checkpoints are
  Orbax-named, raise ``NotImplementedError`` instead of running from seeded
  weights or from step 0; a ``.pt`` path that does not exist keeps the
  seeded fallback both packages share.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_no_ldmae_tpu():
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import ldmae_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(ldmae_tpu_torch.__path__, "ldmae_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "ldmae_tpu" or m.startswith("ldmae_tpu."))
        assert not bad, bad
        # PIL is imported where an image is decoded; safetensors is read and
        # written by the port itself
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "safetensors"))
        assert not bad, bad
        # the training slice's and the extraction and evaluation slice's
        # modules are among those checked
        for name in ("ldmae_tpu_torch.train.train_dit", "ldmae_tpu_torch.train.state",
                     "ldmae_tpu_torch.data.latent_dataset", "ldmae_tpu_torch.utils.profiling",
                     "ldmae_tpu_torch.cli.train_dit",
                     "ldmae_tpu_torch.ops.gaussian", "ldmae_tpu_torch.models.vmae", "ldmae_tpu_torch.data.images",
                     "ldmae_tpu_torch.cli.extract_features", "ldmae_tpu_torch.eval.metrics",
                     "ldmae_tpu_torch.models.lpips", "ldmae_tpu_torch.models.inception", "ldmae_tpu_torch.eval.fid",
                     "ldmae_tpu_torch.cli.evaluate_tokenizer", "ldmae_tpu_torch.eval.evaluator",
                     "ldmae_tpu_torch.eval.save_npz", "ldmae_tpu_torch.cli.fid_stats", "ldmae_tpu_torch.cli.evaluate",
                     "ldmae_tpu_torch.cli.inference", "ldmae_tpu_torch.ops.conv",
                     "ldmae_tpu_torch.transport.adaptive", "ldmae_tpu_torch.transport.utils",
                     "ldmae_tpu_torch.transport.samplers", "ldmae_tpu_torch.transport.paths"):
            assert name in names, name
        print(len(names))
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 40


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_config(tmp_path):
    from ldmae_tpu_torch.core.config import LDMAEConfig

    cfg = LDMAEConfig.from_dict({
        "data": {"image_size": 32, "num_classes": 1000, "data_path": str(tmp_path / "none")},
        "vae": {"model_name": "vmae_f8d16", "weight_path": ""},
        "model": {"model_type": "LightningDiT-debug", "in_chans": 16},
        "train": {"exp_name": "tiny", "output_dir": str(tmp_path)},
        "sample": {"num_sampling_steps": 3, "cfg_scale": 4.0, "per_proc_batch_size": 2, "fid_num": 3},
    })
    return cfg


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    from ldmae_tpu_torch.cli import evaluate, evaluate_tokenizer, extract_features, fid_stats, train_dit
    from ldmae_tpu_torch.cli.inference import build_pipeline
    from ldmae_tpu_torch.eval.evaluator import Evaluator
    from ldmae_tpu_torch.models.inception import InceptionV3
    from ldmae_tpu_torch.models.lpips import LPIPS
    from ldmae_tpu_torch.core import resolve_device
    from ldmae_tpu_torch.eval.sampling import demo_labels, make_sample_fn
    from ldmae_tpu_torch.models import VMAE, LightningDiT, dit_spec, production_vmae_spec
    from ldmae_tpu_torch.transport import create_transport

    spec = dit_spec("LightningDiT-debug")
    cfg_path = str(tmp_path / "tiny.yaml")
    _tiny_config(tmp_path).to_yaml(cfg_path)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    npz = str(tmp_path / "a.npz")
    np.savez(npz, arr_0=np.zeros((2, 8, 8, 3), np.uint8))
    for call in (
        lambda: resolve_device(),
        lambda: LightningDiT(spec),
        lambda: VMAE(production_vmae_spec(32)),
        lambda: make_sample_fn(spec, create_transport()),
        lambda: demo_labels(),
        lambda: build_pipeline(_tiny_config(tmp_path)),
        lambda: train_dit.main(["--config", cfg_path]),
        lambda: train_dit.main(["--config", cfg_path, "--device", "cuda"]),
        lambda: extract_features.main(["--config", cfg_path]),
        lambda: evaluate_tokenizer.main(["--config", cfg_path, "--data_path", str(imgs),
                                         "--output_path", str(tmp_path / "rfid")]),
        lambda: fid_stats.main(["--input", npz, "--out", str(tmp_path / "s.npz")]),
        lambda: evaluate.main([npz, npz]),
        lambda: evaluate.main([npz, npz, "--fid"]),
        lambda: LPIPS(),
        lambda: InceptionV3(),
        lambda: Evaluator(),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    LightningDiT(spec, device="cpu")


def test_wrappers_never_run_the_plain_version_off_the_cpu(monkeypatch):
    """The plain version is chosen by the tensor's device alone: a tensor
    elsewhere goes to the kernel launch, here stopped at the library load."""
    from ldmae_tpu_torch import kernels
    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops import fused_adaln as fad

    class Launch(Exception):
        pass

    def load(name):
        raise Launch(name)

    monkeypatch.setattr(kernels, "load", load)
    q = torch.empty(1, 2, 64, 64, dtype=torch.bfloat16, device="meta")
    cos = torch.empty(64, 64, device="meta")
    x = torch.empty(2, 128, 128, dtype=torch.bfloat16, device="meta")
    sh = torch.empty(2, 128, device="meta")
    w = torch.empty(64, device="meta")
    qkv = torch.empty(1, 64, 3, 2, 64, dtype=torch.bfloat16, device="meta")
    for call in (
        lambda: fa.flash_attention(q, q, q),
        lambda: fa.flash_attention_rope(q, q, q, cos, cos),
        lambda: fad.fused_norm_modulate(x, None, sh, sh),
        lambda: fad.fused_matmul_silu(x, torch.empty(256, 128, device="meta"), None),
        lambda: fa.flash_attention_qknorm_rope(q, q, q, w, w, cos, cos),
        lambda: fa.flash_attention_fused_rope(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], cos, cos),
        lambda: fad.fused_norm_modulate_quant(x, None, sh.bfloat16(), sh.bfloat16()),
        lambda: fad.fused_silu_mul_quant(x),
        lambda: fa.flash_attention_bwd(q, q, q, q),
        lambda: fa.flash_attention_rope_bwd(q, q, q, q, cos, cos),
    ):
        with pytest.raises(Launch):
            call()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_fp32_and_other_head_dims_never_run_the_plain_version_off_the_cpu(monkeypatch, dtype):
    """The same in both kernel dtypes at head dims off the first kernels'
    (12, 80) and for the resident d = 16 forward and the bf16 dense with an
    fp32 bias (at a shape its wgmma kernel takes)."""
    from ldmae_tpu_torch import kernels
    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops import fused_adaln as fad
    from ldmae_tpu_torch.ops import linear as lin

    class Launch(Exception):
        pass

    def load(name):
        raise Launch(name)

    monkeypatch.setattr(kernels, "load", load)
    meta = dict(dtype=dtype, device="meta")
    q12, q80 = torch.empty(1, 2, 64, 12, **meta), torch.empty(1, 2, 64, 80, **meta)
    cos = torch.empty(64, 80, device="meta")
    x = torch.empty(2, 128, 1152, **meta)
    sh = torch.empty(2, 1152, **meta)
    calls = [
        lambda: fa.flash_attention(q12, q12, q12),
        lambda: fa.flash_attention_rope(q80, q80, q80, cos, cos),
        lambda: fa.flash_attention_bwd(q12, q12, q12, q12),
        lambda: fa.flash_attention_rope_bwd(q80, q80, q80, q80, cos, cos),
        lambda: fad.fused_norm_modulate(x, None, sh, sh),
        lambda: fad.fused_norm_modulate_quant(x, None, sh, sh),
        lambda: fad.fused_matmul_silu(x, torch.empty(512, 1152, device="meta"), None),
        lambda: fad.fused_silu_mul_quant(x),
    ]
    if dtype == torch.bfloat16:
        q16 = torch.empty(2, 12, 1024, 16, **meta)
        calls += [lambda: fa.flash_attention_resident(q16, q16, q16),
                  lambda: lin.dense(x, torch.empty(256, 1152, device="meta"), torch.empty(256, device="meta"))]
    for call in calls:
        with pytest.raises(Launch):
            call()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_forward_only_kernels_raise_under_autograd(monkeypatch, device):
    """The qk-norm and fused-layout attention kernels have no backward: with
    inputs that require grad they raise before any launch, on the CPU and off
    it, so no training run takes them and leaves the attention weights
    without a gradient; under no_grad they run (off the CPU: they launch)."""
    from ldmae_tpu_torch import kernels
    from ldmae_tpu_torch.ops import attention as att
    from ldmae_tpu_torch.ops import flash_attention as fa

    class Launch(Exception):
        pass

    def load(name):
        raise Launch(name)

    monkeypatch.setattr(kernels, "load", load)
    bf16 = dict(dtype=torch.bfloat16, device=device)
    q = torch.zeros(1, 2, 64, 64, **bf16).requires_grad_()
    qkv = torch.zeros(1, 64, 3, 2, 64, **bf16).requires_grad_()
    cos, w = torch.ones(64, 64, device=device), torch.ones(64, device=device)
    for call in (
        lambda: fa.flash_attention_qknorm_rope(q, q, q, w, w, cos, cos),
        lambda: fa.flash_attention_fused_rope(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], cos, cos),
    ):
        with pytest.raises(RuntimeError, match="forward only"):
            call()
        with torch.no_grad():
            if device == "cpu":
                assert call().shape[-1] == 64
            else:
                with pytest.raises(Launch):
                    call()
    if device != "cpu":
        return
    # through the attention module, as a train step with either impl would call it
    d, heads, n = 32, 2, 16
    p = torch.nn.Module()
    p.qkv, p.proj = torch.nn.Linear(d, 3 * d), torch.nn.Linear(d, d)
    p.q_norm, p.k_norm = torch.nn.Module(), torch.nn.Module()
    p.q_norm.weight = p.k_norm.weight = torch.nn.Parameter(torch.ones(d // heads))
    rope = (torch.ones(n, d // heads), torch.zeros(n, d // heads))
    x = torch.randn(2, n, d)
    for impl in ("flash_qkr", "flash_fused"):
        kw = dict(rope=rope, rope_layout="half", qk_norm_kind="rms", impl=impl)
        with pytest.raises(RuntimeError, match="forward only"):
            att.multi_head_attention(x, p, heads, **kw)
        with torch.no_grad():
            assert att.multi_head_attention(x, p, heads, **kw).shape == x.shape


def test_fused_matmul_silu_raises_under_autograd_off_the_cpu(monkeypatch):
    """#4 has no backward: off the CPU, with an input that requires grad
    and grad enabled, it raises before any kernel loads (its output would
    carry no gradient to the SwiGLU's w12); under no_grad it launches. On
    the CPU the plain version stays differentiable."""
    from ldmae_tpu_torch import kernels
    from ldmae_tpu_torch.ops import fused_adaln as fad

    class Launch(Exception):
        pass

    def load(name):
        raise Launch(name)

    monkeypatch.setattr(kernels, "load", load)
    x = torch.empty(2, 128, 128, dtype=torch.bfloat16, device="meta")
    w = torch.empty(256, 128, device="meta")
    for args in ((x.requires_grad_(), w, None), (x.detach(), w.requires_grad_(), None),
                 (x.detach(), w.detach(), torch.empty(256, device="meta").requires_grad_())):
        with pytest.raises(RuntimeError, match="fused_matmul_silu is forward only"):
            fad.fused_matmul_silu(*args)
        with torch.no_grad(), pytest.raises(Launch):
            fad.fused_matmul_silu(*args)
    xc = torch.randn(2, 128, 128, requires_grad=True)
    wc = torch.randn(256, 128, requires_grad=True)
    out = fad.fused_matmul_silu(xc, wc, None)
    out.sum().backward()
    assert xc.grad is not None and wc.grad is not None and float(wc.grad.abs().sum()) > 0


def test_cli_demo_grid_on_cpu(tmp_path):
    from PIL import Image

    from ldmae_tpu_torch.cli import inference

    cfg_path = tmp_path / "tiny.yaml"
    _tiny_config(tmp_path).to_yaml(str(cfg_path))
    out = tmp_path / "demo"
    inference.main(["--config", str(cfg_path), "--demo", "--demo_out", str(out), "--device", "cpu"])
    (png,) = list(out.iterdir())
    img = np.asarray(Image.open(png))
    assert img.shape == (2 * 32, 4 * 32, 3) and img.dtype == np.uint8


def test_cli_demo_grid_with_quant_on_cpu(tmp_path):
    from PIL import Image

    from ldmae_tpu_torch.cli import inference

    cfg_path = tmp_path / "tiny.yaml"
    _tiny_config(tmp_path).to_yaml(str(cfg_path))
    out = tmp_path / "demo"
    inference.main(["--config", str(cfg_path), "--demo", "--demo_out", str(out), "--device", "cpu",
                    "--quant", "w8a8"])
    (png,) = list(out.iterdir())
    img = np.asarray(Image.open(png))
    assert img.shape == (2 * 32, 4 * 32, 3) and img.dtype == np.uint8


@pytest.mark.parametrize("quant", ["w8a8", "w8"])
def test_config_parallel_quant_quantizes_the_dit(tmp_path, quant):
    """A YAML that says parallel.quant samples quantized, as the JAX CLI
    does: the DiT's block linears are int8, the out-projection is not, and
    the sample function runs the quantized forward."""
    from ldmae_tpu_torch.cli.inference import build_pipeline
    from ldmae_tpu_torch.ops.quant import QLinear

    cfg = _tiny_config(tmp_path)
    cfg.parallel.quant = quant
    sample_fn, bundle, spec = build_pipeline(cfg, device="cpu")
    blk = bundle["dit"].blocks[0]
    for lin in (blk.attn.qkv, blk.mlp.w12, blk.mlp.w3, blk.adaLN_modulation[1]):
        assert isinstance(lin, QLinear) and lin.w_q.dtype == torch.int8
    assert isinstance(blk.attn.proj, torch.nn.Linear)
    lat = sample_fn(dict(bundle, vae=None), torch.tensor([1, 2]), generator=torch.Generator().manual_seed(0))
    assert lat.shape == (2, spec.in_channels, spec.input_size, spec.input_size)
    assert torch.isfinite(lat).all()


def test_cli_writes_pngs_on_cpu(tmp_path):
    from ldmae_tpu_torch.cli import inference

    cfg = _tiny_config(tmp_path)
    out_dir = inference.do_sample(cfg, device="cpu")
    # the PNGs and the stream-identity manifest of the batch-level resume
    assert sorted(os.listdir(out_dir)) == ["000000.png", "000001.png", "000002.png", "resume_manifest.json"]
    assert os.path.basename(out_dir) == inference.folder_name(cfg)


def test_pipeline_builders_raise_for_a_missing_vmae_checkpoint(tmp_path):
    """A ``vae.weight_path`` that names no file: the JAX CLI's tokenizer
    loader raises (``ldmae_tpu/models/tokenizers.py``, ``_load_or_init``),
    and so must the port's builder, rather than decode through seeded random
    weights. (An empty path means seeded weights in both.)"""
    from ldmae_tpu.cli.inference import build_pipeline as jbuild_pipeline
    from ldmae_tpu.core.config import LDMAEConfig as JLDMAEConfig

    from ldmae_tpu_torch.cli.inference import build_pipeline

    cfg = _tiny_config(tmp_path)
    cfg.vae.weight_path = str(tmp_path / "missing" / "vmaef8d16.pth")
    cfg_path = str(tmp_path / "missing_vae.yaml")
    cfg.to_yaml(cfg_path)
    with pytest.raises(FileNotFoundError, match="vmaef8d16.pth"):
        jbuild_pipeline(JLDMAEConfig.from_yaml(cfg_path))
    with pytest.raises(FileNotFoundError, match="vmaef8d16.pth"):
        build_pipeline(cfg, device="cpu")


def _orbax_refusal(err) -> None:
    """The refusal names the conversion and says that AdamW's moments do
    not cross (the export writes an empty ``opt``)."""
    msg = str(err.value)
    assert "python -m ldmae_tpu.cli.export_torch" in msg and "AdamW's moments do not cross" in msg, msg


def test_pipeline_builder_raises_for_an_orbax_checkpoint_directory(tmp_path, monkeypatch, capsys):
    """An existing directory as the DiT checkpoint (the JAX CLI restores it
    with Orbax) raises before the DiT is built; a missing ``.pt`` path
    keeps the seeded fallback."""
    from ldmae_tpu_torch.cli import inference

    orbax = tmp_path / "checkpoints" / "0100000"
    orbax.mkdir(parents=True)
    built = []
    monkeypatch.setattr(inference, "LightningDiT", lambda *a, **kw: built.append(a) or pytest.fail("DiT built"))
    with pytest.raises(NotImplementedError) as err:
        inference.build_pipeline(_tiny_config(tmp_path), ckpt_path=str(orbax), device="cpu")
    _orbax_refusal(err)
    assert not built
    monkeypatch.undo()
    inference.build_pipeline(_tiny_config(tmp_path), ckpt_path=str(tmp_path / "missing.pt"), device="cpu")
    assert "using seeded random weights" in capsys.readouterr().out


def test_train_cli_raises_for_orbax_checkpoints_instead_of_starting_at_step_0(tmp_path, monkeypatch):
    """An experiment directory that holds only an Orbax-named
    ``checkpoints/0000002/`` (the JAX CLI resumes from it): the port's
    training CLI raises rather than train from step 0."""
    import yaml

    from ldmae_tpu_torch.cli import train_dit

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    (tmp_path / "out" / "tiny" / "checkpoints" / "0000002").mkdir(parents=True)
    cfg = {
        "data": {"data_path": str(tmp_path / "none"), "image_size": 32, "num_classes": 10},
        "vae": {"model_name": "vmae_f8d16", "weight_path": ""},
        "model": {"model_type": "LightningDiT-debug", "in_chans": 16},
        "train": {"max_steps": 4, "global_batch_size": 2, "output_dir": str(tmp_path / "out"), "exp_name": "tiny"},
    }
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with pytest.raises(NotImplementedError, match="0000002") as err:
        train_dit.main(["--config", str(path), "--device", "cpu"])
    _orbax_refusal(err)
    assert sorted(os.listdir(tmp_path / "out" / "tiny" / "checkpoints")) == ["0000002"]


@pytest.mark.parametrize("model_name", ["sdv3", "vavae", "marvae"])
def test_clis_default_to_cuda_with_a_conv_tokenizer(no_cuda, tmp_path, model_name):
    """With a conv tokenizer named in the config, the sampling, extraction
    and tokenizer-evaluation entries still default to ``cuda`` and raise
    without it, before any model is built."""
    from ldmae_tpu_torch.cli import evaluate_tokenizer, extract_features, inference
    from ldmae_tpu_torch.cli.inference import build_pipeline

    cfg = _tiny_config(tmp_path)
    cfg.vae.model_name = model_name
    cfg_path = str(tmp_path / "conv.yaml")
    cfg.to_yaml(cfg_path)
    for call in (
        lambda: build_pipeline(cfg),
        lambda: inference.main(["--config", cfg_path, "--demo"]),
        lambda: extract_features.main(["--config", cfg_path]),
        lambda: evaluate_tokenizer.main(["--config", cfg_path, "--data_path", str(tmp_path),
                                         "--output_path", str(tmp_path / "rfid")]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cli_demo_grid_with_the_sdvae_on_cpu(tmp_path, monkeypatch):
    """``vae.model_name: sdv3``: the sampling CLI decodes through the SD-VAE
    (full width, seeded weights) on the CPU when asked."""
    from PIL import Image

    from ldmae_tpu_torch.cli import inference
    from ldmae_tpu_torch.models.conv_vae import ConvVAE

    decoded = []
    real = ConvVAE.decode_to_images

    def spy(self, z):
        decoded.append(self.spec.ch_mult)
        return real(self, z)

    monkeypatch.setattr(ConvVAE, "decode_to_images", spy)
    cfg = _tiny_config(tmp_path)
    cfg.vae.model_name = "sdv3"
    cfg_path = tmp_path / "sdv3.yaml"
    cfg.to_yaml(str(cfg_path))
    out = tmp_path / "demo"
    inference.main(["--config", str(cfg_path), "--demo", "--demo_out", str(out), "--device", "cpu"])
    assert decoded == [(1, 2, 4, 4)]
    (png,) = list(out.iterdir())
    img = np.asarray(Image.open(png))
    assert img.shape == (2 * 32, 4 * 32, 3) and img.dtype == np.uint8 and img.std() > 1.0

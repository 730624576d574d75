"""Shared helpers of the port's parity tests (JAX side), and the fixtures of
its CLI tests: a tiny ImageFolder, a VMAE checkpoint, a config, the JAX CLI
in a subprocess."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def randomize(params, seed, std=0.02):
    """Every leaf of a JAX parameter tree replaced by a seeded numpy draw,
    normal x std; norm weights ("scale" leaves) get 1 + that draw. Nothing
    is zero, unlike the reference init's adaLN and final layer."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        v = rng.standard_normal(leaf.shape).astype(np.float32) * np.float32(std)
        if "scale" in jax.tree_util.keystr(path):
            v += np.float32(1.0)
        return jnp.asarray(v)

    return jax.tree_util.tree_map_with_path(draw, params)


def to_numpy(params):
    return jax.tree_util.tree_map(np.asarray, params)


def rel_l2(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(port - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module")
def image_folder(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(10)
    for c in range(2):
        (root / f"c{c}").mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (40, 44, 3), dtype=np.uint8)).save(root / f"c{c}" / f"{i}.png")
    return str(root)


@pytest.fixture(scope="module")
def vmae_ckpt(tmp_path_factory):
    """A production-arch VMAE checkpoint at 32^2 with seeded non-zero
    weights, written by the JAX package's exporter."""
    from ldmae_tpu.models import vmae as jvmae
    from ldmae_tpu.train.torch_export import save_vmae_torch_checkpoint

    spec = jvmae.vmae_spec("mae_for_ldmae_f8d16_prev", img_size=32, ldmae_mode=True, no_cls=True,
                           kl_loss_weight=True, smooth_output=True)
    params = randomize(jvmae.init_vmae_params(jax.random.key(0), spec), 11)
    return save_vmae_torch_checkpoint(str(tmp_path_factory.mktemp("ckpt") / "vmae.pth"), params, spec)


def write_config(path, origin, data_path, weights, sample):
    cfg = {"data": {"origin_path": origin, "data_path": data_path, "image_size": 32, "num_classes": 2,
                    "latent_norm": True, "sample": sample},
           "vae": {"model_name": "vmae_f8d16", "downsample_ratio": 8, "weight_path": weights},
           "model": {"model_type": "LightningDiT-debug", "in_chans": 16},
           "train": {"output_dir": os.path.dirname(path), "exp_name": "x"}}
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def start_jax_cli(module, *args):
    """The JAX CLI in a subprocess on the CPU, started now, read by ``finish``
    (its compilation cache in the temporary directory, not the checkout)."""
    cache = os.path.join(tempfile.gettempdir(), "ldmae_port_tests_jax_cache")
    env = dict(os.environ, JAX_PLATFORMS="cpu", LDMAE_PLATFORM="cpu", PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=cache)
    return subprocess.Popen([sys.executable, "-m", module, *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish(proc):
    out, err = proc.communicate(timeout=400)
    assert proc.returncode == 0, err[-3000:]
    return out

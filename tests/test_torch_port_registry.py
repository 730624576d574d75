"""The registry slice on the CPU: every LightningDiT arch of the registry and
every ``parallel.quant`` mode through the port against ``ldmae_tpu``.

* The eight registry archs' specs against the JAX specs: exact.
* #10 (``fused_silu_mul_quant``) and its two tensor-parallel
  halves take every SwiGLU width of the registry, int(2/3 * 4D) (2,730 at L,
  4,778 at 1p6B, neither a multiple of 8) and its half at tp 2, as the JAX
  kernel does: on a CUDA tensor the wrappers launch the kernel at each, never
  the plain version, which is held against the JAX kernel (Pallas,
  interpret mode) at the same widths. Checked here on ``meta`` tensors, with
  the library's C entries replaced by recorders; the kernel itself is in
  ``test_torch_port_gpu.py``.
* At the real width, heads, patch and SwiGLU width of L/2, XL/2, 1p6B/1 and
  B/2, cut to depth 1, 8^2 latents and batch 2, from seeded numpy weights
  carried by ``dit_state_dict_from_jax``: the DiT forward under the sampling
  impls (flash_rope, half-split RoPE, fused adaLN and SwiGLU) in bf16 and
  under w8a8; B/1's forward under w8; a 4-step CFG chain at L/2 under w8a8
  from an injected z. The JAX side runs its Pallas kernels in interpret
  mode (its forward under ``jax.jit``, as its sampler runs it); the port's
  wrappers run their plain versions for CPU tensors.

Tolerances, each that of the parity test it mirrors: the bf16 forward
within 2e-2 of max|jax| (``test_torch_port_xl.py``, bf16 roundings through
the blocks); a quantized forward (w8a8, w8) within 3e-2
(``test_torch_port_quant.py::test_quantized_dit_forward_matches_jax``: the
bf16 bound plus one-step int8 flips from rows reduced in another order); the
w8a8 chain's latents within 3e-2 of their scale (the XL chain's 2e-2 in
bf16, plus the same flips); #10's plain version: int8 within one step, at
most 1e-3 of the values off, row scales within rtol 1e-6
(``test_torch_port_quant.py``).
"""

import copy
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ldmae_tpu.eval import sampling as jsampling
from ldmae_tpu.models import lightningdit as jdit
from ldmae_tpu.ops import fused_adaln as jfad
from ldmae_tpu.transport import create_transport as jcreate_transport

from torch_port_helpers import to_numpy

from ldmae_tpu_torch import kernels
from ldmae_tpu_torch.convert import dit_state_dict_from_jax
from ldmae_tpu_torch.eval.sampling import make_sample_fn
from ldmae_tpu_torch.models import LightningDiT, quantize_dit_
from ldmae_tpu_torch.models import lightningdit as tdit
from ldmae_tpu_torch.ops import fused_adaln as tfad
from ldmae_tpu_torch.transport import create_transport

REGISTRY = ["LightningDiT-XL/1", "LightningDiT-XL/2", "LightningDiT-L/2", "LightningDiT-B/1", "LightningDiT-B/2",
            "LightningDiT-1p0B/1", "LightningDiT-1p0B/2", "LightningDiT-1p6B/1", "LightningDiT-1p6B/2"]
# the shipped YAML's model flags
FLAGS = dict(in_channels=16, num_classes=1000, use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True)
# (width, heads, patch, head dim, SwiGLU width) of each arch, from the registry
# of the reference (lightningdit.py:498-531) and int(2/3 * 4D)
WIDTHS = {"LightningDiT-XL/1": (1152, 16, 1, 72, 3072), "LightningDiT-XL/2": (1152, 16, 2, 72, 3072),
          "LightningDiT-L/2": (1024, 16, 2, 64, 2730), "LightningDiT-B/1": (768, 12, 1, 64, 2048),
          "LightningDiT-B/2": (768, 12, 2, 64, 2048), "LightningDiT-1p0B/1": (1536, 24, 1, 64, 4096),
          "LightningDiT-1p0B/2": (1536, 24, 2, 64, 4096), "LightningDiT-1p6B/1": (1792, 28, 1, 64, 4778),
          "LightningDiT-1p6B/2": (1792, 28, 2, 64, 4778)}
SAMPLING_IMPLS = dict(attn_impl="flash_rope", rope_layout="half", adaln_impl="fused", mlp_impl="fused")
FWD_REL = {None: 2e-2, "w8a8": 3e-2, "w8": 3e-2}
CHAIN_REL = 3e-2
CUT = dict(depth=1, input_size=8)


def _rel_max(port, ref):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("arch", REGISTRY)
def test_registry_specs_match_jax(arch):
    """Width, heads, patch, head dim, SwiGLU width, depth and tokens at the
    32^2 latents of 256^2 images."""
    js, ts = jdit.dit_spec(arch, input_size=32, **FLAGS), tdit.dit_spec(arch, input_size=32, **FLAGS)
    port = (ts.hidden_size, ts.num_heads, ts.patch_size, ts.head_dim, ts.swiglu_hidden)
    assert port == (js.hidden_size, js.num_heads, js.patch_size, js.head_dim, js.swiglu_hidden) == WIDTHS[arch]
    assert (ts.depth, ts.num_patches, ts.num_adaln) == (js.depth, js.num_patches, js.num_adaln)
    assert ts.num_patches == 1024 // ts.patch_size**2
    assert sorted(tdit.list_models()) == sorted(jdit.list_models())


# -- #10 at every SwiGLU width of the registry ------------------------------

# H: the SwiGLU widths of L and 1p6B and their tp-2 halves (the fault), and
# the aligned widths of B, XL and 1p0B
GATE_WIDTHS = {"L": 2730, "1p6B": 4778, "L-tp2": 1365, "1p6B-tp2": 2389, "B": 2048, "XL": 3072, "1p0B": 4096}


class _Recorder:
    """Stands for the ``fused_quant`` library: each C entry records its
    (rows, H) and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("h", list(GATE_WIDTHS.values()), ids=list(GATE_WIDTHS))
def test_gate_wrappers_launch_the_kernel_at_every_registry_swiglu_width(h, monkeypatch):
    """The JAX #10 takes the width (its block spans the row), and the port's
    plain version agrees with it there (bf16); on a device tensor, bf16 or
    fp32, #10 and its two tp halves pass their shape rule and call the
    kernel's C entry with that width, counted as a launch, with no fallback
    to the plain version."""
    rng = np.random.default_rng(h)
    jx = jnp.asarray(rng.standard_normal((1, 8, 2 * h)).astype(np.float32) * 2).astype(jnp.bfloat16)
    jq, js = jfad.fused_silu_mul_quant(jx)
    assert jq.shape == (1, 8, h)
    tq, ts = tfad.fused_silu_mul_quant(torch.from_numpy(np.array(jx.astype(jnp.float32))).bfloat16())
    dq = np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int))
    assert dq.max() <= 1 and (dq != 0).mean() <= 1e-3
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)

    lib = _Recorder()
    monkeypatch.setattr(kernels, "load", lambda name: lib)
    monkeypatch.setattr(kernels, "on_device", lambda x, entry, *args: entry(*args, None))
    for plain in ("fused_silu_mul_quant_plain", "silu_mul_amax_plain", "silu_mul_quant_scaled_plain"):
        monkeypatch.setattr(tfad, plain, lambda *a: pytest.fail("the plain version ran on a device tensor"))
    for td in (torch.bfloat16, torch.float32):
        lib.calls.clear()
        x12 = torch.empty(2, 256, 2 * h, device="meta", dtype=td)
        wrappers = (tfad.fused_silu_mul_quant, tfad.silu_mul_amax, tfad.silu_mul_quant_scaled)
        before = [fn.launches for fn in wrappers]
        q, s = tfad.fused_silu_mul_quant(x12)
        amax = tfad.silu_mul_amax(x12)
        q2, s2 = tfad.silu_mul_quant_scaled(x12, amax)
        assert q.shape == q2.shape == (2, 256, h) and s.shape == s2.shape == amax.shape == (2, 256, 1)
        assert [fn.launches - b for fn, b in zip(wrappers, before)] == [1, 1, 1]
        fp32 = int(td == torch.float32)
        assert [(name, args[-4:-1]) for name, args in lib.calls] == [
            ("ldmae_fused_silu_mul_quant", (512, h, fp32)), ("ldmae_silu_mul_amax", (512, h, fp32)),
            ("ldmae_silu_mul_quant_scaled", (512, h, fp32))]


def test_gate_wrappers_raise_for_what_the_kernel_does_not_take():
    """Past the gate kernel's row (H > 8,192), an odd packed width, another
    dtype or a strided x12: a ValueError before any launch."""
    for shape, dtype in (((4, 2 * 8193), torch.bfloat16), ((4, 2731), torch.bfloat16), ((4, 64), torch.float16)):
        x12 = torch.empty(*shape, device="meta", dtype=dtype)
        for fn in (tfad.fused_silu_mul_quant, tfad.silu_mul_amax):
            with pytest.raises(ValueError):
                fn(x12)
    with pytest.raises(ValueError, match="contiguous"):
        tfad.fused_silu_mul_quant(torch.empty(8, 4, device="meta", dtype=torch.bfloat16).t())


# -- the registry's archs at their real widths, depth 1 ----------------------


def _draw(shapes, seed, std=0.02):
    """Every leaf of a JAX parameter tree's shapes as a seeded fp32 normal
    draw x std; norm weights ("scale" leaves) 1 + that draw. Nothing is
    zero, unlike the reference init's adaLN and final layer."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        v = rng.standard_normal(leaf.shape, dtype=np.float32) * np.float32(std)
        return jnp.asarray(v + np.float32(1.0) if "scale" in jax.tree_util.keystr(path) else v)

    return jax.tree_util.tree_map_with_path(draw, shapes)


# the JAX package's parameter transforms, compiled once a spec (eagerly each
# op would compile on its own at every width)
_permute = jax.jit(jdit.permute_qk_for_half_rope, static_argnums=1)
_quantize = jax.jit(jdit.quantize_dit_params, static_argnums=1)


@functools.lru_cache(maxsize=None)
def _models(arch):
    """Seeded JAX parameters at the arch's width, depth 1, 8^2 latents, in
    the half RoPE layout with SwiGLU merged (as the JAX sampling path takes
    them), and the port's DiT carrying the same weights."""
    js, ts = jdit.dit_spec(arch, **FLAGS, **CUT), tdit.dit_spec(arch, **FLAGS, **CUT)
    params = _permute(_draw(jax.eval_shape(lambda: jdit.init_dit_params(jax.random.key(0), js)), 0), js)
    model = LightningDiT(ts, device="cpu")
    model.load_state_dict(dit_state_dict_from_jax(to_numpy(params), ts), strict=True)
    return js, ts, jdit.merge_swiglu(params, js), model


def _quantized(arch):
    js, ts, jp, model = _models(arch)
    return _quantize(jp, js), quantize_dit_(copy.deepcopy(model))


@pytest.mark.parametrize("quant", [None, "w8a8"], ids=["bf16", "w8a8"])
@pytest.mark.parametrize("arch", ["LightningDiT-L/2", "LightningDiT-XL/2", "LightningDiT-1p6B/1", "LightningDiT-B/2"])
def test_registry_dit_forward_matches_jax(arch, quant):
    """The sampling forward at the arch's width, heads, patch and SwiGLU
    width (#1 at its head dim, #3 or #9 at its width, #10 at its SwiGLU
    width under w8a8), bf16."""
    _forward_matches_jax(arch, quant)


def test_b1_forward_under_w8_matches_jax():
    """parallel.quant: w8 (int8 weights dequantized to bf16 before each
    float matmul; w12 unfused) at B/1's width."""
    _forward_matches_jax("LightningDiT-B/1", "w8")


def _forward_matches_jax(arch, quant):
    js, ts, jp, model = _models(arch)
    if quant is not None:
        jp, model = _quantized(arch)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    t = np.array([0.3, 0.71], np.float32)
    y = np.array([3, 1000])  # 1000 = the null class
    kw = dict(SAMPLING_IMPLS, quant_mode=quant)
    consts = jdit.DiTConsts(js)
    forward = jax.jit(lambda p, x, t, y: jdit.dit_forward(p, js, consts, x, t, y, compute_dtype=jnp.bfloat16, **kw))
    ref = forward(jp, jnp.asarray(x), jnp.asarray(t).astype(jnp.bfloat16), jnp.asarray(y))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t).bfloat16(), torch.from_numpy(y),
                    compute_dtype=torch.bfloat16, **kw)
    assert out.shape == (2, 16, 8, 8) and out.dtype == torch.float32
    assert np.abs(np.asarray(ref)).max() > 1e-3  # the gates are non-zero
    assert _rel_max(out.numpy(), ref) < FWD_REL[quant]


def test_l2_w8a8_sample_chain_matches_jax():
    """4 Euler steps, timestep shift 0.3, CFG 4 on [0.10, 1] (phased), the
    first-3-channel guidance and the latent statistics, at L/2 under w8a8
    (#10 at H 2,730 every block), from one injected z; latents only."""
    js, ts, _, _ = _models("LightningDiT-L/2")
    jq, qmodel = _quantized("LightningDiT-L/2")
    rng = np.random.default_rng(2)
    mean = (0.1 * rng.standard_normal((1, 16, 1, 1))).astype(np.float32)
    std = (1 + 0.1 * rng.standard_normal((1, 16, 1, 1))).astype(np.float32)
    chain = dict(num_steps=4, sampling_method="euler", timestep_shift=0.3, cfg_scale=4.0, cfg_interval=True,
                 cfg_interval_start=0.10, cfg_channels=3, quant_mode="w8a8", **SAMPLING_IMPLS)
    jfn = jsampling.make_sample_fn(js, jdit.DiTConsts(js), jcreate_transport(), compute_dtype=jnp.bfloat16, **chain)
    tfn = make_sample_fn(ts, create_transport(), compute_dtype=torch.bfloat16, device="cpu", **chain)
    z = np.random.default_rng(7).standard_normal((2, 16, 8, 8)).astype(np.float32)
    y = np.array([1, 7])
    jbundle = {"dit": jq, "vae": None, "latent_mean": jnp.asarray(mean), "latent_std": jnp.asarray(std)}
    tbundle = {"dit": qmodel, "vae": None, "latent_mean": torch.from_numpy(mean), "latent_std": torch.from_numpy(std)}
    jlat = np.asarray(jfn(jbundle, jax.random.key(0), jnp.asarray(y), z=jnp.asarray(z)))
    tlat = tfn(tbundle, torch.from_numpy(y), z=torch.from_numpy(z)).numpy()
    assert tlat.shape == (2, 16, 8, 8) and np.isfinite(tlat).all()
    assert np.abs(tlat - jlat).max() <= CHAIN_REL * np.abs(jlat).max()
    assert np.abs(tlat - (z * std + mean)).max() > 1e-2  # the DiT moved the latents


@pytest.mark.parametrize("arch,quant", [("LightningDiT-XL/1", "w8a8"), ("LightningDiT-B/1", "w8"),
                                        ("LightningDiT-L/2", "w8a8"), ("LightningDiT-1p6B/1", None)])
def test_chip_smoke_registry_yaml_loads_in_both_packages(tmp_path, arch, quant):
    """The YAML that ``chip_smoke.py`` writes for its registry legs: the
    shipped YAML with model.model_type and parallel.quant changed and
    nothing else, in both config loaders."""
    import dataclasses
    import sys

    from ldmae_tpu.core.config import LDMAEConfig as JConfig
    from ldmae_tpu_torch.core.config import LDMAEConfig

    from torch_port_helpers import REPO

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    path = chip_smoke.xl_yaml(str(tmp_path / "reg.yaml"), arch, parallel={"quant": quant})
    shipped = f"{REPO}/configs/imagenet/lightningdit_b_vmae_f8d16.yaml"
    for loader in (LDMAEConfig, JConfig):
        cfg, ref = loader.from_yaml(path), loader.from_yaml(shipped)
        assert (cfg.model.model_type, cfg.parallel.quant) == (arch, quant)
        assert dataclasses.replace(cfg, model=ref.model, parallel=dataclasses.replace(cfg.parallel, quant=None)) \
            == dataclasses.replace(ref, parallel=dataclasses.replace(ref.parallel, quant=None))

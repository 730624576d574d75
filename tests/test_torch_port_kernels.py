"""Port kernel modules vs the JAX package's Pallas kernels (interpret mode on
the CPU). The CUDA kernels themselves are held against these plain versions
on a card in ``test_torch_port_gpu.py`` and ``chip_smoke.py``.

On the CPU each port wrapper runs its plain PyTorch version, so these tests
pin the arithmetic the CUDA kernels must reproduce. Inputs come from numpy
with a fixed seed and cross as numpy arrays.

Tolerances: in float32 both sides do the same algorithm, so differences are
summation order and exp/rsqrt rounding (1e-5 abs on O(1) values). In bf16
the outputs are rounded to 8 mantissa bits; a differing fp32 intermediate
can flip one rounding, so the bound is a couple of bf16 ulps at the output's
magnitude (2^-7 relative, plus 2^-7 absolute for values below 1).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ldmae_tpu.models import lightningdit as jdit
from ldmae_tpu.ops import flash_attention as jfa
from ldmae_tpu.ops import fused_adaln as jfad
from ldmae_tpu.ops import linear as jlin
from ldmae_tpu.ops.rope import build_rope_table as jbuild_rope, to_half_layout as jhalf

from ldmae_tpu_torch.models import lightningdit as tdit
from ldmae_tpu_torch.ops import flash_attention as tfa
from ldmae_tpu_torch.ops import fused_adaln as tfad
from ldmae_tpu_torch.ops import linear as tlin

BF16_TOL = dict(rtol=2**-7, atol=2**-7)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX and a torch array of dtype ``dt``."""
    jd, td = DTYPES[dt]
    j = jnp.asarray(a, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _close(jout, tout, dt):
    np.testing.assert_allclose(
        tout.float().numpy(), np.asarray(jout.astype(jnp.float32)),
        **(BF16_TOL if dt == "bfloat16" else F32_TOL),
    )


def _qkv(seed, shape, dt):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(shape).astype(np.float32), dt) for _ in range(3)]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,n", [(64, 256), (72, 256), (64, 200)])
def test_flash_attention_rope_matches_pallas(d, n, dt):
    """d = 64 runs the wgmma kernel on the card, d = 72 the mma.sync core;
    N = 200 leaves a ragged last key tile there (72 of 128 keys)."""
    b, h = 2, 2
    grid = int(np.ceil(np.sqrt(n)))
    (jq, tq), (jk, tk), (jv, tv) = _qkv(0, (b, h, n, d), dt)
    cos, sin = (jhalf(t)[:n] for t in jbuild_rope(d // 2, grid))
    jout = jfa.flash_attention_rope(jq, jk, jv, jnp.asarray(cos), jnp.asarray(sin))
    tout = tfa.flash_attention_rope(tq, tk, tv, torch.from_numpy(cos), torch.from_numpy(sin))
    assert tout.dtype == tq.dtype and tout.shape == tq.shape
    _close(jout, tout, dt)


def _tables(d, n):
    """(N, d) half-split RoPE tables: the rows of a grid of ceil(sqrt(N))^2."""
    grid = int(np.ceil(np.sqrt(n)))
    return [np.ascontiguousarray(jhalf(t)[:n]) for t in jbuild_rope(d // 2, grid)]


# (b, h, n, d, views): d = 64 runs the wgmma forward on the card, d = 72
# the mma.sync core; N = 200 and 1025 leave ragged last tiles there (the
# Pallas kernel takes such an N as one block); H = 12 is B/1's; views: the
# port's q, k, v are the attention module's permuted views of a packed qkv
@pytest.mark.parametrize("shape", [
    pytest.param((2, 2, 256, 64, False), id="64"), pytest.param((2, 2, 256, 72, False), id="72"),
    pytest.param((1, 3, 200, 64, False), id="64-n200"), pytest.param((1, 1, 1025, 64, False), id="64-n1025"),
    pytest.param((1, 12, 256, 64, False), id="64-h12"), pytest.param((2, 4, 256, 64, True), id="64-qkv-views"),
])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_attention_qknorm_rope_matches_pallas(dt, shape):
    """The qk-norm kernel's own cast order (norm in fp32, rounded to q's
    dtype, times the fp32 weight, rotated in fp32, one rounding)."""
    b, h, n, d, views = shape
    (jq, tq), (jk, tk), (jv, tv) = _qkv(5, (b, h, n, d), dt)
    if views:  # the same values, laid out as the attention module's views of qkv (B, N, 3, H, d)
        tq, tk, tv = torch.stack([tq, tk, tv]).permute(1, 3, 0, 2, 4).contiguous().permute(2, 0, 3, 1, 4).unbind(0)
        assert tv.stride() == (n * 3 * h * d, d, 3 * h * d, 1)
    rng = np.random.default_rng(6)
    qs, ks = ((1 + 0.1 * rng.standard_normal(d)).astype(np.float32) for _ in range(2))
    cos, sin = _tables(d, n)
    jout = jfa.flash_attention_qknorm_rope(jq, jk, jv, jnp.asarray(qs), jnp.asarray(ks),
                                           jnp.asarray(cos), jnp.asarray(sin))
    tout = tfa.flash_attention_qknorm_rope(tq, tk, tv, torch.from_numpy(qs), torch.from_numpy(ks),
                                           torch.from_numpy(cos), torch.from_numpy(sin))
    assert tout.dtype == tq.dtype and tout.shape == tq.shape
    _close(jout, tout, dt)


# (b, n, h, pad): qkv rows of 3 h d + pad elements; the first two cases are
# the attention module's packed qkv at both dtypes
_FUSED = (2, 256, 4, 0)


@pytest.mark.parametrize("dt,shape", [
    pytest.param("float32", _FUSED, id="float32"), pytest.param("bfloat16", _FUSED, id="bfloat16"),
    *(pytest.param(dt, shape, id=f"{dt}-{name}") for dt in ("float32", "bfloat16") for name, shape in
      (("n200-h12", (1, 200, 12, 0)), ("n1025", (1, 1025, 2, 0)), ("padded-rows", (2, 256, 4, 8)))),
])
def test_flash_attention_fused_rope_matches_pallas(dt, shape):
    """(B, N, H, d) operands, v a strided view of a packed qkv as the
    attention module passes it (its row stride padded past 3 H d in one
    case); ragged N and H = 12 as for the qk-norm kernel."""
    b, n, h, pad = shape
    d = 64
    rng = np.random.default_rng(7)
    jqkv, tqkv = _pair(rng.standard_normal((b, n, 3 * h * d + pad)).astype(np.float32), dt)
    cos, sin = _tables(d, n)
    jq, jk, jv = (jqkv[..., i * h * d:(i + 1) * h * d].reshape(b, n, h, d) for i in range(3))
    tq, tk, tv = (tqkv[..., i * h * d:(i + 1) * h * d].view(b, n, h, d) for i in range(3))
    assert tv.stride(1) == 3 * h * d + pad
    jout = jfa.flash_attention_fused_rope(jq, jk, jv, jnp.asarray(cos), jnp.asarray(sin))
    tout = tfa.flash_attention_fused_rope(tq, tk, tv, torch.from_numpy(cos), torch.from_numpy(sin))
    assert tout.dtype == tqkv.dtype and tout.shape == (b, n, h, d) and tout.is_contiguous()
    _close(jout, tout, dt)


@pytest.mark.parametrize("n", [256, 65])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(dt, n):
    """d=16 as in the VMAE decoder; n=65 is ragged (the TPU kernel takes the
    whole sequence as one block, the CUDA kernel masks its last tile)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, (2, 3, n, 16), dt)
    jout = jfa._flash_forward(jq, jk, jv)
    tout = tfa.flash_attention(tq, tk, tv)
    _close(jout, tout, dt)


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_norm_modulate_matches_pallas(dt, kind):
    rng = np.random.default_rng(2)
    b, n, d = 2, 128, 256
    jx, tx = _pair(rng.standard_normal((b, n, d)) * 3.0 + 0.5, dt)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jsh, tsh = _pair(0.1 * rng.standard_normal((b, d)), dt)
    jsc, tsc = _pair(0.1 * rng.standard_normal((b, d)), dt)
    jout = jfad.fused_norm_modulate(jx, jnp.asarray(w), jsh, jsc, kind=kind)
    tout = tfad.fused_norm_modulate(tx, torch.from_numpy(w), tsh, tsc, kind=kind)
    assert tout.dtype == tx.dtype
    _close(jout, tout, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_matmul_silu_matches_pallas(dt):
    rng = np.random.default_rng(3)
    m, d, h2 = 256, 128, 256
    jx, tx = _pair(rng.standard_normal((2, m // 2, d)), dt)
    w12 = (rng.standard_normal((d, h2)) * d**-0.5).astype(np.float32)  # JAX (D, 2H)
    b12 = (0.1 * rng.standard_normal(h2)).astype(np.float32)
    jout = jfad.fused_matmul_silu(jx, jnp.asarray(w12), jnp.asarray(b12))
    tout = tfad.fused_matmul_silu(tx, torch.from_numpy(w12.T.copy()), torch.from_numpy(b12))
    assert tout.shape == (2, m // 2, h2 // 2) and tout.dtype == tx.dtype
    _close(jout, tout, dt)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["B/1", "B/2", "L/2", "XL/1", "1p0B/1", "1p6B/1"])
def test_fused_matmul_silu_registry_widths(model, dt):
    """At each registry model's SwiGLU widths (D, 2H) and M = 128, the port
    returns None exactly where the Pallas kernel's shape gate does (L: H =
    2730, 1p6B: H = 4778), and elsewhere (B, XL, 1p0B: the shapes the wgmma
    kernel takes on the card) matches the kernel in interpret mode."""
    spec = jdit.dit_spec(f"LightningDiT-{model}")
    d, h2 = spec.hidden_size, 2 * spec.swiglu_hidden
    tspec = tdit.dit_spec(f"LightningDiT-{model}")
    assert (tspec.hidden_size, tspec.swiglu_hidden) == (spec.hidden_size, spec.swiglu_hidden)
    rng = np.random.default_rng(8)
    jx, tx = _pair(rng.standard_normal((128, d)), dt)
    w12 = (rng.standard_normal((d, h2)) * d**-0.5).astype(np.float32)  # JAX (D, 2H)
    b12 = (0.1 * rng.standard_normal(h2)).astype(np.float32)
    jout = jfad.fused_matmul_silu(jx, jnp.asarray(w12), jnp.asarray(b12))
    tout = tfad.fused_matmul_silu(tx, torch.from_numpy(w12.T.copy()), torch.from_numpy(b12))
    assert (tout is None) == (jout is None) == (model in ("L/2", "1p6B/1"))
    if jout is not None:
        assert tout.shape == (128, h2 // 2) and tout.dtype == tx.dtype
        _close(jout, tout, dt)


@pytest.mark.parametrize("m,d,h2", [(200, 128, 256), (256, 96, 256), (256, 128, 320)])
def test_fused_matmul_silu_gate_falls_back(m, d, h2):
    """Outside the TPU kernel's tiling both return None, and swiglu_ffn runs
    the unfused path (x12 rounded to the compute dtype before the silu)."""
    rng = np.random.default_rng(4)
    jx, tx = _pair(rng.standard_normal((m, d)), "bfloat16")
    w12 = (rng.standard_normal((d, h2)) * d**-0.5).astype(np.float32)
    b12 = (0.1 * rng.standard_normal(h2)).astype(np.float32)
    w3 = (rng.standard_normal((h2 // 2, d)) * 0.05).astype(np.float32)
    b3 = np.zeros(d, np.float32)
    assert jfad.fused_matmul_silu(jx, jnp.asarray(w12), jnp.asarray(b12)) is None
    assert tfad.fused_matmul_silu(tx, torch.from_numpy(w12.T.copy()), torch.from_numpy(b12)) is None
    jp = {"w12": {"w": jnp.asarray(w12), "b": jnp.asarray(b12)},
          "w3": {"w": jnp.asarray(w3), "b": jnp.asarray(b3)}}
    jout = jlin.swiglu_ffn(jx, jp, impl="fused")
    tout = tlin.swiglu_ffn(
        tx, SimpleNamespace(weight=torch.from_numpy(w12.T.copy()), bias=torch.from_numpy(b12)),
        SimpleNamespace(weight=torch.from_numpy(w3.T.copy()), bias=torch.from_numpy(b3)), impl="fused",
    )
    _close(jout, tout, "bfloat16")

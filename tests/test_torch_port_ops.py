"""Port ops leaves vs ``ldmae_tpu.ops``: norms, linear, rope, patchify,
sincos and the attention module, on the CPU.

Inputs are numpy arrays from a fixed seed handed to both packages.
Tolerances: framework-free numpy tables must be identical; float32 math
agrees to summation order (1e-5 on O(1) values, 1e-6 where no reduction
is involved); bf16 results may differ by a rounding (2^-7 relative and
absolute, one bf16 ulp near 1).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ldmae_tpu.ops import attention as jatt
from ldmae_tpu.ops import linear as jlin
from ldmae_tpu.ops import norms as jnorms
from ldmae_tpu.ops.patchify import patchify as jpatchify
from ldmae_tpu.ops import rope as jrope
from ldmae_tpu.ops import sincos as jsincos

from ldmae_tpu_torch.ops import attention as tatt
from ldmae_tpu_torch.ops import linear as tlin
from ldmae_tpu_torch.ops import norms as tnorms
from ldmae_tpu_torch.ops.patchify import patch_embed, patchify, unpatchify
from ldmae_tpu_torch.ops import rope as trope
from ldmae_tpu_torch.ops import sincos as tsincos

TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2**-7, atol=2**-7)}
DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dt="float32"):
    jd, td = DT[dt]
    j = jnp.asarray(np.asarray(a, np.float32)).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize(
    "fn,args",
    [
        ("get_2d_sincos_pos_embed", (64, 8)),
        ("get_2d_sincos_pos_embed", (192, 32)),
        ("timestep_embedding_freqs", (256,)),
    ],
)
def test_sincos_tables_identical(fn, args):
    np.testing.assert_array_equal(getattr(tsincos, fn)(*args), getattr(jsincos, fn)(*args))


@pytest.mark.parametrize("hd,grid", [(64, 32), (16, 8)])
def test_rope_tables_and_permutation_identical(hd, grid):
    for a, b in zip(trope.build_rope_table(hd // 2, grid), jrope.build_rope_table(hd // 2, grid)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(trope.to_half_layout(a), jrope.to_half_layout(b))
    np.testing.assert_array_equal(trope.rope_channel_permutation(hd), jrope.rope_channel_permutation(hd))


@pytest.mark.parametrize("layout", ["interleaved", "half"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_apply_rope(layout, dt):
    rng = np.random.default_rng(0)
    cos, sin = jrope.build_rope_table(16, 4)  # hd 32, N 16
    if layout == "half":
        cos, sin = jrope.to_half_layout(cos), jrope.to_half_layout(sin)
    jx, tx = _pair(rng.standard_normal((2, 3, 16, 32)), dt)
    jfn, tfn = (jrope.apply_rope_half, trope.apply_rope_half) if layout == "half" else (
        jrope.apply_rope, trope.apply_rope)
    out = tfn(tx, torch.from_numpy(cos), torch.from_numpy(sin))
    np.testing.assert_allclose(_np(out), _np(jfn(jx, jnp.asarray(cos), jnp.asarray(sin))), **TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_norms(dt):
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng.standard_normal((2, 5, 48)) * 2 + 0.3, dt)
    w = (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)
    b = (0.1 * rng.standard_normal(48)).astype(np.float32)
    out = tnorms.rms_norm(tx, torch.from_numpy(w))
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(jnorms.rms_norm(jx, jnp.asarray(w))), **TOL[dt])
    out = tnorms.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(
        _np(out), _np(jnorms.layer_norm(jx, jnp.asarray(w), jnp.asarray(b))), **TOL[dt])
    np.testing.assert_allclose(_np(tnorms.layer_norm(tx)), _np(jnorms.layer_norm(jx)), **TOL[dt])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_linear_family(dt):
    rng = np.random.default_rng(2)
    jx, tx = _pair(rng.standard_normal((2, 8, 32)), dt)
    w1, b1 = rng.standard_normal((32, 64)) * 0.2, rng.standard_normal(64) * 0.1
    w2, b2 = rng.standard_normal((64, 32)) * 0.2, rng.standard_normal(32) * 0.1
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in dict(w1=w1, b1=b1, w2=w2, b2=b2).items()}
    tp = {k: torch.from_numpy(np.ascontiguousarray(v.T if k[0] == "w" else v, np.float32))
          for k, v in dict(w1=w1, b1=b1, w2=w2, b2=b2).items()}
    np.testing.assert_allclose(
        _np(tlin.dense(tx, tp["w1"], tp["b1"])),
        _np(jlin.dense(jx, {"w": jp["w1"], "b": jp["b1"]})), **TOL[dt])
    fc1, fc2 = _Lin(tp["w1"], tp["b1"]), _Lin(tp["w2"], tp["b2"])
    for approx in (False, True):
        out = tlin.mlp_gelu(tx, fc1, fc2, approximate=approx)
        ref = jlin.mlp_gelu(jx, {"fc1": {"w": jp["w1"], "b": jp["b1"]},
                                 "fc2": {"w": jp["w2"], "b": jp["b2"]}}, approximate=approx)
        np.testing.assert_allclose(_np(out), _np(ref), **TOL[dt])
    # SwiGLU with the merged (2H, D) w12: H = 32
    out = tlin.swiglu_ffn(tx, fc1, _Lin(tp["w2"][:, :32].contiguous(), tp["b2"]))
    ref = jlin.swiglu_ffn(jx, {"w12": {"w": jp["w1"], "b": jp["b1"]},
                               "w3": {"w": jp["w2"][:32], "b": jp["b2"]}})
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dt])
    jsh, tsh = _pair(rng.standard_normal((2, 32)) * 0.1, dt)
    jsc, tsc = _pair(rng.standard_normal((2, 32)) * 0.1, dt)
    np.testing.assert_allclose(_np(tlin.modulate(tx, tsh, tsc)), _np(jlin.modulate(jx, jsh, jsc)), **TOL[dt])
    np.testing.assert_allclose(_np(tlin.modulate(tx, None, tsc)), _np(jlin.modulate(jx, None, jsc)), **TOL[dt])


def test_patchify_roundtrip_and_layout():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    t = patchify(torch.from_numpy(img), 4)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jpatchify(jnp.asarray(img), 4)))
    np.testing.assert_array_equal(unpatchify(t, 4, 3).numpy(), img)
    conv_w = rng.standard_normal((8, 3, 4, 4)).astype(np.float32)
    conv_b = rng.standard_normal(8).astype(np.float32)
    ref = torch.nn.functional.conv2d(torch.from_numpy(img), torch.from_numpy(conv_w), torch.from_numpy(conv_b), stride=4)
    out = patch_embed(torch.from_numpy(img), torch.from_numpy(conv_w), torch.from_numpy(conv_b), 4)
    np.testing.assert_allclose(out.numpy(), ref.flatten(2).transpose(1, 2).numpy(), rtol=1e-5, atol=1e-5)


class _Lin:
    def __init__(self, w, b):
        self.weight, self.bias = w, b


class _Attn:
    pass


@pytest.mark.parametrize(
    "impl,layout,qk", [("xla", "interleaved", "rms"), ("flash", "interleaved", "layer"),
                       ("flash_rope", "half", "rms"), ("flash_rope", None, None),
                       ("flash_qkr", "half", "rms"), ("flash_qkr", "half", "layer"),
                       ("flash_fused", "half", "rms"), ("flash_fused", "half", None),
                       ("flash_fused", None, None)],
)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_multi_head_attention(impl, layout, qk, dt):
    """Packed qkv, per-head qk-norm outside the kernel (inside it for
    flash_qkr with RMS norms; a LayerNorm with bias takes flash_rope's
    fallback), RoPE, the (B, N, H*hd) layout of flash_fused (v a strided
    view of qkv; without qk-norm q and k too), and the routing of a flash
    impl without RoPE to the plain flash kernel."""
    rng = np.random.default_rng(4)
    d, heads, grid = 64, 4, 4
    hd = d // heads
    jx, tx = _pair(rng.standard_normal((2, grid * grid, d)), dt)
    wqkv = rng.standard_normal((d, 3, d)).astype(np.float32) * d**-0.5
    bqkv = rng.standard_normal((3, d)).astype(np.float32) * 0.1
    wp = rng.standard_normal((d, d)).astype(np.float32) * d**-0.5
    bp = rng.standard_normal(d).astype(np.float32) * 0.1
    jp = {"qkv": {"w": jnp.asarray(wqkv), "b": jnp.asarray(bqkv)},
          "proj": {"w": jnp.asarray(wp), "b": jnp.asarray(bp)}}
    tp = _Attn()
    tp.qkv = _Lin(torch.from_numpy(wqkv.reshape(d, 3 * d).T.copy()), torch.from_numpy(bqkv.reshape(-1)))
    tp.proj = _Lin(torch.from_numpy(wp.T.copy()), torch.from_numpy(bp))
    tp.q_norm = tp.k_norm = None
    if qk is not None:
        s = (1 + 0.1 * rng.standard_normal(hd)).astype(np.float32)
        bias = (0.1 * rng.standard_normal(hd)).astype(np.float32) if qk == "layer" else None
        jn = {"scale": jnp.asarray(s)} | ({"bias": jnp.asarray(bias)} if bias is not None else {})
        jp["q_norm"] = jp["k_norm"] = jn
        tp.q_norm = tp.k_norm = _Lin(torch.from_numpy(s), None if bias is None else torch.from_numpy(bias))
    rope = None
    if layout is not None:
        cos, sin = jrope.build_rope_table(hd // 2, grid)
        if layout == "half":
            cos, sin = jrope.to_half_layout(cos), jrope.to_half_layout(sin)
        rope = (cos, sin)
    kw = dict(rope_layout=layout or "interleaved", qk_norm_kind=qk or "rms", impl=impl)
    ref = jatt.multi_head_attention(
        jx, jp, heads, rope=None if rope is None else tuple(map(jnp.asarray, rope)), **kw)
    out = tatt.multi_head_attention(
        tx, tp, heads, rope=None if rope is None else tuple(map(torch.from_numpy, rope)), **kw)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(ref), **TOL[dt])

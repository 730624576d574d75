"""The port's w8a8 / w8 sampling leg vs ``ldmae_tpu`` on the CPU: int8 weight
quantization through the weight bridge, ``qdense`` / ``qdense_pre``, the two
quantizing kernels' plain versions against the Pallas kernels (interpret
mode), and the quantized DiT forward.

Inputs are numpy arrays from a fixed seed handed to both packages.
Tolerances:
* int8 weights, their scales and the per-row activation quantization are
  elementwise fp32 math in the same op order on both sides: bit-identical.
* ``qdense`` / ``qdense_pre``: an exact int32 product, then the same fp32
  dequant (acc * row scale) * column scale + bias and one rounding:
  identical too.
* The quantizing kernels reduce each row in another fp32 order (and with
  another rsqrt / exp), so a value on a rounding boundary may step by one:
  |dq| <= 1 everywhere, at most 1e-3 of the elements differ, row scales
  within rtol 1e-6.
* The quantized DiT: those one-step flips feed the int8 matmuls, each worth
  1/127 of its row's absmax, so max|port - jax| / max|jax| is held to 1e-2
  in fp32 and 3e-2 in bf16 (the bf16 bound of the unquantized forward, 2e-2,
  plus the flips); measured well below.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ldmae_tpu.models import lightningdit as jdit
from ldmae_tpu.ops import fused_adaln as jfad
from ldmae_tpu.ops import quant as jquant

from torch_port_helpers import randomize, to_numpy

from ldmae_tpu_torch.convert import dit_state_dict_from_jax
from ldmae_tpu_torch.models import LightningDiT, permute_qk_for_half_rope, quantize_dit_
from ldmae_tpu_torch.models import lightningdit as tdit
from ldmae_tpu_torch.ops import fused_adaln as tfad
from ldmae_tpu_torch.ops import quant as tquant

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SMALL_DIT = dict(input_size=16, in_channels=16, num_classes=10, depth=2, hidden_size=384,
                 num_heads=6, use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True)


def _pair(a, dt="float32"):
    jd, td = DT[dt]
    j = jnp.asarray(np.asarray(a, np.float32)).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _linear(rng, k, n, bias=True):
    """A JAX linear {"w": (in, out), "b"} and the nn.Linear with its weights."""
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.01).astype(np.float32) if bias else None
    lin = torch.nn.Linear(k, n, bias=bias).requires_grad_(False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        if bias:
            lin.bias.copy_(torch.from_numpy(b))
    jp = {"w": jnp.asarray(w)} | ({"b": jnp.asarray(b)} if bias else {})
    return jp, lin


def _dits(seed=0):
    js, ts = jdit.dit_spec("LightningDiT-B/1", **SMALL_DIT), tdit.dit_spec("LightningDiT-B/1", **SMALL_DIT)
    params = randomize(jdit.init_dit_params(jax.random.key(0), js), seed)
    model = LightningDiT(ts, device="cpu")
    model.load_state_dict(permute_qk_for_half_rope(dit_state_dict_from_jax(to_numpy(params), ts), ts))
    jp = jdit.merge_swiglu(jdit.permute_qk_for_half_rope(params, js), js)
    return js, ts, params, jp, model


@pytest.mark.parametrize("merged", [True, False], ids=["merged_w12", "split_w1_w2"])
def test_quantize_linear_bit_identical_through_the_bridge(merged):
    """quantize_dit_ on the port's model and quantize_dit_params on the JAX
    tree give the same int8 weights, scales and biases, key for key; the
    JAX-quantized tree loads into a quantized port model strictly."""
    js, ts, params, jp, model = _dits(seed=1)
    if not merged:
        jp = jdit.permute_qk_for_half_rope(params, js)
    jq = jdit.quantize_dit_params(jp, js)
    theirs = dit_state_dict_from_jax(to_numpy(jq), ts)
    ours = quantize_dit_(model).state_dict()
    assert set(ours) == set(theirs)
    qkeys = [k for k in ours if k.endswith((".w_q", ".w_scale"))]
    assert len(qkeys) == 2 * 4 * ts.depth  # qkv, w12, w3, adaLN per block
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        torch.testing.assert_close(ours[k], theirs[k], rtol=0, atol=0)
    assert ours["blocks.0.attn.qkv.w_q"].dtype == torch.int8
    assert "blocks.0.attn.proj.weight" in ours  # the out-projection stays fp32
    fresh = quantize_dit_(LightningDiT(ts, device="cpu"))
    fresh.load_state_dict(theirs, strict=True)


@pytest.mark.parametrize("m", [5, 40])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_qdense_matches_jax(dt, m):
    """w8, w8a8 and qdense_pre; m = 5 goes through the zero-row pad of the
    int8 product (torch._int_mm takes more than 16 rows on CUDA)."""
    rng = np.random.default_rng(0)
    jp, lin = _linear(rng, 64, 48)
    jq, tq = jquant.quantize_linear(jp), tquant.quantize_linear(lin)
    np.testing.assert_array_equal(tq.w_q.numpy().T, np.asarray(jq["w_q"]))
    np.testing.assert_array_equal(tq.w_scale.numpy(), np.asarray(jq["w_scale"]))
    jx, tx = _pair(rng.standard_normal((m, 64)) * 2.0, dt)
    for mode in ("w8", "w8a8"):
        out = tquant.qdense(tx, tq, mode=mode)
        assert out.dtype == tx.dtype and out.shape == (m, 48)
        ref = _np(jquant.qdense(jx, jq, mode=mode))
        if mode == "w8" and dt == "float32":
            # an fp32 product of 64 terms: the two BLAS libraries may sum in
            # another order (which depends on the host's vector width), so
            # each element is allowed one fp32 ulp of the magnitude it is
            # summed at, sum |x_i w_i| + |b| (an ulp of a result that cancels
            # would be far smaller than the rounding of its terms)
            w = tq.w_q.double() * tq.w_scale.double()[:, None]
            mag = tx.double().abs() @ w.abs().t() + tq.bias.double().abs()
            ulp = np.spacing(mag.numpy().astype(np.float32))
            assert np.all(np.abs(_np(out).astype(np.float64) - ref) <= ulp)
        else:
            np.testing.assert_array_equal(_np(out), ref)
    jxq, jxs = jquant._quantize_rows(jx)
    txq, txs = tquant._quantize_rows(tx)
    np.testing.assert_array_equal(txq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(txs.numpy(), np.asarray(jxs))
    jd, td = DT[dt]
    np.testing.assert_array_equal(
        _np(tquant.qdense_pre(txq, txs, tq, compute_dtype=td)),
        _np(jquant.qdense_pre(jxq, jxs, jq, compute_dtype=jd)))
    with pytest.raises(ValueError):
        tquant.qdense(tx, tq, mode="w4")


def test_swiglu_ffn_quant_and_maybe_qdense_match_jax():
    rng = np.random.default_rng(1)
    j12, t12 = _linear(rng, 64, 96)
    j3, t3 = _linear(rng, 48, 64)
    jp = {"w12": jquant.quantize_linear(j12), "w3": jquant.quantize_linear(j3)}
    mlp = torch.nn.Module()
    mlp.w12, mlp.w3 = tquant.quantize_linear(t12), tquant.quantize_linear(t3)
    jx, tx = _pair(rng.standard_normal((2, 24, 64)), "bfloat16")
    jxq, jxs = jquant._quantize_rows(jx)
    txq, txs = tquant._quantize_rows(tx)
    out = tquant.swiglu_ffn_quant(txq, txs, mlp)
    ref = jquant.swiglu_ffn_quant(jxq, jxs, jp)
    # the gate's int8 step can flip on a boundary (see the module docstring)
    assert np.abs(_np(out) - _np(ref)).max() <= 1e-2 * np.abs(_np(ref)).max()
    # maybe_qdense takes either layout
    np.testing.assert_array_equal(
        _np(tquant.maybe_qdense(tx, mlp.w12, None)), _np(jquant.maybe_qdense(jx, jp["w12"], None)))
    np.testing.assert_array_equal(
        _np(tquant.maybe_qdense(tx, t12, None)), _np(jquant.maybe_qdense(jx, j12, None)))


def _assert_quant_close(tq, ts, jq, js):
    """|dq| <= 1, at most 1e-3 of the elements differ, scales rtol 1e-6."""
    tq, jq = tq.numpy().astype(np.int32), np.asarray(jq).astype(np.int32)
    assert tq.shape == jq.shape
    dq = np.abs(tq - jq)
    assert dq.max() <= 1
    assert (dq != 0).mean() <= 1e-3
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_norm_modulate_quant_matches_pallas(dt, kind):
    rng = np.random.default_rng(2)
    b, n, d = 2, 256, 384
    jx, tx = _pair(rng.standard_normal((b, n, d)) * 3.0 + 0.5, dt)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jsh, tsh = _pair(0.3 * rng.standard_normal((b, d)), dt)
    jsc, tsc = _pair(0.3 * rng.standard_normal((b, d)), dt)
    jq, js = jfad.fused_norm_modulate_quant(jx, jnp.asarray(w), jsh, jsc, kind=kind)
    tq, ts = tfad.fused_norm_modulate_quant(tx, torch.from_numpy(w), tsh, tsc, kind=kind)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (b, n, 1)
    _assert_quant_close(tq, ts, jq, js)
    # no weight: the JAX kernel multiplies by ones
    jq, js = jfad.fused_norm_modulate_quant(jx, None, jsh, jsc, kind=kind)
    tq, ts = tfad.fused_norm_modulate_quant_plain(tx, None, tsh, tsc, kind=kind)
    _assert_quant_close(tq, ts, jq, js)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_fused_silu_mul_quant_matches_pallas(dt):
    rng = np.random.default_rng(3)
    b, n, h = 2, 256, 512
    jx, tx = _pair(rng.standard_normal((b, n, 2 * h)) * 2.0, dt)
    jq, js = jfad.fused_silu_mul_quant(jx)
    tq, ts = tfad.fused_silu_mul_quant(tx)
    assert tq.shape == (b, n, h) and ts.shape == (b, n, 1)
    _assert_quant_close(tq, ts, jq, js)


def rel_err(port, ref):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize(
    "mode,impls", [("w8a8", ("flash_rope", "fused", "fused")), ("w8a8", ("xla", "xla", "xla")),
                   ("w8", ("flash_rope", "fused", "fused"))],
    ids=["w8a8-fused", "w8a8-xla", "w8-fused"],
)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_quantized_dit_forward_matches_jax(dt, mode, impls):
    """adaln_impl='fused' under w8a8 takes the fused-quant branch of _block
    (the quantizing adaLN kernel feeds qkv and w12); 'xla' the qdense path;
    w8 dequantizes the weights before float matmuls."""
    attn, adaln, mlp = impls
    js, ts, _, jp, model = _dits(seed=4)
    quantize_dit_(model)
    jq = jdit.quantize_dit_params(jp, js)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    t = np.array([0.3, 0.71], np.float32)
    y = np.array([3, 10])
    jd, td = DT[dt]
    kw = dict(attn_impl=attn, rope_layout="half", adaln_impl=adaln, mlp_impl=mlp, quant_mode=mode)
    ref = jdit.dit_forward(jq, js, jdit.DiTConsts(js), jnp.asarray(x), jnp.asarray(t).astype(jd),
                           jnp.asarray(y), compute_dtype=jd, **kw)
    with torch.no_grad():  # sampling callers turn grad off themselves
        out = model(torch.from_numpy(x), torch.from_numpy(t).to(td), torch.from_numpy(y),
                    compute_dtype=td, **kw)
    assert out.dtype == torch.float32 and out.shape == (2, 16, 16, 16)
    assert np.abs(np.asarray(ref)).max() > 1e-3
    assert rel_err(out.numpy(), ref) < {"float32": 1e-2, "bfloat16": 3e-2}[dt]

"""The w8a8 linear layer's GEMM (``int8_dense``) on the CPU: the arithmetic of
its epilogue, the operands its wrapper hands the kernel, and the port's
``qdense`` / ``qdense_pre`` against ``ldmae_tpu.ops.quant``.

The CUDA kernel (``csrc/dense.cu``) computes out = bf16(((f32(acc) *
x_scale[m]) * w_scale[n]) + bias[n]) from the exact int32 sum, each fp32
operation rounded on its own (``__fmul_rn`` / ``__fadd_rn``, so no FMA),
and claims bit equality with the plain version (``torch._int_mm``, then
``_dequant``'s fp32 passes). A numpy model of that epilogue, every step
rounded to fp32 and the end to bf16 half-to-even, is held bitwise against
``_dequant`` on int32 sums past 2^24 (where int -> fp32 rounds), with a
bias, a zero bias and none; an FMA-contracted model, which rounds once
where the kernel rounds twice, must differ from it. The kernel itself is
held against the plain version on the card (``test_torch_port_gpu.py``).

Port against JAX: an exact int32 product and the same fp32 dequant in the
same op order on both sides, so bitwise in bf16 and fp32.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ldmae_tpu.ops import quant as jquant

from ldmae_tpu_torch.ops import quant as tquant

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_rne(f32: np.ndarray) -> np.ndarray:
    """fp32 -> bf16 bits (uint16), round to nearest, ties to even (finite
    values)."""
    u = f32.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _epilogue_model(acc, xs, ws, bias, fma=False):
    """The kernel's epilogue in numpy fp32: cvt.rn.f32.s32, two rounded
    products, a rounded add. fma=True contracts the second product and the
    add into one rounding (what nvcc does to a*b+c by default)."""
    v = acc.astype(np.float32) * xs.astype(np.float32)
    if fma and bias is not None:
        exact = v.astype(np.float64) * ws.astype(np.float64) + bias.astype(np.float64)
        return exact.astype(np.float32)
    v = v * ws.astype(np.float32)
    return v if bias is None else v + bias.astype(np.float32)


def _sums(m, n, seed):
    """int32 sums as an int8 product of depth up to 2,048 gives them (|acc|
    <= 127^2 * 2048 ~ 2^25), a quarter beyond 2^24, and zeros."""
    rng = np.random.default_rng(seed)
    acc = rng.integers(-(2**24), 2**24, size=(m, n), dtype=np.int64)
    big = rng.integers(2**24, 127 * 127 * 2048, size=(m, n), dtype=np.int64) * rng.choice([-1, 1], size=(m, n))
    acc = np.where(rng.random((m, n)) < 0.25, big, acc)
    acc[0, :4] = 0
    return acc.astype(np.int32)


def _scales(m, n, seed, bias):
    rng = np.random.default_rng(seed)
    xs = (rng.random((m, 1)) * 1e-2 + 1e-5).astype(np.float32)
    ws = (rng.random(n) * 1e-3 + 1e-6).astype(np.float32)
    b = {"none": None, "zero": np.zeros(n, np.float32),
         "random": rng.standard_normal(n).astype(np.float32)}[bias]
    return xs, ws, b


def _qlinear(w_q: np.ndarray, ws: np.ndarray, b) -> tquant.QLinear:
    return tquant.QLinear(torch.from_numpy(w_q), torch.from_numpy(ws), None if b is None else torch.from_numpy(b))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bias", ["random", "zero", "none"])
def test_epilogue_model_equals_dequant_bitwise(bias, dtype):
    """The numpy model of the kernel's epilogue equals ``_dequant`` bit for
    bit, int32 sums past 2^24 included."""
    m, n = 64, 96
    acc = _sums(m, n, 0)
    assert (np.abs(acc) > 2**24).mean() > 0.2
    xs, ws, b = _scales(m, n, 1, bias)
    p = _qlinear(np.zeros((n, 8), np.int8), ws, b)
    out = tquant._dequant(torch.from_numpy(acc), torch.from_numpy(xs), p, DT[dtype][1])
    model = _epilogue_model(acc, xs, ws, b)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(out.view(torch.int16).numpy().view(np.uint16), _bf16_rne(model))
    else:
        np.testing.assert_array_equal(out.numpy().view(np.uint32), model.view(np.uint32))


def test_fma_contracted_epilogue_differs():
    """The control: one rounding for (v * w_scale) + bias, as an FMA gives
    it, differs from the plain version's two on some elements, so the
    bitwise comparison above (and the kernel's on the card) can tell them
    apart."""
    m, n = 64, 96
    acc = _sums(m, n, 2)
    xs, ws, b = _scales(m, n, 3, "random")
    fused = _epilogue_model(acc, xs, ws, b, fma=True)
    twice = _epilogue_model(acc, xs, ws, b)
    assert (fused.view(np.uint32) != twice.view(np.uint32)).sum() > 0
    p = _qlinear(np.zeros((n, 8), np.int8), ws, b)
    plain = tquant._dequant(torch.from_numpy(acc), torch.from_numpy(xs), p, torch.float32).numpy()
    assert (plain.view(np.uint32) != fused.view(np.uint32)).any()


@pytest.mark.parametrize("k", [16, 40, 48, 100])
def test_int8_args_pad_k_to_16(k):
    """The wrapper's operands: K zero-padded to a multiple of 16 (exact: the
    padded int32 product equals the unpadded one), one row scale a row, the
    bias fp32; an aligned contiguous K of 16s is passed as it is."""
    rng = np.random.default_rng(k)
    x_q = torch.from_numpy(rng.integers(-127, 128, (2, 5, k), dtype=np.int8))
    w_q = rng.integers(-127, 128, (24, k), dtype=np.int8)
    xs = torch.rand(2, 5, 1)
    p = _qlinear(w_q, np.ones(24, np.float32), np.zeros(24, np.float32))
    a, w, xs_flat, ws, bias = tquant._int8_args(x_q, xs, p, torch.bfloat16)
    kp = -(-k // 16) * 16
    assert a.shape == (10, kp) and w.shape == (24, kp) and a.is_contiguous() and w.is_contiguous()
    assert not a[:, k:].any() and not w[:, k:].any()
    assert xs_flat.numel() == 10 and xs_flat.is_contiguous()
    assert ws.dtype == bias.dtype == torch.float32
    np.testing.assert_array_equal(tquant._int_mm(a, w).numpy(), tquant._int_mm(x_q.reshape(10, k), p.w_q).numpy())
    if kp == k:
        assert w.data_ptr() == p.w_q.data_ptr()
    # a bf16 bias and a non-contiguous x_q are made fp32 and contiguous
    p16 = _qlinear(w_q, np.ones(24, np.float32), None)
    p16.bias = torch.ones(24, dtype=torch.bfloat16)
    a2, _, _, _, b2 = tquant._int8_args(x_q.transpose(0, 1), xs.transpose(0, 1), p16, torch.float32)
    assert a2.is_contiguous() and b2.dtype == torch.float32
    np.testing.assert_array_equal(a2[:, :k].numpy(), x_q.transpose(0, 1).reshape(10, k).numpy())


def test_int8_args_reject_what_the_kernel_does_not_take():
    """Output dtypes other than bf16 and fp32, non-int8 operands, a weight
    of another depth and row scales that do not match x_q raise."""
    x_q = torch.zeros(4, 32, dtype=torch.int8)
    xs = torch.ones(4, 1)
    p = _qlinear(np.zeros((8, 32), np.int8), np.ones(8, np.float32), None)
    assert tquant._int8_args(x_q, xs, p, torch.float32)[4] is None
    for args in ((x_q, xs, p, torch.float16), (x_q.float(), xs, p, torch.bfloat16),
                 (x_q[:, :16], xs, p, torch.bfloat16), (x_q, xs[:2], p, torch.bfloat16),
                 (x_q, xs.double(), p, torch.bfloat16)):
        with pytest.raises(ValueError):
            tquant._int8_args(*args)


def _linear_pair(k, n, seed):
    """A JAX linear {"w": (in, out), "b"} and the same nn.Linear."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(n) * 0.01).astype(np.float32)
    lin = torch.nn.Linear(k, n).requires_grad_(False)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T.copy()))
        lin.bias.copy_(torch.from_numpy(b))
    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, lin


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
@pytest.mark.parametrize("k", [48, 40])
@pytest.mark.parametrize("m", [5, 16, 17, 64])
def test_qdense_and_qdense_pre_match_jax_bitwise(m, k, dt):
    """qdense (w8a8) and qdense_pre through ``int8_dense`` (its plain version
    on the CPU) against the JAX package's, bit for bit; K = 40 is a depth the
    kernel's wrapper pads."""
    jd, td = DT[dt]
    jp, lin = _linear_pair(k, 72, m * 100 + k)
    jq, tq = jquant.quantize_linear(jp), tquant.quantize_linear(lin)
    x = np.random.default_rng(m + k).standard_normal((m, k)).astype(np.float32) * 2.0
    jx = jnp.asarray(x).astype(jd)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(td)
    out = tquant.qdense(tx, tq, mode="w8a8")
    ref = jquant.qdense(jx, jq, mode="w8a8")
    assert out.dtype == td and out.shape == (m, 72)
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    jxq, jxs = jquant._quantize_rows(jx)
    txq, txs = tquant._quantize_rows(tx)
    pre = tquant.qdense_pre(txq, txs, tq, compute_dtype=td)
    np.testing.assert_array_equal(pre.float().numpy(),
                                  np.asarray(jquant.qdense_pre(jxq, jxs, jq, compute_dtype=jd).astype(jnp.float32)))

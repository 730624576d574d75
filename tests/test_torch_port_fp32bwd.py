"""The fp32 flash-attention backward on the tensor cores (``csrc/
flash_attention_fp32.cu``'s ``tf32x3_bwd_dkdv_kernel`` and
``tf32x3_bwd_dq_kernel``, d = 64 and 72) against ``ldmae_tpu`` on the CPU.

* A plain emulation of the kernels' decomposition, kept here and not in
  the package: every fp32 operand x split into x = hi + lo + e, hi the
  TF32 rounding of x (round to nearest, ties away from zero, at bit 13:
  ``cvt.rna.tf32.f32``) and lo that of x - hi, done by bit operations on
  the int32 view; each product a b accumulated in fp32 as a_lo b_hi +
  a_hi b_lo + a_hi b_hi, a streamed 64-row tile at a time (dK and dV over
  query tiles, dQ over key tiles); p from the forward's lse, delta =
  rowsum(g o), p and ds split like any operand; for RoPE q and k rotated
  in fp32 and the transposed Jacobian on dq and dk. It is held against
  ``jax.vjp`` of ``flash_attention`` and ``flash_attention_rope_trainable``
  in fp32 (their Pallas backward kernels in interpret mode) at a ragged N
  and d = 64 and 72: relative L2 error within F32X3_REL (1e-5) per
  gradient, the left-out lo lo terms (below 2^-22 of each product) and
  fp32 sums in another order. A one-product TF32 emulation (hi hi alone)
  reads at least ten times that bound.
* The split itself: hi keeps no bit below bit 13, hi is x rounded to 11
  significant bits with ties away from zero (checked against a frexp
  rounding in fp64), and |x - (hi + lo)| <= 2^-22 |x|.
* The dispatch: on fp32 device operands at d = 64 and 72 the wrappers reach
  the C entries with what the tensor-core kernels take (16-byte aligned
  rows, the forward's output and lse, no dq scratch), and bf16 keeps its
  single pass with its dq scratch.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ldmae_tpu.ops import flash_attention as jfa

from ldmae_tpu_torch import kernels
from ldmae_tpu_torch.ops import flash_attention as tfa
from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

TILE = 64  # rows of a streamed tile
F32X3_REL = 1e-5


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 x as ``cvt.rna.tf32.f32`` makes them: + 2^12 on the
    magnitude bits and the 13 low bits cleared rounds to nearest with ties
    away from zero (the sign bit is apart from the magnitude)."""

    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as 3xTF32: the small terms first, fp32 sums."""
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
    return al @ bh + ah @ bl + ah @ bh


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product (the control)."""
    return tf32_split(a)[0] @ tf32_split(b)[0]


def tc_emulation(q, k, v, g, cos=None, sin=None, mm=mm3):
    """(dq, dk, dv) as the tensor-core kernels compute them (see the module
    note), on fp32 (B, H, N, d) tensors."""
    if cos is not None:  # the RoPE pre-pass, in fp32
        q, k = (tfa._rope_fp32(t, cos, sin) for t in (q, k))
    n, d = q.shape[-2:]
    scale = d**-0.5
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    lse = tfa.flash_attention_lse_plain(q, k)  # the forward's, log2 units
    delta = (g * tfa.flash_attention_plain(q, k, v)).sum(-1)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for t0 in range(0, n, TILE):
        rows = slice(t0, t0 + TILE)
        # the dK/dV kernel: every key against the query tile
        qt, gt = q[..., rows, :], g[..., rows, :]
        pt = torch.exp2(mm(k, qt.transpose(-1, -2)) * scale_log2 - lse[..., None, rows])
        dst = pt * (mm(v, gt.transpose(-1, -2)) - delta[..., None, rows])
        dv += mm(pt, gt)
        dk += mm(dst, qt)
        # the dQ kernel: every query against the key tile
        kt, vt = k[..., rows, :], v[..., rows, :]
        p = torch.exp2(mm(q, kt.transpose(-1, -2)) * scale_log2 - lse[..., :, None])
        dq += mm(p * (mm(g, vt.transpose(-1, -2)) - delta[..., :, None]), kt)
    dq, dk = dq * scale, dk * scale
    if cos is not None:
        dq, dk = tfa._rope_transpose(dq, cos, sin), tfa._rope_transpose(dk, cos, sin)
    return dq, dk, dv


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _tables(n, d):
    grid = int(math.isqrt(n - 1)) + 1
    return tuple(to_half_layout(t)[:n] for t in build_rope_table(d // 2, grid))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("rope", [False, True], ids=["flash_attention", "flash_attention_rope"])
@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (1, 2, 136, 72)], ids=["d64", "d72"])
def test_tf32x3_emulation_matches_pallas_vjp(shape, rope):
    """Within F32X3_REL of the JAX backward in fp32; one TF32 product reads
    ten times that bound or more on every gradient."""
    q, k, v, g = _inputs(shape, 3)
    cos, sin = _tables(shape[2], shape[3])
    if rope:
        _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_rope_trainable(q, k, v, cos, sin), q, k, v)
        tables = (torch.from_numpy(cos), torch.from_numpy(sin))
    else:
        _, vjp = jax.vjp(jfa.flash_attention, q, k, v)
        tables = ()
    refs = vjp(jnp.asarray(g))
    args = [torch.from_numpy(a) for a in (q, k, v, g)]
    for name, o, r in zip(("dq", "dk", "dv"), tc_emulation(*args, *tables), refs):
        assert _rel_l2(o.numpy(), r) <= F32X3_REL, name
    for name, o, r in zip(("dq", "dk", "dv"), tc_emulation(*args, *tables, mm=mm1), refs):
        assert _rel_l2(o.numpy(), r) >= 10 * F32X3_REL, name


def test_tf32_split_rounds_to_nearest_away_and_keeps_22_bits():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(200_000) * np.exp2(rng.integers(-60, 60, 200_000))).astype(np.float32)
    # values halfway between two TF32 numbers: the rounding goes away from zero
    ties = (np.uint32(127 << 23) | np.arange(1024, dtype=np.uint32) << 13 | 0x1000).view(np.float32)
    x = np.concatenate([x, ties, -ties, [0.0, 1.0, -1.0]]).astype(np.float32)
    hi, lo = (t.numpy() for t in tf32_split(torch.from_numpy(x)))
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    m, e = np.frexp(x.astype(np.float64))  # |m| in [0.5, 1): 11 significant bits are m * 2^11
    want = np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5) * np.exp2(e - 11.0)
    np.testing.assert_array_equal(hi.astype(np.float64), want)
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert (err <= 2.0**-22 * np.abs(x.astype(np.float64))).all()


class _Recorder:
    """Stands for an attention library: each C entry records its arguments
    and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.mark.parametrize("d", [64, 72])
@pytest.mark.parametrize("rope", [False, True], ids=["flash_attention_bwd", "flash_attention_rope_bwd"])
def test_fp32_backward_reaches_the_tensor_core_entry(d, rope, monkeypatch):
    """fp32 device operands at d = 64 and 72: the backward C entry with the
    output and lse, 16-byte rows (vec 4, the C dispatch's condition beside
    d), lse and delta scratch and no dq scratch, counted once, no plain
    version; bf16 at the same d: vec 8 and its dq scratch."""
    lib = _Recorder()
    monkeypatch.setattr(kernels, "load", lambda name: lib)
    monkeypatch.setattr(kernels, "on_device", lambda x, entry, *args: entry(*args, None))
    for plain in ("flash_attention_bwd_plain", "flash_attention_rope_bwd_plain"):
        monkeypatch.setattr(tfa, plain, lambda *a: pytest.fail("the plain version ran on a device tensor"))
    b, h, n = 2, 3, 200
    entry = "ldmae_flash_attention_rope_bwd" if rope else "ldmae_flash_attention_bwd"
    wrapper = tfa.flash_attention_rope_bwd if rope else tfa.flash_attention_bwd
    for dtype, vec, dq_scratch in ((torch.float32, 4, False), (torch.bfloat16, 8, True)):
        assert tfa._uses_lse(dtype, d, vec)
        q, k, v, g, out = (torch.empty(b, h, n, d, device="meta", dtype=dtype) for _ in range(5))
        lse = torch.empty(b, h, n, device="meta", dtype=torch.float32)
        tables = (torch.empty(n, d, device="meta"), torch.empty(n, d, device="meta")) if rope else ()
        lib.calls.clear()
        before = wrapper.launches
        dq, dk, dv = wrapper(q, k, v, g, *tables, out=out, lse=lse)
        assert wrapper.launches == before + 1
        assert all(t.shape == q.shape and t.dtype == dtype for t in (dq, dk, dv))
        ((name, args),) = lib.calls
        assert name == entry
        assert args[-5:-2] == (b * h, n, d) and args[-2] == vec  # the stream last
        grads_at = 10 if rope else 6  # the argument after the output's and lse's pointers (and the tables)
        assert args[4] is not None and args[5] is not None  # out, lse
        lse_pad, delta, dq_acc = args[grads_at + 3:grads_at + 6]
        assert lse_pad is not None and delta is not None
        assert (dq_acc is not None) == dq_scratch

"""The fp32 flash-attention forward on the tensor cores (``csrc/
flash_attention_fp32.cu``'s ``tf32x3_fwd_kernel``, d = 64 and 72) against
``ldmae_tpu`` on the CPU.

* A plain emulation of the kernel's decomposition, kept here and not in the
  package: every operand split into hi and lo (``tf32_split`` of the
  backward's tests); S = Q K^T by 3xTF32 a 64-key tile at a time; the
  online softmax in exp2 units (the running maximum, alpha = 2^(m_old -
  m_new) rescaling the row sum and O); P split like any operand; each
  tile's P V summed from zero, then added to O in fp32; lse = m + log2 l. It
  is held against the JAX forwards ``flash_attention``,
  ``flash_attention_rope``, ``flash_attention_qknorm_rope`` and
  ``flash_attention_fused_rope`` in fp32 (their Pallas kernels in
  interpret mode) at N = 200 (a ragged last tile) and d = 64 and 72, inputs
  from numpy seeds: relative L2 within F32X3_REL (1e-5) per output, the
  left-out lo lo terms (below 2^-22 of each product) and fp32 sums in
  another order. lse within F32X3_REL (relative L2) of an fp64 logsumexp
  over ln 2. A one-product TF32 emulation (hi hi alone) reads at least ten
  times the bound.
* The dispatch: the four wrappers on fp32 device operands at d = 64 and 72
  reach their C entries with ``vec == 4`` (16-byte rows; the C dispatch
  checks each operand's base and strides itself), #7's and #8's strided
  views of a packed qkv included, the forward with lse where the backward
  takes it, counted once, no plain version; a view one float off a 16-byte
  boundary, or with rows of an odd stride, gets a smaller ``vec``.

Readings of the emulation (N = 200, the four forwards at d = 64 and 72):
3.7e-7 to 4.5e-7 of the JAX outputs, lse 4.0e-8 to 4.2e-8 of fp64; the
control 3.8e-4 to 4.0e-4, 38-40 times the bound.
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ldmae_tpu.ops import flash_attention as jfa

from ldmae_tpu_torch import kernels
from ldmae_tpu_torch.ops import flash_attention as tfa

from test_torch_port_fp32bwd import TILE, F32X3_REL, _Recorder, _rel_l2, _tables, mm1, mm3


def fwd_emulation(q, k, v, mm=mm3):
    """(out, lse) as the tensor-core forward computes them (see the module
    note) on fp32 (B, H, N, d) q, k, v (already rotated or normed)."""
    n, d = q.shape[-2:]
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros_like(q)
    for t0 in range(0, n, TILE):
        kt, vt = k[..., t0:t0 + TILE, :], v[..., t0:t0 + TILE, :]
        s = mm(q, kt.transpose(-1, -2)) * scale_log2
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + mm(p, vt)  # the tile's product from zero, then added
        m = m_new
    return o / l[..., None], m + torch.log2(l)


def _inputs(shape, seed, n_arrays=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n_arrays)]


def _cases(shape):
    """(kernel, the JAX output, the emulated kernel's pre-pass output
    (q, k, v as (B, H, N, d) fp32 torch tensors), a function that brings the
    emulated (B, H, N, d) output to the JAX output's layout) for the four
    forwards at ``shape`` = (B, H, N, d)."""
    b, h, n, d = shape
    q, k, v = _inputs(shape, 11)
    cos, sin = _tables(n, d)
    tq, tk, tv, tcos, tsin = (torch.from_numpy(a) for a in (q, k, v, cos, sin))
    rng = np.random.default_rng(12)
    ws = [(1 + 0.1 * rng.standard_normal(d)).astype(np.float32) for _ in range(2)]
    tws = [torch.from_numpy(w) for w in ws]
    same = (lambda o: o)
    yield ("flash_attention", jfa.flash_attention(q, k, v), (tq, tk, tv), same)
    yield ("flash_attention_rope", jfa.flash_attention_rope(q, k, v, cos, sin),
           (tfa._rope_fp32(tq, tcos, tsin), tfa._rope_fp32(tk, tcos, tsin), tv), same)
    yield ("flash_attention_qknorm_rope",
           jfa.flash_attention_qknorm_rope(q, k, v, jnp.asarray(ws[0]), jnp.asarray(ws[1]), cos, sin),
           (tfa._qknorm_rope_fp32(tq, tws[0], tcos, tsin), tfa._qknorm_rope_fp32(tk, tws[1], tcos, tsin), tv), same)
    # the fused kernel's (B, N, H, d) operands: the same values transposed
    qn, kn, vn = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (q, k, v))
    yield ("flash_attention_fused_rope", jfa.flash_attention_fused_rope(qn, kn, vn, cos, sin),
           (tfa._rope_fp32(tq, tcos, tsin), tfa._rope_fp32(tk, tcos, tsin), tv), lambda o: o.transpose(1, 2))


@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (1, 2, 200, 72)], ids=["d64", "d72"])
def test_tf32x3_forward_emulation_matches_pallas(shape):
    """Each of the four forwards within F32X3_REL of the JAX forward in
    fp32, lse within F32X3_REL of the fp64 logsumexp; one TF32 product
    reads ten times that bound or more."""
    for name, ref, (q, k, v), layout in _cases(shape):
        out, lse = fwd_emulation(q, k, v)
        assert _rel_l2(layout(out).numpy(), ref) <= F32X3_REL, name
        logits = q.double() @ k.double().transpose(-1, -2) / math.sqrt(shape[-1])
        exact_lse = torch.logsumexp(logits, -1) / math.log(2.0)
        assert _rel_l2(lse.numpy(), exact_lse.numpy()) <= F32X3_REL, name
        control, _ = fwd_emulation(q, k, v, mm=mm1)
        assert _rel_l2(layout(control).numpy(), ref) >= 10 * F32X3_REL, name


# (name, C entry, index of vec counted from the end: the stream is last)
_ENTRIES = {
    "flash_attention": ("ldmae_flash_attention_fwd", -2),
    "flash_attention_rope": ("ldmae_flash_attention_rope_fwd", -2),
    "flash_attention_qknorm_rope": ("ldmae_flash_attention_qknorm_rope_fwd", -3),
    "flash_attention_fused_rope": ("ldmae_flash_attention_fused_rope_fwd", -2),
}


def _operands(name, b, h, n, d, pad, offset):
    """meta fp32 operands of ``name`` as the attention module passes them:
    contiguous (B, H, N, d) for #1 and #2 (``offset`` floats past a 16-byte
    base), the permuted views of a packed (B, N, 3 H d + pad) qkv for #7,
    its (B, N, H, d) slices for #8."""
    if name in ("flash_attention", "flash_attention_rope"):
        buf = torch.empty(3 * b * h * n * d + offset, device="meta")[offset:]
        return buf.view(3, b, h, n, d).unbind(0)
    qkv = torch.empty(b, n, 3 * h * d + pad, device="meta")[..., :3 * h * d]
    parts = [qkv[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d)) for i in range(3)]
    return [t.transpose(1, 2) for t in parts] if name == "flash_attention_qknorm_rope" else parts


def _call(name, q, k, v, n, d):
    tables = (torch.empty(n, d, device="meta"), torch.empty(n, d, device="meta"))
    weights = (torch.empty(d, device="meta"), torch.empty(d, device="meta"))
    fn = getattr(tfa, name)
    if name == "flash_attention":
        return fn(q, k, v)
    if name == "flash_attention_qknorm_rope":
        return fn(q, k, v, *weights, *tables)
    return fn(q, k, v, *tables)


@pytest.mark.parametrize("name", list(_ENTRIES))
@pytest.mark.parametrize("d", [64, 72])
def test_fp32_forward_reaches_its_entry_with_16_byte_rows(name, d, monkeypatch):
    """fp32 device operands at d = 64 and 72: one call of the wrapper's C
    entry with vec 4 (so every row of every operand is 16-byte aligned, the
    tensor-core forward's condition beside d), counted once, no plain
    version; a view off the 16-byte grid gets vec 1 and still reaches the
    same entry (the C dispatch then takes the SIMT forward)."""
    lib = _Recorder()
    monkeypatch.setattr(kernels, "load", lambda lib_name: lib)
    monkeypatch.setattr(kernels, "on_device", lambda x, entry, *args: entry(*args, None))
    for plain in ("flash_attention_plain", "flash_attention_rope_plain", "flash_attention_qknorm_rope_plain",
                  "flash_attention_fused_rope_plain"):
        monkeypatch.setattr(tfa, plain, lambda *a: pytest.fail("the plain version ran on a device tensor"))
    b, h, n = 2, 3, 200
    entry, at = _ENTRIES[name]
    wrapper = getattr(tfa, name)
    # aligned; the packed rows padded by 4 floats (16 bytes); one float off
    for pad, offset, vec in ((0, 0, 4), (4, 0, 4), (1, 1, 1)):
        if name in ("flash_attention", "flash_attention_rope") and pad:
            continue
        q, k, v = _operands(name, b, h, n, d, pad, offset)
        lib.calls.clear()
        before = wrapper.launches
        out = _call(name, q, k, v, n, d)
        assert wrapper.launches == before + 1
        assert out.dtype == torch.float32 and out.shape == q.shape and out.is_contiguous()
        ((called, args),) = lib.calls
        assert called == entry
        assert args[at] == vec, (pad, offset, args)


@pytest.mark.parametrize("rope", [False, True], ids=["flash_attention", "flash_attention_rope"])
def test_fp32_forward_under_autograd_writes_lse(rope, monkeypatch):
    """Under autograd (the training path) #1 and #2 in fp32 pass the C entry
    an lse buffer beside vec 4, which the backward then takes."""
    lib = _Recorder()
    monkeypatch.setattr(kernels, "load", lambda lib_name: lib)
    monkeypatch.setattr(kernels, "on_device", lambda x, entry, *args: entry(*args, None))
    b, h, n, d = 2, 3, 200, 64
    q, k, v = (t.requires_grad_() for t in _operands("flash_attention", b, h, n, d, 0, 0))
    _call("flash_attention_rope" if rope else "flash_attention", q, k, v, n, d)
    ((called, args),) = lib.calls
    assert called == ("ldmae_flash_attention_rope_fwd" if rope else "ldmae_flash_attention_fwd")
    lse_at = 8 if rope else 4
    assert args[lse_at] is not None and args[-2] == 4

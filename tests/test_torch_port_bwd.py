"""The single-pass flash-attention backward (the CUDA kernels at head dim 64)
and the lse the forward saves for it, against ``ldmae_tpu`` on the CPU.

* A plain-PyTorch emulation of the kernels' decomposition, kept here and not
  in the package: 128-key blocks by 64-query tiles, lse from the forward,
  delta = rowsum(g * o) from the bf16-rounded output, P and dS rounded to
  bf16 as product operands, dq summed over the key blocks in fp32, then the
  scale and (RoPE) the transposed Jacobian on the rotated q, k rounded to
  bf16 as the kernel's pre-pass rounds them. It is held against ``jax.vjp``
  of ``flash_attention`` and ``flash_attention_rope_trainable`` (their Pallas
  backward kernels in interpret mode) on bf16-valued inputs, at a ragged and
  a whole number of tiles: relative L2 error within 1e-2 per gradient (the
  bf16 roundings of P, dS, the output and, for RoPE, the rotated q, k; the
  JAX kernels keep all of them in fp32).
* The plain lse (``flash_attention_lse_plain``, the kernels' convention)
  against ``jax.nn.logsumexp`` of the JAX logits over ln 2, within 1e-5 of
  its magnitude (fp32, summation order only).
* The differentiable wrappers save their inputs, the output and that lse,
  and pass them to the backward, which gives the plain backward's gradients.
"""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ldmae_tpu.ops import flash_attention as jfa

from ldmae_tpu_torch.ops import flash_attention as tfa
from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

KEYS, QUERIES = 128, 64  # the kernel's key block and query tile


def _bf16_inputs(shape, seed):
    """q, k, v, g as fp32 arrays holding bf16 values (the kernel's operands)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().float().numpy()
            for _ in range(4)]


def _tables(n, d):
    grid = int(math.isqrt(n - 1)) + 1
    return tuple(to_half_layout(t)[:n] for t in build_rope_table(d // 2, grid))


def _bf16(x):
    return x.bfloat16().float()


def single_pass_emulation(q, k, v, g, cos=None, sin=None):
    """(dq, dk, dv) as flash_bwd_wgmma_kernel and its pre- and postprocess
    compute them (see the module note), in fp32 on (B, H, N, d) tensors."""
    if cos is not None:  # the forward's pre-pass: rotated in fp32, rounded to bf16
        q, k = (_bf16(tfa._rope_fp32(t, cos, sin)) for t in (q, k))
    n, d = q.shape[-2:]
    scale = d**-0.5
    lse = tfa.flash_attention_lse_plain(q, k)  # the forward's, in log2 units
    out = _bf16(tfa.flash_attention_plain(q, k, v))  # the saved bf16 output
    delta = (g * out).sum(-1)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, n, KEYS):
        kb, vb = k[..., k0:k0 + KEYS, :], v[..., k0:k0 + KEYS, :]
        for q0 in range(0, n, QUERIES):
            rows = slice(q0, q0 + QUERIES)
            qb, gb = q[..., rows, :], g[..., rows, :]
            p = torch.exp2(qb @ kb.transpose(-1, -2) * (scale * math.log2(math.e)) - lse[..., rows, None])
            ds = p * (gb @ vb.transpose(-1, -2) - delta[..., rows, None])
            p, ds = _bf16(p), _bf16(ds)
            dv[..., k0:k0 + KEYS, :] += p.transpose(-1, -2) @ gb
            dk[..., k0:k0 + KEYS, :] += ds.transpose(-1, -2) @ qb
            dq[..., rows, :] += ds @ kb  # the accumulator, summed over key blocks
    dq, dk = dq * scale, dk * scale
    if cos is not None:
        dq, dk = tfa._rope_transpose(dq, cos, sin), tfa._rope_transpose(dk, cos, sin)
    return dq, dk, dv


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("rope", [False, True], ids=["flash_attention", "flash_attention_rope"])
@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (1, 2, 256, 64)], ids=["ragged", "whole"])
def test_single_pass_emulation_matches_pallas_vjp(shape, rope):
    q, k, v, g = _bf16_inputs(shape, 0)
    cos, sin = _tables(shape[2], shape[3])
    if rope:
        _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_rope_trainable(q, k, v, cos, sin), q, k, v)
        out = single_pass_emulation(*map(torch.from_numpy, (q, k, v, g)), torch.from_numpy(cos),
                                    torch.from_numpy(sin))
    else:
        _, vjp = jax.vjp(jfa.flash_attention, q, k, v)
        out = single_pass_emulation(*map(torch.from_numpy, (q, k, v, g)))
    for name, o, r in zip(("dq", "dk", "dv"), out, vjp(jnp.asarray(g))):
        assert _rel_l2(o.numpy(), r) < 1e-2, name


@pytest.mark.parametrize("shape", [(1, 2, 200, 64), (2, 3, 256, 16)])
def test_plain_lse_matches_jax_logsumexp(shape):
    q, k, _, _ = _bf16_inputs(shape, 1)
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) * shape[-1] ** -0.5
    ref = np.asarray(jax.nn.logsumexp(logits, axis=-1)) / math.log(2)
    out = tfa.flash_attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k)).numpy()
    assert out.shape == shape[:3]
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("rope", [False, True], ids=["flash_attention", "flash_attention_rope"])
def test_functions_save_the_output_and_lse(rope):
    q, k, v, g = (torch.from_numpy(a) for a in _bf16_inputs((1, 2, 96, 64), 2))
    cos, sin = (torch.from_numpy(t) for t in _tables(96, 64))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = tfa.flash_attention_rope(q, k, v, cos, sin) if rope else tfa.flash_attention(q, k, v)
    saved = out.grad_fn.saved_tensors
    qr, kr = (tfa._rope_fp32(t.detach(), cos, sin) for t in (q, k)) if rope else (q.detach(), k.detach())
    torch.testing.assert_close(saved[-2], out.detach(), rtol=0, atol=0)
    torch.testing.assert_close(saved[-1], tfa.flash_attention_lse_plain(qr, kr), rtol=0, atol=0)
    grads = torch.autograd.grad(out, (q, k, v), g)
    refs = (tfa.flash_attention_rope_bwd_plain(q.detach(), k.detach(), v.detach(), g, cos, sin) if rope
            else tfa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), g))
    for o, r in zip(grads, refs):
        torch.testing.assert_close(o, r, rtol=0, atol=0)

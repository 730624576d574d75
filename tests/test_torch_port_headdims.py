"""The port's kernels at every head dim and in fp32, against the JAX package.

The CUDA kernels take any head dim 1 <= d <= 128 and bf16 or fp32, as the
Pallas kernels do; on the CPU each wrapper runs its plain version, so these
tests pin, against the Pallas kernels in interpret mode, the arithmetic the
CUDA kernels are held to on the card (``test_torch_port_gpu.py``,
``chip_smoke.py``): the attention forward and backward at the VMAE head
dims (8, 12, 24, 36, 80) and ragged N, the fp32 adaLN kernels at every DiT
registry width, and the arithmetic of the resident d = 16 forward kernel
(two-pass softmax, p rounded to bf16) emulated in plain PyTorch.

Tolerances: fp32 forwards 1e-5 (summation order, exp rounding); fp32
backwards 1e-5 of the largest |gradient| (the plain backward's math is the
Pallas kernel's); bf16 forwards a couple of bf16 ulps at the output's
magnitude (2^-7 relative plus 2^-7 absolute). The resident emulation: one
bf16 ulp of the element (2^-7 relative) plus 2^-8 of the largest |output|,
the gate the CUDA attention kernels meet on the card (p rounded before it
is normalised is far inside it).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ldmae_tpu.ops import flash_attention as jfa
from ldmae_tpu.ops import fused_adaln as jfad
from ldmae_tpu.ops.rope import build_rope_table as jbuild_rope, to_half_layout as jhalf

from ldmae_tpu_torch.models import lightningdit as tdit
from ldmae_tpu_torch.ops import flash_attention as tfa
from ldmae_tpu_torch.ops import fused_adaln as tfad

BF16_TOL = dict(rtol=2**-7, atol=2**-7)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
HEAD_DIMS = [8, 12, 24, 36, 80]  # VMAE decoders (small 12, prev_large 24), an off-8 dim, the MAE-huge encoder


def _pair(a: np.ndarray, dt: str):
    jd, td = DTYPES[dt]
    j = jnp.asarray(a, jnp.float32).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _close(jout, tout, dt):
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout.astype(jnp.float32)),
                               **(BF16_TOL if dt == "bfloat16" else F32_TOL))


def _tables(d, n):
    grid = int(np.ceil(np.sqrt(n)))
    return [jhalf(t)[:n] for t in jbuild_rope(d // 2, grid)]


@pytest.mark.parametrize("n", [200, 256])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_any_head_dim_matches_pallas(d, dt, n):
    """flash_attention and flash_attention_rope forwards; N = 200 is ragged
    against the CUDA kernels' 64-row tiles (and 128-key chunks)."""
    rng = np.random.default_rng(d + n)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.standard_normal((1, 2, n, d)), dt) for _ in range(3))
    _close(jfa._flash_forward(jq, jk, jv), tfa.flash_attention(tq, tk, tv), dt)
    cos, sin = _tables(d, n)
    jout = jfa.flash_attention_rope(jq, jk, jv, jnp.asarray(cos), jnp.asarray(sin))
    tout = tfa.flash_attention_rope(tq, tk, tv, torch.from_numpy(cos), torch.from_numpy(sin))
    assert tout.dtype == tq.dtype and tout.shape == tq.shape
    _close(jout, tout, dt)


@pytest.mark.parametrize("rope", [False, True], ids=["flash_attention", "flash_attention_rope"])
@pytest.mark.parametrize("n", [200, 256])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_bwd_any_head_dim_matches_pallas_vjp(d, n, rope):
    """The fp32 backward (through the autograd Functions, which on the CPU
    run the plain backward) against jax.vjp of the Pallas kernels."""
    rng = np.random.default_rng(3 * d + n)
    q, k, v, g = (rng.standard_normal((1, 2, n, d)).astype(np.float32) for _ in range(4))
    cos, sin = _tables(d, n)
    if rope:
        _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_rope_trainable(q, k, v, cos, sin), q, k, v)
    else:
        _, vjp = jax.vjp(jfa.flash_attention, q, k, v)
    ref = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = (tfa.flash_attention_rope(tq, tk, tv, torch.from_numpy(cos), torch.from_numpy(sin)) if rope
           else tfa.flash_attention(tq, tk, tv))
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, o, r in zip(("dq", "dk", "dv"), grads, ref):
        r = np.asarray(r)
        assert float(np.abs(o.numpy() - r).max() / np.abs(r).max()) < 1e-5, name


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("model", ["debug", "B/1", "L/2", "XL/1", "1p0B/1", "1p6B/1"])
def test_fused_norm_modulate_fp32_registry_widths(model, kind):
    """#3 in fp32 at each DiT registry width (every one a multiple of 4 and
    at most the kernels' 2,048) against the Pallas kernel, and #9's plain
    version (the quantizing kernel the card holds to it) on the same fp32
    rows against its Pallas kernel."""
    d = tdit.dit_spec(f"LightningDiT-{model}").hidden_size
    assert d % 4 == 0 and d <= tfad.MAX_WIDTH
    rng = np.random.default_rng(9)
    jx, tx = _pair(rng.standard_normal((2, 32, d)) * 3.0 + 0.5, "float32")
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    jsh, tsh = _pair(0.1 * rng.standard_normal((2, d)), "float32")
    jsc, tsc = _pair(0.1 * rng.standard_normal((2, d)), "float32")
    jout = jfad.fused_norm_modulate(jx, jnp.asarray(w), jsh, jsc, kind=kind)
    tout = tfad.fused_norm_modulate(tx, torch.from_numpy(w), tsh, tsc, kind=kind)
    assert tout.dtype == torch.float32
    _close(jout, tout, "float32")
    jq, js = jfad.fused_norm_modulate_quant(jx, jnp.asarray(w), jsh, jsc, kind=kind)
    tq, ts = tfad.fused_norm_modulate_quant(tx, torch.from_numpy(w), tsh, tsc, kind=kind)
    # an int8 value on a rounding boundary after another fp32 sum may move a step
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


def test_fused_silu_mul_quant_fp32_matches_pallas():
    rng = np.random.default_rng(10)
    jx, tx = _pair(rng.standard_normal((2, 256, 2 * 2048)) * 2.0, "float32")
    jq, js = jfad.fused_silu_mul_quant(jx)
    tq, ts = tfad.fused_silu_mul_quant(tx)
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@pytest.mark.parametrize("n,d", [(1025, 16), (1000, 16), (1024, 16), (1024, 8), (3072, 16)])
def test_resident_kernel_emulation_matches_pallas(n, d):
    """The resident kernel's arithmetic against the Pallas kernel in bf16 at
    the VMAE decoder's N = 1024, ragged N (a cls token past 1,024 patches:
    1025; 1000), d = 8 (which the kernel pads to 16) and the most keys it
    holds (3,072)."""
    rng = np.random.default_rng(11 + n + d)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.standard_normal((1, 2, n, d)), "bfloat16") for _ in range(3))
    ref = torch.from_numpy(np.asarray(jfa._flash_forward(jq, jk, jv).astype(jnp.float32)))
    out = tfa.flash_attention_resident_emulated(tq, tk, tv).float()
    torch.testing.assert_close(out, ref, rtol=2**-7, atol=2**-8 * float(ref.abs().max()))

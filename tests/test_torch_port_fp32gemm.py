"""#4 ``fused_matmul_silu`` in fp32 on the tensor cores (``csrc/gemm.cuh``'s
fp32 configuration, ``csrc/fused_matmul_silu.cu``) against ``ldmae_tpu``
on the CPU.

* A plain emulation of the kernel's arithmetic, kept here and not in the
  package: w12 and x split into TF32 hi and lo parts (``tf32_split``, the
  kernels' ``split_tf32``), the product summed over D in the kernel's k
  steps of 8, each step adding x_lo w_hi, then x_hi w_lo, then x_hi w_hi
  into a partial fp32 sum that starts from zero every 128 of depth (the
  kernel's kFlush stages) and is then added to the running sum; then the
  fp32 bias and silu(x1) x2 = x1 x2 / (1 + e^-x1), the kernel's epilogue.
  It is held against the JAX ``fused_matmul_silu`` in fp32 (its Pallas
  kernel in interpret mode, a full fp32 dot on the CPU): relative L2 error
  within F32X3_REL (1e-5), the left-out lo lo terms (below 2^-22 of each
  product) and fp32 sums in another order. The same with one TF32 product
  a step (hi hi alone) reads at least ten times that bound.
* The dispatch: fp32 device operands reach the fp32 C entry once, with
  the (4H, D) scratch that receives w12's split parts, counted once, no
  plain version; bf16 reaches its own entry; an x off the 16-byte grid
  that TMA needs raises.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ldmae_tpu.ops import fused_adaln as jfad

from ldmae_tpu_torch import kernels
from ldmae_tpu_torch.ops import fused_adaln as tfad
from test_torch_port_fp32bwd import F32X3_REL, _Recorder, _rel_l2, tf32_split

K_STEP = 8  # depth of one wgmma m64nNk8 tf32 product
K_FLUSH = 128  # depth summed from zero before it is added to the running sum (4 stages of 32)


def tc_emulation(x, w12, b12, products=3):
    """The kernel's (M, H) output on fp32 x (M, D), w12 (2H, D), b12 (2H,)
    or None: ``products`` 3 is 3xTF32, 1 one TF32 product (the control)."""
    (xh, xl), (wh, wl) = tf32_split(x), tf32_split(w12)
    acc = torch.zeros(x.shape[0], w12.shape[0])
    for c0 in range(0, x.shape[1], K_FLUSH):
        part = torch.zeros_like(acc)
        for k0 in range(c0, c0 + K_FLUSH, K_STEP):
            ks = slice(k0, k0 + K_STEP)
            if products == 3:
                part = part + xl[:, ks] @ wh[:, ks].T
                part = part + xh[:, ks] @ wl[:, ks].T
            part = part + xh[:, ks] @ wh[:, ks].T
        acc = acc + part
    if b12 is not None:
        acc = acc + b12
    x1, x2 = acc.chunk(2, dim=-1)
    return x1 / (1 + torch.exp(-x1)) * x2


def _inputs(m, d, h2, seed, bias=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    w12 = (rng.standard_normal((h2, d)) * d**-0.5).astype(np.float32)  # nn.Linear layout (2H, D)
    b12 = (rng.standard_normal(h2) * 0.1).astype(np.float32) if bias else None
    return x, w12, b12


@pytest.mark.parametrize("m,d,h2,bias", [(256, 256, 512, True), (128, 384, 768, True), (256, 128, 256, False)],
                         ids=["256x256x512", "128x384x768", "no-bias"])
def test_tf32x3_emulation_matches_pallas(m, d, h2, bias):
    """Within F32X3_REL of the JAX kernel in fp32; one TF32 product a step
    reads ten times that bound or more."""
    x, w12, b12 = _inputs(m, d, h2, 11, bias)
    ref = np.asarray(jfad.fused_matmul_silu(jnp.asarray(x), jnp.asarray(w12.T), None if b12 is None
                                            else jnp.asarray(b12)))
    args = (torch.from_numpy(x), torch.from_numpy(w12), None if b12 is None else torch.from_numpy(b12))
    assert _rel_l2(tc_emulation(*args).numpy(), ref) <= F32X3_REL
    assert _rel_l2(tc_emulation(*args, products=1).numpy(), ref) >= 10 * F32X3_REL


def _device_call(monkeypatch, dtype, offset=0, m=256, d=256, h2=512):
    lib = _Recorder()
    monkeypatch.setattr(kernels, "load", lambda name: lib)
    monkeypatch.setattr(kernels, "on_device", lambda x, entry, *args: entry(*args, None))
    monkeypatch.setattr(tfad, "fused_matmul_silu_plain", lambda *a: pytest.fail("the plain version ran"))
    x = torch.empty(m * d + offset, device="meta", dtype=dtype)[offset:].view(m, d)
    w12 = torch.empty(h2, d, device="meta", dtype=dtype)
    b12 = torch.empty(h2, device="meta")
    before = tfad.fused_matmul_silu.launches
    out = tfad.fused_matmul_silu(x, w12, b12)
    assert tfad.fused_matmul_silu.launches == before + 1
    assert out.shape == (m, h2 // 2) and out.dtype == dtype
    return lib.calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_device_operands_reach_their_entry_once(dtype, monkeypatch):
    """fp32: ``ldmae_fused_matmul_silu_f32`` with a w12 split scratch beside
    the output, then (m, d, h); bf16: ``ldmae_fused_matmul_silu``."""
    m, d, h2 = 256, 256, 512
    ((name, args),) = _device_call(monkeypatch, dtype, m=m, d=d, h2=h2)
    if dtype == torch.float32:
        assert name == "ldmae_fused_matmul_silu_f32"
        assert len(args) == 9 and args[4] is not None and args[5:8] == (m, d, h2 // 2)
    else:
        assert name == "ldmae_fused_matmul_silu"
        assert len(args) == 8 and args[4:7] == (m, d, h2 // 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_unaligned_x_raises_before_any_launch(dtype, monkeypatch):
    with pytest.raises(ValueError, match="aligned"):
        _device_call(monkeypatch, dtype, offset=1)

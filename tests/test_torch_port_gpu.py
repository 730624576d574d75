"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``; each test skips (from a fixture, so every xdist worker
collects the same tests) when there is no CUDA device. This file imports
neither JAX nor ``ldmae_tpu``, so on a machine without JAX it runs with
``python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py``.

Tolerance: both sides round the output to bf16 and differ in fp32
summation order and exp/rsqrt rounding; a one-ulp difference early can grow
to two through the later bf16 roundings, so for the norm and the GEMM two
bf16 ulps at the output's magnitude (~1; 2^-6). Attention: one ulp of the
element (rtol 2^-7) plus 2^-8 of the largest |output| (the kernel rounds p
before normalising it, the plain version after: an error absolute in the
output's scale, ~0.05 for random q, k, v). The quantizing kernels: the
int8 values within one step of the plain version's, at most 1e-3 of them
off by that step (a value on a rounding boundary after another fp32 row
sum), the row scales within rtol 1e-6. The backward kernels round p and
ds to bf16 for the tensor-core products (the plain version keeps them
fp32): each of dq, dk, dv within relative L2 error BWD_REL_L2 and every
element within BWD_ELEM of that output's largest |value|. At head dim 64 the
backward sums dq over key tiles with atomic adds, in an order that changes
from run to run: two runs' dq agree within BWD_REL_L2, dk and dv exactly.
The forward's lse (log2 units, magnitude about log2 N plus the largest
logit) within 1e-4 plus 1e-5 relative of the plain lse: both sum the same
fp32 exponentials in another order, the kernel's by ex2.approx.
"""

import re

import pytest
import torch

from ldmae_tpu_torch.ops import flash_attention as tfa
from ldmae_tpu_torch.ops import fused_adaln as tfad
from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

BF16_TOL = dict(rtol=2**-6, atol=2**-6)
BWD_REL_L2, BWD_ELEM = 1e-2, 2e-2  # readings on an H100: 0.0025-0.0028 and <= 0.0065


def _attn_tol(ref):
    return dict(rtol=2**-7, atol=2**-8 * float(ref.float().abs().max()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16(shape, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "d,n,rope",
    [(64, 1024, True), (64, 256, True), (64, 1000, True), (16, 1024, False), (16, 1025, False),
     (16, 1000, False), (72, 200, True)],
)
def test_cuda_flash_attention_vs_plain(cuda, d, n, rope):
    q, k, v = (_bf16((2, 3, n, d), s, cuda) for s in range(3))
    if rope:
        grid = int(n**0.5) + 1
        cos, sin = (torch.from_numpy(to_half_layout(t)[:n]).to(cuda)
                    for t in build_rope_table(d // 2, grid))
        out = tfa.flash_attention_rope(q, k, v, cos, sin)
        ref = tfa.flash_attention_rope_plain(q, k, v, cos, sin)
    else:
        out = tfa.flash_attention(q, k, v)
        ref = tfa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **_attn_tol(ref))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("mod", ["rows", "strided", "fp32"])
def test_cuda_fused_norm_modulate_vs_plain(cuda, kind, mod):
    x = _bf16((4, 256, 768), 0, cuda) * 3
    w = 1 + 0.1 * _bf16((768,), 1, cuda).float()
    ada = _bf16((4, 6, 768), 2, cuda) * 0.1  # shift, scale as the adaLN projection's views
    sh, sc = ada[:, 0], ada[:, 1]
    if mod == "rows":
        sh, sc = sh.contiguous(), sc.contiguous()
    elif mod == "fp32":  # rounded to x's dtype by the wrapper, as by the TPU kernel
        sh, sc = (torch.randn(4, 768, device=cuda) * 0.1 for _ in range(2))
    out = tfad.fused_norm_modulate(x, w, sh, sc, kind=kind)
    ref = tfad.fused_norm_modulate_plain(x, w, sh, sc, kind=kind)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "m,d,h2,bias",
    [
        (16384, 768, 4096, True),  # B/1 at batch 8, CFG-doubled: 2,048 tiles of 128 x 128
        (384, 768, 4096, True),    # 48 tiles, fewer than the SMs
        (1024, 1152, 6144, True),  # XL
        (512, 1536, 8192, True),   # 1p0B
        (128, 128, 256, True),     # the smallest shape the gate admits: one tile, two stages deep
        (1024, 768, 4096, False),  # b12 None
    ],
)
def test_cuda_fused_matmul_silu_vs_plain(cuda, m, d, h2, bias):
    x = _bf16((m, d), 0, cuda)
    w12 = _bf16((h2, d), 1, cuda) * d**-0.5
    b12 = _bf16((h2,), 2, cuda).float() * 0.1 if bias else None
    out = tfad.fused_matmul_silu(x, w12, b12)
    ref = tfad.fused_matmul_silu_plain(x, w12, b12)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = _bf16((1, 2, 64, 48), 0, cuda)  # head dim 48 is not instantiated
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q)
    with pytest.raises(ValueError):
        tfa.flash_attention(q.float(), q.float(), q.float())


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(64, 1024), (72, 200)])
def test_cuda_flash_attention_qknorm_rope_vs_plain(cuda, d, n):
    q, k, v = (_bf16((2, 3, n, d), s, cuda) for s in range(3))
    qs, ks = (1 + 0.1 * _bf16((d,), s, cuda).float() for s in (3, 4))
    grid = int(n**0.5) + 1
    cos, sin = (torch.from_numpy(to_half_layout(t)[:n]).to(cuda) for t in build_rope_table(d // 2, grid))
    out = tfa.flash_attention_qknorm_rope(q, k, v, qs, ks, cos, sin)
    ref = tfa.flash_attention_qknorm_rope_plain(q, k, v, qs, ks, cos, sin)
    torch.testing.assert_close(out.float(), ref.float(), **_attn_tol(ref))


@pytest.mark.gpu
@pytest.mark.parametrize("d,h,n", [(64, 12, 1024), (72, 4, 200)])
def test_cuda_flash_attention_fused_rope_vs_plain(cuda, d, h, n):
    """q, k normed copies in the (B, N, H, d) layout, v a strided view of the
    packed qkv, as the attention module passes them."""
    qkv = _bf16((2, n, 3, h, d), 0, cuda)
    q, k, v = qkv[:, :, 0].contiguous(), qkv[:, :, 1], qkv[:, :, 2]
    grid = int(n**0.5) + 1
    cos, sin = (torch.from_numpy(to_half_layout(t)[:n]).to(cuda) for t in build_rope_table(d // 2, grid))
    out = tfa.flash_attention_fused_rope(q, k, v, cos, sin)
    ref = tfa.flash_attention_fused_rope_plain(q, k, v, cos, sin)
    assert out.shape == (2, n, h, d) and out.is_contiguous()
    torch.testing.assert_close(out.float(), ref.float(), **_attn_tol(ref))


def _rope_tables(d, n, device):
    grid = int(n**0.5) + 1
    return tuple(torch.from_numpy(to_half_layout(t)[:n]).to(device) for t in build_rope_table(d // 2, grid))


def _assert_bwd_close(outs, refs):
    """Per output: relative L2 error within BWD_REL_L2 and every element
    within BWD_ELEM of the output's largest |value| (see the module note)."""
    torch.cuda.synchronize()
    for name, out, ref in zip(("dq", "dk", "dv"), outs, refs):
        out, ref = out.float(), ref.float()
        assert torch.isfinite(out).all(), name
        rel = float((out - ref).norm() / ref.norm())
        elem = float((out - ref).abs().max() / ref.abs().max())
        assert rel <= BWD_REL_L2 and elem <= BWD_ELEM, (name, rel, elem)


def _bwd_inputs(shape, rope, device):
    q, k, v, g = (_bf16(shape, s, device) for s in range(4))
    tables = _rope_tables(shape[-1], shape[-2], device) if rope else ()
    return (q, k, v, g), tables


# b, h, d, n: the single pass (d = 64) at ragged and whole tiles of 64 queries
# and 128 keys, and at the DiT B/1 training shape; the three passes (d = 16, 72)
_BWD_CASES = [(2, 3, 16, 1024), (2, 3, 64, 1024), (2, 3, 72, 200), (2, 3, 64, 1000), (2, 3, 16, 200),
              (2, 3, 64, 64), (2, 3, 64, 128), (2, 3, 64, 200), (2, 3, 64, 256), (32, 12, 64, 1024)]


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("b,h,d,n", _BWD_CASES)
def test_cuda_flash_attention_bwd_vs_plain(cuda, b, h, d, n, rope):
    (q, k, v, g), tables = _bwd_inputs((b, h, n, d), rope, cuda)
    if rope:
        outs = tfa.flash_attention_rope_bwd(q, k, v, g, *tables)
        refs = tfa.flash_attention_rope_bwd_plain(q, k, v, g, *tables)
    else:
        outs = tfa.flash_attention_bwd(q, k, v, g)
        refs = tfa.flash_attention_bwd_plain(q, k, v, g)
    _assert_bwd_close(outs, refs)
    if d == tfa.WGMMA_HEAD_DIM:  # the residuals passed in, as the autograd Functions pass them
        out, lse = tfa._launch(q, k, v, "test", *tables, with_lse=True)
        kernel = tfa.flash_attention_rope_bwd if rope else tfa.flash_attention_bwd
        _assert_bwd_close(kernel(q, k, v, g, *tables, out=out, lse=lse), refs)


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("n", [64, 200, 1024])
def test_cuda_forward_lse_vs_plain(cuda, n, rope):
    """The d = 64 forward's lse against the plain lse of the same (rotated,
    bf16-rounded) q and k; the output is the forward without lse's."""
    (q, k, v, _), tables = _bwd_inputs((2, 3, n, 64), rope, cuda)
    out, lse = tfa._launch(q, k, v, "test", *tables, with_lse=True)
    qr, kr = (tfa._rope_fp32(t, *tables) for t in (q, k)) if rope else (q, k)
    assert lse.shape == (2, 3, n) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, tfa.flash_attention_lse_plain(qr, kr), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(out, tfa._launch(q, k, v, "test", *tables), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
def test_cuda_bwd_dq_run_to_run(cuda, rope):
    """dq's atomic sums over key tiles change order between runs: two runs
    agree within BWD_REL_L2; dk and dv are written once, so exactly."""
    (q, k, v, g), tables = _bwd_inputs((4, 12, 1024, 64), rope, cuda)
    out, lse = tfa._launch(q, k, v, "test", *tables, with_lse=True)
    kernel = tfa.flash_attention_rope_bwd if rope else tfa.flash_attention_bwd
    first = kernel(q, k, v, g, *tables, out=out, lse=lse)
    second = kernel(q, k, v, g, *tables, out=out, lse=lse)
    torch.cuda.synchronize()
    rel = float((first[0].float() - second[0].float()).norm() / first[0].float().norm())
    assert rel <= BWD_REL_L2, rel
    torch.testing.assert_close(first[1], second[1], rtol=0, atol=0)
    torch.testing.assert_close(first[2], second[2], rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
def test_cuda_autograd_functions_vs_plain_backward(cuda, rope):
    """The differentiable wrappers on CUDA tensors launch the backward kernel
    (counted) and give the plain backward's gradients; a non-contiguous
    output gradient (a transposed view, as autograd hands in) is taken."""
    n, d = 256, 64
    q, k, v = (_bf16((2, 4, n, d), s, cuda).requires_grad_() for s in range(3))
    gt = _bf16((2, n, 4, d), 3, cuda)
    g = gt.transpose(1, 2)  # (2, 4, n, d), not contiguous
    cos, sin = _rope_tables(d, n, cuda)
    before = (tfa.flash_attention_rope_bwd if rope else tfa.flash_attention_bwd).launches
    out = tfa.flash_attention_rope(q, k, v, cos, sin) if rope else tfa.flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), g)
    after = (tfa.flash_attention_rope_bwd if rope else tfa.flash_attention_bwd).launches
    assert after == before + 1
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    refs = (tfa.flash_attention_rope_bwd_plain(qd, kd, vd, g, cos, sin) if rope
            else tfa.flash_attention_bwd_plain(qd, kd, vd, g))
    _assert_bwd_close(grads, refs)


def _kernel_names(fn) -> list:
    """Names of the device kernels that ``fn`` launches, by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
def test_cuda_autograd_backward_at_d64_is_one_pass(cuda, rope):
    """At d = 64 the autograd Functions save the forward's output and lse and
    pass them to the backward, which launches the preprocess, the single-pass
    kernel and the postprocess (and for RoPE its pre-pass), and no forward or
    statistics pass: one counted backward launch, no counted forward."""
    q, k, v = (_bf16((2, 4, 256, 64), s, cuda).requires_grad_() for s in range(3))
    g = _bf16((2, 4, 256, 64), 3, cuda)
    cos, sin = _rope_tables(64, 256, cuda)
    out = tfa.flash_attention_rope(q, k, v, cos, sin) if rope else tfa.flash_attention(q, k, v)
    saved = out.grad_fn.saved_tensors
    ref_lse = tfa._launch(q.detach(), k.detach(), v.detach(), "test", *((cos, sin) if rope else ()),
                          with_lse=True)[1]
    torch.testing.assert_close(saved[-1], ref_lse, rtol=0, atol=0)
    torch.testing.assert_close(saved[-2], out.detach(), rtol=0, atol=0)
    fwd = tfa.flash_attention_rope if rope else tfa.flash_attention
    bwd = tfa.flash_attention_rope_bwd if rope else tfa.flash_attention_bwd
    counts = fwd.launches, bwd.launches
    names = _kernel_names(lambda: torch.autograd.grad(out, (q, k, v), g))
    assert (fwd.launches, bwd.launches) == (counts[0], counts[1] + 1)
    ours = sorted(m.group(1) for n in names if (m := re.search(r"(flash_\w+_kernel|norm_rope_kernel)", n)))
    want = ["flash_bwd_postprocess_kernel", "flash_bwd_preprocess_kernel", "flash_bwd_wgmma_kernel"]
    assert ours == sorted(want + (["norm_rope_kernel"] if rope else [])), names


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_cuda_fused_norm_modulate_function_backward(cuda, kind):
    """The differentiable fused_norm_modulate on CUDA tensors: the forward
    kernel runs (counted) and the gradients are fused_norm_modulate_bwd's."""
    x = (_bf16((4, 256, 768), 0, cuda) * 3).requires_grad_()
    w = (1 + 0.1 * _bf16((768,), 1, cuda).float()).requires_grad_()
    ada = (_bf16((4, 6, 768), 2, cuda) * 0.1).requires_grad_()
    g = _bf16((4, 256, 768), 3, cuda)
    before = tfad.fused_norm_modulate.launches
    out = tfad.fused_norm_modulate(x, w, ada[:, 0], ada[:, 1], kind=kind)
    assert tfad.fused_norm_modulate.launches == before + 1
    dx, dw, dada = torch.autograd.grad(out, (x, w, ada), g)
    rx, rw, rsh, rsc = tfad.fused_norm_modulate_bwd(x.detach(), w.detach(), ada[:, 0].detach(),
                                                    ada[:, 1].detach(), g, kind=kind)
    torch.testing.assert_close(dx, rx, rtol=0, atol=0)
    torch.testing.assert_close(dada[:, 0], rsh, rtol=0, atol=0)
    torch.testing.assert_close(dada[:, 1], rsc, rtol=0, atol=0)
    if kind == "rms":
        torch.testing.assert_close(dw, rw, rtol=0, atol=0)


@pytest.mark.gpu
def test_cuda_backward_rejects_more_than_65535_heads(cuda):
    """batch * heads is the grid's y dimension, at most 65535: a clear error,
    not a launch that fails."""
    q = torch.zeros(65536, 1, 16, 16, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="65535"):
        tfa.flash_attention_bwd(q, q, q, q)


def _assert_quant_close(out, ref):
    (q, s), (q_ref, s_ref) = out, ref
    torch.cuda.synchronize()
    dq = (q.int() - q_ref.int()).abs()
    assert int(dq.max()) <= 1
    assert float((dq != 0).float().mean()) <= 1e-3
    torch.testing.assert_close(s, s_ref, rtol=1e-6, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_cuda_fused_norm_modulate_quant_vs_plain(cuda, kind):
    x = _bf16((4, 256, 768), 0, cuda) * 3
    w = 1 + 0.1 * _bf16((768,), 1, cuda).float()
    ada = _bf16((4, 6, 768), 2, cuda) * 0.1
    sh, sc = ada[:, 0], ada[:, 1]
    _assert_quant_close(tfad.fused_norm_modulate_quant(x, w, sh, sc, kind=kind),
                        tfad.fused_norm_modulate_quant_plain(x, w, sh, sc, kind=kind))


@pytest.mark.gpu
@pytest.mark.parametrize("h", [2048, 1000])
def test_cuda_fused_silu_mul_quant_vs_plain(cuda, h):
    x12 = _bf16((2, 512, 2 * h), 0, cuda) * 2
    _assert_quant_close(tfad.fused_silu_mul_quant(x12), tfad.fused_silu_mul_quant_plain(x12))

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
element within BWD_ELEM of that output's largest |value|. At head dims 64
and 72 the backward sums dq over key tiles by bulk reductions in key-tile
order: two runs' dq, dk and dv agree bit for bit.
The forward's lse (log2 units, magnitude about log2 N plus the largest
logit) within 1e-4 plus 1e-5 relative of the plain lse: both sum the same
fp32 exponentials in another order, the kernel's by ex2.approx.

fp32 (the configs' other compute dtype): forwards within F32_FWD (2e-5) of
the output's largest |value| (fp32 sums in another order, exp2f), backwards
within relative L2 F32_BWD (1e-4) per output, against the plain fp32
versions with TF32 off. ``dense`` in bf16 with an fp32 bias: within half a
bf16 ulp (beyond 2^-14 of the terms' magnitude, for the fp32 sums) of the
fp64 product plus bias, where a bias rounded to bf16 first reads above.
``int8_dense`` (the w8a8 linear): bit for bit its plain version, an exact
int32 product and the same fp32 dequant operations, each rounded once.
#3's backward kernel: ``chip_smoke.fnm_bwd_check`` (fp32 outputs within
relative L2 1e-5 of the plain backward; bf16 outputs within one bf16 ulp
in all but 1e-3 of the elements; each no farther from the fp64 backward
than the plain version is), and two runs bit for bit equal (its column
sums take a fixed order).
"""

import re

import pytest
import torch

from ldmae_tpu_torch.ops import flash_attention as tfa
from ldmae_tpu_torch.ops import fused_adaln as tfad
from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

BF16_TOL = dict(rtol=2**-6, atol=2**-6)
BWD_REL_L2, BWD_ELEM = 1e-2, 2e-2  # readings on an H100: 0.0025-0.0028 and <= 0.0065
F32_FWD, F32_BWD = 2e-5, 1e-4
# head dims of the registries' archs the kernels once refused (VMAE 8, 12,
# 24, 32, 80; DiT XL 72 aside), an odd one, and the largest class
ANY_HEAD_DIMS = [5, 8, 12, 24, 32, 36, 80, 128]


def _attn_tol(ref):
    return dict(rtol=2**-7, atol=2**-8 * float(ref.float().abs().max()))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # fp32 plain versions in full fp32 (these are PyTorch's defaults for
    # matmuls; convolutions are not compared here)
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16(shape, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "d,n,rope",
    [(64, 1024, True), (64, 256, True), (64, 1000, True), (16, 1024, False), (16, 1025, False),
     (16, 1000, False), (72, 200, True), (72, 1024, True), (72, 1024, False), (72, 1000, False)],
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
    q = _bf16((1, 2, 64, 136), 0, cuda)  # head dim above the largest class, 128
    with pytest.raises(ValueError, match="head dim"):
        tfa.flash_attention(q, q, q)
    q = _bf16((1, 2, 64, 48), 0, cuda)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tfa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="bf16 or fp32"):
        tfad.fused_norm_modulate(q.half()[0], None, q.half()[0, :, 0], q.half()[0, :, 0])


def _assert_route(fn, d, aligned):
    """fn's attention ran on the wgmma forward at d = 64 or 72 with 16-byte
    aligned operands, else on the mma.sync core (by kernel name)."""
    wgmma = d in tfa.WGMMA_HEAD_DIMS and aligned

    def route(names):
        return (any("flash_fwd_wgmma_kernel" in k for k in names) == wgmma
                and any("flash_fwd_kernel" in k for k in names) == (not wgmma))

    names, _ = _kernel_names(fn, need=route)
    assert any("flash_fwd_wgmma_kernel" in k for k in names) == wgmma, names
    assert any("flash_fwd_kernel" in k for k in names) == (not wgmma), names


# N = 64 (one tile), 200, 1000 and 1025 (ragged last tiles) with an odd b * h;
# q, k, v as the attention module's views of a packed qkv; v at an 8-byte
# offset takes the mma.sync core
@pytest.mark.gpu
@pytest.mark.parametrize("d,n,b,h,layout", [
    pytest.param(64, 1024, 2, 3, "contiguous", id="64-1024"), pytest.param(72, 200, 2, 3, "contiguous", id="72-200"),
    pytest.param(72, 1024, 2, 16, "views", id="72-1024-qkv-views"),
    *(pytest.param(64, n, 3, 5, "contiguous", id=f"64-{n}-odd") for n in (64, 200, 1000, 1025)),
    pytest.param(64, 1024, 2, 12, "views", id="64-1024-qkv-views"),
    pytest.param(64, 200, 1, 3, "views", id="64-200-qkv-views"),
    pytest.param(64, 256, 1, 3, "v8byte", id="64-256-v8byte"),
])
def test_cuda_flash_attention_qknorm_rope_vs_plain(cuda, d, n, b, h, layout):
    offset = 4 if layout == "v8byte" else 0
    q, k = (_bf16((b, h, n, d), s, cuda) for s in range(2))
    v = _bf16((offset + b * h * n * d,), 2, cuda)[offset:].view(b, h, n, d)
    if layout == "views":  # (B, N, 3, H, d) qkv, permuted as ops/attention.py does
        q, k, v = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).contiguous().permute(2, 0, 3, 1, 4).unbind(0)
    qs, ks = (1 + 0.1 * _bf16((d,), s, cuda).float() for s in (3, 4))
    grid = int(n**0.5) + 1
    cos, sin = (torch.from_numpy(to_half_layout(t)[:n]).to(cuda) for t in build_rope_table(d // 2, grid))
    out = tfa.flash_attention_qknorm_rope(q, k, v, qs, ks, cos, sin)
    ref = tfa.flash_attention_qknorm_rope_plain(q, k, v, qs, ks, cos, sin)
    assert out.shape == (b, h, n, d) and out.is_contiguous()
    torch.testing.assert_close(out.float(), ref.float(), **_attn_tol(ref))
    _assert_route(lambda: tfa.flash_attention_qknorm_rope(q, k, v, qs, ks, cos, sin), d, offset == 0)


# as above, and the packed qkv's rows padded past 3 H d (v's row stride)
@pytest.mark.gpu
@pytest.mark.parametrize("d,h,n,b,pad,offset", [
    pytest.param(64, 12, 1024, 2, 0, 0, id="64-12-1024"), pytest.param(72, 4, 200, 2, 0, 0, id="72-4-200"),
    pytest.param(72, 16, 1024, 2, 0, 0, id="72-16-1024"),
    *(pytest.param(64, 5, n, 1, 0, 0, id=f"64-5-{n}-odd") for n in (64, 200, 1000, 1025)),
    pytest.param(64, 12, 1024, 2, 8, 0, id="64-12-1024-padded"),
    pytest.param(64, 4, 256, 1, 0, 4, id="64-4-256-v8byte"),
])
def test_cuda_flash_attention_fused_rope_vs_plain(cuda, d, h, n, b, pad, offset):
    """q, k normed copies in the (B, N, H, d) layout, v a strided view of the
    packed qkv, as the attention module passes them (with an offset, a view
    of another qkv at an 8-byte aligned base)."""
    hd, row = h * d, 3 * h * d + pad
    qkv = _bf16((b * n * row,), 0, cuda).view(b, n, row)
    q, k = qkv[..., :hd].view(b, n, h, d).contiguous(), qkv[..., hd:2 * hd].view(b, n, h, d)
    vsrc = qkv if offset == 0 else _bf16((offset + b * n * row,), 1, cuda)[offset:].view(b, n, row)
    v = vsrc[..., 2 * hd:3 * hd].view(b, n, h, d)
    assert v.stride(1) == row
    grid = int(n**0.5) + 1
    cos, sin = (torch.from_numpy(to_half_layout(t)[:n]).to(cuda) for t in build_rope_table(d // 2, grid))
    out = tfa.flash_attention_fused_rope(q, k, v, cos, sin)
    ref = tfa.flash_attention_fused_rope_plain(q, k, v, cos, sin)
    assert out.shape == (b, n, h, d) and out.is_contiguous()
    torch.testing.assert_close(out.float(), ref.float(), **_attn_tol(ref))
    _assert_route(lambda: tfa.flash_attention_fused_rope(q, k, v, cos, sin), d, offset == 0)


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


# b, h, d, n: the single pass (d = 64, 72) at ragged and whole tiles of 64
# queries and 128 keys, and at the DiT B/1 and XL training shapes; the three
# passes (d = 16)
_BWD_CASES = [(2, 3, 16, 1024), (2, 3, 64, 1024), (2, 3, 72, 200), (2, 3, 64, 1000), (2, 3, 16, 200),
              (2, 3, 64, 64), (2, 3, 64, 128), (2, 3, 64, 200), (2, 3, 64, 256), (32, 12, 64, 1024),
              (2, 3, 72, 1024), (2, 3, 72, 1000), (32, 16, 72, 1024)]


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
    if d in tfa.WGMMA_HEAD_DIMS:  # the residuals passed in, as the autograd Functions pass them
        out, lse = tfa._launch(q, k, v, "test", *tables, with_lse=True)
        kernel = tfa.flash_attention_rope_bwd if rope else tfa.flash_attention_bwd
        _assert_bwd_close(kernel(q, k, v, g, *tables, out=out, lse=lse), refs)


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("n", [64, 200, 1024])
def test_cuda_forward_lse_vs_plain(cuda, n, rope):
    """The d = 64 forward's lse against the plain lse of the same (rotated,
    bf16-rounded) q and k; the output is the forward without lse's."""
    _check_forward_lse((2, 3, n, 64), rope, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("b,h,n", [(2, 3, 200), (2, 3, 1024), (16, 16, 1024)])
def test_cuda_forward_lse_vs_plain_d72(cuda, b, h, n, rope):
    """As above at DiT XL's head dim 72 (the wgmma forward on its two swizzle
    parts), up to XL's sampling shape (16, 16, 1024, 72): the output within
    the attention tolerance of the plain version, the lse as above."""
    q, k, v, tables, out = _check_forward_lse((b, h, n, 72), rope, cuda)
    ref = tfa.flash_attention_rope_plain(q, k, v, *tables) if rope else tfa.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **_attn_tol(ref))


def _check_forward_lse(shape, rope, device):
    """The lse checks above; returns the inputs, tables and output."""
    (q, k, v, _), tables = _bwd_inputs(shape, rope, device)
    out, lse = tfa._launch(q, k, v, "test", *tables, with_lse=True)
    qr, kr = (tfa._rope_fp32(t, *tables) for t in (q, k)) if rope else (q, k)
    assert lse.shape == shape[:3] and lse.dtype == torch.float32
    torch.testing.assert_close(lse, tfa.flash_attention_lse_plain(qr, kr), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(out, tfa._launch(q, k, v, "test", *tables), rtol=0, atol=0)
    return q, k, v, tables, out


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
def test_cuda_bwd_dq_run_to_run(cuda, rope):
    """dq is summed over key tiles in key-tile order, dk and dv are written
    once: two runs agree bit for bit."""
    _check_dq_run_to_run((4, 12, 1024, 64), rope, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
def test_cuda_bwd_dq_run_to_run_d72(cuda, rope):
    """As above at head dim 72, where dq's columns 64-71 of a key tile's two
    consumer warpgroups are added together before their one reduction."""
    _check_dq_run_to_run((4, 16, 1024, 72), rope, cuda)


def _check_dq_run_to_run(shape, rope, device):
    (q, k, v, g), tables = _bwd_inputs(shape, rope, device)
    out, lse = tfa._launch(q, k, v, "test", *tables, with_lse=True)
    kernel = tfa.flash_attention_rope_bwd if rope else tfa.flash_attention_bwd
    first = kernel(q, k, v, g, *tables, out=out, lse=lse)
    second = kernel(q, k, v, g, *tables, out=out, lse=lse)
    torch.cuda.synchronize()
    for a_, b_ in zip(first, second):
        torch.testing.assert_close(a_, b_, rtol=0, atol=0)


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


_MARKER_N = 12345  # a fill of this many elements: a kernel no test function launches


def _traced_names(fn) -> list:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.empty(_MARKER_N, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        marker.fill_(0.0)
        fn()
        marker.fill_(1.0)
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def _kernel_names(fn, attempts: int = 3, need=None) -> tuple:
    """(names of the device kernels that ``fn`` launches, by torch.profiler,
    and how many times ``fn`` was called).

    CUPTI hands the profiler its device records in buffers, asynchronously,
    and a trace has come back with none at all (PERF.md, PR 12): then the
    trace says nothing of which kernels ran. So a marker kernel is launched
    after ``fn`` and the device synchronised before the session closes; a
    trace without any device record but the marker's is taken again (``fn``
    must be callable again), at most ``attempts`` times in all. A trace with
    other device records is returned whole, whatever it holds. In a long
    pytest process traces have also come back without the session's first
    kernel record (PERF.md), so the marker also runs first. With ``need``
    (a test of the names) a trace that fails it is taken again too, as
    ``chip_smoke.device_split`` does: late in a long process traces have come
    back with only the last of ``fn``'s kernels (PERF.md)."""
    for calls in range(1, attempts + 1):
        names = _traced_names(fn)
        if any("FillFunctor" not in name for name in names) and (need is None or need(names)):
            return names, calls
    return names, calls


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
def test_cuda_autograd_backward_at_d64_is_one_pass(cuda, rope):
    """At d = 64 the autograd Functions save the forward's output and lse and
    pass them to the backward, which launches the preprocess, the single-pass
    kernel and the postprocess (and for RoPE its pre-pass), and no forward or
    statistics pass: one counted backward launch, no counted forward."""
    _check_one_pass((2, 4, 256, 64), rope, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
def test_cuda_autograd_backward_at_d72_is_one_pass(cuda, rope):
    """As above at DiT XL's head dim 72 and N = 1024: no mma.sync forward and
    none of the three passes' kernels run, the gradients within the
    backward's bounds of the plain backward."""
    _check_one_pass((2, 4, 1024, 72), rope, cuda)


def _check_one_pass(shape, rope, device):
    n, d = shape[-2:]
    q, k, v = (_bf16(shape, s, device).requires_grad_() for s in range(3))
    g = _bf16(shape, 3, device)
    cos, sin = _rope_tables(d, n, device)
    out = tfa.flash_attention_rope(q, k, v, cos, sin) if rope else tfa.flash_attention(q, k, v)
    saved = out.grad_fn.saved_tensors
    ref_lse = tfa._launch(q.detach(), k.detach(), v.detach(), "test", *((cos, sin) if rope else ()),
                          with_lse=True)[1]
    torch.testing.assert_close(saved[-1], ref_lse, rtol=0, atol=0)
    torch.testing.assert_close(saved[-2], out.detach(), rtol=0, atol=0)
    fwd = tfa.flash_attention_rope if rope else tfa.flash_attention
    bwd = tfa.flash_attention_rope_bwd if rope else tfa.flash_attention_bwd
    counts = fwd.launches, bwd.launches
    want = sorted(["flash_bwd_postprocess_kernel", "flash_bwd_preprocess_kernel", "flash_bwd_wgmma_kernel"]
                  + (["norm_rope_kernel"] if rope else []))

    def ours(names):
        return sorted(m.group(1) for n in names if (m := re.search(r"(flash_\w+_kernel|norm_rope_kernel)", n)))

    names, calls = _kernel_names(lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True),
                                 need=lambda names: ours(names) == want)
    assert (fwd.launches, bwd.launches) == (counts[0], counts[1] + calls)
    assert ours(names) == want, names
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    refs = (tfa.flash_attention_rope_bwd_plain(qd, kd, vd, g, cos, sin) if rope
            else tfa.flash_attention_bwd_plain(qd, kd, vd, g))
    _assert_bwd_close(torch.autograd.grad(out, (q, k, v), g), refs)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_cuda_fused_norm_modulate_function_backward(cuda, kind):
    """The differentiable fused_norm_modulate on CUDA tensors: the forward
    kernel and the backward kernel run (counted), and the gradients agree
    with fused_norm_modulate_bwd's and fp64's (``chip_smoke.fnm_bwd_check``:
    the kernel sums in another fp32 order); the control, that check with
    shift and scale swapped, must fail."""
    import chip_smoke

    x = (_bf16((4, 256, 768), 0, cuda) * 3).requires_grad_()
    w = (1 + 0.1 * _bf16((768,), 1, cuda).float()).requires_grad_()
    ada = (_bf16((4, 6, 768), 2, cuda) * 0.1).requires_grad_()
    g = _bf16((4, 256, 768), 3, cuda)
    before = (tfad.fused_norm_modulate.launches, tfad.fused_norm_modulate_bwd_kernel.launches)
    out = tfad.fused_norm_modulate(x, w, ada[:, 0], ada[:, 1], kind=kind)
    dx, dw, dada = torch.autograd.grad(out, (x, w, ada), g)
    assert (tfad.fused_norm_modulate.launches, tfad.fused_norm_modulate_bwd_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    xd, wd, sh, sc = x.detach(), w.detach(), ada[:, 0].detach(), ada[:, 1].detach()
    grads = (dx, dw, dada[:, 0], dada[:, 1])
    ok, read = chip_smoke.fnm_bwd_check(grads, xd, wd, sh, sc, g, kind)
    assert ok, read
    assert not chip_smoke.fnm_bwd_check(grads, xd, wd, sc, sh, g, kind)[0]


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


# (B, N) of the row-engine tests: rows ragged against every tile, one row,
# fewer rows than the SMs, and bench.py's batch 36 CFG-doubled
ROW_COUNTS = [(4, 256), (16, 200), (1, 1), (3, 7), (1, 100), (72, 1024)]


def _six_views(ada):
    """(shift, scale) pairs covering each of the six strided (B, D) views of
    the adaLN projection's (B, 6, D) output as shift and as scale."""
    return [(ada[:, k], ada[:, (k + 1) % 6]) for k in range(6)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("b,n", ROW_COUNTS)
def test_cuda_fused_norm_modulate_quant_vs_plain(cuda, kind, b, n):
    """#9 (and #3 beside it) at ragged, tiny and large row counts, shift and
    scale as every strided view of the adaLN projection's output."""
    x = _bf16((b, n, 768), 0, cuda) * 3
    w = 1 + 0.1 * _bf16((768,), 1, cuda).float()
    ada = _bf16((b, 6, 768), 2, cuda) * 0.1
    for sh, sc in _six_views(ada):
        _assert_quant_close(tfad.fused_norm_modulate_quant(x, w, sh, sc, kind=kind),
                            tfad.fused_norm_modulate_quant_plain(x, w, sh, sc, kind=kind))
        torch.testing.assert_close(tfad.fused_norm_modulate(x, w, sh, sc, kind=kind).float(),
                                   tfad.fused_norm_modulate_plain(x, w, sh, sc, kind=kind).float(), **BF16_TOL)


@pytest.mark.gpu
def test_cuda_row_kernels_launch_on_the_current_stream(cuda):
    """The wrappers launch on the caller's current stream (read as a raw
    handle by ``kernels.on_device``): on a side stream, x is written after a
    long spin, so a launch on any other stream would read it unwritten."""
    src = _bf16((16, 1024, 768), 0, cuda)
    w = 1 + 0.1 * _bf16((768,), 1, cuda).float()
    ada = _bf16((16, 6, 768), 2, cuda) * 0.1
    sh, sc = ada[:, 0], ada[:, 1]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(2e8))
        x = src * 3
        out = tfad.fused_norm_modulate(x, w, sh, sc)
        q = tfad.fused_norm_modulate_quant(x, w, sh, sc)
    side.synchronize()
    torch.testing.assert_close(out.float(), tfad.fused_norm_modulate_plain(x, w, sh, sc).float(), **BF16_TOL)
    _assert_quant_close(q, tfad.fused_norm_modulate_quant_plain(x, w, sh, sc))


def _near_half_row(absmax, d, seed):
    """d values whose quotients by the row scale max(absmax / 127, 1e-8)
    lie within 0-4 fp32 ulps of k + 0.5, with +-absmax among them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    a = torch.tensor(absmax, dtype=torch.float32)
    qs = torch.clamp_min(a / 127, 1e-8)
    t = (torch.randint(-127, 127, (d,), generator=g).float() + 0.5) * qs
    for _ in range(4):  # up to four ulps either way
        step = torch.randint(-1, 2, (d,), generator=g).float()
        t = torch.nextafter(t, t + step * torch.inf).where(step != 0, t)
    t = t.clamp(-a, a)
    t[:2] = torch.stack([a, -a])
    return t


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cuda_fused_norm_modulate_quant_int8_is_true_division_rounding(cuda, dtype):
    """x = 0 makes the normalised row 0, so o = shift exactly: #9's int8
    values (a reciprocal with a fix-up) are then bit for bit round(o / qs)
    by true division, and its scales max(absmax / 127, 1e-8), on rows whose
    quotients sit within a few ulps of half-integers, at qs's 1e-8 floor and
    on seeded normal rows."""
    d, n = 768, 4
    rows = [_near_half_row(a, d, i) for i, a in enumerate((3.0, 0.37, 117.0, 15.875, 1.2e-6))]
    rows += [_randn((d,), 5 + i, "cpu", torch.float32, s) for i, s in enumerate((0.05, 3.0))]
    sh = torch.stack(rows).to(dtype)  # bf16: rounded once here; o is then this row exactly
    b = len(rows)
    sc = _randn((b, d), 9, cuda, dtype, 0.3)
    x = torch.zeros(b, n, d, device=cuda, dtype=dtype)
    q, s = tfad.fused_norm_modulate_quant(x, None, sh.to(cuda), sc)
    torch.cuda.synchronize()
    o = sh.float().to(cuda)[:, None, :].expand(b, n, d)
    qs = torch.clamp_min(o.abs().amax(-1, keepdim=True) / 127, 1e-8)
    assert torch.equal(s, qs)
    assert torch.equal(q, torch.round(o / qs).to(torch.int8))


@pytest.mark.gpu
@pytest.mark.parametrize("h", [2048, 1000])
def test_cuda_fused_silu_mul_quant_vs_plain(cuda, h):
    x12 = _bf16((2, 512, 2 * h), 0, cuda) * 2
    _assert_quant_close(tfad.fused_silu_mul_quant(x12), tfad.fused_silu_mul_quant_plain(x12))


def _randn(shape, seed, device, dtype, scale=1.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(device=device, dtype=dtype)


def _assert_f32_close(out, ref, bound=F32_FWD):
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err <= bound, err


def _assert_f32_bwd_close(outs, refs):
    torch.cuda.synchronize()
    for name, out, ref in zip(("dq", "dk", "dv"), outs, refs):
        rel = float((out - ref).norm() / ref.norm())
        assert rel <= F32_BWD, (name, rel)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", ANY_HEAD_DIMS)
def test_cuda_flash_attention_any_head_dim(cuda, d, dtype):
    """The forward kernels (plain, RoPE, qk-norm + RoPE, and the fused rows)
    at every head-dim class and an odd d, N ragged against the 64-row tile."""
    n = 200
    q, k, v = (_randn((2, 3, n, d), s, cuda, dtype) for s in range(3))
    cos, sin = _rope_tables(d, n, cuda) if d % 2 == 0 else (
        _randn((n, d), 7, cuda, torch.float32), _randn((n, d), 8, cuda, torch.float32))
    qs, ks = (1 + 0.1 * _randn((d,), s, cuda, torch.float32) for s in (3, 4))
    cases = [
        (tfa.flash_attention(q, k, v), tfa.flash_attention_plain(q, k, v)),
        (tfa.flash_attention_rope(q, k, v, cos, sin), tfa.flash_attention_rope_plain(q, k, v, cos, sin)),
        (tfa.flash_attention_qknorm_rope(q, k, v, qs, ks, cos, sin),
         tfa.flash_attention_qknorm_rope_plain(q, k, v, qs, ks, cos, sin)),
    ]
    qkv = _randn((2, n, 3, 3, d), 5, cuda, dtype)
    qf, kf, vf = qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(), qkv[:, :, 2]
    cases.append((tfa.flash_attention_fused_rope(qf, kf, vf, cos, sin),
                  tfa.flash_attention_fused_rope_plain(qf, kf, vf, cos, sin)))
    for out, ref in cases:
        if dtype == torch.float32:
            _assert_f32_close(out, ref)
        else:
            torch.cuda.synchronize()
            torch.testing.assert_close(out.float(), ref.float(), **_attn_tol(ref))


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", ANY_HEAD_DIMS)
def test_cuda_flash_attention_bwd_any_head_dim(cuda, d, dtype, rope):
    """The backward (bf16: the three passes off d = 64 and 72; fp32: the fp32
    kernels, given the forward's output and lse or running it first), N
    ragged against the 64-row tile."""
    n = 200
    q, k, v, g = (_randn((2, 3, n, d), s, cuda, dtype) for s in range(4))
    tables = ((_rope_tables(d, n, cuda) if d % 2 == 0 else
               (_randn((n, d), 7, cuda, torch.float32), _randn((n, d), 8, cuda, torch.float32)))
              if rope else ())
    kernel = tfa.flash_attention_rope_bwd if rope else tfa.flash_attention_bwd
    plain = tfa.flash_attention_rope_bwd_plain if rope else tfa.flash_attention_bwd_plain
    refs = plain(q, k, v, g, *tables)
    outs = kernel(q, k, v, g, *tables)
    if dtype == torch.float32:
        _assert_f32_bwd_close(outs, refs)
        out, lse = tfa._launch(q, k, v, "test", *tables, with_lse=True)
        _assert_f32_bwd_close(kernel(q, k, v, g, *tables, out=out, lse=lse), refs)
    else:
        _assert_bwd_close(outs, refs)


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
def test_cuda_fp32_training_shape(cuda, rope):
    """fp32 forward and backward at the DiT B/1 training shape (32, 12, 1024,
    64), through the autograd Functions (the forward saves lse)."""
    shape = (32, 12, 1024, 64)
    q, k, v = (_randn(shape, s, cuda, torch.float32).requires_grad_() for s in range(3))
    g = _randn(shape, 3, cuda, torch.float32)
    tables = _rope_tables(64, 1024, cuda) if rope else ()
    fwd = tfa.flash_attention_rope if rope else tfa.flash_attention
    out = fwd(q, k, v, *tables)
    assert out.grad_fn.saved_tensors[-1].shape == shape[:3]  # lse
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    ref = tfa.flash_attention_rope_plain(qd, kd, vd, *tables) if rope else tfa.flash_attention_plain(qd, kd, vd)
    _assert_f32_close(out.detach(), ref)
    grads = torch.autograd.grad(out, (q, k, v), g)
    plain = tfa.flash_attention_rope_bwd_plain if rope else tfa.flash_attention_bwd_plain
    _assert_f32_bwd_close(grads, plain(qd, kd, vd, g, *tables))


# the fp32 forward on the tensor cores (3xTF32, ``tf32x3_fwd_kernel``) for
# #1, #2, #7 and #8: B/1's and XL/1's training shapes, the patch-2 archs' N
# = 256, a ragged N; #7 and #8 on views of a packed qkv at the sampling shape
_F32_FWD_SHAPES = [(32, 12, 1024, 64), (32, 16, 1024, 72), (32, 16, 256, 64), (2, 12, 1000, 64),
                   (2, 12, 1000, 72)]
_FWD_NAMES = ["flash_attention", "flash_attention_rope", "flash_attention_qknorm_rope", "flash_attention_fused_rope"]


# which fp32 kernels run, by torch.profiler: early in the file, since late
# in a long process traces have come back without some kernels' records
@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("d", [16, 64, 72, 128])
def test_cuda_fp32_bwd_kernels_by_head_dim(cuda, d, rope):
    """At d = 64 and 72 (the C dispatch's choice) the fp32 backward runs the
    tensor-core kernels and not the SIMT ones, at d = 16 and 128 the SIMT
    kernels; every one within F32_BWD of the plain backward (N ragged)."""
    args, kernel, plain = _f32_bwd_call((2, 12, 1000, d), rope, cuda)
    tc = d in (64, 72)
    want = {"flash32_bwd_preprocess_kernel"} | (
        {"tf32x3_bwd_dkdv_kernel", "tf32x3_bwd_dq_kernel"} if tc else {"flash32_bwd_dkdv_kernel", "flash32_bwd_dq_kernel"})

    def ours(names):
        return {m.group(1) for n in names if (m := re.search(r"((?:tf32x3|flash32)_bwd_\w+_kernel)", n))}

    names, _ = _kernel_names(lambda: kernel(*args), need=lambda names: ours(names) == want)
    assert ours(names) == want, names
    _assert_f32_bwd_close(kernel(*args), plain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("name", _FWD_NAMES)
@pytest.mark.parametrize("d,unaligned", [(16, False), (64, False), (72, False), (128, False), (64, True)],
                         ids=["16", "64", "72", "128", "64-unaligned"])
def test_cuda_fp32_fwd_kernel_by_head_dim(cuda, d, unaligned, name):
    """At d = 64 and 72 with 16-byte aligned rows (the C dispatch's choice)
    every fp32 forward runs the tensor-core kernel and not the SIMT one; at
    d = 16 and 128, and with v one float off a 16-byte boundary, the SIMT
    kernel; every one within F32_FWD of its plain version (N ragged)."""
    shape = (2, 12, 1000, d)
    if unaligned:
        b, h, n, _ = shape
        cos, sin = _rope_tables(d, n, cuda)
        q, k = (_randn(shape, s, cuda, torch.float32) for s in range(2))
        if name in ("flash_attention", "flash_attention_rope"):
            v = _randn((b * h * n * d + 1,), 2, cuda, torch.float32)[1:].view(shape)
        else:  # rows of a packed qkv padded by one float
            qkv = _randn((b, n, 3 * h * d + 1), 2, cuda, torch.float32)[..., :3 * h * d].unflatten(-1, (3, h, d))
            q, k, v = qkv.unbind(2) if name == "flash_attention_fused_rope" else qkv.permute(2, 0, 3, 1, 4).unbind(0)
        qs, ks = (1 + 0.1 * _randn((d,), s, cuda, torch.float32) for s in (3, 4))
        tab = {"flash_attention": (), "flash_attention_qknorm_rope": (qs, ks, cos, sin)}.get(name, (cos, sin))
        kernel = (lambda: getattr(tfa, name)(q, k, v, *tab))
        plain = (lambda: getattr(tfa, f"{name}_plain")(q, k, v, *tab))
    else:
        kernel, plain = _f32_fwd_call(name, shape, cuda)
    want = {"tf32x3_fwd_kernel"} if d in (64, 72) and not unaligned else {"flash32_fwd_kernel"}

    def ours(names):
        return {m.group(1) for n in names if (m := re.search(r"((?:tf32x3|flash32)_fwd_kernel)", n))}

    names, _ = _kernel_names(kernel, need=lambda names: ours(names) == want)
    assert ours(names) == want, names
    _assert_f32_close(kernel(), plain())


@pytest.mark.gpu
@pytest.mark.parametrize("b,n", [(8, 1024), (36, 1024), (2, 1025), (2, 1000), (2, 3072)])
@pytest.mark.parametrize("d", [16, 8])
def test_cuda_flash_attention_resident_vs_plain(cuda, b, n, d):
    """The resident d = 16 kernel (d = 8 padded) at the VMAE shapes, ragged
    N (a cls token, 1025; 1000) and the largest N it holds;
    flash_attention launches it without a gradient and the mma.sync core
    past RESIDENT_MAX_N."""
    q, k, v = (_bf16((b, 12, n, d), s, cuda) for s in range(3))
    ref = tfa.flash_attention_plain(q, k, v)
    out = tfa.flash_attention_resident(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **_attn_tol(ref))
    counts = tfa.flash_attention_resident.launches, tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v)
    assert (tfa.flash_attention_resident.launches, tfa.flash_attention.launches) == (counts[0] + 1, counts[1])
    torch.testing.assert_close(out.float(), ref.float(), **_attn_tol(ref))


@pytest.mark.gpu
def test_cuda_flash_attention_past_resident_n_runs_the_core(cuda):
    n = tfa.RESIDENT_MAX_N + 1
    q, k, v = (_bf16((1, 2, n, 16), s, cuda) for s in range(3))
    counts = tfa.flash_attention_resident.launches, tfa.flash_attention.launches
    out = tfa.flash_attention(q, k, v)
    assert (tfa.flash_attention_resident.launches, tfa.flash_attention.launches) == (counts[0], counts[1] + 1)
    ref = tfa.flash_attention_plain(q, k, v)
    torch.testing.assert_close(out.float(), ref.float(), **_attn_tol(ref))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("d", [64, 768, 1024, 1152, 1536, 1792])  # every width of the DiT registry
def test_cuda_fused_norm_modulate_registry_widths(cuda, d, kind):
    """#3 and #9 at every DiT registry width, in bf16 and fp32, at ragged
    and small row counts (one row; fewer rows than the SMs), shift and
    scale as every strided view of the adaLN projection's output."""
    for dtype in (torch.bfloat16, torch.float32):
        for b, n in ((2, 64), (16, 200), (1, 1), (3, 7), (1, 100)):
            x = _randn((b, n, d), 0, cuda, dtype, 3.0)
            w = 1 + 0.1 * _randn((d,), 1, cuda, torch.float32)
            ada = _randn((b, 6, d), 2, cuda, dtype, 0.1)
            for sh, sc in _six_views(ada):
                out = tfad.fused_norm_modulate(x, w, sh, sc, kind=kind)
                ref = tfad.fused_norm_modulate_plain(x, w, sh, sc, kind=kind)
                if dtype == torch.float32:
                    _assert_f32_close(out, ref)
                else:
                    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
                _assert_quant_close(tfad.fused_norm_modulate_quant(x, w, sh, sc, kind=kind),
                                    tfad.fused_norm_modulate_quant_plain(x, w, sh, sc, kind=kind))


@pytest.mark.gpu
def test_cuda_fp32_adaln_and_mlp_kernels(cuda):
    """#4 and #10 in fp32 at the B/1 sampling shapes (batch 8, CFG-doubled)."""
    x = _randn((16384, 768), 0, cuda, torch.float32)
    w12 = _randn((4096, 768), 1, cuda, torch.float32, 768**-0.5)
    b12 = _randn((4096,), 2, cuda, torch.float32, 0.1)
    _assert_f32_close(tfad.fused_matmul_silu(x, w12, b12), tfad.fused_matmul_silu_plain(x, w12, b12))
    x12 = _randn((16, 1024, 4096), 3, cuda, torch.float32, 2.0)
    _assert_quant_close(tfad.fused_silu_mul_quant(x12), tfad.fused_silu_mul_quant_plain(x12))


def dense_ulp_error(out, x, w, b):
    """max over the elements of (|out - exact| - 2^-14 sum |terms|) / ulp:
    exact = x w^T + b in fp64 on the same bf16 operands and fp32 bias, sum
    |terms| = |x| |w|^T + |b| (an allowance for the fp32 sums, which an
    exact value near 0, whose ulp is tiny, would otherwise read as a huge
    error), ulp the bf16 ulp of exact's binade. One rounding reads <= 0.5."""
    exact = x.double() @ w.double().t() + b.double()
    mag = x.double().abs() @ w.double().abs().t() + b.double().abs()
    ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0**-100))) - 7)
    return float((((out.double() - exact).abs() - 2.0**-14 * mag) / ulp).max())


# the B/1 shapes (batch 8 under CFG: qkv, proj, w3, the adaLN linear's 16
# rows, the final layer's 16 columns), the VMAE decoder's (qkv 576 wide,
# from_latent's depth 16), the patch-14 head's 588 columns and a patch-14
# embedding's depth 588 (ragged N and K), a small odd shape; then every
# configuration the C entry picks by (M, N): M from one row to the training
# shape's tokens across N from 8 to the adaLN linear's 4,608
_DENSE_SHAPES = [(16384, 768, 2304), (16384, 768, 768), (16384, 2048, 768), (16, 768, 4608), (16384, 768, 16),
                 (8192, 192, 576), (8192, 16, 192), (2048, 512, 588), (512, 588, 1280), (333, 100, 7)]
_DENSE_SHAPES += [(m, 768, n) for m in (1, 16, 17, 8192, 32768) for n in (8, 16, 588, 1536, 4608)]
_DENSE_SHAPES += [(72, 768, 4608), (128, 768, 1536), (129, 768, 1536)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", _DENSE_SHAPES)
def test_cuda_dense_fp32_bias_rounds_once(cuda, m, k, n):
    """``dense`` in bf16 with an fp32 bias: the fp32 product plus the fp32
    bias rounded once, within half a bf16 ulp of fp64 math on the same
    operands (``dense_ulp_error``); the bias rounded to bf16 first (a bf16
    F.linear, the port's dense before) reads above 0.6, over at least 512
    rows of x (where m is smaller, 512 rows from the same seed with the same
    w and b), so that some element shows it where the output has few."""
    from ldmae_tpu_torch.ops import dense
    import torch.nn.functional as F

    x = _bf16((m, k), 0, cuda)
    w = (_bf16((n, k), 1, cuda).float() * k**-0.5).bfloat16()
    b = _randn((n,), 2, cuda, torch.float32)
    err = dense_ulp_error(dense(x, w, b), x, w, b)
    assert err <= 0.5, err
    xc = x if m >= 512 else _bf16((512, k), 0, cuda)
    assert dense_ulp_error(F.linear(xc, w, b.bfloat16()), xc, w, b) > 0.6


def _int8_linear(m, k, n, seed, device, bias=True):
    """int8 x_q (m, k) with fp32 row scales, and a QLinear (n, k) with
    per-column scales and an fp32 bias (or none), at the magnitudes of the
    w8a8 leg (scales ~1e-2 and ~1e-3)."""
    from ldmae_tpu_torch.ops.quant import QLinear

    g = torch.Generator(device="cpu").manual_seed(seed)
    x_q = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    xs = torch.rand(m, 1, generator=g) * 1e-2 + 1e-4
    w_q = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    ws = torch.rand(n, generator=g) * 1e-3 + 1e-5
    b = torch.randn(n, generator=g) if bias else None
    p = QLinear(w_q.to(device), ws.to(device), None if b is None else b.to(device))
    return x_q.to(device), xs.to(device), p


def _assert_int8_dense_bitwise(x_q, xs, p, dtype):
    """int8_dense equal bit for bit to its plain version (on the card where
    torch._int_mm takes the shape, K and N multiples of 8, else on the CPU)."""
    from ldmae_tpu_torch.ops.quant import QLinear, int8_dense, int8_dense_plain

    out = int8_dense(x_q, xs, p, dtype)
    k, n = x_q.shape[-1], p.w_q.shape[0]
    if k % 8 or n % 8:
        cpu = QLinear(p.w_q.cpu(), p.w_scale.cpu(), None if p.bias is None else p.bias.cpu())
        ref = int8_dense_plain(x_q.cpu(), xs.cpu(), cpu, dtype).to(out.device)
    else:
        ref = int8_dense_plain(x_q, xs, p, dtype)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == ref.shape
    assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n,bias,dtype", [
    (16384, 768, 2304, True, torch.bfloat16),   # qkv at batch 8 under CFG
    (16384, 768, 4096, True, torch.bfloat16),   # w12
    (16384, 2048, 768, True, torch.bfloat16),   # w3
    (16, 768, 4608, True, torch.bfloat16),      # the adaLN linear
    (8192, 768, 2304, True, torch.bfloat16),    # qkv on a single-batch step
    (8, 768, 4608, True, torch.bfloat16),
    (72, 768, 4608, True, torch.bfloat16),      # the adaLN linear at batch 36
    (128, 768, 2304, True, torch.bfloat16),
    (16384, 768, 2304, False, torch.bfloat16),  # no bias
    (16384, 768, 2304, True, torch.float32),    # compute_dtype float32
    (16, 768, 4608, False, torch.float32),
    (333, 100, 7, True, torch.bfloat16),        # ragged M and N, K padded to 112
    (1, 48, 5, True, torch.float32),
    (200, 2730, 1000, True, torch.bfloat16),    # K padded, N past a 256-column unit
], ids=lambda v: str(v).replace("torch.", ""))
def test_cuda_int8_dense_bitwise_vs_plain(cuda, m, k, n, bias, dtype):
    """``int8_dense`` at the w8a8 path's shapes (B/1, batch 8 under CFG and
    single), without a bias, in fp32, and at ragged M, N and K: bit for bit
    the plain version."""
    _assert_int8_dense_bitwise(*_int8_linear(m, k, n, 0, cuda, bias), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 384, 768, 1024, 1152, 1536, 1792])  # every width of the DiT registry
def test_cuda_int8_dense_registry_widths(cuda, d):
    """The quantized linears of a DiT of width d (qkv, w12, w3 with SwiGLU's
    int(8/3 d) hidden width, the block adaLN's 16 rows), bit for bit."""
    hidden = int(2 / 3 * 4 * d)
    for i, (m, k, n) in enumerate(((512, d, 3 * d), (512, d, 2 * hidden), (512, hidden, d), (16, d, 6 * d))):
        _assert_int8_dense_bitwise(*_int8_linear(m, k, n, i, cuda), torch.bfloat16)


@pytest.mark.gpu
def test_cuda_qdense_launches_int8_dense_only(cuda):
    """On CUDA, qdense (w8a8) and qdense_pre launch int8_dense, never
    torch._int_mm, and the result is the plain version's."""
    from unittest import mock

    from ldmae_tpu_torch.ops import quant

    x_q, xs, p = _int8_linear(16, 768, 4608, 3, cuda)
    x = _bf16((2, 8, 768), 4, cuda)
    before = quant.int8_dense.launches
    with mock.patch.object(torch, "_int_mm", side_effect=AssertionError("torch._int_mm called")):
        out_pre = quant.qdense_pre(x_q, xs, p)
        out = quant.qdense(x, p, mode="w8a8")
    assert quant.int8_dense.launches == before + 2
    torch.testing.assert_close(out_pre, quant.int8_dense_plain(x_q, xs, p, torch.bfloat16), rtol=0, atol=0)
    x_q2, xs2 = quant._quantize_rows(x)
    torch.testing.assert_close(out, quant.int8_dense_plain(x_q2, xs2, p, torch.bfloat16), rtol=0, atol=0)
    with pytest.raises(ValueError):
        quant.int8_dense(x_q, xs, p, torch.float16)


@pytest.mark.gpu
def test_cuda_linear_kernels_launch_on_the_current_stream(cuda):
    """dense and int8_dense launch on the caller's current stream, as the
    row kernels do: their inputs are written on a side stream after a long
    spin."""
    from ldmae_tpu_torch.ops import dense
    from ldmae_tpu_torch.ops.quant import int8_dense, int8_dense_plain

    src = _bf16((16384, 768), 0, cuda)
    w = _bf16((768, 768), 1, cuda)
    b = _randn((768,), 2, cuda, torch.float32)
    x_q0, xs, p = _int8_linear(16384, 768, 2304, 3, cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        torch.cuda._sleep(int(2e8))
        x, x_q = src * 2, x_q0 + 0
        out = dense(x, w, b)
        q = int8_dense(x_q, xs, p, torch.bfloat16)
    side.synchronize()
    assert dense_ulp_error(out, x, w, b) <= 0.5
    assert torch.equal(q, int8_dense_plain(x_q, xs, p, torch.bfloat16))


@pytest.mark.gpu
def test_cuda_dense_backward_vs_fp64(cuda):
    """``dense``'s gradients in bf16 training (the autograd Function around
    the wgmma GEMM): dx and dw as bf16 products of g (within relative L2
    1e-2 of fp64 math on the same bf16 values), dbias the fp32 sum of g
    (within 1e-5 relative)."""
    from ldmae_tpu_torch.ops import dense

    x = _bf16((4, 256, 768), 0, cuda).requires_grad_()
    w = (_bf16((2304, 768), 1, cuda).float() * 768**-0.5).requires_grad_()
    b = _randn((2304,), 2, cuda, torch.float32).requires_grad_()
    g = _bf16((4, 256, 2304), 3, cuda)
    out = dense(x, w, b, compute_dtype=torch.bfloat16)
    dx, dw, db = torch.autograd.grad(out, (x, w, b), g)
    gd, xd, wd = g.double().reshape(-1, 2304), x.detach().double().reshape(-1, 768), w.detach().bfloat16().double()
    for got, ref in ((dx.reshape(-1, 768), gd @ wd), (dw, gd.t() @ xd)):
        assert float((got.double() - ref).norm() / ref.norm()) <= 1e-2
    assert db.dtype == torch.float32
    torch.testing.assert_close(db.double(), gd.sum(0), rtol=1e-5, atol=1e-5 * float(gd.abs().sum(0).max()))


# -- the extraction and evaluation slice ------------------------------------


@pytest.mark.gpu
def test_cuda_vmae_encode_flash_vs_xla(cuda):
    """The production VMAE encoder at 256^2 (1,024 tokens, head dim 16) in
    bf16 under ``flash`` (#2's resident kernel, 12 launches, and ``dense``)
    against ``xla`` on the card: moments within 5e-2 of their largest
    |value|, as the sampling comparisons hold latents."""
    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.models import VMAE, production_vmae_spec, seeded_init_

    vae = seeded_init_(VMAE(production_vmae_spec(256), device=cuda), 5)
    x = torch.rand(4, 3, 256, 256, generator=torch.Generator().manual_seed(6)).to(cuda) * 2 - 1
    ops.reset_launch_counts()
    flash = vae.ldmae_encode_moments(x, torch.bfloat16, "flash")
    counts = ops.launch_counts()
    xla = vae.ldmae_encode_moments(x, torch.bfloat16, "xla")
    assert counts["flash_attention_resident"] == 12 and counts["dense_bias_f32"] == 1 + 4 * 12 + 1
    assert flash.shape == (4, 32, 32, 32) and torch.isfinite(flash).all()
    assert float((flash - xla).abs().max() / xla.abs().max()) <= 5e-2


def _tf32_conv(monkeypatch, module):
    """The module's float32 convolutions in TF32 (the control)."""
    import torch.nn.functional as F

    def conv(x, w, bias=None, **kw):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            return F.conv2d(x.float(), w.float(), None if bias is None else bias.float(), **kw)

    monkeypatch.setattr(module, "conv2d_fp32", conv)


@pytest.mark.gpu
def test_cuda_inception_vs_cpu_and_tf32_control(cuda, monkeypatch):
    """The FID InceptionV3 on the card against its CPU path (seeded random
    weights, batch 4 at 256^2): pooled and sFID features within relative L2
    1e-5 with TF32 off; the same network with TF32 convolutions reads above
    that bound."""
    from ldmae_tpu_torch.models import inception as tinc

    sd = tinc.import_inception_torch_state_dict(tinc.random_inception_torch_state_dict())
    cpu, gpu = tinc.InceptionV3("cpu"), tinc.InceptionV3(cuda)
    cpu.load_state_dict(sd)
    gpu.load_state_dict(sd)
    x = torch.rand(4, 256, 256, 3, generator=torch.Generator().manual_seed(7))
    ref = cpu(x, return_spatial=True)

    def err():
        out = gpu(x.to(cuda), return_spatial=True)
        return max(float((o.cpu().double() - r.double()).norm() / r.double().norm()) for o, r in zip(out, ref))

    assert err() <= 1e-5
    _tf32_conv(monkeypatch, tinc)
    assert err() > 1e-5


@pytest.mark.gpu
def test_cuda_lpips_ssim_vs_cpu_and_tf32_control(cuda, monkeypatch):
    """LPIPS (VGG16, seeded random weights) at 256^2 against its CPU path with
    TF32 off: the five VGG feature maps within relative L2 1e-5 and the
    distances within 1e-5 of their largest value (readings on an H100:
    2.8e-6 and 1.5e-7); with TF32 convolutions both read above (1.2e-3 and
    4.1e-5). SSIM per image within 1e-6 of its CPU path: its depthwise
    window runs no TF32 kernel (the same 6e-8 with TF32 allowed)."""
    from ldmae_tpu_torch.eval import metrics
    from ldmae_tpu_torch.models import lpips as tlpips

    sd = tlpips.import_lpips_weights()
    cpu, gpu = tlpips.LPIPS("cpu"), tlpips.LPIPS(cuda)
    cpu.load_state_dict(sd)
    gpu.load_state_dict(sd)
    g = torch.Generator().manual_seed(8)
    x = torch.rand(4, 3, 256, 256, generator=g) * 2 - 1
    y = (x + 0.2 * torch.randn(x.shape, generator=g)).clamp(-1, 1)
    ref_l, ref_f = cpu(x, y), cpu.net(x)
    ref_s = metrics.ssim(x, y, data_range=(-1.0, 1.0), per_image=True)
    out_s = metrics.ssim(x.to(cuda), y.to(cuda), data_range=(-1.0, 1.0), per_image=True).cpu()
    assert float((out_s - ref_s).abs().max()) <= 1e-6

    def errs():
        with torch.no_grad():
            feats = gpu.net(x.to(cuda))
        feat = max(float((f.cpu() - r).norm() / r.norm()) for f, r in zip(feats, ref_f))
        return feat, float((gpu(x.to(cuda), y.to(cuda)).cpu() - ref_l).abs().max() / ref_l.abs().max())

    feat, dist = errs()
    assert feat <= 1e-5 and dist <= 1e-5
    _tf32_conv(monkeypatch, tlpips)
    feat, dist = errs()
    assert feat > 1e-5 and dist > 1e-5


@pytest.mark.gpu
def test_cuda_manifold_distances_vs_host(cuda, monkeypatch):
    """Precision/recall's k-NN radii on the card (float32 products, TF32
    off) within 1e-4 relative of the numpy path, and the same fractions;
    with TF32 products the radii read above that bound."""
    import contextlib

    from ldmae_tpu_torch.eval import evaluator

    g = torch.Generator().manual_seed(9)
    f1 = torch.rand(600, 2048, generator=g).numpy()
    f2 = (torch.rand(500, 2048, generator=g) + 0.02).numpy()
    host = evaluator.ManifoldEstimator(row_batch_size=256, col_batch_size=256)
    dev = evaluator.ManifoldEstimator(row_batch_size=256, col_batch_size=256, device=cuda)
    r1, r2 = host.manifold_radii(f1), host.manifold_radii(f2)
    assert float(abs(dev.manifold_radii(f1) / r1 - 1).max()) <= 1e-4
    ours, theirs = dev.evaluate_pr(f1, r1, f2, r2), host.evaluate_pr(f1, r1, f2, r2)
    assert [x.tolist() for x in ours] == [x.tolist() for x in theirs]

    @contextlib.contextmanager
    def tf32():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    monkeypatch.setattr(evaluator, "_fp32_matmul", tf32)
    assert float(abs(dev.manifold_radii(f1) / r1 - 1).max()) > 1e-4


# -- the VMAE training slice -------------------------------------------------


@pytest.mark.gpu
def test_cuda_conv2d_fp32_backward_vs_float64(cuda):
    """``conv2d_fp32`` under autograd (LPIPS's VGG16 shape and the VMAE
    smoother's): the output and the input, weight and bias gradients within
    relative L2 1e-5 of float64 math, TF32 off in the backward too; a
    convolution whose backward runs with cuDNN's default (TF32 allowed)
    reads above that bound."""
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops.conv import conv2d_fp32

    g = torch.Generator().manual_seed(10)
    for (n, cin, cout, hw) in ((4, 64, 128, 64), (8, 3, 3, 128)):
        x = torch.randn(n, cin, hw, hw, generator=g)
        w = torch.randn(cout, cin, 3, 3, generator=g) * (cin * 9) ** -0.5
        b = torch.randn(cout, generator=g)
        go = torch.randn(n, cout, hw, hw, generator=g)
        ref_in = [t.double().requires_grad_() for t in (x, w, b)]
        ref_out = F.conv2d(*ref_in, padding=1)
        refs = [ref_out.detach(), *torch.autograd.grad(ref_out, ref_in, go.double())]

        def errs(conv):
            ins = [t.to(cuda).requires_grad_() for t in (x, w, b)]
            out = conv(*ins)
            got = [out.detach(), *torch.autograd.grad(out, ins, go.to(cuda))]
            return [float((a.cpu().double() - r).norm() / r.norm()) for a, r in zip(got, refs)]

        assert max(errs(lambda x, w, b: conv2d_fp32(x, w, b, padding=1))) <= 1e-5

        def tf32_conv(x, w, b):
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
                return F.conv2d(x, w, b, padding=1)

        if cin > 3:  # the 3-channel smoother's products are too short to show TF32
            assert max(errs(tf32_conv)[1:3]) > 1e-5


def _vmae_grads(cuda, dtype, attn_impl, tune_decoder=False):
    """One micro-batch's gradients of the production VMAE at full width
    (depth 2 / 2) on the card, the recipe's stage-1 (128^2) or stage-3
    (256^2) flags with LPIPS on seeded random weights, fixed noise."""
    from ldmae_tpu_torch.models import VMAE, init_vmae_weights_, vmae_spec
    from ldmae_tpu_torch.models.lpips import LPIPS, import_lpips_weights, make_lpips_fn
    from ldmae_tpu_torch.train.train_vmae import vmae_loss

    size, kw = ((256, dict(kl_loss_weight=0.0, perceptual_loss_ratio=10.0, ldmae_mode=True)) if tune_decoder
                else (128, dict(kl_loss_weight=1e-6, fixed_std=1e-3, perceptual_loss_ratio=0.5)))
    spec = vmae_spec("mae_for_ldmae_f8d16_prev", img_size=size, depth=2, decoder_depth=2, no_cls=True,
                     smooth_output=True, **kw)
    model = init_vmae_weights_(VMAE(spec, device=cuda), torch.Generator().manual_seed(11))
    lp = LPIPS(cuda)
    lp.load_state_dict(import_lpips_weights())
    gen = torch.Generator().manual_seed(12)
    n_tok = spec.num_patches
    n_keep = n_tok if tune_decoder else int(n_tok * 0.75)
    x = torch.randint(0, 256, (4, size, size, 3), generator=gen, dtype=torch.uint8).to(cuda)
    noise = dict(mask_noise=torch.rand(4, n_tok, generator=gen).to(cuda),
                 latent_noise=torch.randn(4, 16, n_keep, generator=gen).to(cuda))
    out = vmae_loss(model, x, tune_decoder=tune_decoder, mask_ratio=0.0 if tune_decoder else 0.25,
                    visible_loss_ratio=0.75, perceptual_loss_fn=make_lpips_fn(lp), compute_dtype=dtype,
                    attn_impl=attn_impl, **noise)
    out["loss"].backward()
    return float(out["loss"]), {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}


def _worst_leaf(got, ref):
    assert got.keys() == ref.keys()
    return max(float((got[n] - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)) for n in ref)


@pytest.mark.gpu
@pytest.mark.parametrize("tune_decoder", [False, True], ids=["stage1", "stage3"])
def test_cuda_vmae_train_step_vs_plain(cuda, tune_decoder, monkeypatch):
    """One VMAE training micro-batch on the card against the plain path on
    the card: in fp32, the ``flash`` attention kernels (#2 and #5 at head dim
    16) against ``xla``, every gradient leaf within relative L2 1e-3 and the
    loss within 1e-5; in bf16 (the CLI's configuration), ``dense``'s kernel
    against its plain version (fp32 sums of the same bf16 values, the fp32
    bias, one rounding), every leaf within relative L2 1e-2."""
    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.ops import linear

    loss_x, g_x = _vmae_grads(cuda, torch.float32, "xla", tune_decoder)
    ops.reset_launch_counts()
    loss_f, g_f = _vmae_grads(cuda, torch.float32, "flash", tune_decoder)
    counts = ops.launch_counts()
    # fp32 has no resident kernel: stage 3's encoder (no gradient) runs the fp32 forward too
    assert counts["flash_attention"] == 4 and counts["flash_attention_bwd"] == (2 if tune_decoder else 4)
    assert abs(loss_f - loss_x) <= 1e-5 * abs(loss_x) and _worst_leaf(g_f, g_x) <= 1e-3

    ops.reset_launch_counts()
    loss_k, g_k = _vmae_grads(cuda, torch.bfloat16, "xla", tune_decoder)
    assert ops.launch_counts()["dense_bias_f32"] > 0

    def plain(x, weight, bias):
        return torch.nn.functional.linear(x.float(), weight.float(), bias).bfloat16()

    plain.launches = 0
    monkeypatch.setattr(linear, "dense_bias_f32", plain)
    loss_p, g_p = _vmae_grads(cuda, torch.bfloat16, "xla", tune_decoder)
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p) and _worst_leaf(g_k, g_p) <= 1e-2


def _conv_vae_pair(cuda, name):
    """A conv VAE of each spec cut to ch 64, ch_mult (1, 2, 2), 16 groups at
    64^2 (the VA-VAE's and MAR-VAE's attention at 16^2 in a level), seeded
    weights, on the CPU and on the card; seeded images."""
    import dataclasses

    from ldmae_tpu_torch.models import conv_vae as cv

    spec = dataclasses.replace(getattr(cv, f"{name}_spec")(), ch=64, ch_mult=(1, 2, 2), num_groups=16,
                               resolution=64)
    cpu = cv.init_conv_vae_weights_(cv.ConvVAE(spec, device="cpu"), torch.Generator().manual_seed(20))
    gpu = cv.ConvVAE(spec, device=cuda)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(21)) * 2 - 1
    return cpu, gpu, x


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sdvae", "vavae", "marvae"])
def test_cuda_conv_vae_vs_cpu_and_tf32_control(cuda, name, monkeypatch):
    """``encode_moments`` and ``decode`` on the card against the same
    module's float32 run on the CPU: within 1e-4 of the output's largest
    |value| (both float32, TF32 off: summation order only); with the
    convolutions in TF32 (cuDNN's default) the encode reads above it."""
    import torch.nn.functional as F

    from ldmae_tpu_torch.models import conv_vae as cv

    cpu, gpu, x = _conv_vae_pair(cuda, name)
    ref_m = cpu.encode_moments(x)
    z = ref_m[:, :cpu.spec.embed_dim]
    ref_d = cpu.decode(z)

    def err(out, ref):
        return float((out.cpu() - ref).abs().max() / ref.abs().max())

    assert err(gpu.encode_moments(x.to(cuda)), ref_m) <= 1e-4
    assert err(gpu.decode(z.to(cuda)), ref_d) <= 1e-4

    def tf32_conv(x, w, bias=None, **kw):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            return F.conv2d(x.float(), w.float(), bias, **kw)

    monkeypatch.setattr(cv, "conv2d_fp32", tf32_conv)
    assert err(gpu.encode_moments(x.to(cuda)), ref_m) > 1e-4


@pytest.mark.gpu
def test_cuda_conv_vae_runs_no_tf32_convolution(cuda, monkeypatch):
    """Every convolution of the conv VAE's encode and decode runs with
    cuDNN's TF32 off (counted at ``F.conv2d``)."""
    import torch.nn.functional as F

    _, gpu, x = _conv_vae_pair(cuda, "vavae")
    real, calls = F.conv2d, []

    def conv2d(*args, **kw):
        calls.append(torch.backends.cudnn.allow_tf32)
        return real(*args, **kw)

    monkeypatch.setattr(F, "conv2d", conv2d)
    gpu.decode(gpu.encode(x.to(cuda)).mode())
    assert len(calls) > 40 and not any(calls)


@pytest.mark.gpu
def test_cuda_gradual_vmae_micro_batch_vs_plain(cuda, monkeypatch):
    """One ``--gradual_resol`` micro-batch (the production arch at full
    width, depth 2 / 2, 128^2 at patch 4: 1,024 tokens either side of the
    token convolutions) on the card: in fp32 the ``flash`` kernels (#2 and
    #5 at head dim 16, 1,024 and 256 tokens) against ``xla``, every gradient
    leaf within relative L2 1e-3 and the loss within 1e-5; in bf16
    ``dense``'s kernel against its plain version, every leaf within 1e-2."""
    import dataclasses

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.models import vmae_spec
    from ldmae_tpu_torch.models.vmae_variants import GradualVMAE, init_gradual_weights_
    from ldmae_tpu_torch.ops import linear
    from ldmae_tpu_torch.train.train_vmae import vmae_loss

    spec = vmae_spec("mae_for_ldmae_f8d16_prev", img_size=128, depth=2, decoder_depth=2, no_cls=True,
                     smooth_output=True, kl_loss_weight=1e-6, fixed_std=1e-3)
    spec = dataclasses.replace(spec, patch_size=4)
    gen = torch.Generator().manual_seed(22)
    x = torch.randint(0, 256, (4, 128, 128, 3), generator=gen, dtype=torch.uint8).to(cuda)
    noise = dict(mask_noise=torch.rand(4, 1024, generator=gen).to(cuda),
                 latent_noise=torch.randn(4, 16, 256, generator=gen).to(cuda))

    def grads(dtype, attn_impl):
        model = init_gradual_weights_(GradualVMAE(spec, device=cuda), torch.Generator().manual_seed(23))
        out = vmae_loss(model, x, mask_ratio=0.25, visible_loss_ratio=0.75, compute_dtype=dtype,
                        attn_impl=attn_impl, **noise)
        out["loss"].backward()
        return float(out["loss"]), {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}

    loss_x, g_x = grads(torch.float32, "xla")
    ops.reset_launch_counts()
    loss_f, g_f = grads(torch.float32, "flash")
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 4 and counts["flash_attention_bwd"] == 4
    assert abs(loss_f - loss_x) <= 1e-5 * abs(loss_x) and _worst_leaf(g_f, g_x) <= 1e-3

    ops.reset_launch_counts()
    loss_k, g_k = grads(torch.bfloat16, "xla")
    assert ops.launch_counts()["dense_bias_f32"] > 0

    def plain(x, weight, bias):
        return torch.nn.functional.linear(x.float(), weight.float(), bias).bfloat16()

    plain.launches = 0
    monkeypatch.setattr(linear, "dense_bias_f32", plain)
    loss_p, g_p = grads(torch.bfloat16, "xla")
    assert abs(loss_k - loss_p) <= 1e-2 * abs(loss_p) and _worst_leaf(g_k, g_p) <= 1e-2


# ---------------------------------------------------------------------------
# the multi-process layer on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_cuda_two_ranks_on_one_card_resume_sampling_pixel_for_pixel(cuda, tmp_path):
    """Two ranks (gloo, LOCAL_RANK 0 each) through the sampling CLI on the
    card (LightningDiT-debug, VMAE f8d16 at 32^2, 3 steps, fid_num 10 at batch
    4); batch 2's PNGs deleted and resampled: the same pixels, the other
    batches untouched."""
    import os

    import numpy as np
    import yaml
    from PIL import Image

    from torch_mp_worker import REPO, spawn

    cfg = {"data": {"image_size": 32, "num_classes": 1000, "data_path": str(tmp_path / "none")},
           "vae": {"model_name": "vmae_f8d16", "weight_path": ""},
           "model": {"model_type": "LightningDiT-debug", "in_chans": 16},
           "train": {"exp_name": "mp", "output_dir": str(tmp_path / "out"), "global_seed": 3},
           "sample": {"num_sampling_steps": 3, "cfg_scale": 4.0, "per_proc_batch_size": 4, "fid_num": 10}}
    path = tmp_path / "mp.yaml"
    path.write_text(yaml.safe_dump(cfg))
    argv = [os.path.join(REPO, "tests", "torch_mp_worker.py"), "gloo_cli", "inference", "--config", str(path),
            "--skip_fid"]
    spawn([argv] * 2, env={"OMP_NUM_THREADS": "4"})
    (folder,) = [os.path.join(r, d) for r, ds, _ in os.walk(tmp_path / "out") for d in ds if d.startswith("light")]
    first = {f: np.asarray(Image.open(os.path.join(folder, f))) for f in os.listdir(folder) if f.endswith(".png")}
    assert sorted(first) == [f"{i:06d}.png" for i in range(10)]
    for i in range(4, 8):
        os.remove(os.path.join(folder, f"{i:06d}.png"))
    outs = spawn([argv] * 2)
    assert "[rank 1] batch 2/3" in outs[1] and "0 generated + 6 resumed" in outs[0]
    for f, img in first.items():
        np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(folder, f))), img, f)


@pytest.mark.gpu
def test_cuda_ddp_at_world_one_on_nccl_equals_the_plain_step(cuda, tmp_path):
    """Two steps of two micro-batches of 8 (a DiT of width 128 at 16 x 16
    tokens, bf16, the flash_rope / fused kernels, the noise drawn from the
    step's seed) without a process group and under DDP in an NCCL group of
    one: DDP's buckets average one rank's gradients, so the weights come out
    bit for bit the same."""
    import os

    from torch_mp_worker import REPO, spawn

    from ldmae_tpu_torch.models import lightningdit as tdit
    from ldmae_tpu_torch.models import seeded_init_

    g = torch.Generator().manual_seed(5)
    dims = dict(input_size=16, patch_size=1, in_channels=4, hidden_size=128, depth=2, num_heads=2, num_classes=10,
                class_dropout_prob=0.1, learn_sigma=False, use_qknorm=True, use_swiglu=True, use_rope=True,
                use_rmsnorm=True)
    sd = seeded_init_(tdit.LightningDiT(tdit.DiTSpec(**dims), device="cpu"), 4).state_dict()
    inp = dict(dims=dims, sd=sd, lr=1e-3, beta2=0.95, clip=1.0, accum=2,
               impls=dict(compute_dtype=torch.bfloat16, attn_impl="flash_rope", adaln_impl="fused",
                          rope_layout="half"),
               transport=dict(use_lognorm=True), x=torch.randn((2, 2, 8, 4, 16, 16), generator=g),
               y=torch.randint(0, 10, (2, 2, 8), generator=g))
    torch.save(inp, tmp_path / "inputs.pt")
    spawn([[os.path.join(REPO, "tests", "torch_mp_worker.py"), "nccl_dit_steps", str(tmp_path)]])
    out = torch.load(tmp_path / "nccl.pt")
    for k, v in out["plain"].items():
        torch.testing.assert_close(out["ddp"][k], v, rtol=0, atol=0, msg=k)


def _sampler_dit(device, seed=0):
    """A small DiT in the half RoPE layout (width 128, 2 heads of 64: the
    d = 64 wgmma kernels, #4's shape gate), seeded non-zero weights."""
    from ldmae_tpu_torch.models import LightningDiT, dit_spec, permute_qk_for_half_rope, seeded_init_

    spec = dit_spec("LightningDiT-debug", input_size=16, in_channels=16, num_classes=10, hidden_size=128,
                    num_heads=2, depth=2, use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True)
    dit = LightningDiT(spec, device=device)
    seeded_init_(dit, seed)
    dit.load_state_dict(permute_qk_for_half_rope(dit.state_dict(), spec))
    return spec, dit


@pytest.mark.gpu
def test_cuda_fused_matmul_silu_raises_under_autograd(cuda):
    x = torch.randn(2, 128, 128, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    w = torch.randn(256, 128, device=cuda)
    with pytest.raises(RuntimeError, match="forward only"):
        tfad.fused_matmul_silu(x, w, None)
    with torch.no_grad():
        out = tfad.fused_matmul_silu(x, w, None)
    torch.testing.assert_close(out.float(), tfad.fused_matmul_silu_plain(x.detach(), w, None).float(), **BF16_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("leg", ["sde_euler", "sde_heun", "rk4", "dopri5"])
def test_cuda_samplers_fp32_vs_cpu(cuda, leg):
    """The sampler legs in fp32 through the kernels on the card against the
    same leg on the CPU (plain versions), same z and SDE noise: within 1e-4
    of the latents' scale (fp32 summation order; the SDE legs 1e-3, as an
    SDE from t0 = 1e-3 grows a rounding by up to a few hundred times),
    dopri5 with the same accepted/rejected tally."""
    from ldmae_tpu_torch.eval.sampling import make_sample_fn
    from ldmae_tpu_torch.transport import adaptive, create_transport

    mode, method = {"sde_euler": ("SDE", "euler"), "sde_heun": ("SDE", "heun"), "rk4": ("ODE", "rk4"),
                    "dopri5": ("ODE", "dopri5")}[leg]
    transport = (create_transport("Linear", "noise", train_eps=1e-3, sample_eps=1e-3) if mode == "SDE"
                 else create_transport())
    g = torch.Generator().manual_seed(1)
    z = torch.randn(2, 16, 16, 16, generator=g)
    noise = [torch.randn(4, 16, 16, 16, generator=g) for _ in range(5)]
    out, tally = {}, {}
    for dev in ("cpu", cuda):
        spec, dit = _sampler_dit(dev)
        fn = make_sample_fn(spec, transport, num_steps=6, sampling_method=method, mode=mode, timestep_shift=0.3,
                            cfg_scale=4.0, cfg_interval=True, cfg_interval_start=0.1, compute_dtype=torch.float32,
                            attn_impl="flash_rope", rope_layout="half", adaln_impl="fused", mlp_impl="fused",
                            device=dev)
        adaptive.dopri5.accepted = adaptive.dopri5.rejected = 0
        kw = {"sde_noise": noise} if mode == "SDE" else {}
        out[str(dev)] = fn({"dit": dit, "vae": None}, torch.tensor([1, 7]), z=z, **kw).cpu()
        tally[str(dev)] = (adaptive.dopri5.accepted, adaptive.dopri5.rejected)
    ref = out["cpu"]
    assert float((out["cuda"] - ref).abs().max()) <= (1e-3 if mode == "SDE" else 1e-4) * float(ref.abs().max())
    assert tally["cuda"] == tally["cpu"]


@pytest.mark.gpu
def test_cuda_likelihood_through_the_backward_kernel(cuda):
    """The likelihood (fp32 state and compute) through flash_rope's
    forward and #6's backward and the fused adaLN, against the all-xla DiT
    on the card: logp within 1e-5 relative, the divergence integral within
    1e-3 of its scale; #6 launches once a layer a drift evaluation."""
    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.transport import create_transport
    from ldmae_tpu_torch.transport.adaptive import make_likelihood_fn, prior_logp

    spec, dit = _sampler_dit(cuda, seed=2)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 16, 16, generator=g).to(cuda)
    eps = (torch.randint(0, 2, x.shape, generator=g) * 2.0 - 1).to(cuda)
    fn = make_likelihood_fn(create_transport(), 3, "rk4")
    res = {}
    for impl in ("kernels", "xla"):
        kw = (dict(attn_impl="flash_rope", adaln_impl="fused", mlp_impl="xla") if impl == "kernels"
              else dict(attn_impl="xla", adaln_impl="xla", mlp_impl="xla"))
        ops.reset_launch_counts()
        logp, z = fn(x, lambda xx, t, y: dit(xx, t, y, compute_dtype=torch.float32, rope_layout="half", **kw),
                     eps=eps, module=dit, y=torch.tensor([1, 7], device=cuda))
        res[impl] = (logp, prior_logp(z) - logp, ops.launch_counts())
    (lk, dk, counts), (lx, dx, _) = res["kernels"], res["xla"]
    assert counts["flash_attention_rope_bwd"] == 2 * 4 * spec.depth  # 2 steps x 4 evaluations x depth
    assert counts["flash_attention_rope"] == 2 * 4 * spec.depth and counts["fused_matmul_silu"] == 0
    assert float(((lk - lx).abs() / lx.abs()).max()) <= 1e-5
    assert float((dk - dx).abs().max()) <= 1e-3 * float(dx.abs().max())
    assert all(p.requires_grad for p in dit.parameters())


# -- tensor parallelism's kernel pieces: the row-parallel partials and #10's halves


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(16384, 768, 1536), (16384, 2048, 1536), (8192, 85, 64), (333, 100, 7)],
                         ids=lambda v: str(v))
def test_cuda_row_parallel_partials(cuda, m, k, n):
    """``dense_f32_out``: bf16(out + bias) is ``dense_bias_f32`` bit for bit
    (the same mainloop and configuration), and out is the fp32 product
    within 1e-5 of its scale (another summation order); ``int8_dense_i32``
    is ``torch._int_mm`` bit for bit. At 1p0B/1's proj and w3 under tp 2,
    and at ragged shapes (K padded)."""
    from ldmae_tpu_torch.ops import linear as lin
    from ldmae_tpu_torch.ops import quant as qt

    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn(n, k, generator=g, device=cuda) * k**-0.5).to(torch.bfloat16)
    b = torch.randn(n, generator=g, device=cuda)
    out = lin.dense_f32_out(x, w)
    assert out.dtype == torch.float32 and lin.dense_f32_out.launches > 0
    assert torch.equal(out.add(b).to(torch.bfloat16), lin.dense_bias_f32(x, w, b))
    ref = lin.dense_f32_out_plain(x, w)
    assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    xq = torch.randint(-127, 128, (m, k), generator=g, device=cuda, dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=cuda, dtype=torch.int8)
    assert torch.equal(qt.int8_dense_i32(xq, wq), qt.int8_dense_i32(xq.cpu(), wq.cpu()).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
def test_cuda_silu_mul_halves_equal_fused_silu_mul_quant(cuda, dtype):
    """#10's two halves on two rank slices [x1_r | x2_r], around the max of
    their row maxima, equal #10 on the whole row bit for bit (1p0B/1's
    hidden 4,096 split in two)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    h = 2048
    x12 = (torch.randn(4096, 4 * h, generator=g, device=cuda) * 2).to(dtype)
    x1, x2 = x12[:, :2 * h], x12[:, 2 * h:]
    parts = [torch.cat([x1[:, r * h:(r + 1) * h], x2[:, r * h:(r + 1) * h]], 1).contiguous() for r in range(2)]
    amax = torch.maximum(*[tfad.silu_mul_amax(p) for p in parts])
    halves = [tfad.silu_mul_quant_scaled(p, amax) for p in parts]
    q, s = tfad.fused_silu_mul_quant(x12)
    assert torch.equal(torch.cat([hq for hq, _ in halves], 1), q)
    assert all(torch.equal(hs, s) for _, hs in halves)


# -- tensor parallelism in training: the row-parallel dense under autograd


@pytest.mark.gpu
def test_cuda_dense_row_parallel_backward_vs_plain(cuda):
    """``dense_row_parallel`` at group size 1 under autograd, at 1p0B/1's
    proj under tp 2 (K 768) with a batch-2 token count: the card's forward
    (``dense_f32_out``) and backward against its plain version on the same
    values on the CPU: dx and dw (bf16, another summation order) within two
    bf16 ulps of their scale, dbias (fp32 sums of the bf16 gradient) within
    1e-5 of its scale."""
    from ldmae_tpu_torch.ops import linear as lin

    g = torch.Generator(device=cuda).manual_seed(11)
    m, k, n = 2048, 768, 1536
    x = torch.randn(m, k, generator=g, device=cuda).to(torch.bfloat16)
    w = torch.randn(n, k, generator=g, device=cuda) * k**-0.5
    b = torch.randn(n, generator=g, device=cuda) * 0.1
    gout = torch.randn(m, n, generator=g, device=cuda).to(torch.bfloat16)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs, ws, bs = (t.detach().to(dev).requires_grad_(True) for t in (x, w, b))
        before = lin.dense_f32_out.launches
        out = lin.dense_row_parallel(xs, ws, bs, None, compute_dtype=torch.bfloat16)
        assert out.dtype == torch.bfloat16 and lin.dense_f32_out.launches == before + (dev.type == "cuda")
        out.backward(gout.to(dev))
        grads.append([t.grad.float().cpu() for t in (xs, ws, bs)])
    for name, got, ref in zip(("dx", "dw", "db"), *grads):
        tol = 1e-5 if name == "db" else 2**-6
        assert float((got - ref).abs().max()) <= tol * float(ref.abs().max()), name


@pytest.mark.gpu
def test_cuda_tp_forward_under_autograd_keeps_proj_w3_and_adaln_gradients(cuda):
    """A DiT block whose ``tp_group`` is a gloo group of one (so proj and w3
    run ``dense_row_parallel``, adaLN the gather): on the card under
    autograd every parameter of proj, w3 and adaLN takes a non-zero
    gradient, ``dense_f32_out`` launches, and the gradients equal the
    unsharded block's within 1e-5 relative L2 (the same products; dbias
    sums in another order)."""
    import socket

    import torch.distributed as dist

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.models import LightningDiT, dit_spec, seeded_init_
    from ldmae_tpu_torch.train import dit_loss
    from ldmae_tpu_torch.transport import create_transport

    spec = dit_spec("LightningDiT-B/1", depth=1, input_size=32, in_channels=16, use_qknorm=True, use_swiglu=True,
                    use_rope=True, use_rmsnorm=True)
    sd = seeded_init_(LightningDiT(spec, device="cpu"), 4).state_dict()
    gen = torch.Generator(device=cuda).manual_seed(2)
    x1, x0 = (torch.randn(2, 16, 32, 32, generator=gen, device=cuda) for _ in range(2))
    y, t = torch.tensor([3, 7], device=cuda), torch.tensor([0.3, 0.7], device=cuda)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        grads = []
        for group in (dist.group.WORLD, None):
            model = LightningDiT(spec, device=cuda)
            model.load_state_dict(sd)
            model.blocks[0].tp_group = group
            ops.reset_launch_counts()
            dit_loss(model, create_transport(use_lognorm=True), x1, y, x0=x0, t=t, drop_ids=torch.zeros_like(y),
                     compute_dtype=torch.bfloat16, attn_impl="flash_rope", adaln_impl="fused").backward()
            assert (ops.launch_counts()["dense_f32_out"] > 0) == (group is not None)
            grads.append({n: p.grad.float() for n, p in model.named_parameters()})
    finally:
        dist.destroy_process_group()
    for name, grad in grads[0].items():
        if any(part in name for part in ("attn.proj", "mlp.w3", "adaLN_modulation")):
            assert float(grad.abs().max()) > 0, name
        assert float((grad - grads[1][name]).norm()) <= 1e-5 * float(grads[1][name].norm()) + 1e-12, name


# -- the registry slice: every arch's shapes (L/2, XL/2, 1p6B/1 beside B/1, XL/1)

# #10's hidden widths H: the SwiGLU widths int(2/3 * 4D) of L (2,730) and
# 1p6B (4,778), no multiple of 8 (the realigning kernel), their
# halves at tp 2 (1,365, 2,389), and XL's 3,072 (the vector one)
REGISTRY_GATE_H = [1365, 2389, 2730, 3072, 4778]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("h", REGISTRY_GATE_H)
def test_cuda_gate_kernel_registry_swiglu_widths(cuda, h, dtype):
    """#10 and its two tp halves (``silu_mul_amax``; ``silu_mul_quant_scaled``
    given the plain amax) at each width, each launching its kernel, against
    their plain versions; the control, the plain version of x12 with x1 and
    x2 swapped, must fail the same gate."""
    x12 = _randn((4, 256, 2 * h), 0, cuda, dtype, 2.0)
    before = (tfad.fused_silu_mul_quant.launches, tfad.silu_mul_amax.launches, tfad.silu_mul_quant_scaled.launches)
    out = tfad.fused_silu_mul_quant(x12)
    amax = tfad.silu_mul_amax(x12)
    ref_amax = tfad.silu_mul_amax_plain(x12)
    scaled = tfad.silu_mul_quant_scaled(x12, ref_amax)
    after = (tfad.fused_silu_mul_quant.launches, tfad.silu_mul_amax.launches, tfad.silu_mul_quant_scaled.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    assert out[0].shape == scaled[0].shape == (4, 256, h) and amax.shape == (4, 256, 1)
    _assert_quant_close(out, tfad.fused_silu_mul_quant_plain(x12))
    torch.testing.assert_close(amax, ref_amax, rtol=1e-6, atol=0)
    _assert_quant_close(scaled, tfad.silu_mul_quant_scaled_plain(x12, ref_amax))
    swapped = torch.cat([x12[..., h:], x12[..., :h]], dim=-1)
    with pytest.raises(AssertionError):
        _assert_quant_close(out, tfad.fused_silu_mul_quant_plain(swapped))


@pytest.mark.gpu
@pytest.mark.parametrize("h", [2730, 4778])
def test_cuda_gate_halves_equal_the_whole_row_at_odd_rank_widths(cuda, h):
    """L's and 1p6B's rows split gate-aligned over two tp ranks (odd widths
    1,365 and 2,389 a rank): the halves' amax reduced with max, then each
    rank's int8 and scales, equal #10 on the whole row bit for bit."""
    x12 = _bf16((2, 1024, 2 * h), 3, cuda) * 2
    hr = h // 2
    slices = [torch.cat([x12[..., r * hr:(r + 1) * hr], x12[..., h + r * hr:h + (r + 1) * hr]], dim=-1)
              for r in range(2)]
    amax = torch.maximum(*(tfad.silu_mul_amax(s) for s in slices))
    parts = [tfad.silu_mul_quant_scaled(s, amax) for s in slices]
    q, s = tfad.fused_silu_mul_quant(x12)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([p[0] for p in parts], dim=-1), q)
    assert all(torch.equal(p[1], s) for p in parts)


@pytest.mark.gpu
def test_cuda_gate_kernel_takes_unaligned_bases(cuda):
    """An aligned width (2,048) whose x12 starts 2 bytes past an aligned base
    (a contiguous view at a storage offset) runs the realigning kernel
    (``silu_mul_quant_any_kernel``); its result is the plain version's."""
    h = 2048
    x12 = _bf16((1 + 512 * 2 * h,), 4, cuda)[1:].view(512, 2 * h)
    assert x12.data_ptr() % 16 == 2
    _assert_quant_close(tfad.fused_silu_mul_quant(x12), tfad.fused_silu_mul_quant_plain(x12))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 72])
def test_cuda_flash_attention_rope_at_patch2_tokens(cuda, d):
    """#1 at the patch-2 archs' 256 tokens and their batch-8 CFG shape, (16,
    16, 256, d): L/2 and B/2 at d = 64, XL/2 at d = 72; the control,
    attention without RoPE, must fail the same tolerance. (That these shapes
    run the wgmma forward ``chip_smoke.py``'s registry kernel phase checks,
    early in its process: late in a long pytest process the profiler has
    returned traces without any device record.)"""
    q, k, v = (_bf16((16, 16, 256, d), s, cuda) for s in range(3))
    cos, sin = _rope_tables(d, 256, cuda)
    out = tfa.flash_attention_rope(q, k, v, cos, sin)
    ref = tfa.flash_attention_rope_plain(q, k, v, cos, sin)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), **_attn_tol(ref))
    with pytest.raises(AssertionError):
        torch.testing.assert_close(out.float(), tfa.flash_attention_plain(q, k, v).float(), **_attn_tol(ref))


# (M, K, N) of the registry's linears that no B/1 or XL path has: L/2's w12
# (N = 5,460, no multiple of the epilogue's vector) and w3 (K = 2,730,
# padded), 1p6B/1's w12 (N = 9,556) and w3 (K = 4,778), M rows of a batch
_REGISTRY_LINEARS = [(4096, 1024, 5460), (4096, 2730, 1024), (1024, 1792, 9556), (1024, 4778, 1792)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", _REGISTRY_LINEARS)
def test_cuda_registry_linears_vs_plain(cuda, m, k, n):
    """``dense`` (bf16, fp32 bias) within half a bf16 ulp of fp64 math, its
    control the bias rounded to bf16 first (above 0.6); ``int8_dense`` bit for
    bit its plain version, its control the plain version with the column
    scales one fp32 ulp up (not equal)."""
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import dense
    from ldmae_tpu_torch.ops.quant import QLinear, int8_dense, int8_dense_plain

    x = _bf16((m, k), 0, cuda)
    w = (_bf16((n, k), 1, cuda).float() * k**-0.5).bfloat16()
    b = _randn((n,), 2, cuda, torch.float32)
    assert dense_ulp_error(dense(x, w, b), x, w, b) <= 0.5
    assert dense_ulp_error(F.linear(x, w, b.bfloat16()), x, w, b) > 0.6
    x_q, xs, p = _int8_linear(m, k, n, 3, cuda)
    _assert_int8_dense_bitwise(x_q, xs, p, torch.bfloat16)
    up = QLinear(p.w_q.cpu(), torch.nextafter(p.w_scale, torch.full_like(p.w_scale, 1.0)).cpu(), p.bias.cpu())
    assert not torch.equal(int8_dense(x_q, xs, p, torch.bfloat16).cpu(),
                           int8_dense_plain(x_q.cpu(), xs.cpu(), up, torch.bfloat16))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_cuda_fused_norm_modulate_quant_at_1p6b_width(cuda, kind):
    """#9 at 1p6B's width (D 1,792, the row engine's widest), on the w8a8
    path's batch-8 CFG shape (16, 1024, 1792), shift and scale as views of
    the adaLN projection; the control, the plain version with shift and
    scale swapped, must fail the same gate."""
    d = 1792
    x = _bf16((16, 1024, d), 0, cuda) * 3
    w = 1 + 0.1 * _bf16((d,), 1, cuda).float()
    ada = _bf16((16, 6, d), 2, cuda) * 0.1
    sh, sc = ada[:, 0], ada[:, 1]
    out = tfad.fused_norm_modulate_quant(x, w, sh, sc, kind=kind)
    _assert_quant_close(out, tfad.fused_norm_modulate_quant_plain(x, w, sh, sc, kind=kind))
    with pytest.raises(AssertionError):
        _assert_quant_close(out, tfad.fused_norm_modulate_quant_plain(x, w, sc, sh, kind=kind))


# -- the registry's training slice ------------------------------------------


def _wrong_bwd(q, k, v, g, cos=None, sin=None):
    """The backward the kernels must not match: without the rowsum term of
    ds (ds = p * dp), and under RoPE with the Jacobian applied untransposed
    (the forward rotation instead of its transpose)."""
    rope = cos is not None
    qr, kr = (tfa._rope_fp32(q, cos, sin), tfa._rope_fp32(k, cos, sin)) if rope else (q, k)
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = (t.float() for t in (qr, kr, v, g))
    p = torch.softmax(qf @ kf.transpose(-1, -2) * scale, dim=-1)
    ds = p * (gf @ vf.transpose(-1, -2))
    dq, dk, dv = ds @ kf * scale, ds.transpose(-1, -2) @ qf * scale, p.transpose(-1, -2) @ gf
    if rope:
        dq, dk = tfa._rotate_fp32(dq, cos, sin), tfa._rotate_fp32(dk, cos, sin)
    return dq, dk, dv


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("d", [64, 72])
def test_cuda_backward_at_patch2_tokens(cuda, d, rope):
    """#6 (rope) and #5 at the patch-2 archs' 256 tokens, (4, 16, 256, d):
    L/2 and B/2 at d = 64, XL/2 at 72. Each head has two 128-key tiles, so
    each query tile's dq is summed from two bulk reductions. Given the
    forward's output and lse as the autograd Functions pass them: within the
    backward bounds of the plain backward; dq, dk and dv equal from run to
    run; the control (no rowsum term; under RoPE also the
    Jacobian untransposed), with q and k at twice unit scale (peaked rows),
    must fail the same bounds."""
    shape = (4, 16, 256, d)
    (q, k, v, g), tables = _bwd_inputs(shape, rope, cuda)
    q, k = q * 2, k * 2
    out, lse = tfa._launch(q, k, v, "test", *tables, with_lse=True)
    kernel = tfa.flash_attention_rope_bwd if rope else tfa.flash_attention_bwd
    plain = tfa.flash_attention_rope_bwd_plain if rope else tfa.flash_attention_bwd_plain
    refs = plain(q, k, v, g, *tables)
    first = kernel(q, k, v, g, *tables, out=out, lse=lse)
    _assert_bwd_close(first, refs)
    second = kernel(q, k, v, g, *tables, out=out, lse=lse)
    torch.cuda.synchronize()
    assert all(torch.equal(a_, b_) for a_, b_ in zip(first, second))
    with pytest.raises(AssertionError):
        _assert_bwd_close(_wrong_bwd(q, k, v, g, *tables), refs)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1024, 1792])  # L's and 1p6B's widths
def test_cuda_fused_norm_modulate_function_backward_registry_widths(cuda, d):
    """#3's autograd Function at L's and 1p6B's widths on patch-2-sized rows:
    the forward kernel runs (counted) within BF16_TOL of its plain version,
    the gradients (the backward kernel's) agree with
    ``fused_norm_modulate_bwd``'s and fp64's (``chip_smoke.fnm_bwd_check``);
    the control, that check with shift and scale swapped, must fail."""
    import chip_smoke

    x = (_bf16((4, 256, d), 0, cuda) * 3).requires_grad_()
    w = (1 + 0.1 * _bf16((d,), 1, cuda).float()).requires_grad_()
    ada = (_bf16((4, 6, d), 2, cuda) * 0.1).requires_grad_()
    g = _bf16((4, 256, d), 3, cuda)
    before = tfad.fused_norm_modulate.launches
    out = tfad.fused_norm_modulate(x, w, ada[:, 0], ada[:, 1])
    assert tfad.fused_norm_modulate.launches == before + 1
    xd, wd, sh, sc = x.detach(), w.detach(), ada[:, 0].detach(), ada[:, 1].detach()
    torch.testing.assert_close(out.detach().float(), tfad.fused_norm_modulate_plain(xd, wd, sh, sc).float(),
                               **BF16_TOL)
    dx, dw, dada = torch.autograd.grad(out, (x, w, ada), g)
    grads = (dx, dw, dada[:, 0], dada[:, 1])
    ok, read = chip_smoke.fnm_bwd_check(grads, xd, wd, sh, sc, g)
    assert ok, read
    assert not chip_smoke.fnm_bwd_check(grads, xd, wd, sc, sh, g)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", _REGISTRY_LINEARS)
def test_cuda_dense_backward_at_registry_swiglu_widths(cuda, m, k, n):
    """``dense``'s autograd Function (``_DenseBiasF32``) at L's and 1p6B's
    SwiGLU linears, whose N (w12) or K (w3) is off a multiple of 8: the
    forward kernel runs (counted) on x and w padded to a K multiple of 8,
    the backward's cuBLAS products take the unpadded operands; dx and dw
    within relative L2 1e-2 of fp64 math on the same bf16 values, dbias the
    fp32 sum of g within 1e-5 (``test_cuda_dense_backward_vs_fp64``'s
    bounds); the control, a bf16 F.linear's dbias (g summed in bf16), must
    read above that bound."""
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import dense
    from ldmae_tpu_torch.ops import linear as tlin

    x = _bf16((m, k), 0, cuda).requires_grad_()
    w = (_bf16((n, k), 1, cuda).float() * k**-0.5).requires_grad_()
    b = _randn((n,), 2, cuda, torch.float32).requires_grad_()
    g = _bf16((m, n), 3, cuda)
    before = tlin.dense_bias_f32.launches
    dx, dw, db = torch.autograd.grad(dense(x, w, b, compute_dtype=torch.bfloat16), (x, w, b), g)
    assert tlin.dense_bias_f32.launches == before + 1
    gd, xd, wd = g.double(), x.detach().double(), w.detach().bfloat16().double()
    for got, ref in ((dx, gd @ wd), (dw, gd.t() @ xd)):
        assert float((got.double() - ref).norm() / ref.norm()) <= 1e-2
    assert db.dtype == torch.float32
    db_tol = dict(rtol=1e-5, atol=1e-5 * float(gd.abs().sum(0).max()))
    torch.testing.assert_close(db.double(), gd.sum(0), **db_tol)
    xb, wb, bb = (t.detach().bfloat16().requires_grad_() for t in (x, w, b))
    with pytest.raises(AssertionError):
        torch.testing.assert_close(torch.autograd.grad(F.linear(xb, wb, bb), bb, g)[0].double(), gd.sum(0), **db_tol)


@pytest.mark.gpu
def test_cuda_train_cli_step_at_l2_depth2(cuda, tmp_path, monkeypatch):
    """One ``cli.train_dit`` step of LightningDiT-L/2 (width 1,024, 16 heads
    of 64, SwiGLU 2,730, 256 tokens) cut to depth 2 in the model registry,
    on the training legs' YAML (``chip_smoke.train_yaml``: the shipped one's
    training sections, batch 32): exact launches (#1 2 a block, #3 4, #6 1,
    dense 5 + 9 a block), a finite loss and gradient norm; the control, the
    same step under rope_layout interleaved, launches #2 and #5 instead,
    exactly, so the half layout's counts do not hold there."""
    import math
    import os
    import sys

    import yaml

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.cli import train_dit
    from ldmae_tpu_torch.models import lightningdit

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    arch = "LightningDiT-L/2"
    monkeypatch.setitem(lightningdit._REGISTRY, arch, dict(lightningdit._REGISTRY[arch], depth=2))
    data = chip_smoke.write_latent_shards(str(tmp_path / "latents"))
    counts = {}
    for layout in ("half", "interleaved"):
        path = chip_smoke.train_yaml(str(tmp_path / f"{layout}.yaml"), arch, data, "", str(tmp_path), layout)
        cfg = yaml.safe_load(open(path))
        cfg["train"]["max_steps"] = 1
        cfg["parallel"]["rope_layout"] = layout
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        ops.reset_launch_counts()
        hist = train_dit.main(["--config", path])["history"]
        torch.cuda.synchronize()
        counts[layout] = ops.launch_counts()
        assert len(hist) == 1 and math.isfinite(hist[0]["loss"]) and math.isfinite(hist[0]["grad_norm"])
    for layout in counts:
        assert counts[layout] == chip_smoke._counts_of(layout, 1, 2), layout
    assert counts["interleaved"] != chip_smoke._counts_of("half", 1, 2)


# -- #3's backward kernel and #10's realigning kernel -------------------------

# D: the DiT registry's widths (B, L, XL, 1p0B, 1p6B)
FNM_BWD_WIDTHS = [768, 1024, 1152, 1536, 1792]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["rms", "rms_no_weight", "layer", "rms_fp32"])
@pytest.mark.parametrize("d", FNM_BWD_WIDTHS)
def test_cuda_fused_norm_modulate_backward_kernel(cuda, d, case):
    """#3's backward kernel (``fused_norm_modulate_bwd_kernel``, counted) at
    every registry width, bf16 and fp32, rms with and without a weight and
    layer: within ``chip_smoke.fnm_bwd_check`` of the plain backward and of
    fp64, two runs equal bit for bit; the control, shift and scale swapped,
    must fail the check."""
    import chip_smoke

    dtype = torch.float32 if case.endswith("fp32") else torch.bfloat16
    kind = "layer" if case == "layer" else "rms"
    x = _randn((4, 256, d), 0, cuda, dtype, 3.0)
    w = None if case == "rms_no_weight" else 1 + 0.1 * _randn((d,), 1, cuda, torch.float32)
    ada = _randn((4, 6, d), 2, cuda, dtype, 0.1)
    g = _randn((4, 256, d), 3, cuda, dtype)
    sh, sc = ada[:, 0], ada[:, 1]
    before = tfad.fused_norm_modulate_bwd_kernel.launches
    first = tfad.fused_norm_modulate_bwd_kernel(x, w, sh, sc, g, kind=kind)
    second = tfad.fused_norm_modulate_bwd_kernel(x, w, sh, sc, g, kind=kind)
    assert tfad.fused_norm_modulate_bwd_kernel.launches == before + 2
    torch.cuda.synchronize()
    ok, read = chip_smoke.fnm_bwd_check(first, x, w, sh, sc, g, kind)
    assert ok, read
    assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(first, second))
    assert not chip_smoke.fnm_bwd_check(first, x, w, sc, sh, g, kind)[0]


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,d", [(64, 16, 768), (3, 7, 1024), (1, 1, 768), (32, 1024, 768), (32, 1024, 1792)])
def test_cuda_fused_norm_modulate_backward_kernel_row_ranges(cuda, b, n, d):
    """The backward kernel where a block's row range meets several batch
    elements (16 rows each), with fewer rows than a block's warps, one row,
    and at B/1's and 1p6B/1's training shapes: within
    ``chip_smoke.fnm_bwd_check``; the control, shift and scale swapped, must
    fail."""
    import chip_smoke

    x = _randn((b, n, d), 7, cuda, torch.bfloat16, 3.0)
    w = 1 + 0.1 * _randn((d,), 8, cuda, torch.float32)
    ada = _randn((b, 6, d), 9, cuda, torch.bfloat16, 0.1)
    g = _randn((b, n, d), 10, cuda, torch.bfloat16)
    grads = tfad.fused_norm_modulate_bwd_kernel(x, w, ada[:, 0], ada[:, 1], g)
    torch.cuda.synchronize()
    ok, read = chip_smoke.fnm_bwd_check(grads, x, w, ada[:, 0], ada[:, 1], g)
    assert ok, read
    assert not chip_smoke.fnm_bwd_check(grads, x, w, ada[:, 1], ada[:, 0], g)[0]


# #10's widths off a multiple of 8: tiny and odd ones, the tp-2 halves of L
# and 1p6B (1,365, 2,389), L's and 1p6B's (2,730, 4,778), and the largest
GATE_ANY_H = [1, 7, 15, 17, 33, 1365, 2389, 2730, 4778, 8191]
_SENTINEL = 0x5A


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("h", GATE_ANY_H)
def test_cuda_gate_any_kernel_writes_its_rows_alone(cuda, h, dtype):
    """#10's realigning kernel through its three C entries (the whole row;
    the row's amax; int8 from a given amax) with x12 one element past an
    aligned base and the int8 rows 1, 3, 8 and 15 bytes past a 16-byte
    boundary: int8 and scales within the plain versions' tolerance, amax
    equal to the plain one, and every byte around the rows (sentinels)
    untouched; the control, x1 and x2 swapped, must fail."""
    from ldmae_tpu_torch import kernels

    rows, fp32 = 37, int(dtype == torch.float32)
    x12 = _randn((1 + rows * 2 * h,), 5, cuda, dtype, 2.0)[1:].view(rows, 2 * h)
    lib = kernels.load("fused_quant")
    ref = tfad.fused_silu_mul_quant_plain(x12)
    amax_ref = tfad.silu_mul_amax_plain(x12)
    amax = torch.empty(rows, 1, device=cuda)
    kernels.check(kernels.on_device(x12, lib.ldmae_silu_mul_amax, x12.data_ptr(), amax.data_ptr(), rows, h, fp32),
                  "silu_mul_amax")
    torch.testing.assert_close(amax, amax_ref, rtol=1e-6, atol=0)
    for off in (1, 3, 8, 15):
        for entry in ("ldmae_fused_silu_mul_quant", "ldmae_silu_mul_quant_scaled"):
            buf = torch.full((16 + off + rows * h + 32,), _SENTINEL, dtype=torch.int8, device=cuda)
            assert buf.data_ptr() % 16 == 0
            out, scales = buf.data_ptr() + 16 + off, torch.empty(rows, 1, device=cuda)
            args = ((x12.data_ptr(), out) if entry == "ldmae_fused_silu_mul_quant"
                    else (x12.data_ptr(), amax_ref.data_ptr(), out))
            kernels.check(kernels.on_device(x12, getattr(lib, entry), *args, scales.data_ptr(), rows, h, fp32), entry)
            q = buf[16 + off:16 + off + rows * h].view(rows, h)
            _assert_quant_close((q, scales), ref)
            assert bool((buf[:16 + off] == _SENTINEL).all()) and bool((buf[16 + off + rows * h:] == _SENTINEL).all())
    swapped = torch.cat([x12[:, h:], x12[:, :h]], dim=-1)
    with pytest.raises(AssertionError):
        _assert_quant_close(tfad.fused_silu_mul_quant(x12), tfad.fused_silu_mul_quant_plain(swapped))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_cuda_gate_any_kernel_equals_the_vector_kernel(cuda, dtype):
    """At an aligned width (3,072) the vector kernel runs on aligned x12 and
    the realigning kernel on the same values one element past it: the two
    agree bit for bit, int8 and scales, as both compute each output by the
    same operations."""
    h, rows = 3072, 64
    aligned = _randn((rows, 2 * h), 6, cuda, dtype, 2.0)
    shifted = torch.empty(1 + rows * 2 * h, device=cuda, dtype=dtype)
    shifted[1:] = aligned.flatten()
    q1, s1 = tfad.fused_silu_mul_quant(aligned)
    q2, s2 = tfad.fused_silu_mul_quant(shifted[1:].view(rows, 2 * h))
    torch.cuda.synchronize()
    assert torch.equal(q1, q2) and torch.equal(s1, s2)


# the fp32 backward on the tensor cores (3xTF32, ``tf32x3_bwd_dkdv_kernel``
# and ``tf32x3_bwd_dq_kernel``): B/1's and XL/1's training shapes, the
# patch-2 archs' N = 256, a ragged N
_TF32X3_SHAPES = [(32, 12, 1024, 64), (32, 16, 1024, 72), (32, 16, 256, 64), (2, 12, 1000, 64)]


def _f32_bwd_call(shape, rope, device):
    """fp32 q, k, v, g of ``shape`` (and the RoPE tables), the backward
    wrapper and its plain version."""
    q, k, v, g = (_randn(shape, s, device, torch.float32) for s in range(4))
    tables = _rope_tables(shape[3], shape[2], device) if rope else ()
    name = "flash_attention_rope_bwd" if rope else "flash_attention_bwd"
    return (q, k, v, g, *tables), getattr(tfa, name), getattr(tfa, f"{name}_plain")


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("shape", _TF32X3_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_fp32_bwd_tensor_cores_vs_plain(cuda, shape, rope):
    """Through the autograd Functions (the forward saves lse): dq, dk, dv
    within F32_BWD of the plain fp32 backward, and the same bits from two
    backward calls (nothing is summed across blocks)."""
    (q, k, v, g, *tables), _, plain = _f32_bwd_call(shape, rope, cuda)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = (tfa.flash_attention_rope if rope else tfa.flash_attention)(*leaves, *tables)
    first = torch.autograd.grad(out, leaves, g, retain_graph=True)
    second = torch.autograd.grad(out, leaves, g)
    _assert_f32_bwd_close(first, plain(*(t.detach() for t in leaves), g, *tables))
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("shape", [(4, 12, 1024, 64), (4, 16, 1024, 72)], ids=["d64", "d72"])
def test_cuda_fp32_bwd_tensor_cores_vs_fp64(cuda, shape, rope):
    """``chip_smoke.py``'s fp64 gate: each of dq, dk, dv within max(F64_SLACK
    x the plain fp32 backward's relative L2 error against the fp64
    backward, F64_FLOOR) of it; the plain backward with TF32 matmuls (one
    TF32 product) reads above that bound."""
    import chip_smoke

    args, kernel, plain = _f32_bwd_call(shape, rope, cuda)
    q, k, v, g, *tables = args
    exact = plain(q.double(), k.double(), v.double(), g.double(), *tables)

    def rels(outs):
        return [float((o.double() - r).norm() / r.norm()) for o, r in zip(outs, exact)]

    got, f32 = rels(kernel(*args)), rels(plain(*args))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = rels(plain(*args))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    bounds = [max(chip_smoke.F64_SLACK * e, chip_smoke.F64_FLOOR) for e in f32]
    assert all(e <= b for e, b in zip(got, bounds)), (got, bounds)
    assert all(e > b for e, b in zip(tf32, bounds)), (tf32, bounds)


def _f32_fwd_call(name, shape, device):
    """The wrapper ``name`` on fp32 operands of (B, H, N, d) ``shape`` as the
    attention module passes them (#7 the permuted views of a packed qkv, #8
    its (B, N, H, d) slices), and its plain version, as two thunks."""
    b, h, n, d = shape
    cos, sin = _rope_tables(d, n, device)
    if name in ("flash_attention", "flash_attention_rope"):
        q, k, v = (_randn(shape, s, device, torch.float32) for s in range(3))
        tab = (cos, sin) if name == "flash_attention_rope" else ()
        return (lambda: getattr(tfa, name)(q, k, v, *tab)), (lambda: getattr(tfa, f"{name}_plain")(q, k, v, *tab))
    qkv = _randn((b, n, 3, h, d), 5, device, torch.float32, scale=3.0)
    if name == "flash_attention_fused_rope":
        q, k, v = qkv.unbind(2)
        return (lambda: tfa.flash_attention_fused_rope(q, k, v, cos, sin),
                lambda: tfa.flash_attention_fused_rope_plain(q, k, v, cos, sin))
    q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    qs, ks = (1 + 0.1 * _randn((d,), s, device, torch.float32) for s in (3, 4))
    return (lambda: tfa.flash_attention_qknorm_rope(q, k, v, qs, ks, cos, sin),
            lambda: tfa.flash_attention_qknorm_rope_plain(q, k, v, qs, ks, cos, sin))


@pytest.mark.gpu
@pytest.mark.parametrize("name", _FWD_NAMES)
@pytest.mark.parametrize("shape", _F32_FWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_fp32_fwd_tensor_cores_vs_plain(cuda, shape, name):
    """Each fp32 forward within F32_FWD of its plain version, the same bits
    from two calls (nothing is summed across blocks)."""
    if name in ("flash_attention_qknorm_rope", "flash_attention_fused_rope") and shape[0] == 32:
        shape = (16, *shape[1:])  # the sampling batch (CFG-doubled 8)
    kernel, plain = _f32_fwd_call(name, shape, cuda)
    first, second = kernel(), kernel()
    _assert_f32_close(first, plain())
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("rope", [False, True], ids=["plain", "rope"])
@pytest.mark.parametrize("shape", [(32, 12, 1024, 64), (32, 16, 1024, 72), (2, 12, 1000, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_fp32_fwd_lse_vs_plain(cuda, shape, rope):
    """Under autograd the fp32 forward saves lse: within chip_smoke's F32_LSE
    of the plain lse (log2 units), the same bits from two calls."""
    import chip_smoke

    q, k, v = (_randn(shape, s, cuda, torch.float32).requires_grad_() for s in range(3))
    tables = _rope_tables(shape[3], shape[2], cuda) if rope else ()
    fwd = tfa.flash_attention_rope if rope else tfa.flash_attention
    outs = [fwd(q, k, v, *tables) for _ in range(2)]  # alive: the Function saves its output
    lse, again = (out.grad_fn.saved_tensors[-1] for out in outs)
    qd, kd = ((tfa._rope_fp32(t.detach(), *tables) for t in (q, k)) if rope else (q.detach(), k.detach()))
    assert float((lse - tfa.flash_attention_lse_plain(qd, kd)).abs().max()) <= chip_smoke.F32_LSE
    assert torch.equal(lse, again)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 12, 1024, 64), (4, 16, 1024, 72)], ids=["d64", "d72"])
def test_cuda_fp32_fwd_tensor_cores_vs_fp64(cuda, shape):
    """``chip_smoke.py``'s fp64 gate on the forward: the output within
    max(F64_SLACK x the plain fp32 forward's relative L2 error against the
    fp64 forward, F64_FLOOR), lse within max(F64_SLACK x the plain lse's
    largest error, F64_FLOOR); the plain forward with TF32 matmuls (one TF32
    product) reads above both bounds."""
    import chip_smoke

    q, k, v = (_randn(shape, s, cuda, torch.float32) for s in range(3))
    exact = tfa.flash_attention_plain(q.double(), k.double(), v.double())
    exact_lse = tfa.flash_attention_lse_plain(q.double(), k.double())

    def errs(out, lse):
        return float((out.double() - exact).norm() / exact.norm()), float((lse.double() - exact_lse).abs().max())

    def plain():
        return tfa.flash_attention_plain(q, k, v), tfa.flash_attention_lse_plain(q, k)

    got, f32 = errs(*tfa._flash_attention_fwd(q, k, v, with_lse=True)), errs(*plain())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = errs(*plain())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    bounds = [max(chip_smoke.F64_SLACK * e, chip_smoke.F64_FLOOR) for e in f32]
    assert all(e <= b for e, b in zip(got, bounds)), (got, bounds)
    assert all(e > b for e, b in zip(tf32, bounds)), (tf32, bounds)

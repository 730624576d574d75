"""Which CUDA entries ``flash_attention`` reaches at the VMAE's head dim 16
under autograd, on meta device operands (the attention library replaced by
a recorder; no card needed).

At bf16 d = 16 with 16-byte aligned rows and N <= RESIDENT_MAX_N the
forward asks the resident kernel for lse (``flash_fwd_resident_kernel``,
counted as ``flash_attention_resident``) and the backward passes the saved
output and lse, with its dq scratch, to the backward entry, whose C
dispatch then runs the single pass (``flash_bwd_wgmma_kernel<16>``).
Past RESIDENT_MAX_N, at other head dims (8, 128) and with RoPE the forward
writes no lse and the backward recomputes the row statistics (the three
passes). The arithmetic of both paths is held against the JAX VJP by
``tests/test_torch_port_headdims.py`` (the plain backward) and, on the
card, by ``tests/test_torch_port_gpu.py``.
"""

import pytest
import torch

from ldmae_tpu_torch import kernels
from ldmae_tpu_torch.ops import flash_attention as tfa
from test_torch_port_fp32bwd import _Recorder


def _meta(shape, dtype=torch.bfloat16, grad=True):
    return torch.empty(shape, device="meta", dtype=dtype, requires_grad=grad)


@pytest.fixture
def lib(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(kernels, "load", lambda name: lib)
    monkeypatch.setattr(kernels, "on_device", lambda x, entry, *args: entry(*args, None))
    for plain in ("flash_attention_plain", "flash_attention_bwd_plain", "flash_attention_rope_plain",
                  "flash_attention_rope_bwd_plain"):
        monkeypatch.setattr(tfa, plain, lambda *a: pytest.fail("the plain version ran on a device tensor"))
    return lib


def _counts():
    return (tfa.flash_attention.launches, tfa.flash_attention_resident.launches, tfa.flash_attention_bwd.launches,
            tfa.flash_attention_rope.launches, tfa.flash_attention_rope_bwd.launches)


@pytest.mark.parametrize("n", [200, 1024, tfa.RESIDENT_MAX_N])
def test_d16_under_autograd_runs_the_resident_forward_and_the_single_pass(n, lib):
    b, h, d = 2, 3, 16
    q, k, v = (_meta((b, h, n, d)) for _ in range(3))
    before = _counts()
    out = tfa.flash_attention(q, k, v)
    ((name, args),) = lib.calls
    assert name == "ldmae_flash_attention_resident_fwd"
    assert args[4] is not None and args[5:8] == (b * h, n, d)  # lse, then (bh, n, d)
    saved_out, saved_lse = out.grad_fn.saved_tensors[-2:]
    assert saved_out.shape == q.shape and saved_lse.shape == (b, h, n) and saved_lse.dtype == torch.float32
    lib.calls.clear()
    torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    ((name, args),) = lib.calls
    assert name == "ldmae_flash_attention_bwd"
    assert args[4] is not None and args[5] is not None  # the saved output and lse
    assert args[11] is not None  # the dq accumulator and its counters (scratch)
    assert args[-5:-1] == (b * h, n, d, 8)  # then the stream
    after = _counts()
    assert after[1:3] == (before[1] + 1, before[2] + 1) and after[0] == before[0]


@pytest.mark.parametrize("case", ["past-resident-n", "d8", "d128", "rope"])
def test_other_shapes_keep_the_three_passes(case, lib):
    """The forward writes no lse (the ``mma.sync`` core, or the RoPE
    forward), and the backward entry gets neither output nor lse nor dq
    scratch."""
    n, d = {"past-resident-n": (tfa.RESIDENT_MAX_N + 1, 16), "d8": (1024, 8), "d128": (1024, 128),
            "rope": (1024, 16)}[case]
    b, h = 2, 3
    q, k, v = (_meta((b, h, n, d)) for _ in range(3))
    before = _counts()
    if case == "rope":
        cos, sin = torch.empty(n, d, device="meta"), torch.empty(n, d, device="meta")
        out = tfa.flash_attention_rope(q, k, v, cos, sin)
        fwd_entry, bwd_entry, lse_at, out_at = "ldmae_flash_attention_rope_fwd", "ldmae_flash_attention_rope_bwd", 8, 4
    else:
        out = tfa.flash_attention(q, k, v)
        fwd_entry, bwd_entry, lse_at, out_at = "ldmae_flash_attention_fwd", "ldmae_flash_attention_bwd", 4, 4
    ((name, args),) = lib.calls
    assert name == fwd_entry and args[lse_at] is None
    lib.calls.clear()
    torch.autograd.grad(out, (q, k, v), torch.empty_like(out))
    ((name, args),) = lib.calls
    assert name == bwd_entry
    assert args[out_at] is None and args[out_at + 1] is None  # no output, no lse
    assert args[-6] is None  # no dq scratch
    after = _counts()
    if case == "rope":
        assert (after[3], after[4]) == (before[3] + 1, before[4] + 1)
    else:
        assert (after[0], after[1], after[2]) == (before[0] + 1, before[1], before[2] + 1)


@pytest.mark.parametrize("n,vec,rope,want", [
    (1024, 8, False, True), (tfa.RESIDENT_MAX_N, 8, False, True), (tfa.RESIDENT_MAX_N + 1, 8, False, False),
    (1024, 4, False, False), (1024, 8, True, False)])
def test_uses_lse_at_d16(n, vec, rope, want):
    """bf16 at d = 16: the single pass needs 16-byte rows, N within the
    resident forward's reach and no RoPE; fp32 always takes lse."""
    assert tfa._uses_lse(torch.bfloat16, 16, vec, n, rope=rope) is want
    assert tfa._uses_lse(torch.float32, 16, vec, n, rope=rope)

"""float32 convolution with TF32 off, forward and backward.

cuDNN runs a float32 convolution in TF32 by default (about three decimal
digits); the JAX package's convolutions (the VMAE head's smoother, SSIM's
window, LPIPS's VGG16, the FID InceptionV3) are full float32. TF32 is turned
off for each call only; no global is set. Autograd would run the
convolution's backward later, outside such a block, where the default
(TF32 on) holds again; so when a gradient is recorded the convolution is an
autograd Function whose backward runs ``aten.convolution_backward`` under
the same local flags.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _no_tf32():
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def _pair(v) -> list:
    if isinstance(v, str):
        raise ValueError(f"conv2d_fp32 takes integer padding, not {v!r}")
    return list(v) if isinstance(v, (tuple, list)) else [v, v]


class _Conv2dFP32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride, padding, dilation, groups):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups, bias is not None)
        with _no_tf32():
            return F.conv2d(x, w, bias, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, has_bias = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], has_bias and ctx.needs_input_grad[2]]
        with _no_tf32():
            dx, dw, db = torch.ops.aten.convolution_backward(
                g.contiguous(), x, w, [w.shape[0]] if has_bias else None, stride, padding, dilation,
                False, [0, 0], groups, mask)
        return dx, dw, db, None, None, None, None


def conv2d_fp32(x: torch.Tensor, w: torch.Tensor, bias=None, stride=1, padding=0, dilation=1,
                groups: int = 1) -> torch.Tensor:
    """``F.conv2d`` on float32 operands with TF32 off for this call and, when
    autograd records it, for its backward."""
    x, w = x.float(), w.float()
    bias = None if bias is None else bias.float()
    stride, padding, dilation = _pair(stride), _pair(padding), _pair(dilation)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, bias)):
        return _Conv2dFP32.apply(x, w, bias, stride, padding, dilation, groups)
    with _no_tf32():
        return F.conv2d(x, w, bias, stride, padding, dilation, groups)

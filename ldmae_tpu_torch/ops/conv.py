"""float32 convolution with TF32 off.

cuDNN runs a float32 convolution in TF32 by default (about three decimal
digits); the JAX package's convolutions (the VMAE head's smoother, SSIM's
window, LPIPS's VGG16, the FID InceptionV3) are full float32. TF32 is turned
off for each call only; no global is set.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_fp32(x: torch.Tensor, w: torch.Tensor, bias=None, **kw) -> torch.Tensor:
    """``F.conv2d`` on float32 operands with TF32 off for this call."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(x.float(), w.float(), None if bias is None else bias.float(), **kw)

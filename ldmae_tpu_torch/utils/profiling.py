"""FLOP accounting for the training logs (port of the parts of
``ldmae_tpu/utils/profiling.py`` the train CLIs use): the analytic forward
FLOPs of a LightningDiT and of a VMAE, the device's peak for MFU, and the
log's TFLOP/s and MFU text."""

from __future__ import annotations

from typing import Optional

import torch

# Dense bf16 tensor-core peaks by CUDA device name (NVIDIA's data sheets), for
# MFU only; the first key found in the lower-cased name wins. Any other
# device resolves to None and the log prints "MFU n/a", never 0 %.
_CUDA_PEAK_FLOPS = (
    ("h100 pcie", 756e12),
    ("h100", 989e12),  # SXM (HBM3), at the 700 W limit
    ("h200", 989e12),
)


def resolve_peak_flops(peak_tflops: Optional[float] = None, device=None) -> Optional[float]:
    """Peak FLOP/s of one device: an explicit ``peak_tflops`` (TFLOP/s) wins;
    otherwise a CUDA device's name is looked up in the table above. None
    for the CPU or an unknown name."""
    if peak_tflops is not None:
        return float(peak_tflops) * 1e12
    dev = torch.device(device) if device is not None else None
    if dev is None or dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev).lower()
    return next((v for k, v in _CUDA_PEAK_FLOPS if k in name), None)


def format_tflops_mfu(flops_done: float, dt: float, peak_flops_total) -> str:
    """Achieved TFLOP/s, and MFU when the peak is known, for log lines: %.3g
    never rounds real work down to "0.0", and an unknown peak prints
    "MFU n/a"."""
    tfs = flops_done / dt / 1e12 if dt > 0 else 0.0
    if peak_flops_total:
        return f"TFLOP/s: {tfs:.3g} ({tfs * 1e12 / peak_flops_total * 100:.3g}% MFU)"
    return f"TFLOP/s: {tfs:.3g} (MFU n/a: unknown peak for this device)"


def dit_forward_flops(spec, batch: int) -> float:
    """Analytic FLOPs of one LightningDiT forward: 2 x params x tokens for the
    block matmuls, 4 N^2 D per layer for attention, the adaLN projections
    once per sample (not per token), and the patch embedding."""
    d, n, depth = spec.hidden_size, spec.num_patches, spec.depth
    mlp = 3 * d * spec.swiglu_hidden if spec.use_swiglu else 2 * d * spec.mlp_hidden
    matmul_flops = 2 * depth * (4 * d * d + mlp) * n
    attn_flops = depth * 4 * n * n * d
    adaln_flops = 2 * depth * spec.num_adaln * d * d
    embed = 2 * n * spec.patch_size**2 * spec.in_channels * d
    return (matmul_flops + attn_flops + adaln_flops + embed) * batch


def _vit_stack_flops(n: int, d: int, depth: int, mlp_ratio: float) -> float:
    """Matmul and attention FLOPs of ``depth`` pre-LN ViT blocks on ``n``
    tokens of width ``d`` (qkv + proj 4 d^2, the MLP 2 d (d mlp_ratio))."""
    per_layer_params = 4 * d * d + 2 * d * int(d * mlp_ratio)
    return depth * (2 * n * per_layer_params + 4 * n * n * d)


def vmae_forward_flops(spec, batch: int, mask_ratio: float = 0.0) -> float:
    """Analytic FLOPs of one VMAE forward for MFU: the encoder on the
    ``L (1 - mask_ratio)`` kept tokens, the decoder on all ``L``, and the
    patch embedding, latent projections, decoder_embed and pred head (the
    smoother and any perceptual loss are not counted)."""
    n_tok = spec.num_patches
    n_vis = int(n_tok * (1 - mask_ratio)) + spec.num_extra_tokens
    enc = _vit_stack_flops(n_vis, spec.embed_dim, spec.depth, spec.mlp_ratio)
    dec = _vit_stack_flops(n_tok + spec.num_extra_tokens, spec.decoder_embed_dim, spec.decoder_depth,
                           spec.mlp_ratio)
    p2c = spec.patch_size**2 * spec.in_chans
    heads = (2 * n_tok * p2c * spec.embed_dim
             + 2 * n_vis * spec.embed_dim * spec.encoder_latent_dim
             + 2 * n_tok * spec.latent_dim * spec.embed_dim
             + 2 * n_tok * spec.embed_dim * spec.decoder_embed_dim
             + 2 * n_tok * spec.decoder_embed_dim * p2c)
    return (enc + dec + heads) * batch

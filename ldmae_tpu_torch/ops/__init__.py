from .sincos import (
    get_2d_sincos_pos_embed,
    get_1d_sincos_pos_embed_from_grid,
    timestep_embedding_freqs,
)
from .rope import build_rope_table, apply_rope, apply_rope_half, rotate_half
from .norms import rms_norm, layer_norm
from .linear import dense, gelu, mlp_gelu, silu, swiglu_ffn, modulate
from .patchify import patchify, unpatchify, patch_embed
from .attention import multi_head_attention, sdpa
from .gaussian import DiagonalGaussian, diagonal_gaussian
from . import flash_attention as _fa, fused_adaln as _fad, linear as _lin, quant as _quant

# every kernel wrapper of the ported path; each counts its launches. (The
# ``flash_attention`` function is not re-exported here: that name is its
# module's.)
KERNEL_WRAPPERS = (_fa.flash_attention_rope, _fa.flash_attention,
                   _fad.fused_norm_modulate, _fad.fused_norm_modulate_bwd_kernel, _fad.fused_matmul_silu,
                   _fa.flash_attention_qknorm_rope, _fa.flash_attention_fused_rope,
                   _fad.fused_norm_modulate_quant, _fad.fused_silu_mul_quant,
                   _fa.flash_attention_bwd, _fa.flash_attention_rope_bwd,
                   _fa.flash_attention_resident, _lin.dense_bias_f32, _quant.int8_dense,
                   # the tensor-parallel pieces: row-parallel partials, #10's halves
                   _lin.dense_f32_out, _quant.int8_dense_i32, _fad.silu_mul_amax, _fad.silu_mul_quant_scaled)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


__all__ = [
    "get_2d_sincos_pos_embed",
    "get_1d_sincos_pos_embed_from_grid",
    "timestep_embedding_freqs",
    "build_rope_table",
    "apply_rope",
    "apply_rope_half",
    "rotate_half",
    "rms_norm",
    "layer_norm",
    "dense",
    "gelu",
    "mlp_gelu",
    "silu",
    "swiglu_ffn",
    "modulate",
    "patchify",
    "unpatchify",
    "patch_embed",
    "multi_head_attention",
    "sdpa",
    "DiagonalGaussian",
    "diagonal_gaussian",
    "KERNEL_WRAPPERS",
    "reset_launch_counts",
    "launch_counts",
]

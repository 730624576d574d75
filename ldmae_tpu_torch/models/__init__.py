from . import lightningdit, vmae
from .init import seeded_init_
from .lightningdit import (
    DiTConsts,
    DiTSpec,
    LightningDiT,
    dit_spec,
    init_dit_weights_,
    list_models,
    permute_qk_for_half_rope,
    quantize_dit_,
)
from .vmae import VMAE, VMAEConsts, VMAESpec, list_archs, production_vmae_spec, vmae_spec

__all__ = [
    "lightningdit",
    "vmae",
    "seeded_init_",
    "DiTConsts",
    "DiTSpec",
    "LightningDiT",
    "dit_spec",
    "init_dit_weights_",
    "list_models",
    "permute_qk_for_half_rope",
    "quantize_dit_",
    "VMAE",
    "VMAEConsts",
    "VMAESpec",
    "list_archs",
    "production_vmae_spec",
    "vmae_spec",
]

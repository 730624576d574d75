"""Typed configuration system (copy of ``ldmae_tpu/core/config.py``, which is
framework-free; the port keeps its own copy so it never imports ``ldmae_tpu``).

One dataclass-based config tree replacing the reference's two disjoint
systems (VMAE argparse, LDMAE raw-YAML-dict — SURVEY.md §5.6) while keeping
the same knob names and YAML section layout so the reference's configs (e.g.
LDMAE/configs/imagenet/lightningdit_b_vmae_f8d16_cfg.yaml) load unchanged.

Unknown keys in a YAML are rejected loudly rather than silently ignored.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import yaml


def _from_dict(cls, data: Dict[str, Any]):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if dataclasses.is_dataclass(f.type) and isinstance(v, dict):
            v = _from_dict(f.type, v)
        else:
            sub = _DATACLASS_FIELDS.get((cls, f.name))
            if sub is not None and isinstance(v, dict):
                v = _from_dict(sub, v)
        kwargs[f.name] = v
    return cls(**kwargs)


@dataclass
class DataConfig:
    name: Optional[str] = None
    data_path: str = ""
    origin_path: str = ""
    fid_reference_file: str = ""
    image_size: int = 256
    num_classes: int = 1000
    num_workers: int = 8
    latent_norm: bool = True
    latent_multiplier: float = 1.0
    sample: bool = False  # latents stored as raw moments; sample at load
    valid_path: Optional[str] = None


@dataclass
class VaeConfig:
    model_name: str = "vmae_f8d16"
    downsample_ratio: int = 8
    weight_path: str = ""


@dataclass
class ModelConfig:
    model_type: str = "LightningDiT-B/1"
    use_qknorm: bool = True
    use_swiglu: bool = True
    use_rope: bool = True
    use_rmsnorm: bool = True
    wo_shift: bool = False
    in_chans: int = 16
    learn_sigma: bool = False
    use_checkpoint: bool = False  # remat
    # remat granularity: 'full' (min HBM) | 'dots' (save matmul/attention
    # outputs; backward recomputes only elementwise ops)
    remat_policy: str = "full"
    # the JAX block scan's unroll factor (1 = rolled; depth = fully unrolled);
    # kept so configs map one to one, no effect on the port's eager block loop
    scan_unroll: int = 1


@dataclass
class TrainConfig:
    max_steps: int = 100000
    global_batch_size: int = 256
    global_seed: int = 0
    output_dir: str = "output"
    exp_name: str = "exp"
    ckpt: Optional[str] = None
    log_every: int = 100
    ckpt_every: int = 20000
    use_checkpoint: bool = False
    gradient_accumulation_steps: int = 1
    weight_init: Optional[str] = None


@dataclass
class OptimizerConfig:
    lr: float = 2e-4
    beta2: float = 0.95
    max_grad_norm: Optional[float] = None


@dataclass
class TransportConfig:
    path_type: str = "Linear"
    prediction: str = "velocity"
    loss_weight: Optional[str] = None
    train_eps: Optional[float] = None
    sample_eps: Optional[float] = None
    use_cosine_loss: bool = False
    use_lognorm: bool = True
    partitial_train: Optional[List[float]] = None
    partial_ratio: float = 1.0
    shift_lg: bool = False


@dataclass
class SampleConfig:
    mode: str = "ODE"
    sampling_method: str = "euler"
    atol: float = 1e-6
    rtol: float = 1e-3
    reverse: bool = False
    likelihood: bool = False
    num_sampling_steps: int = 250
    cfg_scale: float = 10.0
    per_proc_batch_size: int = 256
    fid_num: int = 50000
    cfg_interval_start: float = 0.10
    timestep_shift: float = 0.3
    # bug-compat with lightningdit.py:432 — guidance on first 3 channels only.
    cfg_channels: int = 3
    # z truncation (inference.py:267-273); `trunaction` is the reference's
    # misspelled config key, accepted as an alias.
    truncation: Optional[float] = None
    trunaction: Optional[float] = None

    @property
    def truncation_bound(self) -> Optional[float]:
        return self.truncation if self.truncation is not None else self.trunaction


@dataclass
class ParallelConfig:
    """Device-mesh layout. Products must equal the device count in use."""

    dp: int = -1  # -1: all remaining devices
    fsdp: int = 1
    tp: int = 1
    compute_dtype: str = "bfloat16"
    attention_impl: str = "flash_rope"  # sampling: in-kernel rope flash
    # ('xla' | 'sdpa' | 'flash' | 'flash_rope' | 'flash_fused')
    # training: flash_rope (Pallas fwd+bwd kernels with in-kernel RoPE;
    # 100.7 vs 58 img/s/chip for B/1 at b=32 — the fp32 (B,H,N,N) HBM tensor
    # never exists and q/k skip the rope round-trips)
    train_attention_impl: str = "flash_rope"
    # training adaLN epilogue: 'xla' or 'fused' (Pallas fwd + custom-VJP
    # fp32 backward; gradient-parity-tested)
    train_adaln_impl: str = "xla"
    rope_layout: str = "interleaved"  # 'half' = fast permuted q/k layout
    adaln_impl: str = "fused"  # sampling: Pallas norm+modulate epilogue
    mlp_impl: str = "fused"  # sampling: silu gate fused into the w12 matmul
    # sampling-only int8 quantization (ops/quant.py): None | 'w8' | 'w8a8'
    quant: Optional[str] = None


@dataclass
class LDMAEConfig:
    """Top-level config for diffusion training / sampling (reference YAML layout)."""

    ckpt_path: Optional[str] = None
    data: DataConfig = field(default_factory=DataConfig)
    vae: VaeConfig = field(default_factory=VaeConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    transport: TransportConfig = field(default_factory=TransportConfig)
    sample: SampleConfig = field(default_factory=SampleConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    @classmethod
    def from_yaml(cls, path: str) -> "LDMAEConfig":
        with open(path) as f:
            raw = yaml.safe_load(f)
        return cls.from_dict(raw)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "LDMAEConfig":
        raw = dict(raw or {})
        # reference quirk: `sample: true` under data gates moment-sampling;
        # the top-level `sample:` section is the sampler config. The reference
        # checks `'sample' in config['data']`.
        return _from_dict(cls, raw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


@dataclass
class VMAEConfig:
    """VMAE tokenizer pretraining config (reference argparse flags,
    VMAE/main_pretrain.py:38-93)."""

    # model
    model: str = "mae_for_ldmae_f8d16_prev"
    input_size: int = 256
    mask_ratio: float = 0.25
    norm_pix_loss: bool = False
    no_cls: bool = True
    kl_loss_weight: Optional[float] = None
    fixed_std: Optional[float] = None
    smooth_output: bool = False
    pred_with_conv: bool = False
    gradual_resol: bool = False
    down_nonlinear: bool = False
    visible_loss_ratio: float = 0.5
    perceptual_loss_ratio: float = 1.0
    use_lpips: bool = False
    # training
    batch_size: int = 128
    epochs: int = 400
    accum_iter: int = 1
    weight_decay: float = 0.05
    lr: Optional[float] = None
    blr: float = 1e-4
    min_lr: float = 0.0
    warmup_epochs: int = 40
    fixed_lr: bool = False
    tune_decoder: bool = False
    seed: int = 0
    save_epochs: int = 20
    resume: str = ""
    start_epoch: int = 0
    # data
    data_path: str = ""
    dataset_name: str = "imagenet"
    output_dir: str = "./output_dir"
    log_dir: str = "./output_dir"
    num_workers: int = 10

    @classmethod
    def from_yaml(cls, path: str) -> "VMAEConfig":
        with open(path) as f:
            raw = yaml.safe_load(f)
        return _from_dict(cls, raw or {})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_DATACLASS_FIELDS = {
    (LDMAEConfig, "data"): DataConfig,
    (LDMAEConfig, "vae"): VaeConfig,
    (LDMAEConfig, "model"): ModelConfig,
    (LDMAEConfig, "train"): TrainConfig,
    (LDMAEConfig, "optimizer"): OptimizerConfig,
    (LDMAEConfig, "transport"): TransportConfig,
    (LDMAEConfig, "sample"): SampleConfig,
    (LDMAEConfig, "parallel"): ParallelConfig,
}

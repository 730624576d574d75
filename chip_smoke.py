#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ldmae_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py [--profile]

It builds the port's CUDA kernels from ``ldmae_tpu_torch/csrc`` (one nvcc
per source, in parallel) and prints ``-Xptxas -v``'s registers, shared
memory and spills of the wgmma kernels (the GEMM engine's instantiations
among them) and the row engine, measures the
SFU's ex2 and the bf16 packing's throughput (the exponential term of the
attention bounds), then:

  1. holds each of the sampling kernels against its plain PyTorch version
     on the card at the shapes the sampling paths below give it (batch 8:
     the CFG-doubled DiT step and the VMAE decode; #2 by the resident d = 16
     kernel, also at N = 1025, 1000 and d = 8), and times the kernel, the plain
     version and, where one exists, one PyTorch library call computing the
     same function (a yardstick only; the port never calls it), #1's, #7's
     and #8's two kernels apart (the pre-pass and the wgmma attention, by
     kernel name under ``torch.profiler``; the run fails if #7 or #8 does
     not launch ``flash_fwd_wgmma_kernel``), the host time a call of #7's
     and #8's wrappers, and #2 beside the ``mma.sync`` core it
     replaced, #3 and #9 (the streaming row engine) warm, with the
     device's queue full and with a cold L2, and the host time a call of
     their wrappers and of their bare C entries; then the same
     at ``bench.py``'s batch 36; then ``int8_dense``, the w8a8 leg's linear
     layer (int8 wgmma with the dequant in its epilogue, ``csrc/dense.cu``),
     bit for bit against its plain version (``torch._int_mm`` and the fp32
     dequant passes) at the path's four shapes at batch 8 and 36 (and in
     fp32 out), timed warm, queued and cold beside that plain version,
     ``torch._int_mm`` alone and cuBLAS bf16;
  1b. bf16 attention forward and backward at head dims 8, 12, 24, 32, 36,
     80 and 128 against their plain versions; every fp32 instantiation
     (#1, #2, #5, #6 at the training shape (32, 12, 1024, 64); #3, #4, #9,
     #10 at the B/1 shapes; #7, #8 at batch 8) against its plain fp32
     version, timed; ``dense`` in bf16 with an fp32 bias against fp64 math
     (one rounding), with the bias rounded first as a control that fails,
     at every linear shape of the paths (the engine's Wide and Narrow
     configurations), timed warm, queued and cold beside cuBLAS's bf16
     ``F.linear``;
  2. drives the bf16 main path through its entry points: LightningDiT-B/1
     + VMAE f8d16_prev at full width with seeded random weights (non-zero
     gates), batch 8, 250 Euler steps, timestep shift 0.3, CFG 10 on
     [0.10, 1] with the phased split, decode to uint8 (8, 256, 256, 3),
     with every kernel's launch count zeroed just before and checked
     exactly just after;
  3. drives path (a), the w8a8 leg, the same way from the same weights
     (quantized by ``quantize_dit_``) and the same noise, and holds its
     images against the bf16 ones (PSNR >= 30 dB);
  4. runs 10 steps from one noise and compares the latents and the decoded
     images: the bf16 kernels against the plain ``xla`` impls, the w8a8
     kernels against the w8a8 ``xla`` impls, and the opt-in attention
     impls ``flash_qkr`` (c) and ``flash_fused`` (d) against
     ``flash_rope``, each with its exact launch counts, the three impls'
     10-step seconds side by side, and the same four
     in fp32 (``compute_dtype`` float32); decodes with two VMAE archs of
     head dims 12 and 24 under ``flash`` against ``xla`` in bf16 and fp32;
     then holds the
     10-step w8a8 latents against the bf16 latents from the same noise
     (relative L2 error within ``QUANT_REL_MAX``), and two wrongly
     quantized DiTs, which must read above that bound;
  5. holds the two flash-attention backward kernels, given the forward's
     output and lse as the autograd Functions give them, against their plain
     backward at the DiT training shapes (32, 12, 1024, 64) bf16 by a
     per-output relative L2 error and an elementwise bound, which two wrong
     backwards (no rowsum term; the RoPE Jacobian untransposed) must exceed,
     and times them (the backward alone, and its kernels apart by name under
     ``torch.profiler``: RoPE pre-pass, preprocess, single pass,
     postprocess) beside the plain backward and the backward of
     ``F.scaled_dot_product_attention`` (fwd+bwd minus fwd); also the
     forward kernels #1, #3 (and #9) at the training shapes;
  6. checks one train step of B/1 at full width (depth 2, batch 8) on the
     card: the loss and every parameter's gradient of the kernel path (the
     shipped YAML's flash_rope, half-split RoPE, fused adaLN, remat 'attn')
     against the plain xla path from the same weights, noise, t and label
     drops, within GRAD_REL_L2, which the path with the untransposed RoPE
     Jacobian must exceed; then the same in fp32, half and interleaved
     RoPE, within GRAD_F32_REL_L2, with exact launch counts;
  7. trains LightningDiT-B/1 at full width and depth through the training
     CLI (``cli.train_dit.main``) on a YAML made from the shipped one's
     model, transport, optimizer and parallel sections, batch 32, 20 steps,
     on synthetic 16-channel 32x32 latent shards this script writes, from
     seeded non-zero weights (``train.weight_init``), with exact launch
     counts; checks finite losses and gradient norms and that the weights
     and the EMA moved; restarts to step 25 ("resumed from step 20"); and
     prints steps/s, latents/s, TFLOP/s, MFU and peak memory; then 5 steps
     of the ``rope_layout: interleaved`` configuration and 5 steps with
     ``parallel.compute_dtype: float32``, each with exact counts;
  8. with ``--profile``, traces one 50-step batch of the bf16 and of the
     w8a8 path, and one training step, with ``torch.profiler`` and prints
     device time by kernel and group and the idle share.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line
(sampling kernels at the batch-8 shapes, the backward kernels and #2 at d
= 64 at the training shapes, the fp32 instantiations as their own entries;
launches from the path that runs each kernel), and as its last line
``{"ok": true, "device": {...}}``.
Any failure exits non-zero without that line; without a CUDA device, or
outside the repository, it exits non-zero at once.

``python3 chip_smoke.py --linear`` times only the linear layers' kernels
(#4, ``dense``, ``qdense_pre``) through wrappers that earlier commits have
too, likewise for comparisons within one call; ``--attention`` the d = 64
attention forwards (#7 and #8 by part, with their wrappers' host time a
call, #1, #2) and the 10-step sampling seconds under flash_rope, flash_qkr
and flash_fused.

``python3 chip_smoke.py --rows`` runs only the #3 / #9 row phases (batch 8,
batch 36, the training shape, fp32) after building their two libraries,
and ends with a ``{"rows": {...}}`` line: copied into a checkout of an
earlier commit whose two C entries take the same arguments, it times that
commit's kernels and wrappers by the same means, for comparisons within
one call.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, at the 700 W limit
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth

_FA, _FA32 = "ldmae_tpu_torch/csrc/flash_attention.cu", "ldmae_tpu_torch/csrc/flash_attention_fp32.cu"
_PALLAS_FA, _PALLAS_AD = "ldmae_tpu/ops/flash_attention.py", "ldmae_tpu/ops/fused_adaln.py"
_DENSE = "ldmae_tpu_torch/csrc/dense.cu"
# kernels-line name -> (source, the Pallas call it replaces, the path whose
# launches it reports, the wrapper that counts them); the fp32 entries are
# the fp32 instantiations (their own kernels) behind the same wrappers
KERNELS = {
    "flash_attention_rope": (_FA, f"{_PALLAS_FA}:323", "bf16", "flash_attention_rope"),
    "flash_attention_resident": (_FA, f"{_PALLAS_FA}:77", "bf16", "flash_attention_resident"),
    "flash_attention": (_FA, f"{_PALLAS_FA}:77", "interleaved", "flash_attention"),
    "fused_norm_modulate": ("ldmae_tpu_torch/csrc/fused_norm_modulate.cu", f"{_PALLAS_AD}:232", "bf16",
                            "fused_norm_modulate"),
    "fused_matmul_silu": ("ldmae_tpu_torch/csrc/fused_matmul_silu.cu", f"{_PALLAS_AD}:199", "bf16", "fused_matmul_silu"),
    "flash_attention_qknorm_rope": (_FA, f"{_PALLAS_FA}:282", "flash_qkr", "flash_attention_qknorm_rope"),
    "flash_attention_fused_rope": (_FA, f"{_PALLAS_FA}:550", "flash_fused", "flash_attention_fused_rope"),
    "fused_norm_modulate_quant": ("ldmae_tpu_torch/csrc/fused_quant.cu", f"{_PALLAS_AD}:99", "w8a8",
                                  "fused_norm_modulate_quant"),
    "fused_silu_mul_quant": ("ldmae_tpu_torch/csrc/fused_quant.cu", f"{_PALLAS_AD}:144", "w8a8", "fused_silu_mul_quant"),
    "flash_attention_bwd": (_FA, f"{_PALLAS_FA}:151", "interleaved", "flash_attention_bwd"),
    "flash_attention_rope_bwd": (_FA, f"{_PALLAS_FA}:429", "train", "flash_attention_rope_bwd"),
    "flash_attention_rope_fp32": (_FA32, f"{_PALLAS_FA}:323", "train_fp32", "flash_attention_rope"),
    "flash_attention_fp32": (_FA32, f"{_PALLAS_FA}:77", "decode_fp32", "flash_attention"),
    "flash_attention_bwd_fp32": (_FA32, f"{_PALLAS_FA}:151", "grad_fp32_interleaved", "flash_attention_bwd"),
    "flash_attention_rope_bwd_fp32": (_FA32, f"{_PALLAS_FA}:429", "train_fp32", "flash_attention_rope_bwd"),
    "fused_norm_modulate_fp32": ("ldmae_tpu_torch/csrc/fused_norm_modulate.cu", f"{_PALLAS_AD}:232", "train_fp32",
                                 "fused_norm_modulate"),
    "fused_matmul_silu_fp32": ("ldmae_tpu_torch/csrc/fused_matmul_silu.cu", f"{_PALLAS_AD}:199", "sample_fp32",
                               "fused_matmul_silu"),
    "fused_norm_modulate_quant_fp32": ("ldmae_tpu_torch/csrc/fused_quant.cu", f"{_PALLAS_AD}:99", "sample_fp32_w8a8",
                                       "fused_norm_modulate_quant"),
    "fused_silu_mul_quant_fp32": ("ldmae_tpu_torch/csrc/fused_quant.cu", f"{_PALLAS_AD}:144", "sample_fp32_w8a8",
                                  "fused_silu_mul_quant"),
    "flash_attention_qknorm_rope_fp32": (_FA32, f"{_PALLAS_FA}:282", "sample_fp32_qkr", "flash_attention_qknorm_rope"),
    "flash_attention_fused_rope_fp32": (_FA32, f"{_PALLAS_FA}:550", "sample_fp32_fused", "flash_attention_fused_rope"),
    # the port's own kernels for two XLA ops: dense's bf16 linear with its
    # fp32 bias, and the w8a8 linear (int8 GEMM + dequant; bf16 and fp32 out)
    "dense": (_DENSE, "ldmae_tpu/ops/linear.py:21", "bf16", "dense_bias_f32"),
    "int8_dense": (_DENSE, "ldmae_tpu/ops/quant.py:97", "w8a8", "int8_dense"),
    "int8_dense_fp32": (_DENSE, "ldmae_tpu/ops/quant.py:97", "sample_fp32_w8a8", "int8_dense"),
}
WRAPPERS = ("flash_attention_rope", "flash_attention", "fused_norm_modulate", "fused_matmul_silu",
            "flash_attention_qknorm_rope", "flash_attention_fused_rope", "fused_norm_modulate_quant",
            "fused_silu_mul_quant", "flash_attention_bwd", "flash_attention_rope_bwd", "flash_attention_resident",
            "dense_bias_f32", "int8_dense")

BATCH, STEPS, CFG_SCALE, SHIFT, CFG_START = 8, 250, 10.0, 0.3, 0.10
SHORT_STEPS = 10  # the comparisons between impls
BENCH_BATCH = 36  # bench.py's batch: kernel shapes also checked and timed there
N1 = 68  # single-batch Euler steps before the CFG interval at 250 steps, shift 0.3
DEPTH, DEC_DEPTH = 12, 12
PSNR_MIN = 30.0  # w8a8 vs bf16 images from the same noise (the JAX gate: perf_quant.py)
# w8a8 vs bf16 10-step latents from noise z, ||w8a8 - bf16|| / ||bf16 - z||:
# the bound of a sound quantization, and wrongly quantized DiTs that must read above it.
# Set between the readings on an H100 SXM: sound 0.0132-0.0133, the two controls 0.038-0.042
QUANT_REL_MAX = 0.025
QUANT_NOISE_SEEDS = (2, 3)
# DiT training: B/1 at full width and depth through the CLI, batch 32, then a
# restart to step 25; the interleaved-RoPE configuration for 5 steps; the
# gradient check at depth 2, batch 8
TRAIN_BATCH, TRAIN_STEPS, RESUME_STEPS, INTERLEAVED_STEPS, FP32_STEPS = 32, 20, 25, 5, 5
GRAD_DEPTH, GRAD_BATCH, GRAD_T = 2, 8, 0.37
# the backward kernels against their plain backward at the training shapes
# (per output: relative L2 error, max |error| / max |value|); readings on an
# H100 SXM: 0.0025-0.0028 and <= 0.0065 with unit inputs, 0.0028 and 0.0069
# with q, k at twice that scale; the controls 0.93-1.74 and 1.75-3.37
BWD_REL_L2, BWD_ELEM = 1e-2, 2e-2
# per-leaf relative L2 error of the kernel path's gradients against the xla
# path's, both in bf16 (the kernels round p and ds to bf16, the xla path
# rounds other intermediates); readings on an H100 SXM: worst leaf 0.0026,
# the untransposed-Jacobian control 1.16
GRAD_REL_L2 = 1e-2
GRAD_F32_REL_L2 = 1e-3  # the same in fp32: summation order only
_NONE = dict.fromkeys(WRAPPERS, 0)
_EVALS = (STEPS - 1) * DEPTH  # block forwards of one 250-step batch (the last step evaluates nothing)
_SHORT = (SHORT_STEPS - 1) * DEPTH
# dense's launches (bf16 with a bias; fp32 runs cuBLAS): per DiT forward the
# patch embedding, the timestep MLP's two linears and the final layer's two,
# and per block the adaLN linear, qkv, proj and w3 (w12 is #4) in bf16, proj
# alone in w8a8 (the other block linears are int8_dense's four); per VMAE
# decode the latent projection, decoder_embed, the four linears of each
# block and the pred head
_DENSE_FWD, _DENSE_FWD_W8A8, _DENSE_DECODE = 5 + 4 * DEPTH, 5 + DEPTH, 3 + 4 * DEC_DEPTH
# exact launch counts per path: every wrapper is counted, so each dict names all of them
EXPECTED_LAUNCHES = {
    "bf16": _NONE | {"flash_attention_rope": _EVALS, "fused_norm_modulate": 2 * _EVALS,
                     "fused_matmul_silu": _EVALS, "flash_attention_resident": DEC_DEPTH,
                     "dense_bias_f32": (STEPS - 1) * _DENSE_FWD + _DENSE_DECODE},
    "w8a8": _NONE | {"fused_norm_modulate_quant": 2 * _EVALS, "fused_silu_mul_quant": _EVALS,
                     "flash_attention_rope": _EVALS, "flash_attention_resident": DEC_DEPTH,
                     "int8_dense": 4 * _EVALS, "dense_bias_f32": (STEPS - 1) * _DENSE_FWD_W8A8 + _DENSE_DECODE},
    # 10 steps, latents only (the decode is compared apart)
    "flash_qkr": _NONE | {"flash_attention_qknorm_rope": _SHORT, "fused_norm_modulate": 2 * _SHORT,
                          "fused_matmul_silu": _SHORT, "dense_bias_f32": (SHORT_STEPS - 1) * _DENSE_FWD},
    "flash_fused": _NONE | {"flash_attention_fused_rope": _SHORT, "fused_norm_modulate": 2 * _SHORT,
                            "fused_matmul_silu": _SHORT, "dense_bias_f32": (SHORT_STEPS - 1) * _DENSE_FWD},
    # VMAE decode of an arch off the resident kernel's head dims (12, 24), bf16 and fp32
    "decode": _NONE | {"flash_attention": DEC_DEPTH, "dense_bias_f32": _DENSE_DECODE},
    "decode_fp32": _NONE | {"flash_attention": DEC_DEPTH},
}
# the 10-step paths in fp32 (parallel.compute_dtype: float32), latents only
EXPECTED_LAUNCHES |= {
    "sample_fp32": _NONE | {"flash_attention_rope": _SHORT, "fused_norm_modulate": 2 * _SHORT,
                            "fused_matmul_silu": _SHORT},
    "sample_fp32_w8a8": _NONE | {"fused_norm_modulate_quant": 2 * _SHORT, "fused_silu_mul_quant": _SHORT,
                                 "flash_attention_rope": _SHORT, "int8_dense": 4 * _SHORT},
    "sample_fp32_qkr": _NONE | {"flash_attention_qknorm_rope": _SHORT, "fused_norm_modulate": 2 * _SHORT,
                                "fused_matmul_silu": _SHORT},
    "sample_fp32_fused": _NONE | {"flash_attention_fused_rope": _SHORT, "fused_norm_modulate": 2 * _SHORT,
                                  "fused_matmul_silu": _SHORT},
}
# Training with remat_policy 'attn' (two checkpointed segments per block,
# split at the attention output): per step and block the forward runs #1
# (or #2) once and #3 twice, the backward recomputes both segments (#1 or #2
# once more, #3 twice more) and runs the backward kernel #6 (or #5) once;
# the final layer's norm is not fused, and the MLP stays 'xla' in training.
# dense in bf16: the forward's 5 + 5 per block (w12 too), and the recomputed
# segments' four block linears a block again.
def _train_counts(steps: int, depth: int = DEPTH) -> dict:
    return dict(fwd=2 * depth * steps, adaln=4 * depth * steps, bwd=depth * steps, dense=(5 + 9 * depth) * steps)


for _path, _steps in (("train", TRAIN_STEPS), ("train_resume", RESUME_STEPS - TRAIN_STEPS)):
    _n = _train_counts(_steps)
    EXPECTED_LAUNCHES[_path] = _NONE | {"flash_attention_rope": _n["fwd"], "fused_norm_modulate": _n["adaln"],
                                        "flash_attention_rope_bwd": _n["bwd"], "dense_bias_f32": _n["dense"]}
_n = _train_counts(INTERLEAVED_STEPS)
EXPECTED_LAUNCHES["interleaved"] = _NONE | {"flash_attention": _n["fwd"], "fused_norm_modulate": _n["adaln"],
                                            "flash_attention_bwd": _n["bwd"], "dense_bias_f32": _n["dense"]}
_n = _train_counts(FP32_STEPS)
EXPECTED_LAUNCHES["train_fp32"] = _NONE | {"flash_attention_rope": _n["fwd"], "fused_norm_modulate": _n["adaln"],
                                           "flash_attention_rope_bwd": _n["bwd"]}
# the fp32 gradient checks: one step at depth GRAD_DEPTH, each layout
_n = _train_counts(1, GRAD_DEPTH)
EXPECTED_LAUNCHES["grad_fp32_half"] = _NONE | {"flash_attention_rope": _n["fwd"], "fused_norm_modulate": _n["adaln"],
                                               "flash_attention_rope_bwd": _n["bwd"]}
EXPECTED_LAUNCHES["grad_fp32_interleaved"] = _NONE | {"flash_attention": _n["fwd"], "fused_norm_modulate": _n["adaln"],
                                                      "flash_attention_bwd": _n["bwd"]}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters: int = 50) -> float:
    """Time per call of ``iters`` back-to-back calls of ``fn`` queued behind
    a spin of the device (``torch.cuda._sleep``, longer than the host takes
    to launch them all): the kernels' own time, where ``cuda_ms`` reads the
    host's launch time whenever that is the longer (a short kernel behind a
    Python wrapper)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e8))  # ~0.1 s at the boost clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 100, windows: int = 5) -> float:
    """Host time per call of ``fn`` (the Python wrapper: checks, output
    allocation, the launch), the device kept busy by a spin so that no call
    waits for it: the median of ``windows`` windows of ``iters`` calls (the
    host's time drifts with its other load)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        torch.cuda._sleep(int(1e8))  # ~0.05 s at the boost clock, longer than a window's launches
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) / iters * 1e3)
        torch.cuda.synchronize()
    return sorted(times)[windows // 2]


FLUSH_BYTES = 256 * 2**20  # five times the H100's 50 MB L2


def cold_ms(fn, iters: int = 20) -> float:
    """Median time of one call of ``fn`` with a cold L2: before each call
    the device writes a 256 MB buffer (the L2 then holds dirty lines of it,
    as after another kernel's output, and nothing of fn's inputs), and each
    call is timed by its own events. The write takes longer than the host
    needs to launch the call, so the host's time does not show."""
    import torch

    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")  # freed on return: no later peak counts it
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in events:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(end) for start, end in events)
    return times[len(times) // 2]


def _profiled(fn, iters: int):
    """torch.profiler's device events of ``iters`` calls of ``fn`` after a
    warm-up call, as (name, device ms per call) pairs. The profiler has come
    back empty now and then on the card; an empty trace is taken again, up
    to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [(e.key, e.self_device_time_total / 1e3 / iters) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if events:
            return events
    return []


def kernel_device_ms(fn, names, iters: int = 20) -> dict:
    """Device time per call of each kernel whose name contains one of
    ``names``, from torch.profiler over ``iters`` calls of ``fn`` after a
    warm-up call: the parts of a wrapper that launches more than one kernel."""
    out = dict.fromkeys(names, 0.0)
    for key, ms in _profiled(fn, iters):
        for name in names:
            if name in key:
                out[name] += ms
    if not all(out.values()):
        raise SystemExit(f"the profiler saw none of {[n for n, v in out.items() if not v]}")
    return out


def device_ms(fn, iters: int = 20):
    """Device time per call of ``fn``, every kernel it launches summed
    (torch.profiler): the kernel's time without the host's time to launch
    it, which at batch 8 can exceed it. None ("not measured") when the
    profiler records nothing: a yardstick beside the checked numbers, which
    a failed trace does not fail."""
    events = _profiled(fn, iters)
    return sum(ms for _, ms in events) if events else None


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def rope_parts(fn, strict: bool = True) -> dict:
    """The two kernels of a RoPE attention wrapper (#1, #7, #8) timed apart:
    the pre-pass and the wgmma attention; fails unless both ran. Not
    strict (an earlier tree's wrappers, ``--attention``): the pre-pass and
    whichever flash_fwd attention kernels ran, named."""
    if strict:
        ms = kernel_device_ms(fn, ("norm_rope_kernel", "flash_fwd_wgmma_kernel"))
        return {"prepass_ms": ms["norm_rope_kernel"], "attention_ms": ms["flash_fwd_wgmma_kernel"]}
    parts = {"prepass_ms": 0.0, "attention_ms": 0.0, "attention_kernels": []}
    for key, ms in _profiled(fn, 20):
        if "norm_rope" in key:
            parts["prepass_ms"] += ms
        elif "flash_fwd" in key:
            parts["attention_ms"] += ms
            parts["attention_kernels"].append(re.search(r"flash_fwd\w*", key)[0])
    return parts


def ptxas_summary(log: str, kernel: str) -> str:
    """``-Xptxas -v``'s report of a kernel, each instantiation: registers at
    entry, barriers, static shared memory, stack and spills."""
    lines = log.splitlines()
    found = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            props = []
            for nxt in lines[i + 1:i + 5]:
                if "Compiling entry function" in nxt:
                    break
                if "registers" in nxt or "spill" in nxt:
                    props.append(nxt.split("info    :")[-1].strip())
            found.append("; ".join(props))
    return " | ".join(found) or "not in the report"


# exponentials per second of the card's SFUs (ex2.approx), measured by
# rate_probes() at the start of the run: the exponential term of the
# attention kernels' bounds
RATES = {"ex2": None, "f2fp": None}


def rate_probes(dev) -> None:
    """The SFU's ex2 and the bf16 packing's (F2FP) throughput over the whole
    card, from a kernel whose threads run 8 independent chains of the one
    operation (``ldmae_rate_probe``); stored in RATES."""
    import torch

    from ldmae_tpu_torch import kernels

    lib = kernels.load("flash_attention")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = sms * 8, 4096
    out = torch.empty(blocks * 256, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for which, name in ((0, "ex2"), (1, "f2fp")):
        def run():
            kernels.check(lib.ldmae_rate_probe(out.data_ptr(), which, blocks, iters, stream), "rate probe")

        ms = cuda_ms(run, 5)
        RATES[name] = blocks * 256 * iters * 8 / (ms * 1e-3)
        clock = torch.cuda.get_device_properties(0).clock_rate * 1e3  # Hz, the boost clock
        log(f"[rates] {name}: {RATES[name]:.4g} results/s on {sms} SMs ({RATES[name] / sms / clock:.2f} per SM "
            f"per clock at the {clock / 1e9:.3f} GHz boost clock); {ms:.4f} ms for {blocks} blocks x 256 threads "
            f"x {iters} x 8")


def bound(nbytes: float, bf16_flops: float = 0.0, fp32_flops: float = 0.0, exps: float = 0.0,
          int8_ops: float = 0.0) -> tuple[float, str]:
    """Least time in ms for the work: the larger of bytes over the memory
    rate and the operations' time, itself the largest of tensor-core bf16
    operations, tensor-core int8 operations, plain fp32 operations and
    exponentials over their units' rates (the units run side by side;
    exponentials over the measured SFU rate)."""
    t_ops = max(bf16_flops / PEAK_BF16_FLOPS, int8_ops / PEAK_INT8_OPS, fp32_flops / PEAK_FP32_FLOPS,
                exps / RATES["ex2"] if exps else 0.0) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(name: str, out, ref, rtol: float, atol: float) -> float:
    """max |out - ref|; fails unless every element is within atol + rtol*|ref|."""
    import torch

    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    max_abs = float(diff.max())
    rel = max_abs / max(float(ref.float().abs().max()), 1e-30)
    excess = float((diff - (atol + rtol * ref.float().abs())).max())
    ok = bool(torch.isfinite(out.float()).all()) and excess <= 0
    log(f"  {name}: max_abs_err={max_abs:.6g} max_rel_err={rel:.6g} "
        f"tolerance atol={atol:g} rtol={rtol:g} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return max_abs


def compare_quant(name: str, out, ref) -> float:
    """The int8 outputs within one step of the plain version's, at most
    1e-3 of them off (a value on a rounding boundary after another fp32 row
    sum), row scales within rtol 1e-6. Returns max |q * scale - q_ref *
    scale_ref| (the dequantized values)."""
    import torch

    torch.cuda.synchronize()
    (q, s), (q_ref, s_ref) = out, ref
    dq = (q.int() - q_ref.int()).abs()
    max_dq, flips = int(dq.max()), float((dq != 0).float().mean())
    s_rel = float(((s - s_ref).abs() / s_ref.abs()).max())
    err = float((q.float() * s - q_ref.float() * s_ref).abs().max())
    ok = max_dq <= 1 and flips <= 1e-3 and s_rel <= 1e-6 and bool(torch.isfinite(s).all())
    log(f"  {name}: max |dq| {max_dq} (tolerance 1), share of q off {flips:.3g} (tolerance 1e-3), "
        f"scales max rel err {s_rel:.3g} (tolerance 1e-6), dequantized max_abs_err {err:.6g} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return err


def adaln_row_kernels(dev, b: int, what: str, dtype=None) -> dict:
    """#3 and #9, the streaming row engine's two kernels, at x (b, 1024, 768)
    with shift and scale strided views of a (b, 6, 768) projection output:
    each against its plain version, timed warm (``cuda_ms``, as the earlier
    PRs' rows), queued (``queued_ms``: the device's time alone) and with a
    cold L2 (``cold_ms``), beside its plain version; and the host time a
    call (``host_ms``; warm reads the larger of it and the device's time) of
    the wrapper, of its bare C entry called with ready arguments, and of
    that entry inside a ``torch.cuda.device`` guard with
    ``torch.cuda.current_stream``'s handle (what the wrappers' ``_on_device``
    skips when x's device is current). The
    bound is the bytes moved, the share of it taken from the cold time.
    Returns name -> row of the kernels line."""
    import torch

    from ldmae_tpu_torch import kernels
    from ldmae_tpu_torch.ops import fused_adaln as fad

    dtype = dtype or torch.bfloat16
    bf16 = dtype == torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(b)
    n, d = 1024, 768
    log(f"[kernel] fused_norm_modulate(_quant) {what}: x ({b},{n},{d}) {str(dtype)[6:]}, w ({d},) fp32, "
        f"shift/scale ({b},{d}) views of ({b},6,{d})")
    x = (torch.randn(b, n, d, generator=g, device=dev) * 3).to(dtype)
    w = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
    mod = (torch.randn(b, 6, d, generator=g, device=dev) * 0.1).to(dtype)
    sh, sc = mod[:, 0], mod[:, 1]
    es = x.element_size()
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = (x.data_ptr(), w.data_ptr(), sh.data_ptr(), sc.data_ptr(), sh.stride(0), sc.stride(0))
    tail = (b, n, d, 0, 1e-6, int(not bf16))
    out16 = torch.empty_like(x)
    out8, scales = torch.empty(b, n, d, device=dev, dtype=torch.int8), torch.empty(b, n, 1, device=dev)
    rows = {}
    # per element: square and sum, scale, weight, (1 + scale) product, shift;
    # #9 also absmax, reciprocal product, round
    for name, kern, plain, out_bytes, flops, entry, outs in (
        ("fused_norm_modulate", fad.fused_norm_modulate, fad.fused_norm_modulate_plain, es, 6,
         kernels.load("fused_norm_modulate").ldmae_fused_norm_modulate, (out16.data_ptr(),)),
        ("fused_norm_modulate_quant", fad.fused_norm_modulate_quant, fad.fused_norm_modulate_quant_plain, 1, 9,
         kernels.load("fused_quant").ldmae_fused_norm_modulate_quant, (out8.data_ptr(), scales.data_ptr())),
    ):
        quant = name.endswith("_quant")
        if quant:
            check = compare_quant
        elif bf16:
            def check(label, out, ref):
                return compare(label, out, ref, rtol=2**-6, atol=2**-6)
        else:
            check = f32_compare
        ref = plain(x, w, sh, sc)
        err = check(f"{name} {what}", kern(x, w, sh, sc), ref)

        def run():
            return kern(x, w, sh, sc)

        args = common + outs + tail

        def bare():
            return entry(*args, stream)

        def guarded():
            with torch.cuda.device(x.device):
                return entry(*args, torch.cuda.current_stream(x.device).cuda_stream)

        warm = sorted(cuda_ms(run, 50) for _ in range(5))
        ms = warm[2]
        parts = {"warm_min_ms": warm[0], "warm_max_ms": warm[-1], "queued_ms": queued_ms(run),
                 "cold_ms": cold_ms(run), "host_ms": host_ms(run), "entry_host_ms": host_ms(bare),
                 "guarded_entry_host_ms": host_ms(guarded)}
        plain_ms = cuda_ms(lambda: plain(x, w, sh, sc), 10)
        bnd = bound(b * n * d * (es + out_bytes) + (b * n * 4 if quant else 0) + d * 4 + 2 * b * d * es,
                    fp32_flops=flops * b * n * d)
        parts["share_cold"] = bnd[0] / parts["cold_ms"]
        log(f"  {name} {what}: warm {ms:.4f} ms (median of 5, {warm[0]:.4f}-{warm[-1]:.4f}), queued "
            f"{parts['queued_ms']:.4f}, cold L2 {parts['cold_ms']:.4f}; host time a call: wrapper "
            f"{parts['host_ms']:.4f}, C entry {parts['entry_host_ms']:.4f}, C entry in the device guard "
            f"{parts['guarded_entry_host_ms']:.4f}; plain {plain_ms:.4f}; bound {bnd[0]:.4f} ms ({bnd[1]}), share "
            f"of bound {parts['share_cold']:.3f} (cold), {bnd[0] / parts['queued_ms']:.3f} (queued)")
        rows[name if bf16 else f"{name}_fp32"] = (err, ms, plain_ms, None, *bnd, parts)
    del x, out16, out8
    torch.cuda.empty_cache()
    return rows


def engine_ptxas(report: dict) -> None:
    """ptxas's report of the row engine's instantiations at D = 768
    (csrc/norm_rows.cuh): #3 and #9 in bf16 and fp32 (dynamic shared
    memory)."""
    for lib, epi in (("fused_norm_modulate", "8Modulate"), ("fused_quant", "13ModulateQuant")):
        for what, inst in (("bf16", "I13__nv_bfloat16EELi3EE"), ("fp32", "IfEELi6EE")):
            log(f"  ptxas norm_rows_kernel {lib} {what}: {ptxas_summary(report[lib]['ptxas'], epi + inst)}")


def gemm_ptxas(report: dict) -> None:
    """ptxas's report of each instantiation of the GEMM engine
    (csrc/gemm.cuh): #4 and the dense / int8_dense configurations, named
    by operand type, accumulator columns, cluster, stages and epilogue."""
    for lib in ("fused_matmul_silu", "dense"):
        log_ = report[lib]["ptxas"]
        for name in sorted(set(re.findall(r"Compiling entry function '(_ZN4gemm11gemm_kernel[^']*)'", log_))):
            cfg = re.search(r"ConfigI(13__nv_bfloat16|a)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)EE", name)
            epi = re.search(r"(BiasEpi|GateEpi|DequantEpiI13__nv_bfloat16E|DequantEpiIfE)", name)
            if cfg is None or epi is None:
                log(f"  ptxas {name}: {ptxas_summary(log_, name)}")
                continue
            label = (f"{'bf16' if cfg[1].startswith('13') else 'int8'} BN={cfg[2]} cluster={cfg[3]} "
                     f"stages={cfg[4]}x{cfg[5]} {epi[1].replace('I13__nv_bfloat16E', '<bf16>').replace('IfE', '<fp32>')}")
            log(f"  ptxas gemm_kernel {label}: {ptxas_summary(log_, name)}")


def rows_only(dev) -> int:
    """``--rows``: the #3 / #9 row phases alone, at every shape the full run
    times them at, and a ``{"rows": ...}`` line of their numbers."""
    import torch

    from ldmae_tpu_torch import kernels

    t0 = time.perf_counter()
    report = kernels.build(["fused_norm_modulate", "fused_quant"])
    log(f"[build] {time.perf_counter() - t0:.2f} s for the two row-kernel libraries")
    engine_ptxas(report)
    out = {}
    for b, what, dtype in ((2 * BATCH, f"(batch {BATCH})", torch.bfloat16),
                           (2 * BENCH_BATCH, f"(batch {BENCH_BATCH})", torch.bfloat16),
                           (32, "(training shape)", torch.bfloat16),
                           (2 * BATCH, f"fp32 (batch {BATCH})", torch.float32)):
        for name, (err, ms, plain_ms, _, bound_ms, _, parts) in adaln_row_kernels(dev, b, what, dtype).items():
            out[f"{name} {what}"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms} | parts
    log(json.dumps({"rows": out}))
    return 0


def linear_only(dev) -> int:
    """``--linear``: the linear layers' kernels alone, through wrappers an
    earlier commit has too (``ops.dense``, ``fused_matmul_silu``,
    ``quant.qdense_pre``), so that copied into an unpacked parent it times
    the parent's by the same means: #4 at its sampling shape, ``dense`` at
    DENSE_SHAPES and ``qdense_pre`` at the int8 shapes of batch 8, each
    queued (the device alone; median of three), cold and warm, with the
    host time a call at the adaLN shapes; ``qdense_pre`` held bit for bit
    against ``torch._int_mm`` and the fp32 dequant passes. Ends with a
    ``{"linear": {...}}`` line."""
    import torch

    from ldmae_tpu_torch import kernels
    from ldmae_tpu_torch.ops import dense
    from ldmae_tpu_torch.ops import fused_adaln as fad
    from ldmae_tpu_torch.ops import quant

    t0 = time.perf_counter()
    kernels.build([n for n in ("fused_matmul_silu", "dense") if n in kernels.LIBRARIES])
    log(f"[build] {time.perf_counter() - t0:.2f} s for the GEMM libraries")
    g = torch.Generator(device=dev).manual_seed(41)
    out = {}

    def timed(key, run, host=False):
        r = {"queued_ms": sorted(queued_ms(run) for _ in range(3))[1], "cold_ms": cold_ms(run),
             "warm_ms": cuda_ms(run, 20)}
        if host:
            r["host_ms"] = host_ms(run)
        out[key] = r
        log(f"  {key}: " + ", ".join(f"{k} {v:.4f}" for k, v in r.items()))

    x = torch.randn(16384, 768, generator=g, device=dev).bfloat16()
    w12 = (torch.randn(4096, 768, generator=g, device=dev) * 768**-0.5).bfloat16()
    b12 = torch.randn(4096, generator=g, device=dev) * 0.1
    timed("fused_matmul_silu (16384x768 -> 2x2048)", lambda: fad.fused_matmul_silu(x, w12, b12))
    for name, m, k, n in DENSE_SHAPES:
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        w = (torch.randn(n, k, generator=g, device=dev) * k**-0.5).bfloat16()
        b = torch.randn(n, generator=g, device=dev)
        timed(f"dense {name} ({m}x{k} -> {n})", lambda: dense(x, w, b), host=name == "adaLN")
    for name, k, n in INT8_SHAPES:
        m = 2 * BATCH * (1 if name == "adaLN" else 1024)
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        p = quant.QLinear(torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8),
                          torch.rand(n, generator=g, device=dev) * 1e-3, torch.randn(n, generator=g, device=dev))
        xs = torch.rand(m, 1, generator=g, device=dev) * 1e-2
        if not torch.equal(quant.qdense_pre(a, xs, p), quant._dequant(quant._int_mm(a, p.w_q), xs, p, torch.bfloat16)):
            raise SystemExit(f"qdense_pre {name}: not bit for bit torch._int_mm and the dequant passes")
        timed(f"qdense_pre {name} ({m}x{k} -> {n})", lambda: quant.qdense_pre(a, xs, p), host=name == "adaLN")
    log(json.dumps({"linear": out}))
    return 0


def attn_tol(ref) -> dict:
    """One bf16 ulp of the element (rtol 2^-7: the two sides may round the
    same value to neighbours) plus 2^-8 of the largest |output| (atol: the
    kernel rounds p to bf16 before normalising it, the plain version after,
    an error absolute in the output's scale, which is ~0.05 for random q, k,
    v, not ~1)."""
    return dict(rtol=2**-7, atol=2**-8 * float(ref.float().abs().max()))


def opt_in_attention(dev, b: int, strict: bool = True) -> dict:
    """#7 and #8 at the DiT B/1 attention shapes of a CFG-doubled batch of
    b (b, 12, 1024, 64) bf16: each against its plain version, timed warm
    beside its plain version and SDPA on the pre-normed and rotated q, k;
    its pre-pass and attention apart (torch.profiler; strict: the attention
    must be ``flash_fwd_wgmma_kernel``, else the run fails); the host time a
    call of its wrapper. Returns name -> (max_abs_err, ms, plain_ms,
    library_ms, bound_ms, bound_by, parts)."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

    g = torch.Generator(device=dev).manual_seed(7)
    h, n, d = 12, 1024, 64

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).bfloat16()

    cos, sin = (torch.from_numpy(to_half_layout(t)).to(dev) for t in build_rope_table(d // 2, 32))
    # q, k, v (and out) once each, the tables; the two products and the exponentials
    work = dict(bf16_flops=4 * b * h * n * n * d, exps=b * h * n * n)
    rows = {}

    log(f"[kernel] flash_attention_qknorm_rope q,k,v ({b},{h},{n},{d}) bf16, qk-norm weights ({d},) fp32")
    q, k, v = randn(b, h, n, d, scale=3.0), randn(b, h, n, d, scale=3.0), randn(b, h, n, d)
    qs, ks = (1 + 0.1 * torch.randn(d, generator=g, device=dev) for _ in range(2))

    def run7():
        return fa.flash_attention_qknorm_rope(q, k, v, qs, ks, cos, sin)

    ref = fa.flash_attention_qknorm_rope_plain(q, k, v, qs, ks, cos, sin)
    err = compare("flash_attention_qknorm_rope", run7(), ref, **attn_tol(ref))
    del ref
    ms = cuda_ms(run7, 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_qknorm_rope_plain(q, k, v, qs, ks, cos, sin), 3, 1)
    qr, kr = fa._qknorm_rope_fp32(q, qs, cos, sin), fa._qknorm_rope_fp32(k, ks, cos, sin)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v), 20)
    parts = rope_parts(run7, strict) | {"host_ms": host_ms(run7)}
    rows["flash_attention_qknorm_rope"] = (err, ms, plain_ms, lib_ms, *bound(
        4 * b * h * n * d * 2 + 2 * n * d * 4 + 2 * d * 4, **work), parts)
    del q, k, v, qr, kr

    log(f"[kernel] flash_attention_fused_rope q,k ({b},{n},{h},{d}) bf16, v a view of qkv ({b},{n},3,{h},{d})")
    qkv = randn(b, n, 3, h, d)
    q, k, v = qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(), qkv[:, :, 2]

    def run8():
        return fa.flash_attention_fused_rope(q, k, v, cos, sin)

    ref = fa.flash_attention_fused_rope_plain(q, k, v, cos, sin)
    err = compare("flash_attention_fused_rope", run8(), ref, **attn_tol(ref))
    ms = cuda_ms(run8, 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_fused_rope_plain(q, k, v, cos, sin), 3, 1)
    qr, kr = (fa._rope_fp32(t.transpose(1, 2), cos, sin) for t in (q, k))
    vt = v.transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, vt), 20)
    parts = rope_parts(run8, strict) | {"host_ms": host_ms(run8)}
    rows["flash_attention_fused_rope"] = (err, ms, plain_ms, lib_ms, *bound(
        4 * b * h * n * d * 2 + 2 * n * d * 4, **work), parts)
    del qkv, q, k, v, qr, kr, vt, ref
    torch.cuda.empty_cache()
    return rows


def attention_only(dev) -> int:
    """``--attention``: the d = 64 attention forwards alone, through
    wrappers an earlier tree has too, so that copied into an unpacked
    parent it times the parent's by the same means: #7 and #8 at batch 8
    and 36 (``opt_in_attention``, not strict), #1 at batch 8 and 36 and at
    the training shape and #2 at d = 64 at the training shape (kernel and
    SDPA, warm; #1's two kernels apart), then the SHORT_STEPS-step sampling
    seconds under flash_rope, flash_qkr and flash_fused. Ends with an
    ``{"attention": {...}}`` line."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch import kernels
    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    rate_probes(dev)
    out = {}
    g = torch.Generator(device=dev).manual_seed(12)
    cos, sin = (torch.from_numpy(to_half_layout(t)).to(dev) for t in build_rope_table(32, 32))
    for what, b in ((f"batch {BATCH}", 2 * BATCH), (f"batch {BENCH_BATCH}", 2 * BENCH_BATCH),
                    ("training", TRAIN_BATCH)):
        if what != "training":
            for name, (err, ms, plain_ms, lib_ms, bound_ms, _, parts) in opt_in_attention(dev, b, False).items():
                out[f"{name} ({what})"] = {"max_abs_err": err, "ms": ms, "library_ms": lib_ms,
                                           "bound_ms": bound_ms} | parts
        q, k, v = (torch.randn(b, 12, 1024, 64, generator=g, device=dev).bfloat16() for _ in range(3))
        qr, kr = fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin)
        out[f"flash_attention_rope ({what})"] = {
            "ms": cuda_ms(lambda: fa.flash_attention_rope(q, k, v, cos, sin), 20),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v), 20),
        } | rope_parts(lambda: fa.flash_attention_rope(q, k, v, cos, sin), False)
        if what == "training":
            out[f"flash_attention d=64 ({what})"] = {
                "ms": cuda_ms(lambda: fa.flash_attention(q, k, v), 20),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)}
        del q, k, v, qr, kr
    for key, r in out.items():
        log(f"  {key}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in r.items()))
    spec, bundle = build_models(dev)
    y = torch.arange(BATCH, device=dev) * 125 % 1000
    z = torch.randn(BATCH, 16, 32, 32, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    out["sampling_seconds"] = impl_seconds(spec, bundle, y, z, dev)
    log(json.dumps({"attention": out}))
    return 0


def kernel_phases(dev, batch: int) -> dict:
    """Each kernel against its plain version at the shapes that sampling at
    ``batch`` images gives it: the CFG-doubled DiT step (2 * batch) and the
    VMAE decode (batch). Returns name -> (max_abs_err, ms, plain_ms,
    library_ms, bound_ms, bound_by)."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops import fused_adaln as fad
    from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

    g = torch.Generator(device=dev).manual_seed(0)
    # norm and GEMM: both sides make the same roundings in another fp32
    # summation order, and a one-ulp flip early can grow to two through the
    # later bf16 roundings: two ulps of an output of magnitude ~1 (2^-6).
    tol = dict(rtol=2**-6, atol=2**-6)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    rows = {}
    b2 = 2 * batch
    # -- 1: flash_attention_rope, DiT B/1 attention in a CFG-doubled step
    b, h, n, d = b2, 12, 1024, 64
    log(f"[kernel] flash_attention_rope q,k,v ({b},{h},{n},{d}) bf16, cos/sin ({n},{d}) fp32")
    q, k, v = randn(b, h, n, d), randn(b, h, n, d), randn(b, h, n, d)
    cos, sin = (torch.from_numpy(to_half_layout(t)).to(dev) for t in build_rope_table(d // 2, 32))
    ref = fa.flash_attention_rope_plain(q, k, v, cos, sin)
    err = compare("flash_attention_rope", fa.flash_attention_rope(q, k, v, cos, sin), ref, **attn_tol(ref))
    ms = cuda_ms(lambda: fa.flash_attention_rope(q, k, v, cos, sin), 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_rope_plain(q, k, v, cos, sin), 3, 1)
    qr, kr = fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v), 20)
    parts = rope_parts(lambda: fa.flash_attention_rope(q, k, v, cos, sin))
    rows["flash_attention_rope"] = (err, ms, plain_ms, lib_ms, *bound(
        4 * b * h * n * d * 2 + 2 * n * d * 4, 4 * b * h * n * n * d, exps=b * h * n * n), parts)
    del q, k, v, qr, kr

    # -- 2: flash_attention, VMAE decoder attention (head dim 16): the resident kernel
    b, h, n, d = batch, 12, 1024, 16
    log(f"[kernel] flash_attention_resident q,k,v ({b},{h},{n},{d}) bf16; ragged N = 1025 and 1000, d = 8")
    q, k, v = randn(b, h, n, d), randn(b, h, n, d), randn(b, h, n, d)
    ref = fa.flash_attention_plain(q, k, v)
    err = compare("flash_attention_resident", fa.flash_attention(q, k, v), ref, **attn_tol(ref))
    # ragged: a cls token past 1,024 patches (1,025: one key in the last
    # chunk of 128) and N = 1000 (104 keys there), so a dropped or mis-masked
    # chunk moves the outputs by far more than the tolerance; d = 8 padded
    for shape in ((2, h, 1025, d), (2, h, 1000, d), (b, h, n, 8)):
        qs, ks, vs = randn(*shape), randn(*shape), randn(*shape)
        r = fa.flash_attention_plain(qs, ks, vs)
        compare(f"flash_attention_resident{list(shape)}", fa.flash_attention(qs, ks, vs), r, **attn_tol(r))
    del ref
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 50)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 3, 1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 50)
    # the mma.sync core the resident kernel replaced (the library's forward at d = 16)
    core_ms = cuda_ms(lambda: fa._launch(q, k, v, "flash_attention"), 50)
    # device time alone (the profiler): at batch 8 the host's launch work
    # per call is of the kernel's order
    alone = {"device_ms": device_ms(lambda: fa.flash_attention(q, k, v)),
             "mma_core_device_ms": device_ms(lambda: fa._launch(q, k, v, "flash_attention")),
             "library_device_ms": device_ms(lambda: F.scaled_dot_product_attention(q, k, v))}
    bnd = bound(4 * b * h * n * d * 2, 4 * b * h * n * n * d, exps=b * h * n * n)
    log(f"  flash_attention_resident (batch {batch}): resident {ms:.4f} ms, mma.sync core {core_ms:.4f} ms, "
        f"SDPA {lib_ms:.4f} ms; SDPA / resident {lib_ms / ms:.3f}, core / resident {core_ms / ms:.3f}; bound "
        f"{bnd[0]:.4f} ms ({b * h * n * n:.4g} exponentials at the measured {RATES['ex2']:.4g}/s), share "
        f"{bnd[0] / ms:.3f}; device time alone: " + ", ".join(f"{k[:-3]} {fmt_ms(v)}" for k, v in alone.items()))
    rows["flash_attention_resident"] = (err, ms, plain_ms, lib_ms, *bnd, {"mma_core_ms": core_ms} | alone)
    del q, k, v

    # -- 3 and 9: fused_norm_modulate(_quant), the DiT adaLN epilogue (bf16
    # and w8a8) in a CFG-doubled step
    rows |= adaln_row_kernels(dev, b2, f"(batch {batch})")

    # -- 4: fused_matmul_silu, SwiGLU w12 in a CFG-doubled step (M = 2 * batch * 1024)
    m, d, h2 = b2 * 1024, 768, 4096
    log(f"[kernel] fused_matmul_silu x ({m},{d}) bf16, w12 ({h2},{d}) bf16, b12 ({h2},) fp32")
    x = randn(m, d)
    w12 = randn(h2, d, scale=d**-0.5)
    b12 = randn(h2, scale=0.1, dtype=torch.float32)
    err = compare("fused_matmul_silu", fad.fused_matmul_silu(x, w12, b12),
                  fad.fused_matmul_silu_plain(x, w12, b12), **tol)
    ms = cuda_ms(lambda: fad.fused_matmul_silu(x, w12, b12), 20)
    plain_ms = cuda_ms(lambda: fad.fused_matmul_silu_plain(x, w12, b12), 3, 1)
    b12_bf16 = b12.to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: torch.addmm(b12_bf16, x, w12.t()), 20)
    rows["fused_matmul_silu"] = (err, ms, plain_ms, lib_ms,
                                 *bound((m * d + h2 * d + m * h2 // 2) * 2 + h2 * 4, 2 * m * d * h2), {})
    del x, w12

    # -- 7 and 8: the opt-in impls flash_qkr and flash_fused, on the wgmma forward
    rows |= opt_in_attention(dev, b2)

    # -- 10: fused_silu_mul_quant, the w8a8 SwiGLU gate (M = 2 * batch * 1024)
    m, h = b2 * 1024, 2048
    log(f"[kernel] fused_silu_mul_quant x12 ({b2},1024,{2 * h}) bf16 -> int8 ({b2},1024,{h}) + fp32 scales")
    x12 = randn(b2, 1024, 2 * h, scale=2.0)
    err = compare_quant("fused_silu_mul_quant", fad.fused_silu_mul_quant(x12),
                        fad.fused_silu_mul_quant_plain(x12))
    ms = cuda_ms(lambda: fad.fused_silu_mul_quant(x12), 50)
    plain_ms = cuda_ms(lambda: fad.fused_silu_mul_quant_plain(x12), 10)
    # per output: exp, add, divide, two products, absmax, divide, round
    rows["fused_silu_mul_quant"] = (err, ms, plain_ms, None, *bound(
        m * 2 * h * 2 + m * h + m * 4, fp32_flops=8 * m * h), {})
    del x12
    torch.cuda.empty_cache()

    for name, (err, ms, plain_ms, lib_ms, bound_ms, bound_by, parts) in rows.items():
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        split = "".join(f", {k} {v:.4f}" if isinstance(v, float) else f", {k} {v}" for k, v in parts.items())
        log(f"  {name} (batch {batch}): kernel {ms:.4f} ms{split}, plain {plain_ms:.4f} ms, library {lib} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), share of bound {bound_ms / ms:.3f}")
    return rows


def linear_timings(run, lib=None) -> dict:
    """The times of a linear-layer kernel (and of its library yardstick):
    warm (``cuda_ms``, median of three windows of 20 calls; reads the
    host's launch time where that is the longer), queued (the device's time
    alone) and with a cold L2."""
    warm = sorted(cuda_ms(run, 20) for _ in range(3))
    out = {"ms": warm[1], "queued_ms": queued_ms(run), "cold_ms": cold_ms(run)}
    if lib is not None:
        out |= {"library_ms": cuda_ms(lib, 20), "library_queued_ms": queued_ms(lib)}
    return out


# the w8a8 leg's int8 linears on B/1 (name, K, N); M = 2 * batch * 1024 tokens
# under CFG, the adaLN linear's 2 * batch rows
INT8_SHAPES = (("qkv", 768, 2304), ("w12", 768, 4096), ("w3", 2048, 768), ("adaLN", 768, 4608))


def int8_gemm_phase(dev, batch: int) -> dict:
    """``int8_dense``, the w8a8 linear (int8 wgmma with the dequant in its
    epilogue), at the path's four shapes under CFG at ``batch`` images: bit
    for bit its plain version (``torch._int_mm``, then the fp32 dequant
    passes), and in fp32 out at qkv; timed warm, queued and cold
    (``linear_timings``) beside the plain version, ``torch._int_mm`` alone
    (the int32 product, no dequant) and cuBLAS bf16 (``F.linear``) at the
    same shape; bound: int8 operations over 1,979 TOP/s or the bytes (x, w,
    out, scales, bias once each). At batch 8 also the host time a call of
    the wrapper at the adaLN shape, against the plain version's. Returns the
    kernels line's rows: int8_dense at qkv with every shape's numbers among
    its parts, int8_dense_fp32 at qkv."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops.quant import QLinear, _int_mm, int8_dense, int8_dense_plain

    g = torch.Generator(device=dev).manual_seed(5)
    rows, parts = {}, {}
    for name, k, n in INT8_SHAPES:
        m = 2 * batch * (1 if name == "adaLN" else 1024)
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        p = QLinear(w, torch.rand(n, generator=g, device=dev) * 1e-3, torch.randn(n, generator=g, device=dev))
        xs = torch.rand(m, 1, generator=g, device=dev) * 1e-2
        for dtype in (torch.bfloat16, torch.float32) if name == "qkv" else (torch.bfloat16,):
            out, ref = int8_dense(a, xs, p, dtype), int8_dense_plain(a, xs, p, dtype)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise SystemExit(f"int8_dense {name} {dtype}: not bit for bit the plain version "
                                 f"(max |diff| {float((out.float() - ref.float()).abs().max())})")
            t = linear_timings(lambda: int8_dense(a, xs, p, dtype))
            plain_ms = cuda_ms(lambda: int8_dense_plain(a, xs, p, dtype), 10)
            int_mm_ms = queued_ms(lambda: _int_mm(a, w))
            xb, wb = a.bfloat16(), w.bfloat16()
            bf16_ms = queued_ms(lambda: F.linear(xb, wb))
            bnd = bound(m * k + n * k + m * n * out.element_size() + 4 * m + 8 * n, int8_ops=2 * m * k * n)
            fp32 = dtype == torch.float32
            log(f"  int8_dense {name}{' fp32 out' if fp32 else ''} M={m} K={k} N={n} (batch {batch}): bit for bit "
                f"the plain version; warm {t['ms']:.4f} ms, queued {t['queued_ms']:.4f}, cold L2 {t['cold_ms']:.4f}; "
                f"torch._int_mm alone {int_mm_ms:.4f} (queued), plain qdense_pre {plain_ms:.4f}, cuBLAS bf16 "
                f"{bf16_ms:.4f} (queued); bound {bnd[0]:.4f} ms ({bnd[1]}), share {bnd[0] / t['queued_ms']:.3f} "
                f"(queued), {bnd[0] / t['cold_ms']:.3f} (cold); queued / torch._int_mm "
                f"{t['queued_ms'] / int_mm_ms:.3f}")
            key = "int8_dense_fp32" if fp32 else name
            row = {"queued_ms": t["queued_ms"], "cold_ms": t["cold_ms"], "int_mm_ms": int_mm_ms,
                   "cublas_bf16_ms": bf16_ms, "plain_ms": plain_ms, "bound_ms": bnd[0]}
            if fp32:
                rows["int8_dense_fp32"] = (0.0, t["ms"], plain_ms, None, *bnd, row)
            elif name == "qkv":
                rows["int8_dense"] = (0.0, t["ms"], plain_ms, None, *bnd, row)
            else:
                parts |= {f"{key}_{k_}": v for k_, v in row.items()} | {f"{key}_ms": t["ms"]}
            if name == "adaLN" and batch == BATCH:
                host = {"host_ms": host_ms(lambda: int8_dense(a, xs, p, dtype)),
                        "plain_host_ms": host_ms(lambda: int8_dense_plain(a, xs, p, dtype))}
                parts |= {f"adaLN_{k_}": v for k_, v in host.items()}
                log(f"  int8_dense adaLN: host time a call {host['host_ms']:.4f} ms (the plain qdense_pre's "
                    f"torch._int_mm and dequant passes {host['plain_host_ms']:.4f})")
        del a, w, p
    torch.cuda.empty_cache()
    rows["int8_dense"][-1].update(parts)
    return rows


def build_models(dev):
    import torch

    from ldmae_tpu_torch.models import (
        VMAE, LightningDiT, dit_spec, permute_qk_for_half_rope, production_vmae_spec, seeded_init_,
    )

    spec = dit_spec("LightningDiT-B/1", input_size=32, in_channels=16, num_classes=1000,
                    use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True)
    dit = LightningDiT(spec, device=dev)
    seeded_init_(dit, 0)
    dit.load_state_dict(permute_qk_for_half_rope(dit.state_dict(), spec), strict=True)
    vae = VMAE(production_vmae_spec(256), device=dev)
    seeded_init_(vae, 1)
    bundle = {"dit": dit, "vae": vae,
              "latent_mean": torch.zeros(1, 16, 1, 1, device=dev),
              "latent_std": torch.ones(1, 16, 1, 1, device=dev)}
    return spec, bundle


def sampler(spec, steps, dev, kernels: bool, quant=None, attn_impl="flash_rope", dtype=None):
    import torch

    from ldmae_tpu_torch.eval.sampling import make_sample_fn
    from ldmae_tpu_torch.transport import create_transport

    impls = (dict(attn_impl=attn_impl, adaln_impl="fused", mlp_impl="fused") if kernels
             else dict(attn_impl="xla", adaln_impl="xla", mlp_impl="xla"))
    return make_sample_fn(
        spec, create_transport("Linear", "velocity", use_lognorm=True),
        num_steps=steps, sampling_method="euler", timestep_shift=SHIFT, cfg_scale=CFG_SCALE,
        cfg_interval=True, cfg_interval_start=CFG_START, cfg_channels=3,
        compute_dtype=dtype or torch.bfloat16, rope_layout="half", quant_mode=quant, device=dev, **impls,
    )


def check_counts(path: str, counts: dict) -> None:
    log(f"  launches: {counts}")
    if counts != EXPECTED_LAUNCHES[path]:
        raise SystemExit(f"{path}: launch counts {counts} != expected {EXPECTED_LAUNCHES[path]}")


def full_path(path: str, spec, bundle, y, dev, quant=None):
    """One 250-step batch through the entry points, launches counted from 0;
    returns (images, launch counts, seconds)."""
    import torch

    from ldmae_tpu_torch import ops

    sample_fn = sampler(spec, STEPS, dev, kernels=True, quant=quant)
    log(f"[pipeline] {path} warm-up: LightningDiT-B/1 + VMAE f8d16_prev, batch {BATCH}, 4 steps")
    sampler(spec, 4, dev, kernels=True, quant=quant)(bundle, y, generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    log(f"[pipeline] {path} path: batch {BATCH}, {STEPS} Euler steps, shift {SHIFT}, CFG {CFG_SCALE} "
        f"on [{CFG_START}, 1] (phased: {N1} single-batch steps), decode to uint8")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    imgs = sample_fn(bundle, y, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check_counts(path, counts)
    if imgs.shape != (BATCH, 256, 256, 3) or imgs.dtype != torch.uint8:
        raise SystemExit(f"images {tuple(imgs.shape)} {imgs.dtype}, expected ({BATCH}, 256, 256, 3) uint8")
    spread = float(imgs.float().std())
    if not spread > 1.0:
        raise SystemExit(f"images are flat (std {spread}): the pipeline did not move them")
    log(f"  images {tuple(imgs.shape)} uint8, pixel std {spread:.3f}; {seconds:.4f} s per batch of "
        f"{BATCH}, {BATCH / seconds:.4f} images/s, peak memory {peak_gb:.3f} GB "
        f"on {torch.cuda.get_device_name(0)}")
    return imgs, counts, seconds


def short_compare(what: str, spec, bundle, y, z, dev, kernel_kw: dict, ref_kw: dict, decode_impl: str,
                  count_path=None, dtype=None):
    """SHORT_STEPS steps from z through two impl sets; the latents within 5e-2
    of their scale (fp32: 1e-2, where the w8a8 leg's int8 roundings may
    still flip), and the kernel path's latents decoded by ``decode_impl``
    within 8 levels of the plain ``xla`` decode of the same latents (fp32: 2
    levels). With ``count_path``, the first run's launches
    are counted exactly."""
    import torch

    from ldmae_tpu_torch import ops

    dtype = dtype or torch.bfloat16
    lat_tol, px_tol = (1e-2, 2) if dtype == torch.float32 else (5e-2, 8)
    log(f"[pipeline] {SHORT_STEPS} steps: {what} from the same noise")
    latents = bundle | {"vae": None}
    ops.reset_launch_counts()
    lat_k = sampler(spec, SHORT_STEPS, dev, dtype=dtype, **kernel_kw)(latents, y, z=z)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if count_path:
        check_counts(count_path, counts)
    lat_x = sampler(spec, SHORT_STEPS, dev, dtype=dtype, **ref_kw)(latents, y, z=z)
    if not (torch.isfinite(lat_k).all() and lat_k.shape == (BATCH, 16, 32, 32)):
        raise SystemExit(f"{what}: latents are not finite ({BATCH}, 16, 32, 32)")
    lat_rel = float((lat_k - lat_x).abs().max() / lat_x.abs().max())
    moved = float((lat_x - z).abs().max())
    vae = bundle["vae"]
    img_k = vae.decode_to_images(lat_k, compute_dtype=dtype, attn_impl=decode_impl)
    img_x = vae.decode_to_images(lat_k, compute_dtype=dtype, attn_impl="xla")
    px = int((img_k.int() - img_x.int()).abs().max())
    px_paths = int((img_x.int() - vae.decode_to_images(lat_x, compute_dtype=dtype,
                                                       attn_impl="xla").int()).abs().max())
    ok = lat_rel <= lat_tol and moved > 1e-2 and px <= px_tol
    log(f"  latents max rel err {lat_rel:.6g} (tolerance {lat_tol:g}: {dtype} roundings in other places, "
        f"compounded over {SHORT_STEPS} CFG-10 steps); latents moved {moved:.4g} from z; decode "
        f"{decode_impl} vs xla max pixel diff {px} (tolerance {px_tol} levels); images of the two paths' "
        f"latents differ by up to {px_paths} levels -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{what}: the two paths disagree")
    return counts


def impl_seconds(spec, bundle, y, z, dev) -> dict:
    """Seconds of one SHORT_STEPS-step bf16 batch (latents only, from z)
    under each DiT attention impl, flash_rope (#1), flash_qkr (#7) and
    flash_fused (#8), and flash_qkr with its q, k, v copied contiguous
    first (as the attention module passed them before #7 took views),
    after a warm-up run of each, timed in turns and back: impl -> its two
    readings."""
    import torch

    from ldmae_tpu_torch.ops import attention as attention_module

    kernel = attention_module.flash_attention_qknorm_rope

    def with_copies(q, k, v, *rest):
        return kernel(q.contiguous(), k.contiguous(), v.contiguous(), *rest)

    runs = {"flash_rope": "flash_rope", "flash_qkr": "flash_qkr", "flash_qkr+copies": "flash_qkr",
            "flash_fused": "flash_fused"}
    latents = bundle | {"vae": None}
    fns = {impl: sampler(spec, SHORT_STEPS, dev, kernels=True, attn_impl=impl) for impl in set(runs.values())}

    def run(label):
        attention_module.flash_attention_qknorm_rope = with_copies if label.endswith("+copies") else kernel
        try:
            fns[runs[label]](latents, y, z=z)
        finally:
            attention_module.flash_attention_qknorm_rope = kernel

    for label in runs:
        run(label)
    seconds = {label: [] for label in runs}
    for label in [*runs, *reversed(runs)]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(label)
        torch.cuda.synchronize()
        seconds[label].append(time.perf_counter() - t0)
    log(f"[pipeline] {SHORT_STEPS} steps, batch {BATCH}, latents only, seconds by attention impl (in turns): "
        + ", ".join(f"{impl} {' / '.join(f'{t:.4f}' for t in ts)}" for impl, ts in seconds.items()))
    return seconds


def psnr(a, b) -> float:
    """PSNR of two uint8 image batches, as perf_quant.py computes it."""
    d = a.double() - b.double()
    return 10 * math.log10(255.0**2 / max(float((d * d).mean()), 1e-9))


def pipeline_phases(dev, profile: bool = False) -> dict:
    import torch

    from ldmae_tpu_torch.models import quantize_dit_

    spec, bundle = build_models(dev)
    y = torch.arange(BATCH, device=dev) * 125 % 1000
    imgs, counts_bf16, sec_bf16 = full_path("bf16", spec, bundle, y, dev)

    # path (a): the same seeded weights, quantized, and the same noise
    qbundle = bundle | {"dit": quantize_dit_(copy.deepcopy(bundle["dit"]))}
    qimgs, counts_w8a8, sec_w8a8 = full_path("w8a8", spec, qbundle, y, dev, quant="w8a8")
    db = psnr(qimgs, imgs)
    mae = float((qimgs.float() - imgs.float()).abs().mean())
    log(f"[pipeline] w8a8 vs bf16, {STEPS} steps, same weights and noise: PSNR {db:.4f} dB "
        f"(gate {PSNR_MIN} dB), MAE {mae:.4f}/255; seconds per batch of {BATCH}: w8a8 {sec_w8a8:.4f} "
        f"({BATCH / sec_w8a8:.4f} images/s), bf16 {sec_bf16:.4f} ({BATCH / sec_bf16:.4f} images/s), "
        f"w8a8/bf16 time {sec_w8a8 / sec_bf16:.4f}")
    if not db >= PSNR_MIN:
        raise SystemExit(f"w8a8 images are {db:.2f} dB from the bf16 ones (gate {PSNR_MIN} dB)")

    z = torch.randn(BATCH, 16, 32, 32, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    short_compare("bf16 kernels vs the plain xla impls", spec, bundle, y, z, dev,
                  dict(kernels=True), dict(kernels=False), "flash_rope")
    short_compare("w8a8 kernels vs the w8a8 xla impls", spec, qbundle, y, z, dev,
                  dict(kernels=True, quant="w8a8"), dict(kernels=False, quant="w8a8"), "flash_rope")
    counts = {"bf16": counts_bf16, "w8a8": counts_w8a8}
    for impl in ("flash_qkr", "flash_fused"):
        counts[impl] = short_compare(f"attention_impl {impl} vs flash_rope", spec, bundle, y, z, dev,
                                     dict(kernels=True, attn_impl=impl), dict(kernels=True), impl,
                                     count_path=impl)
    impl_seconds(spec, bundle, y, z, dev)
    # the same 10-step paths in fp32 (parallel.compute_dtype: float32): the
    # fp32 kernels against the fp32 xla impls, the opt-in impls against fp32 flash_rope
    f32 = torch.float32
    fbundle, fqbundle = bundle, qbundle  # fp32 weights; the compute dtype casts
    counts["sample_fp32"] = short_compare("fp32 kernels vs the fp32 xla impls", spec, fbundle, y, z, dev,
                                          dict(kernels=True), dict(kernels=False), "flash", "sample_fp32", f32)
    counts["sample_fp32_w8a8"] = short_compare(
        "fp32 w8a8 kernels vs the fp32 w8a8 xla impls", spec, fqbundle, y, z, dev, dict(kernels=True, quant="w8a8"),
        dict(kernels=False, quant="w8a8"), "flash", "sample_fp32_w8a8", f32)
    for impl in ("flash_qkr", "flash_fused"):
        counts[f"sample_fp32_{impl[6:]}"] = short_compare(
            f"fp32 attention_impl {impl} vs fp32 flash_rope", spec, fbundle, y, z, dev,
            dict(kernels=True, attn_impl=impl), dict(kernels=True), impl, f"sample_fp32_{impl[6:]}", f32)
    quant_gate(spec, bundle, qbundle, y, dev)
    if profile:
        sampling_profile(spec, bundle, y, dev)
        sampling_profile(spec, qbundle, y, dev, quant="w8a8")
    return {"counts": counts, "seconds": {"bf16": sec_bf16, "w8a8": sec_w8a8}}


def quant_gate(spec, bundle, qbundle, y, dev) -> None:
    """The w8a8 leg against bf16 on what the DiT computes: SHORT_STEPS-step
    latents of both kernel paths from the same noise z, their difference
    relative to what the bf16 path moved the latents (L2 norms,
    ||w8a8 - bf16|| / ||bf16 - z||) within QUANT_REL_MAX at each noise of
    QUANT_NOISE_SEEDS. Two controls
    show the bound can fail: the quantized DiT with every weight scale 10 %
    high, and with its int8 weights on a 16-step (4-bit) grid; each must
    read above the bound. (The PSNR of the decoded images cannot tell these
    apart: the random-weight VMAE decodes to near-flat images.)"""
    import torch

    from ldmae_tpu_torch.ops.quant import QLinear

    def control(fn):
        dit = copy.deepcopy(qbundle["dit"])
        with torch.no_grad():
            for m in dit.modules():
                if isinstance(m, QLinear):
                    fn(m)
        return qbundle | {"dit": dit}

    def latents(b, z, quant):
        return sampler(spec, SHORT_STEPS, dev, kernels=True, quant=quant)(b | {"vae": None}, y, z=z)

    def rel(lat, ref, z):
        if not (torch.isfinite(lat).all() and lat.shape == ref.shape):
            raise SystemExit("quant gate: latents are not finite")
        d, moved = lat.float() - ref.float(), ref.float() - z
        return float(d.norm() / moved.norm()), float(d.abs().max() / moved.abs().max())

    controls = {
        "weight scales x 1.1": control(lambda m: m.w_scale.mul_(1.1)),
        "int8 weights on a 16-step grid": control(
            lambda m: m.w_q.copy_((m.w_q.float() / 16).round().mul(16).clamp(-127, 127).to(torch.int8))),
    }
    log(f"[pipeline] {SHORT_STEPS} steps: w8a8 vs bf16 latents from the same noise "
        f"(bound {QUANT_REL_MAX} relative L2, relative to the bf16 path's move from the noise)")
    ok = True
    for seed in QUANT_NOISE_SEEDS:
        z = torch.randn(BATCH, 16, 32, 32, generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
        ref = latents(bundle, z, None)
        l2, mx = rel(latents(qbundle, z, "w8a8"), ref, z)
        ok &= l2 <= QUANT_REL_MAX
        log(f"  noise seed {seed}: w8a8 relative L2 error {l2:.6g}, max err / max move {mx:.6g} "
            f"(bound {QUANT_REL_MAX}) -> {'ok' if l2 <= QUANT_REL_MAX else 'FAIL'}")
        if seed != QUANT_NOISE_SEEDS[0]:
            continue
        for name, b in controls.items():
            l2, mx = rel(latents(b, z, "w8a8"), ref, z)
            ok &= l2 > QUANT_REL_MAX
            log(f"  noise seed {seed}: control ({name}) relative L2 error {l2:.6g}, max err / max move {mx:.6g} "
                f"(must exceed {QUANT_REL_MAX}) -> {'ok' if l2 > QUANT_REL_MAX else 'FAIL'}")
    if not ok:
        raise SystemExit("quant gate: w8a8 latents out of bound, or a wrongly quantized DiT within it")


# ---------------------------------------------------------------------------
# DiT training
# ---------------------------------------------------------------------------


def wrong_bwd_no_rowsum(q, k, v, g):
    """A wrong backward (control): ds = p * dp, the rowsum(dp * p) term left out."""
    import torch

    scale = q.shape[-1] ** -0.5
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(qf @ kf.transpose(-1, -2) * scale, dim=-1)
    ds = p * (gf @ vf.transpose(-1, -2))
    return ((ds @ kf * scale).to(q.dtype), (ds.transpose(-1, -2) @ qf * scale).to(k.dtype),
            (p.transpose(-1, -2) @ gf).to(v.dtype))


def wrong_rope_bwd_untransposed(q, k, v, g, cos, sin, out=None, lse=None):
    """A wrong backward (control): the RoPE Jacobian applied to dq, dk
    untransposed (the forward rotation instead of its transpose); takes and
    ignores the forward's residuals, as the kernel's wrapper takes them."""
    from ldmae_tpu_torch.ops import flash_attention as fa

    dqr, dkr, dv = fa._attention_bwd_fp32(fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin), v, g)
    return (fa._rotate_fp32(dqr, cos, sin).to(q.dtype), fa._rotate_fp32(dkr, cos, sin).to(k.dtype),
            dv.to(v.dtype))


def bwd_errors(outs, refs) -> tuple[float, float]:
    """max over dq, dk, dv of the relative L2 error and of max |error| / max |value|."""
    import torch

    torch.cuda.synchronize()
    rel = elem = 0.0
    for out, ref in zip(outs, refs):
        if not bool(torch.isfinite(out.float()).all()):
            return math.inf, math.inf
        d = out.float() - ref.float()
        rel = max(rel, float(d.norm() / ref.float().norm()))
        elem = max(elem, float(d.abs().max() / ref.float().abs().max()))
    return rel, elem


def train_kernel_phase(dev) -> dict:
    """#5 and #6 at the DiT B/1 training shapes, given the forward's output
    and lse (the residuals the autograd Functions save), against their plain
    backward and two wrong backwards; their times (the backward alone, and
    by kernel) beside the plain backward and the SDPA backward; #1 and #3
    timed at the training shapes. Returns name -> (max_abs_err, ms,
    plain_ms, library_ms, bound_ms, bound_by, parts)."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

    gen = torch.Generator(device=dev).manual_seed(11)
    b, h, n, d = TRAIN_BATCH, 12, 1024, 64
    # q and k at twice unit scale: peaked attention rows, where leaving out
    # the rowsum term moves dq and dk by far more than the bound
    q, k = (torch.randn(b, h, n, d, generator=gen, device=dev).mul(2).bfloat16() for _ in range(2))
    v, g = (torch.randn(b, h, n, d, generator=gen, device=dev).bfloat16() for _ in range(2))
    cos, sin = (torch.from_numpy(to_half_layout(t)).to(dev) for t in build_rope_table(d // 2, 32))
    rows = {}
    for name, kernel, plain, wrongs, tables in (
        ("flash_attention_bwd", fa.flash_attention_bwd, fa.flash_attention_bwd_plain,
         {"no rowsum term": wrong_bwd_no_rowsum}, ()),
        ("flash_attention_rope_bwd", fa.flash_attention_rope_bwd, fa.flash_attention_rope_bwd_plain,
         {"no rowsum term": lambda q, k, v, g, cos, sin: wrong_bwd_no_rowsum(
             fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin), v, g),
          "untransposed RoPE Jacobian": wrong_rope_bwd_untransposed}, (cos, sin)),
    ):
        log(f"[train kernel] {name} q,k,v,g ({b},{h},{n},{d}) bf16" + (", cos/sin (1024,64) fp32" if tables else "")
            + "; the forward's output and lse (fp32) passed in")
        o, lse = fa._launch(q, k, v, name, *tables, with_lse=True)  # the library, uncounted

        def run():
            return kernel(q, k, v, g, *tables, out=o, lse=lse)

        ref = plain(q, k, v, g, *tables)
        out = run()
        rel, elem = bwd_errors(out, ref)
        ok = rel <= BWD_REL_L2 and elem <= BWD_ELEM
        log(f"  kernel vs plain backward: relative L2 {rel:.6g} (bound {BWD_REL_L2}), max |err| / max |value| "
            f"{elem:.6g} (bound {BWD_ELEM}) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{name}: kernel disagrees with its plain backward")
        for what, wrong in wrongs.items():
            wrel, welem = bwd_errors(wrong(q, k, v, g, *tables), ref)
            log(f"  control ({what}) vs plain backward: relative L2 {wrel:.6g}, max |err| / max |value| "
                f"{welem:.6g} (must exceed {BWD_REL_L2} or {BWD_ELEM}) -> "
                f"{'ok' if wrel > BWD_REL_L2 or welem > BWD_ELEM else 'FAIL'}")
            if not (wrel > BWD_REL_L2 or welem > BWD_ELEM):
                raise SystemExit(f"{name}: a wrong backward ({what}) reads within the bound")
        err = max(float((o.float() - r.float()).abs().max()) for o, r in zip(out, ref))
        del out, ref
        ms = cuda_ms(run, 10)
        kernel_of = ({"prepass": "norm_rope_kernel"} if tables else {}) | {
            "preprocess": "flash_bwd_preprocess_kernel", "main": "flash_bwd_wgmma_kernel",
            "postprocess": "flash_bwd_postprocess_kernel"}
        by_name = kernel_device_ms(run, tuple(kernel_of.values()))
        parts = {f"{part}_ms": by_name[kern] for part, kern in kernel_of.items()}
        plain_ms = cuda_ms(lambda: plain(q, k, v, g, *tables), 3, 1)
        qs, ks = (fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin)) if tables else (q, k)
        qs, ks, vs = (t.detach().requires_grad_() for t in (qs, ks, v))

        def sdpa_fwd_bwd():
            torch.autograd.grad(F.scaled_dot_product_attention(qs, ks, vs), (qs, ks, vs), g)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qs, ks, vs)

        fb_ms, f_ms = cuda_ms(sdpa_fwd_bwd, 10), cuda_ms(sdpa_fwd, 10)
        # q, k, v, g, o in, dq, dk, dv out (bf16), lse in (fp32), the tables
        bnd = bound(8 * b * h * n * d * 2 + b * h * n * 4 + (2 * n * d * 4 if tables else 0),
                    10 * b * h * n * n * d, exps=b * h * n * n)
        rows[name] = (err, ms, plain_ms, fb_ms - f_ms, *bnd, parts)
        split = ", ".join(f"{key[:-3]} {v:.4f}" for key, v in parts.items())
        log(f"  {name} (training shapes): kernel {ms:.4f} ms ({split}; main kernel's share of bound "
            f"{bnd[0] / parts['main_ms']:.3f}), plain {plain_ms:.4f} ms, library "
            f"{fb_ms - f_ms:.4f} ms (SDPA backward = fwd+bwd {fb_ms:.4f} ms minus fwd {f_ms:.4f} ms), "
            f"kernel / library {ms / (fb_ms - f_ms):.3f}, bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"share of bound {bnd[0] / ms:.3f}")
        del qs, ks, vs, o, lse

    # #2 at d = 64, the forward of the interleaved training (the wgmma kernel)
    log(f"[train kernel] flash_attention q,k,v ({b},{h},{n},{d}) bf16 (no RoPE; the wgmma forward)")
    ref = fa.flash_attention_plain(q, k, v)
    err = compare("flash_attention[d=64]", fa.flash_attention(q, k, v), ref, rtol=2**-7,
                  atol=2**-8 * float(ref.float().abs().max()))
    del ref
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 3, 1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    bnd = bound(4 * b * h * n * d * 2, 4 * b * h * n * n * d, exps=b * h * n * n)
    rows["flash_attention"] = (err, ms, plain_ms, lib_ms, *bnd, {})
    log(f"  flash_attention (training shapes): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}), share of bound {bnd[0] / ms:.3f}")

    # the forward kernels of the training path at its shapes
    fwd_ms = cuda_ms(lambda: fa.flash_attention_rope(q, k, v, cos, sin), 20)
    qr, kr = fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v), 20)
    bnd = bound(4 * b * h * n * d * 2 + 2 * n * d * 4, 4 * b * h * n * n * d, exps=b * h * n * n)
    parts = rope_parts(lambda: fa.flash_attention_rope(q, k, v, cos, sin))
    log(f"  flash_attention_rope (training shapes): kernel {fwd_ms:.4f} ms (pre-pass {parts['prepass_ms']:.4f}, "
        f"attention {parts['attention_ms']:.4f}), SDPA {lib_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    del q, k, v, g, qr, kr
    adaln_row_kernels(dev, b, "(training shape)")
    torch.cuda.empty_cache()
    return rows


def _yaml_config(**sections):
    """The shipped B/1 YAML with its train and data sections replaced."""
    import yaml

    with open("configs/imagenet/lightningdit_b_vmae_f8d16.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg.update(sections)
    return cfg


def grad_check_phase(dev, dtype=None, layout: str = "half", count_path=None, grad_bound: float = GRAD_REL_L2):
    """One train step of B/1 at full width, depth GRAD_DEPTH, batch
    GRAD_BATCH: loss and per-leaf gradients of the kernel path (the YAML's
    impls, remat 'attn'; with ``layout`` 'interleaved', RoPE outside the
    kernel, flash_attention and its backward) against the xla path (plain
    attention, xla adaLN, no remat), from the same seeded weights, noise, t
    and label drops, in ``dtype`` (bf16 by default); with ``count_path`` the
    kernel path's launches counted exactly. In bf16 with half RoPE, then the
    kernel path with the untransposed RoPE Jacobian, which must read above
    the bound."""
    import dataclasses

    import torch

    from ldmae_tpu_torch import ops

    dtype = dtype or torch.bfloat16

    from ldmae_tpu_torch.models import LightningDiT, dit_spec, permute_qk_for_half_rope, seeded_init_
    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.train import dit_loss
    from ldmae_tpu_torch.transport import create_transport

    spec = dit_spec("LightningDiT-B/1", depth=GRAD_DEPTH, input_size=32, in_channels=16, num_classes=1000,
                    use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True)
    sd = seeded_init_(LightningDiT(spec, device="cpu"), 5).state_dict()
    gen = torch.Generator(device=dev).manual_seed(6)
    x1, x0 = (torch.randn(GRAD_BATCH, 16, 32, 32, generator=gen, device=dev) for _ in range(2))
    y = torch.arange(GRAD_BATCH, device=dev) * 97 % 1000
    t = torch.linspace(0.1, 0.9, GRAD_BATCH, device=dev)
    drop = (torch.arange(GRAD_BATCH, device=dev) % 4 == 0).int()
    transport = create_transport("Linear", "velocity", use_lognorm=True)

    half = layout == "half"
    kernel_counts = {}

    def grads(kernels: bool):
        s = dataclasses.replace(spec, use_checkpoint=kernels, remat_policy="attn")
        model = LightningDiT(s, device=dev)
        model.load_state_dict(permute_qk_for_half_rope(sd, s) if kernels and half else sd)
        impls = (dict(attn_impl="flash_rope" if half else "flash", rope_layout=layout, adaln_impl="fused")
                 if kernels else dict(attn_impl="xla", rope_layout="interleaved", adaln_impl="xla"))
        ops.reset_launch_counts()
        loss = dit_loss(model, transport, x1, y, x0=x0, t=t, drop_ids=drop, compute_dtype=dtype, **impls)
        loss.backward()
        torch.cuda.synchronize()
        if kernels:
            kernel_counts.update(ops.launch_counts())
            if count_path:
                check_counts(count_path, kernel_counts)
        out = {n: p.grad.float() for n, p in model.named_parameters()}
        return float(loss.detach()), (permute_qk_for_half_rope(out, s, inverse=True) if kernels and half else out)

    def worst(g, ref):
        errs = {n: float((g[n] - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)) for n in ref}
        name = max(errs, key=errs.get)
        return errs[name], name

    log(f"[train] gradient check: B/1 width 768, depth {GRAD_DEPTH}, batch {GRAD_BATCH}, {dtype}; kernel path "
        f"({'flash_rope, half' if half else 'flash, interleaved'} RoPE, fused adaLN, remat attn) vs xla path "
        f"(plain attention, xla adaLN, no remat)")
    loss_x, g_x = grads(False)
    loss_k, g_k = grads(True)
    err, leaf = worst(g_k, g_x)
    loss_rel = abs(loss_k - loss_x) / abs(loss_x)
    ok = err <= grad_bound and loss_rel <= 1e-2 and all(bool(torch.isfinite(v).all()) for v in g_k.values())
    log(f"  loss kernel {loss_k:.6f} vs xla {loss_x:.6f} (relative {loss_rel:.3g}, bound 1e-2); worst leaf "
        f"{leaf}: relative L2 {err:.6g} (bound {grad_bound}) over {len(g_x)} leaves -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("gradient check: the kernel path's gradients disagree with the xla path's")
    if dtype != torch.bfloat16 or not half:
        torch.cuda.empty_cache()
        return kernel_counts
    saved = fa.flash_attention_rope_bwd
    fa.flash_attention_rope_bwd = wrong_rope_bwd_untransposed  # the control, in this process only
    try:
        _, g_w = grads(True)
    finally:
        fa.flash_attention_rope_bwd = saved
    err, leaf = worst(g_w, g_x)
    log(f"  control (untransposed RoPE Jacobian): worst leaf {leaf}: relative L2 {err:.6g} "
        f"(must exceed {GRAD_REL_L2}) -> {'ok' if err > GRAD_REL_L2 else 'FAIL'}")
    if not err > GRAD_REL_L2:
        raise SystemExit("gradient check: a wrong backward reads within the bound")
    torch.cuda.empty_cache()
    return kernel_counts


def write_latent_shard(path: str, latents, labels) -> None:
    """A shard in the safetensors layout (8-byte little-endian header length,
    JSON header, raw little-endian buffers): latents, their flip, labels."""
    import struct

    import numpy as np

    tensors = {"latents": latents, "latents_flip": np.ascontiguousarray(latents[..., ::-1]), "labels": labels}
    header, offset = {}, 0
    for name, a in tensors.items():
        dtype = {np.dtype(np.float32): "F32", np.dtype(np.int64): "I64"}[a.dtype]
        header[name] = {"dtype": dtype, "shape": list(a.shape), "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a).astype(a.dtype.newbyteorder("<")).tobytes())


def check_train_counts(path: str, counts: dict) -> None:
    log(f"  launches: {counts}")
    if counts != EXPECTED_LAUNCHES[path]:
        raise SystemExit(f"{path}: launch counts {counts} != expected {EXPECTED_LAUNCHES[path]}")


def cli_train_phase(dev, smi: str, tmp: str) -> dict:
    """B/1 at full width and depth through ``cli.train_dit.main``: 20 steps
    and a checkpoint, a restart to 25, then 5 steps of the interleaved
    configuration. Returns {"train": counts, "interleaved": counts}."""
    import numpy as np
    import torch
    import yaml

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.cli import train_dit
    from ldmae_tpu_torch.core.config import LDMAEConfig
    from ldmae_tpu_torch.models import LightningDiT, seeded_init_
    from ldmae_tpu_torch.train.train_dit import spec_from_config
    from ldmae_tpu_torch.utils.profiling import dit_forward_flops

    data = os.path.join(tmp, "latents")
    os.makedirs(data)
    rng = np.random.default_rng(7)
    for i in range(2):  # 512 latents
        write_latent_shard(os.path.join(data, f"latents_rank00_shard{i:03d}.safetensors"),
                           rng.standard_normal((256, 16, 32, 32), dtype=np.float32) * 1.5 + 0.2,
                           rng.integers(0, 1000, 256).astype(np.int64))
    weights = os.path.join(tmp, "seeded.pt")

    def config(name: str, layout: str, steps: int, dtype: str = "bfloat16") -> str:
        cfg = _yaml_config(
            data={"data_path": data, "image_size": 256, "num_classes": 1000, "latent_norm": True,
                  "latent_multiplier": 1.0, "sample": False},
            train={"max_steps": steps, "global_batch_size": TRAIN_BATCH, "global_seed": 0,
                   "output_dir": tmp, "exp_name": name, "log_every": 5, "ckpt_every": TRAIN_STEPS,
                   "use_checkpoint": True, "gradient_accumulation_steps": 1, "weight_init": weights})
        cfg["parallel"]["rope_layout"] = layout
        cfg["parallel"]["compute_dtype"] = dtype
        path = os.path.join(tmp, f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    def run(argv, path):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = train_dit.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = ops.launch_counts()
        check_train_counts(path, counts)
        return out, counts, seconds, torch.cuda.max_memory_allocated() / 1e9

    cfg = config("b1", "half", TRAIN_STEPS)
    c = LDMAEConfig.from_yaml(cfg)
    spec = spec_from_config(c)
    init = seeded_init_(LightningDiT(spec, device="cpu"), 3).state_dict()
    torch.save({"model": init}, weights)  # the warm start: non-zero gates from step 1
    log(f"[train] cli.train_dit: LightningDiT-B/1 (depth {spec.depth}, width {spec.hidden_size}), batch "
        f"{TRAIN_BATCH}, {TRAIN_STEPS} steps, the shipped YAML's model/transport/optimizer/parallel sections "
        f"(train_attention_impl {c.parallel.train_attention_impl}, rope_layout {c.parallel.rope_layout}, "
        f"train_adaln_impl {c.parallel.train_adaln_impl}, remat_policy {c.model.remat_policy}, lr "
        f"{c.optimizer.lr}, beta2 {c.optimizer.beta2}), seeded weights, 512 synthetic latents")
    out, counts, seconds, peak_gb = run(["--config", cfg], "train")
    # keep only what is read below, so the later runs' peak memory is their own
    hist, exp_dir = out["history"], out["exp_dir"]
    del out
    log("  " + "; ".join(f"step {h['step']}: loss {h['loss']:.5f}, grad norm {h['grad_norm']:.5f}, "
                         f"{h['steps_per_sec']:.4f} steps/s" for h in hist))
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) and h["grad_norm"] > 0 for h in hist):
        raise SystemExit("training: a non-finite loss or gradient norm")
    ckpt = torch.load(os.path.join(exp_dir, "checkpoints", f"{TRAIN_STEPS:07d}.pt"), weights_only=True)
    moved = {key: max(float((ckpt[key][k] - init[k]).abs().max()) for k in init) for key in ("model", "ema")}
    log(f"  after {TRAIN_STEPS} steps: max |change| of the weights {moved['model']:.6g}, of the EMA "
        f"{moved['ema']:.6g}")
    if not (moved["model"] > 0 and moved["ema"] > 0 and ckpt["step"] == TRAIN_STEPS):
        raise SystemExit("training: the weights or the EMA did not move")
    steady = [h for h in hist[1:]]  # the first window holds the warm-up
    sps = sum(h["steps_per_sec"] * h["seconds"] for h in steady) / sum(h["seconds"] for h in steady)
    flops = 3 * dit_forward_flops(spec, TRAIN_BATCH)
    log(f"  steady state (steps 6-{TRAIN_STEPS}): {sps:.4f} steps/s, {sps * TRAIN_BATCH:.4f} latents/s, "
        f"{flops * sps / 1e12:.4f} TFLOP/s, MFU {flops * sps / PEAK_BF16_FLOPS:.4f} (3x forward FLOPs over "
        f"989 TFLOP/s); {seconds:.2f} s for the whole call; peak memory {peak_gb:.3f} GB; on {smi}")

    log(f"[train] restart to step {RESUME_STEPS} from the step-{TRAIN_STEPS} checkpoint")
    _, resume_counts, _, _ = run(["--config", cfg, "--max_steps", str(RESUME_STEPS)], "train_resume")
    with open(os.path.join(exp_dir, "log.txt")) as f:
        if f"resumed from step {TRAIN_STEPS}" not in f.read():
            raise SystemExit("training: the restart did not resume")
    log(f"  log.txt: resumed from step {TRAIN_STEPS}")

    log(f"[train] rope_layout interleaved: {INTERLEAVED_STEPS} steps, B/1, batch {TRAIN_BATCH} "
        f"(RoPE outside the kernel, flash_attention and its backward)")
    iout, icounts, iseconds, ipeak = run(["--config", config("b1_interleaved", "interleaved", INTERLEAVED_STEPS)],
                                         "interleaved")
    if not all(math.isfinite(h["loss"]) for h in iout["history"]):
        raise SystemExit("interleaved training: a non-finite loss")
    log(f"  losses {[round(h['loss'], 5) for h in iout['history']]}; {iseconds:.2f} s; peak memory {ipeak:.3f} GB")

    log(f"[train] parallel.compute_dtype float32: {FP32_STEPS} steps, B/1, batch {TRAIN_BATCH} (the fp32 kernels: "
        f"flash_attention_rope and its backward, fused adaLN)")
    fout, fcounts, fseconds, fpeak = run(["--config", config("b1_fp32", "half", FP32_STEPS, "float32")],
                                         "train_fp32")
    fhist = fout["history"]
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) and h["grad_norm"] > 0 for h in fhist):
        raise SystemExit("fp32 training: a non-finite loss or gradient norm")
    log(f"  losses {[round(h['loss'], 5) for h in fhist]}; {fseconds:.2f} s for the call ({FP32_STEPS} steps, the "
        f"first with the warm-up); peak memory {fpeak:.3f} GB; on {smi}")
    return {"train": counts, "interleaved": icounts, "train_fp32": fcounts}


def train_profile_phase(dev) -> None:
    """Where one training step's time goes (B/1, batch 32, the YAML's impls)."""
    import torch

    from ldmae_tpu_torch.core.config import LDMAEConfig
    from ldmae_tpu_torch.models import seeded_init_
    from ldmae_tpu_torch.train import build_from_config, init_train_state, make_optimizer

    c = LDMAEConfig.from_dict(_yaml_config(train={"global_batch_size": TRAIN_BATCH, "use_checkpoint": True}))
    spec, model, _, step_fn = build_from_config(c, dev, torch.Generator().manual_seed(0))
    seeded_init_(model, 3)
    state = init_train_state(model, make_optimizer(model.parameters(), c.optimizer.lr, c.optimizer.beta2))
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"x": torch.randn(TRAIN_BATCH, 16, 32, 32, generator=gen, device=dev),
             "y": torch.arange(TRAIN_BATCH, device=dev)}
    profile_phase(f"one training step (B/1, batch {TRAIN_BATCH})", lambda: step_fn(state, batch, gen))


PROFILE_STEPS = 50  # 14 single-batch Euler steps, 35 doubled: the main path's split in proportion
OWN_KERNELS = ("flash_fwd_kernel", "flash_fwd_wgmma_kernel", "norm_rope_kernel", "norm_rows_kernel",
               "gemm_kernel", "silu_mul_quant_kernel",
               "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel", "flash_bwd_preprocess_kernel",
               "flash_bwd_wgmma_kernel", "flash_bwd_postprocess_kernel", "flash_fwd_resident_kernel",
               "norm_rope_any_kernel", "flash32_", "matmul_silu_f32_kernel")
# device-time groups of the profile, by kernel name; the first match wins
PROFILE_GROUPS = (
    ("port kernels", OWN_KERNELS),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cublas")),
    ("casts and copies", ("copy",)),
    ("reductions", ("reduce_kernel",)),
    ("other elementwise", ("",)),
)


def profile_phase(what: str, fn) -> None:
    """Where the time goes: torch.profiler over one call of ``fn`` after a
    warm-up call; device time by kernel, by group (the port's kernels,
    cuBLAS GEMMs, everything else) and the device's idle share of the wall
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        raise SystemExit("the profiler recorded no device time")
    events.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    groups = dict.fromkeys((g for g, _ in PROFILE_GROUPS), 0.0)
    for e in events:
        group = next(g for g, marks in PROFILE_GROUPS if any(m in e.key.lower() for m in marks))
        groups[group] += e.self_device_time_total / 1e3
    log(f"[profile] {what} under torch.profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{sum(e.count for e in events)} kernel launches")
    for group, ms in groups.items():
        log(f"  {group}: {ms:.1f} ms ({ms / busy_ms:.3f} of device time)")
    for e in events[:20]:
        ms = e.self_device_time_total / 1e3
        log(f"  {ms:9.2f} ms {e.count:6d}x {ms / busy_ms:6.3f}  {e.key[:110]}")


def sampling_profile(spec, bundle, y, dev, quant=None) -> None:
    """One batch sampled at PROFILE_STEPS steps and decoded."""
    import torch

    fn = sampler(spec, PROFILE_STEPS, dev, kernels=True, quant=quant)
    profile_phase(f"{quant or 'bf16'} path, batch {BATCH}, {PROFILE_STEPS} steps + decode",
                  lambda: fn(bundle, y, generator=torch.Generator(device=dev).manual_seed(3)))


# ---------------------------------------------------------------------------
# Every head dim and fp32 (the kernels take what the Pallas kernels take)
# ---------------------------------------------------------------------------

# bf16 attention at the head dims of the registries' archs that the first
# kernels refused (VMAE 8, 12, 24, 32, 80), an off-8 dim and the largest class
ANY_HEAD_DIMS = (8, 12, 24, 32, 36, 80, 128)
# fp32 kernels against their plain fp32 versions (TF32 off): forwards within
# F32_FWD of the output's largest |value|, backwards within relative L2
# F32_BWD per output (fp32 sums in another order)
F32_FWD, F32_BWD = 2e-5, 1e-4


def f32_compare(name: str, out, ref) -> float:
    """max |out - ref|; fails unless within F32_FWD of ref's largest |value|."""
    import torch

    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    rel = err / float(ref.float().abs().max())
    ok = bool(torch.isfinite(out).all()) and rel <= F32_FWD and out.dtype == torch.float32
    log(f"  {name}: max_abs_err={err:.6g}, / max |ref| {rel:.3g} (tolerance {F32_FWD:g}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: the fp32 kernel disagrees with its plain version")
    return err


def f32_bwd_compare(name: str, outs, refs) -> float:
    import torch

    torch.cuda.synchronize()
    rels = [float((o - r).norm() / r.norm()) for o, r in zip(outs, refs)]
    ok = max(rels) <= F32_BWD and all(bool(torch.isfinite(o).all()) for o in outs)
    log(f"  {name}: relative L2 dq {rels[0]:.3g}, dk {rels[1]:.3g}, dv {rels[2]:.3g} (tolerance {F32_BWD:g}) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: the fp32 backward disagrees with its plain version")
    return max(float((o - r).abs().max()) for o, r in zip(outs, refs))


def head_dim_phase(dev) -> None:
    """bf16 attention forward (plain, RoPE) and backward (three passes) at
    every head dim of ANY_HEAD_DIMS, N = 1000 (ragged), against the plain
    versions with the bf16 gates; then the forward and the backward timed
    at (8, 12, 1024, d) beside SDPA's and the bound."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(21)
    for d in ANY_HEAD_DIMS:
        b, h, n = 2, 12, 1000
        log(f"[head dims] bf16 attention ({b},{h},{n},{d}): forward, RoPE forward, backward, RoPE backward")
        q, k, v, g = (torch.randn(b, h, n, d, generator=gen, device=dev).bfloat16() for _ in range(4))
        grid = math.isqrt(n) + 1
        from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

        cos, sin = (torch.from_numpy(to_half_layout(t)[:n]).to(dev) for t in build_rope_table(d // 2, grid))
        for name, out, ref in (
            ("flash_attention", fa.flash_attention(q, k, v), fa.flash_attention_plain(q, k, v)),
            ("flash_attention_rope", fa.flash_attention_rope(q, k, v, cos, sin),
             fa.flash_attention_rope_plain(q, k, v, cos, sin)),
        ):
            compare(f"{name}[d={d}]", out, ref, rtol=2**-7, atol=2**-8 * float(ref.float().abs().max()))
        for name, outs, refs in (
            ("flash_attention_bwd", fa.flash_attention_bwd(q, k, v, g), fa.flash_attention_bwd_plain(q, k, v, g)),
            ("flash_attention_rope_bwd", fa.flash_attention_rope_bwd(q, k, v, g, cos, sin),
             fa.flash_attention_rope_bwd_plain(q, k, v, g, cos, sin)),
        ):
            rel, elem = bwd_errors(outs, refs)
            ok = rel <= BWD_REL_L2 and elem <= BWD_ELEM
            log(f"  {name}[d={d}]: relative L2 {rel:.6g} (bound {BWD_REL_L2}), max |err| / max |value| {elem:.6g} "
                f"(bound {BWD_ELEM}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{name} at d = {d}: kernel disagrees with its plain backward")
        b, n = BATCH, 1024
        q, k, v, g = (torch.randn(b, h, n, d, generator=gen, device=dev).bfloat16() for _ in range(4))
        ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
        bnd = bound(4 * b * h * n * d * 2, 4 * b * h * n * n * d, exps=b * h * n * n)
        bwd_ms = cuda_ms(lambda: fa.flash_attention_bwd(q, k, v, g), 5)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))
        fb_ms = cuda_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(qs, ks, vs), (qs, ks, vs), g), 5)
        bbnd = bound(7 * b * h * n * d * 2, 10 * b * h * n * n * d, exps=b * h * n * n)
        log(f"  timed at ({b},{h},{n},{d}) bf16: forward {ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}), share {bnd[0] / ms:.3f}; backward (statistics pass included) {bwd_ms:.4f} ms, SDPA's "
            f"backward (fwd+bwd minus fwd) {fb_ms - lib_ms:.4f} ms, bound {bbnd[0]:.4f} ms, share {bbnd[0] / bwd_ms:.3f}")
        del q, k, v, g, qs, ks, vs
    torch.cuda.empty_cache()


def fp32_kernel_phase(dev, batch: int) -> dict:
    """Every kernel's fp32 instantiation against its plain fp32 version
    (TF32 off) and timed beside it and a library call: #1, #2, #5 and #6 at
    the training shape (32, 12, 1024, 64), #3, #4, #9 and #10 at the B/1
    sampling shapes at ``batch`` (CFG-doubled), #7 and #8 at the sampling
    attention shape. Returns name -> row of the kernels line."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops import fused_adaln as fad
    from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(23)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    rows = {}
    b, h, n, d = TRAIN_BATCH, 12, 1024, 64
    cos, sin = (torch.from_numpy(to_half_layout(t)).to(dev) for t in build_rope_table(d // 2, 32))
    q, k, v, g = (randn(b, h, n, d) for _ in range(4))
    attn_bytes, attn_flops, exps = 4 * b * h * n * d * 4, 4 * b * h * n * n * d, b * h * n * n
    log(f"[fp32] attention at the training shape ({b},{h},{n},{d}) fp32")
    for name, kern, plain, lib, tables in (
        ("flash_attention_fp32", fa.flash_attention, fa.flash_attention_plain, (q, k), ()),
        ("flash_attention_rope_fp32", fa.flash_attention_rope, fa.flash_attention_rope_plain,
         (fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin)), (cos, sin)),
    ):
        err = f32_compare(name, kern(q, k, v, *tables), plain(q, k, v, *tables))
        ms = cuda_ms(lambda: kern(q, k, v, *tables), 5)
        plain_ms = cuda_ms(lambda: plain(q, k, v, *tables), 3, 1)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(*lib, v), 5)
        bnd = bound(attn_bytes + (2 * n * d * 4 if tables else 0), fp32_flops=attn_flops, exps=exps)
        rows[name] = (err, ms, plain_ms, lib_ms, *bnd, {})
    for name, kern, plain, lib, tables in (
        ("flash_attention_bwd_fp32", fa.flash_attention_bwd, fa.flash_attention_bwd_plain, (q, k), ()),
        ("flash_attention_rope_bwd_fp32", fa.flash_attention_rope_bwd, fa.flash_attention_rope_bwd_plain,
         (fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin)), (cos, sin)),
    ):
        o, lse = fa._launch(q, k, v, name, *tables, with_lse=True)  # the library, uncounted

        def run():
            return kern(q, k, v, g, *tables, out=o, lse=lse)

        err = f32_bwd_compare(name, run(), plain(q, k, v, g, *tables))
        ms = cuda_ms(run, 3)
        plain_ms = cuda_ms(lambda: plain(q, k, v, g, *tables), 2, 1)
        qs, ks, vs = (t.detach().requires_grad_() for t in (*lib, v))
        fb_ms = cuda_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(qs, ks, vs), (qs, ks, vs), g), 3)
        with torch.no_grad():
            f_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs), 3)
        bnd = bound(8 * b * h * n * d * 4 + b * h * n * 4 + (2 * n * d * 4 if tables else 0),
                    fp32_flops=10 * b * h * n * n * d, exps=exps)
        rows[name] = (err, ms, plain_ms, fb_ms - f_ms, *bnd, {})
        del o, lse, qs, ks, vs
    del q, k, v, g

    b2 = 2 * batch
    b, h, n, d = b2, 12, 1024, 64
    log(f"[fp32] opt-in attention at the sampling shape ({b},{h},{n},{d}) fp32")
    q, k, v = randn(b, h, n, d, scale=3.0), randn(b, h, n, d, scale=3.0), randn(b, h, n, d)
    qs_, ks_ = (1 + 0.1 * randn(d) for _ in range(2))
    err = f32_compare("flash_attention_qknorm_rope_fp32", fa.flash_attention_qknorm_rope(q, k, v, qs_, ks_, cos, sin),
                      fa.flash_attention_qknorm_rope_plain(q, k, v, qs_, ks_, cos, sin))
    ms = cuda_ms(lambda: fa.flash_attention_qknorm_rope(q, k, v, qs_, ks_, cos, sin), 5)
    plain_ms = cuda_ms(lambda: fa.flash_attention_qknorm_rope_plain(q, k, v, qs_, ks_, cos, sin), 3, 1)
    qr, kr = fa._qknorm_rope_fp32(q, qs_, cos, sin), fa._qknorm_rope_fp32(k, ks_, cos, sin)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v), 5)
    bnd = bound(4 * b * h * n * d * 4, fp32_flops=4 * b * h * n * n * d, exps=b * h * n * n)
    rows["flash_attention_qknorm_rope_fp32"] = (err, ms, plain_ms, lib_ms, *bnd, {})
    qkv = randn(b, n, 3, h, d)
    qf, kf, vf = qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(), qkv[:, :, 2]
    err = f32_compare("flash_attention_fused_rope_fp32", fa.flash_attention_fused_rope(qf, kf, vf, cos, sin),
                      fa.flash_attention_fused_rope_plain(qf, kf, vf, cos, sin))
    ms = cuda_ms(lambda: fa.flash_attention_fused_rope(qf, kf, vf, cos, sin), 5)
    plain_ms = cuda_ms(lambda: fa.flash_attention_fused_rope_plain(qf, kf, vf, cos, sin), 3, 1)
    qr, kr = (fa._rope_fp32(t.transpose(1, 2), cos, sin) for t in (qf, kf))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, vf.transpose(1, 2)), 5)
    rows["flash_attention_fused_rope_fp32"] = (err, ms, plain_ms, lib_ms, *bnd, {})
    del q, k, v, qr, kr, qkv, qf, kf, vf

    log(f"[fp32] adaLN and SwiGLU kernels at the B/1 sampling shapes (batch {batch}, CFG-doubled) fp32")
    rows |= adaln_row_kernels(dev, b2, f"fp32 (batch {batch})", torch.float32)
    d = 768
    m, h2 = b2 * 1024, 4096
    x = randn(m, d)
    w12 = randn(h2, d, scale=d**-0.5)
    b12 = randn(h2, scale=0.1)
    err = f32_compare("fused_matmul_silu_fp32", fad.fused_matmul_silu(x, w12, b12),
                      fad.fused_matmul_silu_plain(x, w12, b12))
    ms = cuda_ms(lambda: fad.fused_matmul_silu(x, w12, b12), 5)
    plain_ms = cuda_ms(lambda: fad.fused_matmul_silu_plain(x, w12, b12), 3, 1)
    lib_ms = cuda_ms(lambda: torch.addmm(b12, x, w12.t()), 5)
    rows["fused_matmul_silu_fp32"] = (err, ms, plain_ms, lib_ms, *bound(
        (m * d + h2 * d + m * h2 // 2) * 4 + h2 * 4, fp32_flops=2 * m * d * h2), {})
    del x, w12
    x12 = randn(b2, 1024, h2, scale=2.0)
    err = compare_quant("fused_silu_mul_quant_fp32", fad.fused_silu_mul_quant(x12), fad.fused_silu_mul_quant_plain(x12))
    ms = cuda_ms(lambda: fad.fused_silu_mul_quant(x12), 20)
    plain_ms = cuda_ms(lambda: fad.fused_silu_mul_quant_plain(x12), 5)
    rows["fused_silu_mul_quant_fp32"] = (err, ms, plain_ms, None, *bound(
        m * h2 * 4 + m * h2 // 2 + m * 4, fp32_flops=8 * m * h2 // 2), {})
    del x12
    torch.cuda.empty_cache()
    for name, (err, ms, plain_ms, lib_ms, bound_ms, bound_by, _) in rows.items():
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}), share of bound {bound_ms / ms:.3f}")
    return rows


def dense_ulp_error(out, x, w, b) -> float:
    """max over the elements of (|out - exact| - 2^-14 sum |terms|) / ulp,
    exact = x w^T + b in fp64 on the same bf16 operands and fp32 bias, sum
    |terms| = |x| |w|^T + |b|, ulp = the bf16 ulp of exact's binade: one
    rounding of an fp32 result reads at most 0.5 (the 2^-14 allows for the
    fp32 sums, about 2^-18 of the terms over K = 2048; without it an exact
    value near 0, whose ulp is tiny, would read as a huge error)."""
    import torch

    exact = x.double() @ w.double().t() + b.double()
    mag = x.double().abs() @ w.double().abs().t() + b.double().abs()
    ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0**-100))) - 7)
    return float((((out.double() - exact).abs() - 2.0**-14 * mag) / ulp).max())


# dense's bf16 linears on the paths (name, M, K, N): B/1 under CFG at batch 8
# (the adaLN, final adaLN and timestep linears take one row a sample), a
# single-batch step's M = 8,192, the training forward's M = 32,768, the
# patch-14 head
DENSE_SHAPES = (("qkv", 16384, 768, 2304), ("proj", 16384, 768, 768), ("w3", 16384, 2048, 768),
                ("adaLN", 16, 768, 4608), ("final adaLN", 16, 768, 1536), ("timestep MLP 1", 16, 256, 768),
                ("timestep MLP 2", 16, 768, 768), ("final layer", 16384, 768, 16), ("qkv M=8192", 8192, 768, 2304),
                ("w3 M=8192", 8192, 2048, 768), ("qkv training", 32768, 768, 2304),
                ("patch-14 head", 2048, 512, 588))


def dense_phase(dev) -> dict:
    """``dense`` in bf16 with an fp32 bias at DENSE_SHAPES: within half a
    bf16 ulp of fp64 math on the same operands rounded once
    (``dense_ulp_error``), where the bias rounded to bf16 first (a bf16
    F.linear, as the port's dense once did) must read above 0.6 ulp (over
    512 rows where M is smaller); timed warm, queued and cold beside that
    F.linear (``linear_timings``), with bound (bf16 flops over 989 TFLOP/s or
    the bytes) and share; at the adaLN shape the host time a call of the
    wrapper, of its bare C entry, and of that entry inside a
    ``torch.cuda.device`` guard with ``torch.cuda.current_stream``'s handle
    (the wrapper before ``kernels.on_device``). Returns the kernels line's
    row: dense at qkv, every shape's numbers among its parts."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch import kernels
    from ldmae_tpu_torch.ops import dense

    gen = torch.Generator(device=dev).manual_seed(29)
    log("[dense] bf16 x bf16 + fp32 bias, one rounding (the GEMM engine's dense kernel) vs fp64; error in "
        "bf16 ulps; ms queued = device time alone, warm = with the host's launch time")
    parts, row = {}, None
    for name, m, k, n in DENSE_SHAPES:
        x = torch.randn(m, k, generator=gen, device=dev).bfloat16()
        w = (torch.randn(n, k, generator=gen, device=dev) * k**-0.5).bfloat16()
        b = torch.randn(n, generator=gen, device=dev)
        xc = x if m >= 512 else torch.randn(512, k, generator=gen, device=dev).bfloat16()
        ours, parent = dense_ulp_error(dense(x, w, b), x, w, b), dense_ulp_error(F.linear(xc, w, b.bfloat16()), xc, w, b)
        ok = ours <= 0.5 and parent > 0.6
        bb = b.bfloat16()
        t = linear_timings(lambda: dense(x, w, b), lambda: F.linear(x, w, bb))
        bnd = bound(2 * (m * k + n * k + m * n) + 4 * n, 2 * m * k * n)
        log(f"  {name} ({m}x{k} -> {n}): dense max error {ours:.4f} ulp (bound 0.5); bias rounded to bf16 first "
            f"{parent:.4f} ulp (must exceed 0.6) -> {'ok' if ok else 'FAIL'}; dense warm {t['ms']:.4f} ms, queued "
            f"{t['queued_ms']:.4f}, cold L2 {t['cold_ms']:.4f}; bf16 F.linear warm {t['library_ms']:.4f}, queued "
            f"{t['library_queued_ms']:.4f}; queued dense / F.linear {t['queued_ms'] / t['library_queued_ms']:.3f}; "
            f"bound {bnd[0]:.4f} ms ({bnd[1]}), share {bnd[0] / t['queued_ms']:.3f} (queued), "
            f"{bnd[0] / t['cold_ms']:.3f} (cold)")
        if not ok:
            raise SystemExit(f"dense ({name}): not one rounding after the fp32 bias, or the control reads within")
        key = name.replace(" ", "_").replace("=", "")
        if name == "qkv":
            row = [None, t["ms"], None, t["library_ms"], *bnd,
                   {k_: v for k_, v in t.items() if k_ != "ms"} | {"max_ulp": ours}]
        else:
            parts |= {f"{key}_{k_}": v for k_, v in t.items()} | {f"{key}_bound_ms": bnd[0], f"{key}_max_ulp": ours}
        if name == "adaLN":
            lib = kernels.load("dense")
            out = torch.empty(m, n, device=dev, dtype=torch.bfloat16)
            args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def guarded():
                with torch.cuda.device(x.device):
                    return lib.ldmae_dense_bias_f32(*args, torch.cuda.current_stream(x.device).cuda_stream)

            host = {"host_ms": host_ms(lambda: dense(x, w, b)),
                    "entry_host_ms": host_ms(lambda: lib.ldmae_dense_bias_f32(*args, stream)),
                    "guarded_entry_host_ms": host_ms(guarded)}
            parts |= {f"adaLN_{k_}": v for k_, v in host.items()}
            log(f"  dense adaLN host time a call: wrapper {host['host_ms']:.4f} ms, C entry {host['entry_host_ms']:.4f}, "
                f"C entry in the device guard with the Stream object {host['guarded_entry_host_ms']:.4f}")
        del x, xc
    # the plain version: the fp32 product of the bf16 operands plus the fp32
    # bias, rounded once (dense's CPU path), at qkv: its time, and the
    # kernel's largest difference from it (fp32 sums in another order: a
    # bf16 ulp now and then)
    x = torch.randn(16384, 768, generator=gen, device=dev).bfloat16()
    w = (torch.randn(2304, 768, generator=gen, device=dev) * 768**-0.5).bfloat16()
    b = torch.randn(2304, generator=gen, device=dev)
    row[0] = float((dense(x, w, b).float() - F.linear(x.float(), w.float(), b).bfloat16().float()).abs().max())
    row[2] = cuda_ms(lambda: F.linear(x.float(), w.float(), b).bfloat16(), 10)
    torch.cuda.empty_cache()
    row[-1] |= parts
    return {"dense": tuple(row)}


def vmae_decode_phase(dev) -> dict:
    """VMAE decode of two archs off the resident kernel's head dims,
    mae_for_ldmae_f8d16_small (decoder head dim 12) and ..._prev_large (24),
    at 256^2 (1,024 tokens), batch 8, seeded weights, under ``flash``
    against ``xla``, in bf16 (within 8 levels) and fp32 (within 1 level),
    with exact launch counts. Returns {"decode_fp32": counts}."""
    import torch

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.models import VMAE, seeded_init_, vmae_spec

    out = {}
    z = torch.randn(BATCH, 16, 32, 32, generator=torch.Generator(device=dev).manual_seed(31), device=dev)
    for arch in ("mae_for_ldmae_f8d16_small", "mae_for_ldmae_f8d16_prev_large"):
        spec = vmae_spec(arch, img_size=256, ldmae_mode=True, no_cls=True, kl_loss_weight=True, smooth_output=True)
        vae = seeded_init_(VMAE(spec, device=dev), 4)
        hd = spec.decoder_embed_dim // spec.decoder_num_heads
        for dtype, tol in ((torch.bfloat16, 8), (torch.float32, 1)):
            ops.reset_launch_counts()
            img_k = vae.decode_to_images(z, compute_dtype=dtype, attn_impl="flash")
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            check_counts("decode" if dtype == torch.bfloat16 else "decode_fp32", counts)
            img_x = vae.decode_to_images(z, compute_dtype=dtype, attn_impl="xla")
            px = int((img_k.int() - img_x.int()).abs().max())
            spread = float(img_k.float().std())
            ok = px <= tol and img_k.shape == (BATCH, 256, 256, 3) and spread > 1.0
            log(f"[decode] {arch} (decoder head dim {hd}) {dtype}: flash vs xla max pixel diff {px} (tolerance "
                f"{tol}), pixel std {spread:.3f} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"VMAE decode {arch} {dtype}: flash disagrees with xla")
            if dtype == torch.float32:
                out["decode_fp32"] = counts
        del vae
    torch.cuda.empty_cache()
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU only", file=sys.stderr)
        return 2
    try:
        from ldmae_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
        f"count {torch.cuda.device_count()}")
    if "--rows" in sys.argv[1:]:
        return rows_only(dev)
    if "--linear" in sys.argv[1:]:
        return linear_only(dev)
    if "--attention" in sys.argv[1:]:
        return attention_only(dev)

    t0 = time.perf_counter()
    report = kernels.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s for {len(report)} libraries (nvcc in parallel)")
    for name, info in report.items():
        regs = [ln.strip() for ln in info["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: {info['seconds']:.2f} s" + "".join(f"\n    {r}" for r in regs))
    # the wgmma kernels: registers at entry (setmaxnreg then gives the
    # consumer warpgroups more), static shared memory (the rings are dynamic)
    for kernel in ("flash_fwd_wgmma_kernel", "flash_bwd_wgmma_kernel", "flash_fwd_resident_kernel"):
        log(f"  ptxas {kernel}: {ptxas_summary(report['flash_attention']['ptxas'], kernel)}")
    # the forward's two instantiations (sampling: no lse; training: lse) must not spill
    for what, inst in (("<false>", "flash_fwd_wgmma_kernelILb0EE"), ("<true>", "flash_fwd_wgmma_kernelILb1EE")):
        summary = ptxas_summary(report["flash_attention"]["ptxas"], inst)
        log(f"  ptxas flash_fwd_wgmma_kernel{what}: {summary}")
        if re.search(r"[1-9]\d* bytes spill", summary) or summary == "not in the report":
            raise SystemExit(f"flash_fwd_wgmma_kernel{what}: ptxas reports spills (or no entry): {summary}")
    gemm_ptxas(report)
    engine_ptxas(report)
    rate_probes(dev)

    rows = kernel_phases(dev, BATCH)
    log(f"[kernel] the same at bench.py's batch {BENCH_BATCH}")
    kernel_phases(dev, BENCH_BATCH)
    log("[kernel] the w8a8 leg's int8 linears (int8_dense)")
    rows |= int8_gemm_phase(dev, BATCH)
    int8_gemm_phase(dev, BENCH_BATCH)
    rows |= train_kernel_phase(dev)
    head_dim_phase(dev)
    rows |= fp32_kernel_phase(dev, BATCH)
    rows |= dense_phase(dev)
    profile = "--profile" in sys.argv[1:]
    result = pipeline_phases(dev, profile=profile)
    result["counts"] |= vmae_decode_phase(dev)
    grad_check_phase(dev)
    for layout in ("half", "interleaved"):
        path = f"grad_fp32_{layout}"
        result["counts"][path] = grad_check_phase(dev, torch.float32, layout, path, GRAD_F32_REL_L2)
    with tempfile.TemporaryDirectory() as tmp:
        result["counts"] |= cli_train_phase(dev, smi, tmp)
    if profile:
        train_profile_phase(dev)

    out = []
    for name, (err, ms, plain_ms, lib_ms, bound_ms, bound_by, parts) in rows.items():
        source, replaces, path, wrapper = KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": result["counts"][path][wrapper], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        } | parts)
    missing = set(KERNELS) - set(rows)
    if missing:
        raise SystemExit(f"no measurement of {sorted(missing)}")
    log(smi)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

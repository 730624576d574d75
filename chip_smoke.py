#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ldmae_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py [--profile]

It builds the port's CUDA kernels from ``ldmae_tpu_torch/csrc`` (one nvcc
per source, in parallel) and prints ``-Xptxas -v``'s registers, shared
memory and spills of the wgmma kernels, then:

  1. holds each of the eight kernels against its plain PyTorch version on
     the card at the shapes the sampling paths below give it (batch 8: the
     CFG-doubled DiT step and the VMAE decode), and times the kernel, the
     plain version and, where one exists, one PyTorch library call
     computing the same function (a yardstick only; the port never calls
     it), and #1's two kernels apart (the RoPE pre-pass and the wgmma
     attention, by kernel name under ``torch.profiler``); then the same at
     ``bench.py``'s batch 36; then times the int8
     product of the w8a8 leg (``torch._int_mm``, checked exact) beside
     cuBLAS bf16 at the same shapes;
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
     ``flash_rope``, each with its exact launch counts; then holds the
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
     forward kernels #1 and #3 at the training shapes;
  6. checks one train step of B/1 at full width (depth 2, batch 8) on the
     card: the loss and every parameter's gradient of the kernel path (the
     shipped YAML's flash_rope, half-split RoPE, fused adaLN, remat 'attn')
     against the plain xla path from the same weights, noise, t and label
     drops, within GRAD_REL_L2, which the path with the untransposed RoPE
     Jacobian must exceed;
  7. trains LightningDiT-B/1 at full width and depth through the training
     CLI (``cli.train_dit.main``) on a YAML made from the shipped one's
     model, transport, optimizer and parallel sections, batch 32, 20 steps,
     on synthetic 16-channel 32x32 latent shards this script writes, from
     seeded non-zero weights (``train.weight_init``), with exact launch
     counts; checks finite losses and gradient norms and that the weights
     and the EMA moved; restarts to step 25 ("resumed from step 20"); and
     prints steps/s, latents/s, TFLOP/s, MFU and peak memory; then 5 steps
     of the ``rope_layout: interleaved`` configuration with exact counts;
  8. with ``--profile``, traces one 50-step batch of the bf16 and of the
     w8a8 path, and one training step, with ``torch.profiler`` and prints
     device time by kernel and group and the idle share.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line
(sampling kernels at the batch-8 shapes, the backward kernels at the
training shapes; launches from the path that runs each kernel), and as its
last line ``{"ok": true, "device": {...}}``.
Any failure exits non-zero without that line; without a CUDA device, or
outside the repository, it exits non-zero at once.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, at the 700 W limit
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth

# name -> (source, the Pallas call it replaces, the path whose launches it reports)
KERNELS = {
    "flash_attention_rope": ("ldmae_tpu_torch/csrc/flash_attention.cu", "ldmae_tpu/ops/flash_attention.py:323", "bf16"),
    "flash_attention": ("ldmae_tpu_torch/csrc/flash_attention.cu", "ldmae_tpu/ops/flash_attention.py:77", "bf16"),
    "fused_norm_modulate": ("ldmae_tpu_torch/csrc/fused_norm_modulate.cu", "ldmae_tpu/ops/fused_adaln.py:232", "bf16"),
    "fused_matmul_silu": ("ldmae_tpu_torch/csrc/fused_matmul_silu.cu", "ldmae_tpu/ops/fused_adaln.py:199", "bf16"),
    "flash_attention_qknorm_rope": ("ldmae_tpu_torch/csrc/flash_attention.cu", "ldmae_tpu/ops/flash_attention.py:282", "flash_qkr"),
    "flash_attention_fused_rope": ("ldmae_tpu_torch/csrc/flash_attention.cu", "ldmae_tpu/ops/flash_attention.py:550", "flash_fused"),
    "fused_norm_modulate_quant": ("ldmae_tpu_torch/csrc/fused_quant.cu", "ldmae_tpu/ops/fused_adaln.py:99", "w8a8"),
    "fused_silu_mul_quant": ("ldmae_tpu_torch/csrc/fused_quant.cu", "ldmae_tpu/ops/fused_adaln.py:144", "w8a8"),
    "flash_attention_bwd": ("ldmae_tpu_torch/csrc/flash_attention.cu", "ldmae_tpu/ops/flash_attention.py:151", "interleaved"),
    "flash_attention_rope_bwd": ("ldmae_tpu_torch/csrc/flash_attention.cu", "ldmae_tpu/ops/flash_attention.py:429", "train"),
}

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
TRAIN_BATCH, TRAIN_STEPS, RESUME_STEPS, INTERLEAVED_STEPS = 32, 20, 25, 5
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
_NONE = dict.fromkeys(KERNELS, 0)
_EVALS = (STEPS - 1) * DEPTH  # block forwards of one 250-step batch (the last step evaluates nothing)
_SHORT = (SHORT_STEPS - 1) * DEPTH
# exact launch counts per path: every wrapper is counted, so each dict names all eight
EXPECTED_LAUNCHES = {
    "bf16": _NONE | {"flash_attention_rope": _EVALS, "fused_norm_modulate": 2 * _EVALS,
                     "fused_matmul_silu": _EVALS, "flash_attention": DEC_DEPTH},
    "w8a8": _NONE | {"fused_norm_modulate_quant": 2 * _EVALS, "fused_silu_mul_quant": _EVALS,
                     "flash_attention_rope": _EVALS, "flash_attention": DEC_DEPTH},
    # 10 steps, latents only (the decode is compared apart)
    "flash_qkr": _NONE | {"flash_attention_qknorm_rope": _SHORT, "fused_norm_modulate": 2 * _SHORT,
                          "fused_matmul_silu": _SHORT},
    "flash_fused": _NONE | {"flash_attention_fused_rope": _SHORT, "fused_norm_modulate": 2 * _SHORT,
                            "fused_matmul_silu": _SHORT},
}
# Training with remat_policy 'attn' (two checkpointed segments per block,
# split at the attention output): per step and block the forward runs #1
# (or #2) once and #3 twice, the backward recomputes both segments (#1 or #2
# once more, #3 twice more) and runs the backward kernel #6 (or #5) once;
# the final layer's norm is not fused, and the MLP stays 'xla' in training.
def _train_counts(steps: int, depth: int = DEPTH) -> dict:
    return dict(fwd=2 * depth * steps, adaln=4 * depth * steps, bwd=depth * steps)


for _path, _steps in (("train", TRAIN_STEPS), ("train_resume", RESUME_STEPS - TRAIN_STEPS)):
    _n = _train_counts(_steps)
    EXPECTED_LAUNCHES[_path] = _NONE | {"flash_attention_rope": _n["fwd"], "fused_norm_modulate": _n["adaln"],
                                        "flash_attention_rope_bwd": _n["bwd"]}
_n = _train_counts(INTERLEAVED_STEPS)
EXPECTED_LAUNCHES["interleaved"] = _NONE | {"flash_attention": _n["fwd"], "fused_norm_modulate": _n["adaln"],
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


def kernel_device_ms(fn, names, iters: int = 20) -> dict:
    """Device time per call of each kernel whose name contains one of
    ``names``, from torch.profiler over ``iters`` calls of ``fn`` after a
    warm-up call: the parts of a wrapper that launches more than one kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name in names:
                if name in e.key:
                    out[name] += e.self_device_time_total / 1e3 / iters
    if not all(out.values()):
        raise SystemExit(f"the profiler saw none of {[n for n, v in out.items() if not v]}")
    return out


def rope_parts(fn) -> dict:
    """#1's two kernels timed apart: the RoPE pre-pass and the attention."""
    ms = kernel_device_ms(fn, ("norm_rope_kernel", "flash_fwd_wgmma_kernel"))
    return {"prepass_ms": ms["norm_rope_kernel"], "attention_ms": ms["flash_fwd_wgmma_kernel"]}


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


def bound(nbytes: float, bf16_flops: float = 0.0, fp32_flops: float = 0.0) -> tuple[float, str]:
    """Least time in ms for the work: bytes over the memory rate, or
    tensor-core bf16 and plain fp32 operations over their peak rates."""
    t_ops = (bf16_flops / PEAK_BF16_FLOPS + fp32_flops / PEAK_FP32_FLOPS) * 1e3
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

    def attn_tol(ref):
        # one bf16 ulp of the element (rtol 2^-7: the two sides may round the
        # same value to neighbours) plus 2^-8 of the largest |output| (atol:
        # the kernel rounds p to bf16 before normalising it, the plain version
        # after, an error absolute in the output's scale, which is ~0.05 for
        # random q, k, v, not ~1)
        return dict(rtol=2**-7, atol=2**-8 * float(ref.float().abs().max()))

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
    rows["flash_attention_rope"] = (err, ms, plain_ms, lib_ms,
                                    *bound(4 * b * h * n * d * 2 + 2 * n * d * 4, 4 * b * h * n * n * d), parts)
    del q, k, v, qr, kr

    # -- 2: flash_attention, VMAE decoder attention (head dim 16)
    b, h, n, d = batch, 12, 1024, 16
    # ragged: N = 1000 leaves 40 keys in the last 64-row tile, so a dropped
    # or mis-masked tile moves the outputs by far more than the tolerance
    log(f"[kernel] flash_attention q,k,v ({b},{h},{n},{d}) bf16; ragged (2,{h},1000,{d})")
    q, k, v = randn(b, h, n, d), randn(b, h, n, d), randn(b, h, n, d)
    ref = fa.flash_attention_plain(q, k, v)
    err = compare("flash_attention", fa.flash_attention(q, k, v), ref, **attn_tol(ref))
    qs, ks, vs = randn(2, h, 1000, d), randn(2, h, 1000, d), randn(2, h, 1000, d)
    ref = fa.flash_attention_plain(qs, ks, vs)
    compare("flash_attention[N=1000]", fa.flash_attention(qs, ks, vs), ref, **attn_tol(ref))
    del ref
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 3, 1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    rows["flash_attention"] = (err, ms, plain_ms, lib_ms,
                               *bound(4 * b * h * n * d * 2, 4 * b * h * n * n * d), {})
    del q, k, v

    # -- 3: fused_norm_modulate, the DiT adaLN epilogue in a CFG-doubled step
    b, n, d = b2, 1024, 768
    log(f"[kernel] fused_norm_modulate x ({b},{n},{d}) bf16, w ({d},) fp32, shift/scale ({b},{d}) bf16")
    x = randn(b, n, d, scale=3.0)
    w = 1 + 0.1 * randn(d, dtype=torch.float32)
    mod = randn(b, 6, d, scale=0.1)  # shift and scale as strided views, as the adaLN projection gives them
    sh, sc = mod[:, 0], mod[:, 1]
    err = compare("fused_norm_modulate", fad.fused_norm_modulate(x, w, sh, sc),
                  fad.fused_norm_modulate_plain(x, w, sh, sc), **tol)
    ms = cuda_ms(lambda: fad.fused_norm_modulate(x, w, sh, sc), 50)
    plain_ms = cuda_ms(lambda: fad.fused_norm_modulate_plain(x, w, sh, sc), 10)
    # per element: square and sum, scale, weight, (1 + scale) product, shift
    rows["fused_norm_modulate"] = (err, ms, plain_ms, None,
                                   *bound(2 * b * n * d * 2 + d * 4 + 2 * b * d * 2,
                                          fp32_flops=6 * b * n * d), {})
    del x

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

    # -- 7: flash_attention_qknorm_rope, DiT attention under attention_impl flash_qkr
    b, h, n, d = b2, 12, 1024, 64
    log(f"[kernel] flash_attention_qknorm_rope q,k,v ({b},{h},{n},{d}) bf16, qk-norm weights ({d},) fp32")
    q, k, v = randn(b, h, n, d, scale=3.0), randn(b, h, n, d, scale=3.0), randn(b, h, n, d)
    qs, ks = (1 + 0.1 * randn(d, dtype=torch.float32) for _ in range(2))
    ref = fa.flash_attention_qknorm_rope_plain(q, k, v, qs, ks, cos, sin)
    err = compare("flash_attention_qknorm_rope", fa.flash_attention_qknorm_rope(q, k, v, qs, ks, cos, sin),
                  ref, **attn_tol(ref))
    ms = cuda_ms(lambda: fa.flash_attention_qknorm_rope(q, k, v, qs, ks, cos, sin), 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_qknorm_rope_plain(q, k, v, qs, ks, cos, sin), 3, 1)
    qr, kr = fa._qknorm_rope_fp32(q, qs, cos, sin), fa._qknorm_rope_fp32(k, ks, cos, sin)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v), 20)
    rows["flash_attention_qknorm_rope"] = (err, ms, plain_ms, lib_ms, *bound(
        4 * b * h * n * d * 2 + 2 * n * d * 4 + 2 * d * 4, 4 * b * h * n * n * d), {})
    del q, k, v, qr, kr, ref

    # -- 8: flash_attention_fused_rope, DiT attention under attention_impl flash_fused
    log(f"[kernel] flash_attention_fused_rope q,k ({b},{n},{h},{d}) bf16, v a view of qkv ({b},{n},3,{h},{d})")
    qkv = randn(b, n, 3, h, d)
    q, k, v = qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(), qkv[:, :, 2]
    ref = fa.flash_attention_fused_rope_plain(q, k, v, cos, sin)
    err = compare("flash_attention_fused_rope", fa.flash_attention_fused_rope(q, k, v, cos, sin),
                  ref, **attn_tol(ref))
    ms = cuda_ms(lambda: fa.flash_attention_fused_rope(q, k, v, cos, sin), 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_fused_rope_plain(q, k, v, cos, sin), 3, 1)
    qr, kr = (fa._rope_fp32(t.transpose(1, 2), cos, sin) for t in (q, k))
    vt = v.transpose(1, 2)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, vt), 20)
    rows["flash_attention_fused_rope"] = (err, ms, plain_ms, lib_ms, *bound(
        4 * b * h * n * d * 2 + 2 * n * d * 4, 4 * b * h * n * n * d), {})
    del qkv, q, k, v, qr, kr, vt, ref

    # -- 9: fused_norm_modulate_quant, the w8a8 adaLN epilogue in a CFG-doubled step
    b, n, d = b2, 1024, 768
    log(f"[kernel] fused_norm_modulate_quant x ({b},{n},{d}) bf16 -> int8 + ({b},{n},1) fp32")
    x = randn(b, n, d, scale=3.0)
    w = 1 + 0.1 * randn(d, dtype=torch.float32)
    mod = randn(b, 6, d, scale=0.1)
    sh, sc = mod[:, 0], mod[:, 1]
    err = compare_quant("fused_norm_modulate_quant", fad.fused_norm_modulate_quant(x, w, sh, sc),
                        fad.fused_norm_modulate_quant_plain(x, w, sh, sc))
    ms = cuda_ms(lambda: fad.fused_norm_modulate_quant(x, w, sh, sc), 50)
    plain_ms = cuda_ms(lambda: fad.fused_norm_modulate_quant_plain(x, w, sh, sc), 10)
    # per element: square and sum, scale, weight, (1 + scale) product, shift,
    # absmax, divide, round
    rows["fused_norm_modulate_quant"] = (err, ms, plain_ms, None, *bound(
        b * n * d * (2 + 1) + b * n * 4 + d * 4 + 2 * b * d * 2, fp32_flops=9 * b * n * d), {})
    del x

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
        split = "".join(f", {k} {v:.4f}" for k, v in parts.items())
        log(f"  {name} (batch {batch}): kernel {ms:.4f} ms{split}, plain {plain_ms:.4f} ms, library {lib} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), share of bound {bound_ms / ms:.3f}")
    return rows


def int8_gemm_phase(dev, batch: int) -> None:
    """The int8 products of the w8a8 leg at the path's shapes: ``torch._int_mm``
    with the weight as the transposed view of its contiguous (out, in) int8
    tensor (the layout the port passes), checked exact against an fp64
    product, timed beside cuBLAS bf16 (``F.linear``) at the same shape and
    beside the whole ``qdense_pre`` (product + fp32 dequant passes)."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops.quant import QLinear, _int_mm, qdense_pre

    g = torch.Generator(device=dev).manual_seed(5)
    m = 2 * batch * 1024
    for name, rows_, k, n in (("qkv", m, 768, 2304), ("w12", m, 768, 4096), ("w3", m, 2048, 768),
                              ("adaLN", 2 * batch, 768, 4608)):
        a = torch.randint(-127, 128, (rows_, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        exact = torch.equal(_int_mm(a, w).double(), a.double() @ w.double().t())
        if not exact:
            raise SystemExit(f"torch._int_mm ({name}) is not the exact int32 product")
        p = QLinear(w, torch.rand(n, generator=g, device=dev) * 1e-3, torch.zeros(n, device=dev))
        xs = torch.rand(rows_, 1, generator=g, device=dev) * 1e-2
        xb, wb = a.bfloat16(), w.bfloat16()
        int_ms = cuda_ms(lambda: _int_mm(a, w), 20)
        pre_ms = cuda_ms(lambda: qdense_pre(a, xs, p), 20)
        bf_ms = cuda_ms(lambda: F.linear(xb, wb), 20)
        log(f"  int8 GEMM {name} M={rows_} K={k} N={n} (batch {batch}): torch._int_mm {int_ms:.4f} ms "
            f"(exact), qdense_pre {pre_ms:.4f} ms, cuBLAS bf16 {bf_ms:.4f} ms")
    torch.cuda.empty_cache()


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


def sampler(spec, steps, dev, kernels: bool, quant=None, attn_impl="flash_rope"):
    import torch

    from ldmae_tpu_torch.eval.sampling import make_sample_fn
    from ldmae_tpu_torch.transport import create_transport

    impls = (dict(attn_impl=attn_impl, adaln_impl="fused", mlp_impl="fused") if kernels
             else dict(attn_impl="xla", adaln_impl="xla", mlp_impl="xla"))
    return make_sample_fn(
        spec, create_transport("Linear", "velocity", use_lognorm=True),
        num_steps=steps, sampling_method="euler", timestep_shift=SHIFT, cfg_scale=CFG_SCALE,
        cfg_interval=True, cfg_interval_start=CFG_START, cfg_channels=3,
        compute_dtype=torch.bfloat16, rope_layout="half", quant_mode=quant, device=dev, **impls,
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
                  count_path=None):
    """SHORT_STEPS steps from z through two impl sets; the latents within 5e-2
    of their scale, and the kernel path's latents decoded by ``decode_impl``
    within 8 levels of the plain ``xla`` decode of the same latents. With
    ``count_path``, the first run's launches are counted exactly."""
    import torch

    from ldmae_tpu_torch import ops

    log(f"[pipeline] {SHORT_STEPS} steps: {what} from the same noise")
    latents = bundle | {"vae": None}
    ops.reset_launch_counts()
    lat_k = sampler(spec, SHORT_STEPS, dev, **kernel_kw)(latents, y, z=z)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if count_path:
        check_counts(count_path, counts)
    lat_x = sampler(spec, SHORT_STEPS, dev, **ref_kw)(latents, y, z=z)
    if not (torch.isfinite(lat_k).all() and lat_k.shape == (BATCH, 16, 32, 32)):
        raise SystemExit(f"{what}: latents are not finite ({BATCH}, 16, 32, 32)")
    lat_rel = float((lat_k - lat_x).abs().max() / lat_x.abs().max())
    moved = float((lat_x - z).abs().max())
    vae = bundle["vae"]
    img_k = vae.decode_to_images(lat_k, compute_dtype=torch.bfloat16, attn_impl=decode_impl)
    img_x = vae.decode_to_images(lat_k, compute_dtype=torch.bfloat16, attn_impl="xla")
    px = int((img_k.int() - img_x.int()).abs().max())
    px_paths = int((img_x.int() - vae.decode_to_images(lat_x, compute_dtype=torch.bfloat16,
                                                       attn_impl="xla").int()).abs().max())
    ok = lat_rel <= 5e-2 and moved > 1e-2 and px <= 8
    log(f"  latents max rel err {lat_rel:.6g} (tolerance 5e-2: bf16 roundings in other places, "
        f"compounded over {SHORT_STEPS} CFG-10 steps); latents moved {moved:.4g} from z; decode "
        f"{decode_impl} vs xla max pixel diff {px} (tolerance 8 levels); images of the two paths' "
        f"latents differ by up to {px_paths} levels -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{what}: the two paths disagree")
    return counts


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
    from ldmae_tpu_torch.ops import fused_adaln as fad
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
                    10 * b * h * n * n * d)
        rows[name] = (err, ms, plain_ms, fb_ms - f_ms, *bnd, parts)
        split = ", ".join(f"{key[:-3]} {v:.4f}" for key, v in parts.items())
        log(f"  {name} (training shapes): kernel {ms:.4f} ms ({split}; main kernel's share of bound "
            f"{bnd[0] / parts['main_ms']:.3f}), plain {plain_ms:.4f} ms, library "
            f"{fb_ms - f_ms:.4f} ms (SDPA backward = fwd+bwd {fb_ms:.4f} ms minus fwd {f_ms:.4f} ms), "
            f"kernel / library {ms / (fb_ms - f_ms):.3f}, bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"share of bound {bnd[0] / ms:.3f}")
        del qs, ks, vs, o, lse

    # the forward kernels of the training path at its shapes
    fwd_ms = cuda_ms(lambda: fa.flash_attention_rope(q, k, v, cos, sin), 20)
    qr, kr = fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v), 20)
    bnd = bound(4 * b * h * n * d * 2 + 2 * n * d * 4, 4 * b * h * n * n * d)
    parts = rope_parts(lambda: fa.flash_attention_rope(q, k, v, cos, sin))
    log(f"  flash_attention_rope (training shapes): kernel {fwd_ms:.4f} ms (pre-pass {parts['prepass_ms']:.4f}, "
        f"attention {parts['attention_ms']:.4f}), SDPA {lib_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    del q, k, v, g, qr, kr
    x = torch.randn(b, n, 768, generator=gen, device=dev).mul(3).bfloat16()
    w = 1 + 0.1 * torch.randn(768, generator=gen, device=dev)
    mod = torch.randn(b, 6, 768, generator=gen, device=dev).mul(0.1).bfloat16()
    ms = cuda_ms(lambda: fad.fused_norm_modulate(x, w, mod[:, 0], mod[:, 1]), 50)
    plain_ms = cuda_ms(lambda: fad.fused_norm_modulate_plain(x, w, mod[:, 0], mod[:, 1]), 10)
    bnd = bound(2 * b * n * 768 * 2 + 768 * 4 + 2 * b * 768 * 2, fp32_flops=6 * b * n * 768)
    log(f"  fused_norm_modulate x ({b},{n},768) (training shapes): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bnd[0]:.4f} ms ({bnd[1]})")
    del x
    torch.cuda.empty_cache()
    return rows


def _yaml_config(**sections):
    """The shipped B/1 YAML with its train and data sections replaced."""
    import yaml

    with open("configs/imagenet/lightningdit_b_vmae_f8d16.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg.update(sections)
    return cfg


def grad_check_phase(dev) -> None:
    """One train step of B/1 at full width, depth GRAD_DEPTH, batch
    GRAD_BATCH: loss and per-leaf gradients of the kernel path (the YAML's
    impls, remat 'attn') against the xla path (plain attention, xla adaLN,
    no remat), from the same seeded weights, noise, t and label drops; then
    the kernel path with the untransposed RoPE Jacobian, which must read
    above the bound."""
    import dataclasses

    import torch

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

    def grads(kernels: bool):
        s = dataclasses.replace(spec, use_checkpoint=kernels, remat_policy="attn")
        model = LightningDiT(s, device=dev)
        model.load_state_dict(permute_qk_for_half_rope(sd, s) if kernels else sd)
        impls = (dict(attn_impl="flash_rope", rope_layout="half", adaln_impl="fused") if kernels
                 else dict(attn_impl="xla", rope_layout="interleaved", adaln_impl="xla"))
        loss = dit_loss(model, transport, x1, y, x0=x0, t=t, drop_ids=drop, compute_dtype=torch.bfloat16, **impls)
        loss.backward()
        out = {n: p.grad.float() for n, p in model.named_parameters()}
        return float(loss.detach()), (permute_qk_for_half_rope(out, s, inverse=True) if kernels else out)

    def worst(g, ref):
        errs = {n: float((g[n] - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)) for n in ref}
        name = max(errs, key=errs.get)
        return errs[name], name

    log(f"[train] gradient check: B/1 width 768, depth {GRAD_DEPTH}, batch {GRAD_BATCH}, bf16; kernel path "
        f"(flash_rope, half RoPE, fused adaLN, remat attn) vs xla path (plain attention, xla adaLN, no remat)")
    loss_x, g_x = grads(False)
    loss_k, g_k = grads(True)
    err, leaf = worst(g_k, g_x)
    loss_rel = abs(loss_k - loss_x) / abs(loss_x)
    ok = err <= GRAD_REL_L2 and loss_rel <= 1e-2 and all(bool(torch.isfinite(v).all()) for v in g_k.values())
    log(f"  loss kernel {loss_k:.6f} vs xla {loss_x:.6f} (relative {loss_rel:.3g}, bound 1e-2); worst leaf "
        f"{leaf}: relative L2 {err:.6g} (bound {GRAD_REL_L2}) over {len(g_x)} leaves -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("gradient check: the kernel path's gradients disagree with the xla path's")
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

    def config(name: str, layout: str, steps: int) -> str:
        cfg = _yaml_config(
            data={"data_path": data, "image_size": 256, "num_classes": 1000, "latent_norm": True,
                  "latent_multiplier": 1.0, "sample": False},
            train={"max_steps": steps, "global_batch_size": TRAIN_BATCH, "global_seed": 0,
                   "output_dir": tmp, "exp_name": name, "log_every": 5, "ckpt_every": TRAIN_STEPS,
                   "use_checkpoint": True, "gradient_accumulation_steps": 1, "weight_init": weights})
        cfg["parallel"]["rope_layout"] = layout
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
    return {"train": counts, "interleaved": icounts}


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
OWN_KERNELS = ("flash_fwd_kernel", "flash_fwd_wgmma_kernel", "norm_rope_kernel", "norm_modulate_kernel",
               "matmul_silu_kernel", "norm_modulate_quant_kernel", "silu_mul_quant_kernel",
               "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel", "flash_bwd_preprocess_kernel",
               "flash_bwd_wgmma_kernel", "flash_bwd_postprocess_kernel")
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

    t0 = time.perf_counter()
    report = kernels.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s for {len(report)} libraries (nvcc in parallel)")
    for name, info in report.items():
        regs = [ln.strip() for ln in info["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: {info['seconds']:.2f} s" + "".join(f"\n    {r}" for r in regs))
    # the wgmma kernels: registers at entry (setmaxnreg then gives the
    # consumer warpgroups more), static shared memory (the rings are dynamic)
    for lib, kernel in (("fused_matmul_silu", "matmul_silu_kernel"), ("flash_attention", "flash_fwd_wgmma_kernel"),
                        ("flash_attention", "flash_bwd_wgmma_kernel")):
        log(f"  ptxas {kernel}: {ptxas_summary(report[lib]['ptxas'], kernel)}")

    rows = kernel_phases(dev, BATCH)
    log(f"[kernel] the same at bench.py's batch {BENCH_BATCH}")
    kernel_phases(dev, BENCH_BATCH)
    log("[kernel] int8 products of the w8a8 leg")
    int8_gemm_phase(dev, BATCH)
    rows |= train_kernel_phase(dev)
    profile = "--profile" in sys.argv[1:]
    result = pipeline_phases(dev, profile=profile)
    grad_check_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        result["counts"] |= cli_train_phase(dev, smi, tmp)
    if profile:
        train_profile_phase(dev)

    out = []
    for name, (err, ms, plain_ms, lib_ms, bound_ms, bound_by, parts) in rows.items():
        source, replaces, path = KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": result["counts"][path][name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        } | parts)
    log(smi)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

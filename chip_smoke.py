#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ldmae_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py [--profile]

It builds the port's CUDA kernels from ``ldmae_tpu_torch/csrc`` (one nvcc
per source, in parallel), then:

  1. holds each kernel against its plain PyTorch version on the card in
     bf16 at the shapes the main path below gives it (batch 8: the
     CFG-doubled DiT step and the VMAE decode), and times the kernel, the
     plain version and, where one exists, one PyTorch library call
     computing the same function (a yardstick only; the port never calls
     it); then the same at ``bench.py``'s batch 36;
  2. drives the main path through its entry points: LightningDiT-B/1 +
     VMAE f8d16_prev at full width with seeded random weights (non-zero
     gates), batch 8, 250 Euler steps, timestep shift 0.3, CFG 10 on
     [0.10, 1] with the phased split, decode to uint8 (8, 256, 256, 3),
     with every kernel's launch count zeroed just before and checked
     exactly just after;
  3. runs the same pipeline for 10 steps through the kernels and through
     the plain ``xla`` impls from the same noise and compares the latents
     and the decoded images;
  4. with ``--profile``, traces one 50-step batch with ``torch.profiler``
     and prints device time by kernel and group and the idle share.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line
(batch-8 shapes), and as its last line ``{"ok": true, "device": {...}}``.
Any failure exits non-zero without that line; without a CUDA device, or
outside the repository, it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, at the 700 W limit
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth

# (name, source, the Pallas call it replaces)
KERNELS = {
    "flash_attention_rope": ("ldmae_tpu_torch/csrc/flash_attention.cu", "ldmae_tpu/ops/flash_attention.py:323"),
    "flash_attention": ("ldmae_tpu_torch/csrc/flash_attention.cu", "ldmae_tpu/ops/flash_attention.py:77"),
    "fused_norm_modulate": ("ldmae_tpu_torch/csrc/fused_norm_modulate.cu", "ldmae_tpu/ops/fused_adaln.py:232"),
    "fused_matmul_silu": ("ldmae_tpu_torch/csrc/fused_matmul_silu.cu", "ldmae_tpu/ops/fused_adaln.py:199"),
}

BATCH, STEPS, CFG_SCALE, SHIFT, CFG_START = 8, 250, 10.0, 0.3, 0.10
BENCH_BATCH = 36  # bench.py's batch: kernel shapes also checked and timed there
N1 = 68  # single-batch Euler steps before the CFG interval at 250 steps, shift 0.3
DEPTH, DEC_DEPTH = 12, 12
EXPECTED_LAUNCHES = {
    "flash_attention_rope": (STEPS - 1) * DEPTH,
    "fused_norm_modulate": 2 * (STEPS - 1) * DEPTH,
    "fused_matmul_silu": (STEPS - 1) * DEPTH,
    "flash_attention": DEC_DEPTH,
}


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
    rows["flash_attention_rope"] = (err, ms, plain_ms, lib_ms,
                                    *bound(4 * b * h * n * d * 2 + 2 * n * d * 4, 4 * b * h * n * n * d))
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
                               *bound(4 * b * h * n * d * 2, 4 * b * h * n * n * d))
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
                                          fp32_flops=6 * b * n * d))
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
                                 *bound((m * d + h2 * d + m * h2 // 2) * 2 + h2 * 4, 2 * m * d * h2))
    del x, w12
    torch.cuda.empty_cache()

    for name, (err, ms, plain_ms, lib_ms, bound_ms, bound_by) in rows.items():
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"  {name} (batch {batch}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), share of bound {bound_ms / ms:.3f}")
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


def sampler(spec, steps, dev, kernels: bool):
    from ldmae_tpu_torch.eval.sampling import make_sample_fn
    from ldmae_tpu_torch.transport import create_transport

    impls = (dict(attn_impl="flash_rope", adaln_impl="fused", mlp_impl="fused") if kernels
             else dict(attn_impl="xla", adaln_impl="xla", mlp_impl="xla"))
    import torch

    return make_sample_fn(
        spec, create_transport("Linear", "velocity", use_lognorm=True),
        num_steps=steps, sampling_method="euler", timestep_shift=SHIFT, cfg_scale=CFG_SCALE,
        cfg_interval=True, cfg_interval_start=CFG_START, cfg_channels=3,
        compute_dtype=torch.bfloat16, rope_layout="half", device=dev, **impls,
    )


def pipeline_phases(dev, profile: bool = False) -> dict:
    import torch

    from ldmae_tpu_torch import ops

    spec, bundle = build_models(dev)
    y = torch.arange(BATCH, device=dev) * 125 % 1000
    sample_fn = sampler(spec, STEPS, dev, kernels=True)
    log(f"[pipeline] warm-up: LightningDiT-B/1 + VMAE f8d16_prev, batch {BATCH}, 4 steps")
    sampler(spec, 4, dev, kernels=True)(bundle, y, generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()

    log(f"[pipeline] main path: batch {BATCH}, {STEPS} Euler steps, shift {SHIFT}, CFG {CFG_SCALE} "
        f"on [{CFG_START}, 1] (phased: {N1} single-batch steps), decode to uint8")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    imgs = sample_fn(bundle, y, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  launches: {counts}")
    if counts != EXPECTED_LAUNCHES:
        raise SystemExit(f"launch counts {counts} != expected {EXPECTED_LAUNCHES}")
    if imgs.shape != (BATCH, 256, 256, 3) or imgs.dtype != torch.uint8:
        raise SystemExit(f"images {tuple(imgs.shape)} {imgs.dtype}, expected ({BATCH}, 256, 256, 3) uint8")
    spread = float(imgs.float().std())
    if not spread > 1.0:
        raise SystemExit(f"images are flat (std {spread}): the pipeline did not move them")
    log(f"  images {tuple(imgs.shape)} uint8, pixel std {spread:.3f}; {seconds:.4f} s per batch of "
        f"{BATCH}, {BATCH / seconds:.4f} images/s, peak memory {peak_gb:.3f} GB "
        f"on {torch.cuda.get_device_name(0)}")

    log("[pipeline] 10 steps: kernels vs the plain xla impls from the same noise")
    z = torch.randn(BATCH, 16, 32, 32, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    latents = bundle | {"vae": None}
    lat_k = sampler(spec, 10, dev, kernels=True)(latents, y, z=z)
    lat_x = sampler(spec, 10, dev, kernels=False)(latents, y, z=z)
    if not (torch.isfinite(lat_k).all() and lat_k.shape == (BATCH, 16, 32, 32)):
        raise SystemExit("kernel-path latents are not finite (8, 16, 32, 32)")
    lat_rel = float((lat_k - lat_x).abs().max() / lat_x.abs().max())
    moved = float((lat_x - z).abs().max())
    vae = bundle["vae"]
    img_k = vae.decode_to_images(lat_k, compute_dtype=torch.bfloat16, attn_impl="flash_rope")
    img_x = vae.decode_to_images(lat_k, compute_dtype=torch.bfloat16, attn_impl="xla")
    px = int((img_k.int() - img_x.int()).abs().max())
    ok = lat_rel <= 5e-2 and moved > 1e-2 and px <= 8
    log(f"  latents max rel err {lat_rel:.6g} (tolerance 5e-2: bf16 roundings, and RoPE rotated in fp32 "
        f"in the kernel but in bf16 by apply_rope_half, compounded over 10 CFG-10 steps); latents moved "
        f"{moved:.4g} from z; decode kernel vs xla max pixel diff {px} (tolerance 8 levels) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("kernel path disagrees with the xla path")
    if profile:
        profile_phase(spec, bundle, y, dev)
    return {"counts": counts, "seconds": seconds}


PROFILE_STEPS = 50  # 14 single-batch Euler steps, 35 doubled: the main path's split in proportion
OWN_KERNELS = ("flash_fwd_kernel", "rope_half_kernel", "norm_modulate_kernel", "matmul_silu_kernel")
# device-time groups of the profile, by kernel name; the first match wins
PROFILE_GROUPS = (
    ("port kernels", OWN_KERNELS),
    ("cuBLAS GEMMs", ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cublas")),
    ("casts and copies", ("copy",)),
    ("reductions", ("reduce_kernel",)),
    ("other elementwise", ("",)),
)


def profile_phase(spec, bundle, y, dev) -> None:
    """Where the time goes: torch.profiler over one batch sampled at
    PROFILE_STEPS steps and decoded; device time by kernel, by group (the
    port's kernels, cuBLAS GEMMs, everything else) and the device's idle
    share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn = sampler(spec, PROFILE_STEPS, dev, kernels=True)
    fn(bundle, y, generator=torch.Generator(device=dev).manual_seed(3))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(bundle, y, generator=torch.Generator(device=dev).manual_seed(3))
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
    log(f"[profile] batch {BATCH}, {PROFILE_STEPS} steps + decode under torch.profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{sum(e.count for e in events)} kernel launches")
    for group, ms in groups.items():
        log(f"  {group}: {ms:.1f} ms ({ms / busy_ms:.3f} of device time)")
    for e in events[:20]:
        ms = e.self_device_time_total / 1e3
        log(f"  {ms:9.2f} ms {e.count:6d}x {ms / busy_ms:6.3f}  {e.key[:110]}")


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

    rows = kernel_phases(dev, BATCH)
    log(f"[kernel] the same at bench.py's batch {BENCH_BATCH}")
    kernel_phases(dev, BENCH_BATCH)
    result = pipeline_phases(dev, profile="--profile" in sys.argv[1:])

    out = []
    for name, (err, ms, plain_ms, lib_ms, bound_ms, bound_by) in rows.items():
        source, replaces = KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": result["counts"][name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        })
    log(smi)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

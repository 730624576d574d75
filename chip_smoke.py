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
     (#3, #4, #9, #10 at the B/1 shapes) against its plain fp32 version,
     timed; #4 in fp32 (3xTF32 on the GEMM engine) also against the fp64
     function at B/1's and XL/1's widths with the TF32-matmul control that
     must fail, its kernels named, beside ``torch.addmm`` and the bound by
     both routes (``matmul_silu_f32_row``); #1, #2, #7 and #8 in fp32, on the tensor cores as 3xTF32 at d =
     64 and 72 (``fp32_fwd_phase``): against the plain fp32 forward (and
     its lse) at B/1's and XL/1's training shapes, N = 256, a ragged N and
     the sampling shape (#7 and #8 on views of a packed qkv), against the
     fp64 forward with the plain forward under TF32 matmuls as the control
     that must fail, bit for bit from run to run, the kernels that ran named
     by torch.profiler, timed warm and queued beside SDPA's fp32 forward and
     the bound by both routes; the SIMT fp32 forward at d = 16, 128 and for
     an unaligned view the same way; #5 and #6 in fp32, on the tensor cores
     as 3xTF32 at d = 64 and 72 (``fp32_bwd_phase``): against the plain fp32 backward at B/1's and
     XL/1's training shapes, N = 256 and a ragged N, against the fp64
     backward with the plain backward under TF32 matmuls as the control
     that must fail, bit for bit from run to run, the kernels that ran
     named by torch.profiler, timed warm and queued by kernel beside SDPA's
     fp32 backward and the bound by both routes (3xTF32, FMA pipes); the
     SIMT fp32 backward at d = 16 and 128 against the plain version, bit
     for bit, its kernels named;
     ``dense`` in bf16 with an fp32 bias against fp64 math
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
  4b. the sampler slice (also alone under ``--samplers``): the same B/1 +
     VMAE pipeline through ``make_sample_fn`` in each sampling mode the
     sampling CLI reads from its YAML, batch 8, CFG 10 on [0.10, 1], bf16,
     each leg timed (seconds per batch, images/s) with its launches counted
     from 0 and checked exactly. The SDE legs run the Linear path with noise
     prediction and eps 1e-3 (the production velocity transport's eps 0
     starts the SBDM SDE at t0 = 0, where its 1/t drift is infinite); each
     SDE drift evaluation is one DiT forward. Doubled forwards a batch and
     launches (dense besides: 53 a forward, 51 the decode):

       leg                              forwards   #1      #3      #4     #2  #6
       SDE Euler, 50 steps, Mean        49 + 1     600     1,200   600    12  -
       SDE Heun, 50 steps               49x2 + 1   1,188   2,376   1,188  12  -
       ODE RK4, 50 steps, shift 0.3     49x4       2,352   4,704   2,352  12  -
       ODE dopri5 (rtol 1e-3, atol      1 + 6 x    12 a forward, from the
         1e-6; at most 100 attempted)   attempted  solver's own tally
       likelihood, rk4, 20 nodes,       19x4       912     1,824   0      -   912
         unguided batch 8, fp32 state   (batch 8; the MLP xla, #4 having no
                                        backward; dense 65 an evaluation)
       ODE Euler 50 under sdpa          49         0       1,176   588    0   -
         (phased CFG; decode under sdpa too; beside the flash_rope
         pipeline, the two in turns: #1's end-to-end library yardstick)

     Two SDE Euler batches from ``torch.Generator(device).manual_seed(0)``
     are pixel for pixel equal (control: the same z, other SDE noise). The
     likelihood (``transport.adaptive.make_likelihood_fn``) is of the bf16
     ODE pipeline's latents. Gates, each with a control that must fail:
     10-step latents of the SDE Euler, SDE Heun, RK4 and sdpa legs with the
     kernels against the same leg under xla with the same z and injected
     SDE noise within 5e-2 of their scale (control: another SDE noise draw,
     for the ODE legs another z); dopri5 in fp32, 8 attempted steps, kernels
     against xla within 1e-3, both tallies reported; the likelihood at 5
     nodes, per-sample logp within 1e-4 relative and the divergence
     integral within 5e-2 of its scale (control: eps = 0). Its own JSON line
     ``{"samplers": ...}``;
  5. holds the two flash-attention backward kernels, given the forward's
     output and lse as the autograd Functions give them, against their plain
     backward at the DiT training shapes (32, 12, 1024, 64) bf16 by a
     per-output relative L2 error and an elementwise bound, which two wrong
     backwards (no rowsum term; the RoPE Jacobian untransposed) must exceed,
     and times them (the backward alone, and its kernels apart by name under
     ``torch.profiler``: RoPE pre-pass, preprocess, single pass,
     postprocess) beside the plain backward and the backward of
     ``F.scaled_dot_product_attention`` (fwd+bwd minus fwd); also the
     forward kernels #1, #3 (and #9) at the training shapes, and #3's
     backward kernel (``rows::bwd``, csrc/norm_rows.cuh) through the autograd
     Function at (32, 1024, 768) (``fnm_bwd_row``: the plain backward and
     fp64 as references, a bitwise repeat, shift and scale swapped as the
     control; timed by kernel beside the plain backward; also in fp32, at a
     tp rank's (8, 1024, 1536) and at L/2's, XL/2's and 1p6B/1's rows);
  5b. the XL slice's kernels at head dim 72 (also under --xl): #1 at (16,
     16, 1024, 72) and (72, 16, 1024, 72), #2, #7 and #8 at the first, #6
     and #5 at (32, 16, 1024, 72) given the forward's output and lse, each
     against its plain version (the forward and backward gates above, with
     the wrong backwards as controls), timed beside SDPA and the bound, and
     each run's kernels named by torch.profiler: the wgmma kernels alone;
  6. checks one train step of B/1 at full width (depth 2, batch 8) on the
     card: the loss and every parameter's gradient of the kernel path (the
     shipped YAML's flash_rope, half-split RoPE, fused adaLN, remat 'attn')
     against the plain xla path from the same weights, noise, t and label
     drops, within GRAD_REL_L2, which the path with the untransposed RoPE
     Jacobian must exceed; then the same in fp32, half and interleaved
     RoPE, within GRAD_F32_REL_L2, with exact launch counts, at B/1 and at
     XL/1 (head dim 72: the fp32 backward's ``_xl`` entries' launches);
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
  7b. the XL legs (also under --xl): LightningDiT-XL/1 (28 blocks, D
     1,152, 16 heads of 72) on the shipped YAML with model.model_type
     changed (``xl_yaml``), seeded weights: 10 steps of the YAML's kernels
     against the plain xla impls from one noise (the B/1 gate, 5e-2; the
     control another noise); ``cli.inference`` on one batch of 8, 50
     Euler steps (cut from 250), phased CFG 10, VMAE decode to PNGs,
     launches exact (#1 392, #3 784, #4 392, #2 12), seconds a batch, both
     at depth 8 (cut from 28); ``cli.train_dit`` at full depth, batch 32
     (cut from 256), 4 steps, remat attn, launches exact (a step: #1 56, #3
     112, #6 28), finite losses, steps/s, MFU, peak memory
     (the final checkpoint's 11 GB write left out); the gradient check of
     6. at XL width, depth 4, with its launches and control;
  7c. the registry slice (also under --registry): early, beside 5b, the
     slice's kernel shapes against their plain versions, timed beside the
     bound (#10 at L/2's and 1p6B/1's SwiGLU widths 2,730 and 4,778, which
     run its realigning kernel, and at XL's 3,072, its tp halves at 1,365
     and 2,389; #9 at D 1,152
     and 1,792; #1 at the patch-2 archs' (16, 16, 256, 64) and (16, 16,
     256, 72) beside SDPA; int8_dense at XL's and 1p6B's w12 and w3); then
     every arch and parallel.quant mode through the sampling CLI's pipeline
     builder on the shipped YAML with model.model_type and parallel.quant
     changed, seeded weights, batch 8, CFG 10 phased, shift 0.3: XL/1 under
     w8a8 and B/1 under w8 through ``cli.inference`` (50 steps, PNGs,
     launches exact, seconds a batch, images/s, peak memory), and L/2, XL/2
     and 1p6B/1 at full width, depth cut to 8, for 10 steps in bf16 and
     w8a8; for
     each leg, each mode's 10-step latents within 5e-2 relative L2 of the
     plain xla path with no port kernel launched (control: another noise),
     each quantized mode within ``QUANT_REL_MAX`` of bf16 (control: the
     weight scales 10 % high), launches exact, images not flat;
  7d. the registry's training slice (also under --registry): early, beside
     5b, the training kernels at batch 32 against their plain versions, each
     timed beside its bound and library call, the route named by
     torch.profiler (#1 with lse and #6 at L/2's (32, 16, 256, 64), XL/2's
     (32, 16, 256, 72) and 1p6B/1's (32, 28, 1024, 64), with the wrong
     backwards as controls and dq, dk, dv equal from run to run; #2 and #5 at the first
     two; #3 through its autograd Function at D 1,024, 1,152 and 1,792;
     dense_bias_f32 and its backward at L's and 1p6B's SwiGLU linears, N
     5,460 / 9,556 and K 2,730 / 4,778, beside cuBLAS); then
     ``cli.train_dit`` at L/2, XL/2 and 1p6B/1 at full width and depth as
     7b's XL/1 (batch 32, 4 steps, seeded gates, no final checkpoint
     write): launches exact, finite losses and gradient norms, the weights
     and the EMA moved, steps/s, MFU, peak memory; the gradient check of 6.
     at each arch's full width, depth 4, and under rope_layout interleaved
     at L/2 and XL/2 (control: #5 without the rowsum term);
  8. with ``--profile``, traces one 50-step batch of the bf16 and of the
     w8a8 path, and one training step, with ``torch.profiler`` and prints
     device time by kernel and group and the idle share;
  9. the extraction and evaluation slice on 256 seeded PNGs (300 x 280, two
     classes) with seeded VMAE, LPIPS and Inception weights: latent
     extraction through ``cli.extract_features`` at --batch 64 (flip-doubled,
     the CLI's xla attention, the shipped YAML's raw moments) with exact
     launch counts, the shards read back (count, labels, each image's latents
     and its flip's against a re-encode) and the statistics file against its
     recomputation, images/s and peak memory; the encoder under ``flash``
     (#2's resident kernel, exact counts) against ``xla``, #2 at the encoder's
     (128, 12, 1024, 16) and ``dense`` at the encoder's linears (M = 131,072,
     K = 192 and 768) against their plain versions, timed beside SDPA and
     cuBLAS, with bounds (their own JSON line, ``{"encoder_kernels": [...]}``);
     ``cli.evaluate_tokenizer`` on 64 of the images at batch 32 with exact
     counts (finite rFID, PSNR, LPIPS, SSIM; LPIPS(x, x) = 0, SSIM(x, x) = 1)
     and its roundtrip's images/s; the FID InceptionV3 on the card against
     its CPU path and its images/s at batch 64; ``cli.fid_stats`` and
     ``cli.evaluate`` on two seeded npz sets, and FID(a, a) = 0;
 10. VMAE training on those PNGs: stage 1 and stage 3 of
     ``scripts/train_ae.sh`` through ``cli.train_vmae`` (the production arch
     at full width and depth, the recipe's flags, 2 epochs x 2 steps each,
     LPIPS on seeded random weights), ``dense``'s launches counted by (M,
     K, N) exactly, finite losses, stage 3 from stage 1's
     ``checkpoint-0.pth`` with its frozen parameters bitwise unchanged,
     steps/s, images/s, TFLOP/s, MFU and peak memory; a micro-batch's
     gradients against ``dense``'s plain version and LPIPS's gradient in
     the reconstruction; the flash leg (#2, under autograd the resident
     kernel with lse, and #5, the single pass, at head dim 16 counted by
     shape, gradients against xla, one step timed under each); #2 and #5 at
     the three d = 16 shapes against their plain versions (#5 bit for bit
     from run to run, its kernels named) beside SDPA (warm and queued), with
     bounds (their own JSON line, ``{"vmae_train_kernels": [...]}``; stage
     3's #5 also the kernels line's ``flash_attention_bwd_d16``);
     one micro-batch's device time split by group; then stage 1 with
     ``--gradual_resol`` (patch 4: 1,024 tokens either side of the token
     convolutions; the micro-batch cut to 32 x 8), dense counted by shape,
     finite losses, the reference's gradual checkpoint layout, and one
     micro-batch under ``flash`` (#2 and #5 counted by shape) against xla;
 11. the tokenizer family: the SD-VAE, VA-VAE and MAR-VAE at full size
     (256^2, ch 128, seeded weights) through ``build_tokenizer_fns``,
     ``encode_moments`` and ``decode`` of 8 of the PNGs on the card against
     the same module's float32 CPU run (1 image; with a TF32 control), no
     convolution with TF32 allowed, ms a batch, images/s, TFLOP/s and peak
     memory (their own JSON line, ``{"conv_tokenizers": [...]}``); the
     sampling CLI's ``build_pipeline`` with ``vae.model_name: sdv3``
     (LightningDiT-B/1, batch 8, 250 steps, CFG 10, bf16; #1, #3, #4 and
     dense counted exactly, uint8 (8, 256, 256, 3) equal to the SD-VAE's
     decode of the run's latents); ``cli.extract_features`` with the SD-VAE
     on the 256 PNGs and ``cli.evaluate_tokenizer`` with the VA-VAE on 64,
     images/s and peak memory;
 12. the multi-process slice: two ranks on the one card (spawned by
     ``torch.multiprocessing``, gloo, LOCAL_RANK 0 each, the CLIs' own
     ``init_distributed_mode`` finding the group started) through
     ``cli.inference`` (the shipped YAML's B/1 pipeline, 50 steps,
     per_proc_batch_size cut to 8 and fid_num to 40: every index once, the
     manifest's world 2, #1-#4 and ``dense`` counted exactly per rank for its
     3 or 2 batches; batch 3's PNGs moved away and resampled alone, pixel for
     pixel; a rerun at batch 4 refused by the manifest), ``cli.train_dit --dp
     2`` (B/1, global batch 32, 10 steps, counts per rank; the ranks' weights
     bitwise equal; rank 0's checkpoint against one process stepping on the
     concatenated rank batches with the CLI's seeds, within
     ``MP_TRAIN_REL_L2``, which the halves swapped must exceed; a restart to
     12), ``cli.extract_features --limit 200`` (rank shards, 100 each, the
     statistics against their recomputation) and ``cli.evaluate_tokenizer``
     on 64 (rank-named PNGs, rFID on rank 0, PSNR, LPIPS and SSIM against one
     process within ``MP_METRIC_REL``), the native PNG writer on every
     rank; then 10 training steps of the plain CLI here beside 10 under DDP
     in an NCCL group of one (a spawned process), counts exact; its own JSON
     line ``{"multiproc": ...}`` before the card's name;
 13. tensor parallelism (also alone under ``--parallel``): the four kernel
     pieces of tp at LightningDiT-1p0B/1's per-rank shapes under tp 2
     (batch 8 doubled: M = 16,384): ``dense_f32_out`` (proj, w3) with
     bf16(out + bias) equal to ``dense_bias_f32`` bit for bit,
     ``int8_dense_i32`` (w3) equal to ``torch._int_mm`` bit for bit and its
     dequant to ``int8_dense``'s, #10's halves ``silu_mul_amax`` and
     ``silu_mul_quant_scaled`` on two rank slices equal to #10 on the whole
     row bit for bit, each against its plain version and timed beside its
     bound, #1 and #4 at their tp shapes; then two ranks on the card
     (gloo) through ``cli.inference --tp 2`` on 1p0B/1 at full width, depth
     cut to 4, batch 8, 5 steps, phased CFG 10, VMAE decode on the first
     rank, bf16 then w8a8: exact launches a rank, the PNGs and the
     manifest's tp, both ranks' latents bitwise equal, the 5-step latents
     within ``TP_LAT_REL`` relative L2 of one process at tp 1 from the same
     noise, which a w12 shard that is not gate-aligned must exceed; seconds
     a batch at tp 1 and tp 2 (two ranks time-slice the card); its own
     JSON line ``{"tensor_parallel": ...}``. FSDP has no leg here: over
     gloo on CUDA tensors the full state dicts a checkpoint gathers
     segfault (``scripts/gloo_cuda_probe.py``);
 14. tensor parallelism in training (also under ``--parallel``, after 13):
     the training kernels at a rank's shapes of 1p0B/1 under tp 2, batch 8
     (M = 8,192): #1 and #6 at (8, 12, 1024, 64), #3 at (8, 1024, 1536),
     ``dense_bias_f32`` at a rank's qkv with its backward, ``dense_f32_out``
     at proj and w3 and under ``dense_row_parallel``'s backward, each
     against its plain version, timed beside its bound and library call;
     then two ranks on the card (gloo) through ``cli.train_dit --tp 2`` on
     1p0B/1 at full width, depth cut to 4, the shipped YAML's training
     sections (bf16, flash_rope, fused adaLN, remat attn), global batch 8,
     a seeded warm start (std ``TPT_WARM_STD``): 4 steps and a checkpoint, a
     resume to 6, and the control (copy-to-tp's all-reduce left out of the
     backward); one process at tp 1 twice (the second run: the one-process
     path's own spread from run to run). Per rank
     and step: #1 16, #3 32, #6 8, ``dense_bias_f32`` 45, ``dense_f32_out``
     56 (7 a block: proj and w3 forward and recomputed, the fp32 partial dx
     of adaLN, qkv and w12) launches and 65 all-reduces and 8 all-gathers
     over gloo, exact (a
     checkpoint adds 256 all-gathers); each step's loss within
     ``TPT_LOSS_REL`` and the update theta_4 - theta_0 of the gathered
     checkpoint within ``TPT_UPDATE_REL`` relative L2 of one process at tp 1
     from the same weights and data (the control must read above), the
     step-6 checkpoint restored in one process bit for bit; seconds a step
     at tp 1 and tp 2, peak memory a rank; its own JSON line
     ``{"tensor_parallel_training": ...}``. No FSDP x tp leg, for the same
     segfault.

It prints the card's name and power limit, a ``{"kernels": [...]}`` line
(sampling kernels at the batch-8 shapes, the backward kernels and #2 at d
= 64 at the training shapes, the fp32 instantiations as their own entries,
the d = 72 kernels as ``..._xl`` entries, the registry's sampling and
training shapes as entries named by arch; launches from the path that
runs each kernel), and
as its last line
``{"ok": true, "device": {...}}``.
Any failure exits non-zero without that line; without a CUDA device, or
outside the repository, it exits non-zero at once.

``python3 chip_smoke.py --linear`` times only the linear layers' kernels
(#4, ``dense``, ``qdense_pre``) through wrappers that earlier commits have
too, likewise for comparisons within one call; ``--attention`` the d = 64
attention forwards (#7 and #8 by part, with their wrappers' host time a
call, #1, #2) and the 10-step sampling seconds under flash_rope, flash_qkr
and flash_fused.

``python3 chip_smoke.py --vmae`` builds the kernels and runs phase 10 alone,
``--tokenizers`` phase 11 alone, ``--multiproc`` phase 12 alone,
``--samplers`` phase 4b alone, ``--parallel`` phases 13 and 14 alone,
``--xl`` phases 5b and 7b alone (their kernels as an ``{"xl_kernels":
[...]}`` line), ``--registry`` phases 7c and 7d alone (a
``{"registry_kernels": [...]}`` line). The default run prints ``[time]``
lines, the seconds into the run after each phase. ``--xl-kernels`` builds the attention library and runs 5b
without asserting which kernels ran: copied into an unpacked earlier commit
(``git archive`` into a git-ignored directory), it times that commit's
kernels at the same shapes. ``--fp32-bwd`` builds the attention libraries
and runs the fp32 backward's gates and times (phase 1b's
``fp32_bwd_phase``) alone, ending with an ``{"fp32_bwd_times": {...}}``
line; ``--fp32-fwd`` the same for the fp32 forward (``fp32_fwd_phase``),
ending with an ``{"fp32_fwd_times": {...}}`` line. Copied into an unpacked
earlier commit, either times that commit's kernels at the same shapes
(``--fp32-fwd --any-route`` names the forward's kernels without asserting
them, for a commit whose fp32 forward ran other kernels). ``--redesigned``
builds the libraries of #5 at d = 16 and #4 in fp32 and runs their rows
alone (``vmae_attention_rows`` at the flash leg's shapes,
``matmul_silu_f32_row``), ending with a ``{"redesigned_times": {...}}``
line.

``python3 chip_smoke.py --rows`` runs only the #3 / #9 row phases (batch 8,
batch 36, the training shape, fp32) after building their two libraries,
and ends with a ``{"rows": {...}}`` line: copied into a checkout of an
earlier commit whose two C entries take the same arguments, it times that
commit's kernels and wrappers by the same means, for comparisons within
one call.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import json
import math
import multiprocessing
import os
import re
import subprocess
import sys
import tempfile
import time

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak, at the 700 W limit
PEAK_FP32_FLOPS = 67e12   # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core peak (an fp32 product as 3xTF32 is three)
PEAK_INT8_OPS = 1979e12   # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth

_FA, _FA32 = "ldmae_tpu_torch/csrc/flash_attention.cu", "ldmae_tpu_torch/csrc/flash_attention_fp32.cu"
_PALLAS_FA, _PALLAS_AD = "ldmae_tpu/ops/flash_attention.py", "ldmae_tpu/ops/fused_adaln.py"
_DENSE = "ldmae_tpu_torch/csrc/dense.cu"
_NORM_ROWS = "ldmae_tpu_torch/csrc/norm_rows.cuh"
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
    # the same at XL's head dim 72, launched by the fp32 gradient checks at XL/1
    "flash_attention_fp32_xl": (_FA32, f"{_PALLAS_FA}:77", "grad_fp32_xl_interleaved", "flash_attention"),
    "flash_attention_rope_fp32_xl": (_FA32, f"{_PALLAS_FA}:323", "grad_fp32_xl_half", "flash_attention_rope"),
    "flash_attention_bwd_fp32_xl": (_FA32, f"{_PALLAS_FA}:151", "grad_fp32_xl_interleaved", "flash_attention_bwd"),
    "flash_attention_rope_bwd_fp32_xl": (_FA32, f"{_PALLAS_FA}:429", "grad_fp32_xl_half", "flash_attention_rope_bwd"),
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
    # tensor parallelism (phase 13, launches per rank of the --tp 2 CLI leg):
    # the row-parallel partials (the fp32 sum under the JAX psum of dense's
    # dot, the int32 sum under the psum of qdense_pre's int8 dot) and #10's
    # two halves around the all-reduce of the row maxima
    "dense_f32_out": (_DENSE, "ldmae_tpu/ops/linear.py:21", "tp_bf16", "dense_f32_out"),
    "int8_dense_i32": (_DENSE, "ldmae_tpu/ops/quant.py:107", "tp_w8a8", "int8_dense_i32"),
    "silu_mul_amax": ("ldmae_tpu_torch/csrc/fused_quant.cu", f"{_PALLAS_AD}:144", "tp_w8a8", "silu_mul_amax"),
    "silu_mul_quant_scaled": ("ldmae_tpu_torch/csrc/fused_quant.cu", f"{_PALLAS_AD}:144", "tp_w8a8",
                              "silu_mul_quant_scaled"),
    # tensor parallelism in training (phase 14, launches per rank of the
    # --tp 2 CLI leg's 4 steps): the training path's kernels at a rank's
    # shapes of 1p0B/1 at batch 8
    "flash_attention_rope_tp_train": (_FA, f"{_PALLAS_FA}:323", "tp_train", "flash_attention_rope"),
    "flash_attention_rope_bwd_tp_train": (_FA, f"{_PALLAS_FA}:429", "tp_train", "flash_attention_rope_bwd"),
    "fused_norm_modulate_tp_train": ("ldmae_tpu_torch/csrc/fused_norm_modulate.cu", f"{_PALLAS_AD}:232", "tp_train",
                                     "fused_norm_modulate"),
    # #3's backward (the JAX custom VJP's backward, XLA there, at :263):
    # B/1's training shape, fp32, a tp rank's rows
    "fused_norm_modulate_bwd": (_NORM_ROWS, f"{_PALLAS_AD}:263", "train", "fused_norm_modulate_bwd_kernel"),
    "fused_norm_modulate_bwd_fp32": (_NORM_ROWS, f"{_PALLAS_AD}:263", "train_fp32", "fused_norm_modulate_bwd_kernel"),
    "fused_norm_modulate_bwd_tp_train": (_NORM_ROWS, f"{_PALLAS_AD}:263", "tp_train",
                                         "fused_norm_modulate_bwd_kernel"),
    "dense_tp_train": (_DENSE, "ldmae_tpu/ops/linear.py:21", "tp_train", "dense_bias_f32"),
    # #5 at the VMAE's d = 16 (the single pass), stage 3's decoder shape and
    # launches a step of the flash leg (make_vmae_train_step(attn_impl="flash"))
    "flash_attention_bwd_d16": (_FA, f"{_PALLAS_FA}:151", "vmae_flash_stage3", "flash_attention_bwd"),
    "dense_f32_out_tp_train": (_DENSE, "ldmae_tpu/ops/linear.py:21", "tp_train", "dense_f32_out"),
}
WRAPPERS = ("flash_attention_rope", "flash_attention", "fused_norm_modulate", "fused_matmul_silu",
            "flash_attention_qknorm_rope", "flash_attention_fused_rope", "fused_norm_modulate_quant",
            "fused_silu_mul_quant", "flash_attention_bwd", "flash_attention_rope_bwd", "flash_attention_resident",
            "dense_bias_f32", "int8_dense", "dense_f32_out", "int8_dense_i32", "silu_mul_amax", "silu_mul_quant_scaled",
            "fused_norm_modulate_bwd_kernel")

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
# the Orbax route's card leg: a JAX run converted at step ORBAX_STEP (by
# train.jax_import), resumed for ORBAX_RESUMED steps; a control with its
# AdamW moments zeroed must move the first update by more than
# ORBAX_CONTROL_REL (relative L2), the bound the identical rerun's spread
# must stay under
ORBAX_STEP, ORBAX_RESUMED, ORBAX_CONTROL_REL = 1000, 2, 1e-2
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
# #3's backward kernel against the plain fp32 backward (fused_norm_modulate_bwd)
# on the same inputs: fp32 outputs (dw; all four for fp32 x) within relative
# L2 FNM_BWD_REL of it; bf16 outputs (dx, and dshift and dscale, each cast
# once from fp32 sums) within one bf16 ulp of it in all but FNM_BWD_ULP_FRAC
# of the elements (a column sum that cancels to near 0 can move by more);
# each output no farther from the fp64 backward than the plain version is
# (relative L2, at most FNM_BWD_F64_SLACK times the plain version's, plus
# 1e-7). The two sum in another fp32 order, so they are not equal bit for
# bit.
FNM_BWD_REL, FNM_BWD_ULP_FRAC, FNM_BWD_F64_SLACK = 1e-5, 1e-3, 1.1
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
# once more, #3 twice more) and runs the backward kernels #6 (or #5) once and
# #3's twice; the final layer's norm is not fused, and the MLP stays 'xla' in
# training. dense in bf16: the forward's 5 + 5 per block (w12 too), and the
# recomputed segments' four block linears a block again.
def _train_counts(steps: int, depth: int = DEPTH) -> dict:
    return dict(fwd=2 * depth * steps, adaln=4 * depth * steps, bwd=depth * steps, adaln_bwd=2 * depth * steps,
                dense=(5 + 9 * depth) * steps)


def _counts_of(layout: str, steps: int, depth: int = DEPTH, dense: bool = True) -> dict:
    """Exact launches of ``steps`` training steps at ``depth``: #1 and #6
    (half RoPE) or #2 and #5 (interleaved), #3 and its backward, and in bf16
    (``dense``) dense_bias_f32."""
    n = _train_counts(steps, depth)
    fwd, bwd = (("flash_attention_rope", "flash_attention_rope_bwd") if layout == "half"
                else ("flash_attention", "flash_attention_bwd"))
    return _NONE | {fwd: n["fwd"], "fused_norm_modulate": n["adaln"], bwd: n["bwd"],
                    "fused_norm_modulate_bwd_kernel": n["adaln_bwd"]} | (
        {"dense_bias_f32": n["dense"]} if dense else {})


for _path, _steps in (("train", TRAIN_STEPS), ("train_resume", RESUME_STEPS - TRAIN_STEPS),
                      ("orbax_resume", ORBAX_RESUMED)):
    EXPECTED_LAUNCHES[_path] = _counts_of("half", _steps)
EXPECTED_LAUNCHES["interleaved"] = _counts_of("interleaved", INTERLEAVED_STEPS)
EXPECTED_LAUNCHES["train_fp32"] = _counts_of("half", FP32_STEPS, dense=False)
# the fp32 gradient checks: one step at depth GRAD_DEPTH, each layout, at B/1
# and at XL/1 (head dim 72)
for _layout in ("half", "interleaved"):
    EXPECTED_LAUNCHES[f"grad_fp32_{_layout}"] = _counts_of(_layout, 1, GRAD_DEPTH, dense=False)
    EXPECTED_LAUNCHES[f"grad_fp32_xl_{_layout}"] = _counts_of(_layout, 1, GRAD_DEPTH, dense=False)


def log(msg: str) -> None:
    print(msg, flush=True)


def fnm_bwd_check(grads, x, w, shift, scale, g, kind: str = "rms") -> tuple:
    """#3's backward gradients ``grads`` (dx, dw, dshift, dscale) against
    ``fused_norm_modulate_bwd`` and the fp64 backward on the same inputs
    (FNM_BWD_*). Returns (ok, readings)."""
    import torch

    from ldmae_tpu_torch.ops import fused_adaln as fad

    plain = fad.fused_norm_modulate_bwd(x, w, shift, scale, g, kind=kind)
    f64 = fad.fused_norm_modulate_bwd(*(None if t is None else t.double() for t in (x, w, shift, scale, g)),
                                      kind=kind)

    def rel(a, b):
        b = b.double()
        return float((a.double() - b).norm() / b.norm().clamp_min(1e-30))

    ok, read = True, {}
    for name, got, want, exact in zip(("dx", "dw", "dshift", "dscale"), grads, plain, f64):
        if want is None or (name == "dw" and kind == "layer"):  # no weight; the layer norm's zeros
            ok &= (got is None) == (want is None) and (got is None or not bool(got.any()))
            continue
        ok &= got.dtype == want.dtype and got.shape == want.shape and bool(torch.isfinite(got).all())
        if want.dtype == torch.bfloat16:
            m, e = torch.frexp(want.float())
            ulp = torch.ldexp(torch.ones_like(m), e - 8)
            read[f"{name}_beyond_ulp"] = float(((got.float() - want.float()).abs() > ulp).float().mean())
            ok &= read[f"{name}_beyond_ulp"] <= FNM_BWD_ULP_FRAC
        else:
            read[f"{name}_rel"] = rel(got, want)
            ok &= read[f"{name}_rel"] <= FNM_BWD_REL
        read[f"{name}_f64"] = (rel(got, exact), rel(want, exact))
        ok &= read[f"{name}_f64"][0] <= FNM_BWD_F64_SLACK * read[f"{name}_f64"][1] + 1e-7
    return bool(ok), read


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
    warm-up call: the parts of a wrapper that launches more than one kernel.
    A trace without some of them is taken again, up to three in all, as
    ``device_split`` does (late in a long process traces have come back
    without some kernels' records)."""
    for _ in range(3):
        out = dict.fromkeys(names, 0.0)
        for key, ms in _profiled(fn, iters):
            for name in names:
                if name in key:
                    out[name] += ms
        if all(out.values()):
            return out
    raise SystemExit(f"the profiler saw none of {[n for n, v in out.items() if not v]}")


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
          int8_ops: float = 0.0, tf32x3_flops: float = 0.0) -> tuple[float, str]:
    """Least time in ms for the work: the larger of bytes over the memory
    rate and the operations' time, itself the largest of tensor-core bf16
    operations, tensor-core int8 operations, plain fp32 operations (on the
    FMA pipes), fp32 products as 3xTF32 (three TF32 tensor-core products
    each) and exponentials over their units' rates (the units run side by
    side; exponentials over the measured SFU rate)."""
    t_ops = max(bf16_flops / PEAK_BF16_FLOPS, int8_ops / PEAK_INT8_OPS, fp32_flops / PEAK_FP32_FLOPS,
                3 * tf32x3_flops / PEAK_TF32_FLOPS, exps / RATES["ex2"] if exps else 0.0) * 1e3
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


def fnm_bwd_row(dev, label: str, b: int, n: int, d: int, seed: int, dtype=None) -> tuple:
    """#3's backward at x (b, n, d), shift and scale views of a (b, 6, d)
    projection output, as training runs it: the autograd Function's forward
    and backward on the card (the backward kernel launches, counted), its
    gradients within ``fnm_bwd_check`` of the plain backward and of fp64, a
    second call bit for bit the first; the control, the check with shift and
    scale swapped, must fail. The wrapper timed warm, queued and by kernel
    (the column pass and the two sums), with its host time a call, beside
    the plain backward and the bound (x and g read, dx written; about 16
    fp32 operations an element). Returns the kernels line's row."""
    import torch

    from ldmae_tpu_torch.ops import fused_adaln as fad

    dtype = dtype or torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    log(f"[kernel] #3's backward {label}: x ({b},{n},{d}) {str(dtype)[6:]}, shift/scale views of ({b},6,{d}), "
        "under autograd")
    x = (torch.randn(b, n, d, generator=gen, device=dev) * 3).to(dtype)
    w = 1 + 0.1 * torch.randn(d, generator=gen, device=dev)
    ada = (torch.randn(b, 6, d, generator=gen, device=dev) * 0.1).to(dtype)
    go = torch.randn(b, n, d, generator=gen, device=dev).to(dtype)
    sh, sc = ada[:, 0], ada[:, 1]
    xs, ws, adas = (t.detach().requires_grad_() for t in (x, w, ada))
    before = fad.fused_norm_modulate_bwd_kernel.launches
    dx, dw, dada = torch.autograd.grad(fad.fused_norm_modulate(xs, ws, adas[:, 0], adas[:, 1]), (xs, ws, adas), go)
    grads = (dx, dw, dada[:, 0], dada[:, 1])
    ok, read = fnm_bwd_check(grads, x, w, sh, sc, go)
    control = fnm_bwd_check(grads, x, w, sc, sh, go)[0]
    again = fad.fused_norm_modulate_bwd_kernel(x, w, sh, sc, go)
    torch.cuda.synchronize()
    same = all(torch.equal(a_, r_) for a_, r_ in zip(grads, again))
    launched = fad.fused_norm_modulate_bwd_kernel.launches - before == 2
    log(f"  vs the plain backward and fp64: {read}; shift and scale swapped passes the check: {control}; two "
        f"calls bit for bit: {same}; the Function launched the kernel: {launched}")
    if not (ok and same and launched) or control:
        raise SystemExit(f"fused_norm_modulate_bwd {label}: the backward kernel fails its check, its control, its "
                         "repeat or its launch")
    err = float((dx.float() - fad.fused_norm_modulate_bwd(x, w, sh, sc, go)[0].float()).abs().max())

    def run():
        return fad.fused_norm_modulate_bwd_kernel(x, w, sh, sc, go)

    ms, plain_ms = cuda_ms(run, 30), cuda_ms(lambda: fad.fused_norm_modulate_bwd(x, w, sh, sc, go), 10)
    parts = {"queued_ms": queued_ms(run, 30), "host_ms": host_ms(run, 50),
             "kernels_ms": kernel_device_ms(run, ("norm_rows_bwd_kernel", "norm_rows_bwd_sum_kernel",
                                                  "norm_rows_bwd_dw_kernel"))} | read
    es = x.element_size()
    bnd = bound(3 * b * n * d * es + 3 * b * d * es + 2 * d * 4, fp32_flops=16 * b * n * d)
    log(f"  fused_norm_modulate_bwd {label}: kernel {ms:.4f} ms (queued {parts['queued_ms']:.4f}; host a call "
        f"{parts['host_ms']:.4f}; " + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in parts["kernels_ms"].items())
        + f"), plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), share {bnd[0] / ms:.3f} (queued "
        f"{bnd[0] / parts['queued_ms']:.3f})")
    del x, ada, go, xs, ws, adas, dx, dw, dada, again
    torch.cuda.empty_cache()
    return (err, ms, plain_ms, None, *bnd, parts)


def wgmma_ptxas(report: dict) -> None:
    """ptxas's registers at entry (setmaxnreg then gives the consumer
    warpgroups more), static shared memory (the rings are dynamic) and
    spills of the attention library's wgmma kernels and of the fp32
    library's tensor-core kernels; every instantiation of the forward and
    the single-pass backward (d = 64 and 72, with and without lse / RoPE)
    and of the fp32 forward and backward's two kernels must not spill."""
    log(f"  ptxas flash_fwd_resident_kernel: "
        f"{ptxas_summary(report['flash_attention']['ptxas'], 'flash_fwd_resident_kernel')}")
    for lib, names in (("flash_attention", ("flash_fwd_wgmma_kernel", "flash_bwd_wgmma_kernel")),
                       ("flash_attention_fp32", ("tf32x3_bwd_dkdv_kernel", "tf32x3_bwd_dq_kernel"))):
        for kernel in names:
            for d in (64, 72):
                for flag in (0, 1):
                    summary = ptxas_summary(report[lib]["ptxas"], f"{kernel}ILi{d}ELb{flag}EE")
                    log(f"  ptxas {kernel}<{d}, {bool(flag)}>: {summary}")
                    if re.search(r"[1-9]\d* bytes spill", summary) or summary == "not in the report":
                        raise SystemExit(f"{kernel}<{d}, {bool(flag)}>: ptxas reports spills (or no entry): "
                                         f"{summary}")
    # the fp32 forward on the tensor cores; the single-pass backward at d = 16
    # (no RoPE); #4's fp32 GEMM (3xTF32 on wgmma)
    for lib, kernel, label in (
            *(("flash_attention_fp32", f"tf32x3_fwd_kernelILi{d}EE", f"tf32x3_fwd_kernel<{d}>") for d in (64, 72)),
            ("flash_attention", "flash_bwd_wgmma_kernelILi16ELb0EE", "flash_bwd_wgmma_kernel<16, false>"),
            ("fused_matmul_silu", "GateEpiF32", "gemm_kernel<float, ..., GateEpiF32>")):
        summary = ptxas_summary(report[lib]["ptxas"], kernel)
        log(f"  ptxas {label}: {summary}")
        if re.search(r"[1-9]\d* bytes spill", summary) or summary == "not in the report":
            raise SystemExit(f"{label}: ptxas reports spills (or no entry): {summary}")


def engine_ptxas(report: dict) -> None:
    """ptxas's report of the row engine's instantiations at D = 768
    (csrc/norm_rows.cuh): #3 and #9 in bf16 and fp32 (dynamic shared
    memory), and #3's backward."""
    for lib, epi in (("fused_norm_modulate", "8Modulate"), ("fused_quant", "13ModulateQuant")):
        for what, inst in (("bf16", "I13__nv_bfloat16EELi3EE"), ("fp32", "IfEELi6EE")):
            log(f"  ptxas norm_rows_kernel {lib} {what}: {ptxas_summary(report[lib]['ptxas'], epi + inst)}")
    # #3's backward at D = 768 and 1,792 (bf16), 768 (fp32)
    for what, inst in (("bf16 D 768", "I13__nv_bfloat16Li3EE"), ("bf16 D 1792", "I13__nv_bfloat16Li7EE"),
                       ("fp32 D 768", "IfLi6EE")):
        log(f"  ptxas norm_rows_bwd_kernel {what}: "
            f"{ptxas_summary(report['fused_norm_modulate']['ptxas'], 'norm_rows_bwd_kernel' + inst)}")


def gemm_ptxas(report: dict) -> None:
    """ptxas's report of each instantiation of the GEMM engine
    (csrc/gemm.cuh): #4 and the dense / int8_dense configurations, named
    by operand type, accumulator columns, cluster, stages and epilogue."""
    for lib in ("fused_matmul_silu", "dense"):
        log_ = report[lib]["ptxas"]
        for name in sorted(set(re.findall(r"Compiling entry function '(_ZN4gemm11gemm_kernel[^']*)'", log_))):
            cfg = re.search(r"ConfigI(13__nv_bfloat16|a|f)Li(\d+)ELi(\d+)ELi(\d+)ELi(\d+)EE", name)
            epi = re.search(r"(BiasEpi|GateEpiF32|GateEpi|DequantEpiI13__nv_bfloat16E|DequantEpiIfE)", name)
            if cfg is None or epi is None:
                log(f"  ptxas {name}: {ptxas_summary(log_, name)}")
                continue
            label = (f"{ {'a': 'int8', 'f': 'fp32 (3xTF32)'}.get(cfg[1], 'bf16')} BN={cfg[2]} cluster={cfg[3]} "
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


def attention_bwd_row(label: str, bwd_name: str, q, k, v, g, tab: tuple, route) -> tuple:
    """The backward kernel ``bwd_name`` (``flash_attention_bwd``, or with the
    RoPE tables ``tab`` ``flash_attention_rope_bwd``) given the forward's
    output and lse, as the autograd Functions pass them: against its plain
    backward (BWD_REL_L2, BWD_ELEM), the wrong backwards (no rowsum term;
    under RoPE also the Jacobian untransposed) above those bounds, dq, dk
    and dv equal from run to run; timed warm and with the
    device's queue full beside the plain backward and SDPA's on the rotated
    q, k (fwd+bwd minus fwd), with the bound. ``route`` takes the call,
    names the kernels that ran (torch.profiler), and returns the row's parts
    or fails. Returns the kernels line's row."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa

    b, h, n, d = q.shape
    kernel, plain = getattr(fa, bwd_name), getattr(fa, f"{bwd_name}_plain")
    wrongs = {"no rowsum term": lambda *a: wrong_bwd_no_rowsum(
        *((fa._rope_fp32(a[0], *tab), fa._rope_fp32(a[1], *tab)) if tab else a[:2]), a[2], a[3])}
    if tab:
        wrongs["untransposed RoPE Jacobian"] = wrong_rope_bwd_untransposed
    log(f"[{label}] {bwd_name} q,k,v,g ({b},{h},{n},{d}) bf16; the forward's output and lse passed in")
    o, lse = fa._launch(q, k, v, bwd_name, *tab, with_lse=True)  # the library, uncounted

    def run():
        return kernel(q, k, v, g, *tab, out=o, lse=lse)

    ref = plain(q, k, v, g, *tab)
    first = run()
    rel, elem = bwd_errors(first, ref)
    ok = rel <= BWD_REL_L2 and elem <= BWD_ELEM
    log(f"  kernel vs plain backward: relative L2 {rel:.6g} (bound {BWD_REL_L2}), max |err| / max |value| "
        f"{elem:.6g} (bound {BWD_ELEM}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label} {bwd_name}: kernel disagrees with its plain backward")
    for what, wrong in wrongs.items():
        wrel, welem = bwd_errors(wrong(q, k, v, g, *tab), ref)
        bad = wrel > BWD_REL_L2 or welem > BWD_ELEM
        log(f"  control ({what}): relative L2 {wrel:.6g}, max |err| / max |value| {welem:.6g} (must exceed "
            f"{BWD_REL_L2} or {BWD_ELEM}) -> {'ok' if bad else 'FAIL'}")
        if not bad:
            raise SystemExit(f"{label} {bwd_name}: a wrong backward ({what}) reads within the bound")
    second = run()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(first, second))
    spread = float((first[0].float() - second[0].float()).norm() / first[0].float().norm())
    log(f"  run to run: dq, dk and dv equal bit for bit: {same} -> {'ok' if same else 'FAIL'}")
    if not same:
        raise SystemExit(f"{label} {bwd_name}: dq, dk or dv differ from run to run")
    err = max(float((x.float() - r.float()).abs().max()) for x, r in zip(first, ref))
    del first, second, ref
    ms, plain_ms = cuda_ms(run, 10), cuda_ms(lambda: plain(q, k, v, g, *tab), 3, 1)
    qs, ks = (fa._rope_fp32(q, *tab), fa._rope_fp32(k, *tab)) if tab else (q, k)
    qs, ks, vs = (t.detach().requires_grad_() for t in (qs, ks, v))

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(qs, ks, vs), (qs, ks, vs), g)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qs, ks, vs)

    lib_ms = cuda_ms(sdpa_fwd_bwd, 10) - cuda_ms(sdpa_fwd, 10)
    bnd = bound(8 * b * h * n * d * 2 + b * h * n * 4 + (2 * n * d * 4 if tab else 0), 10 * b * h * n * n * d,
                exps=b * h * n * n)
    # where the work is small the host's launch time can exceed the device's: also timed with the queue full
    parts = route(run) | {
        "queued_ms": queued_ms(run, 20), "dq_run_to_run": spread,
        "library_queued_ms": queued_ms(sdpa_fwd_bwd, 20) - queued_ms(sdpa_fwd, 20)}
    log(f"  {bwd_name} ({b},{h},{n},{d}): kernel {ms:.4f} ms (queued {parts['queued_ms']:.4f}), plain {plain_ms:.4f} "
        f"ms, SDPA backward {lib_ms:.4f} ms (queued {parts['library_queued_ms']:.4f}; queued kernel / SDPA "
        f"{parts['queued_ms'] / parts['library_queued_ms']:.3f}), bound {bnd[0]:.4f} ms ({bnd[1]}), share "
        f"{bnd[0] / ms:.3f} (queued {bnd[0] / parts['queued_ms']:.3f})")
    return (err, ms, plain_ms, lib_ms, *bnd, parts)


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
    rows["fused_norm_modulate_bwd"] = fnm_bwd_row(dev, "(B/1 training shape)", b, n, 768, 21)
    torch.cuda.empty_cache()
    return rows


def _yaml_config(**sections):
    """The shipped B/1 YAML with its train and data sections replaced."""
    import yaml

    with open("configs/imagenet/lightningdit_b_vmae_f8d16.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg.update(sections)
    return cfg


@functools.lru_cache(maxsize=1)
def _seeded_state(model_type: str, depth: int) -> dict:
    """The gradient checks' seeded DiT weights (CPU), drawn once for
    consecutive checks of one arch and depth."""
    from ldmae_tpu_torch.models import LightningDiT, dit_spec, seeded_init_

    spec = dit_spec(model_type, depth=depth, input_size=32, in_channels=16, num_classes=1000,
                    use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True)
    return seeded_init_(LightningDiT(spec, device="cpu"), 5).state_dict()


def grad_check_phase(dev, dtype=None, layout: str = "half", count_path=None, grad_bound: float = GRAD_REL_L2,
                     model_type: str = "LightningDiT-B/1", depth: int = GRAD_DEPTH):
    """One train step of ``model_type`` (B/1; XL/1 for the XL slice) at full
    width, depth ``depth``, batch
    GRAD_BATCH: loss and per-leaf gradients of the kernel path (the YAML's
    impls, remat 'attn'; with ``layout`` 'interleaved', RoPE outside the
    kernel, flash_attention and its backward) against the xla path (plain
    attention, xla adaLN, no remat), from the same seeded weights, noise, t
    and label drops, in ``dtype`` (bf16 by default); with ``count_path`` the
    kernel path's launches counted exactly. In bf16, then the kernel path
    with a wrong backward (half RoPE: the untransposed RoPE Jacobian;
    interleaved: #5 without the rowsum term), which must read above the
    bound."""
    import dataclasses

    import torch

    from ldmae_tpu_torch import ops

    dtype = dtype or torch.bfloat16

    from ldmae_tpu_torch.models import LightningDiT, dit_spec, permute_qk_for_half_rope
    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.train import dit_loss
    from ldmae_tpu_torch.transport import create_transport

    spec = dit_spec(model_type, depth=depth, input_size=32, in_channels=16, num_classes=1000,
                    use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True)
    sd = _seeded_state(model_type, depth)
    gen = torch.Generator(device=dev).manual_seed(6)
    x1, x0 = (torch.randn(GRAD_BATCH, 16, 32, 32, generator=gen, device=dev) for _ in range(2))
    y = torch.arange(GRAD_BATCH, device=dev) * 97 % 1000
    t = torch.linspace(0.1, 0.9, GRAD_BATCH, device=dev)
    drop = (torch.arange(GRAD_BATCH, device=dev) % 4 == 0).int()
    transport = create_transport("Linear", "velocity", use_lognorm=True)

    half = layout == "half"
    kernel_counts = {}

    def grads(kernels: bool, count: bool = False):
        s = dataclasses.replace(spec, use_checkpoint=kernels, remat_policy="attn")
        model = LightningDiT(s, device=dev)
        model.load_state_dict(permute_qk_for_half_rope(sd, s) if kernels and half else sd)
        impls = (dict(attn_impl="flash_rope" if half else "flash", rope_layout=layout, adaln_impl="fused")
                 if kernels else dict(attn_impl="xla", rope_layout="interleaved", adaln_impl="xla"))
        ops.reset_launch_counts()
        loss = dit_loss(model, transport, x1, y, x0=x0, t=t, drop_ids=drop, compute_dtype=dtype, **impls)
        loss.backward()
        torch.cuda.synchronize()
        if count:  # the kernel path's own run (not the control's)
            kernel_counts.update(ops.launch_counts())
            if count_path:
                check_counts(count_path, kernel_counts)
        out = {n: p.grad.float() for n, p in model.named_parameters()}
        return float(loss.detach()), (permute_qk_for_half_rope(out, s, inverse=True) if kernels and half else out)

    def worst(g, ref):
        errs = {n: float((g[n] - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)) for n in ref}
        name = max(errs, key=errs.get)
        return errs[name], name

    log(f"[train] gradient check: {model_type} width {spec.hidden_size}, head dim {spec.hidden_size // spec.num_heads}, "
        f"depth {depth}, batch {GRAD_BATCH}, {dtype}; kernel path "
        f"({'flash_rope, half' if half else 'flash, interleaved'} RoPE, fused adaLN, remat attn) vs xla path "
        f"(plain attention, xla adaLN, no remat)")
    loss_x, g_x = grads(False)
    loss_k, g_k = grads(True, count=True)
    err, leaf = worst(g_k, g_x)
    loss_rel = abs(loss_k - loss_x) / abs(loss_x)
    ok = err <= grad_bound and loss_rel <= 1e-2 and all(bool(torch.isfinite(v).all()) for v in g_k.values())
    log(f"  loss kernel {loss_k:.6f} vs xla {loss_x:.6f} (relative {loss_rel:.3g}, bound 1e-2); worst leaf "
        f"{leaf}: relative L2 {err:.6g} (bound {grad_bound}) over {len(g_x)} leaves -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("gradient check: the kernel path's gradients disagree with the xla path's")
    if dtype != torch.bfloat16:
        torch.cuda.empty_cache()
        return kernel_counts
    if half:
        target, wrong, what = "flash_attention_rope_bwd", wrong_rope_bwd_untransposed, "untransposed RoPE Jacobian"
    else:
        target, what = "flash_attention_bwd", "no rowsum term"

        def wrong(q, k, v, g, out=None, lse=None):
            return wrong_bwd_no_rowsum(q, k, v, g)
    saved = getattr(fa, target)
    setattr(fa, target, wrong)  # the control, in this process only
    try:
        _, g_w = grads(True)
    finally:
        setattr(fa, target, saved)
    err, leaf = worst(g_w, g_x)
    log(f"  control ({what}): worst leaf {leaf}: relative L2 {err:.6g} "
        f"(must exceed {GRAD_REL_L2}) -> {'ok' if err > GRAD_REL_L2 else 'FAIL'}")
    if not err > GRAD_REL_L2:
        raise SystemExit("gradient check: a wrong backward reads within the bound")
    torch.cuda.empty_cache()
    return kernel_counts


def write_latent_shards(data: str) -> str:
    """512 synthetic 16-channel 32 x 32 latents (seeded normals, scale 1.5,
    shift 0.2) with their flips and labels, in two shards; returns ``data``."""
    import numpy as np

    from ldmae_tpu_torch.data.latent_dataset import LatentShardWriter

    rng = np.random.default_rng(7)
    writer = LatentShardWriter(data, shard_size=256)
    for _ in range(2):
        lat = rng.standard_normal((256, 16, 32, 32), dtype=np.float32) * 1.5 + 0.2
        writer.add(lat, np.ascontiguousarray(lat[..., ::-1]), rng.integers(0, 1000, 256).astype(np.int64))
    return data


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

    data = write_latent_shards(os.path.join(tmp, "latents"))
    weights = os.path.join(tmp, "seeded.pt")

    def config(name: str, layout: str, steps: int, dtype: str = "bfloat16", warm: bool = True) -> str:
        cfg = _yaml_config(
            data={"data_path": data, "image_size": 256, "num_classes": 1000, "latent_norm": True,
                  "latent_multiplier": 1.0, "sample": False},
            train={"max_steps": steps, "global_batch_size": TRAIN_BATCH, "global_seed": 0,
                   "output_dir": tmp, "exp_name": name, "log_every": 5, "ckpt_every": TRAIN_STEPS,
                   "use_checkpoint": True, "gradient_accumulation_steps": 1, "weight_init": weights if warm else ""})
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
        check_counts(path, counts)
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
    ocounts = orbax_resume_leg(smi, tmp, config("b1_orbax", "half", ORBAX_STEP + ORBAX_RESUMED, warm=False), run)
    return {"train": counts, "interleaved": icounts, "train_fp32": fcounts, "orbax_resume": ocounts}


def orbax_resume_leg(smi: str, tmp: str, cfg: str, run) -> dict:
    """The port side of the Orbax route (``scripts/convert_orbax.py`` runs in
    the JAX environment, which the GPU machine lacks). B/1 at full width and
    depth on the shipped YAML (``cfg``, rope_layout half): seeded weights,
    EMA and AdamW moments, drawn like a trained run's (mu ~ N(0, 1e-3), nu =
    mu^2 + 1e-8), in the run's half layout as the conversion hands them
    over, written by ``train.jax_import`` at step ORBAX_STEP into a fresh
    experiment; ``cli.train_dit`` resumes there for ORBAX_RESUMED steps, a
    second time from the same file (the spread), and from a file with the
    moments zeroed (the control). Gates: the resume at ORBAX_STEP, the end
    at ORBAX_STEP + ORBAX_RESUMED, the weights, EMA, moments and AdamW steps
    on the card before the first update equal to the written ones bit for
    bit, the control's first update more than ORBAX_CONTROL_REL (relative
    L2) from the resumed one and the spread under it, and exact launches
    (``run`` checks them). Returns the first run's launch counts."""
    import shutil

    import torch
    import yaml

    from ldmae_tpu_torch.cli import train_dit
    from ldmae_tpu_torch.core.config import LDMAEConfig
    from ldmae_tpu_torch.models import LightningDiT, seeded_init_
    from ldmae_tpu_torch.train.jax_import import write_dit_checkpoint
    from ldmae_tpu_torch.train.train_dit import spec_from_config

    t0 = time.perf_counter()
    with open(cfg) as f:
        raw = yaml.safe_load(f)
    spec = spec_from_config(LDMAEConfig.from_dict(raw))
    model = seeded_init_(LightningDiT(spec, device="cpu"), 11)
    gen = torch.Generator().manual_seed(12)
    params = model.state_dict()
    ema = dict(params)
    mu, nu = {}, {}
    for n, p in model.named_parameters():
        ema[n] = p.detach() + 1e-3 * torch.randn(p.shape, generator=gen)
        mu[n] = 1e-3 * torch.randn(p.shape, generator=gen)
        nu[n] = mu[n] * mu[n] + 1e-8
    zeros = {n: torch.zeros_like(m) for n, m in mu.items()}
    exp = os.path.join(tmp, raw["train"]["exp_name"])
    t_draw = time.perf_counter() - t0
    path = write_dit_checkpoint(os.path.join(tmp, "orbax_resumed"), raw, params, ema, mu, nu, step=ORBAX_STEP,
                                count=ORBAX_STEP, rope_layout="half")
    t_write = time.perf_counter() - t0 - t_draw
    # the control: the same file with its moments zeroed
    ckpt = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    for state in ckpt["opt"]["state"].values():
        state["exp_avg"], state["exp_avg_sq"] = torch.zeros_like(state["exp_avg"]), torch.zeros_like(state["exp_avg"])
    os.makedirs(os.path.join(tmp, "orbax_control", "checkpoints"))
    torch.save(ckpt, os.path.join(tmp, "orbax_control", "checkpoints", os.path.basename(path)))
    del ckpt
    t_control = time.perf_counter() - t0 - t_draw - t_write
    log(f"[train] the Orbax route's port side: B/1 (depth {spec.depth}, width {spec.hidden_size}) weights, EMA "
        f"and AdamW moments drawn in {t_draw:.2f} s; train.jax_import wrote them at step {ORBAX_STEP} (half layout "
        f"in, canonical on disk, {os.path.getsize(path) / 1e9:.3f} GB) in {t_write:.2f} s; the control (the moments "
        f"zeroed) in {t_control:.2f} s; cli.train_dit resumes for {ORBAX_RESUMED} steps, batch {TRAIN_BATCH}")

    seen = {}
    real_build = train_dit.build_from_config

    def build(*args, **kw):  # the CLI's step, watched before and after the first resumed update
        spec_, model_, transport, step_fn = real_build(*args, **kw)

        def step(state, batch, generator=None, **k):
            if state.step == ORBAX_STEP:
                want = (mu, nu) if seen["moments"] == "resumed" else (zeros, zeros)
                bad = [n for n, p in state.model.named_parameters()
                       if not (torch.equal(p.detach().cpu(), params[n])
                               and torch.equal(state.ema.get_parameter(n).cpu(), ema[n])
                               and torch.equal(state.optimizer.state[p]["exp_avg"].cpu(), want[0][n])
                               and torch.equal(state.optimizer.state[p]["exp_avg_sq"].cpu(), want[1][n])
                               and float(state.optimizer.state[p]["step"]) == ORBAX_STEP)]
                seen["mismatched"] = bad
                seen["before"] = [p.detach().clone() for p in state.model.parameters()]
            out = step_fn(state, batch, generator, **k)
            if state.step == ORBAX_STEP + 1:
                seen["update"] = torch.cat([(p.detach() - w).flatten().float()
                                            for p, w in zip(state.model.parameters(), seen.pop("before"))])
            return out

        return spec_, model_, transport, step

    updates, counts = {}, None
    train_dit.build_from_config = build
    try:
        for label, source in (("resumed", "resumed"), ("rerun", "resumed"), ("control", "control")):
            shutil.rmtree(exp, ignore_errors=True)
            # linked, not copied: the run writes its own files beside the written one
            shutil.copytree(os.path.join(tmp, f"orbax_{source}"), exp, copy_function=os.link)
            seen.clear()
            seen["moments"] = source
            t1 = time.perf_counter()
            out, c, _, peak_gb = run(["--config", cfg], "orbax_resume")
            seconds = time.perf_counter() - t1
            counts = counts or c
            with open(os.path.join(exp, "log.txt")) as f:
                resumed = f"resumed from step {ORBAX_STEP}" in f.read()
            end = out["state"].step
            del out
            bad = seen.get("mismatched", ["(the first resumed step never ran)"])
            log(f"  {label}: log.txt resumed from step {ORBAX_STEP}: {resumed}; ended at step {end}; parameters "
                f"whose weight, EMA, moments or AdamW step on the card differ from the written ones before the "
                f"first update: {len(bad)} {bad[:3]}; {seconds:.2f} s for the call; peak memory {peak_gb:.3f} GB")
            if not resumed or end != ORBAX_STEP + ORBAX_RESUMED or bad or "update" not in seen:
                raise SystemExit(f"Orbax route ({label}): no resume at {ORBAX_STEP}, another end than "
                                 f"{ORBAX_STEP + ORBAX_RESUMED}, or the card's state is not the written one")
            updates[label] = seen.pop("update")
    finally:
        train_dit.build_from_config = real_build
    ref = updates["resumed"]
    spread = float((updates["rerun"] - ref).norm() / ref.norm())
    control = float((updates["control"] - ref).norm() / ref.norm())
    seconds = time.perf_counter() - t0
    ok = spread < ORBAX_CONTROL_REL < control
    log(f"  first update (step {ORBAX_STEP + 1}), relative L2 against the resumed run's: rerun (spread) "
        f"{spread:.6g}, control with zeroed moments {control:.6g} (bound {ORBAX_CONTROL_REL}: spread under it, "
        f"control above) -> {'ok' if ok else 'FAIL'}")
    log(f"  Orbax leg: {seconds:.2f} s in all; on {smi}")
    if not ok:
        raise SystemExit("Orbax route: the moments carried do not set the first update apart from zeroed ones")
    for name in ("resumed", "control"):
        shutil.rmtree(os.path.join(tmp, f"orbax_{name}"), ignore_errors=True)
    shutil.rmtree(exp, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


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
               "norm_rope_any_kernel", "flash32_", "split_tf32_kernel")
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


# The fp32 backward (#5, #6) on the tensor cores as 3xTF32 at d = 64 and 72
# (tf32x3_bwd_dkdv_kernel and tf32x3_bwd_dq_kernel after the preprocess):
# against the plain fp32 backward within F32_BWD at F32_BWD_SHAPES (the
# training shapes of B/1 and XL/1, the patch-2 archs' N = 256, a ragged N);
# against the fp64 backward at F32_F64_SHAPES, each output within
# max(F64_SLACK x the plain fp32 backward's error, F64_FLOOR) (relative L2),
# which the plain backward with TF32 matmuls (one TF32 product) must exceed;
# dq, dk, dv equal bit for bit between two calls (nothing is summed across
# blocks); the kernels that ran named by torch.profiler, the SIMT kernels
# absent. At F32_SIMT_BWD_SHAPES (head dims the tensor-core kernels do not
# take) the SIMT kernels (flash32_bwd_dkdv_kernel, flash32_bwd_dq_kernel)
# are held the same way: F32_BWD, bit for bit, their route with the
# tensor-core kernels absent
F32_BWD_SHAPES = ((TRAIN_BATCH, 12, 1024, 64), (TRAIN_BATCH, 16, 1024, 72), (TRAIN_BATCH, 16, 256, 64),
                  (2, 12, 1000, 64))
F32_SIMT_BWD_SHAPES = ((2, 12, 1000, 16), (2, 12, 1000, 128))
F32_F64_SHAPES = ((4, 12, 1024, 64), (4, 16, 1024, 72))
F64_SLACK, F64_FLOOR = 4.0, 1e-5
TF32X3_BWD = ("flash32_bwd_preprocess_kernel", "tf32x3_bwd_dkdv_kernel", "tf32x3_bwd_dq_kernel")
SIMT_F32_BWD = ("flash32_bwd_dkdv_kernel", "flash32_bwd_dq_kernel")


def _fmt3(xs) -> str:
    return ", ".join(f"{x:.3g}" for x in xs)


def fp32_bwd_phase(dev) -> dict:
    """#5 and #6 in fp32 by the gates above; at (32, 12, 1024, 64) and XL's
    (32, 16, 1024, 72) timed warm and with the device's queue full, by
    kernel (torch.profiler), beside the plain backward and SDPA's fp32
    backward (fwd+bwd minus fwd, warm and queued) and the bound by both
    routes: 3xTF32 on the tensor cores (the kernels line's bound_ms) and
    the FMA pipes (``fma_bound_ms``). Returns the kernels line's rows
    (``..._fp32`` at d = 64, ``..._fp32_xl`` at 72)."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

    gen = torch.Generator(device=dev).manual_seed(29)

    def inputs(shape):
        b, h, n, d = shape
        grid = math.isqrt(n - 1) + 1
        tab = tuple(torch.from_numpy(to_half_layout(t)[:n]).to(dev) for t in build_rope_table(d // 2, grid))
        return [torch.randn(*shape, generator=gen, device=dev) for _ in range(4)], tab

    def calls(q, k, v, g, tab):
        for rope in (False, True):
            name = "flash_attention_rope_bwd" if rope else "flash_attention_bwd"
            tables = tab if rope else ()
            o, lse = fa._launch(q, k, v, name, *tables, with_lse=True)  # the library, uncounted
            kern, plain = getattr(fa, name), getattr(fa, f"{name}_plain")
            yield name, tables, (lambda: kern(q, k, v, g, *tables, out=o, lse=lse)), plain

    rows = {}
    log(f"[fp32] the backward (#5, #6) on the tensor cores as 3xTF32 at {list(F32_BWD_SHAPES)}, "
        f"on the SIMT kernels at {list(F32_SIMT_BWD_SHAPES)}")
    for shape in F32_BWD_SHAPES + F32_SIMT_BWD_SHAPES:
        (q, k, v, g), tab = inputs(shape)
        b, h, n, d = shape
        for name, tables, run, plain in calls(q, k, v, g, tab):
            first = run()
            err = f32_bwd_compare(f"{name} fp32 {shape}", first, plain(q, k, v, g, *tables))
            second = run()
            torch.cuda.synchronize()
            same = all(torch.equal(x, y) for x, y in zip(first, second))
            log(f"  run to run: dq, dk and dv equal bit for bit: {same} -> {'ok' if same else 'FAIL'}")
            if not same:
                raise SystemExit(f"{name} fp32 {shape}: dq, dk or dv differ from run to run")
            del first, second
            rope_pass = ("norm_rope_kernel",) if tables else ()
            if shape in F32_SIMT_BWD_SHAPES:
                train_route(f"{name} fp32 {shape}", run, TF32X3_BWD[:1] + SIMT_F32_BWD + rope_pass, TF32X3_BWD[1:])
                continue
            if shape not in F32_BWD_SHAPES[:2]:
                continue
            want = TF32X3_BWD + rope_pass
            parts = train_route(f"{name} fp32 {shape}", run, want, SIMT_F32_BWD)
            ms, queued = cuda_ms(run, 5), queued_ms(run, 10)
            plain_ms = cuda_ms(lambda: plain(q, k, v, g, *tables), 2, 1)
            qs, ks = (fa._rope_fp32(q, *tab), fa._rope_fp32(k, *tab)) if tables else (q, k)
            qs, ks, vs = (t.detach().requires_grad_() for t in (qs, ks, v))

            def sdpa_fwd_bwd():
                torch.autograd.grad(F.scaled_dot_product_attention(qs, ks, vs), (qs, ks, vs), g)

            def sdpa_fwd():
                with torch.no_grad():
                    F.scaled_dot_product_attention(qs, ks, vs)

            lib_ms = cuda_ms(sdpa_fwd_bwd, 5) - cuda_ms(sdpa_fwd, 5)
            lib_queued = queued_ms(sdpa_fwd_bwd, 10) - queued_ms(sdpa_fwd, 10)
            nbytes = 8 * b * h * n * d * 4 + b * h * n * 4 + (2 * n * d * 4 if tables else 0)
            flops, exps = 10 * b * h * n * n * d, b * h * n * n
            bnd = bound(nbytes, tf32x3_flops=flops, exps=exps)
            fma = bound(nbytes, fp32_flops=flops, exps=exps)[0]
            key = f"{name}_fp32" + ("_xl" if d == 72 else "")
            parts |= {"queued_ms": queued, "library_queued_ms": lib_queued, "fma_bound_ms": fma}
            log(f"  {key} {shape}: kernel {ms:.4f} ms (queued {queued:.4f}), parts "
                f"{ {n_: round(v_, 4) for n_, v_ in parts['kernels_ms'].items()} }, plain {plain_ms:.4f} ms, SDPA's "
                f"fp32 backward {lib_ms:.4f} ms (queued {lib_queued:.4f}; kernel / SDPA {ms / lib_ms:.3f}), bound "
                f"3xTF32 {bnd[0]:.4f} ms ({bnd[1]}; share {bnd[0] / ms:.3f}), FMA pipes {fma:.4f} ms (share "
                f"{fma / ms:.3f})")
            rows[key] = (err, ms, plain_ms, lib_ms, *bnd, parts)
            del qs, ks, vs
        del q, k, v, g
        torch.cuda.empty_cache()
    for shape in F32_F64_SHAPES:
        (q, k, v, g), tab = inputs(shape)
        for name, tables, run, plain in calls(q, k, v, g, tab):
            exact = plain(*(t.double() for t in (q, k, v, g)), *tables)

            def rels(outs):
                return [float((x.double() - r).norm() / r.norm()) for x, r in zip(outs, exact)]

            kernel, f32 = rels(run()), rels(plain(q, k, v, g, *tables))
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = rels(plain(q, k, v, g, *tables))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            bounds = [max(F64_SLACK * e, F64_FLOOR) for e in f32]
            ok = all(e <= bd for e, bd in zip(kernel, bounds))
            control = all(e > bd for e, bd in zip(tf32, bounds))
            log(f"  {name} fp32 {shape} against fp64 (dq, dk, dv): kernel {_fmt3(kernel)}, plain fp32 "
                f"{_fmt3(f32)}, bound {_fmt3(bounds)} -> {'ok' if ok else 'FAIL'}; control (plain, TF32 matmuls) "
                f"{_fmt3(tf32)} must exceed it -> {'ok' if control else 'FAIL'}")
            if not (ok and control):
                raise SystemExit(f"{name} fp32 {shape}: the fp64 gate failed, or its TF32 control read within it")
            del exact
        del q, k, v, g
        torch.cuda.empty_cache()
    return rows


def fp32_bwd_only(dev) -> int:
    """``--fp32-bwd``: ``fp32_bwd_phase`` alone, after the attention
    libraries' build (ptxas's registers and spills printed) and the rate
    probes; ends with an ``{"fp32_bwd_times": {...}}`` line. Run it in two
    unpacked commits in one call to compare them on one card."""
    import torch

    from ldmae_tpu_torch import kernels

    t0 = time.perf_counter()
    report = kernels.build(["flash_attention", "flash_attention_fp32"])
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    regs = [ln.strip() for ln in report["flash_attention_fp32"]["ptxas"].splitlines()
            if "registers" in ln or "spill" in ln]
    log("  flash_attention_fp32:" + "".join(f"\n    {r}" for r in regs))
    rate_probes(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t1 = time.perf_counter()
    rows = fp32_bwd_phase(dev)
    log(f"[time] the fp32 backward phase {time.perf_counter() - t1:.1f} s")
    log(json.dumps({"fp32_bwd_times": {name: {"ms": r[1], "plain_ms": r[2], "library_ms": r[3], "bound_ms": r[4],
                                              "parts": r[6]} for name, r in rows.items()}}))
    return 0


# the flash leg's d = 16 shapes and #5's launches a step at them (the VMAE
# stage 1 encoder and decoder at batch 128, stage 3's decoder at 16: its
# kernels-line row)
VMAE_D16_SHAPE = [16, 12, 1024, 16]
VMAE_D16_LAUNCHES = {(128, 12, 192, 16): 24, (128, 12, 256, 16): 24, tuple(VMAE_D16_SHAPE): 192}


def redesigned_only(dev) -> int:
    """``--redesigned``: #5 at d = 16 (``vmae_attention_rows`` at the flash
    leg's three shapes, the launches a step of a full run) and #4 in fp32
    (``matmul_silu_f32_row``) alone, after the two libraries' build (the
    ptxas checks of the single pass at d = 16 and the fp32 GEMM) and the
    rate probes; ends with a ``{"redesigned_times": {...}}`` line. Copied
    into an unpacked earlier commit it times that commit's kernels the same
    way where its wrappers take the same arguments."""
    import torch

    from ldmae_tpu_torch import kernels

    t0 = time.perf_counter()
    report = kernels.build(["flash_attention", "flash_attention_fp32", "fused_matmul_silu", "dense"])
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    wgmma_ptxas(report)
    gemm_ptxas(report)
    rate_probes(dev)
    t1 = time.perf_counter()
    rows = vmae_attention_rows(dev, VMAE_D16_LAUNCHES, VMAE_D16_LAUNCHES)
    f32 = matmul_silu_f32_row(dev, 2 * BATCH)
    log(f"[time] the two kernels' rows {time.perf_counter() - t1:.1f} s")
    log(json.dumps({"redesigned_times": {"vmae": rows, "fused_matmul_silu_fp32": f32}}))
    return 0


# The fp32 forward (#1, #2, #7, #8) on the tensor cores as 3xTF32 at d = 64
# and 72 (tf32x3_fwd_kernel behind each wrapper's pre-pass): against the
# plain fp32 forward within F32_FWD at F32_FWD_SHAPES (#1 and #2 with lse
# at B/1's and XL/1's training shapes, the patch-2 archs' N = 256 and a
# ragged N) and at the sampling shape (#1, and #7 and #8 on views of a
# packed qkv); lse (log2 units) within F32_LSE of the plain lse
# (flash_attention_lse_plain; both sum fp32 exponentials in another
# order); the output and lse equal bit for bit between two calls; against
# the fp64 forward at F32_F64_SHAPES, the output within max(F64_SLACK x the
# plain fp32 forward's relative L2 error, F64_FLOOR) and lse (whose
# magnitude is mostly a common offset) within max(F64_SLACK x the plain
# lse's largest error, F64_FLOOR) absolute, which the plain forward with
# TF32 matmuls (one TF32 product) must exceed on both; the kernels that ran
# named by torch.profiler, the SIMT forward absent. At F32_SIMT_FWD_SHAPES
# (head dims the tensor-core kernel does not take) and for an unaligned
# view at d = 64 flash32_fwd_kernel is held the same way (F32_FWD, bit for
# bit, its route with the tensor-core kernel absent)
F32_FWD_SHAPES = ((TRAIN_BATCH, 12, 1024, 64), (TRAIN_BATCH, 16, 1024, 72), (TRAIN_BATCH, 16, 256, 64),
                  (2, 12, 1000, 64))
F32_SIMT_FWD_SHAPES = ((2, 12, 1000, 16), (2, 12, 1000, 128))
F32_LSE = 1e-4
TF32X3_FWD, SIMT_F32_FWD = ("tf32x3_fwd_kernel",), ("flash32_fwd_kernel",)


def fp32_fwd_phase(dev, batch: int, strict: bool = True) -> dict:
    """#1, #2, #7 and #8 in fp32 by the gates above (with ``strict`` False
    the kernels that ran are named but not asserted: an earlier commit's); #1 and #2 with lse at
    (32, 12, 1024, 64) and XL's (32, 16, 1024, 72), #7 and #8 at the
    sampling shape (2 x ``batch``, 12, 1024, 64), timed warm and with the
    device's queue full (by kernel, torch.profiler) beside the plain
    forward and SDPA's fp32 forward (TF32 off, on the rotated or normed q,
    k) and the bound by both routes: 3xTF32 on the tensor cores (the
    kernels line's bound_ms) and the FMA pipes (``fma_bound_ms``). Returns
    the kernels line's rows (``..._fp32``, ``..._fp32_xl`` at d = 72)."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

    gen = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def tables(n, d):
        grid = math.isqrt(n - 1) + 1
        return tuple(torch.from_numpy(to_half_layout(t)[:n]).to(dev) for t in build_rope_table(d // 2, grid))

    def checked(what, run, plain, want, absent, lse_of=None):
        """run() against plain() (F32_FWD; lse against the plain lse of
        lse_of()'s q, k), twice bit for bit, its kernels named."""
        first, again = run(), run()
        out, lse = first if lse_of else (first, None)
        err = f32_compare(what, out, plain())
        if lse is not None:
            lse_err = float((lse - fa.flash_attention_lse_plain(*lse_of())).abs().max())
            ok = lse_err <= F32_LSE
            log(f"  {what}: lse max |err| {lse_err:.3g} (tolerance {F32_LSE:g}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{what}: lse disagrees with the plain lse")
        same = all(torch.equal(x, y) for x, y in zip(first, again)) if lse_of else torch.equal(first, again)
        log(f"  run to run: the output{' and lse' if lse_of else ''} equal bit for bit: {same} -> "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            raise SystemExit(f"{what}: the output differs from run to run")
        del first, again
        if strict:
            return err, train_route(what, run, want, absent)
        split = device_split(run)
        log(f"  {what}: kernels that ran {sorted(split)} (not asserted)")
        return err, {"kernels_ms": split}

    def timed(key, err, parts, run, plain, lib, nbytes, flops, exps):
        ms, queued = cuda_ms(run, 5), queued_ms(run, 10)
        plain_ms = cuda_ms(plain, 2, 1)
        lib_ms, lib_queued = cuda_ms(lib, 5), queued_ms(lib, 10)
        bnd = bound(nbytes, tf32x3_flops=flops, exps=exps)
        fma = bound(nbytes, fp32_flops=flops, exps=exps)[0]
        parts |= {"queued_ms": queued, "library_queued_ms": lib_queued, "fma_bound_ms": fma}
        log(f"  {key}: kernel {ms:.4f} ms (queued {queued:.4f}), parts "
            f"{ {n_: round(v_, 4) for n_, v_ in parts['kernels_ms'].items()} }, plain {plain_ms:.4f} ms, SDPA's fp32 "
            f"forward {lib_ms:.4f} ms (queued {lib_queued:.4f}; kernel / SDPA {ms / lib_ms:.3f}), bound 3xTF32 "
            f"{bnd[0]:.4f} ms ({bnd[1]}; share {bnd[0] / ms:.3f}), FMA pipes {fma:.4f} ms (share {fma / ms:.3f})")
        rows[key] = (err, ms, plain_ms, lib_ms, *bnd, parts)

    rows = {}
    log(f"[fp32] the forward (#1, #2, #7, #8) on the tensor cores as 3xTF32 at {list(F32_FWD_SHAPES)} and the "
        f"sampling shape, on the SIMT kernel at {list(F32_SIMT_FWD_SHAPES)} and an unaligned view")
    for shape in F32_FWD_SHAPES + F32_SIMT_FWD_SHAPES + ("unaligned",):
        unaligned = shape == "unaligned"
        if unaligned:  # contiguous views of a buffer one float past a 16-byte boundary
            shape = (2, 12, 1000, 64)
            q, k, v = randn(3 * math.prod(shape) + 1)[1:].view(3, *shape).unbind(0)
        else:
            q, k, v = (randn(*shape) for _ in range(3))
        b, h, n, d = shape
        cos, sin = tables(n, d)
        tc = d in (64, 72) and not unaligned
        want, absent = (TF32X3_FWD, SIMT_F32_FWD) if tc else (SIMT_F32_FWD, TF32X3_FWD)
        for rope in (True, False):
            name = "flash_attention_rope" if rope else "flash_attention"
            tab = (cos, sin) if rope else ()
            qs, ks = (fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin)) if rope else (q, k)
            fwd = fa._flash_attention_rope_fwd if rope else fa._flash_attention_fwd
            plain = getattr(fa, f"{name}_plain")

            def run(fwd=fwd, tab=tab):
                return fwd(q, k, v, *tab, with_lse=True)

            what = f"{name} fp32 {'unaligned ' if unaligned else ''}{shape}"
            rope_pass = () if not rope else ("norm_rope_any_kernel",) if unaligned else ("norm_rope_kernel",)
            err, parts = checked(what, run, lambda: plain(q, k, v, *tab), want + rope_pass, absent,
                                 lse_of=lambda: (qs, ks))
            if shape in F32_FWD_SHAPES[:2]:
                timed(f"{name}_fp32" + ("_xl" if d == 72 else ""), err, parts, run, lambda: plain(q, k, v, *tab),
                      lambda: F.scaled_dot_product_attention(qs, ks, v), 4 * b * h * n * d * 4 + b * h * n * 4
                      + (2 * n * d * 4 if rope else 0), 4 * b * h * n * n * d, b * h * n * n)
            del qs, ks
        del q, k, v
        torch.cuda.empty_cache()

    # the sampling shape: #1 on contiguous operands, #7 on the attention
    # module's views of a packed qkv (B, N, 3, H, d), #8 on its rows
    b, h, n, d = 2 * batch, 12, 1024, 64
    cos, sin = tables(n, d)
    qkv = randn(b, n, 3, h, d, scale=3.0)
    qv, kv, vv = qkv.permute(2, 0, 3, 1, 4).unbind(0)
    w_q, w_k = (1 + 0.1 * randn(d) for _ in range(2))
    qc, kc, vc = (t.contiguous() for t in (qv, kv, vv))
    qr, kr = fa._rope_fp32(qc, cos, sin), fa._rope_fp32(kc, cos, sin)
    qn, kn = fa._qknorm_rope_fp32(qv, w_q, cos, sin), fa._qknorm_rope_fp32(kv, w_k, cos, sin)
    qf, kf, vf = qkv.unbind(2)
    nbytes, flops, exps = 4 * b * h * n * d * 4 + 2 * n * d * 4, 4 * b * h * n * n * d, b * h * n * n
    rope_pass = ("norm_rope_kernel",)
    cases = (
        ("flash_attention_rope", lambda: fa.flash_attention_rope(qc, kc, vc, cos, sin),
         lambda: fa.flash_attention_rope_plain(qc, kc, vc, cos, sin), lambda: F.scaled_dot_product_attention(qr, kr, vc)),
        ("flash_attention_qknorm_rope", lambda: fa.flash_attention_qknorm_rope(qv, kv, vv, w_q, w_k, cos, sin),
         lambda: fa.flash_attention_qknorm_rope_plain(qv, kv, vv, w_q, w_k, cos, sin),
         lambda: F.scaled_dot_product_attention(qn, kn, vv)),
        ("flash_attention_fused_rope", lambda: fa.flash_attention_fused_rope(qf, kf, vf, cos, sin),
         lambda: fa.flash_attention_fused_rope_plain(qf, kf, vf, cos, sin),
         lambda: F.scaled_dot_product_attention(qr, kr, vc)),
    )
    for name, run, plain, lib in cases:
        err, parts = checked(f"{name} fp32 sampling ({b},{h},{n},{d})", run, plain, TF32X3_FWD + rope_pass,
                             SIMT_F32_FWD)
        if name != "flash_attention_rope":
            timed(f"{name}_fp32", err, parts, run, plain, lib, nbytes, flops, exps)
    del qkv, qv, kv, vv, qc, kc, vc, qr, kr, qn, kn, qf, kf, vf
    torch.cuda.empty_cache()

    for shape in F32_F64_SHAPES:
        q, k, v = (randn(*shape) for _ in range(3))
        exact, exact_lse = fa.flash_attention_plain(*(t.double() for t in (q, k, v))), \
            fa.flash_attention_lse_plain(q.double(), k.double())

        def errs(out, lse):
            return (float((out.double() - exact).norm() / exact.norm()),
                    float((lse.double() - exact_lse).abs().max()))

        def plain_pair():
            return fa.flash_attention_plain(q, k, v), fa.flash_attention_lse_plain(q, k)

        kernel, f32 = errs(*fa._flash_attention_fwd(q, k, v, with_lse=True)), errs(*plain_pair())
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = errs(*plain_pair())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        bounds = [max(F64_SLACK * e, F64_FLOOR) for e in f32]
        ok = all(e <= bd for e, bd in zip(kernel, bounds))
        control = all(e > bd for e, bd in zip(tf32, bounds))
        log(f"  flash_attention fp32 {shape} against fp64 (output relative L2, lse max |err|): kernel "
            f"{_fmt3(kernel)}, plain fp32 {_fmt3(f32)}, bound {_fmt3(bounds)} -> {'ok' if ok else 'FAIL'}; control "
            f"(plain, TF32 matmuls) {_fmt3(tf32)} must exceed it -> {'ok' if control else 'FAIL'}")
        if not (ok and control):
            raise SystemExit(f"flash_attention fp32 {shape}: the fp64 gate failed, or its TF32 control read within it")
        del q, k, v, exact, exact_lse
        torch.cuda.empty_cache()
    return rows


def fp32_fwd_only(dev) -> int:
    """``--fp32-fwd``: ``fp32_fwd_phase`` alone, after the attention
    libraries' build (ptxas's registers and spills printed) and the rate
    probes; ends with an ``{"fp32_fwd_times": {...}}`` line. Run it in two
    unpacked commits in one call to compare them on one card (with
    ``--any-route`` in a commit whose fp32 forward ran other kernels)."""
    import torch

    from ldmae_tpu_torch import kernels

    t0 = time.perf_counter()
    report = kernels.build(["flash_attention", "flash_attention_fp32"])
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    regs = [ln.strip() for ln in report["flash_attention_fp32"]["ptxas"].splitlines()
            if "registers" in ln or "spill" in ln]
    log("  flash_attention_fp32:" + "".join(f"\n    {r}" for r in regs))
    rate_probes(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t1 = time.perf_counter()
    rows = fp32_fwd_phase(dev, BATCH, strict="--any-route" not in sys.argv[1:])
    log(f"[time] the fp32 forward phase {time.perf_counter() - t1:.1f} s")
    log(json.dumps({"fp32_fwd_times": {name: {"ms": r[1], "plain_ms": r[2], "library_ms": r[3], "bound_ms": r[4],
                                              "parts": r[6]} for name, r in rows.items()}}))
    return 0


F32X3_REL = 1e-5  # #4 in fp32 (3xTF32) against the fp64 function: relative L2


def matmul_silu_f64_gate(x, w12, b12) -> dict:
    """#4 in fp32 against the fp64 function on the same operands: fails
    unless within F32X3_REL relative L2, and unless the plain version with
    TF32 matmuls (one TF32 product) reads above that bound."""
    import torch

    from ldmae_tpu_torch.ops import fused_adaln as fad

    acc = x.double() @ w12.double().t() + b12.double()
    x1, x2 = acc.chunk(2, dim=-1)
    exact = x1 * torch.sigmoid(x1) * x2
    del acc, x1, x2

    def rel(out):
        return float((out.double() - exact).norm() / exact.norm())

    kernel, f32 = rel(fad.fused_matmul_silu(x, w12, b12)), rel(fad.fused_matmul_silu_plain(x, w12, b12))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = rel(fad.fused_matmul_silu_plain(x, w12, b12))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ok, control = kernel <= F32X3_REL, tf32 > F32X3_REL
    log(f"  fused_matmul_silu fp32 {tuple(x.shape)} x {tuple(w12.shape)} against fp64 (relative L2): kernel "
        f"{kernel:.3g}, plain fp32 {f32:.3g}, bound {F32X3_REL:g} -> {'ok' if ok else 'FAIL'}; control (plain, TF32 "
        f"matmuls) {tf32:.3g} must exceed it -> {'ok' if control else 'FAIL'}")
    if not (ok and control):
        raise SystemExit("fused_matmul_silu fp32: the fp64 gate failed, or its TF32 control read within it")
    return {"fp64_rel_l2": kernel, "plain_fp64_rel_l2": f32, "tf32_control_rel_l2": tf32}


def matmul_silu_f32_row(dev, b2: int) -> tuple:
    """#4 in fp32 at the B/1 sampling shape (b2 images of 1,024 tokens, the
    CFG-doubled batch): against its plain version (F32_FWD) and the fp64
    function (``matmul_silu_f64_gate``), by route (the split pass and the
    GEMM engine), timed beside ``torch.addmm`` (TF32 off) and its bounds,
    3xTF32 and the FMA pipes; then XL/1's widths, the gates alone. Returns
    the kernels line's row."""
    import torch

    from ldmae_tpu_torch.ops import fused_adaln as fad

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(24)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    d = 768
    m, h2 = b2 * 1024, 4096
    x = randn(m, d)
    w12 = randn(h2, d, scale=d**-0.5)
    b12 = randn(h2, scale=0.1)
    run = lambda: fad.fused_matmul_silu(x, w12, b12)  # noqa: E731
    err = f32_compare("fused_matmul_silu_fp32", run(), fad.fused_matmul_silu_plain(x, w12, b12))
    gate = matmul_silu_f64_gate(x, w12, b12)
    # the split pass, then the GEMM engine (its fp32 configuration: the only one that takes fp32)
    parts = train_route("fused_matmul_silu fp32 (B/1)", run, ("split_tf32_kernel", "gemm_kernel"), ())
    ms, queued = cuda_ms(run, 10), queued_ms(run, 20)
    plain_ms = cuda_ms(lambda: fad.fused_matmul_silu_plain(x, w12, b12), 3, 1)
    lib_ms = cuda_ms(lambda: torch.addmm(b12, x, w12.t()), 5)
    nbytes, flops = (m * d + h2 * d + m * h2 // 2) * 4 + h2 * 4, 2 * m * d * h2
    bnd, fma = bound(nbytes, tf32x3_flops=flops), bound(nbytes, fp32_flops=flops)[0]
    log(f"  fused_matmul_silu_fp32 ({m}, {d}) x ({h2}, {d}): kernel {ms:.4f} ms (queued {queued:.4f}), parts "
        f"{ {n_: round(v_, 4) for n_, v_ in parts['kernels_ms'].items()} }, torch.addmm {lib_ms:.4f} ms (kernel / "
        f"addmm {ms / lib_ms:.3f}), bound 3xTF32 {bnd[0]:.4f} ms ({bnd[1]}; share {bnd[0] / ms:.3f}), FMA pipes "
        f"{fma:.4f} ms (share {fma / ms:.3f})")
    row = (err, ms, plain_ms, lib_ms, *bnd, parts | gate | {"queued_ms": queued, "fma_bound_ms": fma})
    d, h2 = 1152, 6144  # XL/1's widths: the gates alone
    x, w12, b12 = randn(m, d), randn(h2, d, scale=d**-0.5), randn(h2, scale=0.1)
    f32_compare(f"fused_matmul_silu_fp32 XL/1 ({m}, {d}) x ({h2}, {d})", fad.fused_matmul_silu(x, w12, b12),
                fad.fused_matmul_silu_plain(x, w12, b12))
    matmul_silu_f64_gate(x, w12, b12)
    del x, w12
    torch.cuda.empty_cache()
    return row


def fp32_kernel_phase(dev, batch: int) -> dict:
    """Every kernel's fp32 instantiation against its plain fp32 version
    (TF32 off) and timed beside it and a library call: #1, #2, #7 and #8
    by ``fp32_fwd_phase``, #5 and #6 by ``fp32_bwd_phase``, #3, #4, #9
    and #10 at the B/1 sampling shapes at ``batch`` (CFG-doubled). Returns
    name -> row of the kernels line."""
    import torch

    from ldmae_tpu_torch.ops import fused_adaln as fad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(23)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    rows = fp32_fwd_phase(dev, batch)
    rows |= fp32_bwd_phase(dev)
    b2 = 2 * batch

    log(f"[fp32] adaLN and SwiGLU kernels at the B/1 sampling shapes (batch {batch}, CFG-doubled) fp32")
    rows |= adaln_row_kernels(dev, b2, f"fp32 (batch {batch})", torch.float32)
    rows["fused_norm_modulate_bwd_fp32"] = fnm_bwd_row(dev, "fp32 (B/1 training shape)", TRAIN_BATCH, 1024, 768, 22,
                                                       torch.float32)
    rows["fused_matmul_silu_fp32"] = matmul_silu_f32_row(dev, b2)
    m, h2 = b2 * 1024, 4096
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


# -- the extraction and evaluation slice -------------------------------------
# extraction: EXTRACT_IMAGES seeded PNGs at --batch EXTRACT_BATCH (doubled by
# the flips), the CLI's xla attention; the tokenizer evaluation of
# EVAL_IMAGES of them at batch EVAL_BATCH; two seeded npz sets of NPZ_IMAGES
EXTRACT_IMAGES, EXTRACT_BATCH, EVAL_IMAGES, EVAL_BATCH, NPZ_IMAGES, INCEPTION_BATCH = 256, 64, 64, 32, 128, 64
# dense per VMAE f8d16 encode (patch embedding, 4 linears a block, to_latent)
# and decode (from_latent, decoder_embed, 4 a block, the pred head)
_DENSE_ENCODE = 2 + 4 * DEPTH
EXPECTED_LAUNCHES |= {
    "extract": _NONE | {"dense_bias_f32": EXTRACT_IMAGES // EXTRACT_BATCH * _DENSE_ENCODE},
    "encode_flash": _NONE | {"flash_attention_resident": DEPTH, "dense_bias_f32": _DENSE_ENCODE},
    "tokenizer_eval": _NONE | {"dense_bias_f32": EVAL_IMAGES // EVAL_BATCH * (_DENSE_ENCODE + _DENSE_DECODE)},
}
# the encoder's linears at a doubled batch of 64 (M = 128 x 1,024 tokens):
# the patch embedding (K = 8 x 8 x 3) and proj share one shape; qkv, fc1, fc2
ENCODER_DENSE_SHAPES = (("patch_embed+proj", 131072, 192, 192), ("qkv", 131072, 192, 576),
                        ("fc1", 131072, 192, 768), ("fc2", 131072, 768, 192))


@contextlib.contextmanager
def launches_by_shape(module, fn_name: str, counter: str, key):
    """Tallies the launches counted on ``module.<counter>.launches`` while
    active by ``key(*positional args)`` of each call of ``module.<fn_name>``.
    A stand-in under that module name sees every call made through it.
    Where the function counts on itself (``fn_name == counter``), the
    wrapper adds one to the count of whatever that name holds where it
    launches, so the stand-in carries the count meanwhile and hands it back
    to the wrapper at the end."""
    real, tally = getattr(module, fn_name), collections.Counter()

    def counted(*args, **kw):
        before = getattr(module, counter).launches
        out = real(*args, **kw)
        tally[key(*args)] += getattr(module, counter).launches - before
        return out

    counted.launches = 0
    setattr(module, fn_name, counted)
    try:
        yield tally
    finally:
        setattr(module, fn_name, real)
        if fn_name == counter:
            real.launches += counted.launches


def dense_launches_by_shape():
    """``dense_bias_f32``'s launches by (M, K, N) while active (``dense``
    calls the wrapper through its module's global name)."""
    from ldmae_tpu_torch.ops import linear

    return launches_by_shape(linear, "dense_bias_f32", "dense_bias_f32",
                             lambda x, weight, bias: (x.shape[0], x.shape[1], weight.shape[0]))


@contextlib.contextmanager
def tf32_convs(module):
    """``module``'s float32 convolutions with TF32 allowed (the control of the
    TF32-off checks)."""
    import torch
    import torch.nn.functional as F

    saved = module.conv2d_fp32

    def conv(x, w, bias=None, **kw):
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            return F.conv2d(x.float(), w.float(), None if bias is None else bias.float(), **kw)

    module.conv2d_fp32 = conv
    try:
        yield
    finally:
        module.conv2d_fp32 = saved


def write_image_folder(root: str, n: int, seed: int) -> None:
    """n seeded RGB PNGs of 300 x 280 (the ADM crop resizes them to 274 x
    256 and crops) in two class folders; smooth gradients plus noise, so
    neighbouring pixels correlate as in photographs."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:280, 0:300].astype(np.float32)
    for i in range(n):
        d = os.path.join(root, f"class{i * 2 // n}")
        os.makedirs(d, exist_ok=True)
        f = rng.uniform(0.005, 0.05, (3, 2))
        base = 127 + 100 * np.sin(f[:, :1, None] * yy + f[:, 1:, None] * xx + rng.uniform(0, 6, (3, 1, 1)))
        img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8).transpose(1, 2, 0)
        Image.fromarray(img).save(os.path.join(d, f"{i:04d}.png"), compress_level=1)


def extraction_phase(dev, smi: str, tmp: str, origin: str) -> tuple:
    """``cli.extract_features.main`` on EXTRACT_IMAGES PNGs at --batch
    EXTRACT_BATCH with the shipped YAML's data section (data.sample: the raw
    32-channel moments), seeded VMAE weights, exact launch counts; the shards
    read back (count, labels in order, each image's latents and its flip's
    against a re-encode: the same batch, and encode(flip(x)) apart) and the
    statistics file against its recomputation; the call's images/s and peak
    memory, and the encode's alone. Returns ({"extract": counts}, dense's
    launches in the call by (M, K, N))."""
    import numpy as np
    import torch
    import yaml

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.cli import extract_features
    from ldmae_tpu_torch.data.images import ImageFolderDataset
    from ldmae_tpu_torch.data.latent_dataset import ImgLatentDataset, _load_stats, read_safetensors
    from ldmae_tpu_torch.models.tokenizers import build_tokenizer_fns

    cfg = _yaml_config(data={"origin_path": origin, "data_path": os.path.join(tmp, "latents"), "image_size": 256,
                             "num_classes": 1000, "latent_norm": True, "latent_multiplier": 1.0, "sample": True})
    cfg["vae"]["weight_path"] = ""
    path = os.path.join(tmp, "extract.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    log(f"[extract] cli.extract_features: {EXTRACT_IMAGES} PNGs (300x280, ADM crop to 256), --batch {EXTRACT_BATCH} "
        f"(flip-doubled to {2 * EXTRACT_BATCH}), VMAE f8d16_prev with seeded weights, bf16, the CLI's xla attention, "
        f"data.sample true (raw moments)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with dense_launches_by_shape() as dense_shapes:
        t0 = time.perf_counter()
        out = extract_features.main(["--config", path, "--batch", str(EXTRACT_BATCH)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts("extract", counts)
    log(f"  dense launches by (M, K, N): {dict(dense_shapes)}")
    if sum(dense_shapes.values()) != counts["dense_bias_f32"]:
        raise SystemExit(f"extract: dense's launches by shape {dict(dense_shapes)} do not add up to its count")

    names = sorted(os.listdir(out))
    shard = read_safetensors(os.path.join(out, names[0]))
    lat, flip, labels = (torch.from_numpy(np.array(shard[k])) for k in ("latents", "latents_flip", "labels"))
    ok = (names == ["latents_rank00_shard000.safetensors", "latents_stats.pt"] and lat.shape == (EXTRACT_IMAGES, 32, 32, 32)
          and flip.shape == lat.shape and labels.tolist() == [0] * (EXTRACT_IMAGES // 2) + [1] * (EXTRACT_IMAGES // 2)
          and bool(torch.isfinite(lat).all() and torch.isfinite(flip).all()))
    # the first batch again through the same encode (same weights, shapes)
    tok = build_tokenizer_fns("vmae_f8d16", "", 256, dev, 1)
    ds = ImageFolderDataset(origin, 256)
    u8 = np.stack([ds.get(i, raw_uint8=True)[0] for i in range(EXTRACT_BATCH)])
    x = torch.from_numpy(u8).to(dev)
    re, re_f = (t.cpu() for t in extract_features.encode_batch(tok, x, True))
    scale = float(lat.abs().max())
    self_err = float((lat[:EXTRACT_BATCH] - re).abs().max()) / scale
    flip_err = float((flip[:EXTRACT_BATCH] - re_f).abs().max()) / scale
    other_err = min(float((lat[i] - re[i + 1]).abs().max()) for i in range(EXTRACT_BATCH - 1)) / scale
    # encode(flip(x)): the flipped crops as the unflipped half of a batch
    ff, _ = extract_features.encode_batch(tok, torch.from_numpy(np.ascontiguousarray(u8[:, :, ::-1])).to(dev), True)
    flip_direct = float((flip[:EXTRACT_BATCH] - ff.cpu()).abs().max()) / scale
    stats = _load_stats(os.path.join(out, "latents_stats.pt"))
    again = ImgLatentDataset(out, latent_norm=False, sample=True).compute_latent_stats()
    stats_ok = all(stats[k].shape == (1, 16, 1, 1) and np.array_equal(stats[k], again[k]) for k in ("mean", "std"))
    # the same weights on the same batch at the same shapes: the same bits
    ok = ok and self_err == 0 and flip_err == 0 and flip_direct == 0 and other_err > 0 and stats_ok
    log(f"  shards {names}; latents {tuple(lat.shape)}, labels in order; the first batch re-encoded: latents max rel "
        f"err {self_err:.3g}, flips {flip_err:.3g} (must be 0), nearest other image {other_err:.3g}; flips vs "
        f"encode(flip(x)) {flip_direct:.3g} (must be 0); latents_stats.pt (mean, std (1, 16, 1, 1) of sampled "
        f"moments) equal to their recomputation: {stats_ok} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("extraction: the shards or the statistics are wrong")

    # the encode alone at the CLI's batch (device time, steady)
    ms = cuda_ms(lambda: extract_features.encode_batch(tok, x, True), 3, 1)
    log(f"  extraction: {EXTRACT_IMAGES / seconds:.2f} images/s for the whole CLI call ({seconds:.2f} s: model build, "
        f"PNG decode and crop, encode, shard and statistics writes); the encode of a batch of {EXTRACT_BATCH} "
        f"(flip-doubled) {ms:.2f} ms = {EXTRACT_BATCH / ms * 1e3:.1f} images/s; peak memory {peak:.3f} GB "
        f"(xla attention's fp32 logits of ({2 * EXTRACT_BATCH},12,1024,1024)); on {smi}")
    del tok, x
    torch.cuda.empty_cache()
    return {"extract": counts}, dense_shapes


def encoder_kernel_phase(dev, origin: str, dense_shapes: dict) -> list:
    """The encoder at a doubled batch of EXTRACT_BATCH under ``flash`` (#2's
    resident kernel, exact counts) against ``xla``; #2 at its shape
    (2 x EXTRACT_BATCH, 12, 1024, 16) against its plain version, timed beside
    it and SDPA, with its bound; ``dense`` at the encoder's linear shapes
    (K = 192 and 768) within half a bf16 ulp of fp64 math, timed beside
    cuBLAS's bf16 F.linear, each with its launches in the extraction run
    (``dense_shapes``, by (M, K, N)). Returns the encoder line's rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.data.images import ImageFolderDataset, normalize_uint8_images
    from ldmae_tpu_torch.models import load_production_vmae
    from ldmae_tpu_torch.ops import dense
    from ldmae_tpu_torch.ops import flash_attention as fa

    vae = load_production_vmae("", 256, dev, 1)
    ds = ImageFolderDataset(origin, 256)
    u8 = torch.from_numpy(np.stack([ds.get(i, raw_uint8=True)[0] for i in range(EXTRACT_BATCH)])).to(dev)
    imgs = normalize_uint8_images(u8)
    both = torch.cat([imgs, imgs.flip(-1)])
    log(f"[encoder] VMAE encode of a doubled batch of {EXTRACT_BATCH} in bf16: flash (#2 resident) vs xla")
    ops.reset_launch_counts()
    m_flash = vae.ldmae_encode_moments(both, torch.bfloat16, "flash")
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check_counts("encode_flash", counts)
    m_xla = vae.ldmae_encode_moments(both, torch.bfloat16, "xla")
    rel = float((m_flash - m_xla).abs().max() / m_xla.abs().max())
    ms_flash = cuda_ms(lambda: vae.ldmae_encode_moments(both, torch.bfloat16, "flash"), 3, 1)
    ms_xla = cuda_ms(lambda: vae.ldmae_encode_moments(both, torch.bfloat16, "xla"), 3, 1)
    ok = rel <= 5e-2 and bool(torch.isfinite(m_flash).all())
    log(f"  moments max rel err {rel:.4g} (tolerance 5e-2); encode {ms_flash:.2f} ms under flash, {ms_xla:.2f} ms "
        f"under xla -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("VMAE encode: flash disagrees with xla")
    del vae, m_flash, m_xla, both, imgs
    torch.cuda.empty_cache()

    rows = []
    g = torch.Generator(device=dev).manual_seed(41)
    b, h, n, d = 2 * EXTRACT_BATCH, 12, 1024, 16
    log(f"[encoder] flash_attention_resident at the encoder's shape ({b},{h},{n},{d}) bf16")
    q, k, v = (torch.randn(b, h, n, d, generator=g, device=dev).bfloat16() for _ in range(3))
    ref = fa.flash_attention_plain(q, k, v)
    err = compare("flash_attention_resident (encoder)", fa.flash_attention(q, k, v), ref, **attn_tol(ref))
    del ref
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v), 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 2, 1)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), 20)
    bnd = bound(4 * b * h * n * d * 2, 4 * b * h * n * n * d, exps=b * h * n * n)
    log(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (SDPA / kernel {lib_ms / ms:.3f}); "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}), share {bnd[0] / ms:.3f}")
    rows.append({"name": "flash_attention_resident", "route": "cuda", "source": _FA,
                 "replaces": KERNELS["flash_attention_resident"][1], "shape": [b, h, n, d], "launches": counts[
        "flash_attention_resident"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
        "bound_by": bnd[1], "library_ms": lib_ms})
    del q, k, v
    torch.cuda.empty_cache()

    log("[encoder] dense (the GEMM engine's bf16 kernel, fp32 bias) at the encoder's linears, M = 131,072 tokens, "
        "vs fp64 (ulps) and cuBLAS's bf16 F.linear")
    for name, m, kk, nn in ENCODER_DENSE_SHAPES:
        x = torch.randn(m, kk, generator=g, device=dev).bfloat16()
        w = (torch.randn(nn, kk, generator=g, device=dev) * kk**-0.5).bfloat16()
        bias = torch.randn(nn, generator=g, device=dev)
        ulp = dense_ulp_error(dense(x, w, bias), x, w, bias)
        plain = F.linear(x.float(), w.float(), bias).bfloat16()
        err = float((dense(x, w, bias).float() - plain.float()).abs().max())
        bb = bias.bfloat16()
        t = linear_timings(lambda: dense(x, w, bias), lambda: F.linear(x, w, bb))
        plain_ms = cuda_ms(lambda: F.linear(x.float(), w.float(), bias).bfloat16(), 5)
        bnd = bound(2 * (m * kk + nn * kk + m * nn) + 4 * nn, 2 * m * kk * nn)
        ok = ulp <= 0.5
        log(f"  {name} ({m}x{kk} -> {nn}): max error {ulp:.4f} ulp (bound 0.5) -> {'ok' if ok else 'FAIL'}; dense warm "
            f"{t['ms']:.4f} ms, queued {t['queued_ms']:.4f}, cold {t['cold_ms']:.4f}; F.linear warm "
            f"{t['library_ms']:.4f}, queued {t['library_queued_ms']:.4f}; queued dense / F.linear "
            f"{t['queued_ms'] / t['library_queued_ms']:.3f}; plain {plain_ms:.4f} ms; bound {bnd[0]:.4f} ms "
            f"({bnd[1]}), share {bnd[0] / t['queued_ms']:.3f} (queued)")
        if not ok:
            raise SystemExit(f"dense ({name}): not one rounding after the fp32 bias")
        launches = dense_shapes.get((m, kk, nn), 0)
        if not launches:
            raise SystemExit(f"dense ({name}): no launch at {(m, kk, nn)} in the extraction run")
        rows.append({"name": f"dense {name}", "route": "cuda", "source": _DENSE, "replaces": KERNELS["dense"][1],
                     "shape": [m, kk, nn], "launches": launches, "max_abs_err": err, "ms": t["ms"],
                     "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": t["library_ms"],
                     "queued_ms": t["queued_ms"], "cold_ms": t["cold_ms"], "library_queued_ms": t["library_queued_ms"],
                     "max_ulp": ulp})
        del x, w, plain
    torch.cuda.empty_cache()
    return rows


def tokenizer_eval_phase(dev, smi: str, tmp: str, origin: str) -> dict:
    """``cli.evaluate_tokenizer.main`` on the first EVAL_IMAGES PNGs at
    --batch EVAL_BATCH (seeded VMAE, seeded random LPIPS and Inception
    weights): exact launch counts, finite rFID, PSNR, LPIPS and SSIM, the
    PNG folders; LPIPS(x, x) = 0 and SSIM(x, x) = 1 on the card; LPIPS on
    the card against its CPU path (with a TF32 control); the roundtrip's
    images/s at its batch. Returns {"tokenizer_eval": counts}."""
    import numpy as np
    import torch
    import yaml

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.cli import evaluate_tokenizer
    from ldmae_tpu_torch.data.images import ImageFolderDataset, normalize_uint8_images
    from ldmae_tpu_torch.eval.metrics import ssim
    from ldmae_tpu_torch.models import lpips as tlpips
    from ldmae_tpu_torch.models.lpips import load_lpips
    from ldmae_tpu_torch.models.tokenizers import build_tokenizer_fns

    cfg = _yaml_config(data={"image_size": 256, "num_classes": 1000})
    cfg["vae"]["weight_path"] = ""
    path = os.path.join(tmp, "eval.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = os.path.join(tmp, "rfid")
    log(f"[tokenizer] cli.evaluate_tokenizer: {EVAL_IMAGES} PNGs, --batch {EVAL_BATCH}, epsilon 0, seeded VMAE, "
        f"random LPIPS and Inception weights (no weight files in the repository)")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    (report,) = evaluate_tokenizer.main(["--config", path, "--data_path", origin, "--output_path", out,
                                         "--batch", str(EVAL_BATCH), "--limit", str(EVAL_IMAGES)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_counts("tokenizer_eval", counts)
    pngs = [len(os.listdir(os.path.join(out, d))) for d in ("reference", "vmae_f8d16_0.0")]
    ok = all(math.isfinite(report[k]) for k in ("rfid", "psnr", "lpips", "ssim")) and pngs == [EVAL_IMAGES] * 2
    # the metrics' identities on the card
    ds = ImageFolderDataset(origin, 256)
    u8 = torch.from_numpy(np.stack([ds.get(i, raw_uint8=True)[0] for i in range(EVAL_BATCH)])).to(dev)
    x = normalize_uint8_images(u8)
    lp = load_lpips(dev)
    same_lpips = float(lp(x, x).abs().max())
    same_ssim = float((ssim(x, x, data_range=(-1.0, 1.0), per_image=True) - 1).abs().max())
    # LPIPS on the card against its CPU path (4 images and their
    # reconstructions): the VGG features within relative L2 1e-5, TF32 off;
    # TF32 convolutions must read above
    cpu_lp = load_lpips("cpu")
    tok = build_tokenizer_fns("vmae_f8d16", "", 256, dev, 1)
    rec = normalize_uint8_images(evaluate_tokenizer.roundtrip(tok, lp, u8[:4])[0])
    ref_f, ref_d = cpu_lp.net(x[:4].cpu()), cpu_lp(x[:4].cpu(), rec.cpu())

    def lp_errs():
        with torch.no_grad():
            feats = lp.net(x[:4])
        feat = max(float((f.cpu() - r).norm() / r.norm()) for f, r in zip(feats, ref_f))
        return feat, float((lp(x[:4], rec).cpu() - ref_d).abs().max() / ref_d.abs().max())

    off = lp_errs()
    with tf32_convs(tlpips):
        on = lp_errs()
    ok = (ok and same_lpips == 0.0 and same_ssim <= 1e-6 and max(off) <= 1e-5 and on[0] > 1e-5)
    log(f"  {report}; PNGs {pngs}; LPIPS(x, x) max {same_lpips:g} (must be 0), |SSIM(x, x) - 1| max {same_ssim:.3g} "
        f"(tolerance 1e-6); LPIPS on the card vs its CPU path: VGG features rel L2 {off[0]:.3g}, distances "
        f"{off[1]:.3g} of their largest (tolerance 1e-5, TF32 off), with TF32 convolutions {on[0]:.3g} (must "
        f"exceed it), {on[1]:.3g} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("tokenizer evaluation: a metric is not finite, an identity fails, or LPIPS disagrees")
    del cpu_lp
    ms = cuda_ms(lambda: evaluate_tokenizer.roundtrip(tok, lp, u8), 3, 1)
    log(f"  tokenizer evaluation: the roundtrip (encode, decode, LPIPS, SSIM) of a batch of {EVAL_BATCH} {ms:.2f} ms "
        f"= {EVAL_BATCH / ms * 1e3:.1f} images/s; the whole CLI call {seconds:.2f} s for {EVAL_IMAGES} images "
        f"(model builds, PNG decode and writes, rFID's Inception and sqrtm on the host); on {smi}")
    del tok, lp
    torch.cuda.empty_cache()
    return {"tokenizer_eval": counts}


# -- the tokenizer-family slice (SD-VAE, VA-VAE, MAR-VAE) --------------------
# the three conv VAEs at full size (256^2, ch 128, seeded weights) on
# CONV_BATCH of the seeded PNGs, the card against the CPU on CONV_CPU of them
# (float32 on both, TF32 off: summation order only; max |err| / max |value|)
CONV_TOKENIZERS = (("sdv3", "SD-VAE f8d16"), ("vavae", "VA-VAE f16d32"), ("marvae", "MAR-VAE f16d16"))
CONV_BATCH, CONV_CPU, CONV_TOL = 8, 1, 1e-4
_bf16 = EXPECTED_LAUNCHES["bf16"]
EXPECTED_LAUNCHES |= {
    # the same DiT as the bf16 VMAE pipeline, the float32 SD-VAE decode (no
    # port kernel) in place of the VMAE's (#2 and dense)
    "sdvae_pipeline": _NONE | {k: _bf16[k] for k in ("flash_attention_rope", "fused_norm_modulate",
                                                     "fused_matmul_silu")}
                            | {"dense_bias_f32": _bf16["dense_bias_f32"] - _DENSE_DECODE},
    "conv_tokenizer": _NONE,
    "extract_sdvae": _NONE,
    "tokenizer_eval_vavae": _NONE,
}


@contextlib.contextmanager
def counted_convs():
    """While active: the FLOPs of every ``F.conv2d`` (2 x output elements x
    C_in k k / groups) and ``torch.bmm`` call, the convolutions' count and
    how many ran with cuDNN's TF32 allowed. Yields that tally."""
    import torch
    import torch.nn.functional as F

    tally = {"flops": 0, "convs": 0, "tf32": 0}
    conv, bmm = F.conv2d, torch.bmm

    def conv2d(x, w, *args, **kw):
        out = conv(x, w, *args, **kw)
        tally["flops"] += 2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        tally["convs"] += 1
        tally["tf32"] += bool(torch.backends.cudnn.allow_tf32)
        return out

    def bmm_(a, b):
        tally["flops"] += 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
        return bmm(a, b)

    F.conv2d, torch.bmm = conv2d, bmm_
    try:
        yield tally
    finally:
        F.conv2d, torch.bmm = conv, bmm


def _seeded_crops(dev, origin: str, n: int):
    """The first n seeded PNGs, ADM-cropped to 256, as (n, 3, 256, 256) in [-1, 1]."""
    import numpy as np
    import torch

    from ldmae_tpu_torch.data.images import ImageFolderDataset, normalize_uint8_images

    ds = ImageFolderDataset(origin, 256)
    return normalize_uint8_images(torch.from_numpy(np.stack([ds.get(i, raw_uint8=True)[0] for i in range(n)])).to(dev))


def conv_tokenizer_phase(dev, smi: str, origin: str) -> dict:
    """Each conv tokenizer through ``build_tokenizer_fns`` at full size with
    seeded weights: ``encode_moments`` and ``decode`` of CONV_BATCH images
    on the card against the same module's float32 run on the CPU (CONV_CPU
    images, within CONV_TOL of the largest |value|; the encode with TF32
    convolutions must read above it), no convolution with TF32 allowed, no
    port kernel launched; ms a batch, images/s, TFLOP/s (the convolutions'
    and the attention's FLOPs as counted in the run) and peak memory.
    Returns {"conv_tokenizer": counts} and the readings."""
    import torch

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.models import conv_vae as cv
    from ldmae_tpu_torch.models.tokenizers import build_tokenizer_fns

    x = _seeded_crops(dev, origin, CONV_BATCH)
    readings = []
    for name, label in CONV_TOKENIZERS:
        tok = build_tokenizer_fns(name, "", 256, dev, 1)
        model, lat = tok.model, tok.latent_dim
        ops.reset_launch_counts()
        with counted_convs() as enc:
            moments = tok.encode_moments(model, x)
        z = moments[:, :lat].contiguous()
        with counted_convs() as dec:
            imgs = tok.decode(model, z)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_counts("conv_tokenizer", counts)
        torch.cuda.reset_peak_memory_stats()
        enc_ms = cuda_ms(lambda: tok.encode_moments(model, x), 3, 1)
        dec_ms = cuda_ms(lambda: tok.decode(model, z), 3, 1)
        peak = torch.cuda.max_memory_allocated() / 1e9
        # where the device time of an encode and a decode goes, by kernel
        events = sorted(_profiled(lambda: tok.decode(model, tok.encode_moments(model, x)[:, :lat]), 1),
                        key=lambda e: -e[1])
        busy = sum(ms for _, ms in events)
        log(f"[tokenizers] {name}: encode + decode device time {busy:.2f} ms by kernel (top 6): " + "; ".join(
            f"{ms:.2f} ms {k[:70]}" for k, ms in events[:6]))
        cpu = cv.ConvVAE(model.spec, device="cpu")
        cpu.load_state_dict(model.state_dict())
        t0 = time.perf_counter()
        ref_m = cpu.encode_moments(x[:CONV_CPU].cpu())
        ref_d = cpu.decode(z[:CONV_CPU].cpu())
        cpu_s = time.perf_counter() - t0

        def err(out, ref):
            return float((out[:CONV_CPU].cpu() - ref).abs().max() / ref.abs().max())

        err_m, err_d = err(moments, ref_m), err(imgs, ref_d)
        with tf32_convs(cv):
            err_tf32 = err(tok.encode_moments(model, x[:CONV_CPU]), ref_m)
        ok = (err_m <= CONV_TOL and err_d <= CONV_TOL and err_tf32 > CONV_TOL and enc["convs"] > 0
              and enc["tf32"] == 0 and dec["tf32"] == 0 and tuple(moments.shape) == (CONV_BATCH, 2 * lat) + (
                  256 // (2 ** (len(model.spec.ch_mult) - 1)),) * 2
              and tuple(imgs.shape) == (CONV_BATCH, 3, 256, 256) and bool(torch.isfinite(imgs).all()))
        r = {"tokenizer": name, "encode_ms": enc_ms, "decode_ms": dec_ms, "peak_gb": peak,
             "encode_gflop_per_image": enc["flops"] / CONV_BATCH / 1e9,
             "decode_gflop_per_image": dec["flops"] / CONV_BATCH / 1e9,
             "encode_tflops": enc["flops"] / enc_ms / 1e9, "decode_tflops": dec["flops"] / dec_ms / 1e9,
             "err_moments": err_m, "err_decode": err_d, "err_tf32_control": err_tf32}
        readings.append(r)
        log(f"[tokenizers] {name} ({label}, seeded weights, float32): encode {enc_ms:.2f} ms a batch of {CONV_BATCH} "
            f"({CONV_BATCH / enc_ms * 1e3:.1f} images/s, {r['encode_gflop_per_image']:.1f} GFLOP an image, "
            f"{r['encode_tflops']:.2f} TFLOP/s), decode {dec_ms:.2f} ms ({CONV_BATCH / dec_ms * 1e3:.1f} images/s, "
            f"{r['decode_gflop_per_image']:.1f} GFLOP an image, {r['decode_tflops']:.2f} TFLOP/s), peak memory "
            f"{peak:.3f} GB; {enc['convs']} + {dec['convs']} convolutions, {enc['tf32'] + dec['tf32']} with TF32 "
            f"allowed (must be 0); card vs CPU ({CONV_CPU} images, {cpu_s:.1f} s on the host): moments "
            f"{err_m:.3g}, images {err_d:.3g} of the largest |value| (tolerance {CONV_TOL}), the encode with TF32 "
            f"convolutions {err_tf32:.3g} (must exceed it); on {smi} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"conv tokenizer {name}: the card disagrees with the CPU, a TF32 convolution ran, "
                             "or a shape is wrong")
        del tok, model, cpu, moments, imgs, z
        torch.cuda.empty_cache()
    log(json.dumps({"conv_tokenizers": readings}))
    return {"conv_tokenizer": counts}


def sdvae_pipeline_phase(dev, smi: str) -> dict:
    """The sampling CLI's ``build_pipeline`` on the shipped YAML with
    ``vae.model_name: sdv3`` (LightningDiT-B/1 at full width and depth with
    seeded weights, bf16, 250 steps, CFG 10, the seeded SD-VAE): a batch of 8
    with the launches of #1, #3, #4 and dense counted exactly (the bf16 VMAE
    pipeline's DiT counts), uint8 (8, 256, 256, 3) out, equal to the SD-VAE's
    decode of the same run's latents; seconds a batch. Returns
    {"sdvae_pipeline": counts}."""
    import torch

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.cli import inference
    from ldmae_tpu_torch.core.config import LDMAEConfig

    cfg = LDMAEConfig.from_dict(_yaml_config(vae={"model_name": "sdv3", "downsample_ratio": 8, "weight_path": ""}))
    sample_fn, bundle, spec = inference.build_pipeline(cfg, device=dev)
    y = torch.arange(BATCH, device=dev) * 125 % 1000
    log(f"[sdvae pipeline] cli.inference.build_pipeline, vae.model_name sdv3: LightningDiT-B/1 + SD-VAE f8d16 "
        f"(seeded), batch {BATCH}, {cfg.sample.num_sampling_steps} Euler steps, CFG {cfg.sample.cfg_scale}, "
        f"attention {cfg.parallel.attention_impl}, bf16 DiT, float32 decode")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    imgs = sample_fn(bundle, y, generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts("sdvae_pipeline", counts)
    lat = sample_fn(dict(bundle, vae=None), y, generator=torch.Generator(device=dev).manual_seed(0))
    again = bundle["vae"].decode_to_images(lat)
    spread = float(imgs.float().std())
    ok = (tuple(imgs.shape) == (BATCH, 256, 256, 3) and imgs.dtype == torch.uint8 and torch.equal(imgs, again)
          and tuple(lat.shape) == (BATCH, 16, 32, 32) and spread > 0)
    log(f"  images {tuple(imgs.shape)} {imgs.dtype}, pixel std {spread:.3f}, equal to the SD-VAE decode of the "
        f"run's latents: {torch.equal(imgs, again)}; {seconds:.4f} s per batch of {BATCH} ({BATCH / seconds:.4f} "
        f"images/s), peak memory {peak:.3f} GB; on {smi} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("SD-VAE pipeline: wrong images, or they are not the SD-VAE's decode of the latents")
    del bundle, sample_fn
    torch.cuda.empty_cache()
    return {"sdvae_pipeline": counts}


def extraction_sdvae_phase(dev, smi: str, tmp: str, origin: str) -> dict:
    """``cli.extract_features`` with ``vae.model_name: sdv3`` on the
    EXTRACT_IMAGES PNGs at --batch EXTRACT_BATCH (flip-doubled; float32,
    seeded SD-VAE): no port kernel, no TF32 convolution, the shard's raw
    moments (N, 32, 32, 32) finite, labels in order, the statistics (1, 16,
    1, 1); images/s and peak memory. Returns {"extract_sdvae": counts}."""
    import numpy as np
    import torch
    import yaml

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.cli import extract_features
    from ldmae_tpu_torch.data.latent_dataset import _load_stats, read_safetensors

    cfg = _yaml_config(data={"origin_path": origin, "data_path": os.path.join(tmp, "latents_sdvae"), "image_size": 256,
                             "num_classes": 1000, "latent_norm": True, "latent_multiplier": 1.0, "sample": True},
                       vae={"model_name": "sdv3", "downsample_ratio": 8, "weight_path": ""})
    path = os.path.join(tmp, "extract_sdvae.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    log(f"[extract sdvae] cli.extract_features, vae.model_name sdv3: {EXTRACT_IMAGES} PNGs, --batch {EXTRACT_BATCH} "
        f"(flip-doubled to {2 * EXTRACT_BATCH}), seeded SD-VAE, float32")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with counted_convs() as tally:
        t0 = time.perf_counter()
        out = extract_features.main(["--config", path, "--batch", str(EXTRACT_BATCH)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts("extract_sdvae", counts)
    shard = read_safetensors(os.path.join(out, "latents_rank00_shard000.safetensors"))
    lat, flip = (np.array(shard[k]) for k in ("latents", "latents_flip"))
    stats = _load_stats(os.path.join(out, "latents_stats.pt"))
    ok = (lat.shape == flip.shape == (EXTRACT_IMAGES, 32, 32, 32) and np.isfinite(lat).all() and np.isfinite(flip).all()
          and np.array(shard["labels"]).tolist() == [0] * (EXTRACT_IMAGES // 2) + [1] * (EXTRACT_IMAGES // 2)
          and stats["mean"].shape == (1, 16, 1, 1) and tally["convs"] > 0 and tally["tf32"] == 0
          and not np.array_equal(lat, flip))
    log(f"  {EXTRACT_IMAGES / seconds:.2f} images/s for the whole CLI call ({seconds:.2f} s), {tally['flops'] / 1e12:.1f} "
        f"TFLOP of convolutions and attention ({tally['flops'] / 1e12 / seconds:.2f} TFLOP/s over the call), "
        f"{tally['convs']} convolutions, {tally['tf32']} with TF32 allowed; shard {lat.shape}, statistics "
        f"{stats['mean'].shape}; peak memory {peak:.3f} GB; on {smi} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("SD-VAE extraction: wrong shards or statistics, or a TF32 convolution")
    torch.cuda.empty_cache()
    return {"extract_sdvae": counts}


def tokenizer_eval_vavae_phase(dev, smi: str, tmp: str, origin: str) -> dict:
    """``cli.evaluate_tokenizer`` with ``vae.model_name: vavae`` on the first
    EVAL_IMAGES PNGs at --batch EVAL_BATCH (seeded VA-VAE, LPIPS and
    Inception): no port kernel, no TF32 convolution, finite rFID, PSNR,
    LPIPS and SSIM, the PNG folders; the roundtrip's images/s at its batch
    and the call's peak memory. Returns {"tokenizer_eval_vavae": counts}."""
    import numpy as np
    import torch
    import yaml

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.cli import evaluate_tokenizer
    from ldmae_tpu_torch.data.images import ImageFolderDataset
    from ldmae_tpu_torch.models.lpips import load_lpips
    from ldmae_tpu_torch.models.tokenizers import build_tokenizer_fns

    cfg = _yaml_config(data={"image_size": 256, "num_classes": 1000},
                       vae={"model_name": "vavae", "downsample_ratio": 16, "weight_path": ""})
    path = os.path.join(tmp, "eval_vavae.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = os.path.join(tmp, "rfid_vavae")
    log(f"[tokenizer vavae] cli.evaluate_tokenizer, vae.model_name vavae: {EVAL_IMAGES} PNGs, --batch {EVAL_BATCH}, "
        f"seeded VA-VAE (float32), LPIPS and Inception")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with counted_convs() as tally:
        t0 = time.perf_counter()
        (report,) = evaluate_tokenizer.main(["--config", path, "--data_path", origin, "--output_path", out,
                                             "--batch", str(EVAL_BATCH), "--limit", str(EVAL_IMAGES)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts("tokenizer_eval_vavae", counts)
    pngs = [len(os.listdir(os.path.join(out, d))) for d in ("reference", "vavae_0.0")]
    ok = (all(math.isfinite(report[k]) for k in ("rfid", "psnr", "lpips", "ssim")) and pngs == [EVAL_IMAGES] * 2
          and tally["convs"] > 0 and tally["tf32"] == 0)
    tok = build_tokenizer_fns("vavae", "", 256, dev, 1)
    lp = load_lpips(dev)
    ds = ImageFolderDataset(origin, 256)
    u8 = torch.from_numpy(np.stack([ds.get(i, raw_uint8=True)[0] for i in range(EVAL_BATCH)])).to(dev)
    ms = cuda_ms(lambda: evaluate_tokenizer.roundtrip(tok, lp, u8), 3, 1)
    log(f"  {report}; PNGs {pngs}; {tally['convs']} convolutions, {tally['tf32']} with TF32 allowed; the roundtrip "
        f"(encode, decode, LPIPS, SSIM) of a batch of {EVAL_BATCH} {ms:.2f} ms = {EVAL_BATCH / ms * 1e3:.1f} images/s; "
        f"the whole CLI call {seconds:.2f} s for {EVAL_IMAGES} images; peak memory {peak:.3f} GB; on {smi} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("VA-VAE tokenizer evaluation: a metric is not finite, PNGs are missing, or a TF32 convolution")
    del tok, lp
    torch.cuda.empty_cache()
    return {"tokenizer_eval_vavae": counts}


def tokenizer_family_phases(dev, smi: str, tmp: str, origin: str) -> dict:
    """The conv tokenizers, the SD-VAE sampling pipeline, the SD-VAE
    extraction and the VA-VAE tokenizer evaluation; their launch counts."""
    counts = conv_tokenizer_phase(dev, smi, origin)
    counts |= sdvae_pipeline_phase(dev, smi)
    counts |= extraction_sdvae_phase(dev, smi, tmp, origin)
    counts |= tokenizer_eval_vavae_phase(dev, smi, tmp, origin)
    return counts


def _fid_of_stats(stats: str) -> tuple:
    """``cli.evaluate --fid`` of the statistics file against itself on the
    CPU, in a spawned process: (FID, seconds)."""
    t0 = time.perf_counter()
    from ldmae_tpu_torch.cli import evaluate

    return evaluate.main([stats, stats, "--fid", "--device", "cpu"])["fid"], time.perf_counter() - t0


def inception_fid_phase(dev, smi: str, tmp: str) -> None:
    """The FID InceptionV3 on the card against its CPU path (batch 4,
    seeded random weights: relative L2 1e-5, which the same network with
    TF32 convolutions must exceed), its images/s at batch INCEPTION_BATCH;
    then ``cli.fid_stats`` on one seeded npz of NPZ_IMAGES and
    ``cli.evaluate`` (the ADM report) of a second against it, and ``evaluate
    --fid`` of the statistics against themselves (FID 0 within 1e-3) on
    the CPU in a process beside it."""
    import numpy as np
    import torch

    from ldmae_tpu_torch.cli import evaluate, fid_stats
    from ldmae_tpu_torch.models import inception as tinc

    sd = tinc.import_inception_torch_state_dict(tinc.random_inception_torch_state_dict())
    gpu, cpu = tinc.InceptionV3(dev), tinc.InceptionV3("cpu")
    gpu.load_state_dict(sd)
    cpu.load_state_dict(sd)
    x = torch.rand(INCEPTION_BATCH, 256, 256, 3, generator=torch.Generator().manual_seed(43))
    ref = cpu(x[:4], return_spatial=True)

    def errs():
        out = gpu(x[:4].to(dev), return_spatial=True)
        return [float((o.cpu().double() - r.double()).norm() / r.double().norm()) for o, r in zip(out, ref)]

    off = errs()
    with tf32_convs(tinc):
        on = errs()
    xd = x.to(dev)
    ms = cuda_ms(lambda: gpu(xd, return_spatial=True), 5)
    ok = max(off) <= 1e-5 and min(on) > 1e-5
    log(f"[inception] FID InceptionV3 on the card vs its CPU path (batch 4, 256^2 -> 299^2): pooled rel L2 "
        f"{off[0]:.3g}, sFID tap {off[1]:.3g} (tolerance 1e-5, TF32 off); with TF32 convolutions {on[0]:.3g}, "
        f"{on[1]:.3g} (must exceed it) -> {'ok' if ok else 'FAIL'}; batch {INCEPTION_BATCH} {ms:.2f} ms = "
        f"{INCEPTION_BATCH / ms * 1e3:.1f} images/s; on {smi}")
    if not ok:
        raise SystemExit("Inception: the card disagrees with the CPU path, or the TF32 control reads within")
    del gpu, cpu, xd
    torch.cuda.empty_cache()

    rng = np.random.default_rng(44)
    for name in ("a", "b"):
        np.savez(os.path.join(tmp, f"{name}.npz"), arr_0=rng.integers(0, 256, (NPZ_IMAGES, 256, 256, 3), dtype=np.uint8))
    stats = os.path.join(tmp, "a_stats.npz")
    t0 = time.perf_counter()
    fid_stats.main(["--input", os.path.join(tmp, "a.npz"), "--out", stats])
    t1 = time.perf_counter()
    # evaluate --fid a a (the statistics against themselves: two .npz, so no
    # Inception, and a scipy sqrtm of 2048 x 2048 on the host) in a process of
    # its own on the CPU, beside evaluate b vs a in this one
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn")) as pool:
        fut = pool.submit(_fid_of_stats, stats)
        report = evaluate.main([os.path.join(tmp, "a.npz"), os.path.join(tmp, "b.npz"), "--ref_stats", stats])
        t2 = time.perf_counter()
        same, same_s = fut.result()
    t3 = time.perf_counter()
    ok = (all(math.isfinite(report[k]) for k in ("fid", "sfid", "precision", "recall")) and report["fid"] > 0
          and abs(same) <= 1e-3 and "inception_score" not in report)
    log(f"[fid] fid_stats ({NPZ_IMAGES} images) {t1 - t0:.2f} s; evaluate b vs a {t2 - t1:.2f} s: {report}; "
        f"evaluate --fid a a {same_s:.2f} s in a CPU process beside it (both done {t3 - t1:.2f} s after "
        f"fid_stats): FID {same:.3g} (must be 0 within 1e-3); no IS without the weights file's fc head -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("fid_stats / evaluate: a metric is not finite, or FID(a, a) is not 0")


# ---------------------------------------------------------------------------
# The VMAE training slice (scripts/train_ae.sh's stages 1 and 3)
# ---------------------------------------------------------------------------

# the recipe's flags; the cut is the step count (epochs x steps_per_epoch)
VMAE_ARCH = "mae_for_ldmae_f8d16_prev"
VMAE_STAGE1 = dict(input_size=128, batch_size=128, accum_iter=2, warmup_epochs=10, blr=1e-4, weight_decay=0.05,
                   mask_ratio=0.25, visible_loss_ratio=0.75, perceptual_loss_ratio=0.5, fixed_std=1e-3,
                   kl_loss_weight=1e-6)
VMAE_STAGE3 = dict(input_size=256, batch_size=16, accum_iter=16, save_epochs=1, warmup_epochs=0, blr=1e-5,
                   weight_decay=0.05, mask_ratio=0.0, visible_loss_ratio=0.5, perceptual_loss_ratio=10.0,
                   kl_loss_weight=0.0)
VMAE_EPOCHS, VMAE_STEPS_PER_EPOCH = 2, 2  # the recipe: 400 and 10 epochs of len(ImageNet) // 256 steps


def _vmae_flags(stage: dict) -> list:
    return [f for k, v in stage.items() for f in (f"--{k}", str(v))] + ["--no_cls", "--smooth_output"]


def vmae_dense_shapes(spec, m: int, mask_ratio: float, tune_decoder: bool) -> collections.Counter:
    """``dense``'s launches by (M, K, N) in one micro-batch of m images: the
    patch embedding on all L tokens, the encoder's blocks, to_latent,
    from_latent and decoder_embed on the kept ones (all of them in stage 3),
    the decoder's blocks and the pred head on all L. The backward launches
    none (``_DenseBiasF32``'s gradients are cuBLAS products)."""
    n_tok = spec.num_patches
    n_keep = n_tok if tune_decoder else int(n_tok * (1 - mask_ratio))
    d, dd, pin, lat = spec.embed_dim, spec.decoder_embed_dim, spec.patch_size**2 * 3, spec.latent_dim
    c = collections.Counter({(m * n_tok, pin, d): 1})
    for rows, w, depth in ((m * n_keep, d, spec.depth), (m * n_tok, dd, spec.decoder_depth)):
        h = int(w * spec.mlp_ratio)
        for shape in ((rows, w, 3 * w), (rows, w, w), (rows, w, h), (rows, h, w)):
            c[shape] += depth
    c[(m * n_keep, d, spec.encoder_latent_dim)] += 1
    c[(m * n_keep, lat, d)] += 1
    c[(m * n_keep, d, dd)] += 1
    c[(m * n_tok, dd, pin)] += 1
    return c


def check_shapes(what: str, tally, want: dict) -> None:
    """A launch tally by shape must equal ``want`` exactly."""
    got = {k: v for k, v in tally.items() if v}
    log(f"  {what}: {got}")
    if got != {k: v for k, v in want.items() if v}:
        raise SystemExit(f"{what}: launches by shape {got}, expected {want}")


def _vmae_cli(dev, smi: str, what: str, argv: list, stage: dict, tune_decoder: bool, micro=None) -> dict:
    """One ``cli.train_vmae.main`` run, counted: the launches (dense's exactly,
    by (M, K, N), ``micro`` a micro-batch's, by default the stage's
    ``vmae_dense_shapes``; nothing else launches under xla), finite losses,
    and the last epoch's steps/s, images/s, TFLOP/s, MFU and peak memory."""
    import torch

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.cli import train_vmae

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with dense_launches_by_shape() as shapes:
        t0 = time.perf_counter()
        res = train_vmae.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps = VMAE_EPOCHS * VMAE_STEPS_PER_EPOCH
    micro = micro or vmae_dense_shapes(_vmae_spec(stage, tune_decoder), stage["batch_size"], stage["mask_ratio"],
                                       tune_decoder)
    want = {k: v * stage["accum_iter"] * steps for k, v in micro.items()}
    EXPECTED_LAUNCHES[what] = _NONE | {"dense_bias_f32": sum(want.values())}
    check_counts(what, counts)
    check_shapes(f"{what}: dense by (M, K, N)", shapes, want)
    hist = res["history"]
    finite = all(math.isfinite(h[k]) for h in hist for k in ("loss", "vis_loss", "mask_loss", "kl_loss", "p_loss"))
    last = hist[-1]
    per_step = stage["batch_size"] * stage["accum_iter"]
    ok = finite and res["state"].step == steps and len(hist) == VMAE_EPOCHS and last["p_loss"] > 0
    log(f"  {what}: {steps} steps in {seconds:.2f} s (model build, PNG decode and augmentation, the steps, "
        f"checkpoints); losses finite: {finite}; last epoch: loss {last['loss']:.6g} (vis {last['vis_loss']:.6g}, "
        f"mask {last['mask_loss']:.6g}, kl {last['kl_loss']:.6g}, lpips {last['p_loss']:.6g}), "
        f"{last['img_per_sec'] / per_step:.4f} steps/s, {last['img_per_sec']:.2f} images/s, "
        f"{last['tflops']:.4g} TFLOP/s, MFU {'n/a' if last['mfu'] is None else format(last['mfu'], '.4g')} (3x the analytic VMAE forward over 989 TFLOP/s; "
        f"LPIPS not counted), peak memory {peak:.3f} GB; on {smi} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{what}: a loss is not finite, or the run did not take its steps")
    return {"counts": counts, "state": res["state"], "seconds": seconds, "peak_gb": peak, "last": last}


def _vmae_spec(stage: dict, tune_decoder: bool):
    """The spec the CLI builds from the stage's flags."""
    from ldmae_tpu_torch.models import vmae_spec

    return vmae_spec(VMAE_ARCH, img_size=stage["input_size"], no_cls=True, smooth_output=True,
                     kl_loss_weight=stage["kl_loss_weight"], fixed_std=stage.get("fixed_std"),
                     perceptual_loss_ratio=stage["perceptual_loss_ratio"], ldmae_mode=tune_decoder)


def _vmae_batch(dev, stage: dict, tune_decoder: bool, seed: int):
    """A micro-batch of the stage's shape (uint8 pixels) with fixed mask and
    posterior noise."""
    import torch

    m, size, n_tok = stage["batch_size"], stage["input_size"], _vmae_spec(stage, tune_decoder).num_patches
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(0, 256, (m, size, size, 3), generator=gen, device=dev, dtype=torch.uint8)
    n_keep = n_tok if tune_decoder else int(n_tok * (1 - stage["mask_ratio"]))
    return x, dict(mask_noise=torch.rand(m, n_tok, generator=gen, device=dev),
                   latent_noise=torch.randn(m, 16, n_keep, generator=gen, device=dev))


def _vmae_model(dev, stage: dict, tune_decoder: bool, seed: int = 13):
    """The stage's model with the reference initialisation from a seed."""
    import torch

    from ldmae_tpu_torch.models import VMAE, init_vmae_weights_

    return init_vmae_weights_(VMAE(_vmae_spec(stage, tune_decoder), device=dev), torch.Generator().manual_seed(seed))


def vmae_grad_phase(dev, stage: dict, tune_decoder: bool, lp_fn) -> None:
    """One micro-batch of the stage at full size: the per-leaf gradients of
    the CLI's path (bf16, ``dense``'s kernel, xla attention) against the same
    path with ``dense``'s plain version (fp32 sums of the same bf16 values,
    the fp32 bias, one rounding) within GRAD_REL_L2; the gradient that LPIPS
    passes to the reconstruction is nonzero and finite; the bf16 path
    against the fp32 plain path is printed, not gated."""
    import torch

    from ldmae_tpu_torch.data.images import normalize_uint8_images
    from ldmae_tpu_torch.ops import linear
    from ldmae_tpu_torch.ops.patchify import unpatchify
    from ldmae_tpu_torch.train.train_vmae import make_vmae_optimizer, vmae_loss

    name = "stage 3" if tune_decoder else "stage 1"
    x, noise = _vmae_batch(dev, stage, tune_decoder, 14)
    kw = dict(tune_decoder=tune_decoder, mask_ratio=stage["mask_ratio"],
              visible_loss_ratio=stage["visible_loss_ratio"], perceptual_loss_fn=lp_fn, **noise)

    def grads(dtype):
        model = _vmae_model(dev, stage, tune_decoder)
        make_vmae_optimizer(model, tune_decoder=tune_decoder)  # the stage-3 freeze
        out = vmae_loss(model, x, compute_dtype=dtype, **kw)
        out["loss"].backward()
        return float(out["loss"]), {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}

    def worst(g, ref):
        errs = {n: float((g[n] - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)) for n in ref}
        leaf = max(errs, key=errs.get)
        return errs[leaf], leaf

    loss_k, g_k = grads(torch.bfloat16)
    real = linear.dense_bias_f32

    def plain(x, weight, bias):
        return torch.nn.functional.linear(x.float(), weight.float(), bias).bfloat16()

    plain.launches = 0
    linear.dense_bias_f32 = plain
    try:
        loss_p, g_p = grads(torch.bfloat16)
    finally:
        linear.dense_bias_f32 = real
    loss_32, g_32 = grads(torch.float32)
    err, leaf = worst(g_k, g_p)
    err32, leaf32 = worst(g_k, g_32)
    # the perceptual term's gradient in the reconstruction
    imgs = normalize_uint8_images(x)
    with torch.no_grad():
        pred = _vmae_model(dev, stage, tune_decoder).reconstruct(imgs, compute_dtype=torch.bfloat16)
    recon = unpatchify(pred.float(), 8, 3).requires_grad_()
    (g_rec,) = torch.autograd.grad(lp_fn(imgs, recon).mean(), recon)
    g_norm = float(g_rec.norm())
    ok = (err <= GRAD_REL_L2 and abs(loss_k - loss_p) <= 1e-2 * abs(loss_p) and g_norm > 0
          and math.isfinite(g_norm) and all(bool(torch.isfinite(v).all()) for v in g_k.values()))
    log(f"  {name} gradients ({len(g_k)} leaves, a micro-batch of {stage['batch_size']} at "
        f"{stage['input_size']}^2): loss kernel {loss_k:.6g} vs plain dense {loss_p:.6g}; worst leaf {leaf}: "
        f"relative L2 {err:.4g} (bound {GRAD_REL_L2}); against the fp32 plain path (loss {loss_32:.6g}, not "
        f"gated): worst leaf {leaf32} {err32:.4g}; LPIPS's gradient in the reconstruction: norm {g_norm:.4g} "
        f"(must be nonzero) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"VMAE {name}: the kernel path's gradients disagree, or LPIPS passes no gradient")
    torch.cuda.empty_cache()


def vmae_flash_leg(dev, stage: dict, tune_decoder: bool, lp_fn) -> dict:
    """``make_vmae_train_step(attn_impl="flash")``: one micro-batch's
    gradients against the xla leg's (both bf16) within GRAD_REL_L2; one full
    step of the recipe (accum_iter micro-batches) under each impl with
    exact launch counts (#2's and #5's by shape), timed. Returns {"counts",
    "fwd_shapes", "bwd_shapes"}."""
    import torch

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.train import TrainState
    from ldmae_tpu_torch.train.train_vmae import lr_schedule, make_vmae_optimizer, make_vmae_train_step, vmae_loss

    name = "stage 3" if tune_decoder else "stage 1"
    x, noise = _vmae_batch(dev, stage, tune_decoder, 15)
    kw = dict(mask_ratio=stage["mask_ratio"], visible_loss_ratio=stage["visible_loss_ratio"],
              perceptual_loss_fn=lp_fn, compute_dtype=torch.bfloat16)

    def grads(attn_impl):
        model = _vmae_model(dev, stage, tune_decoder)
        make_vmae_optimizer(model, tune_decoder=tune_decoder)  # the freeze
        out = vmae_loss(model, x, tune_decoder=tune_decoder, attn_impl=attn_impl, **kw, **noise)
        out["loss"].backward()
        return float(out["loss"]), {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}

    loss_x, g_x = grads("xla")
    loss_f, g_f = grads("flash")
    errs = {n: float((g_f[n] - g_x[n]).norm() / g_x[n].norm().clamp_min(1e-30)) for n in g_x}
    leaf = max(errs, key=errs.get)
    ok = errs[leaf] <= GRAD_REL_L2 and abs(loss_f - loss_x) <= 1e-2 * abs(loss_x)
    log(f"  {name}, flash vs xla (bf16, a micro-batch): loss {loss_f:.6g} vs {loss_x:.6g}; worst leaf {leaf}: "
        f"relative L2 {errs[leaf]:.4g} (bound {GRAD_REL_L2}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"VMAE {name}: the flash leg's gradients disagree with the xla leg's")

    a = stage["accum_iter"]
    batch = {"x": x.expand(a, *x.shape)}
    # per step: dense's forward launches; under flash #2 and #5 on each
    # block with a gradient (stage 3's encoder runs without: the resident
    # forward)
    spec = _vmae_spec(stage, tune_decoder)
    m, n_tok = stage["batch_size"], spec.num_patches
    n_keep = n_tok if tune_decoder else int(n_tok * (1 - stage["mask_ratio"]))
    dense_n = a * sum(vmae_dense_shapes(spec, m, stage["mask_ratio"], tune_decoder).values())
    enc = (m, spec.num_heads, n_keep, spec.embed_dim // spec.num_heads)
    dec = (m, spec.decoder_num_heads, n_tok, spec.decoder_embed_dim // spec.decoder_num_heads)
    want = collections.Counter({dec: a * spec.decoder_depth})
    if not tune_decoder:
        want[enc] += a * spec.depth
    # under autograd at d = 16 and N <= 3,072 #2 is the resident kernel with
    # lse (the single-pass backward's), counted as flash_attention_resident,
    # as are stage 3's encoder forwards without a gradient
    resident = collections.Counter({sh: c for sh, c in want.items()
                                    if fa._resident_lse(torch.bfloat16, sh[3], 8, sh[2], False)})
    fwd_want = resident + collections.Counter({enc: a * spec.depth} if tune_decoder else {})
    what = f"vmae_flash_{'stage3' if tune_decoder else 'stage1'}"
    EXPECTED_LAUNCHES[f"{what}_xla"] = _NONE | {"dense_bias_f32": dense_n}
    EXPECTED_LAUNCHES[what] = _NONE | {"dense_bias_f32": dense_n, "flash_attention": sum((want - resident).values()),
                                       "flash_attention_bwd": sum(want.values()),
                                       "flash_attention_resident": sum(fwd_want.values())}
    out = {}
    for attn_impl in ("xla", "flash"):
        model = _vmae_model(dev, stage, tune_decoder)
        state = TrainState(0, model, None, make_vmae_optimizer(model, tune_decoder=tune_decoder))
        step = make_vmae_train_step(lr_schedule(10, 1e-4, warmup_epochs=0, total_epochs=10), attn_impl=attn_impl,
                                    tune_decoder=tune_decoder, grad_accum=a, **kw)
        gen = torch.Generator(device=dev).manual_seed(16)
        step(state, batch, gen)  # warm-up (cuDNN's algorithm choice, the kernels' first launch)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        shape = lambda q, *rest: tuple(q.shape)  # noqa: E731
        with launches_by_shape(fa, "_flash_attention_fwd", "flash_attention_resident", shape) as fwd, \
                launches_by_shape(fa, "flash_attention_bwd", "flash_attention_bwd", shape) as bwd:
            t0 = time.perf_counter()
            metrics = step(state, batch, gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        log(f"  {name}, one step of {a} x {m} under {attn_impl}: {ms:.1f} ms ({a * m / ms * 1e3:.1f} images/s), "
            f"loss {float(metrics['loss']):.6g}; launches { {k: v for k, v in counts.items() if v} }")
        check_counts(what if attn_impl == "flash" else f"{what}_xla", counts)
        if attn_impl == "flash":
            check_shapes(f"{what}: #2 (resident) by shape", fwd, fwd_want)
            check_shapes(f"{what}: #5 by shape", bwd, want)
        out[attn_impl] = dict(counts=counts, fwd_shapes=dict(fwd), bwd_shapes=dict(bwd), ms=ms)
        if not bool(metrics["loss_finite"]):
            raise SystemExit(f"VMAE {name}: a non-finite loss under {attn_impl}")
        del model, state
    torch.cuda.empty_cache()
    return out


def vmae_attention_rows(dev, shapes: dict, bwd_shapes: dict) -> list:
    """#2's forward (with autograd recording at d = 16: the resident kernel
    with lse) and #5's backward (the single pass given that output and lse:
    preprocess, flash_bwd_wgmma_kernel<16>, postprocess; two runs' dq, dk, dv
    bit for bit equal) at the VMAE training shapes against their plain
    versions, timed beside SDPA's forward and backward (fwd+bwd minus fwd),
    with their bounds (bytes: q, k, v in and the output and lse out for #2;
    q, k, v, g, the output and lse in and dq, dk, dv out for #5; operations:
    4 and 10 b h N^2 d bf16 FLOPs; b h N^2 exponentials). ``shapes`` /
    ``bwd_shapes``: launches a step by shape, from the flash leg."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa

    rows = []
    gen = torch.Generator(device=dev).manual_seed(17)
    for shape, launches in sorted(shapes.items()):
        b, h, n, d = shape
        q, k, v, g = (torch.randn(b, h, n, d, generator=gen, device=dev).bfloat16() for _ in range(4))
        ref = fa.flash_attention_plain(q, k, v)
        out, lse = fa._launch(q, k, v, "flash_attention", with_lse=True)
        err_f = compare(f"flash_attention {shape}", out, ref, **attn_tol(ref))
        fwd_ms = cuda_ms(lambda: fa._launch(q, k, v, "flash_attention", with_lse=True), 20)
        plain_f = cuda_ms(lambda: fa.flash_attention_plain(q, k, v), 3, 1)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q, k, v))

        def sdpa_fwd_bwd():
            torch.autograd.grad(F.scaled_dot_product_attention(qs, ks, vs), (qs, ks, vs), g)

        def sdpa_fwd():
            with torch.no_grad():
                F.scaled_dot_product_attention(qs, ks, vs)

        fb_ms, f_ms = cuda_ms(sdpa_fwd_bwd, 10), cuda_ms(sdpa_fwd, 20)
        # queued, without the host's launch time (autograd's, at these shapes, varied with the host)
        lib_queued = queued_ms(sdpa_fwd_bwd, 10) - queued_ms(sdpa_fwd, 20)
        bnd_f = bound(4 * b * h * n * d * 2 + b * h * n * 4, 4 * b * h * n * n * d, exps=b * h * n * n)
        rows.append({"name": "flash_attention", "route": "cuda", "source": _FA, "replaces": f"{_PALLAS_FA}:77",
                     "shape": list(shape), "launches": launches, "max_abs_err": err_f, "ms": fwd_ms,
                     "plain_ms": plain_f, "bound_ms": bnd_f[0], "bound_by": bnd_f[1], "library_ms": f_ms})
        refs = fa.flash_attention_bwd_plain(q, k, v, g)
        run = lambda: fa.flash_attention_bwd(q, k, v, g, out, lse)  # noqa: E731  the Function's call
        outs = run()
        rel, elem = bwd_errors(outs, refs)
        same = all(torch.equal(x_, y_) for x_, y_ in zip(outs, run()))  # dq summed in key-tile order
        ok = rel <= BWD_REL_L2 and elem <= BWD_ELEM and same
        err_b = max(float((o.float() - r.float()).abs().max()) for o, r in zip(outs, refs))
        del outs, refs
        bwd_ms, queued = cuda_ms(run, 10), queued_ms(run, 20)
        parts = train_route(f"flash_attention_bwd {shape}", run, BWD_ROUTE)["kernels_ms"]
        plain_b = cuda_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, g), 3, 1)
        bnd_b = bound(8 * b * h * n * d * 2 + b * h * n * 4, 10 * b * h * n * n * d, exps=b * h * n * n)
        log(f"[vmae kernel] {shape} bf16: #2 forward with lse {fwd_ms:.4f} ms (SDPA {f_ms:.4f}, plain {plain_f:.4f}, "
            f"bound {bnd_f[0]:.4f} ({bnd_f[1]}), share {bnd_f[0] / fwd_ms:.3f}); #5 backward vs plain: relative L2 "
            f"{rel:.4g} (bound {BWD_REL_L2}), max |err| / max |value| {elem:.4g} (bound {BWD_ELEM}), two runs bit "
            f"for bit {same} -> {'ok' if ok else 'FAIL'}; {bwd_ms:.4f} ms (queued {queued:.4f}; parts "
            f"{ {n_: round(v_, 4) for n_, v_ in parts.items()} }), SDPA backward {fb_ms - f_ms:.4f} ms (fwd+bwd "
            f"{fb_ms:.4f} minus fwd {f_ms:.4f}; queued {lib_queued:.4f}), kernel / library {bwd_ms / (fb_ms - f_ms):.3f} "
            f"(queued {queued / lib_queued:.3f}), plain {plain_b:.4f}, "
            f"bound {bnd_b[0]:.4f} ({bnd_b[1]}), share {bnd_b[0] / bwd_ms:.3f}; launches a step {launches} / "
            f"{bwd_shapes.get(shape, 0)}")
        if not ok:
            raise SystemExit(f"flash_attention_bwd {shape}: kernel disagrees with its plain backward, or two runs differ")
        rows.append({"name": "flash_attention_bwd", "route": "cuda", "source": _FA,
                     "replaces": f"{_PALLAS_FA}:151", "shape": list(shape), "launches": bwd_shapes.get(shape, 0),
                     "max_abs_err": err_b, "ms": bwd_ms, "plain_ms": plain_b, "bound_ms": bnd_b[0],
                     "bound_by": bnd_b[1], "library_ms": fb_ms - f_ms, "queued_ms": queued,
                     "library_queued_ms": lib_queued, "kernels_ms": parts})
        del q, k, v, g, qs, ks, vs, out, lse
        torch.cuda.empty_cache()
    return rows


# device-time groups of a VMAE training step: by the aten op that launched a
# kernel (its self device time; an op whose name holds one of the marks),
# the port's kernels by kernel name
VMAE_SPLIT_OPS = {
    "attention (xla: bmm, softmax)": ("aten::bmm", "softmax"),
    "linear backward (cuBLAS mm)": ("aten::mm", "aten::addmm"),
    "convolutions (LPIPS VGG16, smoother)": ("convolution",),
}
VMAE_SPLIT_KERNELS = {"dense (the port's GEMM)": ("gemm_kernel",), "attention kernels (flash)": ("flash",)}


def vmae_step_split(what: str, fn) -> None:
    """Where one call of ``fn`` (a micro-batch's forward and backward) spends
    device time: torch.profiler after a warm-up call; groups by the aten op
    that launched each kernel, the port's kernels by name, the rest
    (elementwise, norms, reductions, casts, the optimizer) as one group; the
    idle share of the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages()
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not kernels:
        log(f"[vmae profile] {what}: the profiler recorded no device time (split not measured)")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    groups = {g: sum(e.self_device_time_total for e in avg
                     if e.device_type == DeviceType.CPU and any(m in e.key for m in marks)) / 1e3
              for g, marks in VMAE_SPLIT_OPS.items()}
    groups |= {g: sum(e.self_device_time_total for e in kernels if any(m in e.key for m in marks)) / 1e3
               for g, marks in VMAE_SPLIT_KERNELS.items()}
    groups["other (elementwise, norms, reductions, casts)"] = busy - sum(groups.values())
    log(f"[vmae profile] {what}: wall {wall:.1f} ms, device busy {busy:.1f} ms, idle share {1 - busy / wall:.3f}, "
        f"{sum(e.count for e in kernels)} kernel launches; " + "; ".join(
            f"{g} {ms:.1f} ms ({ms / busy:.3f})" for g, ms in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:6d}x  {e.key[:110]}")


# the gradual-resolution stage 1 (--gradual_resol: patch 4 at 128^2, 1,024
# tokens before the token downsample and after the upsample). The recipe's
# micro-batch of 128 would keep xla attention's fp32 (128, 12, 1024, 1024)
# logits and probabilities for the backward, about 10 GB a layer: it is cut to
# 32 with accum_iter 8, the same effective batch of 256
VMAE_GRADUAL = VMAE_STAGE1 | dict(batch_size=32, accum_iter=8)


def vmae_gradual_dense_shapes(spec, m: int, down_after: int, up_after: int) -> collections.Counter:
    """``dense``'s launches by (M, K, N) in one gradual micro-batch of m
    images: the patch embedding on all L tokens, the encoder's first
    ``down_after`` blocks on all L (the mask tokens are back in), the rest
    on L / 4, to_latent, from_latent and decoder_embed on L / 4, the
    decoder's first ``up_after`` blocks on L / 4, the rest and the pred head
    on L. The token convolutions are ``conv2d_fp32``'s."""
    n_tok, n_low = spec.num_patches, spec.num_patches // 4
    d, dd, pin, lat = spec.embed_dim, spec.decoder_embed_dim, spec.patch_size**2 * 3, spec.latent_dim
    c = collections.Counter({(m * n_tok, pin, d): 1})
    for rows, w, depth in ((m * n_tok, d, down_after), (m * n_low, d, spec.depth - down_after),
                           (m * n_low, dd, up_after), (m * n_tok, dd, spec.decoder_depth - up_after)):
        h = int(w * spec.mlp_ratio)
        for shape in ((rows, w, 3 * w), (rows, w, w), (rows, w, h), (rows, h, w)):
            c[shape] += depth
    c[(m * n_low, d, spec.encoder_latent_dim)] += 1
    c[(m * n_low, lat, d)] += 1
    c[(m * n_low, d, dd)] += 1
    c[(m * n_tok, dd, pin)] += 1
    return c


def vmae_gradual_phase(dev, smi: str, tmp: str, common: list, lp_fn) -> dict:
    """Stage 1 with ``--gradual_resol`` through ``cli.train_vmae.main`` (the
    recipe's flags, the micro-batch cut to VMAE_GRADUAL's): dense counted by
    shape, finite losses, the reference's gradual layout in its checkpoint;
    then one micro-batch's gradients under ``flash`` (#2 and #5 at head dim
    16, 1,024 and 256 tokens, counted by shape) against ``xla`` within
    GRAD_REL_L2 per leaf, each timed. Returns the two runs' counts."""
    import torch

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.models.vmae_variants import GradualVMAE, init_gradual_weights_
    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.train.train_vmae import vmae_loss

    stage = VMAE_GRADUAL
    spec = dataclasses.replace(_vmae_spec(stage, False), patch_size=_vmae_spec(stage, False).patch_size // 2)
    down, up = spec.depth // 2, spec.decoder_depth - spec.depth // 2
    m, n_tok = stage["batch_size"], spec.num_patches
    out_dir = os.path.join(tmp, "vmae_gradual")
    log(f"[vmae gradual] cli.train_vmae --gradual_resol: {VMAE_ARCH} at patch {spec.patch_size} ({n_tok} tokens, "
        f"{n_tok // 4} after the downsample at block {down}), {_vmae_flags(stage)} (micro-batch cut from 128 x 2 to "
        f"{m} x {stage['accum_iter']}), {VMAE_EPOCHS} epochs x {VMAE_STEPS_PER_EPOCH} steps, bf16, xla attention")
    run = _vmae_cli(dev, smi, "vmae_gradual", common + ["--output_dir", out_dir, "--gradual_resol"] + _vmae_flags(stage),
                    stage, False, vmae_gradual_dense_shapes(spec, m, down, up))
    sd = torch.load(os.path.join(out_dir, "checkpoints", "checkpoint-1.pth"), map_location="cpu",
                    weights_only=False)["model"]
    layout = (sd[f"blocks.{down}.conv.weight"].shape == (spec.embed_dim,) * 2 + (3, 3)
              and f"decoder_blocks.{up}.conv.bias" in sd and f"blocks.{spec.depth}.norm1.weight" in sd)
    log(f"  checkpoint-1.pth in the reference's gradual layout (blocks.{down}.conv, decoder_blocks.{up}.conv, "
        f"blocks.{spec.depth}): {layout}")
    if not layout:
        raise SystemExit("VMAE gradual: the checkpoint is not in the reference's gradual layout")
    del run["state"]
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(19)
    x = torch.randint(0, 256, (m, stage["input_size"], stage["input_size"], 3), generator=gen, device=dev,
                      dtype=torch.uint8)
    noise = dict(mask_noise=torch.rand(m, n_tok, generator=gen, device=dev),
                 latent_noise=torch.randn(m, 16, n_tok // 4, generator=gen, device=dev))

    def grads(attn_impl):
        model = init_gradual_weights_(GradualVMAE(spec, device=dev), torch.Generator().manual_seed(13))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = vmae_loss(model, x, mask_ratio=stage["mask_ratio"], visible_loss_ratio=stage["visible_loss_ratio"],
                        perceptual_loss_fn=lp_fn, compute_dtype=torch.bfloat16, attn_impl=attn_impl, **noise)
        out["loss"].backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return float(out["loss"]), {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}, ms

    grads("xla")  # warm-up
    want = collections.Counter({(m, spec.num_heads, n_tok, 16): down + spec.decoder_depth - up,
                                (m, spec.num_heads, n_tok // 4, 16): spec.depth - down + up})
    # #2 under autograd at d = 16: the resident kernel with lse (``vmae_flash_leg``)
    resident = collections.Counter({sh: c for sh, c in want.items()
                                    if fa._resident_lse(torch.bfloat16, sh[3], 8, sh[2], False)})
    EXPECTED_LAUNCHES["vmae_gradual_flash"] = _NONE | {
        "flash_attention": sum((want - resident).values()), "flash_attention_resident": sum(resident.values()),
        "flash_attention_bwd": sum(want.values()),
        "dense_bias_f32": sum(vmae_gradual_dense_shapes(spec, m, down, up).values())}
    ops.reset_launch_counts()
    shape = lambda q, *rest: tuple(q.shape)  # noqa: E731
    with launches_by_shape(fa, "_flash_attention_fwd", "flash_attention_resident", shape) as fwd, \
            launches_by_shape(fa, "flash_attention_bwd", "flash_attention_bwd", shape) as bwd:
        loss_f, g_f, _ = grads("flash")
    counts = ops.launch_counts()
    check_counts("vmae_gradual_flash", counts)
    check_shapes("vmae_gradual_flash: #2 (resident) by shape", fwd, resident)
    check_shapes("vmae_gradual_flash: #5 by shape", bwd, want)
    loss_x, g_x, ms_x = grads("xla")
    _, _, ms_f = grads("flash")
    errs = {n: float((g_f[n] - g_x[n]).norm() / g_x[n].norm().clamp_min(1e-30)) for n in g_x}
    leaf = max(errs, key=errs.get)
    ok = errs[leaf] <= GRAD_REL_L2 and abs(loss_f - loss_x) <= 1e-2 * abs(loss_x) and math.isfinite(loss_f)
    log(f"  gradual, flash vs xla (bf16, a micro-batch of {m}): loss {loss_f:.6g} vs {loss_x:.6g}; worst leaf {leaf}: "
        f"relative L2 {errs[leaf]:.4g} (bound {GRAD_REL_L2}); a micro-batch's forward, LPIPS and backward "
        f"{ms_x:.1f} ms under xla, {ms_f:.1f} ms under flash; on {smi} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("VMAE gradual: the flash leg's gradients disagree with the xla leg's")
    torch.cuda.empty_cache()
    return {"vmae_gradual": run["counts"], "vmae_gradual_flash": counts}


def vmae_train_phase(dev, smi: str, tmp: str, origin: str) -> tuple:
    """The VMAE training slice: stage 1 and stage 3 of ``scripts/train_ae.sh``
    through ``cli.train_vmae.main`` on the seeded PNGs (LPIPS on the
    package's seeded random weights), the recipe's flags with the step count
    cut, exact launch counts (dense's by shape); stage 3 from stage 1's
    ``checkpoint-0.pth`` with the frozen parameters bitwise unchanged; the
    gradient checks at each stage's micro-batch; the flash leg with #2's and
    #5's launches; the d = 16 attention kernels timed; one micro-batch's
    device time split. Returns ({path: counts}, the kernels' rows)."""
    import torch

    from ldmae_tpu_torch.models.lpips import load_lpips, make_lpips_fn
    from ldmae_tpu_torch.train.train_vmae import vmae_loss

    counts = {}
    common = ["--model", VMAE_ARCH, "--data_path", origin, "--epochs", str(VMAE_EPOCHS),
              "--steps_per_epoch", str(VMAE_STEPS_PER_EPOCH), "--num_workers", "8", "--seed", "0"]
    out1, out3 = os.path.join(tmp, "vmae_stage1"), os.path.join(tmp, "vmae_stage3")
    log(f"[vmae] cli.train_vmae stage 1: {VMAE_ARCH} (width 192, depth 12 / 12, 12 heads of 16), "
        f"{_vmae_flags(VMAE_STAGE1)}, {VMAE_EPOCHS} epochs x {VMAE_STEPS_PER_EPOCH} steps, bf16, xla attention")
    s1 = _vmae_cli(dev, smi, "vmae_stage1", common + ["--output_dir", out1] + _vmae_flags(VMAE_STAGE1),
                   VMAE_STAGE1, False)
    counts["vmae_stage1"] = s1["counts"]
    ckpt0 = os.path.join(out1, "checkpoints", "checkpoint-0.pth")
    if not (os.path.exists(ckpt0) and os.path.exists(os.path.join(out1, "checkpoints", "checkpoint-1.pth"))):
        raise SystemExit("VMAE stage 1: checkpoint-0.pth / checkpoint-1.pth missing")
    del s1
    torch.cuda.empty_cache()
    log(f"[vmae] cli.train_vmae stage 3: {_vmae_flags(VMAE_STAGE3)} --tune_decoder --resume checkpoint-0.pth, "
        f"{VMAE_EPOCHS} epochs x {VMAE_STEPS_PER_EPOCH} steps")
    s3 = _vmae_cli(dev, smi, "vmae_stage3", common + ["--output_dir", out3, "--tune_decoder", "--resume", ckpt0]
                   + _vmae_flags(VMAE_STAGE3), VMAE_STAGE3, True)
    counts["vmae_stage3"] = s3["counts"]
    before = torch.load(ckpt0, map_location="cpu", weights_only=True)["model"]
    frozen = moved = 0
    for name, p in s3["state"].model.named_parameters():
        same = torch.equal(p.detach().cpu(), before[name])
        if name.split(".")[0].startswith(("decoder", "from_latent")):
            moved += not same
        elif same:
            frozen += 1
        else:
            raise SystemExit(f"VMAE stage 3: frozen parameter {name} changed")
    log(f"  stage 3: {frozen} frozen parameters bitwise equal to checkpoint-0's, {moved} decoder / from_latent "
        f"parameters moved -> {'ok' if moved else 'FAIL'}")
    if not moved:
        raise SystemExit("VMAE stage 3: the decoder did not train")
    del s3, before
    torch.cuda.empty_cache()

    lp_fn = make_lpips_fn(load_lpips(dev))
    log("[vmae] gradient checks on the card (seeded init, fixed noise)")
    vmae_grad_phase(dev, VMAE_STAGE1, False, lp_fn)
    vmae_grad_phase(dev, VMAE_STAGE3, True, lp_fn)
    log("[vmae] the flash leg: make_vmae_train_step(attn_impl='flash'), #2 and #5 at head dim 16")
    fwd, bwd = collections.Counter(), collections.Counter()
    for stage, tune in ((VMAE_STAGE1, False), (VMAE_STAGE3, True)):
        leg = vmae_flash_leg(dev, stage, tune, lp_fn)
        counts[f"vmae_flash_{'stage3' if tune else 'stage1'}"] = leg["flash"]["counts"]
        fwd.update(leg["flash"]["fwd_shapes"])
        bwd.update(leg["flash"]["bwd_shapes"])
    rows = vmae_attention_rows(dev, dict(fwd), dict(bwd))
    for stage, tune in ((VMAE_STAGE1, False), (VMAE_STAGE3, True)):
        x, noise = _vmae_batch(dev, stage, tune, 18)
        model = _vmae_model(dev, stage, tune)

        def micro():
            out = vmae_loss(model, x, tune_decoder=tune, mask_ratio=stage["mask_ratio"],
                            visible_loss_ratio=stage["visible_loss_ratio"], perceptual_loss_fn=lp_fn,
                            compute_dtype=torch.bfloat16, **noise)
            out["loss"].backward()
            model.zero_grad(set_to_none=True)

        vmae_step_split(f"{'stage 3' if tune else 'stage 1'}, one micro-batch of {stage['batch_size']} at "
                        f"{stage['input_size']}^2 (forward, LPIPS, backward; xla attention, bf16)", micro)
        del model
        torch.cuda.empty_cache()
    counts |= vmae_gradual_phase(dev, smi, tmp, common, lp_fn)
    return counts, rows


# The multi-process phase: two ranks on the one card (gloo), then one rank on
# NCCL. Sampling: the shipped YAML's B/1 pipeline, per_proc_batch_size cut
# from 256 to MP_BATCH and fid_num from 50,000 to MP_FID (five batches: rank
# 0 takes 0, 2, 4 and rank 1 takes 1, 3); batch MP_RESUME_BATCH's PNGs are
# moved away and resampled. DiT training at global batch MP_TRAIN_BATCH (16 a
# rank) for MP_STEPS steps, then a restart to MP_RESTART. Extraction of
# MP_EXTRACT_LIMIT of the PNGs (a global --limit), the tokenizer evaluation
# of EVAL_IMAGES at EVAL_BATCH.
MP_BATCH, MP_FID, MP_RESUME_BATCH = 8, 40, 3
MP_SAMPLE_STEPS = 50  # the sampling chain, cut from 250 to keep the script inside its time limit
MP_TRAIN_BATCH, MP_STEPS, MP_RESTART, MP_EXTRACT_LIMIT = 32, 10, 12, 200
# per-leaf relative L2 error of the two-rank checkpoint against one process
# stepping on the concatenated batches (bf16 compute, fp32 master weights)
MP_TRAIN_REL_L2 = 1e-2
# the metrics' relative difference between the two-rank evaluation and one
# process's on the same images
MP_METRIC_REL = 1e-6


def _mp_configs(tmp: str, origin: str, data: str, weights: str) -> dict:
    """The phase's YAMLs, by name -> path."""
    import yaml

    paths = {}

    def put(name, cfg):
        paths[name] = os.path.join(tmp, f"mp_{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)

    sample = _yaml_config(train={"global_seed": 0, "output_dir": os.path.join(tmp, "mp_out"), "exp_name": "sample"})
    sample["ckpt_path"] = None  # seeded weights
    sample["vae"]["weight_path"] = ""
    sample["sample"].update(per_proc_batch_size=MP_BATCH, fid_num=MP_FID, num_sampling_steps=MP_SAMPLE_STEPS)
    put("sample", sample)
    sample["sample"]["per_proc_batch_size"] = MP_BATCH // 2
    put("sample_batch4", sample)

    def train(name):
        cfg = _yaml_config(
            data={"data_path": data, "image_size": 256, "num_classes": 1000, "latent_norm": True,
                  "latent_multiplier": 1.0, "sample": False},
            train={"max_steps": MP_STEPS, "global_batch_size": MP_TRAIN_BATCH, "global_seed": 0,
                   "output_dir": os.path.join(tmp, "mp_out"), "exp_name": name, "log_every": 5,
                   "ckpt_every": MP_STEPS, "use_checkpoint": True, "gradient_accumulation_steps": 1,
                   "weight_init": weights})
        put(name, cfg)

    for name in ("dit_dp2", "dit_plain", "dit_nccl"):
        train(name)
    ext = _yaml_config(data={"origin_path": origin, "data_path": os.path.join(tmp, "mp_latents"), "image_size": 256,
                             "num_classes": 1000, "latent_norm": True, "latent_multiplier": 1.0, "sample": True})
    ext["vae"]["weight_path"] = ""
    put("extract", ext)
    return paths


def _mp_leg(out: dict, name: str, fn) -> None:
    """Run ``fn`` with the launch counts zeroed just before and read just
    after; record them with the seconds and the peak memory."""
    import torch

    from ldmae_tpu_torch import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    extra = fn() or {}
    torch.cuda.synchronize()
    out[name] = {"seconds": time.perf_counter() - t0, "counts": ops.launch_counts(),
                 "peak_gb": torch.cuda.max_memory_allocated() / 1e9, **extra}


def _mp_rank(rank: int, port: int, tmp: str, origin: str, paths: dict) -> None:
    """One of two ranks on the card (spawned): ``init_distributed_mode`` on
    gloo with the torchrun environment, then the four CLIs' ``main``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import gc
    import shutil

    import torch

    from ldmae_tpu_torch.cli import evaluate_tokenizer, extract_features, inference, train_dit
    from ldmae_tpu_torch.data import native_io
    from ldmae_tpu_torch.parallel import barrier, init_distributed_mode

    init_distributed_mode(backend="gloo")
    out = {}
    sample = ["--config", paths["sample"], "--skip_fid"]
    _mp_leg(out, "sample", lambda: {"folder": inference.main(sample)})
    folder = out["sample"]["folder"]
    moved = os.path.join(tmp, "mp_moved")
    barrier("moved")
    if rank == 0:  # batch MP_RESUME_BATCH's PNGs out of the folder, kept for the pixel check
        os.makedirs(moved)
        for i in range(MP_RESUME_BATCH * MP_BATCH, (MP_RESUME_BATCH + 1) * MP_BATCH):
            shutil.move(os.path.join(folder, f"{i:06d}.png"), moved)
    barrier("moved")
    _mp_leg(out, "resume", lambda: {"folder": inference.main(sample)})
    out["pngs"] = sorted(int(f[:-4]) for f in os.listdir(folder) if f.endswith(".png"))
    # a complete folder is skipped whole, so the refusal is shown with the
    # last PNG held out of it
    last = os.path.join(folder, f"{MP_FID - 1:06d}.png")
    barrier("held")
    if rank == 0:
        shutil.move(last, tmp)
    barrier("held")
    try:
        inference.main(["--config", paths["sample_batch4"], "--skip_fid"])
        out["refused"] = None
    except SystemExit as e:
        out["refused"] = str(e)
    barrier("refused")
    if rank == 0:
        shutil.move(os.path.join(tmp, os.path.basename(last)), folder)
    gc.collect()
    torch.cuda.empty_cache()

    def train():
        res = train_dit.main(["--config", paths["dit_dp2"], "--dp", "2"])
        torch.save(res["state"].model.state_dict(), os.path.join(tmp, f"mp_dit_rank{rank}.pt"))
        return {"history": res["history"]}

    _mp_leg(out, "train", train)
    _mp_leg(out, "train_restart", lambda: {"history": train_dit.main(
        ["--config", paths["dit_dp2"], "--dp", "2", "--max_steps", str(MP_RESTART)])["history"]})
    gc.collect()
    torch.cuda.empty_cache()
    _mp_leg(out, "extract", lambda: {"folder": extract_features.main(
        ["--config", paths["extract"], "--batch", str(EXTRACT_BATCH), "--limit", str(MP_EXTRACT_LIMIT)])})
    _mp_leg(out, "evaluate", lambda: {"reports": evaluate_tokenizer.main(
        ["--config", paths["extract"], "--data_path", origin, "--output_path", os.path.join(tmp, "mp_rfid"),
         "--batch", str(EVAL_BATCH), "--limit", str(EVAL_IMAGES)])})
    out["native_pngs"] = dict(native_io.WRITTEN)
    with open(os.path.join(tmp, f"mp_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _mp_nccl(rank: int, port: int, tmp: str, paths: dict) -> None:
    """The training CLI in one process (spawned) for MP_STEPS steps under an
    NCCL group of one (DDP's buckets and all-reduce on the card)."""
    import torch.distributed as dist

    from ldmae_tpu_torch.cli import train_dit
    from ldmae_tpu_torch.parallel import init_distributed_mode

    out = {}
    init_distributed_mode(backend="nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0, local_rank=0)
    _mp_leg(out, "nccl", lambda: {"history": train_dit.main(["--config", paths["dit_nccl"]])["history"],
                                  "backend": dist.get_backend()})
    dist.destroy_process_group()
    with open(os.path.join(tmp, "mp_nccl.json"), "w") as f:
        json.dump(out, f)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _steady_sps(history: list) -> float:
    """steps/s of the log windows after the first (which holds the warm-up)."""
    steady = history[1:]
    return sum(h["steps_per_sec"] * h["seconds"] for h in steady) / sum(h["seconds"] for h in steady)


def multiproc_phase(dev, smi: str, tmp: str, origin: str) -> dict:
    """The multi-process slice on the one card: two ranks (torch.multiprocessing,
    gloo, LOCAL_RANK 0 each) through the sampling CLI (coverage, per-rank
    launch counts, the batch-level resume pixel for pixel, the manifest's
    refusal), the DiT training CLI under --dp 2 (the ranks' weights equal, the
    checkpoint against one process on the concatenated batches, with a
    control, the restart), extraction and tokenizer evaluation (rank names,
    the global --limit, the statistics, the metrics against one process);
    then DDP at world 1 on NCCL against the plain CLI. Returns the
    ``{"multiproc": ...}`` record."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from PIL import Image

    from ldmae_tpu_torch.cli import evaluate_tokenizer, train_dit
    from ldmae_tpu_torch.cli.train_dit import warm_start_
    from ldmae_tpu_torch.core.config import LDMAEConfig
    from ldmae_tpu_torch.data.latent_dataset import ImgLatentDataset, _load_stats
    from ldmae_tpu_torch.models import LightningDiT, permute_qk_for_half_rope, seeded_init_
    from ldmae_tpu_torch.train import init_train_state, make_optimizer
    from ldmae_tpu_torch.train.train_dit import build_from_config, spec_from_config

    phase_t0 = time.perf_counter()
    data = write_latent_shards(os.path.join(tmp, "mp_train_latents"))
    ImgLatentDataset(data, latent_norm=True)  # latents_stats.pt first, so no rank's dataset draws for it
    weights = os.path.join(tmp, "mp_seeded.pt")
    paths = _mp_configs(tmp, origin, data, weights)
    spec = spec_from_config(LDMAEConfig.from_yaml(paths["dit_dp2"]))
    torch.save({"model": seeded_init_(LightningDiT(spec, device="cpu"), 3).state_dict()}, weights)

    log(f"[multiproc] two ranks on the card (torch.multiprocessing, gloo, LOCAL_RANK 0 each): cli.inference "
        f"(B/1 + VMAE f8d16_prev, seeded, bf16, {MP_SAMPLE_STEPS} steps, CFG {CFG_SCALE} on [{CFG_START}, 1], "
        f"shift {SHIFT}; per_proc_batch_size {MP_BATCH}, fid_num {MP_FID}), its resume with batch {MP_RESUME_BATCH}'s PNGs moved "
        f"away, a rerun at per_proc_batch_size {MP_BATCH // 2}; cli.train_dit --dp 2 (B/1, global batch "
        f"{MP_TRAIN_BATCH}, {MP_STEPS} steps, restart to {MP_RESTART}); cli.extract_features --limit "
        f"{MP_EXTRACT_LIMIT}; cli.evaluate_tokenizer on {EVAL_IMAGES}")
    t0 = time.perf_counter()
    mp.start_processes(_mp_rank, args=(_free_port(), tmp, origin, paths), nprocs=2, join=True,
                       start_method="spawn")
    two_rank_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"mp_rank{r}.json")) as f:
            ranks.append(json.load(f))

    # (a) sampling: coverage, manifest, launches per rank, the resume, the refusal
    folder = ranks[0]["sample"]["folder"]
    idx = ranks[0]["pngs"]  # after the resume
    with open(os.path.join(folder, "resume_manifest.json")) as f:
        manifest = json.load(f)
    per_batch = _reg_counts(DEPTH, MP_SAMPLE_STEPS, decode=True)
    n_batches = (MP_FID + MP_BATCH - 1) // MP_BATCH
    for r in range(2):
        mine = len(range(r, n_batches, 2))
        resumed = int(r == MP_RESUME_BATCH % 2)
        for leg, n in (("sample", mine), ("resume", resumed)):
            want = {k: v * n for k, v in per_batch.items()}
            if ranks[r][leg]["counts"] != want:
                raise SystemExit(f"multiproc {leg}, rank {r}: launches {ranks[r][leg]['counts']} != {want}")
    moved = os.path.join(tmp, "mp_moved")
    pixel_diff = max(
        int(np.abs(np.asarray(Image.open(os.path.join(moved, f)), np.int16)
                   - np.asarray(Image.open(os.path.join(folder, f)), np.int16)).max())
        for f in sorted(os.listdir(moved)))
    refused = [ranks[r]["refused"] or "" for r in range(2)]
    sample_ok = (idx == list(range(MP_FID)) and manifest["world"] == 2 and len(os.listdir(moved)) == MP_BATCH
                 and all("per_proc_batch_size was 8, now 4" in m for m in refused))
    img_s = [len(range(r, n_batches, 2)) * MP_BATCH / ranks[r]["sample"]["seconds"] for r in range(2)]
    log(f"  sampling: PNG indices 0-{MP_FID - 1} each once: {idx == list(range(MP_FID))}; manifest {manifest}; "
        f"launches per rank exact (rank 0: 3 batches, rank 1: 2, each {per_batch}); images/s a rank (the CLI "
        f"call, build included) {[round(v, 4) for v in img_s]}, both ranks {MP_FID / max(ranks[r]['sample']['seconds'] for r in range(2)):.4f}; "
        f"peak memory a rank {[round(ranks[r]['sample']['peak_gb'], 3) for r in range(2)]} GB")
    log(f"  resume: batch {MP_RESUME_BATCH} (rank {MP_RESUME_BATCH % 2}) resampled alone "
        f"({MP_BATCH} generated + {MP_FID - MP_BATCH} resumed), {max(ranks[r]['resume']['seconds'] for r in range(2)):.2f} s; "
        f"max |pixel difference| against the first run {pixel_diff} (must be 0); per_proc_batch_size {MP_BATCH // 2} "
        f"refused on both ranks: {refused[0][:90]!r}...")
    if not sample_ok or pixel_diff != 0:
        raise SystemExit("multiproc sampling: coverage, manifest, resume pixels or the refusal failed")

    # (b) DiT training under --dp 2
    want_train, want_restart = _counts_of("half", MP_STEPS), _counts_of("half", MP_RESTART - MP_STEPS)
    for r in range(2):
        for leg, want in (("train", want_train), ("train_restart", want_restart)):
            if ranks[r][leg]["counts"] != want:
                raise SystemExit(f"multiproc {leg}, rank {r}: launches {ranks[r][leg]['counts']} != {want}")
    sds = [torch.load(os.path.join(tmp, f"mp_dit_rank{r}.pt"), weights_only=True) for r in range(2)]
    ranks_equal = all(torch.equal(sds[0][k], sds[1][k]) for k in sds[0])
    hist = ranks[0]["train"]["history"]
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) for h in hist)
    config = LDMAEConfig.from_yaml(paths["dit_dp2"])
    seed = config.train.global_seed

    def replay(order):
        """One process, MP_STEPS steps on each step's two rank slices
        concatenated in ``order``, seeded as the CLI seeds each step."""
        spec_, model, _, step_fn = build_from_config(config, dev, torch.Generator().manual_seed(seed))
        warm_start_(model, weights)
        model.load_state_dict(permute_qk_for_half_rope(model.state_dict(), spec_), strict=True)
        state = init_train_state(model, make_optimizer(model.parameters(), config.optimizer.lr,
                                                       config.optimizer.beta2))
        streams = [ImgLatentDataset(data, latent_norm=True, sample=False, seed=seed).iter_batches(
            MP_TRAIN_BATCH // 2, shuffle=True, seed=seed, process_index=r, process_count=2) for r in range(2)]
        gen = torch.Generator(device=dev)
        for step in range(MP_STEPS):
            parts = [next(it) for it in streams]
            x = torch.from_numpy(np.concatenate([parts[r]["x"] for r in order])).to(dev)[None]
            y = torch.from_numpy(np.concatenate([parts[r]["y"] for r in order])).to(dev)[None]
            gen.manual_seed((seed + 1) * 1_000_003 + step)
            step_fn(state, {"x": x, "y": y}, gen)
        return permute_qk_for_half_rope({k: v.detach().cpu() for k, v in model.state_dict().items()}, spec_,
                                        inverse=True)

    ckpt = torch.load(os.path.join(tmp, "mp_out", "dit_dp2", "checkpoints", f"{MP_STEPS:07d}.pt"), weights_only=True)

    def worst(ref):
        errs = {k: float((ckpt["model"][k].double() - v.double()).norm() / v.double().norm().clamp_min(1e-30))
                for k, v in ref.items() if v.is_floating_point()}
        k = max(errs, key=errs.get)
        return errs[k], k

    err, leaf = worst(replay((0, 1)))
    control, cleaf = worst(replay((1, 0)))  # each rank's latents with the other rank's noise rows
    with open(os.path.join(tmp, "mp_out", "dit_dp2", "log.txt")) as f:
        resumed = f"resumed from step {MP_STEPS}" in f.read()
    dp2_sps = _steady_sps(hist)
    log(f"  training: launches per rank exact ({MP_STEPS} steps: {want_train}); the ranks' weights bitwise equal: "
        f"{ranks_equal}; losses {[round(h['loss'], 5) for h in hist]}; the step-{MP_STEPS} checkpoint against one "
        f"process on the concatenated batches: worst leaf rel L2 {err:.3g} ({leaf}), bound {MP_TRAIN_REL_L2}; the "
        f"control (the halves swapped) {control:.3g} ({cleaf}), must exceed it; restart: resumed from step "
        f"{MP_STEPS}: {resumed}; {dp2_sps:.4f} steps/s a rank (steady, two ranks sharing the card); peak memory a "
        f"rank {[round(ranks[r]['train']['peak_gb'], 3) for r in range(2)]} GB")
    if not (ranks_equal and finite and err <= MP_TRAIN_REL_L2 < control and resumed):
        raise SystemExit("multiproc training: the ranks, the checkpoint, the control or the restart failed")

    # (c) extraction and tokenizer evaluation
    ext = ranks[0]["extract"]["folder"]
    names = sorted(os.listdir(ext))
    sizes = [int(_load_shard_len(os.path.join(ext, f"latents_rank{r:02d}_shard000.safetensors"))) for r in range(2)]
    stats = _load_stats(os.path.join(ext, "latents_stats.pt"))
    again = ImgLatentDataset(ext, latent_norm=False, sample=True).compute_latent_stats()
    stats_ok = all(np.array_equal(stats[k], again[k]) for k in ("mean", "std"))
    want_names = ["latents_rank00_shard000.safetensors", "latents_rank01_shard000.safetensors", "latents_stats.pt"]
    pngs_ok = all(sorted(os.listdir(os.path.join(tmp, "mp_rfid", d))) == sorted(
        f"{p}_rank_{r}_{i}.png" for r in range(2) for i in range(EVAL_IMAGES // 2))
        for d, p in (("reference", "ref_image"), ("vmae_f8d16_0.0", "decoded_image")))
    (two,) = ranks[0]["evaluate"]["reports"]
    real_fid = evaluate_tokenizer.calculate_fid_given_paths
    evaluate_tokenizer.calculate_fid_given_paths = lambda paths_, **kw: 0.0  # the metrics alone
    try:
        (one,) = evaluate_tokenizer.main(["--config", paths["extract"], "--data_path", origin, "--output_path",
                                          os.path.join(tmp, "mp_rfid_one"), "--batch", str(EVAL_BATCH), "--limit",
                                          str(EVAL_IMAGES)])
    finally:
        evaluate_tokenizer.calculate_fid_given_paths = real_fid
    rel = {k: abs(two[k] - one[k]) / abs(one[k]) for k in ("psnr", "lpips", "ssim")}
    log(f"  extraction: {names}, {sizes} latents a rank of --limit {MP_EXTRACT_LIMIT}; statistics equal to their "
        f"recomputation over both shards: {stats_ok}; {MP_EXTRACT_LIMIT / max(ranks[r]['extract']['seconds'] for r in range(2)):.2f} "
        f"images/s for the two-rank call")
    log(f"  tokenizer evaluation: rank-named PNGs {EVAL_IMAGES // 2} a rank: {pngs_ok}; rFID {two['rfid']:.4f} on rank "
        f"0 (rank 1 reports {ranks[1]['evaluate']['reports']}); PSNR, LPIPS, SSIM over both ranks against one process "
        f"on the same images: relative differences {rel} (bound {MP_METRIC_REL})")
    ext_ok = (names == want_names and sizes == [MP_EXTRACT_LIMIT // 2] * 2 and stats_ok and pngs_ok
              and ranks[1]["evaluate"]["reports"] == [None] and math.isfinite(two["rfid"]))
    native = [ranks[r]["native_pngs"] for r in range(2)]
    log(f"  PNGs written a rank by route: {native}")
    if not ext_ok or max(rel.values()) > MP_METRIC_REL or not all(n["native"] > 0 and n["pil"] == 0 for n in native):
        raise SystemExit("multiproc extraction / evaluation: names, budget, statistics, metrics or the native "
                         "writer failed")

    # DDP at world 1 on NCCL (a spawned process), beside the plain CLI here
    log(f"[multiproc] world 1 on NCCL: cli.train_dit {MP_STEPS} steps with no process group (this process), then "
        f"{MP_STEPS} steps under an NCCL group of one (DDP, a spawned process)")
    nccl = {}
    _mp_leg(nccl, "plain", lambda: {"history": train_dit.main(["--config", paths["dit_plain"]])["history"]})
    torch.cuda.empty_cache()
    mp.start_processes(_mp_nccl, args=(_free_port(), tmp, paths), nprocs=1, join=True, start_method="spawn")
    with open(os.path.join(tmp, "mp_nccl.json")) as f:
        nccl |= json.load(f)
    for leg in ("plain", "nccl"):
        if nccl[leg]["counts"] != want_train:
            raise SystemExit(f"multiproc {leg}: launches {nccl[leg]['counts']} != {want_train}")
    plain_sps, nccl_sps = _steady_sps(nccl["plain"]["history"]), _steady_sps(nccl["nccl"]["history"])
    log(f"  backend {nccl['nccl']['backend']}; launches exact in both; steady steps/s: plain {plain_sps:.4f}, DDP on "
        f"NCCL {nccl_sps:.4f} (DDP/plain {nccl_sps / plain_sps:.4f}); peak memory {nccl['plain']['peak_gb']:.3f} / "
        f"{nccl['nccl']['peak_gb']:.3f} GB; the two-rank spawn took {two_rank_s:.2f} s; on {smi}")
    if nccl["nccl"]["backend"] != "nccl":
        raise SystemExit("multiproc: the world-1 leg did not run on NCCL")
    phase_s = time.perf_counter() - phase_t0
    log(f"  the multi-process phase took {phase_s:.2f} s")
    return {
        "phase_s": phase_s,
        "sample_img_per_s_rank": img_s,
        "sample_img_per_s": MP_FID / max(ranks[r]["sample"]["seconds"] for r in range(2)),
        "resume_s": max(ranks[r]["resume"]["seconds"] for r in range(2)),
        "resume_pixel_diff": pixel_diff,
        "ddp_steps_per_s_world1_nccl": nccl_sps, "plain_steps_per_s": plain_sps,
        "ddp_steps_per_s_world2_gloo": dp2_sps,
        "train_worst_rel_l2": err, "train_control_rel_l2": control,
        "metric_rel_diff": rel,
        "peak_gb_rank": {leg: [ranks[r][leg]["peak_gb"] for r in range(2)]
                         for leg in ("sample", "train", "extract", "evaluate")},
        "native_png_writer": all(n["native"] > 0 for n in native),
        "two_rank_s": two_rank_s,
        "card": smi,
    }


# -- the sampler slice: SDE Euler / Heun, RK4, dopri5, the likelihood and the
# sdpa attention impl through the sampling entry points, B/1 at full width and
# depth, batch 8 (16 under CFG)
# SDE Euler and the ODE Euler turns under flash_rope and sdpa cut from 250
# steps to keep the script inside its time limit
SDE_STEPS, HEUN_STEPS, RK4_STEPS, LIK_STEPS, LIK_GATE_STEPS, ODE_STEPS = 50, 50, 50, 20, 5, 50
DOPRI5_MAX_STEPS = 100  # attempted steps of the bf16 dopri5 leg (the solver's default is 1000)
DOPRI5_GATE_MAX_STEPS = 8  # of the fp32 kernels-vs-plain dopri5 comparison
# The SDE legs' transport: the linear path with noise prediction and eps 1e-3,
# as the JAX package's own SDE tests run it; the production velocity
# transport's eps 0 starts the SBDM SDE at t0 = 0, where ICPlan's 1/t drift
# ratio is infinite (in the reference too). The DiT's forward, and so its
# kernels, are the same whatever the prediction type.
SDE_TRANSPORT = dict(path_type="Linear", prediction="noise", train_eps=1e-3, sample_eps=1e-3)
SAMPLER_LEGS = {"sde_euler": ("SDE", "euler"), "sde_heun": ("SDE", "heun"), "rk4": ("ODE", "rk4"),
                "dopri5": ("ODE", "dopri5"), "sdpa": ("ODE", "euler")}
SAMPLER_LAT_REL = 5e-2  # 10-step latents, kernels vs plain: the ODE gate's bound
DOPRI5_F32_REL = 1e-3  # fp32 final latents, kernels vs plain (summation order only)
# The likelihood, kernels vs plain, both bf16 compute on an fp32 state: the
# per-sample logp is about prior(z) (-2.3e4 at 16,384 dimensions), so z's
# bf16 roundings move it by about 1e-5 of itself: bound 1e-4. The divergence
# integral prior(z) - logp is a few thousandths of logp, so it is held
# apart, relative to its own scale: bound 5e-2 (bf16 noise in eps^T J eps
# summed over 16,384 terms); the control without it (eps = 0) reads 1 there.
LIK_LOGP_REL, LIK_DIV_REL = 1e-4, 5e-2


def _sampler_launches(forwards: int, attn: str = "flash_attention_rope", decode: bool = True) -> dict:
    """Exact counts of ``forwards`` B/1 forwards (bf16, fused adaLN and MLP)
    and a VMAE decode under flash_rope (#2's resident kernel) or sdpa."""
    n = forwards * DEPTH
    out = _NONE | {"fused_norm_modulate": 2 * n, "fused_matmul_silu": n,
                   "dense_bias_f32": forwards * _DENSE_FWD + (_DENSE_DECODE if decode else 0)}
    if attn:
        out[attn] = n
    if decode and attn:
        out["flash_attention_resident"] = DEC_DEPTH
    return out


_LIK_EVALS = (LIK_STEPS - 1) * 4
EXPECTED_LAUNCHES |= {
    "sde_euler": _sampler_launches(SDE_STEPS),  # 249 steps and the Mean step: one forward each
    "sde_heun": _sampler_launches((HEUN_STEPS - 1) * 2 + 1),
    "rk4": _sampler_launches((RK4_STEPS - 1) * 4),
    "ode_euler": _sampler_launches(ODE_STEPS - 1),
    "sdpa": _sampler_launches(ODE_STEPS - 1, attn=None),
    # unguided batch of 8, the MLP xla (#4 has no backward): per drift
    # evaluation a forward (#1, #3 twice, dense 5 + 5 a block), #6 a block and
    # #3's backward twice a block
    "likelihood": _NONE | {"flash_attention_rope": _LIK_EVALS * DEPTH, "flash_attention_rope_bwd": _LIK_EVALS * DEPTH,
                           "fused_norm_modulate": 2 * _LIK_EVALS * DEPTH, "dense_bias_f32": _LIK_EVALS * (5 + 5 * DEPTH),
                           "fused_norm_modulate_bwd_kernel": 2 * _LIK_EVALS * DEPTH},
}


def sampler_leg(spec, dev, leg: str, steps: int, kernels: bool = True, dtype=None, decode_fn=None):
    """make_sample_fn for one leg of SAMPLER_LEGS: CFG 10 on [0.10, 1], the
    first 3 channels guided, timestep shift 0.3 (the ODE legs), the kernel
    impls (sdpa: the library attention) or the plain xla ones."""
    import torch

    from ldmae_tpu_torch.eval.sampling import make_sample_fn
    from ldmae_tpu_torch.transport import create_transport

    mode, method = SAMPLER_LEGS[leg]
    transport = (create_transport(**SDE_TRANSPORT) if mode == "SDE"
                 else create_transport("Linear", "velocity", use_lognorm=True))
    impls = (dict(attn_impl="sdpa" if leg == "sdpa" else "flash_rope", adaln_impl="fused", mlp_impl="fused")
             if kernels else dict(attn_impl="xla", adaln_impl="xla", mlp_impl="xla"))
    return make_sample_fn(
        spec, transport, num_steps=steps, sampling_method=method, mode=mode, timestep_shift=SHIFT,
        cfg_scale=CFG_SCALE, cfg_interval=True, cfg_interval_start=CFG_START, cfg_channels=3,
        compute_dtype=dtype or torch.bfloat16, rope_layout="half", device=dev, vae_decode_images_fn=decode_fn,
        **impls)


@contextlib.contextmanager
def dopri5_cap(max_steps: int):
    """The sampler's dopri5 with ``max_steps`` attempted steps (its tallies
    still counted on ``adaptive.dopri5``)."""
    import functools

    from ldmae_tpu_torch.transport import adaptive, samplers

    samplers.dopri5 = functools.partial(adaptive.dopri5, max_steps=max_steps)
    try:
        yield
    finally:
        samplers.dopri5 = adaptive.dopri5


def timed_leg(name: str, fn, counts_path=None):
    """One batch through ``fn`` (returning images or latents), launches
    counted from 0 and, with ``counts_path``, checked exactly; returns
    (output, launch counts, seconds)."""
    import torch

    from ldmae_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    if counts_path:
        check_counts(counts_path, counts)
    log(f"  {name}: {seconds:.4f} s per batch of {BATCH}, {BATCH / seconds:.4f} images/s")
    return out, counts, seconds


def check_images(what: str, imgs) -> None:
    import torch

    if imgs.shape != (BATCH, 256, 256, 3) or imgs.dtype != torch.uint8:
        raise SystemExit(f"{what}: images {tuple(imgs.shape)} {imgs.dtype}, expected ({BATCH}, 256, 256, 3) uint8")
    if not float(imgs.float().std()) > 1.0:
        raise SystemExit(f"{what}: images are flat: the pipeline did not move them")


def sampler_gates(spec, bundle, y, dev) -> dict:
    """SHORT_STEPS-step latents of the SDE Euler, SDE Heun, RK4 and sdpa legs
    with the kernels against the same leg under xla/xla/xla, the same z and
    (SDE) the same injected noise, within SAMPLER_LAT_REL of their scale;
    the control feeds the plain leg another SDE noise draw (the ODE legs:
    another z) and must read above the bound."""
    import torch

    latents = bundle | {"vae": None}
    gen = torch.Generator(device=dev)
    z = torch.randn(BATCH, 16, 32, 32, generator=gen.manual_seed(2), device=dev)
    z_other = torch.randn(BATCH, 16, 32, 32, generator=gen.manual_seed(3), device=dev)

    def draws(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(2 * BATCH, 16, 32, 32, generator=g, device=dev, dtype=torch.bfloat16)
                for _ in range(SHORT_STEPS - 1)]

    readings = {}
    for leg in ("sde_euler", "sde_heun", "rk4", "sdpa"):
        sde = SAMPLER_LEGS[leg][0] == "SDE"
        kw, other = (dict(sde_noise=draws(4)), dict(z=z, sde_noise=draws(5))) if sde else ({}, dict(z=z_other))
        lat_k = sampler_leg(spec, dev, leg, SHORT_STEPS)(latents, y, z=z, **kw)
        plain = sampler_leg(spec, dev, leg, SHORT_STEPS, kernels=False)
        lat_x = plain(latents, y, z=z, **kw)
        lat_c = plain(latents, y, **other)
        if not (torch.isfinite(lat_k).all() and lat_k.shape == (BATCH, 16, 32, 32)):
            raise SystemExit(f"{leg}: latents are not finite ({BATCH}, 16, 32, 32)")
        scale = float(lat_x.abs().max())
        rel, ctl = float((lat_k - lat_x).abs().max()) / scale, float((lat_c - lat_k).abs().max()) / scale
        ok = rel <= SAMPLER_LAT_REL < ctl
        log(f"[samplers] {SHORT_STEPS} steps, {leg}: kernels vs xla max rel err {rel:.6g} (bound {SAMPLER_LAT_REL:g}; "
            f"latent scale {scale:.6g}); control ({'another SDE noise draw' if sde else 'another z'}) {ctl:.6g} "
            f"(must exceed the bound) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{leg}: the kernel path and the plain path disagree, or the control passed")
        readings[leg] = {"rel": rel, "control": ctl, "scale": scale}
    return readings


def dopri5_gate(spec, bundle, y, dev) -> dict:
    """fp32 compute (state and DiT): DOPRI5_GATE_MAX_STEPS attempted dopri5
    steps with the fp32 kernels against the fp32 plain impls from the same
    z; the final latents within DOPRI5_F32_REL of their scale, and the two
    runs' accepted/rejected tallies reported (equal when no decision sits on
    a rounding)."""
    import torch

    from ldmae_tpu_torch.transport import adaptive

    latents = bundle | {"vae": None}
    z = torch.randn(BATCH, 16, 32, 32, generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    out, tallies = {}, {}
    with dopri5_cap(DOPRI5_GATE_MAX_STEPS):
        for kernels in (True, False):
            adaptive.dopri5.accepted = adaptive.dopri5.rejected = 0
            out[kernels] = sampler_leg(spec, dev, "dopri5", 2, kernels=kernels, dtype=torch.float32)(latents, y, z=z)
            tallies[kernels] = (adaptive.dopri5.accepted, adaptive.dopri5.rejected)
    scale = float(out[False].abs().max())
    rel = float((out[True] - out[False]).abs().max()) / scale
    ok = rel <= DOPRI5_F32_REL and bool(torch.isfinite(out[True]).all())
    log(f"[samplers] dopri5 fp32, {DOPRI5_GATE_MAX_STEPS} attempted steps: kernels vs xla max rel err {rel:.6g} "
        f"(bound {DOPRI5_F32_REL:g}); accepted/rejected kernels {tallies[True]}, plain {tallies[False]} "
        f"({'matched' if tallies[True] == tallies[False] else 'differ'}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("dopri5: the fp32 kernel path and the plain path disagree")
    return {"rel": rel, "tally_kernels": tallies[True], "tally_plain": tallies[False]}


def likelihood_run(spec, bundle, x, y, dev, steps: int, kernels: bool = True, eps=None):
    """(logp, z) of the fp32 latents x through the probability-flow ODE
    (rk4, ``steps`` grid nodes, the production velocity transport), the DiT
    in bf16: flash_rope (#1 forward, #6 backward), the fused adaLN (#3 and
    its plain fp32 backward), the MLP xla (#4 is forward only); or all xla."""
    import torch

    from ldmae_tpu_torch.transport import create_transport
    from ldmae_tpu_torch.transport.adaptive import make_likelihood_fn

    dit = bundle["dit"]
    impls = (dict(attn_impl="flash_rope", adaln_impl="fused", mlp_impl="xla") if kernels
             else dict(attn_impl="xla", adaln_impl="xla", mlp_impl="xla"))

    def model_fn(xx, t, y):
        return dit(xx, t, y, compute_dtype=torch.bfloat16, rope_layout="half", **impls).to(xx.dtype)

    fn = make_likelihood_fn(create_transport("Linear", "velocity", use_lognorm=True), steps, "rk4")
    if eps is None:
        eps = torch.randint(0, 2, x.shape, generator=torch.Generator(device=dev).manual_seed(6), device=dev) * 2.0 - 1
    return fn(x, model_fn, eps=eps, module=dit, y=y)


def likelihood_gate(spec, bundle, x, y, dev) -> dict:
    """LIK_GATE_STEPS grid nodes: per-sample logp of the kernel path against
    the plain path within LIK_LOGP_REL, and the divergence integral
    prior(z) - logp within LIK_DIV_REL of its scale; the control drops the
    divergence (eps = 0) and must read above that bound."""
    import torch

    from ldmae_tpu_torch.transport.adaptive import prior_logp

    (lk, zk), (lx, zx) = (likelihood_run(spec, bundle, x, y, dev, LIK_GATE_STEPS, kernels=k) for k in (True, False))
    lc, zc = likelihood_run(spec, bundle, x, y, dev, LIK_GATE_STEPS, eps=torch.zeros_like(x))
    div_k, div_x, div_c = (prior_logp(z) - lp for z, lp in ((zk, lk), (zx, lx), (zc, lc)))
    div_scale = float(div_x.abs().max())
    logp_rel = float(((lk - lx).abs() / lx.abs()).max())
    div_rel, ctl = (float((d - div_x).abs().max()) / div_scale for d in (div_k, div_c))
    z_rel = float((zk - zx).abs().max() / zx.abs().max())
    ok = logp_rel <= LIK_LOGP_REL and div_rel <= LIK_DIV_REL < ctl and bool(torch.isfinite(lk).all())
    log(f"[samplers] likelihood, {LIK_GATE_STEPS} nodes: logp kernels {[round(v, 3) for v in lk.tolist()]}, "
        f"plain {[round(v, 3) for v in lx.tolist()]}; max rel err {logp_rel:.6g} (bound {LIK_LOGP_REL:g}); "
        f"divergence integral plain {[round(v, 4) for v in div_x.tolist()]}, kernels' max err {div_rel:.6g} of its "
        f"scale (bound {LIK_DIV_REL:g}); control without it {ctl:.6g} (must exceed); z max rel err {z_rel:.6g} "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("likelihood: the kernel path and the plain path disagree, or the control passed")
    return {"logp_rel": logp_rel, "div_rel": div_rel, "control": ctl, "z_rel": z_rel, "div_scale": div_scale}


def samplers_phase(dev) -> dict:
    """Each leg of SAMPLER_LEGS and the likelihood at full width and depth,
    batch 8, timed with exact launch counts (dopri5's from its tallies); the
    SDE resume pixel for pixel; the bf16 ODE Euler pipeline under sdpa beside
    flash_rope's, alternated; then the gates."""
    import torch

    from ldmae_tpu_torch.transport import adaptive

    t_phase = time.perf_counter()
    spec, bundle = build_models(dev)
    y = torch.arange(BATCH, device=dev) * 125 % 1000
    record = {"legs": {}, "counts": {}}

    def keep(leg, counts, seconds, **extra):
        record["legs"][leg] = {"seconds": seconds, "images_per_s": BATCH / seconds} | extra
        record["counts"][leg] = counts

    log(f"[samplers] LightningDiT-B/1 + VMAE f8d16_prev, batch {BATCH}, CFG {CFG_SCALE} on [{CFG_START}, 1], "
        f"bf16; SDE legs on the Linear/noise transport, eps 1e-3")
    for leg, steps in (("sde_euler", 4), ("sde_heun", 4), ("rk4", 4)):  # warm-up
        sampler_leg(spec, dev, leg, steps)(bundle | {"vae": None}, y, generator=torch.Generator(device=dev).manual_seed(1))

    # SDE Euler (Mean last step), with its latents kept from the decode
    kept = []

    def decode_keeping(v, lat):
        kept.append(lat)
        return v.decode_to_images(lat, compute_dtype=torch.bfloat16, attn_impl="flash_rope")

    fn = sampler_leg(spec, dev, "sde_euler", SDE_STEPS, decode_fn=decode_keeping)
    imgs, counts, sec = timed_leg(f"SDE Euler, {SDE_STEPS} steps, Mean last step",
                                  lambda: fn(bundle, y, generator=torch.Generator(device=dev).manual_seed(0)),
                                  "sde_euler")
    check_images("sde_euler", imgs)
    sde_scale = float(kept[0].abs().max())
    keep("sde_euler", counts, sec, latent_scale=sde_scale)
    # the resume: a batch from a generator seeded alike is the same batch;
    # control: the same z (the generator's first draws), other SDE noise
    again = fn(bundle, y, generator=torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(0)
    z0 = torch.randn(BATCH, 16, 32, 32, generator=g, device=dev)
    ctl = fn(bundle, y, z=z0, sde_noise=[torch.randn(2 * BATCH, 16, 32, 32, generator=g, device=dev,
                                                     dtype=torch.bfloat16) * -1 for _ in range(SDE_STEPS - 1)])
    same, ctl_diff = int((again.int() - imgs.int()).abs().max()), int((ctl.int() - imgs.int()).abs().max())
    log(f"  SDE resume: a second batch from manual_seed(0) differs by {same} levels (must be 0); the control with "
        f"the same z and negated SDE noise by {ctl_diff} (must be > 0) -> {'ok' if same == 0 < ctl_diff else 'FAIL'}")
    if not same == 0 < ctl_diff:
        raise SystemExit("SDE resume: the batch is not reproduced from its generator, or the control matched")
    record["sde_resume"] = {"max_level_diff": same, "control": ctl_diff}

    for leg, steps, what in (("sde_heun", HEUN_STEPS, f"SDE Heun, {HEUN_STEPS} steps"),
                             ("rk4", RK4_STEPS, f"ODE RK4, {RK4_STEPS} steps, shift {SHIFT}")):
        fn = sampler_leg(spec, dev, leg, steps)
        imgs, counts, sec = timed_leg(what, lambda: fn(bundle, y, generator=torch.Generator(device=dev).manual_seed(0)),
                                      leg)
        check_images(leg, imgs)
        keep(leg, counts, sec)

    # dopri5 (bf16, rtol 1e-3, atol 1e-6 as the sampling CLI runs it), capped
    fn = sampler_leg(spec, dev, "dopri5", 2)
    adaptive.dopri5.accepted = adaptive.dopri5.rejected = 0
    with dopri5_cap(DOPRI5_MAX_STEPS):
        imgs, counts, sec = timed_leg(f"ODE dopri5, at most {DOPRI5_MAX_STEPS} attempted steps",
                                      lambda: fn(bundle, y, generator=torch.Generator(device=dev).manual_seed(0)))
    acc, rej = adaptive.dopri5.accepted, adaptive.dopri5.rejected
    EXPECTED_LAUNCHES["dopri5"] = _sampler_launches(1 + 6 * (acc + rej))
    log(f"  dopri5: {acc} accepted, {rej} rejected steps (cap {DOPRI5_MAX_STEPS} attempted"
        f"{', reached' if acc + rej >= DOPRI5_MAX_STEPS else ''}): {1 + 6 * (acc + rej)} doubled forwards")
    check_counts("dopri5", counts)
    check_images("dopri5", imgs)
    keep("dopri5", counts, sec, accepted=acc, rejected=rej, max_steps=DOPRI5_MAX_STEPS)

    # the bf16 ODE Euler pipeline under sdpa beside flash_rope's, in turns
    fns = {"flash_rope": sampler(spec, ODE_STEPS, dev, kernels=True),
           "sdpa": sampler_leg(spec, dev, "sdpa", ODE_STEPS)}
    sampler_leg(spec, dev, "sdpa", 4)(bundle, y, generator=torch.Generator(device=dev).manual_seed(1))
    seconds = {"flash_rope": [], "sdpa": []}
    images = {}
    for impl in ("flash_rope", "sdpa", "sdpa", "flash_rope"):
        out, counts, sec = timed_leg(f"ODE Euler {ODE_STEPS} steps (phased CFG) under {impl}",
                                     lambda: fns[impl](bundle, y, generator=torch.Generator(device=dev).manual_seed(0)),
                                     "sdpa" if impl == "sdpa" else "ode_euler")
        seconds[impl].append(sec)
        images[impl] = out
        if impl == "sdpa":
            record["counts"]["sdpa"] = counts
    check_images("sdpa", images["sdpa"])
    px = int((images["sdpa"].int() - images["flash_rope"].int()).abs().max())
    log(f"  sdpa vs flash_rope {ODE_STEPS}-step images, same noise: max difference {px} levels (bf16 roundings; "
        f"the 10-step gate below holds the latents)")
    record["legs"]["sdpa"] = {"seconds": seconds["sdpa"], "flash_rope_seconds": seconds["flash_rope"]}

    # the likelihood of the bf16 ODE pipeline's latents (fp32 state); the SDE
    # legs' latents grow to the scale printed above under the random
    # noise-predicting DiT, where an fp32 logp (about -|x|^2 / 2) no longer
    # resolves the divergence
    x = sampler(spec, ODE_STEPS, dev, kernels=True)(bundle | {"vae": None}, y,
                                                generator=torch.Generator(device=dev).manual_seed(0)).float()
    likelihood_run(spec, bundle, x, y, dev, 3)  # warm-up
    (logp, z), counts, sec = timed_leg(f"likelihood, rk4 over {LIK_STEPS} nodes ({_LIK_EVALS} drift evaluations), "
                                       f"unguided, fp32 state", lambda: likelihood_run(spec, bundle, x, y, dev, LIK_STEPS),
                                       "likelihood")
    if not (torch.isfinite(logp).all() and logp.shape == (BATCH,) and torch.isfinite(z).all()):
        raise SystemExit("likelihood: logp or z not finite")
    log(f"  logp per sample {[round(v, 3) for v in logp.tolist()]}; latent scale {float(x.abs().max()):.4g}; "
        f"grads of the DiT's parameters left unset: {all(p.grad is None for p in bundle['dit'].parameters())}")
    keep("likelihood", counts, sec, logp=logp.tolist())

    log(f"[samplers] gates: {SHORT_STEPS} steps, kernels vs plain")
    record["gates"] = sampler_gates(spec, bundle, y, dev)
    record["gates"]["dopri5"] = dopri5_gate(spec, bundle, y, dev)
    record["gates"]["likelihood"] = likelihood_gate(spec, bundle, x, y, dev)
    record["seconds"] = time.perf_counter() - t_phase
    log(f"[samplers] phase: {record['seconds']:.2f} s")
    del bundle
    torch.cuda.empty_cache()
    return record


def samplers_only(dev, smi: str) -> int:
    """``--samplers``: build, then the sampler phase alone."""
    import torch

    from ldmae_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    record = samplers_phase(dev)
    log(json.dumps({"samplers": record}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0



# -- phase 13: tensor parallelism. Two ranks share the card over gloo (NCCL
# refuses two ranks on one device) and run the sampling CLI under --tp 2 on
# LightningDiT-1p0B/1 at full width (D 1,536, 24 heads of 64, SwiGLU hidden
# 4,096), its depth cut from 24 to TP_DEPTH and its steps from 250 to
# TP_STEPS: over gloo every row-parallel partial (2 a block a forward, 100
# MB of fp32 at the doubled batch) crosses the host, 0.153 s each on an
# NVIDIA H100 80GB HBM3 at 700 W (scripts/gloo_cuda_probe.py). Batch
# TP_BATCH, phased CFG 10 on [0.10, 1], VMAE f8d16 decode on the group's
# first rank.
# (depth 4 and 5 steps keep the whole run within its time limit: at tp 2
# the gloo all-reduces, two a block, take the batch's time)
TP_MODEL, TP_DEPTH, TP_STEPS, TP_BATCH = "LightningDiT-1p0B/1", 4, 5, 8
# TP_STEPS-step latents at tp 2 against tp 1 in one process from the same noise,
# relative L2 ||tp2 - tp1|| / ||tp1||: the row-parallel fp32 sums
# reassociate and move bf16 roundings, which CFG 10 amplifies step by step;
# a w12 shard that is not gate-aligned pairs the wrong gate halves and must
# read above. Also printed against the DiT's movement of the latents,
# ||tp2 - tp1|| / ||tp1 - z||, the scale of the w8a8 gate (QUANT_REL_MAX)
TP_LAT_REL = 1e-2
_TP_FWD = TP_STEPS - 1  # DiT forwards of a batch (the last step evaluates nothing)


def _tp_counts(quant, lead: bool) -> dict:
    """Exact launches of one TP_STEPS batch on one rank under --tp 2: every
    rank runs the same DiT calls (a block's proj and w3 are row-parallel,
    its adaLN, qkv and w12 column-parallel), the group's first rank also
    decodes. A forward adds the patch embedding, the timestep MLP's two
    linears and the final layer's two (dense, whole on every rank)."""
    f, depth = _TP_FWD, TP_DEPTH
    if quant is None:
        c = {"flash_attention_rope": f * depth, "fused_norm_modulate": 2 * f * depth, "fused_matmul_silu": f * depth,
             "dense_bias_f32": f * (5 + 2 * depth), "dense_f32_out": 2 * f * depth}
    else:
        c = {"fused_norm_modulate_quant": 2 * f * depth, "flash_attention_rope": f * depth,
             "int8_dense": 3 * f * depth, "int8_dense_i32": f * depth, "silu_mul_amax": f * depth,
             "silu_mul_quant_scaled": f * depth, "dense_f32_out": f * depth, "dense_bias_f32": 5 * f}
    if lead:
        c["flash_attention_resident"] = DEC_DEPTH
        c["dense_bias_f32"] += _DENSE_DECODE
    return _NONE | c


def _tp_cut_depth() -> None:
    """The phase's depth cut, in this process's model registry (the CLI
    reads the depth from there)."""
    from ldmae_tpu_torch.models import lightningdit

    lightningdit._REGISTRY[TP_MODEL] = dict(lightningdit._REGISTRY[TP_MODEL], depth=TP_DEPTH)


def _tp_inputs(dev):
    import torch

    g = torch.Generator().manual_seed(21)
    z = torch.randn(TP_BATCH, 16, 32, 32, generator=g).to(dev)
    y = torch.randint(0, 1000, (TP_BATCH,), generator=g)
    return z, y


def _tp_configs(tmp: str) -> dict:
    import yaml

    paths = {}
    for leg, quant in (("bf16", None), ("w8a8", "w8a8")):
        cfg = _yaml_config(train={"global_seed": 0, "output_dir": os.path.join(tmp, "tp_out"), "exp_name": leg})
        cfg["ckpt_path"] = None  # seeded weights
        cfg["model"]["model_type"] = TP_MODEL
        cfg["vae"]["weight_path"] = ""
        cfg["sample"].update(num_sampling_steps=TP_STEPS, per_proc_batch_size=TP_BATCH, fid_num=TP_BATCH)
        cfg["parallel"]["quant"] = quant
        paths[leg] = os.path.join(tmp, f"tp_{leg}.yaml")
        with open(paths[leg], "w") as f:
            yaml.safe_dump(cfg, f)
    return paths


def _tp_latents(sample_fn, bundle, z, y) -> tuple:
    """(latents, seconds) of one batch from noise z, no decode."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = sample_fn(dict(bundle, vae=None), y, z=z)
    torch.cuda.synchronize()
    return lat.cpu(), time.perf_counter() - t0


def _tp_rank(rank: int, port: int, tmp: str, paths: dict) -> None:
    """One of two ranks on the card (spawned): the sampling CLI under --tp 2
    for each leg, launches counted, then the same pipeline's latents from a
    given noise at tp 2 (and, for bf16, with w12 sharded contiguously: the
    control)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch

    from ldmae_tpu_torch.cli import inference
    from ldmae_tpu_torch.core.config import LDMAEConfig
    from ldmae_tpu_torch.parallel import create_mesh, init_distributed_mode, shard_dit_for_tp_

    init_distributed_mode(backend="gloo")
    _tp_cut_depth()
    dev = torch.device("cuda", 0)
    z, y = _tp_inputs(dev)
    group = create_mesh(dp=-1, tp=2).get_group("tp")
    out = {}
    for leg in ("bf16", "w8a8"):
        _mp_leg(out, leg, lambda: {"folder": inference.main(["--config", paths[leg], "--tp", "2", "--skip_fid"])})
        sample_fn, bundle, _ = inference.build_pipeline(LDMAEConfig.from_yaml(paths[leg]), device=dev)
        dit = bundle["dit"]
        full_w12 = [{k: v.clone() for k, v in blk.mlp.w12.state_dict().items()} for blk in dit.blocks]
        shard_dit_for_tp_(dit, group)
        lat, sec = _tp_latents(sample_fn, bundle, z, y)
        torch.save(lat, os.path.join(tmp, f"tp_{leg}_rank{rank}.pt"))
        out[leg] |= {"latent_s": sec}
        if leg == "bf16":  # the control: [w1; w2] rows r of 2, the gate halves mispaired
            for blk, full in zip(dit.blocks, full_w12):
                rows = full["weight"].shape[0] // 2
                blk.mlp.w12.load_state_dict({k: v[rank * rows:(rank + 1) * rows] for k, v in full.items()})
            lat, _ = _tp_latents(sample_fn, bundle, z, y)
            torch.save(lat, os.path.join(tmp, f"tp_control_rank{rank}.pt"))
        del sample_fn, bundle, dit, full_w12
        torch.cuda.empty_cache()
    with open(os.path.join(tmp, f"tp_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def tp_kernel_phase(dev) -> dict:
    """The tensor-parallel kernel pieces at the per-rank shapes of 1p0B/1
    under tp 2, batch 8 doubled by CFG (M = 16,384 tokens): the fp32 and
    int32 partial epilogues at proj (K 768) and w3 (K 2,048) against their
    plain math, bit for bit where the math is the same, and #10's two halves
    against #10 on the whole row, bit for bit; #1 and #4 at their tp shapes.
    Returns name -> (max_abs_err, ms, plain_ms, library_ms, bound_ms,
    bound_by, parts)."""
    import torch

    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops import fused_adaln as fad
    from ldmae_tpu_torch.ops import linear as lin
    from ldmae_tpu_torch.ops import quant as qt
    from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

    g = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    def randq(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev, dtype=torch.int8)

    rows = {}
    m, d, hl = 2 * TP_BATCH * 1024, 1536, 2048  # tokens, width, a rank's SwiGLU hidden

    # -- the fp32 partial (bf16 row-parallel proj and w3)
    for what, k in (("proj", d // 2), ("w3", hl)):
        x, w = randn(m, k), randn(d, k, scale=k**-0.5)
        b = randn(d, scale=0.1, dtype=torch.float32)
        log(f"[tp kernel] dense_f32_out at {what}: x ({m},{k}) bf16, w ({d},{k}) bf16 -> fp32 ({m},{d})")
        out = lin.dense_f32_out(x, w)
        same = torch.equal(out.add(b).to(torch.bfloat16), lin.dense_bias_f32(x, w, b))
        log(f"  bf16(dense_f32_out + bias) == dense_bias_f32 bit for bit: {same}")
        if not same:
            raise SystemExit("dense_f32_out: its sums are not dense_bias_f32's")
        ref = lin.dense_f32_out_plain(x, w)
        # fp32 sums of the same products in another order: 1e-5 of the row's scale
        err = compare(f"dense_f32_out[{what}]", out, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
        ms = cuda_ms(lambda: lin.dense_f32_out(x, w), 20)
        plain_ms = cuda_ms(lambda: lin.dense_f32_out_plain(x, w), 5)
        try:  # cuBLAS bf16 x bf16 -> fp32, where this torch has it
            lib_ms = cuda_ms(lambda: torch.mm(x, w.t(), out_dtype=torch.float32), 20)
        except (TypeError, RuntimeError):
            lib_ms = None
        if what == "proj":
            rows["dense_f32_out"] = (err, ms, plain_ms, lib_ms, *bound((m * k + d * k) * 2 + m * d * 4, 2 * m * k * d),
                                     {})
        else:
            log(f"  dense_f32_out at w3: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms} ms")
        del x, w, out, ref

    # -- the int32 partial (w8a8 row-parallel w3)
    xq, wq = randq(m, hl), randq(d, hl)
    log(f"[tp kernel] int8_dense_i32 at w3: x_q ({m},{hl}) int8, w_q ({d},{hl}) int8 -> int32 ({m},{d})")
    acc = qt.int8_dense_i32(xq, wq)
    ref = torch._int_mm(xq, wq.t())
    same = torch.equal(acc, ref)
    p = qt.QLinear(wq, torch.rand(d, generator=g, device=dev) * 1e-2 + 1e-3, randn(d, scale=0.1, dtype=torch.float32))
    xs = torch.rand(m, 1, generator=g, device=dev) * 1e-2 + 1e-3
    dequant_same = torch.equal(qt._dequant(acc, xs, p, torch.bfloat16), qt.int8_dense(xq, xs, p, torch.bfloat16))
    log(f"  == torch._int_mm bit for bit: {same}; its dequant == int8_dense bit for bit: {dequant_same}")
    if not (same and dequant_same):
        raise SystemExit("int8_dense_i32: not the exact int32 product")
    ms = cuda_ms(lambda: qt.int8_dense_i32(xq, wq), 20)
    lib_ms = cuda_ms(lambda: torch._int_mm(xq, wq.t()), 20)
    rows["int8_dense_i32"] = (0.0, ms, lib_ms, lib_ms, *bound(m * hl + d * hl + m * d * 4, int8_ops=2 * m * hl * d), {})
    del xq, wq, acc, ref

    # -- #10's two halves: rank slices [x1_r | x2_r] of the whole row's [x1 | x2]
    x12 = randn(m, 4 * hl, scale=2.0)
    x1, x2 = x12[:, :2 * hl], x12[:, 2 * hl:]
    parts = [torch.cat([x1[:, r * hl:(r + 1) * hl], x2[:, r * hl:(r + 1) * hl]], dim=1).contiguous() for r in range(2)]
    log(f"[tp kernel] silu_mul_amax / silu_mul_quant_scaled on rank slices ({m},{2 * hl}) of x12 ({m},{4 * hl}) bf16")
    amaxes = [fad.silu_mul_amax(pt) for pt in parts]
    amax = torch.maximum(*amaxes)
    halves = [fad.silu_mul_quant_scaled(pt, amax) for pt in parts]
    whole_q, whole_s = fad.fused_silu_mul_quant(x12)
    same = (torch.equal(torch.cat([h[0] for h in halves], dim=1), whole_q)
            and all(torch.equal(h[1], whole_s) for h in halves))
    log(f"  the two halves on the two slices == #10 on the whole row bit for bit: {same}")
    if not same:
        raise SystemExit("#10's halves disagree with #10 on the whole row")
    pt = parts[0]
    ref_amax = fad.silu_mul_amax_plain(pt)
    # fp32 silu through expf against torch's sigmoid: an ulp of the row's absmax
    err = compare("silu_mul_amax", amaxes[0], ref_amax, rtol=1e-6, atol=0.0)
    ms = cuda_ms(lambda: fad.silu_mul_amax(pt), 50)
    plain_ms = cuda_ms(lambda: fad.silu_mul_amax_plain(pt), 10)
    rows["silu_mul_amax"] = (err, ms, plain_ms, None, *bound(m * 2 * hl * 2 + m * 4, fp32_flops=6 * m * hl), {})
    err = compare_quant("silu_mul_quant_scaled", halves[0], fad.silu_mul_quant_scaled_plain(pt, amax))
    ms = cuda_ms(lambda: fad.silu_mul_quant_scaled(pt, amax), 50)
    plain_ms = cuda_ms(lambda: fad.silu_mul_quant_scaled_plain(pt, amax), 10)
    rows["silu_mul_quant_scaled"] = (err, ms, plain_ms, None, *bound(
        m * 2 * hl * 2 + m * 4 + m * hl + m * 4, fp32_flops=8 * m * hl), {})
    del x12, parts, halves

    # -- #1 (12 heads a rank) and #4 (a rank's gate-aligned w12) at their tp shapes
    b, h, n, hd = 2 * TP_BATCH, 12, 1024, 64
    q, k, v = randn(b, h, n, hd), randn(b, h, n, hd), randn(b, h, n, hd)
    cos, sin = (torch.from_numpy(to_half_layout(t)).to(dev) for t in build_rope_table(hd // 2, 32))
    ref = fa.flash_attention_rope_plain(q, k, v, cos, sin)
    log(f"[tp kernel] flash_attention_rope ({b},{h},{n},{hd}); fused_matmul_silu x ({m},{d}), w12 ({2 * hl},{d})")
    compare("flash_attention_rope[tp 2]", fa.flash_attention_rope(q, k, v, cos, sin), ref, **attn_tol(ref))
    x, w12 = randn(m, d), randn(2 * hl, d, scale=d**-0.5)
    b12 = randn(2 * hl, scale=0.1, dtype=torch.float32)
    compare("fused_matmul_silu[tp 2]", fad.fused_matmul_silu(x, w12, b12), fad.fused_matmul_silu_plain(x, w12, b12),
            rtol=2**-6, atol=2**-6)
    del q, k, v, ref, x, w12
    torch.cuda.empty_cache()
    for name, (err, ms, plain_ms, lib_ms, bound_ms, bound_by, _) in rows.items():
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"  {name} (tp 2, 1p0B/1, batch {TP_BATCH}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}), share of bound {bound_ms / ms:.3f}")
    return rows


def tp_phase(dev, smi: str, tmp: str) -> tuple:
    """Phase 13: the kernel pieces, then the sampling CLI under --tp 2 on two
    ranks sharing the card, bf16 and w8a8, with exact launches per rank and
    the latents against one process at tp 1. Returns (record, kernel rows,
    launch counts by path)."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from PIL import Image

    from ldmae_tpu_torch.cli import inference
    from ldmae_tpu_torch.core.config import LDMAEConfig

    phase_t0 = time.perf_counter()
    rows = tp_kernel_phase(dev)
    _tp_cut_depth()
    paths = _tp_configs(tmp)
    log(f"[tp] two ranks on the card (torch.multiprocessing, gloo): cli.inference --tp 2 on {TP_MODEL} (full width, "
        f"depth cut 24 -> {TP_DEPTH}, seeded), batch {TP_BATCH}, {TP_STEPS} Euler steps (cut from 250), shift {SHIFT}, "
        f"CFG {CFG_SCALE} on [{CFG_START}, 1], VMAE f8d16 decode on the first rank; bf16 then w8a8")
    t0 = time.perf_counter()
    mp.start_processes(_tp_rank, args=(_free_port(), tmp, paths), nprocs=2, join=True, start_method="spawn")
    two_rank_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"tp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    z, y = _tp_inputs(dev)
    record, counts = {"two_rank_s": two_rank_s, "card": smi, "depth": TP_DEPTH, "steps": TP_STEPS}, {}
    for leg, quant in (("bf16", None), ("w8a8", "w8a8")):
        for r in range(2):
            want = _tp_counts(quant, lead=r == 0)
            if ranks[r][leg]["counts"] != want:
                raise SystemExit(f"tp {leg}, rank {r}: launches {ranks[r][leg]['counts']} != {want}")
        counts[f"tp_{leg}"] = ranks[0][leg]["counts"]
        folder = ranks[0][leg]["folder"]
        pngs = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
        imgs = np.stack([np.asarray(Image.open(os.path.join(folder, f))) for f in pngs])
        with open(os.path.join(folder, "resume_manifest.json")) as f:
            manifest = json.load(f)
        lats = [torch.load(os.path.join(tmp, f"tp_{leg}_rank{r}.pt")) for r in range(2)]
        # one process at tp 1 from the same weights (the CLI's build_pipeline, its seed) and noise
        sample_fn, bundle, _ = inference.build_pipeline(LDMAEConfig.from_yaml(paths[leg]), device=dev)
        _tp_latents(sample_fn, bundle, z, y)  # warm-up
        ref, one_s = _tp_latents(sample_fn, bundle, z, y)
        del sample_fn, bundle
        torch.cuda.empty_cache()
        scale, moved = float(ref.double().norm()), float((ref - z.cpu()).double().norm())
        diff = float((lats[0] - ref).double().norm())
        err = diff / scale
        entry = {"rel_l2_vs_tp1": err, "rel_l2_of_movement": diff / moved, "tp1_s_batch": one_s,
                 "tp2_s_batch": ranks[0][leg]["latent_s"],
                 "cli_s": ranks[0][leg]["seconds"], "peak_gb_rank": [ranks[r][leg]["peak_gb"] for r in range(2)],
                 "ranks_equal": bool(torch.equal(lats[0], lats[1]))}
        ok = (pngs == [f"{i:06d}.png" for i in range(TP_BATCH)] and imgs.shape == (TP_BATCH, 256, 256, 3)
              and manifest.get("tp") == 2 and entry["ranks_equal"] and err <= TP_LAT_REL)
        if leg == "bf16":
            control = float((torch.load(os.path.join(tmp, "tp_control_rank0.pt")) - ref).double().norm())
            entry |= {"control_rel_l2": control / scale, "control_rel_l2_of_movement": control / moved}
            ok = ok and entry["control_rel_l2"] > TP_LAT_REL
        log(f"  {leg}: launches per rank exact (rank 0 {ranks[0][leg]['counts']}; rank 1 the same without the "
            f"decode); PNGs {pngs[0]}..{pngs[-1]} {imgs.shape}, manifest {manifest}; the ranks' latents bitwise "
            f"equal: {entry['ranks_equal']}; {TP_STEPS}-step latents vs tp 1 in one process: rel L2 {err:.4g} (bound "
            f"{TP_LAT_REL}; {entry['rel_l2_of_movement']:.4g} of the latents' movement from z)"
            + (f", control (w12 rows contiguous, not gate-aligned) {entry['control_rel_l2']:.4g} (must exceed it; "
               f"{entry['control_rel_l2_of_movement']:.4g} of the movement)" if leg == "bf16" else "")
            + f"; seconds a batch (latents, no decode): tp 1 {one_s:.4f}, tp 2 {entry['tp2_s_batch']:.4f} (two ranks "
            f"over gloo time-slice one card: not a speed claim); the CLI call {entry['cli_s']:.2f} s a rank; peak "
            f"memory a rank {[round(v, 3) for v in entry['peak_gb_rank']]} GB")
        if not ok:
            raise SystemExit(f"tp {leg}: PNGs, manifest, the ranks' latents, the gate or its control failed")
        record[leg] = entry
    record["phase_s"] = time.perf_counter() - phase_t0
    log(f"  the tensor-parallel phase took {record['phase_s']:.2f} s (two-rank spawn {two_rank_s:.2f} s); on {smi}")
    return record, rows, counts


# -- phase 14: tensor parallelism in DiT training. Two ranks share the card
# over gloo and run the training CLI under --tp 2 on LightningDiT-1p0B/1 at
# full width, depth cut to TP_DEPTH (as phase 13), the shipped YAML's
# training sections (bf16, flash_rope with half-split RoPE, fused adaLN,
# remat 'attn'), global batch TPT_BATCH, from seeded weights (a warm
# start): TPT_STEPS steps and a checkpoint, a resume to TPT_RESUME, and the
# control. Over gloo each row-parallel fp32 partial (8,192 x 1,536, 50 MB)
# crosses the host. FSDP x tp has no leg here: over gloo on CUDA tensors the
# full state dicts a checkpoint gathers segfault (scripts/gloo_cuda_probe.py).
TPT_STEPS, TPT_RESUME, TPT_BATCH = 4, 6, 8
# each step's loss at tp 2 against tp 1 (relative), and the update
# theta_4 - theta_0 of the gathered checkpoint against tp 1's (relative L2
# over every parameter): bf16 roundings move where the partial sums
# reassociate, and AdamW's first steps follow the gradients' signs; the
# control (copy-to-tp's all-reduce left out of the backward: every weight
# below a column-parallel layer gets a partial gradient) must read above
TPT_LOSS_REL, TPT_UPDATE_REL = 1e-2, 1e-2
# the warm start's scale (``seeded_init_``'s std): at 0.02 the first steps
# diverge (loss 2.84 then 5.43 at lr 2e-4), and AdamW's sign-like first
# updates carry bf16 rounding differences into the update, the one-process
# run against itself included (PERF.md section 6); at 0.01 the loss
# falls from 2.20 to 2.05 over the 4 steps, every gate non-zero
TPT_WARM_STD = 0.01


def _tpt_counts(steps: int, control: bool = False) -> dict:
    """Exact launches a rank of ``steps`` tp-2 training steps at TP_DEPTH
    with remat 'attn': per block the forward runs adaLN, qkv and w12
    (``dense_bias_f32``) and proj and w3 (``dense_f32_out``), #1 once, #3
    twice; the backward recomputes both segments (qkv, w12, proj, w3, #1,
    #3 twice more), runs #6 once and #3's backward twice, and takes the fp32
    partial dx of the three
    column-parallel layers (adaLN, qkv, w12: ``dense_f32_out``; the
    control takes the bf16 dx of one rank alone instead); 5 whole linears a
    forward (the embeddings, the final layer)."""
    d = TP_DEPTH
    return _NONE | {"flash_attention_rope": 2 * d * steps, "fused_norm_modulate": 4 * d * steps,
                    "fused_norm_modulate_bwd_kernel": 2 * d * steps,
                    "flash_attention_rope_bwd": d * steps, "dense_bias_f32": (5 + 5 * d) * steps,
                    "dense_f32_out": (4 if control else 7) * d * steps}


def _tpt_collectives(steps: int, control: bool = False) -> dict:
    """Exact gloo collectives a rank of ``steps`` steps and one checkpoint:
    per block the forward's two row-parallel all-reduces (proj, w3) and the
    modulations' all-gather, the recomputation's w3 all-reduce (proj's is
    the attention segment's last op, which saves nothing: checkpointing's
    early stop skips it), the backward's five copy-to-tp all-reduces
    (adaLN's c, qkv's and w12's inputs, the q and k norms' weights; none in
    the control); one a step for the global norm. The checkpoint
    all-gathers the 8 split entries a block of the model, the EMA and the
    two AdamW moments."""
    d = TP_DEPTH
    return {"all_reduce": ((3 if control else 8) * d + 1) * steps, "all_gather": d * steps + 4 * 8 * d}


def _tpt_configs(tmp: str, data: str, weights: str) -> dict:
    import yaml

    paths = {}
    for name in ("tpt_tp2", "tpt_tp1", "tpt_tp1_again", "tpt_control"):
        cfg = _yaml_config(
            data={"data_path": data, "image_size": 256, "num_classes": 1000, "latent_norm": True,
                  "latent_multiplier": 1.0, "sample": False},
            train={"max_steps": TPT_STEPS, "global_batch_size": TPT_BATCH, "global_seed": 0, "output_dir": tmp,
                   "exp_name": name, "log_every": 1, "ckpt_every": 1000, "use_checkpoint": True,
                   "gradient_accumulation_steps": 1, "weight_init": weights})
        cfg["model"]["model_type"] = TP_MODEL
        paths[name] = os.path.join(tmp, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)
    return paths


def _tpt_rank(rank: int, port: int, tmp: str, paths: dict) -> None:
    """One of two ranks on the card (spawned): ``cli.train_dit --tp 2`` for
    TPT_STEPS steps, the resume to TPT_RESUME, then the control, each with
    its launches and gloo collectives counted from 0."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    import torch

    from ldmae_tpu_torch.cli import train_dit
    from ldmae_tpu_torch.ops import linear as lin
    from ldmae_tpu_torch.parallel import distributed, init_distributed_mode

    init_distributed_mode(backend="gloo")
    _tp_cut_depth()
    out = {}

    def leg(name, argv):
        distributed.reset_collectives()
        _mp_leg(out, name, lambda: {"history": train_dit.main(argv)["history"]})
        out[name]["collectives"] = dict(distributed.COLLECTIVES)
        torch.cuda.empty_cache()

    leg("train", ["--config", paths["tpt_tp2"], "--tp", "2"])
    leg("resume", ["--config", paths["tpt_tp2"], "--tp", "2", "--max_steps", str(TPT_RESUME)])
    # the control: no all-reduce of the replicated inputs' gradients (the
    # column-parallel layers' dx, the qk norms' weights)
    real = distributed._CopyToTP.backward, lin._DenseBiasF32.backward

    def partial_dx(ctx, g):
        ctx.group = None  # this rank's partial dx, taken as the whole
        return real[1](ctx, g)

    distributed._CopyToTP.backward, lin._DenseBiasF32.backward = (lambda ctx, g: (g, None)), partial_dx
    try:
        leg("control", ["--config", paths["tpt_control"], "--tp", "2"])
    finally:
        distributed._CopyToTP.backward, lin._DenseBiasF32.backward = real
    with open(os.path.join(tmp, f"tpt_rank{rank}.json"), "w") as f:
        json.dump(out, f)


def tpt_kernel_phase(dev) -> dict:
    """The kernels of tp-2 training at 1p0B/1's per-rank shapes, batch 8
    (M = 8,192 tokens): #1 (8, 12, 1024, 64) and #6 at the same shape given
    the forward's output and lse, #3 at (8, 1024, 1536), ``dense_bias_f32``
    at a rank's qkv (8,192 x 1,536 -> 2,304) with its backward (cuBLAS) against
    the fp32 math, ``dense_f32_out`` at proj (K 768) and w3 (K 2,048), through
    ``dense_row_parallel``'s backward and as qkv's fp32 partial dx; each against its plain
    version and timed beside its bound and library call. Returns name ->
    row of the kernels line."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops import fused_adaln as fad
    from ldmae_tpu_torch.ops import linear as lin
    from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

    g = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    rows = {}
    b, h, n, d = TPT_BATCH, 12, 1024, 64
    m, width = b * n, 1536
    q, k = randn(b, h, n, d, scale=2.0), randn(b, h, n, d, scale=2.0)
    v, go = randn(b, h, n, d), randn(b, h, n, d)
    cos, sin = (torch.from_numpy(to_half_layout(t)).to(dev) for t in build_rope_table(d // 2, 32))

    # -- #1 forward, 12 heads a rank
    log(f"[tp train kernel] flash_attention_rope q,k,v ({b},{h},{n},{d}) bf16 (tp 2: 12 of 24 heads)")
    ref = fa.flash_attention_rope_plain(q, k, v, cos, sin)
    err = compare("flash_attention_rope[tp train]", fa.flash_attention_rope(q, k, v, cos, sin), ref, **attn_tol(ref))
    del ref
    ms = cuda_ms(lambda: fa.flash_attention_rope(q, k, v, cos, sin), 20)
    plain_ms = cuda_ms(lambda: fa.flash_attention_rope_plain(q, k, v, cos, sin), 3, 1)
    qr, kr = fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v), 20)
    parts = rope_parts(lambda: fa.flash_attention_rope(q, k, v, cos, sin))
    bnd = bound(4 * b * h * n * d * 2 + 2 * n * d * 4, 4 * b * h * n * n * d, exps=b * h * n * n)
    rows["flash_attention_rope_tp_train"] = (err, ms, plain_ms, lib_ms, *bnd, parts)

    # -- #6 backward at the same shape, given the forward's output and lse
    log(f"[tp train kernel] flash_attention_rope_bwd q,k,v,g ({b},{h},{n},{d}) bf16, the forward's output and lse")
    o, lse = fa._launch(q, k, v, "flash_attention_rope_bwd", cos, sin, with_lse=True)  # the library, uncounted

    def bwd():
        return fa.flash_attention_rope_bwd(q, k, v, go, cos, sin, out=o, lse=lse)

    ref = fa.flash_attention_rope_bwd_plain(q, k, v, go, cos, sin)
    out = bwd()
    rel, elem = bwd_errors(out, ref)
    log(f"  kernel vs plain backward: relative L2 {rel:.6g} (bound {BWD_REL_L2}), max |err| / max |value| "
        f"{elem:.6g} (bound {BWD_ELEM})")
    if not (rel <= BWD_REL_L2 and elem <= BWD_ELEM):
        raise SystemExit("flash_attention_rope_bwd (tp train): kernel disagrees with its plain backward")
    err = max(float((a.float() - r.float()).abs().max()) for a, r in zip(out, ref))
    del out, ref
    ms = cuda_ms(bwd, 10)
    plain_ms = cuda_ms(lambda: fa.flash_attention_rope_bwd_plain(q, k, v, go, cos, sin), 3, 1)
    qs, ks, vs = (t.detach().requires_grad_() for t in (qr, kr, v))

    def sdpa_fwd_bwd():
        torch.autograd.grad(F.scaled_dot_product_attention(qs, ks, vs), (qs, ks, vs), go)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qs, ks, vs)

    fb_ms, f_ms = cuda_ms(sdpa_fwd_bwd, 10), cuda_ms(sdpa_fwd, 10)
    bnd = bound(8 * b * h * n * d * 2 + b * h * n * 4 + 2 * n * d * 4, 10 * b * h * n * n * d, exps=b * h * n * n)
    rows["flash_attention_rope_bwd_tp_train"] = (err, ms, plain_ms, fb_ms - f_ms, *bnd, {})
    del q, k, v, go, qr, kr, qs, ks, vs, o, lse

    # -- #3 at the full width (the adaLN epilogue runs on the replicated x)
    log(f"[tp train kernel] fused_norm_modulate x ({b},{n},{width}) bf16, shift/scale views of ({b},6,{width})")
    x = randn(b, n, width, scale=3.0)
    w = 1 + 0.1 * torch.randn(width, generator=g, device=dev)
    mod = randn(b, 6, width, scale=0.1)
    sh, sc = mod[:, 0], mod[:, 1]
    err = compare("fused_norm_modulate[tp train]", fad.fused_norm_modulate(x, w, sh, sc),
                  fad.fused_norm_modulate_plain(x, w, sh, sc), rtol=2**-6, atol=2**-6)
    ms = cuda_ms(lambda: fad.fused_norm_modulate(x, w, sh, sc), 50)
    plain_ms = cuda_ms(lambda: fad.fused_norm_modulate_plain(x, w, sh, sc), 10)
    bnd = bound(m * width * 4 + width * 4 + 2 * b * width * 2, fp32_flops=6 * m * width)
    rows["fused_norm_modulate_tp_train"] = (err, ms, plain_ms, None, *bnd, {})
    del x, mod
    rows["fused_norm_modulate_bwd_tp_train"] = fnm_bwd_row(dev, "(a tp rank's training rows)", b, n, width, 23)

    # -- dense_bias_f32 at a rank's qkv, and its backward (cuBLAS) against the fp32 math
    kq, nq = width, 3 * width // 2
    log(f"[tp train kernel] dense_bias_f32 x ({m},{kq}) bf16 @ w ({nq},{kq}) bf16 + b fp32 (a rank's qkv), with "
        f"its backward")
    x, w, bias = randn(m, kq), randn(nq, kq, scale=kq**-0.5), randn(nq, scale=0.1, dtype=torch.float32)
    ref = (x.float() @ w.float().t() + bias).to(torch.bfloat16)
    err = compare("dense_bias_f32[tp train]", lin.dense_bias_f32(x, w, bias), ref, rtol=2**-7, atol=2**-12)
    xs, ws, bs = (t.detach().requires_grad_() for t in (x, w, bias))
    gout = randn(m, nq)
    lin._DenseBiasF32.apply(xs, ws, bs, None).backward(gout)
    dx_ref = gout.float() @ w.float()
    for name, got, want in (("dx", xs.grad, dx_ref), ("dw", ws.grad, gout.float().t() @ x.float()),
                            ("db", bs.grad, gout.float().sum(0))):
        compare(f"dense_bias_f32[tp train] backward {name}", got, want, rtol=2**-6,
                atol=2**-6 * float(want.abs().max()) if name != "db" else 1e-5 * float(want.abs().max()))
    # under tp the backward's dx is this rank's fp32 partial, dense_f32_out on w^T
    compare("dense_f32_out[tp train, qkv's partial dx]", lin.dense_f32_out(gout, w.t().contiguous()), dx_ref,
            rtol=1e-5, atol=1e-5 * float(dx_ref.abs().max()))
    ms = cuda_ms(lambda: lin.dense_bias_f32(x, w, bias), 20)
    bwd_ms = cuda_ms(lambda: (gout @ w, gout.t() @ x, gout.sum(0, dtype=torch.float32)), 20)
    plain_ms = cuda_ms(lambda: (x.float() @ w.float().t() + bias).to(torch.bfloat16), 10)
    bias16 = bias.to(torch.bfloat16)
    lib_ms = cuda_ms(lambda: F.linear(x, w, bias16), 20)
    bnd = bound((m * kq + nq * kq + m * nq) * 2 + nq * 4, 2 * m * kq * nq)
    rows["dense_tp_train"] = (err, ms, plain_ms, lib_ms, *bnd, {"backward_ms": bwd_ms})
    del x, w, xs, ws, bs, gout, ref

    # -- dense_f32_out at a rank's proj and w3, and inside dense_row_parallel's backward
    for what, kk in (("proj", width // 2), ("w3", 2048)):
        log(f"[tp train kernel] dense_f32_out x ({m},{kk}) bf16 @ w ({width},{kk}) bf16 -> fp32 (a rank's {what})")
        x, w = randn(m, kk), randn(width, kk, scale=kk**-0.5)
        ref = lin.dense_f32_out_plain(x, w)
        err = compare(f"dense_f32_out[tp train, {what}]", lin.dense_f32_out(x, w), ref, rtol=1e-5,
                      atol=1e-5 * float(ref.abs().max()))
        xs, ws = x.detach().requires_grad_(), w.float().detach().requires_grad_()
        bs = torch.zeros(width, device=dev, requires_grad=True)
        gout = randn(m, width)
        lin.dense_row_parallel(xs, ws, bs, None, compute_dtype=torch.bfloat16).backward(gout)
        for name, got, want in (("dx", xs.grad, gout.float() @ w.float()),
                                ("dw", ws.grad, gout.float().t() @ x.float()), ("db", bs.grad, gout.float().sum(0))):
            compare(f"dense_row_parallel[tp train, {what}] backward {name}", got, want, rtol=2**-6,
                    atol=(1e-5 if name == "db" else 2**-6) * float(want.abs().max()))
        ms = cuda_ms(lambda: lin.dense_f32_out(x, w), 20)
        plain_ms = cuda_ms(lambda: lin.dense_f32_out_plain(x, w), 5)
        try:  # cuBLAS bf16 x bf16 -> fp32, where this torch has it
            lib_ms = cuda_ms(lambda: torch.mm(x, w.t(), out_dtype=torch.float32), 20)
        except (TypeError, RuntimeError):
            lib_ms = None
        bnd = bound((m * kk + width * kk) * 2 + m * width * 4, 2 * m * kk * width)
        if what == "proj":
            rows["dense_f32_out_tp_train"] = (err, ms, plain_ms, lib_ms, *bnd, {})
        else:
            rows["dense_f32_out_tp_train"][-1]["w3"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                                        "bound_ms": bnd[0], "bound_by": bnd[1], "max_abs_err": err}
        del x, w, xs, ws, bs, gout, ref
    torch.cuda.empty_cache()
    for name, (err, ms, plain_ms, lib_ms, bound_ms, bound_by, _) in rows.items():
        lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
        log(f"  {name} (1p0B/1, tp 2, batch {TPT_BATCH}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}), share of bound {bound_ms / ms:.3f}")
    return rows


def _update_rel(ckpt_path: str, ref: dict, init: dict) -> tuple:
    """(||(theta - theta_0) - (ref - theta_0)|| / ||ref - theta_0|| over
    every parameter of the checkpoint's model (read in place), the three
    parameters with the largest such error of their own)."""
    import torch

    model = torch.load(ckpt_path, map_location="cpu", weights_only=True, mmap=True)["model"]
    num = {k: float((model[k].double() - ref[k].double()).square().sum()) for k in ref}
    den = {k: float((ref[k].double() - init[k].double()).square().sum()) for k in ref}
    worst = sorted(ref, key=lambda k: -num[k] / max(den[k], 1e-300))[:3]
    return (sum(num.values()) / sum(den.values())) ** 0.5, {k: (num[k] / max(den[k], 1e-300)) ** 0.5 for k in worst}


def tp_train_phase(dev, smi: str, tmp: str) -> tuple:
    """Phase 14: the kernels at the tp-local shapes, then ``cli.train_dit
    --tp 2`` on two ranks sharing the card against one process at tp 1 from
    the same weights and data. Returns (record, kernel rows, launch counts
    by path)."""
    import torch
    import torch.multiprocessing as mp

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.cli import train_dit
    from ldmae_tpu_torch.core.config import LDMAEConfig
    from ldmae_tpu_torch.models import LightningDiT, permute_qk_for_half_rope, seeded_init_
    from ldmae_tpu_torch.train import init_train_state, make_optimizer, restore_checkpoint
    from ldmae_tpu_torch.train.train_dit import spec_from_config

    phase_t0 = time.perf_counter()
    rows = tpt_kernel_phase(dev)
    _tp_cut_depth()
    data = write_latent_shards(os.path.join(tmp, "tpt_latents"))
    weights = os.path.join(tmp, "tpt_seeded.pt")
    paths = _tpt_configs(tmp, data, weights)
    spec = spec_from_config(LDMAEConfig.from_yaml(paths["tpt_tp1"]))
    init = seeded_init_(LightningDiT(spec, device="cpu"), 3, std=TPT_WARM_STD).state_dict()
    torch.save({"model": init}, weights)  # the warm start: non-zero gates from step 1
    log(f"[tp train] two ranks on the card (torch.multiprocessing, gloo): cli.train_dit --tp 2 on {TP_MODEL} (full "
        f"width {spec.hidden_size}, {spec.num_heads} heads, SwiGLU {spec.swiglu_hidden}; depth cut 24 -> {TP_DEPTH}; "
        f"seeded warm start, std {TPT_WARM_STD}), the shipped YAML's training sections (bf16, flash_rope, half RoPE, fused adaLN, remat "
        f"attn), global batch {TPT_BATCH}: {TPT_STEPS} steps and a checkpoint, a resume to {TPT_RESUME}, then the "
        f"control ({TPT_STEPS} steps, copy-to-tp's all-reduce left out)")
    t0 = time.perf_counter()
    mp.start_processes(_tpt_rank, args=(_free_port(), tmp, paths), nprocs=2, join=True, start_method="spawn")
    two_rank_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"tpt_rank{r}.json")) as f:
            ranks.append(json.load(f))
    for r in range(2):
        for leg, steps in (("train", TPT_STEPS), ("resume", TPT_RESUME - TPT_STEPS), ("control", TPT_STEPS)):
            got, want = ranks[r][leg]["counts"], _tpt_counts(steps, control=leg == "control")
            coll = {key: ranks[r][leg]["collectives"][key] for key in ("all_reduce", "all_gather")}
            want_coll = _tpt_collectives(steps, control=leg == "control")
            if got != want or coll != want_coll:
                raise SystemExit(f"tp train {leg}, rank {r}: launches {got} (want {want}), collectives {coll} "
                                 f"(want {want_coll})")
    with open(os.path.join(tmp, "tpt_tp2", "log.txt")) as f:
        resumed = f"resumed from step {TPT_STEPS}" in f.read()

    # one process at tp 1: the same weights, data and seeds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    hist1 = train_dit.main(["--config", paths["tpt_tp1"]])["history"]
    torch.cuda.synchronize()
    tp1_call_s, tp1_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 1e9
    counts1 = ops.launch_counts()
    want1 = _counts_of("half", TPT_STEPS, TP_DEPTH)
    if counts1 != want1:
        raise SystemExit(f"tp train at tp 1: launches {counts1} != {want1}")
    # the same one-process run again: the path's own spread from run to run
    # (0 since #6 sums dq in a fixed order)
    train_dit.main(["--config", paths["tpt_tp1_again"]])
    hist2 = ranks[0]["train"]["history"]
    loss_rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(hist2, hist1)]
    ckpt = f"{TPT_STEPS:07d}.pt"
    ref = torch.load(os.path.join(tmp, "tpt_tp1", "checkpoints", ckpt), map_location="cpu", weights_only=True,
                     mmap=True)["model"]
    ref = {k: v for k, v in ref.items() if k in dict(LightningDiT(spec, device="meta").named_parameters())}
    update, update_worst = _update_rel(os.path.join(tmp, "tpt_tp2", "checkpoints", ckpt), ref, init)
    control, _ = _update_rel(os.path.join(tmp, "tpt_control", "checkpoints", ckpt), ref, init)
    spread, spread_worst = _update_rel(os.path.join(tmp, "tpt_tp1_again", "checkpoints", ckpt), ref, init)
    for name in ("tpt_control", "tpt_tp1", "tpt_tp1_again"):
        os.remove(os.path.join(tmp, name, "checkpoints", ckpt))

    # the tp-2 checkpoint restores in one process
    model = LightningDiT(spec, device=dev)
    state = init_train_state(model, make_optimizer(model.parameters(), 2e-4, 0.95))
    restored = restore_checkpoint(os.path.join(tmp, "tpt_tp2"), state, step=TPT_RESUME, half_rope=True)
    saved = torch.load(os.path.join(tmp, "tpt_tp2", "checkpoints", f"{TPT_RESUME:07d}.pt"), map_location="cpu",
                       weights_only=True, mmap=True)["model"]
    back = permute_qk_for_half_rope(state.model.state_dict(), spec, inverse=True)
    restores = restored is not None and state.step == TPT_RESUME and all(
        torch.equal(back[k].cpu(), saved[k]) for k in saved)
    moments = sum(1 for s in state.optimizer.state.values() if "exp_avg" in s)
    del model, state, back, saved
    torch.cuda.empty_cache()

    def steady(hist):
        later = hist[1:]  # the first step holds the warm-up
        return sum(h["seconds"] for h in later) / len(later)

    steps_coll = {key: ranks[0]["train"]["collectives"][key] / TPT_STEPS for key in ("all_reduce", "all_gather")}
    record = {
        "card": smi, "depth": TP_DEPTH, "batch": TPT_BATCH, "steps": TPT_STEPS, "two_rank_s": two_rank_s,
        "loss_tp2": [h["loss"] for h in hist2], "loss_tp1": [h["loss"] for h in hist1], "loss_rel": loss_rel,
        "update_rel_l2": update, "update_worst_leaves": update_worst, "control_update_rel_l2": control,
        "tp1_again_update_rel_l2": spread, "tp1_again_worst_leaves": spread_worst, "resumed": resumed,
        "restores": restores,
        "s_step_tp1": steady(hist1), "s_step_tp2": steady(hist2), "tp1_call_s": tp1_call_s,
        "tp2_call_s": [ranks[r]["train"]["seconds"] for r in range(2)], "tp1_peak_gb": tp1_peak,
        "peak_gb_rank": [ranks[r]["train"]["peak_gb"] for r in range(2)],
        # without the checkpoint's gathers (the all-gathers of _tpt_collectives' last term)
        "collectives_per_step": {"all_reduce": steps_coll["all_reduce"],
                                 "all_gather": steps_coll["all_gather"] - 4 * 8 * TP_DEPTH / TPT_STEPS},
        "gloo_bytes_train_leg_rank0": ranks[0]["train"]["collectives"]["bytes"],
    }
    ok = (all(e <= TPT_LOSS_REL for e in loss_rel) and len(loss_rel) == TPT_STEPS and update <= TPT_UPDATE_REL
          < control and resumed and restores and moments == len(list(LightningDiT(spec, device="meta").parameters()))
          and all(math.isfinite(h["loss"]) for h in hist2 + ranks[0]["resume"]["history"]))
    log(f"  launches per rank exact (train {ranks[0]['train']['counts']}); gloo collectives per rank exact, per step "
        f"{record['collectives_per_step']} (a checkpoint adds {4 * 8 * TP_DEPTH} all-gathers), the train leg's "
        f"{record['gloo_bytes_train_leg_rank0'] / 1e9:.3f} GB through gloo on rank 0; losses tp 2 "
        f"{[round(v, 6) for v in record['loss_tp2']]} vs tp 1 {[round(v, 6) for v in record['loss_tp1']]} (relative "
        f"{[round(v, 6) for v in loss_rel]}, bound {TPT_LOSS_REL}); the update theta_{TPT_STEPS} - theta_0 vs tp 1: "
        f"relative L2 {update:.6g} (bound {TPT_UPDATE_REL}; worst leaves {update_worst}), control (copy-to-tp's "
        f"all-reduce left out) {control:.6g} (must exceed it); the same tp-1 run again vs tp 1 {spread:.6g} (worst "
        f"leaves {spread_worst}); resumed from step {TPT_STEPS}: {resumed}; the step-{TPT_RESUME} tp-2 "
        f"checkpoint restores in one process bit for bit (model, EMA, {moments} AdamW moment pairs): {restores}")
    log(f"  seconds a step (steady, steps 2-{TPT_STEPS}): tp 1 {record['s_step_tp1']:.4f}, tp 2 "
        f"{record['s_step_tp2']:.4f} (two ranks over gloo time-slice one card: not a speed claim); peak memory a rank "
        f"{[round(v, 3) for v in record['peak_gb_rank']]} GB (tp 1: {tp1_peak:.3f} GB); on {smi}")
    if not ok:
        raise SystemExit("tp train: a loss, the update, the control, the resume or the restore failed")
    record["phase_s"] = time.perf_counter() - phase_t0
    log(f"  the tensor-parallel training phase took {record['phase_s']:.2f} s (two-rank spawn {two_rank_s:.2f} s)")
    return record, rows, {"tp_train": ranks[0]["train"]["counts"]}


def parallel_only(dev, smi: str) -> int:
    """``--parallel``: build, then phases 13 and 14 alone, ending with their
    kernels."""
    import torch

    from ldmae_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    rate_probes(dev)  # the exponential term of the attention bounds
    with tempfile.TemporaryDirectory() as tmp:
        record, rows, counts = tp_phase(dev, smi, tmp)
        train_record, train_rows, train_counts = tp_train_phase(dev, smi, tmp)
    rows |= train_rows
    counts |= train_counts
    log(json.dumps({"tensor_parallel": record}))
    log(json.dumps({"tensor_parallel_training": train_record}))
    log(smi)
    log(json.dumps({"kernels": kernel_rows(rows, counts)}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def _load_shard_len(path: str) -> int:
    from ldmae_tpu_torch.data.latent_dataset import read_safetensors

    return len(read_safetensors(path)["labels"])


def multiproc_only(dev, smi: str) -> int:
    """``--multiproc``: build, then the multi-process phase alone."""
    import torch

    from ldmae_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        origin = os.path.join(tmp, "images")
        write_image_folder(origin, EXTRACT_IMAGES, 42)
        record = multiproc_phase(dev, smi, tmp, origin)
    log(smi)
    log(json.dumps({"multiproc": record}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def vmae_only(dev, smi: str) -> int:
    """``--vmae``: build, then the VMAE training phase alone, ending with its
    kernels' line."""
    import torch

    from ldmae_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    rate_probes(dev)  # the exponential term of the attention bounds
    with tempfile.TemporaryDirectory() as tmp:
        origin = os.path.join(tmp, "images")
        write_image_folder(origin, EXTRACT_IMAGES, 42)
        _, rows = vmae_train_phase(dev, smi, tmp, origin)
    log(smi)
    log(json.dumps({"vmae_train_kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def tokenizers_only(dev, smi: str) -> int:
    """``--tokenizers``: build, then the tokenizer-family phases alone."""
    import torch

    from ldmae_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    with tempfile.TemporaryDirectory() as tmp:
        origin = os.path.join(tmp, "images")
        write_image_folder(origin, EXTRACT_IMAGES, 42)
        tokenizer_family_phases(dev, smi, tmp, origin)
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0



# -- the XL slice: LightningDiT-XL/1 (28 blocks, D 1,152, 16 heads of 72,
# SwiGLU hidden 3,072) through the sampling and training CLIs on the shipped
# YAML with model.model_type changed (xl_yaml), and the attention kernels at
# head dim 72, where #1's forward and #6's backward (#5 by the same switch,
# #2, #7 and #8 by the forward's dispatch) run the wgmma kernels on a
# 128-byte and a 32-byte swizzled part of each 144-byte row. Also alone
# under --xl; --xl-kernels runs the kernel phase without asserting which
# kernels ran, so that copied into an unpacked earlier commit it times that
# commit's kernels at these shapes (the mma.sync core and the three passes).
XL_MODEL, XL_DEPTH, XL_HEADS, XL_HEAD_DIM = "LightningDiT-XL/1", 28, 16, 72
# training: batch cut from the YAML's 256, a few steps (no checkpoint
# write: the final one is 11 GB of fp32 weights, EMA and moments); the
# gradient check at full width, depth cut so the plain oracle's logits fit
XL_TRAIN_BATCH, XL_TRAIN_STEPS, XL_GRAD_DEPTH = 32, 4, 4
# the sampling legs (this slice's and the registry's XL/1 w8a8 CLI leg): the
# timed batch's steps and the depth, cut from 250 and 28 to keep the script
# inside its time limit (the width, head dim and tokens stay)
XL_SAMPLE_STEPS, XL_SAMPLE_DEPTH = 50, 8
_XL_EVALS = (XL_SAMPLE_STEPS - 1) * XL_SAMPLE_DEPTH
_XL_SHORT = (SHORT_STEPS - 1) * XL_SAMPLE_DEPTH
EXPECTED_LAUNCHES |= {
    # one batch of 8 through cli.inference: the DiT's forwards and the VMAE decode
    "xl_bf16": _NONE | {"flash_attention_rope": _XL_EVALS, "fused_norm_modulate": 2 * _XL_EVALS,
                        "fused_matmul_silu": _XL_EVALS, "flash_attention_resident": DEC_DEPTH,
                        "dense_bias_f32": (XL_SAMPLE_STEPS - 1) * (5 + 4 * XL_SAMPLE_DEPTH) + _DENSE_DECODE},
    # the 10-step comparison, latents only
    "xl_short": _NONE | {"flash_attention_rope": _XL_SHORT, "fused_norm_modulate": 2 * _XL_SHORT,
                         "fused_matmul_silu": _XL_SHORT,
                         "dense_bias_f32": (SHORT_STEPS - 1) * (5 + 4 * XL_SAMPLE_DEPTH)},
}
EXPECTED_LAUNCHES["xl_train"] = _counts_of("half", XL_TRAIN_STEPS, XL_DEPTH)
EXPECTED_LAUNCHES["xl_grad"] = _counts_of("half", 1, XL_GRAD_DEPTH)
# kernels-line rows at d = 72: launches from the XL legs (no XL path
# launches #2 at this head dim, #5, #7 or #8)
KERNELS |= {
    "flash_attention_rope_xl": (_FA, f"{_PALLAS_FA}:323", "xl_bf16", "flash_attention_rope"),
    "flash_attention_rope_bwd_xl": (_FA, f"{_PALLAS_FA}:429", "xl_train", "flash_attention_rope_bwd"),
    "flash_attention_bwd_xl": (_FA, f"{_PALLAS_FA}:151", "xl_train", "flash_attention_bwd"),
    "flash_attention_xl": (_FA, f"{_PALLAS_FA}:77", "xl_bf16", "flash_attention"),
    "flash_attention_qknorm_rope_xl": (_FA, f"{_PALLAS_FA}:282", "xl_bf16", "flash_attention_qknorm_rope"),
    "flash_attention_fused_rope_xl": (_FA, f"{_PALLAS_FA}:550", "xl_bf16", "flash_attention_fused_rope"),
}
# the kernels the d = 72 paths must run, and the older ones they must not
XL_OWN = ("flash_fwd_wgmma_kernel", "flash_bwd_wgmma_kernel", "flash_bwd_preprocess_kernel",
          "flash_bwd_postprocess_kernel", "norm_rope_kernel")
XL_OLD = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")


def xl_yaml(path: str, model_type: str = XL_MODEL, **sections) -> str:
    """Writes to ``path`` the shipped YAML with model.model_type
    ``model_type`` (LightningDiT-XL/1 unless given) and nothing else
    changed, then each of ``sections`` (a top-level key: a value, or a dict
    merged into that section, parallel.quant among them) as a leg needs it;
    returns ``path``."""
    import yaml

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", "imagenet", "lightningdit_b_vmae_f8d16.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["model_type"] = model_type
    for key, value in sections.items():
        cfg[key] = dict(cfg.get(key) or {}, **value) if isinstance(value, dict) else value
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def train_yaml(path: str, arch: str, data: str, weights: str, output_dir: str, exp_name: str) -> str:
    """The training legs' YAML (``xl_yaml``): the shipped one with
    model.model_type ``arch``, its data the latent shards at ``data``, batch
    XL_TRAIN_BATCH, XL_TRAIN_STEPS steps, a log line a step, the warm start
    ``weights``; returns ``path``."""
    return xl_yaml(path, arch, data={"data_path": data, "sample": False},
                   train={"max_steps": XL_TRAIN_STEPS, "global_batch_size": XL_TRAIN_BATCH, "global_seed": 0,
                          "output_dir": output_dir, "exp_name": exp_name, "log_every": 1,
                          "ckpt_every": 10 * XL_TRAIN_STEPS, "weight_init": weights})


@contextlib.contextmanager
def registry_depth(arch: str, depth: int):
    """``arch`` at ``depth`` in this process's model registry (the CLIs read
    the depth from there) inside the block: the depth cuts of sampling legs."""
    from ldmae_tpu_torch.models import lightningdit

    full = lightningdit._REGISTRY[arch]
    lightningdit._REGISTRY[arch] = dict(full, depth=depth)
    try:
        yield
    finally:
        lightningdit._REGISTRY[arch] = full


def device_split(fn, iters: int = 10, need=None) -> dict:
    """Device ms per call of every kernel ``fn`` launches, by short name
    (torch.profiler). With ``need`` (a test of the names): a trace that
    fails it is taken again, up to three in all, since traces have come
    back without some kernels' records (the kernels ran: their launches are
    counted and their results checked); the last is returned."""
    for _ in range(3):
        out = collections.defaultdict(float)
        for key, ms in _profiled(fn, iters):
            m = re.search(r"(\w+_kernel)\b", key)
            out[m[1] if m else key[:40]] += ms
        if need is None or need(sorted(out)):
            break
    return dict(out)


def xl_route(what: str, fn, strict: bool) -> dict:
    """The d = 72 call ``fn``'s kernels by name (``device_split``); strict:
    fails unless they are the wgmma kernels (and their pre-, pre- and
    post-passes) alone."""

    def route(names):
        return any(n in XL_OWN for n in names) and not any(n in XL_OLD for n in names)

    split = device_split(fn, need=route)
    names = sorted(split)
    ok = route(names)
    log(f"  {what}: kernels that ran {names} -> {'the wgmma kernels' if ok else 'NOT the wgmma kernels'}")
    if strict and not ok:
        raise SystemExit(f"{what}: at d = 72 the call ran {names}, not the wgmma kernels")
    return {"kernels_ms": split}


def xl_kernel_phase(dev, strict: bool = True) -> dict:
    """5(a): the attention kernels at head dim 72 against their plain
    versions (the forward gates rtol 2^-7 and 2^-8 of the largest output;
    the backward BWD_REL_L2 and BWD_ELEM, each with wrong backwards that
    must read above), timed beside the plain version, SDPA (on pre-rotated
    or pre-normed q, k; the backward as fwd+bwd minus fwd) and the bound,
    the kernels that ran named by the profiler (strict: the wgmma kernels
    alone). #1 at (16, 16, 1024, 72) and at bench.py's batch 36 doubled, (72,
    16, 1024, 72); #2, #7, #8 at the first; #6 and #5 at the training shape
    (32, 16, 1024, 72), given the forward's output and lse. Returns name ->
    (max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by, parts)."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

    g = torch.Generator(device=dev).manual_seed(18)
    h, n, d = XL_HEADS, 1024, XL_HEAD_DIM

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).bfloat16()

    cos, sin = (torch.from_numpy(to_half_layout(t)).to(dev) for t in build_rope_table(d // 2, 32))
    tables = 2 * n * d * 4
    rows = {}

    def fwd_row(name, b, run, plain, lib, extra_bytes):
        ref = plain()
        err = compare(f"{name} ({b},{h},{n},{d})", run(), ref, **attn_tol(ref))
        del ref
        ms = cuda_ms(run, 20)
        plain_ms = cuda_ms(plain, 3, 1)
        lib_ms = cuda_ms(lib, 20)
        bnd = bound(4 * b * h * n * d * 2 + extra_bytes, 4 * b * h * n * n * d, exps=b * h * n * n)
        parts = xl_route(name, run, strict)
        log(f"  {name} ({b},{h},{n},{d}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms "
            f"(kernel / SDPA {ms / lib_ms:.3f}), bound {bnd[0]:.4f} ms ({bnd[1]}), share {bnd[0] / ms:.3f}")
        return err, ms, plain_ms, lib_ms, *bnd, parts

    for b in (2 * BATCH, 2 * BENCH_BATCH):
        log(f"[xl kernel] flash_attention_rope q,k,v ({b},{h},{n},{d}) bf16, cos/sin ({n},{d}) fp32")
        q, k, v = randn(b, h, n, d), randn(b, h, n, d), randn(b, h, n, d)
        qr, kr = fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin)
        row = fwd_row("flash_attention_rope", b, lambda: fa.flash_attention_rope(q, k, v, cos, sin),
                      lambda: fa.flash_attention_rope_plain(q, k, v, cos, sin),
                      lambda: F.scaled_dot_product_attention(qr, kr, v), tables)
        if b == 2 * BATCH:
            rows["flash_attention_rope_xl"] = row
            log(f"[xl kernel] flash_attention q,k,v ({b},{h},{n},{d}) bf16 (no RoPE, no gradient)")
            rows["flash_attention_xl"] = fwd_row(
                "flash_attention", b, lambda: fa.flash_attention(q, k, v), lambda: fa.flash_attention_plain(q, k, v),
                lambda: F.scaled_dot_product_attention(q, k, v), 0)
        else:
            err, ms, plain_ms, lib_ms, bnd, by, parts = row
            rows["flash_attention_rope_xl"][6].update(
                {f"batch{BENCH_BATCH}": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                         "bound_ms": bnd, "bound_by": by} | parts})
        del q, k, v, qr, kr
        torch.cuda.empty_cache()

    b = 2 * BATCH
    log(f"[xl kernel] flash_attention_qknorm_rope q,k,v ({b},{h},{n},{d}) bf16, qk-norm weights ({d},) fp32")
    q, k, v = randn(b, h, n, d, scale=3.0), randn(b, h, n, d, scale=3.0), randn(b, h, n, d)
    qs, ks = (1 + 0.1 * torch.randn(d, generator=g, device=dev) for _ in range(2))
    qr, kr = fa._qknorm_rope_fp32(q, qs, cos, sin), fa._qknorm_rope_fp32(k, ks, cos, sin)
    rows["flash_attention_qknorm_rope_xl"] = fwd_row(
        "flash_attention_qknorm_rope", b, lambda: fa.flash_attention_qknorm_rope(q, k, v, qs, ks, cos, sin),
        lambda: fa.flash_attention_qknorm_rope_plain(q, k, v, qs, ks, cos, sin),
        lambda: F.scaled_dot_product_attention(qr, kr, v), tables + 2 * d * 4)
    del q, k, v, qr, kr

    log(f"[xl kernel] flash_attention_fused_rope q,k ({b},{n},{h},{d}) bf16, v a view of qkv ({b},{n},3,{h},{d})")
    qkv = randn(b, n, 3, h, d)
    q, k, v = qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(), qkv[:, :, 2]
    qr, kr = (fa._rope_fp32(t.transpose(1, 2), cos, sin) for t in (q, k))
    vt = v.transpose(1, 2)
    rows["flash_attention_fused_rope_xl"] = fwd_row(
        "flash_attention_fused_rope", b, lambda: fa.flash_attention_fused_rope(q, k, v, cos, sin),
        lambda: fa.flash_attention_fused_rope_plain(q, k, v, cos, sin),
        lambda: F.scaled_dot_product_attention(qr, kr, vt), tables)
    del qkv, q, k, v, qr, kr, vt
    torch.cuda.empty_cache()

    # the backward at the training shape, q and k at twice unit scale (peaked
    # rows, where the controls move dq and dk by far more than the bound)
    b = XL_TRAIN_BATCH
    q, k = randn(b, h, n, d, scale=2.0), randn(b, h, n, d, scale=2.0)
    v, gr = randn(b, h, n, d), randn(b, h, n, d)
    for name, tab in (("flash_attention_rope_bwd", (cos, sin)), ("flash_attention_bwd", ())):
        rows[f"{name}_xl"] = attention_bwd_row("xl kernel", name, q, k, v, gr, tab,
                                               lambda fn, name=name: xl_route(name, fn, strict))
    del q, k, v, gr
    torch.cuda.empty_cache()
    return rows


def xl_sampling_leg(dev, smi: str, tmp: str) -> tuple:
    """5(b): XL/1 through cli.inference on xl_yaml (seeded weights, VMAE f8d16
    seeded, bf16): first SHORT_STEPS steps from one noise under the YAML's
    kernels against the plain xla impls (the B/1 gate, 5e-2 of the latents'
    scale; control: the kernel path from another noise), then one batch of
    8 through the CLI at XL_SAMPLE_STEPS steps, CFG 10 on [0.10, 1] phased,
    decoded to PNGs, launches exact, the batch's seconds timed inside the
    CLI's own pipeline. Returns (record, {path: counts})."""
    import numpy as np
    import torch
    from PIL import Image

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.cli import inference
    from ldmae_tpu_torch.core.config import LDMAEConfig

    out_root = os.path.join(tmp, "xl_out")
    path = xl_yaml(os.path.join(tmp, "xl_sample.yaml"), ckpt_path=None, vae={"weight_path": ""},
                   train={"output_dir": out_root, "exp_name": "xl"},
                   sample={"num_sampling_steps": XL_SAMPLE_STEPS, "per_proc_batch_size": BATCH, "fid_num": BATCH})
    cfg = LDMAEConfig.from_yaml(path)
    record, counts = {"card": smi}, {}

    log(f"[xl] {SHORT_STEPS} steps: {XL_MODEL} (the CLI's build_pipeline, seeded; depth {XL_SAMPLE_DEPTH}), batch "
        f"{BATCH}, the YAML's kernels ({cfg.parallel.attention_impl}, fused adaLN and SwiGLU) vs the plain xla impls "
        f"from the same noise")
    _, bundle, spec = inference.build_pipeline(cfg, device=dev)
    if (spec.depth, spec.head_dim) != (XL_SAMPLE_DEPTH, XL_HEAD_DIM):
        raise SystemExit(f"xl: depth {spec.depth}, head dim {spec.head_dim}")
    latents = dict(bundle, vae=None)
    y = torch.arange(BATCH, device=dev) * 125 % 1000
    gen = torch.Generator(device=dev)
    z, z2 = (torch.randn(BATCH, 16, 32, 32, generator=gen.manual_seed(s), device=dev) for s in (2, 3))
    fk = sampler(spec, SHORT_STEPS, dev, kernels=True)
    fx = sampler(spec, SHORT_STEPS, dev, kernels=False)
    fk(latents, y, z=z)  # warm-up
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat_k = fk(latents, y, z=z)
    torch.cuda.synchronize()
    short_s = time.perf_counter() - t0
    counts["xl_short"] = ops.launch_counts()
    check_counts("xl_short", counts["xl_short"])
    lat_x = fx(latents, y, z=z)
    lat_c = fk(latents, y, z=z2)
    scale = float(lat_x.abs().max())
    rel, control = (float((t - lat_x).abs().max()) / scale for t in (lat_k, lat_c))
    moved = float((lat_x - z).abs().max())
    img_k = bundle["vae"].decode_to_images(lat_k, compute_dtype=torch.bfloat16, attn_impl="flash_rope")
    img_x = bundle["vae"].decode_to_images(lat_k, compute_dtype=torch.bfloat16, attn_impl="xla")
    px = int((img_k.int() - img_x.int()).abs().max())
    ok = (bool(torch.isfinite(lat_k).all()) and lat_k.shape == (BATCH, 16, 32, 32) and rel <= 5e-2
          and control > 5e-2 and moved > 1e-2 and px <= 8)
    record["short"] = {"rel": rel, "control": control, "moved": moved, "decode_px": px, "seconds": short_s}
    log(f"  latents max rel err {rel:.6g} (tolerance 5e-2, the B/1 gate); control (the kernels from another noise) "
        f"{control:.6g} (must exceed 5e-2); latents moved {moved:.4g} from z; decode flash vs xla max pixel diff {px} (tolerance 8); {short_s:.4f} s for the "
        f"{SHORT_STEPS}-step batch (latents) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("xl: the 10-step latents disagree with xla, or the control reads within the gate")
    del bundle, latents, lat_k, lat_x, lat_c, img_k, img_x, fk, fx
    torch.cuda.empty_cache()

    log(f"[xl] cli.inference: {XL_MODEL} + VMAE f8d16 (seeded), batch {BATCH}, {XL_SAMPLE_STEPS} Euler steps, shift "
        f"{cfg.sample.timestep_shift}, CFG {cfg.sample.cfg_scale} on [{cfg.sample.cfg_interval_start}, 1] (phased), "
        f"bf16, PNGs")
    build = inference.build_pipeline
    batch_s = []

    def timed_pipeline(*args, **kwargs):
        fn, bundle, spec_ = build(*args, **kwargs)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            imgs = fn(*a, **kw)
            torch.cuda.synchronize()
            batch_s.append(time.perf_counter() - t)
            return imgs

        return timed, bundle, spec_

    inference.build_pipeline = timed_pipeline
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        folder = inference.main(["--config", path, "--skip_fid"])
    finally:
        inference.build_pipeline = build
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts["xl_bf16"] = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts("xl_bf16", counts["xl_bf16"])
    pngs = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
    imgs = np.stack([np.asarray(Image.open(os.path.join(folder, f))) for f in pngs])
    ok = (pngs == [f"{i:06d}.png" for i in range(BATCH)] and imgs.shape == (BATCH, 256, 256, 3)
          and float(imgs.std()) > 1.0 and len(batch_s) == 1)
    record["cli"] = {"seconds_batch": batch_s[0] if batch_s else None, "cli_s": cli_s, "peak_gb": peak,
                     "steps": XL_SAMPLE_STEPS}
    log(f"  launches exact; PNGs {pngs[0]}..{pngs[-1]} {imgs.shape}, pixel std {float(imgs.std()):.3f}; "
        f"{record['cli']['seconds_batch']:.4f} s per batch of {BATCH} ({BATCH / record['cli']['seconds_batch']:.4f} "
        f"images/s), the whole CLI call {cli_s:.2f} s (model builds, seeded weights, PNG writes); peak memory "
        f"{peak:.3f} GB; on {smi} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("xl: the sampling CLI's PNGs are not the batch's 8 images")
    torch.cuda.empty_cache()
    return record, counts


def training_leg(dev, smi: str, tmp: str, arch: str = XL_MODEL, name: str = "xl") -> tuple:
    """5(c) and 7d: ``arch`` (XL/1 for the XL slice) at full width and depth
    through cli.train_dit on xl_yaml's training sections (bf16, flash_rope,
    half RoPE, fused adaLN, remat attn), batch XL_TRAIN_BATCH, XL_TRAIN_STEPS
    steps on the synthetic latent shards, warm-started with seeded adaLN and
    final-layer weights (the reference init zeroes them, and no kernel's
    output would reach the loss); the final checkpoint's write is left out
    (11 GB at XL, 32 GB at 1p6B). Launches exact (path ``{name}_train``),
    finite losses and gradient norms, the weights and the EMA moved,
    steps/s, MFU, peak memory; then the gradient check at full width, depth
    XL_GRAD_DEPTH (path ``{name}_grad``). Returns (record, {path: counts})."""
    import numpy as np
    import torch

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.cli import train_dit
    from ldmae_tpu_torch.core.config import LDMAEConfig
    from ldmae_tpu_torch.models import LightningDiT
    from ldmae_tpu_torch.train.train_dit import spec_from_config
    from ldmae_tpu_torch.utils.profiling import dit_forward_flops

    data = os.path.join(tmp, "xl_latents")
    if not os.path.isdir(data):
        write_latent_shards(data)
    weights = os.path.join(tmp, f"{name}_gates.pt")
    path = train_yaml(os.path.join(tmp, f"{name}_train.yaml"), arch, data, weights, tmp, f"{name}_train")
    cfg = LDMAEConfig.from_yaml(path)
    spec = spec_from_config(cfg)
    shapes = {n: tuple(p.shape) for n, p in LightningDiT(spec, device="meta").named_parameters()
              if "adaLN_modulation" in n or n.startswith("final_layer")}
    rng = np.random.default_rng(3)
    gates = {n: torch.from_numpy(rng.standard_normal(s, dtype=np.float32) * np.float32(0.02)).bfloat16()
             for n, s in shapes.items()}
    torch.save({"model": gates}, weights)
    saved, moved = [], {}
    save = train_dit.save_checkpoint

    def no_write(exp_dir, state, **kw):  # the final checkpoint is not this leg's measurement
        saved.append(state.step)
        moved.update({key: max(float((t.get_parameter(n).detach().float().cpu() - g.float()).abs().max())
                                for n, g in gates.items()) for key, t in (("model", state.model), ("ema", state.ema))})
        return os.path.join(exp_dir, "checkpoints", "not-written")

    log(f"[{name}] cli.train_dit: {arch} (depth {spec.depth}, width {spec.hidden_size}, {spec.num_heads} heads of "
        f"{spec.head_dim}, SwiGLU {spec.swiglu_hidden}, {spec.num_patches} tokens), batch {XL_TRAIN_BATCH}, "
        f"{XL_TRAIN_STEPS} steps, the shipped YAML's model/transport/optimizer/parallel sections "
        f"(train_attention_impl {cfg.parallel.train_attention_impl}, rope_layout {cfg.parallel.rope_layout}, "
        f"remat {cfg.model.remat_policy}), {len(gates)} seeded gate tensors")
    train_dit.save_checkpoint = no_write
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = train_dit.main(["--config", path])
    finally:
        train_dit.save_checkpoint = save
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {f"{name}_train": ops.launch_counts()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts(f"{name}_train", counts[f"{name}_train"])
    hist = out["history"]
    del out
    torch.cuda.empty_cache()
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]) and h["grad_norm"] > 0 for h in hist)
    steady = hist[1:]  # the first step holds the warm-up
    sps = sum(h["steps_per_sec"] * h["seconds"] for h in steady) / sum(h["seconds"] for h in steady)
    flops = 3 * dit_forward_flops(spec, XL_TRAIN_BATCH)
    record = {"losses": [h["loss"] for h in hist], "grad_norms": [h["grad_norm"] for h in hist], "steps_per_s": sps,
              "latents_per_s": sps * XL_TRAIN_BATCH, "tflops": flops * sps / 1e12,
              "mfu": flops * sps / PEAK_BF16_FLOPS, "peak_gb": peak, "cli_s": seconds, "card": smi,
              "gates_moved": moved}
    log("  " + "; ".join(f"step {h['step']}: loss {h['loss']:.5f}, grad norm {h['grad_norm']:.5f}, "
                         f"{h['steps_per_sec']:.4f} steps/s" for h in hist))
    ok = finite and saved == [XL_TRAIN_STEPS] and moved.get("model", 0) > 0 and moved.get("ema", 0) > 0
    log(f"  steady state (steps 2-{XL_TRAIN_STEPS}): {sps:.4f} steps/s, {sps * XL_TRAIN_BATCH:.4f} latents/s, "
        f"{record['tflops']:.4f} TFLOP/s, MFU {record['mfu']:.4f} (3x forward FLOPs over 989 TFLOP/s); "
        f"{seconds:.2f} s for the whole call; peak memory {peak:.3f} GB; max |change| of the seeded gate weights "
        f"{moved.get('model', 0):.6g}, of their EMA {moved.get('ema', 0):.6g}; final checkpoint at step {saved} not "
        f"written; on {smi} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{arch} training: a non-finite loss or gradient norm, the weights or the EMA did not move, "
                         "or the run did not end at its last step")
    counts[f"{name}_grad"] = grad_check_phase(dev, count_path=f"{name}_grad", model_type=arch, depth=XL_GRAD_DEPTH)
    return record, counts


def xl_legs(dev, smi: str, tmp: str) -> tuple:
    """5(b) and (c). Returns (record, launch counts by path)."""
    t0 = time.perf_counter()
    record, counts = {}, {}
    with registry_depth(XL_MODEL, XL_SAMPLE_DEPTH):
        record["sampling"], c = xl_sampling_leg(dev, smi, tmp)
    counts |= c
    record["training"], c = training_leg(dev, smi, tmp)
    counts |= c
    record["legs_s"] = time.perf_counter() - t0
    log(f"  the XL legs took {record['legs_s']:.2f} s; on {smi}")
    return record, counts


def xl_only(dev, smi: str) -> int:
    """``--xl``: build, then the XL phase alone, its kernels as a
    ``{"xl_kernels": [...]}`` line in the kernels line's form."""
    import torch

    from ldmae_tpu_torch import kernels

    t0 = time.perf_counter()
    report = kernels.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    wgmma_ptxas(report)
    rate_probes(dev)
    rows = xl_kernel_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        record, counts = xl_legs(dev, smi, tmp)
    log(json.dumps({"xl": record}))
    log(smi)
    log(json.dumps({"xl_kernels": kernel_rows(rows, counts)}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def xl_kernels_only(dev) -> int:
    """``--xl-kernels``: the attention library alone, then 5(a) without the
    route assertion, through wrappers an earlier tree has too; ends with an
    ``{"xl_kernel_times": {...}}`` line."""
    from ldmae_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build(["flash_attention"])
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    rate_probes(dev)
    rows = xl_kernel_phase(dev, strict=False)
    log(json.dumps({"xl_kernel_times": {name: {"ms": r[1], "library_ms": r[3], "bound_ms": r[4], "parts": r[6]}
                                        for name, r in rows.items()}}))
    return 0


# -- the registry slice: every LightningDiT arch of the registry and every
# parallel.quant mode through the sampling CLI's pipeline builder, on the
# shipped YAML with model.model_type and parallel.quant changed (xl_yaml):
# XL/1 under w8a8 and B/1 under w8 through cli.inference at 50 steps; L/2,
# XL/2 and 1p6B/1 at 10 steps in bf16 and w8a8 (the patch-2 archs' 256
# tokens; L's and 1p6B's SwiGLU widths 2,730 and 4,778, which #10 takes by
# its realigning kernel; the row engine's widest D, 1,792), at
# depth REG_SHORT_DEPTH. Each at full width, seeded weights, batch 8, CFG
# 10, shift 0.3. Also alone under --registry.
# the legs through cli.inference: name -> (arch, parallel.quant, depth), at
# REG_CLI_STEPS (cut from 250 to keep the script inside its time limit)
REG_CLI_STEPS = 50
REG_CLI = {"xl1_w8a8": (XL_MODEL, "w8a8", XL_SAMPLE_DEPTH), "b1_w8": ("LightningDiT-B/1", "w8", DEPTH)}
# the 10-step legs: arch -> (name, depth, tokens, whether #4's tiling takes
# its w12 at every batch of the chain: M % 128, D % 128 and 2H % 256)
REG_SHORT = {"LightningDiT-L/2": ("l2", 24, 256, False), "LightningDiT-XL/2": ("xl2", 28, 256, True),
             "LightningDiT-1p6B/1": ("1p6b1", 28, 1024, False)}
# their depth, cut from the arch's to keep the script inside its time limit
# (every width, head dim and token count stays; the seeded draws shrink)
REG_SHORT_DEPTH = 8
REG_LAT_REL = 5e-2  # 10-step latents, kernels vs the plain xla path: relative L2 (the B/1 and XL gates' bound)
# The quant gate's bound is QUANT_REL_MAX (set at B/1) wherever the plain
# xla paths, with no port kernel, read within it themselves. At an arch where
# the quantization's own error reads above it (1p6B/1: 0.0357 against bf16 on
# an H100 80GB HBM3 at 700 W), the kernels are held to that reading: within
# QUANT_PLAIN_REL times it (at every registry leg on an H100 the kernels read
# within 1 % of the plain paths; the weight-scale control reads 5x above).
QUANT_PLAIN_REL = 1.05


def _reg_counts(depth: int, steps: int, quant=None, fused_w12: bool = True, decode: bool = False) -> dict:
    """Exact launches of ``steps`` Euler steps (steps - 1 DiT forwards, single
    or CFG-doubled alike) at ``depth``: bf16 and w8 run #1 once and #3 twice
    a block, #4 where its tiling takes w12 (bf16 only: under w8 w12 is a
    quantized linear), and dense the forward's five linears plus the block's
    adaLN, qkv, proj, w3 and w12 (unless #4); w8a8 runs #1, #9 twice, #10
    and int8_dense four times a block, dense the five and proj. ``decode``:
    and the VMAE decode's."""
    f = (steps - 1) * depth
    if quant == "w8a8":
        c = {"flash_attention_rope": f, "fused_norm_modulate_quant": 2 * f, "fused_silu_mul_quant": f,
             "int8_dense": 4 * f, "dense_bias_f32": (steps - 1) * (5 + depth)}
    else:
        w12 = fused_w12 and quant is None
        c = {"flash_attention_rope": f, "fused_norm_modulate": 2 * f, "fused_matmul_silu": f if w12 else 0,
             "dense_bias_f32": (steps - 1) * (5 + (4 if w12 else 5) * depth)}
    if decode:
        c |= {"flash_attention_resident": DEC_DEPTH, "dense_bias_f32": c["dense_bias_f32"] + _DENSE_DECODE}
    return _NONE | c


for _name, (_arch, _quant, _depth) in REG_CLI.items():
    EXPECTED_LAUNCHES[f"reg_{_name}"] = _reg_counts(_depth, REG_CLI_STEPS, _quant, decode=True)
    EXPECTED_LAUNCHES[f"reg_{_name}_short"] = _reg_counts(_depth, SHORT_STEPS, _quant)
    EXPECTED_LAUNCHES[f"reg_{_name.split('_')[0]}_bf16_short"] = _reg_counts(_depth, SHORT_STEPS)
for _name, _depth, _tokens, _w12 in REG_SHORT.values():
    for _quant in ("bf16", "w8a8"):
        EXPECTED_LAUNCHES[f"reg_{_name}_{_quant}_short"] = _reg_counts(
            REG_SHORT_DEPTH, SHORT_STEPS, None if _quant == "bf16" else _quant, _w12)
EXPECTED_LAUNCHES["reg_xla"] = dict(_NONE)  # the plain reference path: no port kernel
# kernels-line rows of the registry's new shapes: launches from the leg that runs each
_FQ = "ldmae_tpu_torch/csrc/fused_quant.cu"
KERNELS |= {
    "fused_silu_mul_quant_l2": (_FQ, f"{_PALLAS_AD}:144", "reg_l2_w8a8_short", "fused_silu_mul_quant"),
    "fused_silu_mul_quant_1p6b1": (_FQ, f"{_PALLAS_AD}:144", "reg_1p6b1_w8a8_short", "fused_silu_mul_quant"),
    "fused_silu_mul_quant_xl1": (_FQ, f"{_PALLAS_AD}:144", "reg_xl1_w8a8", "fused_silu_mul_quant"),
    "fused_norm_modulate_quant_xl1": (_FQ, f"{_PALLAS_AD}:99", "reg_xl1_w8a8", "fused_norm_modulate_quant"),
    "fused_norm_modulate_quant_1p6b1": (_FQ, f"{_PALLAS_AD}:99", "reg_1p6b1_w8a8_short", "fused_norm_modulate_quant"),
    "flash_attention_rope_l2": (_FA, f"{_PALLAS_FA}:323", "reg_l2_bf16_short", "flash_attention_rope"),
    "flash_attention_rope_xl2": (_FA, f"{_PALLAS_FA}:323", "reg_xl2_bf16_short", "flash_attention_rope"),
    "int8_dense_xl1_w12": (_DENSE, "ldmae_tpu/ops/quant.py:97", "reg_xl1_w8a8", "int8_dense"),
    "int8_dense_xl1_w3": (_DENSE, "ldmae_tpu/ops/quant.py:97", "reg_xl1_w8a8", "int8_dense"),
    "int8_dense_1p6b1_w12": (_DENSE, "ldmae_tpu/ops/quant.py:97", "reg_1p6b1_w8a8_short", "int8_dense"),
    "int8_dense_1p6b1_w3": (_DENSE, "ldmae_tpu/ops/quant.py:97", "reg_1p6b1_w8a8_short", "int8_dense"),
}


def _gate_instantiation(fn) -> str:
    """Which of the gate's kernels ``fn`` launched, by its name under
    torch.profiler: 'realigning' (``silu_mul_quant_any_kernel``), 'vector'
    (``silu_mul_quant_kernel``), or 'not measured' when the trace holds no
    record of either."""
    names = [key for key, _ in _profiled(fn, 3) if "silu_mul_quant_" in key and "_kernel" in key]
    if not names:
        return "not measured"
    return "realigning" if all("any_kernel" in k for k in names) else "vector" if not any(
        "any_kernel" in k for k in names) else f"unclear ({names})"


def int8_dense_plain_any(x_q, x_scale, p, compute_dtype):
    """``int8_dense``'s plain version at any K and N: torch._int_mm takes K
    and N that are multiples of 8 on the card, so both are zero-padded to
    one (zero columns and rows add nothing to the int32 sums) and the padded
    columns dropped after the fp32 dequant."""
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops.quant import QLinear, int8_dense_plain

    k, n = x_q.shape[-1], p.w_q.shape[0]
    if k % 8 == 0 and n % 8 == 0:
        return int8_dense_plain(x_q, x_scale, p, compute_dtype)
    a = F.pad(x_q.reshape(-1, k), (0, -k % 8))
    padded = QLinear(F.pad(p.w_q, (0, -k % 8, 0, -n % 8)), F.pad(p.w_scale, (0, -n % 8)),
                     None if p.bias is None else F.pad(p.bias, (0, -n % 8)))
    out = int8_dense_plain(a, x_scale.reshape(-1, 1), padded, compute_dtype)
    return out[:, :n].reshape(*x_q.shape[:-1], n)


@contextlib.contextmanager
def plain_linears():
    """The xla path with no port kernel in it: the two linear kernels that
    the xla impls still reach, ``dense``'s bf16 linear and the w8a8 linear,
    replaced by plain versions (cuBLAS bf16 with fp32 sums out, then the
    fp32 bias and one rounding, as ``dense_bias_f32`` computes; and
    ``int8_dense_plain_any``). The kernels' wrappers count no launch."""
    import torch

    from ldmae_tpu_torch.ops import linear, quant

    def dense_plain(x, weight, bias):
        return (torch.mm(x, weight.t(), out_dtype=torch.float32) + bias).to(torch.bfloat16)

    saved = linear.dense_bias_f32, quant.int8_dense
    linear.dense_bias_f32, quant.int8_dense = dense_plain, int8_dense_plain_any
    try:
        yield
    finally:
        linear.dense_bias_f32, quant.int8_dense = saved


def seeded_init_on_device(module, seed: int, std: float = 0.02):
    """``models.seeded_init_``'s weights (every parameter normal(0, std) in
    ``named_parameters`` order, norm weights 1 + that), drawn on the
    module's device by a ``torch.Generator`` seeded with ``seed``: the
    numpy draws on the host took about 1 s a 5.5e7 values (30 s at 1p6B/1).
    The same distribution, other values; every gate that reads them is
    relative to a path on the same weights and keeps its control."""
    import torch
    import torch.nn as nn

    from ldmae_tpu_torch.models.lightningdit import RMSNorm

    norms = {f"{name}.weight" if name else "weight" for name, m in module.named_modules()
             if isinstance(m, (RMSNorm, nn.LayerNorm))}
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            v = torch.randn(p.shape, generator=gen, device=dev) * std
            p.copy_(v + 1.0 if name in norms else v)
    return module


@contextlib.contextmanager
def seeded_once():
    """The sampling CLI's pipeline builder with its seeded DiT weights drawn
    on the card (``seeded_init_on_device``) once an arch: the first build of
    an arch keeps a copy of them on the card, a later build (another
    parallel.quant, the CLI call itself, the XL and the registry slices'
    XL/1) loads that copy."""
    from ldmae_tpu_torch.cli import inference

    real, cache = inference.seeded_init_, {}

    def init(module, seed, std=0.02):
        key = (getattr(module, "spec", None), seed, std)
        if key in cache:
            module.load_state_dict(cache[key], strict=True)
            return module
        seeded_init_on_device(module, seed, std)
        cache[key] = {k: v.detach().clone() for k, v in module.state_dict().items()}
        return module

    inference.seeded_init_ = init
    try:
        yield
    finally:
        inference.seeded_init_ = real
        cache.clear()


def gate_ptxas(report: dict) -> None:
    """ptxas's registers and spills of the gate's kernels' instantiations
    (#10 and its halves: vector and realigning)."""
    lines = report["fused_quant"]["ptxas"].splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "silu_mul_quant_" in line and "_kernel" in line:
            name = re.sub(r".*silu_mul_quant_", "silu_mul_quant_", line).strip()
            stats = [ln.strip() for ln in lines[i + 1:i + 5] if "registers" in ln or "spill" in ln]
            log(f"  ptxas {name}: {'; '.join(stats)}")


def registry_kernel_phase(dev) -> dict:
    """The registry's new kernel shapes, early in the process: #10 at L/2's
    and 1p6B/1's SwiGLU widths (H 2,730 at 16 x 256 rows, 4,778 at 16 x
    1,024; the realigning kernel) and at XL's 3,072 (the vector one), its
    two tp halves at the tp-2 ranks' widths 1,365 and 2,389 (a
    ``{"gate_tp_halves": [...]}`` line), #9 at D 1,152 and 1,792, #1 at the patch-2 archs' (16, 16, 256, 64)
    and (16, 16, 256, 72), and int8_dense at XL's and 1p6B's w12 and w3, each
    against its plain version (the quantizing kernels within one int8 step;
    #1 the attention tolerance; int8_dense bit for bit), timed beside the
    plain version, SDPA for #1 and the bound. Returns the kernels line's
    rows."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops import fused_adaln as fad
    from ldmae_tpu_torch.ops.quant import QLinear, _int_mm, int8_dense
    from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

    g = torch.Generator(device=dev).manual_seed(19)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    rows = {}
    for name, tokens, h, want in (("fused_silu_mul_quant_l2", 256, 2730, "realigning"),
                                  ("fused_silu_mul_quant_1p6b1", 1024, 4778, "realigning"),
                                  ("fused_silu_mul_quant_xl1", 1024, 3072, "vector")):
        b = 2 * BATCH
        log(f"[registry kernel] fused_silu_mul_quant x12 ({b},{tokens},{2 * h}) bf16 -> int8 ({b},{tokens},{h})")
        x12 = randn(b, tokens, 2 * h, scale=2.0)
        err = compare_quant(name, fad.fused_silu_mul_quant(x12), fad.fused_silu_mul_quant_plain(x12))
        ms = cuda_ms(lambda: fad.fused_silu_mul_quant(x12), 50)
        parts = {"queued_ms": queued_ms(lambda: fad.fused_silu_mul_quant(x12))}
        plain_ms = cuda_ms(lambda: fad.fused_silu_mul_quant_plain(x12), 10)
        m = b * tokens
        bnd = bound(m * 2 * h * 2 + m * h + m * 4, fp32_flops=8 * m * h)
        parts["instantiation"] = how = _gate_instantiation(lambda: fad.fused_silu_mul_quant(x12))
        log(f"  {name}: kernel {ms:.4f} ms, queued {parts['queued_ms']:.4f} ({how} instantiation), plain "
            f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), share {bnd[0] / ms:.3f}")
        if how not in (want, "not measured"):
            raise SystemExit(f"{name}: H = {h} ran the {how} kernel, not the {want} one")
        rows[name] = (err, ms, plain_ms, None, *bnd, parts)
        del x12

    # #10's two tp halves at the tp-2 ranks' widths of L and 1p6B (1,365 and
    # 2,389, the realigning kernel; no leg of this script runs them, so their
    # rows are a line of their own, not the kernels line's)
    halves = []
    for name, tokens, h in (("l2_tp2", 256, 1365), ("1p6b1_tp2", 1024, 2389)):
        b = 2 * BATCH
        m = b * tokens
        log(f"[registry kernel] silu_mul_amax, silu_mul_quant_scaled x12 ({b},{tokens},{2 * h}) bf16 (a tp-2 rank's "
            f"slice)")
        x12 = randn(b, tokens, 2 * h, scale=2.0)
        amax, ref_amax = fad.silu_mul_amax(x12), fad.silu_mul_amax_plain(x12)
        err_amax = compare(f"silu_mul_amax_{name}", amax, ref_amax, rtol=1e-6, atol=0.0)
        err = compare_quant(f"silu_mul_quant_scaled_{name}", fad.silu_mul_quant_scaled(x12, ref_amax),
                            fad.silu_mul_quant_scaled_plain(x12, ref_amax))
        for what, run, plain, nbytes in (
                ("silu_mul_amax", lambda: fad.silu_mul_amax(x12), lambda: fad.silu_mul_amax_plain(x12),
                 m * 2 * h * 2 + m * 4),
                ("silu_mul_quant_scaled", lambda: fad.silu_mul_quant_scaled(x12, ref_amax),
                 lambda: fad.silu_mul_quant_scaled_plain(x12, ref_amax), m * 2 * h * 2 + m * h + 2 * m * 4)):
            ms, plain_ms = cuda_ms(run, 50), cuda_ms(plain, 10)
            bnd = bound(nbytes, fp32_flops=(6 if what == "silu_mul_amax" else 8) * m * h)
            how = _gate_instantiation(run)
            row = {"name": f"{what}_{name}", "route": "cuda", "source": _FQ, "replaces": f"{_PALLAS_AD}:144",
                   "shape": [b, tokens, 2 * h], "max_abs_err": err_amax if what == "silu_mul_amax" else err,
                   "ms": ms, "queued_ms": queued_ms(run), "plain_ms": plain_ms, "bound_ms": bnd[0],
                   "bound_by": bnd[1], "library_ms": None, "kernel": how}
            log(f"  {row['name']}: kernel {ms:.4f} ms, queued {row['queued_ms']:.4f} ({how} kernel), plain "
                f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), share {bnd[0] / ms:.3f}")
            if how not in ("realigning", "not measured"):
                raise SystemExit(f"{row['name']}: H = {h} ran the {how} kernel, not the realigning one")
            halves.append(row)
        del x12, amax, ref_amax
    log(json.dumps({"gate_tp_halves": halves}))

    for name, d in (("fused_norm_modulate_quant_xl1", 1152), ("fused_norm_modulate_quant_1p6b1", 1792)):
        b, n = 2 * BATCH, 1024
        log(f"[registry kernel] fused_norm_modulate_quant x ({b},{n},{d}) bf16, shift/scale views of ({b},6,{d})")
        x = randn(b, n, d, scale=3.0)
        w = 1 + 0.1 * randn(d, dtype=torch.float32)
        mod = randn(b, 6, d, scale=0.1)
        sh, sc = mod[:, 0], mod[:, 1]
        err = compare_quant(name, fad.fused_norm_modulate_quant(x, w, sh, sc),
                            fad.fused_norm_modulate_quant_plain(x, w, sh, sc))
        ms = cuda_ms(lambda: fad.fused_norm_modulate_quant(x, w, sh, sc), 50)
        parts = {"queued_ms": queued_ms(lambda: fad.fused_norm_modulate_quant(x, w, sh, sc)),
                 "cold_ms": cold_ms(lambda: fad.fused_norm_modulate_quant(x, w, sh, sc))}
        plain_ms = cuda_ms(lambda: fad.fused_norm_modulate_quant_plain(x, w, sh, sc), 10)
        bnd = bound(b * n * d * 3 + b * n * 4 + d * 4 + 2 * b * d * 2, fp32_flops=9 * b * n * d)
        log(f"  {name}: kernel {ms:.4f} ms, queued {parts['queued_ms']:.4f}, cold L2 {parts['cold_ms']:.4f}; plain "
            f"{plain_ms:.4f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}), share {bnd[0] / ms:.3f}")
        rows[name] = (err, ms, plain_ms, None, *bnd, parts)
        del x, mod

    for name, d in (("flash_attention_rope_l2", 64), ("flash_attention_rope_xl2", 72)):
        b, h, n = 2 * BATCH, 16, 256
        log(f"[registry kernel] flash_attention_rope q,k,v ({b},{h},{n},{d}) bf16, cos/sin ({n},{d}) fp32")
        q, k, v = randn(b, h, n, d), randn(b, h, n, d), randn(b, h, n, d)
        cos, sin = (torch.from_numpy(to_half_layout(t)).to(dev) for t in build_rope_table(d // 2, 16))
        ref = fa.flash_attention_rope_plain(q, k, v, cos, sin)
        err = compare(name, fa.flash_attention_rope(q, k, v, cos, sin), ref, **attn_tol(ref))
        del ref
        ms = cuda_ms(lambda: fa.flash_attention_rope(q, k, v, cos, sin), 50)
        plain_ms = cuda_ms(lambda: fa.flash_attention_rope_plain(q, k, v, cos, sin), 5, 1)
        qr, kr = fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qr, kr, v), 50)
        bnd = bound(4 * b * h * n * d * 2 + 2 * n * d * 4, 4 * b * h * n * n * d, exps=b * h * n * n)
        parts = xl_route(name, lambda: fa.flash_attention_rope(q, k, v, cos, sin), True)
        parts |= {"queued_ms": queued_ms(lambda: fa.flash_attention_rope(q, k, v, cos, sin)),
                  "library_queued_ms": queued_ms(lambda: F.scaled_dot_product_attention(qr, kr, v)),
                  "host_ms": host_ms(lambda: fa.flash_attention_rope(q, k, v, cos, sin))}
        log(f"  {name}: kernel {ms:.4f} ms (queued {parts['queued_ms']:.4f}, host a call {parts['host_ms']:.4f}; "
            + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in parts["kernels_ms"].items())
            + f"), plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms (queued {parts['library_queued_ms']:.4f}; kernel / "
            f"SDPA {ms / lib_ms:.3f}), bound {bnd[0]:.4f} ms ({bnd[1]}), share {bnd[0] / ms:.3f}")
        rows[name] = (err, ms, plain_ms, lib_ms, *bnd, parts)
        del q, k, v, qr, kr

    m = 2 * BATCH * 1024
    for name, k, n in (("int8_dense_xl1_w12", 1152, 6144), ("int8_dense_xl1_w3", 3072, 1152),
                       ("int8_dense_1p6b1_w12", 1792, 9556), ("int8_dense_1p6b1_w3", 4778, 1792)):
        log(f"[registry kernel] int8_dense x_q ({m},{k}) int8, w_q ({n},{k}) int8, fp32 scales and bias -> bf16")
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
        p = QLinear(w, torch.rand(n, generator=g, device=dev) * 1e-3, torch.randn(n, generator=g, device=dev))
        xs = torch.rand(m, 1, generator=g, device=dev) * 1e-2
        out, ref = int8_dense(a, xs, p, torch.bfloat16), int8_dense_plain_any(a, xs, p, torch.bfloat16)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            raise SystemExit(f"{name}: not bit for bit the plain version "
                             f"(max |diff| {float((out.float() - ref.float()).abs().max())})")
        ms = cuda_ms(lambda: int8_dense(a, xs, p, torch.bfloat16), 20)
        parts = {"queued_ms": queued_ms(lambda: int8_dense(a, xs, p, torch.bfloat16))}
        plain_ms = cuda_ms(lambda: int8_dense_plain_any(a, xs, p, torch.bfloat16), 10)
        takes = k % 8 == 0 and n % 8 == 0
        # torch._int_mm takes K and N that are multiples of 8 on the card: off
        # them, the same product on operands zero-padded to 8 (padded once,
        # outside the timing)
        ap, wp = (a, w) if takes else (F.pad(a, (0, -k % 8)), F.pad(w, (0, -k % 8, 0, -n % 8)))
        parts |= {"int_mm_ms": queued_ms(lambda: _int_mm(ap, wp)), "int_mm_padded": not takes}
        bnd = bound(m * k + n * k + m * n * 2 + 4 * m + 8 * n, int8_ops=2 * m * k * n)
        log(f"  {name} M={m} K={k} N={n}: bit for bit the plain version; kernel {ms:.4f} ms, queued "
            f"{parts['queued_ms']:.4f}; plain (torch._int_mm{'' if takes else ' on K and N padded to 8'} + the "
            f"dequant) {plain_ms:.4f} ms; torch._int_mm alone {parts['int_mm_ms']:.4f}"
            f"{'' if takes else ' (on K and N padded to 8, as it takes them)'}; bound {bnd[0]:.4f} ms ({bnd[1]}), "
            f"share {bnd[0] / ms:.3f}")
        rows[name] = (0.0, ms, plain_ms, None, *bnd, parts)
        del a, w, p, out, ref, ap, wp
    torch.cuda.empty_cache()
    return rows


def _reg_rel(lat, ref) -> tuple:
    """(relative L2 ||lat - ref|| / ||ref||, max |lat - ref| / max |ref|)."""
    d = lat.float() - ref.float()
    return float(d.norm() / ref.float().norm()), float(d.abs().max() / ref.float().abs().max())


def _reg_run(what: str, fn, path=None):
    """One 10-step chain, timed, its launches counted from 0 (with ``path``
    checked exactly). Returns (latents, seconds, launch counts)."""
    import torch

    from ldmae_tpu_torch import ops

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lat = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    if path is not None:
        check_counts(path, counts)
    if not (torch.isfinite(lat).all() and lat.shape == (BATCH, 16, 32, 32)):
        raise SystemExit(f"{what}: the latents are not finite ({BATCH}, 16, 32, 32)")
    return lat, seconds, counts


def _scales_up(qdit):
    """The quantized DiT with every weight scale 10 % high: the quant gate's control."""
    import torch

    from ldmae_tpu_torch.ops.quant import QLinear

    dit = copy.deepcopy(qdit)
    with torch.no_grad():
        for m in dit.modules():
            if isinstance(m, QLinear):
                m.w_scale.mul_(1.1)
    return dit


def registry_gates(dev, what: str, spec, bundles: dict, counts_of: dict, y) -> dict:
    """The 10-step gates of one leg, from the pipeline builder's bundles
    (``bundles``: quant mode -> bundle, None for bf16): each mode's kernels
    (launches exact, ``counts_of[mode]``) against the same mode's plain xla
    path with no port kernel (``plain_linears``; its launches all 0) from
    one noise z, within REG_LAT_REL relative L2 (control: the kernels from
    another noise, which must read above); each quantized mode against the
    bf16 kernels from z, ||q - bf16|| / ||bf16 - z|| within QUANT_REL_MAX,
    or within QUANT_PLAIN_REL of the plain xla paths' own reading where that
    is above QUANT_REL_MAX (control: the weight scales 10 % high, which must
    read above the bound); each
    mode's latents decoded (#2) to finite images that are not flat. Returns
    (the readings and seconds, {path: counts})."""
    import torch

    gen = torch.Generator(device=dev)
    z, z2 = (torch.randn(BATCH, 16, 32, 32, generator=gen.manual_seed(s), device=dev) for s in QUANT_NOISE_SEEDS)
    record, lats, plain, counts = {}, {}, {}, {}
    for quant, bundle in bundles.items():
        mode = quant or "bf16"
        latents = dict(bundle, vae=None)
        fk = sampler(spec, SHORT_STEPS, dev, kernels=True, quant=quant)
        fx = sampler(spec, SHORT_STEPS, dev, kernels=False, quant=quant)
        fk(latents, y, z=z)  # warm-up
        lat_k, sec_k, counts[counts_of[quant]] = _reg_run(f"{what} {mode} kernels", lambda: fk(latents, y, z=z),
                                                          counts_of[quant])
        with plain_linears():
            lat_x, sec_x, _ = _reg_run(f"{what} {mode} xla", lambda: fx(latents, y, z=z), "reg_xla")
        lat_c, _, _ = _reg_run(f"{what} {mode} control", lambda: fk(latents, y, z=z2))
        (rel, rel_max), (control, _) = _reg_rel(lat_k, lat_x), _reg_rel(lat_c, lat_x)
        moved = float((lat_x - z).abs().max())
        imgs = bundle["vae"].decode_to_images(lat_k, compute_dtype=torch.bfloat16, attn_impl="flash_rope")
        std = float(imgs.float().std())
        ok = rel <= REG_LAT_REL and control > REG_LAT_REL and moved > 1e-2 and std > 1.0
        record[mode] = {"rel_l2": rel, "rel_max": rel_max, "control_rel_l2": control, "moved": moved,
                        "image_std": std, "kernels_s": sec_k, "xla_s": sec_x}
        log(f"  {what} {mode}: {SHORT_STEPS}-step latents vs the plain xla path (no port kernel): relative L2 "
            f"{rel:.6g} (bound {REG_LAT_REL}), max rel {rel_max:.6g}; control (another noise) {control:.6g} (must "
            f"exceed {REG_LAT_REL}); moved {moved:.4g} from z; decoded images {tuple(imgs.shape)} pixel std "
            f"{std:.3f}; {sec_k:.4f} s a batch (kernels), {sec_x:.4f} s (xla) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{what} {mode}: the kernels' latents disagree with xla, the control reads within "
                             f"the gate, or the images are flat")
        lats[quant], plain[quant] = lat_k, lat_x
        del lat_c, imgs
    for quant, bundle in bundles.items():
        if quant is None:
            continue
        ref = lats[None]
        moved = (ref.float() - z).norm()
        rel = float((lats[quant].float() - ref.float()).norm() / moved)
        control_dit = _scales_up(bundle["dit"])
        fc = sampler(spec, SHORT_STEPS, dev, kernels=True, quant=quant)
        lat_c, _, _ = _reg_run(f"{what} {quant} control", lambda: fc(dict(bundle, vae=None, dit=control_dit), y, z=z))
        control = float((lat_c.float() - ref.float()).norm() / moved)
        # the same reading of the plain xla paths (no port kernel): the quantization's own error at this arch
        plain_rel = float((plain[quant].float() - plain[None].float()).norm() / (plain[None].float() - z).norm())
        bound_ = QUANT_REL_MAX if plain_rel <= QUANT_REL_MAX else QUANT_PLAIN_REL * plain_rel
        ok = rel <= bound_ and control > bound_
        record[quant] |= {"quant_rel": rel, "quant_control_rel": control, "plain_quant_rel": plain_rel,
                          "quant_bound": bound_, "within_quant_rel_max": rel <= QUANT_REL_MAX}
        log(f"  {what} {quant} vs bf16 kernels from one noise: ||{quant} - bf16|| / ||bf16 - z|| {rel:.6g}; the "
            f"plain xla paths' own reading {plain_rel:.6g}; bound {bound_:.6g} (QUANT_REL_MAX {QUANT_REL_MAX}"
            + ("" if bound_ == QUANT_REL_MAX else f", which the plain paths exceed: {QUANT_PLAIN_REL} x their reading")
            + f"); control (weight scales x 1.1) {control:.6g} (must exceed the bound) -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{what}: {quant} latents out of bound, or the control within it")
        del control_dit, lat_c
    del plain
    torch.cuda.empty_cache()
    return record, counts


def _reg_config(tmp: str, name: str, arch: str, quant, **sample):
    from ldmae_tpu_torch.core.config import LDMAEConfig

    out_root = os.path.join(tmp, f"reg_{name}_out")
    path = xl_yaml(os.path.join(tmp, f"reg_{name}_{quant or 'bf16'}.yaml"), arch, ckpt_path=None,
                   vae={"weight_path": ""}, parallel={"quant": quant},
                   train={"output_dir": out_root, "exp_name": f"reg_{name}"},
                   sample={"per_proc_batch_size": BATCH, "fid_num": BATCH} | sample)
    return path, LDMAEConfig.from_yaml(path)


def registry_cli_leg(dev, smi: str, tmp: str, name: str) -> tuple:
    """XL/1 under w8a8 or B/1 under w8 (``REG_CLI[name]``): the 10-step gates
    from the pipeline builder's bf16 and quantized bundles, then one batch of
    8 through ``cli.inference`` on the YAML with parallel.quant set, 250
    Euler steps, CFG 10 on [0.10, 1] phased, decoded to PNGs, launches
    exact, the batch's seconds timed inside the CLI's pipeline, images/s,
    peak memory. Returns (record, {path: counts})."""
    import numpy as np
    import torch
    from PIL import Image

    from ldmae_tpu_torch import ops
    from ldmae_tpu_torch.cli import inference

    arch, quant, depth = REG_CLI[name]
    path, cfg = _reg_config(tmp, name, arch, quant, num_sampling_steps=REG_CLI_STEPS)
    _, bf16_cfg = _reg_config(tmp, name, arch, None)
    short = name.split("_")[0]
    log(f"[registry] {arch} under parallel.quant {quant}: {SHORT_STEPS}-step gates (the CLI's build_pipeline, "
        f"seeded), batch {BATCH}")
    _, qbundle, spec = inference.build_pipeline(cfg, device=dev)
    _, bundle, _ = inference.build_pipeline(bf16_cfg, device=dev)
    if (spec.depth, spec.num_patches) != (depth, 1024):
        raise SystemExit(f"{arch}: depth {spec.depth}, {spec.num_patches} tokens")
    y = torch.arange(BATCH, device=dev) * 125 % 1000
    record, counts = registry_gates(dev, arch, spec, {None: bundle, quant: qbundle},
                                    {None: f"reg_{short}_bf16_short", quant: f"reg_{name}_short"}, y)
    del bundle, qbundle
    torch.cuda.empty_cache()

    log(f"[registry] cli.inference: {arch} + VMAE f8d16 (seeded), parallel.quant {quant}, batch {BATCH}, "
        f"{REG_CLI_STEPS} Euler steps, shift {cfg.sample.timestep_shift}, CFG {cfg.sample.cfg_scale} on "
        f"[{cfg.sample.cfg_interval_start}, 1] (phased), PNGs")
    build = inference.build_pipeline
    batch_s = []

    def timed_pipeline(*args, **kwargs):
        fn, bundle_, spec_ = build(*args, **kwargs)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            imgs = fn(*a, **kw)
            torch.cuda.synchronize()
            batch_s.append(time.perf_counter() - t)
            return imgs

        return timed, bundle_, spec_

    inference.build_pipeline = timed_pipeline
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        folder = inference.main(["--config", path, "--skip_fid"])
    finally:
        inference.build_pipeline = build
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts[f"reg_{name}"] = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    check_counts(f"reg_{name}", counts[f"reg_{name}"])
    pngs = sorted(f for f in os.listdir(folder) if f.endswith(".png"))
    imgs = np.stack([np.asarray(Image.open(os.path.join(folder, f))) for f in pngs])
    ok = (pngs == [f"{i:06d}.png" for i in range(BATCH)] and imgs.shape == (BATCH, 256, 256, 3)
          and float(imgs.std()) > 1.0 and len(batch_s) == 1)
    sec = batch_s[0] if batch_s else float("nan")
    record["cli"] = {"seconds_batch": sec, "images_per_s": BATCH / sec, "cli_s": cli_s, "peak_gb": peak,
                     "steps": REG_CLI_STEPS, "quant": quant}
    log(f"  launches exact; PNGs {pngs[0]}..{pngs[-1]} {imgs.shape}, pixel std {float(imgs.std()):.3f}; {sec:.4f} s "
        f"per batch of {BATCH} ({BATCH / sec:.4f} images/s), the whole CLI call {cli_s:.2f} s; peak memory "
        f"{peak:.3f} GB; on {smi} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"registry {name}: the sampling CLI's PNGs are not the batch's 8 images")
    torch.cuda.empty_cache()
    return record, counts


def registry_short_leg(dev, smi: str, tmp: str, arch: str) -> tuple:
    """``arch`` (``REG_SHORT``) at full width, depth REG_SHORT_DEPTH (cut in
    this process's model registry while the CLI's pipeline builder reads
    it), bf16 and parallel.quant w8a8: the 10-step gates
    (``registry_gates``), each run's seconds, the leg's peak memory.
    Returns (record, {path: counts})."""
    import torch

    from ldmae_tpu_torch.cli import inference

    name, _, tokens, fused_w12 = REG_SHORT[arch]
    _, cfg = _reg_config(tmp, name, arch, None)
    _, qcfg = _reg_config(tmp, name, arch, "w8a8")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with registry_depth(arch, REG_SHORT_DEPTH):
        _, bundle, spec = inference.build_pipeline(cfg, device=dev)
        _, qbundle, _ = inference.build_pipeline(qcfg, device=dev)
    build_s = time.perf_counter() - t0
    m = 2 * BATCH * spec.num_patches
    takes = m % 128 == 0 and spec.hidden_size % 128 == 0 and 2 * spec.swiglu_hidden % 256 == 0
    if (spec.depth, spec.num_patches, takes) != (REG_SHORT_DEPTH, tokens, fused_w12):
        raise SystemExit(f"{arch}: depth {spec.depth}, {spec.num_patches} tokens, #4 takes w12: {takes}")
    log(f"[registry] {arch} (depth {spec.depth}, width {spec.hidden_size}, {spec.num_heads} heads of "
        f"{spec.head_dim}, SwiGLU {spec.swiglu_hidden}, {spec.num_patches} tokens): {SHORT_STEPS} steps, batch "
        f"{BATCH}, bf16 and w8a8 through the CLI's build_pipeline (seeded, built in {build_s:.2f} s)")
    y = torch.arange(BATCH, device=dev) * 125 % 1000
    record, counts = registry_gates(dev, arch, spec, {None: bundle, "w8a8": qbundle},
                                    {None: f"reg_{name}_bf16_short", "w8a8": f"reg_{name}_w8a8_short"}, y)
    record |= {"build_s": build_s, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  {arch}: peak memory {record['peak_gb']:.3f} GB; on {smi}")
    del bundle, qbundle
    torch.cuda.empty_cache()
    return record, counts


def registry_legs(dev, smi: str, tmp: str) -> tuple:
    """The registry slice's legs: the two 250-step CLI legs, then the three
    10-step legs, inside the caller's ``seeded_once``. Returns (record,
    {path: counts})."""
    t0 = time.perf_counter()
    record, counts = {}, {}
    for name, (arch, _, depth) in REG_CLI.items():
        t1 = time.perf_counter()
        with registry_depth(arch, depth):
            record[name], c = registry_cli_leg(dev, smi, tmp, name)
        record[name]["leg_s"] = time.perf_counter() - t1
        counts |= c
    for arch in REG_SHORT:
        t1 = time.perf_counter()
        leg, c = registry_short_leg(dev, smi, tmp, arch)
        record[REG_SHORT[arch][0]] = leg | {"leg_s": time.perf_counter() - t1}
        counts |= c
    log("  seconds a leg: " + ", ".join(f"{k} {v['leg_s']:.2f}" for k, v in record.items()))
    record["legs_s"] = time.perf_counter() - t0
    log(f"  the registry legs took {record['legs_s']:.2f} s; on {smi}")
    return record, counts


# -- the registry's training slice (phase 7d; also under --registry):
# cli.train_dit at LightningDiT-L/2 (24 blocks, D 1,024, 16 heads of 64,
# SwiGLU 2,730, 256 tokens), XL/2 (28, 1,152, 16 of 72, 3,072, 256) and
# 1p6B/1 (28, 1,792, 28 of 64, 4,778, 1,024), each at full width and depth
# on the shipped YAML with model.model_type changed (``training_leg``, the
# XL leg's settings: batch 32, 4 steps); B/2, 1p0B/2 and 1p6B/2 train at
# these N, d and widths. The gradient check at each arch's full width,
# depth 4, and at L/2 and XL/2 under rope_layout interleaved (#2, #5).
# arch -> leg name: the archs of the registry's 10-step sampling legs
REG_TRAIN = {arch: leg[0] for arch, leg in REG_SHORT.items()}
REG_TRAIN_INTERLEAVED = ("LightningDiT-L/2", "LightningDiT-XL/2")


def _reg_spec(arch: str):
    """``arch`` at 32^2 latents with the shipped YAML's model flags."""
    from ldmae_tpu_torch.models import dit_spec

    return dit_spec(arch, input_size=32, in_channels=16, num_classes=1000, use_qknorm=True, use_swiglu=True,
                    use_rope=True, use_rmsnorm=True)


_FNM = "ldmae_tpu_torch/csrc/fused_norm_modulate.cu"
for _name, _depth, _, _ in REG_SHORT.values():
    EXPECTED_LAUNCHES[f"reg_{_name}_train"] = _counts_of("half", XL_TRAIN_STEPS, _depth)
    EXPECTED_LAUNCHES[f"reg_{_name}_grad"] = _counts_of("half", 1, XL_GRAD_DEPTH)
    EXPECTED_LAUNCHES[f"reg_{_name}_grad_interleaved"] = _counts_of("interleaved", 1, XL_GRAD_DEPTH)
    KERNELS |= {
        f"flash_attention_rope_train_{_name}": (_FA, f"{_PALLAS_FA}:323", f"reg_{_name}_train", "flash_attention_rope"),
        f"flash_attention_rope_bwd_train_{_name}": (_FA, f"{_PALLAS_FA}:429", f"reg_{_name}_train",
                                                    "flash_attention_rope_bwd"),
        f"fused_norm_modulate_train_{_name}": (_FNM, f"{_PALLAS_AD}:232", f"reg_{_name}_train", "fused_norm_modulate"),
        f"fused_norm_modulate_bwd_train_{_name}": (_NORM_ROWS, f"{_PALLAS_AD}:263", f"reg_{_name}_train",
                                                   "fused_norm_modulate_bwd_kernel"),
    }
for _arch in REG_TRAIN_INTERLEAVED:
    _name = REG_TRAIN[_arch]
    KERNELS |= {
        f"flash_attention_train_{_name}": (_FA, f"{_PALLAS_FA}:77", f"reg_{_name}_grad_interleaved", "flash_attention"),
        f"flash_attention_bwd_train_{_name}": (_FA, f"{_PALLAS_FA}:151", f"reg_{_name}_grad_interleaved",
                                               "flash_attention_bwd"),
    }
for _name in ("l2", "1p6b1"):  # the SwiGLU widths off a multiple of 8: w12's N, w3's K
    for _what in ("w12", "w3"):
        KERNELS[f"dense_train_{_name}_{_what}"] = (_DENSE, "ldmae_tpu/ops/linear.py:21", f"reg_{_name}_train",
                                                   "dense_bias_f32")
# the backward's kernels at the d = 64 and 72 single pass (and #6's RoPE pre-pass)
BWD_ROUTE = ("flash_bwd_preprocess_kernel", "flash_bwd_wgmma_kernel", "flash_bwd_postprocess_kernel")


def train_route(what: str, fn, want: tuple, absent: tuple = XL_OLD) -> dict:
    """Fails unless the call ``fn`` ran every kernel of ``want`` and none of
    ``absent`` (the mma.sync core and three passes), by ``device_split``;
    returns the parts by name."""

    def route(names):
        return all(w in names for w in want) and not any(n in absent for n in names)

    split = device_split(fn, need=route)
    names = sorted(split)
    ok = route(names)
    log(f"  {what}: kernels that ran {names} -> {'the route' if ok else 'NOT the route'} {list(want)}")
    if not ok:
        raise SystemExit(f"{what}: ran {names}, not {list(want)}")
    return {"kernels_ms": split}


def reg_train_kernel_phase(dev) -> dict:
    """Phase 7d's kernel rows at the training batch (32), early in the
    process: for each of L/2 (32, 16, 256, 64), XL/2 (32, 16, 256, 72) and
    1p6B/1 (32, 28, 1024, 64): #1 with lse, as the autograd Function runs it
    (output within the attention tolerance of the plain version, lse within
    1e-4 + 1e-5 relative), and #6 given that output and lse against the
    plain backward (BWD_REL_L2, BWD_ELEM; controls: no rowsum term, the
    Jacobian untransposed), dq within BWD_REL_L2 from run to run and dk, dv
    equal; at L/2's and XL/2's shape #2 with lse and #5 the same way; each
    timed beside SDPA (its backward as fwd+bwd minus fwd) and the bound, its
    kernels named by torch.profiler (the wgmma forward, the single-pass
    backward). #3 at the three training row shapes: the forward kernel
    against its plain version, then its backward kernel through the autograd
    Function (``fnm_bwd_row``), each timed beside its plain version. ``dense_bias_f32`` at L/2's and 1p6B/1's w12 (N 5,460, 9,556)
    and w3 (K 2,730, 4,778) through ``_DenseBiasF32``: the forward within
    half a bf16 ulp of fp64 (control: the bias rounded first), dx and dw
    within relative L2 1e-2 of the fp32 products and dbias within 1e-5,
    forward and backward timed beside cuBLAS's F.linear. Returns the
    kernels line's rows."""
    import torch
    import torch.nn.functional as F

    from ldmae_tpu_torch.ops import flash_attention as fa
    from ldmae_tpu_torch.ops import fused_adaln as fad
    from ldmae_tpu_torch.ops import linear as lin
    from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout

    gen = torch.Generator(device=dev).manual_seed(20)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    b, rows = XL_TRAIN_BATCH, {}
    for arch, name in REG_TRAIN.items():
        spec = _reg_spec(arch)
        h, n, d = spec.num_heads, spec.num_patches, spec.head_dim
        cos, sin = (torch.from_numpy(to_half_layout(t)).to(dev) for t in build_rope_table(d // 2, int(n**0.5)))
        # q and k at twice unit scale: peaked rows, where the controls move dq and dk past the bound
        q, k = randn(b, h, n, d, scale=2.0), randn(b, h, n, d, scale=2.0)
        v, go = randn(b, h, n, d), randn(b, h, n, d)
        for fwd_name, tab in (("flash_attention_rope", (cos, sin)), ("flash_attention", ())):
            if not tab and arch not in REG_TRAIN_INTERLEAVED:
                continue
            label = f"{fwd_name}_train_{name}"
            log(f"[registry train kernel] {fwd_name} with lse q,k,v ({b},{h},{n},{d}) bf16"
                + (f", cos/sin ({n},{d}) fp32" if tab else " (interleaved: RoPE outside the kernel)"))
            fwd = fa._flash_attention_rope_fwd if tab else fa._flash_attention_fwd
            qr, kr = (fa._rope_fp32(q, cos, sin), fa._rope_fp32(k, cos, sin)) if tab else (q, k)

            def run(fwd=fwd, tab=tab):
                return fwd(q, k, v, *tab, with_lse=True)

            def plain(tab=tab):
                return fa.flash_attention_rope_plain(q, k, v, *tab) if tab else fa.flash_attention_plain(q, k, v)

            ref = plain()
            o, lse = run()
            err = compare(f"{label} output", o, ref, **attn_tol(ref))
            del ref
            compare(f"{label} lse", lse, fa.flash_attention_lse_plain(qr, kr), rtol=1e-5, atol=1e-4)
            ms, plain_ms = cuda_ms(run, 20), cuda_ms(plain, 3, 1)

            def lib():
                return F.scaled_dot_product_attention(qr, kr, v)

            lib_ms = cuda_ms(lib, 20)
            tables = 2 * n * d * 4 if tab else 0
            bnd = bound(4 * b * h * n * d * 2 + b * h * n * 4 + tables, 4 * b * h * n * n * d, exps=b * h * n * n)
            parts = train_route(label, run,
                                ("flash_fwd_wgmma_kernel",) + (("norm_rope_kernel",) if tab else ()))
            # at N 256 the host's launch time can exceed the device's: also both with the queue full
            parts |= {"queued_ms": queued_ms(run, 20), "library_queued_ms": queued_ms(lib, 20)}
            rows[label] = (err, ms, plain_ms, lib_ms, *bnd, parts)
            log(f"  {label}: kernel {ms:.4f} ms (queued {parts['queued_ms']:.4f}), plain {plain_ms:.4f} ms, SDPA "
                f"{lib_ms:.4f} ms (queued {parts['library_queued_ms']:.4f}; queued kernel / SDPA "
                f"{parts['queued_ms'] / parts['library_queued_ms']:.3f}), bound {bnd[0]:.4f} ms ({bnd[1]}), share "
                f"{bnd[0] / ms:.3f} (queued {bnd[0] / parts['queued_ms']:.3f})")

            label = f"{fwd_name}_bwd_train_{name}"
            want = BWD_ROUTE + (("norm_rope_kernel",) if tab else ())
            rows[label] = attention_bwd_row("registry train kernel", f"{fwd_name}_bwd", q, k, v, go, tab,
                                            lambda fn, label=label, want=want: train_route(
                                                label, fn, want, XL_OLD + ("flash_fwd_wgmma_kernel",)))
            del o, lse, qr, kr
        del q, k, v, go
        torch.cuda.empty_cache()

        # #3 at the block's rows: the forward kernel, then its backward through the autograd Function
        dim, label = spec.hidden_size, f"fused_norm_modulate_train_{name}"
        log(f"[registry train kernel] fused_norm_modulate x ({b},{n},{dim}) bf16, shift/scale views of ({b},6,{dim})")
        x = randn(b, n, dim, scale=3.0)
        w = 1 + 0.1 * torch.randn(dim, generator=gen, device=dev)
        ada = randn(b, 6, dim, scale=0.1)
        err = compare(label, fad.fused_norm_modulate(x, w, ada[:, 0], ada[:, 1]),
                      fad.fused_norm_modulate_plain(x, w, ada[:, 0], ada[:, 1]), rtol=2**-6, atol=2**-6)
        ms = cuda_ms(lambda: fad.fused_norm_modulate(x, w, ada[:, 0], ada[:, 1]), 50)
        plain_ms = cuda_ms(lambda: fad.fused_norm_modulate_plain(x, w, ada[:, 0], ada[:, 1]), 10)
        m = b * n
        bnd = bound(m * dim * 4 + dim * 4 + 2 * b * dim * 2, fp32_flops=6 * m * dim)
        rows[label] = (err, ms, plain_ms, None, *bnd, {})
        log(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), share "
            f"{bnd[0] / ms:.3f}")
        del x, w, ada
        rows[f"fused_norm_modulate_bwd_train_{name}"] = fnm_bwd_row(dev, f"({arch} training rows)", b, n, dim, 24)

    # dense_bias_f32 at the SwiGLU linears whose N or K is off a multiple of 8
    for arch in ("LightningDiT-L/2", "LightningDiT-1p6B/1"):
        spec, name = _reg_spec(arch), REG_TRAIN[arch]
        m, dim, hid = b * spec.num_patches, spec.hidden_size, spec.swiglu_hidden
        for what, kk, nn in (("w12", dim, 2 * hid), ("w3", hid, dim)):
            label = f"dense_train_{name}_{what}"
            log(f"[registry train kernel] dense_bias_f32 x ({m},{kk}) bf16 @ w ({nn},{kk}) bf16 + b fp32 ({arch} "
                f"{what}), with its backward (_DenseBiasF32)")
            # the bias at the output's scale, where rounding it to bf16 first moves the result by an ulp
            x, w, bias = randn(m, kk), randn(nn, kk, scale=kk**-0.5), randn(nn, dtype=torch.float32)
            y = lin.dense_bias_f32(x, w, bias)
            err = float((y.float() - (x.float() @ w.float().t() + bias).bfloat16().float()).abs().max())
            ulp = dense_ulp_error(y, x, w, bias)
            del y
            control = dense_ulp_error(F.linear(x, w, bias.bfloat16()), x, w, bias)
            ok = ulp <= 0.5 and control > 0.6
            log(f"  forward: {ulp:.4f} bf16 ulp of fp64 (bound 0.5); the bias rounded to bf16 first {control:.4f} "
                f"(must exceed 0.6) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{label}: not one rounding after the fp32 bias, or the control reads within")
            xs, ws, bs = (t.detach().requires_grad_() for t in (x, w, bias))
            go = randn(m, nn)
            out = lin._DenseBiasF32.apply(xs, ws, bs, None)

            def back():
                return torch.autograd.grad(out, (xs, ws, bs), go, retain_graph=True)

            dx, dw, db = back()
            errs = {"dx": float((dx.float() - go.float() @ w.float()).norm() / (go.float() @ w.float()).norm())}
            dw_ref = go.float().t() @ x.float()
            errs["dw"] = float((dw.float() - dw_ref).norm() / dw_ref.norm())
            db_ref = go.float().sum(0)
            errs["db"] = float((db - db_ref).abs().max() / db_ref.abs().max())
            ok = errs["dx"] <= 1e-2 and errs["dw"] <= 1e-2 and errs["db"] <= 1e-5 and db.dtype == torch.float32
            log(f"  backward: dx, dw relative L2 {errs['dx']:.3g}, {errs['dw']:.3g} of the fp32 products (bound "
                f"1e-2), dbias (fp32) {errs['db']:.3g} of its largest (bound 1e-5) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"{label}: the backward disagrees with the fp32 products")
            del dx, dw, db, dw_ref, db_ref
            ms = cuda_ms(lambda: lin.dense_bias_f32(x, w, bias), 20)
            plain_ms = cuda_ms(lambda: (x.float() @ w.float().t() + bias).to(torch.bfloat16), 5)
            bwd_ms = cuda_ms(back, 10)
            bias16 = bias.bfloat16()
            lib_ms = cuda_ms(lambda: F.linear(x, w, bias16), 20)
            xl, wl, bl = (t.detach().requires_grad_() for t in (x, w, bias16))

            def lib_fwd_bwd():
                torch.autograd.grad(F.linear(xl, wl, bl), (xl, wl, bl), go)

            lib_bwd_ms = cuda_ms(lib_fwd_bwd, 10) - lib_ms
            bnd = bound((m * kk + nn * kk + m * nn) * 2 + nn * 4, 2 * m * kk * nn)
            bwd_bound = bound((2 * m * nn + 2 * m * kk + 2 * nn * kk) * 2 + nn * 4, 4 * m * kk * nn)
            rows[label] = (err, ms, plain_ms, lib_ms, *bnd,
                           {"max_ulp": ulp, "backward_ms": bwd_ms, "library_backward_ms": lib_bwd_ms,
                            "backward_bound_ms": bwd_bound[0], "backward_rel_l2": errs})
            log(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, F.linear {lib_ms:.4f} ms (kernel / F.linear "
                f"{ms / lib_ms:.3f}), bound {bnd[0]:.4f} ms ({bnd[1]}), share {bnd[0] / ms:.3f}; backward (cuBLAS on "
                f"the unpadded operands) {bwd_ms:.4f} ms, F.linear's backward {lib_bwd_ms:.4f} ms, bound "
                f"{bwd_bound[0]:.4f} ms")
            del x, w, bias, xs, ws, bs, go, out, xl, wl, bl
            torch.cuda.empty_cache()
    return rows


def reg_train_legs(dev, smi: str, tmp: str) -> tuple:
    """Phase 7d's legs: ``training_leg`` at each arch of REG_TRAIN (through
    cli.train_dit, then the gradient check at depth XL_GRAD_DEPTH), then the
    gradient check under rope_layout interleaved at REG_TRAIN_INTERLEAVED.
    Returns (record, {path: counts})."""
    t0 = time.perf_counter()
    record, counts = {}, {}
    for arch, name in REG_TRAIN.items():
        t1 = time.perf_counter()
        record[name], c = training_leg(dev, smi, tmp, arch, f"reg_{name}")
        record[name]["leg_s"] = time.perf_counter() - t1
        counts |= c
    for arch in REG_TRAIN_INTERLEAVED:
        path = f"reg_{REG_TRAIN[arch]}_grad_interleaved"
        counts[path] = grad_check_phase(dev, layout="interleaved", count_path=path, model_type=arch,
                                        depth=XL_GRAD_DEPTH)
    log("  seconds a leg: " + ", ".join(f"{k} {v['leg_s']:.2f}" for k, v in record.items()))
    record["legs_s"] = time.perf_counter() - t0
    log(f"  the registry training legs took {record['legs_s']:.2f} s; on {smi}")
    return record, counts


def registry_only(dev, smi: str) -> int:
    """``--registry``: build, then the registry slices alone (7c's and 7d's
    kernel phases, then the sampling legs and the training legs), their
    kernels as a ``{"registry_kernels": [...]}`` line in the kernels line's
    form."""
    import torch

    from ldmae_tpu_torch import kernels

    t0 = time.perf_counter()
    report = kernels.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s")
    gate_ptxas(report)
    rate_probes(dev)
    rows = registry_kernel_phase(dev)
    rows |= reg_train_kernel_phase(dev)
    with seeded_once(), tempfile.TemporaryDirectory() as tmp:
        record, counts = registry_legs(dev, smi, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        training, c = reg_train_legs(dev, smi, tmp)
        counts |= c
    log(json.dumps({"registry": record}))
    log(json.dumps({"registry_training": training}))
    log(smi)
    log(json.dumps({"registry_kernels": kernel_rows(rows, counts)}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def vmae_kernel_tuple(vmae_rows: list, name: str, shape: list) -> tuple:
    """A vmae_train_kernels row as a kernels-line row (``kernel_rows``):
    (err, ms, plain ms, library ms, bound ms, bound by, the other keys)."""
    row = next(r for r in vmae_rows if r["name"] == name and r["shape"] == shape)
    core = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    rest = {k: v for k, v in row.items() if k not in core + ("name", "route", "source", "replaces", "launches")}
    return (*(row[k] for k in core), rest)


def kernel_rows(rows: dict, counts: dict) -> list:
    """The kernels line's entries: each measured kernel with its launches on
    the path that runs it (``KERNELS``)."""
    out = []
    for name, (err, ms, plain_ms, lib_ms, bound_ms, bound_by, parts) in rows.items():
        source, replaces, path, wrapper = KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[path][wrapper], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        } | parts)
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
    if "--vmae" in sys.argv[1:]:
        return vmae_only(dev, smi)
    if "--tokenizers" in sys.argv[1:]:
        return tokenizers_only(dev, smi)
    if "--multiproc" in sys.argv[1:]:
        return multiproc_only(dev, smi)
    if "--samplers" in sys.argv[1:]:
        return samplers_only(dev, smi)
    if "--parallel" in sys.argv[1:]:
        return parallel_only(dev, smi)
    if "--xl-kernels" in sys.argv[1:]:
        return xl_kernels_only(dev)
    if "--fp32-bwd" in sys.argv[1:]:
        return fp32_bwd_only(dev)
    if "--fp32-fwd" in sys.argv[1:]:
        return fp32_fwd_only(dev)
    if "--redesigned" in sys.argv[1:]:
        return redesigned_only(dev)
    if "--xl" in sys.argv[1:]:
        return xl_only(dev, smi)
    if "--registry" in sys.argv[1:]:
        return registry_only(dev, smi)

    t0 = time.perf_counter()

    def mark(phase: str) -> None:  # where the script's time limit goes
        log(f"[time] {time.perf_counter() - t0:.1f} s into the run, after {phase}")

    report = kernels.build()
    log(f"[build] {time.perf_counter() - t0:.2f} s for {len(report)} libraries (nvcc in parallel)")
    for name, info in report.items():
        regs = [ln.strip() for ln in info["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: {info['seconds']:.2f} s" + "".join(f"\n    {r}" for r in regs))
    wgmma_ptxas(report)
    gemm_ptxas(report)
    engine_ptxas(report)
    rate_probes(dev)
    mark("the build")

    rows = kernel_phases(dev, BATCH)
    log(f"[kernel] the same at bench.py's batch {BENCH_BATCH}")
    kernel_phases(dev, BENCH_BATCH)
    log("[kernel] the w8a8 leg's int8 linears (int8_dense)")
    rows |= int8_gemm_phase(dev, BATCH)
    int8_gemm_phase(dev, BENCH_BATCH)
    rows |= train_kernel_phase(dev)
    # early in the process: later, the profiler's per-kernel splits have
    # come back short of records
    rows |= xl_kernel_phase(dev)
    rows |= registry_kernel_phase(dev)
    rows |= reg_train_kernel_phase(dev)
    mark("the kernel phases")
    head_dim_phase(dev)
    mark("the head-dim phase")
    rows |= fp32_kernel_phase(dev, BATCH)
    mark("the fp32 phase")
    rows |= dense_phase(dev)
    mark("the dense phase")
    profile = "--profile" in sys.argv[1:]
    result = pipeline_phases(dev, profile=profile)
    result["counts"] |= vmae_decode_phase(dev)
    mark("the B/1 pipeline phases")
    samplers = samplers_phase(dev)
    result["counts"] |= samplers["counts"]
    mark("the sampler slice")
    grad_check_phase(dev)
    for arch, name in (("LightningDiT-B/1", "grad_fp32"), (XL_MODEL, "grad_fp32_xl")):
        for layout in ("half", "interleaved"):
            path = f"{name}_{layout}"
            result["counts"][path] = grad_check_phase(dev, torch.float32, layout, path, GRAD_F32_REL_L2,
                                                      model_type=arch)
    with tempfile.TemporaryDirectory() as tmp:
        result["counts"] |= cli_train_phase(dev, smi, tmp)
    mark("the gradient checks and DiT training")
    with seeded_once(), tempfile.TemporaryDirectory() as tmp:  # XL/1's seeded weights drawn once for both slices
        xl_record, counts = xl_legs(dev, smi, tmp)
        result["counts"] |= counts
        mark("the XL legs")
        registry, counts = registry_legs(dev, smi, tmp)
        result["counts"] |= counts
        mark("the registry legs")
    with tempfile.TemporaryDirectory() as tmp:  # after seeded_once's copies of the sampling weights are freed
        reg_training, counts = reg_train_legs(dev, smi, tmp)
        result["counts"] |= counts
        mark("the registry training legs")
    if profile:
        train_profile_phase(dev)
    with tempfile.TemporaryDirectory() as tmp:
        origin = os.path.join(tmp, "images")
        write_image_folder(origin, EXTRACT_IMAGES, 42)
        counts, dense_shapes = extraction_phase(dev, smi, tmp, origin)
        result["counts"] |= counts
        encoder_rows = encoder_kernel_phase(dev, origin, dense_shapes)
        result["counts"] |= tokenizer_eval_phase(dev, smi, tmp, origin)
        inception_fid_phase(dev, smi, tmp)
        mark("extraction and evaluation")
        result["counts"] |= tokenizer_family_phases(dev, smi, tmp, origin)
        mark("the tokenizer family")
        counts, vmae_rows = vmae_train_phase(dev, smi, tmp, origin)
        result["counts"] |= counts
        rows["flash_attention_bwd_d16"] = vmae_kernel_tuple(vmae_rows, "flash_attention_bwd", VMAE_D16_SHAPE)
        mark("VMAE training")
        multiproc = multiproc_phase(dev, smi, tmp, origin)
        mark("the multi-process slice")
        tensor_parallel, tp_rows, counts = tp_phase(dev, smi, tmp)
        rows |= tp_rows
        result["counts"] |= counts
        tp_training, tp_rows, counts = tp_train_phase(dev, smi, tmp)
        rows |= tp_rows
        result["counts"] |= counts
        mark("tensor parallelism")

    out = kernel_rows(rows, result["counts"])
    missing = set(KERNELS) - set(rows)
    if missing:
        raise SystemExit(f"no measurement of {sorted(missing)}")
    # #2 and dense at the VMAE encoder's shapes (the extraction slice), apart
    # from the kernels line's main-path shapes
    log(json.dumps({"encoder_kernels": encoder_rows}))
    # #2 and #5 at the VMAE training shapes (d = 16, the flash leg's launches a step)
    log(json.dumps({"vmae_train_kernels": vmae_rows}))
    # the two-rank and NCCL legs of the multi-process slice
    log(json.dumps({"multiproc": multiproc}))
    # the --tp 2 legs of the tensor-parallel slice: sampling, training
    log(json.dumps({"tensor_parallel": tensor_parallel}))
    log(json.dumps({"tensor_parallel_training": tp_training}))
    # the sampler slice's legs, launches, gates
    log(json.dumps({"samplers": samplers}))
    # the XL slice's sampling and training legs
    log(json.dumps({"xl": xl_record}))
    # the registry slice's legs: XL/1 w8a8 and B/1 w8 through cli.inference, L/2, XL/2, 1p6B/1 at 10 steps
    log(json.dumps({"registry": registry}))
    # the registry's training legs: L/2, XL/2, 1p6B/1 through cli.train_dit, the gradient checks
    log(json.dumps({"registry_training": reg_training}))
    log(smi)
    log(json.dumps({"kernels": out}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run-to-run noise of the DiT block's gradients on the card, by attention
impl: the case of ``tests/test_torch_port_gpu.py::
test_cuda_tp_forward_under_autograd_keeps_proj_w3_and_adaln_gradients``.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/tp_grad_noise.py

One LightningDiT-B/1 block (depth 1, 32^2 x 16 latents, batch 2, the test's
seeds) takes a bf16 training loss's gradients, unsharded (``tp_group``
None) three times and with a gloo tp group of one twice, under each
``attn_impl`` (``xla``: no port kernel; ``flash_rope``: #1 and #6) and
``adaln_impl`` (``fused``: #3 and its backward kernel; ``xla``). For each
it prints the leaves that differ most (relative L2) between two unsharded
runs, between the tp group and the unsharded block, and between the two tp
runs, and whether two unsharded runs are bit for bit equal.
"""

import os
import socket
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    import torch
    import torch.distributed as dist

    from ldmae_tpu_torch.models import LightningDiT, dit_spec, seeded_init_
    from ldmae_tpu_torch.train import dit_loss
    from ldmae_tpu_torch.transport import create_transport

    if not torch.cuda.is_available():
        print("tp_grad_noise: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    spec = dit_spec("LightningDiT-B/1", depth=1, input_size=32, in_channels=16, use_qknorm=True, use_swiglu=True,
                    use_rope=True, use_rmsnorm=True)
    sd = seeded_init_(LightningDiT(spec, device="cpu"), 4).state_dict()
    gen = torch.Generator(device=dev).manual_seed(2)
    x1, x0 = (torch.randn(2, 16, 32, 32, generator=gen, device=dev) for _ in range(2))
    y, t = torch.tensor([3, 7], device=dev), torch.tensor([0.3, 0.7], device=dev)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)

    def run(group, attn, adaln):
        model = LightningDiT(spec, device=dev)
        model.load_state_dict(sd)
        model.blocks[0].tp_group = group
        dit_loss(model, create_transport(use_lognorm=True), x1, y, x0=x0, t=t, drop_ids=torch.zeros_like(y),
                 compute_dtype=torch.bfloat16, attn_impl=attn, adaln_impl=adaln).backward()
        return {n: p.grad.float().clone() for n, p in model.named_parameters()}

    def worst(a, b, k=4):
        errs = {n: float((a[n] - b[n]).norm() / (b[n].norm() + 1e-30)) for n in b}
        return [(n, f"{v:.3g}", f"norm {float(b[n].norm()):.4g}")
                for n, v in sorted(errs.items(), key=lambda kv: -kv[1])[:k]]

    try:
        for attn in ("xla", "flash_rope"):
            for adaln in ("fused", "xla"):
                runs = [run(None, attn, adaln) for _ in range(3)]
                tp = [run(dist.group.WORLD, attn, adaln) for _ in range(2)]
                print(attn, adaln, "none vs none", worst(runs[1], runs[0]), "| none vs none (3rd)",
                      worst(runs[2], runs[0]), flush=True)
                print(attn, adaln, "tp1 vs none", worst(tp[0], runs[0]), "| tp1 vs tp1", worst(tp[1], tp[0]),
                      flush=True)
                print(attn, adaln, "two unsharded runs bitwise equal:",
                      all(torch.equal(runs[0][n], runs[1][n]) for n in runs[0]), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

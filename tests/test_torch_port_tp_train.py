"""Tensor parallelism in DiT training (``cli.train_dit --tp``) on the CPU:
gloo ranks held against one process on the global batch and against the
JAX package.

At a debug size (``tests/test_torch_port_fsdp.py``'s DIMS: width 64, 4
heads, depth 2, SwiGLU, RoPE, qk-norm, remat ``attn``; fp32), through
``torch_mp_worker.py tp_train``, each world spawned once:

* (i) tp 2 (world 2): two steps of two micro-batches with clipping binding
  (max_grad_norm 0.05 against gradient norms of about 1.5): the model, EMA
  and AdamW moments of the checkpoint the ranks gather equal one process's
  stepping on the global batch within relative L2 1e-5 per entry (fp32: the
  partial sums reassociate), its steps and parameter groups one process's;
  one backward's gathered gradients against ``jax.value_and_grad`` of the
  JAX loss on the same weights and inputs (``test_dit_train_step_gradients_
  match_jax``'s inputs and its flash_rope / half / fused / remat-attn
  configuration): the loss within 1e-5 relative, every leaf within relative
  L2 2e-3.
* (ii) dp 2 x tp 2 (DDP over dp) and fsdp 2 x tp 2 (FSDP2 over each tp
  slice) at world 4: the same 1e-5 rule.
* (iii) ``cli.train_dit --tp 2`` resumes a one-process step-2 checkpoint
  to step 4 ("resumed from step 2"), equal within 1e-5 to the same resume
  in one process (model, EMA, AdamW moments), and its checkpoint restores
  in one process.
* (iv) the control: the gather's backward as a reduce-scatter (each slice
  of the modulations' gradient multiplied by the group's size) misses the
  1e-5 rule.
* (v) ``tp_state_gather`` inverts ``tp_state_slice`` bit for bit at 1p0B/1
  and 1p6B/1 (on ``meta`` at full depth: shapes and keys; in fp32 at depth
  1: values), and the three tp Functions and the row-parallel dense pass
  ``torch.autograd.gradcheck`` in float64 at world 1.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from ldmae_tpu.models import lightningdit as jdit
from ldmae_tpu.transport.transport import create_transport as jcreate_transport

from test_torch_port_fsdp import BETA2, CLIP, DIMS, IMPLS, LR, _ckpt_close, _close, _train_config, latent_dir  # noqa: F401
from test_torch_port_train import DIT_DIMS, T_FIXED, _jax_params, _rel_l2, _train_inputs
from torch_mp_worker import REPO, join, start
from torch_port_helpers import to_numpy

from ldmae_tpu_torch.convert import dit_state_dict_from_jax
from ldmae_tpu_torch.models import LightningDiT, dit_spec, seeded_init_
from ldmae_tpu_torch.models import lightningdit as tdit
from ldmae_tpu_torch.parallel import distributed as tdist
from ldmae_tpu_torch.parallel import tp_state_gather, tp_state_slice

WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
LEAD = (2, 2, 8)  # steps, micro-batches, global micro-batch
TRANSPORT = dict(use_cosine_loss=True, use_lognorm=True)
GRAD_IMPLS = dict(compute_dtype=torch.float32, attn_impl="flash_rope", rope_layout="half", adaln_impl="fused")


def _steps_inputs():
    rng = np.random.default_rng(3)
    spec = tdit.DiTSpec(**DIMS)
    sd = seeded_init_(tdit.LightningDiT(spec, device="cpu"), 3, std=0.05).state_dict()
    return dict(dims=DIMS, sd=sd, impls=IMPLS, transport=TRANSPORT,
                x=torch.from_numpy(rng.standard_normal(LEAD + (4, 8, 8)).astype(np.float32)),
                y=torch.from_numpy(rng.integers(0, 10, LEAD)))


def _one_process(src) -> dict:
    """One process stepping on the whole global batch: the checkpoint's
    contents."""
    from ldmae_tpu_torch.train import init_train_state, make_optimizer, make_train_step
    from ldmae_tpu_torch.transport import create_transport

    spec = tdit.DiTSpec(**src["dims"])
    model = tdit.LightningDiT(spec, device="cpu")
    model.load_state_dict(src["sd"])
    state = init_train_state(model, make_optimizer(model.parameters(), LR, BETA2))
    step = make_train_step(spec, create_transport(**src["transport"]), grad_accum=LEAD[1], max_grad_norm=CLIP,
                           **src["impls"])
    gen = torch.Generator()
    for s in range(LEAD[0]):
        gen.manual_seed(1000 + s)
        assert float(step(state, {"x": src["x"][s], "y": src["y"][s]}, gen)["grad_norm"]) > 10 * CLIP  # clipping binds
    return {"model": model.state_dict(), "ema": state.ema.state_dict(), "step": LEAD[0],
            "opt": state.optimizer.state_dict()}


def _grads_inputs():
    ts = tdit.DiTSpec(**DIT_DIMS, use_checkpoint=True, remat_policy="attn")
    jparams = _jax_params(jdit.DiTSpec(**DIT_DIMS, use_checkpoint=True, remat_policy="attn"), "half")
    x1, x0, y, drop = _train_inputs()
    src = dict(dims=dict(DIT_DIMS, use_checkpoint=True, remat_policy="attn"), transport=TRANSPORT, impls=GRAD_IMPLS,
               sd=dit_state_dict_from_jax(to_numpy(jparams), ts), x1=torch.from_numpy(x1), x0=torch.from_numpy(x0),
               y=torch.from_numpy(y), t=torch.full((2,), T_FIXED), drop=torch.from_numpy(drop))
    return src, jparams


def _jax_grads(jparams) -> tuple:
    """``test_dit_train_step_gradients_match_jax``'s JAX loss and gradients
    in the flash_rope / half / fused / remat-attn configuration."""
    js = jdit.DiTSpec(**DIT_DIMS, use_checkpoint=True, remat_policy="attn")
    x1, x0, y, drop = _train_inputs()
    consts = jdit.DiTConsts(js)
    transport = jcreate_transport(**TRANSPORT)

    def loss_fn(p):
        def model_fn(xt, t, yk):
            return jdit.dit_forward(p, js, consts, xt, t, yk, train=True, force_drop_ids=jnp.asarray(drop),
                                    compute_dtype=jnp.float32, attn_impl="flash_rope", rope_layout="half",
                                    adaln_impl="fused")

        terms = transport.training_losses(model_fn, jax.random.key(0), jnp.asarray(x1), dict(yk=jnp.asarray(y)),
                                          sp_timesteps=(T_FIXED, T_FIXED), x0=jnp.asarray(x0))
        return terms["loss"].mean() + terms["cos_loss"].mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    return float(jloss), dit_state_dict_from_jax(to_numpy(jgrads), tdit.DiTSpec(**DIT_DIMS))


@pytest.fixture(scope="module")
def one_process_ref():
    src = _steps_inputs()
    return src, _one_process(src)


def test_tp2_steps_gradients_control_and_cli_resume(tmp_path, latent_dir, one_process_ref, monkeypatch):  # noqa: F811
    """World 2, one spawn: (i) the steps and the gradients against JAX,
    (iv) the control, (iii) the CLI's resume; the references computed here
    while the ranks run."""
    from ldmae_tpu_torch.cli import train_dit
    from ldmae_tpu_torch.core.config import LDMAEConfig
    from ldmae_tpu_torch.models import permute_qk_for_half_rope
    from ldmae_tpu_torch.train import init_train_state, make_optimizer, restore_checkpoint
    from ldmae_tpu_torch.train.train_dit import build_from_config

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # TensorFlow's import takes seconds
    src, ref = one_process_ref
    grads_src, jparams = _grads_inputs()
    out = tmp_path / "out"
    train_dit.main(["--config", _train_config(tmp_path, latent_dir, "one"), "--device", "cpu"])  # to step 2
    cfgs = {}
    for name in ("tp", "one_resume"):
        shutil.copytree(out / "one" / "checkpoints", out / name / "checkpoints")
        cfgs[name] = _train_config(tmp_path, latent_dir, name)
    legs = [dict(name="tp2", kind="steps", dp=1, fsdp=1, tp=2),
            dict(name="grads", kind="grads", dp=1, fsdp=1, tp=2),
            dict(name="control", kind="steps", dp=1, fsdp=1, tp=2, control=True),
            dict(name="cli", kind="cli", argv=["--config", cfgs["tp"], "--device", "cpu", "--tp", "2",
                                               "--max_steps", "4"])]
    torch.save(dict(legs=legs, steps=src, grads=grads_src, lr=LR, beta2=BETA2, clip=CLIP, accum=LEAD[1]),
               tmp_path / "inputs.pt")
    procs = start([[WORKER, "tp_train", str(tmp_path)]] * 2)
    train_dit.main(["--config", cfgs["one_resume"], "--device", "cpu", "--max_steps", "4"])
    jloss, jref = _jax_grads(jparams)
    join(procs)

    # (i) the steps, the gradients against JAX
    _ckpt_close(torch.load(tmp_path / "tp2" / "checkpoints" / f"{LEAD[0]:07d}.pt", weights_only=False), ref)
    got = torch.load(tmp_path / "grads.pt", weights_only=False)
    assert abs(got["loss"] - jloss) <= 1e-5 * abs(jloss)
    errs = {n: _rel_l2(g.numpy(), jref[n].numpy()) for n, g in got["grads"].items() if n in jref}
    assert len(errs) == len([k for k in jref if not k.startswith(("pos_embed", "feat_rope"))])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 2e-3, (worst, errs[worst])
    # (iv) the control misses the rule
    control = torch.load(tmp_path / "control" / "checkpoints" / f"{LEAD[0]:07d}.pt", weights_only=False)
    with pytest.raises(AssertionError):
        _ckpt_close(control, ref)
    # (iii) the CLI's resume under --tp 2 against the same resume in one process
    log = (out / "tp" / "log.txt").read_text()
    assert "resumed from step 2" in log and "tp 2 (each block split over 2 ranks)" in log
    ckpts = [torch.load(out / name / "checkpoints" / "0000004.pt", weights_only=False) for name in ("tp", "one_resume")]
    _ckpt_close(*ckpts)
    model = build_from_config(LDMAEConfig.from_yaml(cfgs["tp"]), "cpu")[1]
    state = init_train_state(model, make_optimizer(model.parameters(), 2e-4, 0.95))
    assert restore_checkpoint(str(out / "tp"), state, half_rope=True) is not None and state.step == 4
    _close(permute_qk_for_half_rope(state.model.state_dict(), model.spec, inverse=True), ckpts[0]["model"], 0.0)


def test_dp2_x_tp2_and_fsdp2_x_tp2_equal_one_process(tmp_path, one_process_ref):
    """World 4, one spawn: (ii) DDP over dp and FSDP2 over fsdp, each beside
    tp 2, against one process on the global batch."""
    src, ref = one_process_ref
    legs = [dict(name="dp2xtp2", kind="steps", dp=2, fsdp=1, tp=2),
            dict(name="fsdp2xtp2", kind="steps", dp=1, fsdp=2, tp=2)]
    torch.save(dict(legs=legs, steps=src, lr=LR, beta2=BETA2, clip=CLIP, accum=LEAD[1]), tmp_path / "inputs.pt")
    join(start([[WORKER, "tp_train", str(tmp_path)]] * 4))
    for leg in legs:
        _ckpt_close(torch.load(tmp_path / leg["name"] / "checkpoints" / f"{LEAD[0]:07d}.pt", weights_only=False),
                    ref)


# ---------------------------------------------------------------------------
# (v) the round trip and the Functions at world 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["LightningDiT-1p0B/1", "LightningDiT-1p6B/1"])
def test_tp_state_gather_inverts_tp_state_slice(model):
    spec = dit_spec(model, input_size=32, in_channels=16, use_qknorm=True, use_swiglu=True, use_rope=True,
                    use_rmsnorm=True)
    sd = LightningDiT(spec, device="meta").state_dict()
    degrees = [n for n in (2, 4) if spec.num_heads % n == 0 and spec.swiglu_hidden % n == 0]  # 1p6B: 2 only
    for n in degrees:
        back = tp_state_gather([tp_state_slice(sd, spec, n, r) for r in range(n)], spec)
        assert list(back) == list(sd) and all(back[k].shape == v.shape for k, v in sd.items())
    one = dit_spec(model, depth=1, input_size=4, in_channels=16, use_qknorm=True, use_swiglu=True, use_rope=True,
                   use_rmsnorm=True)
    gen = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in LightningDiT(one, device="meta").state_dict().items()}
    for n in degrees:
        back = tp_state_gather([tp_state_slice(sd, one, n, r) for r in range(n)], one)
        assert all(torch.equal(back[k], v) for k, v in sd.items())


def test_tp_functions_pass_gradcheck_at_world_1():
    """Without a group (world 1) the Functions' collectives are the
    identity; their backwards, applied directly, and the row-parallel dense
    (a product with fp32-style sums, the all-reduce, the bias, one rounding)
    are checked in float64."""
    from ldmae_tpu_torch.ops import linear as lin

    gen = torch.Generator().manual_seed(1)
    x = torch.randn(3, 5, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a: tdist._CopyToTP.apply(a, None), (x,))
    assert torch.autograd.gradcheck(lambda a: tdist._ReduceFromTP.apply(a * 1, None), (x,))  # in place: not on a leaf
    assert torch.autograd.gradcheck(lambda a: tdist._GatherFromTP.apply(a, None, -1), (x,))
    w = torch.randn(4, 5, generator=gen, dtype=torch.float64, requires_grad=True)
    b = torch.randn(4, generator=gen, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, ww, bb: lin.dense_row_parallel(a, ww, bb, None), (x, w, b))

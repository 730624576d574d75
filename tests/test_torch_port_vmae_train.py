"""The port's VMAE training slice vs ``ldmae_tpu`` on the CPU.

The same inputs, made with numpy from a seed, go through the JAX function
and its counterpart in the port; JAX parameters cross through
``convert.vmae_state_dict_from_jax``, which is linear leaf by leaf, so JAX
gradient trees (and masks) cross through it too. The arch is
``mae_for_ldmae_f8d16_small`` cut to depth 2 / 2 at 32^2 (16 tokens, head
dim 12), batch 3, with seeded non-zero weights.

* ``random_masking`` / ``unshuffle_with_mask_tokens``: the same noise (with
  ties) gives the same mask and ids_restore, and the same values, exactly.
* ``forward_vanilla`` (the stage-1 flags: no_cls, smooth_output, KL with
  fixed_std 1e-3, visible_loss_ratio 0.75), with and without
  ``norm_pix_loss``, ``xla`` and ``flash`` attention (the Pallas kernels in
  interpret mode), fp32: loss within 1e-5 relative, every gradient leaf
  within relative L2 2e-3 (``tests/test_torch_port_train.py``'s bound for
  the DiT; fp32 summation order only). In bf16 compute: loss within 1e-2
  relative and every leaf within relative L2 3e-2 (both sides round the
  same values to bf16 but sum in another order, and a one-ulp difference
  in an activation moves a bf16 gradient by up to 2^-8 of itself).
* The same with the LPIPS term (seeded random LPIPS weights through
  ``convert.lpips_state_dict_from_jax``); the reconstruction's gradient
  through LPIPS alone is nonzero and matches JAX's.
* ``forward_ldmae`` (stage 3) with the same posterior noise: loss and the
  decoder / from_latent gradients as above; the encoder gets none.
  ``use_checkpoint`` (per-block recomputation) gives the same loss and
  gradients (1e-6) in both stages.
* The optimizer: ``cosine_lr`` (1e-9 absolute: JAX computes it in float32); the weight-decay mask leaf
  by leaf against ``_decay_mask``; one update given the same gradients
  against ``make_vmae_optimizer``'s optax chain, stage 1 and stage 3, every
  leaf within 1e-6 relative; a non-finite loss is a no-op for parameters
  and optimizer state and the next update's rate follows optax's count;
  stage 3 leaves the frozen parameters bitwise unchanged; ``grad_accum=2``
  equals the average of the two micro-batches' gradients (1e-6).
* ``train_augment``: the same bytes as the JAX copy for the same seeds.
* ``pe_reset``'s resize against JAX's ``resize_pos_embed_np`` (1e-6) at
  16 -> 32 and 32 -> 16 tokens a side, its ``*_pe.pth`` naming and its
  refusal to overwrite the input.
* The reference initialisation's distributions, the ``strict=False``
  checkpoint merge, and the FLOP count of the MFU log.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ldmae_tpu.cli import pe_reset as jpe_reset
from ldmae_tpu.data import augment as jaugment
from ldmae_tpu.models import lpips as jlpips
from ldmae_tpu.models import vmae as jvmae
from ldmae_tpu.ops import masking as jmasking
from ldmae_tpu.train import train_vmae as jtrain
from ldmae_tpu.utils import profiling as jprofiling

from torch_port_helpers import randomize, to_numpy

from ldmae_tpu_torch.cli import pe_reset as tpe_reset
from ldmae_tpu_torch.convert import lpips_state_dict_from_jax, vmae_state_dict_from_jax
from ldmae_tpu_torch.data import augment as taugment
from ldmae_tpu_torch.models import VMAE, init_vmae_weights_, load_vmae_weights_
from ldmae_tpu_torch.models import vmae as tvmae
from ldmae_tpu_torch.models.lpips import LPIPS, make_lpips_fn
from ldmae_tpu_torch.ops.masking import random_masking, unshuffle_with_mask_tokens
from ldmae_tpu_torch.train import TrainState
from ldmae_tpu_torch.train import train_vmae as ttrain
from ldmae_tpu_torch.utils import profiling as tprofiling

B, IMG = 3, 32
STAGE1 = dict(img_size=IMG, depth=2, decoder_depth=2, no_cls=True, smooth_output=True, kl_loss_weight=1e-6,
              fixed_std=1e-3, perceptual_loss_ratio=0.5)
STAGE3 = dict(img_size=IMG, depth=2, decoder_depth=2, no_cls=True, smooth_output=True, kl_loss_weight=0.0,
              perceptual_loss_ratio=10.0, ldmae_mode=True)
GRAD_REL_L2, LOSS_REL = 2e-3, 1e-5
BF16_GRAD_REL_L2, BF16_LOSS_REL = 3e-2, 1e-2


def _rel_l2(a, b):
    """||a - b|| / max(||b||, 1e-3), as the DiT training tests compare leaves."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-3))


def _pair(seed=0, **kw):
    """(JAX spec, params, consts), and the port's model with the same weights."""
    js = jvmae.vmae_spec("mae_for_ldmae_f8d16_small", **kw)
    ts = tvmae.vmae_spec("mae_for_ldmae_f8d16_small", **kw)
    params = randomize(jvmae.init_vmae_params(jax.random.key(0), js), 20 + seed)
    model = VMAE(ts, device="cpu")
    model.load_state_dict(vmae_state_dict_from_jax(to_numpy(params), ts), strict=True)
    return js, params, jvmae.VMAEConsts(js), model


def _inputs(seed, n_keep, latent_dim=16, length=(IMG // 8) ** 2):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-1, 1, (B, 3, IMG, IMG)).astype(np.float32)
    mask_noise = rng.uniform(size=(B, length)).astype(np.float32)
    latent_noise = rng.standard_normal((B, latent_dim, n_keep)).astype(np.float32)
    return imgs, mask_noise, latent_noise


def _jax_lpips():
    return jlpips.import_lpips_weights()


def _port_lpips(jparams):
    model = LPIPS("cpu")
    model.load_state_dict(lpips_state_dict_from_jax(to_numpy(jparams)), strict=True)
    return model


def _port_grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


def _check_grads(model, jgrads, spec, bound, only=None):
    ref = vmae_state_dict_from_jax(to_numpy(jgrads), spec)
    got = _port_grads(model)
    checked = 0
    for name, g in got.items():
        if only is not None and not only(name):
            assert g is None, name
            continue
        err = _rel_l2(g.numpy(), ref[name].numpy())
        assert err <= bound, (name, err)
        checked += 1
    return checked


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mask_ratio", [0.0, 0.25, 0.75])
def test_random_masking_matches_jax(mask_ratio):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 64, 8)).astype(np.float32)
    # few distinct values: ties must order as jnp.argsort orders them
    noise = np.round(rng.uniform(size=(4, 64)) * 8).astype(np.float32) / 8
    jx, jmask, jids = jmasking.random_masking(None, jnp.asarray(x), mask_ratio, noise=jnp.asarray(noise))
    tx, tmask, tids = random_masking(torch.from_numpy(x), mask_ratio, torch.from_numpy(noise))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    token = rng.standard_normal(8).astype(np.float32)
    jfull = jmasking.unshuffle_with_mask_tokens(jx, jnp.asarray(token), jids)
    tfull = unshuffle_with_mask_tokens(tx, torch.from_numpy(token).reshape(1, 1, 8), tids)
    np.testing.assert_array_equal(tfull.numpy(), np.asarray(jfull))


# ---------------------------------------------------------------------------
# The training forwards and their gradients
# ---------------------------------------------------------------------------


def _vanilla(norm_pix, impl, dtype, lpips_on, seed=0):
    js, params, consts, model = _pair(seed, norm_pix_loss=norm_pix, **STAGE1)
    n_keep = int(js.num_patches * 0.75)
    imgs, mask_noise, latent_noise = _inputs(seed, n_keep)
    jd = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jfn = tfn = None
    if lpips_on:
        lp = _jax_lpips()
        jfn, tfn = jlpips.make_lpips_fn(lp), make_lpips_fn(_port_lpips(lp))

    def jloss(p):
        out = jvmae.forward_vanilla(p, js, consts, jnp.asarray(imgs), jax.random.key(0), mask_ratio=0.25,
                                    visible_loss_ratio=0.75, perceptual_loss_fn=jfn, compute_dtype=jd,
                                    attn_impl=impl, mask_noise=jnp.asarray(mask_noise),
                                    latent_noise=jnp.asarray(latent_noise))
        return out["loss"], out

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tout = model.forward_vanilla(torch.from_numpy(imgs), mask_ratio=0.25, visible_loss_ratio=0.75,
                                 perceptual_loss_fn=tfn, compute_dtype=dtype, attn_impl=impl,
                                 mask_noise=torch.from_numpy(mask_noise), latent_noise=torch.from_numpy(latent_noise))
    tout["loss"].backward()
    return js, model, jl, jout, jgrads, tout


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("norm_pix", [False, True], ids=["pix", "norm_pix"])
def test_forward_vanilla_matches_jax(norm_pix, impl):
    js, model, jl, jout, jgrads, tout = _vanilla(norm_pix, impl, torch.float32, False)
    for k in ("loss", "vis_loss", "mask_loss", "kl_loss"):
        assert abs(float(tout[k]) - float(jout[k])) <= LOSS_REL * abs(float(jout[k])), k
    np.testing.assert_array_equal(tout["mask"].numpy(), np.asarray(jout["mask"]))
    assert _check_grads(model, jgrads, model.spec, GRAD_REL_L2) == len(list(model.parameters()))


def test_forward_vanilla_bf16_matches_jax():
    js, model, jl, jout, jgrads, tout = _vanilla(False, "xla", torch.bfloat16, False, seed=1)
    assert abs(float(tout["loss"]) - float(jl)) <= BF16_LOSS_REL * abs(float(jl))
    _check_grads(model, jgrads, model.spec, BF16_GRAD_REL_L2)


def test_forward_vanilla_with_lpips_matches_jax():
    js, model, jl, jout, jgrads, tout = _vanilla(False, "xla", torch.float32, True, seed=2)
    assert float(tout["p_loss"]) > 0
    for k in ("loss", "p_loss"):
        assert abs(float(tout[k]) - float(jout[k])) <= LOSS_REL * abs(float(jout[k])), k
    _check_grads(model, jgrads, model.spec, GRAD_REL_L2)


def test_lpips_loss_passes_a_gradient_to_the_reconstruction():
    """The perceptual term alone, as the trainers call it: a nonzero
    gradient in the reconstruction, equal to JAX's, and none for the frozen
    LPIPS weights."""
    lp = _jax_lpips()
    model = _port_lpips(lp)
    fn = make_lpips_fn(model)
    rng = np.random.default_rng(3)
    imgs, recon = (rng.uniform(-1, 1, (2, 3, 16, 16)).astype(np.float32) for _ in range(2))
    jg = jax.jit(jax.grad(lambda r: jnp.mean(jlpips.make_lpips_fn(lp)(jnp.asarray(imgs), r))))(jnp.asarray(recon))
    r = torch.from_numpy(recon).requires_grad_()
    fn(torch.from_numpy(imgs), r).mean().backward()
    assert float(r.grad.abs().max()) > 0
    assert _rel_l2(r.grad.numpy(), np.asarray(jg)) <= GRAD_REL_L2
    assert all(p.grad is None and not p.requires_grad for p in model.parameters())


def test_forward_ldmae_matches_jax(monkeypatch):
    from ldmae_tpu.ops import gaussian as jgaussian

    js, params, consts, model = _pair(3, **STAGE3)
    imgs, _, latent_noise = _inputs(4, js.num_patches)
    lp = _jax_lpips()
    jfn, tfn = jlpips.make_lpips_fn(lp), make_lpips_fn(_port_lpips(lp))
    # the JAX reconstruct samples the posterior from its key; its eps is
    # replaced by the noise the port is given
    real_sample, eps = jgaussian.DiagonalGaussian.sample, jnp.asarray(latent_noise)
    monkeypatch.setattr(jgaussian.DiagonalGaussian, "sample", lambda self, k, noise=None: real_sample(self, k, eps))

    def jloss(p):
        out = jvmae.forward_ldmae(p, js, consts, jnp.asarray(imgs), key=jax.random.key(5), perceptual_loss_fn=jfn)
        return out["loss"], out

    (jl, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tout = model.forward_ldmae(torch.from_numpy(imgs), perceptual_loss_fn=tfn,
                               latent_noise=torch.from_numpy(latent_noise))
    tout["loss"].backward()
    for k in ("loss", "vis_loss", "p_loss"):
        assert abs(float(tout[k]) - float(jout[k])) <= LOSS_REL * abs(float(jout[k])), k
    n = _check_grads(model, jgrads, model.spec, GRAD_REL_L2, only=lambda name: ttrain.trains(name, True))
    assert n == sum(ttrain.trains(name, True) for name, _ in model.named_parameters()) > 0
    # the mode (no noise, no generator) is another latent: another loss
    with torch.no_grad():
        mode = model.forward_ldmae(torch.from_numpy(imgs), perceptual_loss_fn=tfn)
    assert float(mode["loss"]) != float(tout["loss"])


@pytest.mark.parametrize("tune_decoder", [False, True], ids=["stage1", "stage3"])
def test_per_block_recomputation_gives_the_same_gradients(tune_decoder):
    """``use_checkpoint`` (the JAX package's per-block remat) recomputes each
    block in the backward: the same loss and gradients (1e-6 relative)."""
    import dataclasses

    _, _, _, model = _pair(7, **(STAGE3 if tune_decoder else STAGE1))
    remat = VMAE(dataclasses.replace(model.spec, use_checkpoint=True), device="cpu")
    remat.load_state_dict(model.state_dict())
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8))
    n_keep = model.spec.num_patches if tune_decoder else 12
    noise = dict(mask_noise=torch.from_numpy(rng.uniform(size=(B, 16)).astype(np.float32)),
                 latent_noise=torch.from_numpy(rng.standard_normal((B, 16, n_keep)).astype(np.float32)))
    losses = []
    for m in (model, remat):
        out = ttrain.vmae_loss(m, x, tune_decoder=tune_decoder, mask_ratio=0.25, **noise)
        out["loss"].backward()
        losses.append(float(out["loss"]))
    assert losses[0] == losses[1]
    for (n, p), q in zip(model.named_parameters(), remat.parameters()):
        assert (p.grad is None) == (q.grad is None), n
        if p.grad is not None:
            assert float((p.grad - q.grad).abs().max()) <= 1e-6 * float(p.grad.abs().max()), n


# ---------------------------------------------------------------------------
# Optimizer, schedule, the train step
# ---------------------------------------------------------------------------


def test_cosine_lr_matches_jax():
    for warm in (0, 2):
        for fixed in (False, True):
            jf = jtrain.cosine_lr(1e-3, 1e-5, warm, 10, fixed)
            tf = ttrain.cosine_lr(1e-3, 1e-5, warm, 10, fixed)
            for epoch in (0.0, 0.25, 1.5, 2.0, 2.75, 7.3, 10.0):
                assert abs(tf(epoch) - float(jf(jnp.float32(epoch)))) <= 1e-9, (warm, fixed, epoch)


@pytest.mark.parametrize("kw", [STAGE1, dict(STAGE1, no_cls=False, down_nonlinear=True),
                                dict(STAGE1, smooth_output=True, pred_with_conv=True)],
                         ids=["stage1", "cls_nonlinear", "pred_with_conv"])
def test_decay_mask_matches_jax(kw):
    js, params, _, model = _pair(0, **kw)
    jmask = jtrain._decay_mask(params)
    as_arrays = jax.tree_util.tree_map(lambda p, m: np.full(p.shape, float(m), np.float32), params, jmask)
    ref = vmae_state_dict_from_jax(as_arrays, model.spec)
    for name, p in model.named_parameters():
        want = bool(ref[name].all())
        assert want == bool(ref[name].any()), name
        assert ttrain.decays(name, p) == want, name
    names = dict(model.named_parameters())
    assert ttrain.decays("blocks.0.norm1.bias", names["blocks.0.norm1.bias"])  # stacked in JAX: 2-D
    assert not ttrain.decays("norm.bias", names["norm.bias"])


def _optax_tx(params, tune_decoder, spe=4, warm=1.0):
    return jtrain.make_vmae_optimizer(params, spe, base_lr=2e-3, min_lr=1e-5, warmup_epochs=warm,
                                      total_epochs=5, weight_decay=0.05, tune_decoder=tune_decoder)


def _port_opt(model, tune_decoder, spe=4, warm=1.0):
    opt = ttrain.make_vmae_optimizer(model, weight_decay=0.05, tune_decoder=tune_decoder)
    return opt, ttrain.lr_schedule(spe, 2e-3, 1e-5, warm, 5)


def _seeded_grads(params, seed):
    return randomize(params, seed, std=1.0)


def _set_grads(model, jgrads, tune_decoder=False):
    sd = vmae_state_dict_from_jax(to_numpy(jgrads), model.spec)
    for name, p in model.named_parameters():
        p.grad = sd[name].clone() if p.requires_grad else None


def _check_params(model, jparams, tol=1e-6):
    ref = vmae_state_dict_from_jax(to_numpy(jparams), model.spec)
    for name, p in model.named_parameters():
        r = ref[name].numpy().astype(np.float64)
        err = np.abs(p.detach().numpy() - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= tol, (name, err)


@pytest.mark.parametrize("tune_decoder", [False, True], ids=["stage1", "stage3"])
def test_optimizer_steps_match_optax(tune_decoder):
    """Three updates from the same gradients (warmup 1 epoch of 4 steps, so
    the rates are 0, 5e-4 and 1e-3 x the base): stage 1 every leaf, stage 3
    the trained leaves, against optax; stage 3's frozen leaves bitwise
    unchanged."""
    js, params, _, model = _pair(1, **(STAGE3 if tune_decoder else STAGE1))
    tx = _optax_tx(params, tune_decoder)
    opt, schedule = _port_opt(model, tune_decoder)
    state = TrainState(step=0, model=model, ema=None, optimizer=opt)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    assert bool(frozen) == tune_decoder
    opt_state = tx.init(params)

    @jax.jit
    def update(g, opt_state, params):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    for i in range(3):
        g = _seeded_grads(params, 100 + i)
        params, opt_state = update(g, opt_state, params)
        _set_grads(model, g)
        ttrain.apply_vmae_update_(state, schedule, True)
    _check_params(model, params)
    assert state.step == 3 and ttrain.applied_updates(opt) == 3
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]) and p.grad is None, n


def test_non_finite_step_is_a_no_op_and_keeps_the_rate_count():
    """A NaN loss in the middle of three steps (the train step's gating, as
    the JAX train step gates params and opt_state): the parameters and the
    optimizer state stay as they were, the step counts, and the next update
    takes the rate of update count 1, as optax's count (which the NaN step
    did not advance) gives it."""
    js, params, consts, model = _pair(2, **STAGE1)
    tx = _optax_tx(params, False)
    opt, schedule = _port_opt(model, False)
    state = TrainState(step=0, model=model, ema=None, optimizer=opt)
    # JAX: the train step itself, with a NaN image batch at step 2
    jstep = jax.jit(jtrain.make_vmae_train_step(js, consts, tx, mask_ratio=0.25, visible_loss_ratio=0.75))
    from ldmae_tpu.train.state import TrainState as JTrainState

    jstate = JTrainState(jnp.zeros((), jnp.int32), params, None, tx.init(params))
    rng = np.random.default_rng(6)
    batches = [rng.uniform(-1, 1, (B, 3, IMG, IMG)).astype(np.float32) for _ in range(3)]
    batches[1][0, 0, 0, 0] = np.nan
    tstep = ttrain.make_vmae_train_step(schedule, mask_ratio=0.25, visible_loss_ratio=0.75)
    gen = torch.Generator().manual_seed(0)
    for i, x in enumerate(batches):
        jstate, jm = jstep(jstate, {"x": jnp.asarray(x)}, jax.random.key(7))
        before = ({n: p.detach().clone() for n, p in model.named_parameters()},
                  {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in opt.state.items()})
        tm = tstep(state, {"x": torch.from_numpy(x)}, gen)
        assert bool(tm["loss_finite"]) == bool(jm["loss_finite"]) == (i != 1)
        if i == 1:
            for n, p in model.named_parameters():
                assert torch.equal(p, before[0][n]), n
            for k, v in opt.state.items():
                for kk, vv in v.items():
                    assert torch.equal(vv, before[1][k][kk]), kk
            assert all(p.grad is None for p in model.parameters())
    counts = {int(c) for _, c in optax.tree_utils.tree_get_all_with_path(jstate.opt_state, "count")}
    assert len(counts) == 1  # Adam's bias correction and the schedule's
    jcount = counts.pop()
    assert ttrain.applied_updates(opt) == jcount == 2 and state.step == int(jstate.step) == 3
    # the rate of the next update, from the two counts
    jsched = lambda c: float(jtrain.cosine_lr(2e-3, 1e-5, 1.0, 5)(jnp.float32(c / 4)))
    assert abs(schedule(ttrain.applied_updates(opt)) - jsched(jcount)) <= 1e-9


def test_grad_accum_two_equals_the_average_of_its_micro_batches():
    _, _, _, model = _pair(4, **STAGE1)
    ref_model = VMAE(model.spec, device="cpu")
    ref_model.load_state_dict(model.state_dict())
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(0, 256, (2, B, IMG, IMG, 3), dtype=np.uint8))
    n_keep = int(model.spec.num_patches * 0.75)
    mask_noise = torch.from_numpy(rng.uniform(size=(2, B, model.spec.num_patches)).astype(np.float32))
    latent_noise = torch.from_numpy(rng.standard_normal((2, B, 16, n_keep)).astype(np.float32))
    kw = dict(mask_ratio=0.25, visible_loss_ratio=0.75)
    schedule = ttrain.lr_schedule(1, 1e-3, warmup_epochs=0, total_epochs=10)
    state = TrainState(0, model, None, ttrain.make_vmae_optimizer(model))
    metrics = ttrain.make_vmae_train_step(schedule, grad_accum=2, **kw)(
        state, {"x": x}, mask_noise=mask_noise, latent_noise=latent_noise)
    losses = []
    for i in range(2):
        out = ttrain.vmae_loss(ref_model, x[i], mask_noise=mask_noise[i], latent_noise=latent_noise[i], **kw)
        (out["loss"] / 2).backward()
        losses.append(float(out["loss"]))
    assert abs(float(metrics["loss"]) - sum(losses) / 2) <= 1e-6 * abs(sum(losses))
    ref_state = TrainState(0, ref_model, None, ttrain.make_vmae_optimizer(ref_model))
    ttrain.apply_vmae_update_(ref_state, schedule, True)
    for (n, p), q in zip(model.named_parameters(), ref_model.parameters()):
        err = float((p - q).abs().max() / q.abs().max())
        assert err <= 1e-6, (n, err)


def test_uint8_batches_normalise_as_float_batches():
    """The train step's uint8 path: the same losses as the float32 images
    of the same pixels."""
    _, _, _, model = _pair(5, **STAGE1)
    rng = np.random.default_rng(9)
    u8 = rng.integers(0, 256, (B, IMG, IMG, 3), dtype=np.uint8)
    f32 = ((u8.astype(np.float32) / 255.0 - 0.5) / 0.5).transpose(0, 3, 1, 2)
    noise = dict(mask_noise=torch.from_numpy(rng.uniform(size=(B, 16)).astype(np.float32)),
                 latent_noise=torch.from_numpy(rng.standard_normal((B, 16, 12)).astype(np.float32)))
    with torch.no_grad():
        a = ttrain.vmae_loss(model, torch.from_numpy(u8), mask_ratio=0.25, **noise)
        b = ttrain.vmae_loss(model, torch.from_numpy(np.ascontiguousarray(f32)), mask_ratio=0.25, **noise)
    assert all(torch.equal(a[k], b[k]) for k in ttrain.METRIC_KEYS)


# ---------------------------------------------------------------------------
# Data, pe_reset, init, checkpoint merge, FLOPs
# ---------------------------------------------------------------------------


def test_train_augment_same_bytes_as_jax():
    from PIL import Image

    rng = np.random.default_rng(10)
    for size in ((40, 44), (300, 280), (64, 64)):
        img = Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8))
        for seed in range(6):
            for raw in (True, False):
                a = taugment.train_augment(img, np.random.default_rng(seed), 32, raw_uint8=raw)
                b = jaugment.train_augment(img, np.random.default_rng(seed), 32, raw_uint8=raw)
                assert a.dtype == b.dtype and np.array_equal(a, b), (size, seed, raw)
        for seed in range(6):
            assert (taugment.random_resized_crop_params(np.random.default_rng(seed), *size)
                    == jaugment.random_resized_crop_params(np.random.default_rng(seed), *size))


@pytest.mark.parametrize("old,new", [(16, 32), (32, 16)])
def test_pe_reset_resize_matches_jax(old, new):
    pe = np.random.default_rng(old).standard_normal((1, old * old, 24)).astype(np.float32)
    ref = jpe_reset.resize_pos_embed_np(pe, new)
    out = tpe_reset.resize_pos_embed(torch.from_numpy(pe), new).numpy()
    assert out.shape == ref.shape == (1, new * new, 24)
    assert np.abs(out - ref).max() <= 1e-6


def test_pe_reset_cli_names_and_refuses_to_overwrite(tmp_path):
    sd = {"pos_embed": torch.randn(1, 256, 8), "decoder_pos_embed": torch.randn(1, 256, 8), "w": torch.ones(2)}
    src = str(tmp_path / "ckpt.pth")
    torch.save({"model": sd, "epoch": 90}, src)
    out = tpe_reset.main(["--ckpt_dir", src, "--input_size", "256", "--patch_size", "8"])
    assert out == str(tmp_path / "ckpt_pe.pth")
    ckpt = torch.load(out, weights_only=False)
    assert ckpt["epoch"] == 90 and tuple(ckpt["model"]["pos_embed"].shape) == (1, 1024, 8)
    assert torch.equal(ckpt["model"]["w"], sd["w"])
    with pytest.raises(SystemExit):
        tpe_reset.main(["--ckpt_dir", src, "--save_dir", src])


def test_reference_init_distributions_match_jax():
    """The JAX package's initialisation, drawn from another generator: the
    same zero and one leaves exactly; each random leaf with the std of the
    JAX draw within 20 % and, for the uniform (xavier) ones, the same
    largest |w| within 5 % (the smallest such leaf, the smoother, has 81
    values)."""
    kw = dict(STAGE1, no_cls=False)
    js = jvmae.vmae_spec("mae_for_ldmae_f8d16_small", **kw)
    ref = vmae_state_dict_from_jax(to_numpy(jvmae.init_vmae_params(jax.random.key(0), js)),
                                   tvmae.vmae_spec("mae_for_ldmae_f8d16_small", **kw))
    model = init_vmae_weights_(VMAE(tvmae.vmae_spec("mae_for_ldmae_f8d16_small", **kw), device="cpu"),
                               torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        r = ref[name]
        if bool((r == 0).all()) or bool((r == 1).all()):
            assert torch.equal(p, r), name
        else:
            assert abs(float(p.std()) / float(r.std()) - 1) <= 0.2, name
            if name not in ("cls_token", "mask_token"):  # uniform: the same largest |w|
                assert abs(float(p.abs().max()) / float(r.abs().max()) - 1) <= 0.05, name


def test_load_vmae_weights_merges_strict_false(tmp_path):
    """A stage-1 checkpoint into a stage-3 model at twice the resolution:
    every matching tensor loads; the mask token is unexpected, the
    positional buffers of the other grid keep the model's values."""
    _, _, _, stage1 = _pair(6, **STAGE1)
    path = str(tmp_path / "s1.pth")
    torch.save({"model": stage1.state_dict()}, path)
    stage3 = VMAE(tvmae.vmae_spec("mae_for_ldmae_f8d16_small", **dict(STAGE3, img_size=2 * IMG)), device="cpu")
    pe = stage3.pos_embed.clone()
    out = load_vmae_weights_(stage3, path)
    assert out["unexpected"] == ["mask_token"]
    assert sorted(m.split(" ")[0] for m in out["missing"]) == ["decoder_pos_embed", "pos_embed"]
    assert torch.equal(stage3.pos_embed, pe)
    for name, p in stage3.named_parameters():
        assert torch.equal(p, stage1.state_dict()[name]), name


def test_vmae_flops_match_jax():
    for kw, mr in ((STAGE1, 0.25), (STAGE3, 0.0), (dict(STAGE1, no_cls=False), 0.75)):
        js = jvmae.vmae_spec("mae_for_ldmae_f8d16_prev", **kw)
        ts = tvmae.vmae_spec("mae_for_ldmae_f8d16_prev", **kw)
        assert tprofiling.vmae_forward_flops(ts, 8, mr) == jprofiling.vmae_forward_flops(js, 8, mr)

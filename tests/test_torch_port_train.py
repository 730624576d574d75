"""The port's DiT training slice vs ``ldmae_tpu`` on the CPU.

* The plain backwards of the two flash-attention backward kernels against
  ``jax.vjp`` of ``flash_attention`` and ``flash_attention_rope_trainable``
  (their Pallas backward kernels in interpret mode), fp32: max |diff| within
  1e-5 of the largest |gradient| (the same fp32 math; summation order only).
* ``torch.autograd.gradcheck`` in float64 on the differentiable Functions
  (default tolerances), and ``fused_norm_modulate``'s backward against the
  JAX custom VJP (fp32, 1e-5 relative).
* Paths (fp32, 1e-6 relative; the drift 1e-5), training losses and the
  truncated logit-normal (1e-5 relative) against JAX with injected noise
  and t.
* The DiT loss and per-leaf gradients against ``jax.grad`` in three
  configurations, fp32 compute on both sides: loss within 1e-5 relative,
  every leaf within relative L2 error 2e-3 (``tests/test_grad_parity.py``'s
  bound; fp32 rounding through the depth-2 net stays far below it). The
  remat policies against no remat (1e-6: the same ops, recomputed).
* One AdamW + clip + EMA step, and a 2-micro-batch accumulation, against
  optax (``ldmae_tpu.train.train_dit.make_optimizer``) fed the same
  gradients: every leaf within relative L2 error 1e-5.
* The port's safetensors reader and dataset against the JAX dataset on
  shards written by the JAX ``LatentShardWriter``: exact.
* The train CLI on the CPU: 3 steps, a checkpoint that restores the run's
  state exactly, a resume to 5 steps, and a sample from the checkpoint
  through the inference CLI; a SIGTERM that saves a preemption checkpoint.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax
import yaml

from ldmae_tpu.data.latent_dataset import ImgLatentDataset as JImgLatentDataset
from ldmae_tpu.data.latent_dataset import LatentShardWriter
from ldmae_tpu.models import lightningdit as jdit
from ldmae_tpu.ops import flash_attention as jfa
from ldmae_tpu.ops.fused_adaln import fused_norm_modulate as jfused_norm_modulate
from ldmae_tpu.train import torch_import
from ldmae_tpu.train.train_dit import make_optimizer as jmake_optimizer
from ldmae_tpu.transport import paths as jpaths
from ldmae_tpu.transport.transport import create_transport as jcreate_transport
from ldmae_tpu.utils import profiling as jprofiling

from torch_port_helpers import randomize, to_numpy

from ldmae_tpu_torch.convert import dit_state_dict_from_jax
from ldmae_tpu_torch.data import ImgLatentDataset, read_safetensors
from ldmae_tpu_torch.models import LightningDiT, init_dit_weights_, permute_qk_for_half_rope
from ldmae_tpu_torch.models import lightningdit as tdit
from ldmae_tpu_torch.ops import flash_attention as tfa
from ldmae_tpu_torch.ops import fused_adaln as tfad
from ldmae_tpu_torch.ops.rope import build_rope_table, to_half_layout
from ldmae_tpu_torch.train import apply_update_, dit_loss, init_train_state, make_optimizer, make_train_step
from ldmae_tpu_torch.transport import create_transport
from ldmae_tpu_torch.transport import paths as tpaths
from ldmae_tpu_torch.transport.transport import logit_normal_in_range
from ldmae_tpu_torch.utils import profiling as tprofiling


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _rel_l2(a, b):
    """||a - b|| / max(||b||, 1e-3), as tests/test_grad_parity.py compares leaves."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-3))


# ---------------------------------------------------------------------------
# The backward kernels' plain versions, gradcheck, fused adaLN backward
# ---------------------------------------------------------------------------


def _qkvg(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("rope", [False, True], ids=["flash_attention", "flash_attention_rope"])
def test_plain_backward_matches_pallas_vjp(rope):
    b, h, n, d = 2, 2, 64, 16
    q, k, v, g = _qkvg((b, h, n, d), 0)
    cos, sin = (to_half_layout(t) for t in build_rope_table(d // 2, 8))
    if rope:
        _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention_rope_trainable(q, k, v, cos, sin), q, k, v)
        ref = vjp(jnp.asarray(g))
        out = tfa.flash_attention_rope_bwd_plain(*map(torch.from_numpy, (q, k, v, g)),
                                                 torch.from_numpy(cos), torch.from_numpy(sin))
    else:
        _, vjp = jax.vjp(jfa.flash_attention, q, k, v)
        ref = vjp(jnp.asarray(g))
        out = tfa.flash_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, g)))
    for o, r in zip(out, ref):
        assert _rel_max(o.numpy(), r) < 1e-5


def _gradcheck_cases():
    rng = np.random.default_rng(1)

    def t(*shape, grad=True):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_(grad)

    cos, sin = (torch.from_numpy(to_half_layout(x)).double() for x in build_rope_table(4, 4))
    return {
        "flash_attention": (tfa.flash_attention, (t(1, 2, 16, 8), t(1, 2, 16, 8), t(1, 2, 16, 8))),
        "flash_attention_rope_trainable": (
            tfa.flash_attention_rope, (t(1, 2, 16, 8), t(1, 2, 16, 8), t(1, 2, 16, 8), cos, sin)),
        "fused_norm_modulate_rms": (
            lambda x, w, sh, sc: tfad.fused_norm_modulate(x, w, sh, sc, kind="rms"),
            (t(2, 5, 8), t(8), t(2, 8), t(2, 8))),
        "fused_norm_modulate_layer": (
            lambda x, sh, sc: tfad.fused_norm_modulate(x, None, sh, sc, kind="layer"),
            (t(2, 5, 8), t(2, 8), t(2, 8))),
    }


@pytest.mark.parametrize("case", list(_gradcheck_cases()))
def test_gradcheck_float64(case):
    fn, args = _gradcheck_cases()[case]
    assert torch.autograd.gradcheck(fn, args)


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_fused_norm_modulate_backward_matches_jax_vjp(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 128, 64)).astype(np.float32) * 2
    w = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    sh, sc, g = (rng.standard_normal(s).astype(np.float32) for s in ((2, 64), (2, 64), (2, 128, 64)))
    _, vjp = jax.vjp(lambda x, w, sh, sc: jfused_norm_modulate(x, w, sh, sc, kind=kind), x, w, sh, sc)
    ref = vjp(jnp.asarray(g))
    tx, tw, tsh, tsc = (torch.from_numpy(a).requires_grad_() for a in (x, w, sh, sc))
    out = tfad.fused_norm_modulate(tx, tw, tsh, tsc, kind=kind)
    grads = torch.autograd.grad(out, (tx, tw, tsh, tsc), torch.from_numpy(g))
    names = ("dx", "dw", "dshift", "dscale")
    for name, o, r in zip(names, grads, ref):
        if kind == "layer" and name == "dw":
            assert not o.any() and not np.asarray(r).any()
            continue
        assert _rel_max(o.numpy(), r) < 1e-5, name


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", ["ICPlan", "VPCPlan", "GVPCPlan"])
def test_paths_match_jax(plan):
    rng = np.random.default_rng(3)
    t = rng.uniform(0.05, 0.95, 4).astype(np.float32)
    x0, x1 = (rng.standard_normal((4, 3, 2, 2)).astype(np.float32) for _ in range(2))
    ref = getattr(jpaths, plan)().plan(jnp.asarray(t), jnp.asarray(x0), jnp.asarray(x1))
    out = getattr(tpaths, plan)().plan(*map(torch.from_numpy, (t, x0, x1)))
    for o, r in zip(out, ref):
        assert _rel_max(o.numpy(), r) < 1e-6
    ref = getattr(jpaths, plan)().compute_drift(jnp.asarray(x1), jnp.asarray(t))
    out = getattr(tpaths, plan)().compute_drift(torch.from_numpy(x1), torch.from_numpy(t))
    for o, r in zip(out, ref):
        assert _rel_max(np.broadcast_to(o.numpy(), np.shape(r)), r) < 1e-5


@pytest.mark.parametrize(
    "kw",
    [dict(path_type="Linear", prediction="velocity", use_cosine_loss=True, use_lognorm=True),
     dict(path_type="Linear", prediction="noise", loss_weight="velocity"),
     dict(path_type="VP", prediction="score", loss_weight="likelihood"),
     dict(path_type="GVP", prediction="velocity")],
    ids=["velocity-cos", "noise-velocity-weight", "vp-score-likelihood", "gvp-velocity"],
)
def test_training_losses_match_jax(kw):
    """Injected noise, t pinned by sp_timesteps=(c, c), one fixed model
    function on both sides."""
    rng = np.random.default_rng(4)
    x1, x0 = (rng.standard_normal((3, 4, 4, 4)).astype(np.float32) for _ in range(2))
    c = 0.37

    def jmodel(xt, t, y):
        return jnp.tanh(xt) * 0.5 + t[:, None, None, None] + y[:, None, None, None]

    def tmodel(xt, t, y):
        return torch.tanh(xt) * 0.5 + t[:, None, None, None] + y[:, None, None, None]

    y = np.array([0.0, 0.1, -0.2], np.float32)
    ref = jcreate_transport(**kw).training_losses(
        jmodel, jax.random.key(0), jnp.asarray(x1), dict(y=jnp.asarray(y)), sp_timesteps=(c, c),
        x0=jnp.asarray(x0))
    out = create_transport(**kw).training_losses(
        tmodel, torch.from_numpy(x1), dict(y=torch.from_numpy(y)), sp_timesteps=(c, c),
        x0=torch.from_numpy(x0))
    assert set(out) == set(ref)
    for key in ref:
        assert _rel_max(out[key].detach().numpy(), ref[key]) < 1e-5, key


def test_truncated_logit_normal_matches_jax():
    key = jax.random.key(5)
    lo, hi = 0.2, 0.7
    u = np.array(jax.random.uniform(key, (512,)))
    transport = jcreate_transport(use_lognorm=True, partitial_train=[lo, hi])
    ref = np.asarray(transport._sample_logit_normal_in_range(key, 0.0, 1.0, (512,), lo, hi))
    out = logit_normal_in_range(torch.from_numpy(u), 0.0, 1.0, lo, hi).numpy()
    assert _rel_max(out, ref) < 1e-5
    assert out.min() >= lo and out.max() <= hi


def test_sampled_t_laws():
    """Uniform t on [0, 1), logit-normal t (median 0.5), and the partial
    range mixed in with probability partial_ratio."""
    gen = torch.Generator().manual_seed(0)
    x1 = torch.zeros(4000, 1)
    t_u, _, _ = create_transport().sample(x1, gen)
    t_ln, _, _ = create_transport(use_lognorm=True).sample(x1, gen)
    assert 0 <= float(t_u.min()) and float(t_u.max()) < 1 and abs(float(t_u.mean()) - 0.5) < 0.03
    assert abs(float(t_ln.median()) - 0.5) < 0.03 and float(t_ln.std()) < float(t_u.std())
    part = create_transport(use_lognorm=True, partitial_train=[0.2, 0.3], partial_ratio=1.0)
    t_p, _, _ = part.sample(x1, gen)
    assert float(t_p.min()) >= 0.2 and float(t_p.max()) <= 0.3


# ---------------------------------------------------------------------------
# The DiT train step: loss and gradients vs jax.grad
# ---------------------------------------------------------------------------

DIT_DIMS = dict(
    input_size=8, patch_size=1, in_channels=4, hidden_size=64, depth=2,
    num_heads=4, num_classes=10, class_dropout_prob=0.1, learn_sigma=False,
    use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True,
)
T_FIXED = 0.37
# (attention impl, RoPE layout, adaLN impl, remat policy or None)
TRAIN_CONFIGS = {
    "xla": ("xla", "interleaved", "xla", None),
    "flash_rope-half-fused-remat_attn": ("flash_rope", "half", "fused", "attn"),
    "flash-interleaved": ("flash", "interleaved", "xla", None),
}


def _train_inputs():
    rng = np.random.default_rng(7)
    x1, x0 = (rng.standard_normal((2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    return x1, x0, np.array([1, 9]), np.array([0, 1], np.int32)


def _jax_params(js, layout):
    params = randomize(jdit.init_dit_params(jax.random.key(0), js), 0)
    return jdit.permute_qk_for_half_rope(params, js) if layout == "half" else params


def _port_model(ts, jparams):
    model = LightningDiT(ts, device="cpu")
    model.load_state_dict(dit_state_dict_from_jax(to_numpy(jparams), ts), strict=True)
    return model


def _port_loss(model, x1, x0, y, drop, attn, layout, adaln, ts):
    transport = create_transport(use_cosine_loss=True, use_lognorm=True)
    return dit_loss(model, transport, torch.from_numpy(x1), torch.from_numpy(y),
                    x0=torch.from_numpy(x0), t=torch.full((2,), T_FIXED), drop_ids=torch.from_numpy(drop),
                    compute_dtype=torch.float32, attn_impl=attn, rope_layout=layout, adaln_impl=adaln)


@pytest.mark.parametrize("config", list(TRAIN_CONFIGS))
def test_dit_train_step_gradients_match_jax(config):
    attn, layout, adaln, remat = TRAIN_CONFIGS[config]
    remat_kw = dict(use_checkpoint=remat is not None, remat_policy=remat or "full")
    js, ts = jdit.DiTSpec(**DIT_DIMS, **remat_kw), tdit.DiTSpec(**DIT_DIMS, **remat_kw)
    jparams = _jax_params(js, layout)
    x1, x0, y, drop = _train_inputs()
    consts = jdit.DiTConsts(js)
    transport = jcreate_transport(use_cosine_loss=True, use_lognorm=True)

    def loss_fn(p):
        def model_fn(xt, t, yk):
            return jdit.dit_forward(p, js, consts, xt, t, yk, train=True, force_drop_ids=jnp.asarray(drop),
                                    compute_dtype=jnp.float32, attn_impl=attn, rope_layout=layout,
                                    adaln_impl=adaln)

        terms = transport.training_losses(model_fn, jax.random.key(0), jnp.asarray(x1),
                                          dict(yk=jnp.asarray(y)), sp_timesteps=(T_FIXED, T_FIXED),
                                          x0=jnp.asarray(x0))
        return terms["loss"].mean() + terms["cos_loss"].mean()

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    ref = dit_state_dict_from_jax(to_numpy(jgrads), ts)

    model = _port_model(ts, jparams)
    loss = _port_loss(model, x1, x0, y, drop, attn, layout, adaln, ts)
    loss.backward()
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    errs = {name: _rel_l2(p.grad.numpy(), ref[name].numpy()) for name, p in model.named_parameters()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 2e-3, (worst, errs[worst])
    for fam in ("x_embedder", "t_embedder", "y_embedder", "qkv", "proj", "adaLN", "w12", "w3",
                "norm1", "q_norm", "final_layer"):
        assert any(fam in n and np.abs(model.get_parameter(n).grad.numpy()).max() > 0 for n in errs), fam


@pytest.mark.parametrize("policy", ["full", "attn", "dots"])
def test_remat_policies_give_the_gradients_of_no_remat(policy):
    ts = tdit.DiTSpec(**DIT_DIMS)
    jparams = _jax_params(jdit.DiTSpec(**DIT_DIMS), "half")
    x1, x0, y, drop = _train_inputs()
    grads = []
    for spec in (ts, dataclasses.replace(ts, use_checkpoint=True, remat_policy=policy)):
        model = _port_model(spec, jparams)
        _port_loss(model, x1, x0, y, drop, "flash_rope", "half", "fused", spec).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# Optimizer, EMA, accumulation vs optax
# ---------------------------------------------------------------------------

LR, BETA2, CLIP = 1e-3, 0.95, 0.5


def _optax_steps(spec, sd, grad_sds):
    """optax make_optimizer (clip + AdamW) and EMA 0.9999 over the given
    gradient state dicts, through the JAX package's importer."""
    names = [k for k in sd if k not in ("pos_embed",) and not k.startswith("feat_rope")]
    params = torch_import.import_dit_state_dict({k: v.numpy() for k, v in sd.items()}, spec)
    tx = jmake_optimizer(LR, BETA2, max_grad_norm=CLIP)
    opt_state = tx.init(params)
    ema = params
    for gsd in grad_sds:
        full = {k: (gsd[k] if k in names else torch.zeros_like(v)).numpy() for k, v in sd.items()}
        grads = torch_import.import_dit_state_dict(full, spec)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree_util.tree_map(lambda e, p: 0.9999 * e + 1e-4 * p, ema, params)
    return dit_state_dict_from_jax(to_numpy(params), spec), dit_state_dict_from_jax(to_numpy(ema), spec)


def _assert_state_close(model, ref_sd, tol=1e-5):
    for n, p in model.named_parameters():
        assert _rel_l2(p.detach().numpy(), ref_sd[n].numpy()) <= tol, n


def test_adamw_clip_ema_steps_match_optax():
    """Two steps (bias correction at t = 1, 2) with gradients large enough
    for the clip to act, fed to both sides."""
    js = jdit.DiTSpec(**DIT_DIMS)
    ts = tdit.DiTSpec(**DIT_DIMS)
    model = _port_model(ts, _jax_params(js, "interleaved"))
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    state = init_train_state(model, make_optimizer(model.parameters(), LR, BETA2))
    rng = np.random.default_rng(8)
    grad_sds = []
    for step in range(2):
        gsd = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.05 * (1 + step))
               for n, p in model.named_parameters()}
        for n, p in model.named_parameters():
            p.grad = gsd[n].clone()
        norm = apply_update_(state, max_grad_norm=CLIP)
        assert float(norm) > CLIP  # the clip acts
        grad_sds.append(gsd)
    ref_params, ref_ema = _optax_steps(js, sd0, grad_sds)
    _assert_state_close(state.model, ref_params)
    _assert_state_close(state.ema, ref_ema)
    assert state.step == 2


def test_two_micro_batch_accumulation_matches_optax():
    """make_train_step with grad_accum 2: the micro-batch gradients (each
    computed alone by the port) averaged, then one optax step."""
    js = jdit.DiTSpec(**DIT_DIMS)
    ts = tdit.DiTSpec(**DIT_DIMS)
    jparams = _jax_params(js, "interleaved")
    rng = np.random.default_rng(9)
    x1, x0 = (rng.standard_normal((2, 2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    y = np.array([[1, 2], [3, 10]])
    drop = np.array([[0, 0], [1, 0]], np.int32)
    t = np.array([[0.2, 0.8], [0.5, 0.33]], np.float32)
    transport = create_transport(use_cosine_loss=True, use_lognorm=True)
    impls = dict(compute_dtype=torch.float32, attn_impl="flash", adaln_impl="fused")

    micro = []
    for i in range(2):
        model = _port_model(ts, jparams)
        dit_loss(model, transport, torch.from_numpy(x1[i]), torch.from_numpy(y[i]),
                 x0=torch.from_numpy(x0[i]), t=torch.from_numpy(t[i]),
                 drop_ids=torch.from_numpy(drop[i]), **impls).backward()
        micro.append({n: p.grad.clone() for n, p in model.named_parameters()})
    avg = {n: (micro[0][n] + micro[1][n]) / 2 for n in micro[0]}

    model = _port_model(ts, jparams)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    state = init_train_state(model, make_optimizer(model.parameters(), LR, BETA2))
    step = make_train_step(ts, transport, grad_accum=2, max_grad_norm=CLIP, **impls)
    metrics = step(state, {"x": torch.from_numpy(x1), "y": torch.from_numpy(y)},
                   x0=torch.from_numpy(x0), t=torch.from_numpy(t), drop_ids=torch.from_numpy(drop))
    ref_params, ref_ema = _optax_steps(js, sd0, [avg])
    _assert_state_close(state.model, ref_params)
    _assert_state_close(state.ema, ref_ema)
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in avg.values()])))
    assert abs(float(metrics["grad_norm"]) - norm) <= 1e-5 * norm
    assert np.isfinite(float(metrics["loss"]))


def test_reference_init_zeroes_the_gates_and_draws_the_rest():
    spec = tdit.DiTSpec(**DIT_DIMS)
    model = init_dit_weights_(LightningDiT(spec, device="cpu"), torch.Generator().manual_seed(0))
    model.requires_grad_(False)
    blk = model.blocks[0]
    assert not blk.adaLN_modulation[1].weight.any() and not model.final_layer.linear.weight.any()
    d, c = spec.hidden_size, spec.in_channels
    a = np.sqrt(6 / (d + 3 * d))
    w = blk.attn.qkv.weight
    assert float(w.abs().max()) <= a and float(w.abs().max()) > 0.9 * a and not blk.attn.qkv.bias.any()
    pe = model.x_embedder.proj.weight
    assert float(pe.abs().max()) <= np.sqrt(6 / (c + d))
    assert abs(float(model.y_embedder.embedding_table.weight.std()) - 0.02) < 2e-3
    assert torch.equal(blk.norm1.weight, torch.ones(d))


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.fixture
def shards(tmp_path):
    """Two shards written by the JAX package's writer (16-channel moments,
    so both ``sample`` settings can read them)."""
    rng = np.random.default_rng(10)
    w = LatentShardWriter(str(tmp_path / "lat"), shard_size=7)
    for _ in range(3):
        lat = rng.standard_normal((5, 16, 4, 4)).astype(np.float32)
        w.add(lat, lat[..., ::-1].copy(), rng.integers(0, 10, 5))
    w.flush()
    return str(tmp_path / "lat")


def test_safetensors_reader_matches_safetensors(shards):
    from safetensors.numpy import load_file

    for f in sorted(os.listdir(shards)):
        ours, theirs = read_safetensors(os.path.join(shards, f)), load_file(os.path.join(shards, f))
        assert set(ours) == set(theirs)
        for k in theirs:
            assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


@pytest.mark.parametrize("sample", [False, True])
def test_dataset_matches_jax(shards, sample):
    kw = dict(latent_multiplier=0.8, sample=sample, seed=3)
    js = JImgLatentDataset(shards, latent_norm=False, **kw).compute_latent_stats()
    ts = ImgLatentDataset(shards, latent_norm=False, **kw).compute_latent_stats()
    for k in ("mean", "std"):
        np.testing.assert_array_equal(ts[k], js[k])
    JImgLatentDataset(shards, latent_norm=True, **kw)  # writes latents_stats.pt
    jds = JImgLatentDataset(shards, latent_norm=True, **kw)  # both read it, so their
    tds = ImgLatentDataset(shards, latent_norm=True, **kw)  # generators start alike
    assert len(tds) == len(jds) == 15
    for i in (0, 6, 14):
        (tx, ty), (jx, jy) = tds[i], jds[i]
        np.testing.assert_array_equal(tx, jx)
        assert int(ty) == int(jy)
    it_kw = dict(shuffle=True, seed=5, start_epoch=1, skip_batches=1)
    for tb, jb in zip(tds.iter_batches(4, epochs=2, **it_kw), jds.iter_batches(4, epochs=2, **it_kw)):
        np.testing.assert_array_equal(tb["x"], jb["x"])
        np.testing.assert_array_equal(tb["y"], jb["y"])


# ---------------------------------------------------------------------------
# Profiling and the CLI
# ---------------------------------------------------------------------------


def test_flop_accounting_matches_jax():
    for kw in (dict(use_swiglu=True), dict(use_swiglu=False, wo_shift=True)):
        js, ts = jdit.dit_spec("LightningDiT-B/1", **kw), tdit.dit_spec("LightningDiT-B/1", **kw)
        assert tprofiling.dit_forward_flops(ts, 32) == jprofiling.dit_forward_flops(js, 32)
    assert tprofiling.resolve_peak_flops(None, "cpu") is None
    assert tprofiling.resolve_peak_flops(989.0) == 989e12
    assert "MFU n/a" in tprofiling.format_tflops_mfu(1e12, 1.0, None)
    assert "50% MFU" in tprofiling.format_tflops_mfu(1e12, 1.0, 2e12)


def _cli_config(tmp_path, shards, max_steps):
    cfg = {
        "data": {"data_path": shards, "image_size": 32, "num_classes": 10, "latent_norm": True},
        "vae": {"model_name": "vmae_f8d16", "weight_path": ""},
        "model": {"model_type": "LightningDiT-debug", "in_chans": 16, "remat_policy": "attn"},
        "train": {"max_steps": max_steps, "global_batch_size": 4, "global_seed": 1,
                  "output_dir": str(tmp_path / "out"), "exp_name": "tiny", "log_every": 1,
                  "ckpt_every": 3, "use_checkpoint": True},
        "optimizer": {"lr": 2e-4, "beta2": 0.95, "max_grad_norm": 1.0},
        "transport": {"use_lognorm": True},
        "sample": {"num_sampling_steps": 3, "cfg_scale": 1.0},  # demo label 0 (with CFG: ImageNet ids)
        "parallel": {"train_attention_impl": "flash_rope", "train_adaln_impl": "fused",
                     "rope_layout": "half"},
    }
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_train_cli_writes_a_profiler_trace_over_its_window(tmp_path, shards, monkeypatch, caplog):
    """``--profile_dir`` with the window at steps 1-2 (``--profile_start 1
    --profile_steps 2``) and ``max_steps`` 2 inside it: the trace starts
    before step 1's update, closes at max_steps (the JAX CLI's lines), and
    its file holds the step's ops."""
    from ldmae_tpu_torch.cli import train_dit

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    trace = tmp_path / "trace"
    out = train_dit.main(["--config", _cli_config(tmp_path, shards, 2), "--device", "cpu", "--profile_dir",
                          str(trace), "--profile_start", "1", "--profile_steps", "2"])
    log = open(os.path.join(out["exp_dir"], "log.txt")).read()
    assert f"profiler trace started -> {trace}" in log and f"profiler trace written to {trace}" in log
    assert log.index("profiler trace started") > log.index("(step=0000001)")
    assert log.index("profiler trace written") < log.index("Saved final checkpoint")
    (name,) = os.listdir(trace)
    text = (trace / name).read_text()
    assert name.endswith(".pt.trace.json") and "aten::" in text and "Optimizer.step#AdamW.step" in text


def test_train_cli_checkpoints_resumes_and_samples(tmp_path, shards, monkeypatch):
    """3 steps and a checkpoint that restores the run's state exactly (model,
    EMA and AdamW moments, through the canonical RoPE layout on disk); a
    restart to 5 steps that logs the resume and carries the optimizer on;
    then the checkpoint samples through the inference CLI. TensorBoard is
    made unimportable, so the log goes to log.txt only."""
    from PIL import Image

    from ldmae_tpu_torch.cli import inference, train_dit
    from ldmae_tpu_torch.train import restore_checkpoint

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = _cli_config(tmp_path, shards, 3)
    out = train_dit.main(["--config", cfg, "--device", "cpu"])
    exp, state = out["exp_dir"], out["state"]
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == ["0000003.pt"]
    assert [h["step"] for h in out["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in out["history"])

    spec = state.model.spec
    model = LightningDiT(spec, device="cpu")
    fresh = init_train_state(model, make_optimizer(model.parameters(), 2e-4, 0.95))
    restore_checkpoint(exp, fresh, half_rope=True)
    assert fresh.step == 3
    for a, b in ((fresh.model, state.model), (fresh.ema, state.ema)):
        for k, v in b.state_dict().items():
            torch.testing.assert_close(a.state_dict()[k], v, rtol=0, atol=0)
    for i, s_ref in state.optimizer.state_dict()["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(fresh.optimizer.state_dict()["state"][i][key], s_ref[key], rtol=0, atol=0)
    # on disk the weights are canonical: permuting them gives the half-split run
    saved = torch.load(os.path.join(exp, "checkpoints", "0000003.pt"), weights_only=True)
    assert set(saved) == {"model", "ema", "opt", "config", "step"} and saved["step"] == 3
    qkv = "blocks.0.attn.qkv.weight"
    assert not torch.equal(saved["model"][qkv], state.model.state_dict()[qkv])
    torch.testing.assert_close(permute_qk_for_half_rope(saved["model"], spec)[qkv],
                               state.model.state_dict()[qkv], rtol=0, atol=0)

    train_dit.main(["--config", cfg, "--device", "cpu", "--max_steps", "5"])
    log = open(os.path.join(exp, "log.txt")).read()
    assert "resumed from step 3" in log and "(step=0000005) Train Loss: " in log
    assert "Train Steps/Sec: " in log and "MFU n/a" in log
    last = torch.load(os.path.join(exp, "checkpoints", "0000005.pt"), weights_only=True)
    assert all(float(s["step"]) == 5 for s in last["opt"]["state"].values())

    demo = tmp_path / "demo"
    inference.main(["--config", cfg, "--ckpt", os.path.join(exp, "checkpoints", "0000005.pt"),
                    "--demo", "--demo_out", str(demo), "--device", "cpu"])
    (png,) = list(demo.iterdir())
    assert np.asarray(Image.open(png)).shape == (64, 128, 3)


def test_train_cli_sigterm_saves_a_preemption_checkpoint(tmp_path, shards, monkeypatch):
    """SIGTERM during training: the step finishes, a checkpoint is saved at
    that step, main returns, and the caller's handler is back in place; the
    validation loss is logged at each checkpoint."""
    import signal

    from ldmae_tpu_torch.cli import train_dit

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cfg = _cli_config(tmp_path, shards, 10)
    raw = yaml.safe_load(open(cfg))
    raw["data"]["valid_path"] = shards
    raw["train"]["ckpt_every"] = 1
    open(cfg, "w").write(yaml.safe_dump(raw))
    taken = []

    class Prefetcher(train_dit.Prefetcher):  # the training stream's background reader
        def __next__(self):
            taken.append(1)
            if len(taken) == 3:  # as step 3 starts, on the training loop's thread
                os.kill(os.getpid(), signal.SIGTERM)
            return super().__next__()

    monkeypatch.setattr(train_dit, "Prefetcher", Prefetcher)
    mine = signal.signal(signal.SIGTERM, signal.SIG_IGN)
    try:
        out = train_dit.main(["--config", cfg, "--device", "cpu"])
        assert signal.getsignal(signal.SIGTERM) is signal.SIG_IGN
    finally:
        signal.signal(signal.SIGTERM, mine)
    assert out["state"].step == 3
    log = open(os.path.join(out["exp_dir"], "log.txt")).read()
    assert "saving a preemption checkpoint at step 3" in log and "Validation Loss: " in log
    assert sorted(os.listdir(os.path.join(out["exp_dir"], "checkpoints")))[-1] == "0000003.pt"

"""The port's sampling chain vs ``ldmae_tpu``'s on the CPU: transport grid,
CFG, phased CFG and the whole ``make_sample_fn`` chain (Euler ODE, CFG with
the first-3-channel quirk, the phase split, denormalisation, VMAE decode
to uint8) at debug size with an injected initial noise ``z``, in bf16 and
with the DiT quantized for the w8a8 leg.

Tolerances: the time grid is numpy on both sides and must be identical.
In bf16 the two chains round at the same points, so they differ only where
a float32 sum order flips a bf16 rounding; over 7 Euler steps with CFG
those flips stay near bf16 resolution: latents within 2e-2 of their scale,
images within 2 of 255 levels. Under w8a8 a one-step flip of an int8
activation (a row reduced in another fp32 order) is worth 1/127 of its row's
absmax and feeds the next steps: latents within 5e-2 of their scale, images
within 4 levels.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ldmae_tpu.eval import sampling as jsampling
from ldmae_tpu.models import lightningdit as jdit
from ldmae_tpu.models import vmae as jvmae
from ldmae_tpu.transport import create_transport as jcreate_transport
from ldmae_tpu.transport import samplers as jsamplers

from ldmae_tpu_torch.convert import dit_state_dict_from_jax, vmae_state_dict_from_jax
from ldmae_tpu_torch.eval.sampling import make_sample_fn
from ldmae_tpu_torch.models import VMAE, LightningDiT, permute_qk_for_half_rope, quantize_dit_
from ldmae_tpu_torch.models import lightningdit as tdit
from ldmae_tpu_torch.models import vmae as tvmae
from ldmae_tpu_torch.transport import create_transport, forward_with_cfg, make_time_grid
from ldmae_tpu_torch.transport.samplers import Sampler

from torch_port_helpers import randomize, to_numpy

DIT = dict(input_size=8, in_channels=16, num_classes=10, depth=2, hidden_size=64, num_heads=4,
           use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True)
VAE = dict(img_size=64, depth=1, decoder_depth=2, ldmae_mode=True, no_cls=True,
           kl_loss_weight=True, smooth_output=True)
CHAIN = dict(num_steps=8, sampling_method="euler", timestep_shift=0.3, cfg_scale=4.0,
             cfg_interval=True, cfg_interval_start=0.10, cfg_channels=3)
IMPLS = dict(attn_impl="flash_rope", rope_layout="half", adaln_impl="fused", mlp_impl="fused")


@pytest.mark.parametrize("args", [(0.0, 1.0, 250, 0.3), (0.0, 1.0, 8, 0.0), (0.001, 0.999, 50, 2.0)])
def test_time_grid_identical(args):
    np.testing.assert_array_equal(make_time_grid(*args), jsamplers.make_time_grid(*args))


def test_phase_split_index_matches_and_happens():
    grid = Sampler(create_transport()).ode_time_grid(CHAIN["num_steps"], CHAIN["timestep_shift"])
    jgrid = jsamplers.Sampler(jcreate_transport()).ode_time_grid(CHAIN["num_steps"], CHAIN["timestep_shift"])
    np.testing.assert_array_equal(grid, jgrid)
    n1 = int(np.searchsorted(grid[:-1], CHAIN["cfg_interval_start"]))
    assert 0 < n1 < CHAIN["num_steps"] - 1
    # the production grid: 68 single-batch steps, then 181 doubled
    prod = Sampler(create_transport()).ode_time_grid(250, 0.3)
    assert int(np.searchsorted(prod[:-1], 0.10)) == 68


@pytest.mark.parametrize("t_val", [0.05, 0.1001, 0.5])
def test_forward_with_cfg_matches_jax(t_val):
    """Guidance on the first 3 channels only, unguided below the interval
    start, the comparison made in t's dtype (bf16)."""
    rng = np.random.default_rng(0)
    out = rng.standard_normal((4, 5, 2, 2)).astype(np.float32)
    x = rng.standard_normal((4, 5, 2, 2)).astype(np.float32)

    def jmodel(x, t, y):
        return jnp.asarray(out).astype(jnp.bfloat16)

    def tmodel(x, t, y):
        return torch.from_numpy(out).bfloat16()

    jt = jnp.full((4,), t_val, jnp.bfloat16)
    tt = torch.full((4,), t_val, dtype=torch.bfloat16)
    ref = jsamplers.forward_with_cfg(jmodel, jnp.asarray(x).astype(jnp.bfloat16), jt, None, 4.0,
                                     cfg_interval=True, cfg_interval_start=0.10)
    got = forward_with_cfg(tmodel, torch.from_numpy(x).bfloat16(), tt, None, 4.0,
                           cfg_interval=True, cfg_interval_start=0.10)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def _pipelines(seed=0, quant=None):
    js, ts = jdit.dit_spec("LightningDiT-debug", **DIT), tdit.dit_spec("LightningDiT-debug", **DIT)
    jparams = randomize(jdit.init_dit_params(jax.random.key(0), js), seed, std=0.05)
    jvs = jvmae.vmae_spec("mae_for_ldmae_f8d16_prev", **VAE)
    tvs = tvmae.vmae_spec("mae_for_ldmae_f8d16_prev", **VAE)
    jvparams = randomize(jvmae.init_vmae_params(jax.random.key(1), jvs), seed + 1)
    dit = LightningDiT(ts, device="cpu")
    dit.load_state_dict(permute_qk_for_half_rope(dit_state_dict_from_jax(to_numpy(jparams), ts), ts))
    vae = VMAE(tvs, device="cpu")
    vae.load_state_dict(vmae_state_dict_from_jax(to_numpy(jvparams), tvs))
    jparams = jdit.merge_swiglu(jdit.permute_qk_for_half_rope(jparams, js), js)
    if quant:
        jparams = jdit.quantize_dit_params(jparams, js)
        quantize_dit_(dit)
    rng = np.random.default_rng(seed + 2)
    stats = dict(mean=(0.1 * rng.standard_normal((1, 16, 1, 1))).astype(np.float32),
                 std=(1 + 0.1 * rng.standard_normal((1, 16, 1, 1))).astype(np.float32))
    jbundle = {"dit": jparams, "vae": jvparams, "latent_mean": jnp.asarray(stats["mean"]),
               "latent_std": jnp.asarray(stats["std"])}
    tbundle = {"dit": dit, "vae": vae, "latent_mean": torch.from_numpy(stats["mean"]),
               "latent_std": torch.from_numpy(stats["std"])}
    return (js, jvs, jbundle), (ts, tvs, tbundle)


def _check_chain(quant):
    (js, jvs, jbundle), (ts, tvs, tbundle) = _pipelines(quant=quant)
    z = np.random.default_rng(7).standard_normal((2, 16, 8, 8)).astype(np.float32)
    y = np.array([1, 7])
    jfn = jsampling.make_sample_fn(
        js, jdit.DiTConsts(js), jcreate_transport(), vae_spec=jvs, vae_consts=jvmae.VMAEConsts(jvs),
        compute_dtype=jnp.bfloat16, quant_mode=quant, **CHAIN, **IMPLS)
    tfn = make_sample_fn(ts, create_transport(), compute_dtype=torch.bfloat16, device="cpu",
                         quant_mode=quant, **CHAIN, **IMPLS)
    jimgs = np.asarray(jfn(jbundle, jax.random.key(0), jnp.asarray(y), z=jnp.asarray(z)))
    timgs = tfn(tbundle, torch.from_numpy(y), z=torch.from_numpy(z)).numpy()
    assert timgs.dtype == np.uint8 and timgs.shape == (2, 64, 64, 3)
    assert np.abs(timgs.astype(int) - jimgs.astype(int)).max() <= (4 if quant else 2)
    assert timgs.std() > 1.0  # the DiT and the decoder moved the pixels

    # the latents before decode
    jlat = np.asarray(jfn(dict(jbundle, vae=None), jax.random.key(0), jnp.asarray(y), z=jnp.asarray(z)))
    tlat = tfn(dict(tbundle, vae=None), torch.from_numpy(y), z=torch.from_numpy(z)).numpy()
    assert np.abs(tlat - jlat).max() <= (5e-2 if quant else 2e-2) * np.abs(jlat).max()
    assert np.abs(tlat - (z * tbundle["latent_std"].numpy() + tbundle["latent_mean"].numpy())).max() > 1e-2


def test_sample_chain_matches_jax():
    _check_chain(None)


def test_sample_chain_w8a8_matches_jax():
    """The fused-quant branch of _block (adaln_impl 'fused') in the chain."""
    _check_chain("w8a8")


def test_phase_split_matches_unsplit():
    """Single-batch steps below the interval start change nothing but the
    batch the matmuls see; BLAS blocks by batch size, so float32 sums may
    change order (1e-5 relative), never more."""
    _, (ts, _, tbundle) = _pipelines(seed=3)
    z = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 16, 8, 8)).astype(np.float32))
    y = torch.tensor([2, 9])
    bundle = dict(tbundle, vae=None)
    outs = [
        make_sample_fn(ts, create_transport(), compute_dtype=torch.float32, device="cpu",
                       cfg_phase_split=split, **CHAIN)(bundle, y, z=z)
        for split in (True, False)
    ]
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)


def test_noise_from_generator_is_reproducible():
    _, (ts, _, tbundle) = _pipelines(seed=4)
    fn = make_sample_fn(ts, create_transport(), num_steps=3, cfg_scale=1.0, device="cpu")
    bundle = dict(tbundle, vae=None)
    y = torch.tensor([0, 1])
    a, b, c = (fn(bundle, y, generator=torch.Generator().manual_seed(s)) for s in (5, 5, 6))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)

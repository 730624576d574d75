"""Tensor parallelism of the port (``--tp``, sampling) on the CPU, held
against the JAX package's unsharded functions and the port at tp 1.

* The sharding rules (``parallel.mesh.tp_slice_index``, the JAX
  ``dit_param_spec`` tp rules with w12 gate-aligned): at the 1p0B/1 and
  1p6B/1 shapes, on ``meta`` tensors, no entry above 50 MB stays whole on
  a rank under tp 2 (``tests/test_prod_sharding.py``'s rule), in the fp32
  and the int8 layouts; every rank's slices, gathered
  (``tp_state_gather``), rebuild each weight bit for bit.
* The new pieces' plain versions: #10's two halves (the row's absmax, then
  int8 from the whole row's absmax) on rank slices equal
  ``fused_silu_mul_quant_plain`` on the whole row bit for bit; the fp32
  partials of a row-parallel ``dense`` summed, plus the bias, equal
  ``dense`` (fp32 summation order: 1e-6); the int32 partials summed and
  dequantized equal ``int8_dense_plain`` bit for bit.
* Two gloo ranks (``torch_mp_worker.py tp_forward``): the DiT forward at tp
  2 in fp32, bf16 and w8a8 (the sampling path's impls: flash_rope, fused
  adaLN, fused MLP) against the JAX ``dit_forward`` at tp 1 (the port's
  parity tolerances, max |error| / max |value|: fp32 1e-5, bf16 2e-2, w8a8
  3e-2; the JAX side runs its attention as ``xla`` on the half-split
  layout, the math of #1 without interpret mode's seconds a call, and its
  adaLN and MLP kernels in interpret mode) and against the port at tp 1 (relative L2: fp32 1e-6, the partial
  sums reassociate; bf16 and w8a8 1e-3, since one reassociated fp32 sum can
  move a bf16 rounding of proj's output, though none did at this size: the
  readings are 0); the ranks' outputs bit for bit equal; the control (w12
  sharded contiguously, the gate halves mispaired) misses the bf16 bound;
  a 4-step chain at tp 2 against the JAX ``make_sample_fn`` from the same
  noise (the chain test's latent tolerances).
* The sampling CLI: ``--tp 2`` at world 2 writes world 1's PNG names and
  labels (pixels equal: max |difference| 0, bound 1) and a manifest with tp
  2; ``--tp 2`` at world 1 prints the JAX CLI's warning and writes the
  images of ``--tp 1``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ldmae_tpu.eval import sampling as jsampling
from ldmae_tpu.models import lightningdit as jdit
from ldmae_tpu.train import torch_import
from ldmae_tpu.transport.transport import create_transport as jcreate_transport

from torch_mp_worker import REPO, join, spawn, start, tp_model

from ldmae_tpu_torch.models import LightningDiT, dit_spec, quantize_dit_, seeded_init_
from ldmae_tpu_torch.models import lightningdit as tdit
from ldmae_tpu_torch.ops import fused_adaln as fad
from ldmae_tpu_torch.ops import linear as lin
from ldmae_tpu_torch.ops import quant as qt
from ldmae_tpu_torch.parallel import tp_slice_index, tp_state_gather, tp_state_slice

WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
BIG_LEAF = 50e6  # bytes (tests/test_prod_sharding.py)

# SMALL_DIT of tests/test_torch_port_models.py: 6 heads, SwiGLU hidden
# 1,024, D 384, so each rank's #4 (2H 1,024) and attention (3 heads) run
DIMS = dict(input_size=16, patch_size=1, in_channels=16, num_classes=10, depth=2, hidden_size=384, num_heads=6,
            use_qknorm=True, use_swiglu=True, use_rope=True, use_rmsnorm=True)
IMPLS = dict(attn_impl="flash_rope", rope_layout="half", adaln_impl="fused", mlp_impl="fused")
JAX_IMPLS = dict(IMPLS, attn_impl="xla")
CHAIN = dict(num_steps=4, timestep_shift=0.3, cfg_scale=4.0, cfg_interval_start=0.1)
LEGS = [dict(name="float32", dtype="float32", quant=None),
        dict(name="bfloat16", dtype="bfloat16", quant=None, chain=True),
        dict(name="w8a8", dtype="bfloat16", quant="w8a8", chain=True),
        dict(name="control", dtype="bfloat16", quant=None, control=True)]
JAX_REL = {"float32": 1e-5, "bfloat16": 2e-2, "w8a8": 3e-2}
TP1_REL = {"float32": 1e-6, "bfloat16": 1e-3, "w8a8": 1e-3}


def _max_rel(port, ref):
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["LightningDiT-1p0B/1", "LightningDiT-1p6B/1"])
def test_no_big_entry_stays_whole_on_a_rank(model):
    spec = dit_spec(model, input_size=32, in_channels=16)
    dit = LightningDiT(spec, device="meta")
    for layout in ("fp32", "int8"):
        if layout == "int8":
            quantize_dit_(dit)
        whole_big, full, mine = [], 0, 0
        for key, t in dit.state_dict().items():
            nbytes = t.numel() * t.element_size()
            found = tp_slice_index(key, spec, 2, 0)
            local = nbytes if found is None else nbytes // t.shape[found[0]] * len(found[1])
            full, mine = full + nbytes, mine + local
            if nbytes > BIG_LEAF and local == nbytes:
                whole_big.append((key, nbytes))
        assert not whole_big, (layout, whole_big)
        # the blocks are about all of the weights: a rank holds about half
        assert 0.5 < mine / full < 0.53, (layout, mine / full)


@pytest.mark.parametrize("layout", ["fp32", "int8"])
def test_rank_slices_gather_to_the_full_weights(layout):
    spec = tdit.DiTSpec(**DIMS)
    model = LightningDiT(spec, device="cpu")
    with torch.no_grad():
        for i, p in enumerate(model.parameters()):
            p.copy_(torch.from_numpy(np.random.default_rng(i).standard_normal(p.shape).astype(np.float32)))
    if layout == "int8":
        quantize_dit_(model)
    sd = model.state_dict()
    shards = [tp_state_slice(sd, spec, 2, r) for r in range(2)]
    qkv = shards[0]["blocks.0.attn.qkv." + ("w_q" if layout == "int8" else "weight")]
    assert qkv.shape == (3 * 384 // 2, 384)  # 3 of 6 heads of q, k and v
    assert shards[0]["blocks.0.mlp.w3.bias"].shape == (384,)  # a row split keeps the bias whole
    back = tp_state_gather(shards, spec)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


# ---------------------------------------------------------------------------
# the plain versions of the new kernel pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_silu_mul_halves_equal_the_whole_row(dtype):
    rng = np.random.default_rng(3)
    h = 64
    x12 = torch.from_numpy(rng.standard_normal((2, 5, 4 * h)).astype(np.float32) * 3).to(dtype)
    x1, x2 = x12[..., :2 * h], x12[..., 2 * h:]
    parts = [torch.cat([x1[..., r * h:(r + 1) * h], x2[..., r * h:(r + 1) * h]], -1) for r in range(2)]
    amax = torch.maximum(*[fad.silu_mul_amax(p) for p in parts])
    halves = [fad.silu_mul_quant_scaled(p, amax) for p in parts]
    q, s = fad.fused_silu_mul_quant_plain(x12)
    assert torch.equal(torch.cat([hq for hq, _ in halves], -1), q)
    assert all(torch.equal(hs, s) for _, hs in halves)


def test_row_parallel_partials_sum_to_the_whole_layer():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 7, 64)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((48, 64)).astype(np.float32) * 0.1)
    b = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
    parts = [lin.dense_f32_out(x[..., r * 32:(r + 1) * 32].reshape(-1, 32), w[:, r * 32:(r + 1) * 32].to(torch.bfloat16))
             for r in range(2)]
    got = (parts[0] + parts[1] + b).to(torch.bfloat16).view(3, 7, 48)
    ref = lin.dense(x, w, b)
    assert _max_rel(got.float(), ref.float()) <= 1e-6 or torch.equal(got, ref)
    # int8: the int32 partials are exact, so the dequant is int8_dense's
    xq = torch.from_numpy(rng.integers(-127, 128, (21, 64)).astype(np.int8))
    xs = torch.from_numpy(rng.uniform(1e-3, 1e-2, (21, 1)).astype(np.float32))
    p = qt.QLinear(torch.from_numpy(rng.integers(-127, 128, (48, 64)).astype(np.int8)),
                   torch.from_numpy(rng.uniform(1e-3, 1e-2, 48).astype(np.float32)), b)
    acc = sum(qt.int8_dense_i32(xq[:, r * 32:(r + 1) * 32].contiguous(), p.w_q[:, r * 32:(r + 1) * 32].contiguous())
              for r in range(2))
    assert acc.dtype == torch.int32
    assert torch.equal(qt._dequant(acc, xs, p, torch.bfloat16), qt.int8_dense_plain(xq, xs, p, torch.bfloat16))


# ---------------------------------------------------------------------------
# two ranks: the DiT forward and the chain
# ---------------------------------------------------------------------------


def _jax_params(js, params, quant):
    jp = jdit.merge_swiglu(jdit.permute_qk_for_half_rope(params, js), js)
    return jdit.quantize_dit_params(jp, js) if quant else jp


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    """Every leg's output on both ranks at tp 2 (one spawn for all legs) and
    the JAX references at tp 1, computed while the ranks run."""
    d = tmp_path_factory.mktemp("tp")
    js = jdit.dit_spec("LightningDiT-B/1", **{k: v for k, v in DIMS.items() if k != "patch_size"})
    sd = seeded_init_(LightningDiT(tdit.DiTSpec(**DIMS), device="cpu"), 0).state_dict()
    rng = np.random.default_rng(1)
    inp = dict(dims=DIMS, sd=sd, impls=IMPLS, chain=CHAIN, legs=LEGS,
               x=torch.from_numpy(rng.standard_normal((2, 16, 16, 16)).astype(np.float32)),
               t=torch.tensor([0.3, 0.71]), y=torch.tensor([3, 10]),
               z=torch.from_numpy(rng.standard_normal((2, 16, 16, 16)).astype(np.float32)),
               y_chain=torch.tensor([1, 7]))
    torch.save(inp, d / "inputs.pt")
    procs = start([[WORKER, "tp_forward", str(d)]] * 2)
    params = torch_import.import_dit_state_dict({k: v.numpy() for k, v in sd.items()}, js)
    refs = {}
    for leg in LEGS[:3]:
        jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[leg["dtype"]]
        jp = _jax_params(js, params, leg["quant"])
        refs[leg["name"]] = np.asarray(jdit.dit_forward(
            jp, js, jdit.DiTConsts(js), jnp.asarray(inp["x"].numpy()), jnp.asarray(inp["t"].numpy()).astype(jd),
            jnp.asarray(inp["y"].numpy()), compute_dtype=jd, quant_mode=leg["quant"], **JAX_IMPLS))
        if leg.get("chain"):
            fn = jsampling.make_sample_fn(js, jdit.DiTConsts(js), jcreate_transport(), compute_dtype=jnp.bfloat16,
                                          quant_mode=leg["quant"], **CHAIN, **JAX_IMPLS)
            bundle = {"dit": jp, "vae": None, "latent_mean": None, "latent_std": None}
            refs[leg["name"] + "_chain"] = np.asarray(fn(bundle, jax.random.key(0), jnp.asarray(inp["y_chain"].numpy()),
                                                         z=jnp.asarray(inp["z"].numpy())))
    join(procs)
    ranks = [torch.load(d / f"rank{r}.pt") for r in range(2)]
    return inp, ranks, refs


def _port_tp1(inp, leg):
    model = tp_model(inp, dict(leg, control=False), None)
    dt = getattr(torch, leg["dtype"])
    with torch.no_grad():
        return model(inp["x"], inp["t"].to(dt), inp["y"], compute_dtype=dt, quant_mode=leg["quant"], **IMPLS)


@pytest.mark.parametrize("leg", LEGS[:3], ids=[leg["name"] for leg in LEGS[:3]])
def test_tp2_dit_forward_matches_jax_and_tp1(tp_run, leg):
    inp, ranks, refs = tp_run
    out, ref = ranks[0][leg["name"]], refs[leg["name"]]
    assert torch.equal(out, ranks[1][leg["name"]])  # every rank ends with the same output
    assert np.abs(ref).max() > 1e-3  # the gates are non-zero
    assert _max_rel(out.numpy(), ref) < JAX_REL[leg["name"]]
    assert _rel_l2(out.numpy(), _port_tp1(inp, leg).numpy()) <= TP1_REL[leg["name"]]


def test_tp2_control_with_w12_not_gate_aligned_misses_the_bound(tp_run):
    inp, ranks, _ = tp_run
    ref = _port_tp1(inp, LEGS[1])
    assert _rel_l2(ranks[0]["control"].numpy(), ref.numpy()) > 2 * TP1_REL["bfloat16"]


@pytest.mark.parametrize("leg", LEGS[1:3], ids=[leg["name"] for leg in LEGS[1:3]])
def test_tp2_chain_matches_jax_make_sample_fn(tp_run, leg):
    """4 Euler steps, shift 0.3, CFG 4 on [0.1, 1] (phased), no decode, from
    the same z; the chain test's bound on the latents (2e-2 bf16, 5e-2 w8a8
    of their largest |value|)."""
    inp, ranks, refs = tp_run
    out, ref = ranks[0][leg["name"] + "_chain"].numpy(), refs[leg["name"] + "_chain"]
    assert np.array_equal(out, ranks[1][leg["name"] + "_chain"].numpy())
    assert np.abs(out - ref).max() <= (5e-2 if leg["quant"] else 2e-2) * np.abs(ref).max()
    assert np.abs(out - inp["z"].numpy()).max() > 1e-2  # the DiT moved the latents


# ---------------------------------------------------------------------------
# the sampling CLI
# ---------------------------------------------------------------------------


def _cli_config(tmp_path, name):
    from ldmae_tpu_torch.core.config import LDMAEConfig

    path = tmp_path / f"{name}.yaml"
    LDMAEConfig.from_dict({
        "data": {"image_size": 32, "num_classes": 1000, "data_path": str(tmp_path / "none")},
        "vae": {"model_name": "vmae_f8d16", "weight_path": ""},
        "model": {"model_type": "LightningDiT-debug", "in_chans": 16},
        "train": {"exp_name": name, "output_dir": str(tmp_path)},
        "sample": {"num_sampling_steps": 3, "cfg_scale": 4.0, "per_proc_batch_size": 2, "fid_num": 5},
    }).to_yaml(str(path))
    return str(path)


def _pngs(folder):
    from PIL import Image

    return {f: np.asarray(Image.open(os.path.join(folder, f)), np.int16)
            for f in sorted(os.listdir(folder)) if f.endswith(".png")}


def test_sampling_cli_tp2_at_world2_writes_world1s_images(tmp_path, capsys):
    from ldmae_tpu_torch.cli import inference

    spawn([[WORKER, "cli", "inference", "--config", _cli_config(tmp_path, "tp2"), "--device", "cpu", "--tp", "2",
            "--skip_fid"]] * 2)
    one = inference.main(["--config", _cli_config(tmp_path, "one"), "--device", "cpu", "--skip_fid"])
    two = one.replace(os.sep + "one" + os.sep, os.sep + "tp2" + os.sep)
    a, b = _pngs(one), _pngs(two)
    assert list(a) == list(b) == [f"{i:06d}.png" for i in range(5)]
    assert max(int(np.abs(a[f] - b[f]).max()) for f in a) <= 1
    with open(os.path.join(two, "resume_manifest.json")) as f:
        assert json.load(f) == {"per_proc_batch_size": 2, "world": 2, "tp": 2, "global_seed": 0, "num_classes": 1000}

    # world 1: the JAX CLI's warning, and --tp 1's images
    again = inference.main(["--config", _cli_config(tmp_path, "warn"), "--device", "cpu", "--skip_fid", "--tp", "2"])
    assert "WARNING: --tp 2 ignored (n_local=1, per_proc_batch_size=2 not divisible)" in capsys.readouterr().out
    c = _pngs(again)
    assert list(c) == list(a) and all(np.array_equal(a[f], c[f]) for f in a)

"""Weight bridge from ``ldmae_tpu`` parameter pytrees to the port's state dicts.

The port's own copy of the mapping in ``ldmae_tpu/train/torch_export.py``:
JAX keeps linears as (in, out), stacks blocks on a leading depth axis and
packs qkv as (D, 3, D) and adaLN as (D, na, D); the reference state dicts
(and the port's modules) use ``nn.Linear`` (out, in) per block. Inputs are
numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``), so this module
needs no JAX. The result is in the canonical interleaved RoPE layout; apply
``models.permute_qk_for_half_rope`` for ``rope_layout="half"``.

``dit_state_dict_from_jax`` also takes a tree from ``quantize_dit_params``
(int8 ``w_q`` (L, in, out) and ``w_scale`` (L, out) in place of ``w``; it
is made after the half-RoPE permutation, so its state dict is already in the
half layout). Its quantized linears become ``QLinear`` entries (``w_q``
(out, in) int8, ``w_scale``, ``bias``), which load into a model after
``models.quantize_dit_``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .models.lightningdit import DiTSpec
from .models.conv_vae import ConvVAESpec
from .models.lpips import VGG_SLICES
from .models.vmae import VMAESpec
from .ops.rope import build_rope_table
from .ops.sincos import get_2d_sincos_pos_embed

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C", copy=True))


def _block_linear(sd: StateDict, name: str, node, i: int, n_in: int, n_out: int) -> None:
    """Block i of a stacked JAX linear {"w": (L, in, ...)} or its quantized
    form {"w_q", "w_scale"}, plus "b", as nn.Linear or QLinear entries."""
    if "w_q" in node:
        w_q = np.asarray(node["w_q"][i]).reshape(n_in, n_out).T
        sd[f"{name}.w_q"] = torch.from_numpy(np.ascontiguousarray(w_q, dtype=np.int8))
        sd[f"{name}.w_scale"] = _t(np.asarray(node["w_scale"][i]).reshape(n_out))
    else:
        sd[f"{name}.weight"] = _t(np.asarray(node["w"][i]).reshape(n_in, n_out).T)
    if node.get("b") is not None:
        sd[f"{name}.bias"] = _t(np.asarray(node["b"][i]).reshape(n_out))


def _conv_from_linear(w, p: int, c: int) -> torch.Tensor:
    """(p*p*C, D) patch-embed matmul weight -> Conv2d weight (D, C, p, p)."""
    w = np.asarray(w)
    return _t(w.reshape(p, p, c, w.shape[-1]).transpose(3, 2, 0, 1))


def dit_state_dict_from_jax(params: Any, spec: DiTSpec) -> StateDict:
    d, na, p = spec.hidden_size, spec.num_adaln, spec.patch_size
    sd: StateDict = {}
    sd["x_embedder.proj.weight"] = _conv_from_linear(params["x_embedder"]["w"], p, spec.in_channels)
    sd["x_embedder.proj.bias"] = _t(params["x_embedder"]["b"])
    te = params["t_embedder"]
    sd["t_embedder.mlp.0.weight"] = _t(np.asarray(te["fc1"]["w"]).T)
    sd["t_embedder.mlp.0.bias"] = _t(te["fc1"]["b"])
    sd["t_embedder.mlp.2.weight"] = _t(np.asarray(te["fc2"]["w"]).T)
    sd["t_embedder.mlp.2.bias"] = _t(te["fc2"]["b"])
    sd["y_embedder.embedding_table.weight"] = _t(params["y_embedder"]["table"])

    grid = spec.input_size // p
    sd["pos_embed"] = _t(get_2d_sincos_pos_embed(d, grid)[None])
    if spec.use_rope:
        cos, sin = build_rope_table(spec.head_dim // 2, grid)
        sd["feat_rope.freqs_cos"] = _t(cos)
        sd["feat_rope.freqs_sin"] = _t(sin)

    b = params["blocks"]
    for i in range(spec.depth):
        pre = f"blocks.{i}"
        a = b["attn"]
        _block_linear(sd, f"{pre}.attn.qkv", a["qkv"], i, d, 3 * d)
        sd[f"{pre}.attn.proj.weight"] = _t(np.asarray(a["proj"]["w"][i]).T)
        sd[f"{pre}.attn.proj.bias"] = _t(a["proj"]["b"][i])
        if spec.use_qknorm:
            for nk in ("q_norm", "k_norm"):
                sd[f"{pre}.attn.{nk}.weight"] = _t(a[nk]["scale"][i])
                if "bias" in a[nk]:
                    sd[f"{pre}.attn.{nk}.bias"] = _t(a[nk]["bias"][i])
        m = b["mlp"]
        if spec.use_swiglu:
            h = spec.swiglu_hidden
            if "w12" in m:  # merged layout (merge_swiglu)
                _block_linear(sd, f"{pre}.mlp.w12", m["w12"], i, d, 2 * h)
            else:  # per-output-channel scales concatenate like the weights
                halves = [{}, {}]
                for half, node in zip(halves, (m["w1"], m["w2"])):
                    _block_linear(half, "w12", node, i, d, h)
                for key in halves[0]:
                    sd[f"{pre}.mlp.{key}"] = torch.cat([halves[0][key], halves[1][key]])
            _block_linear(sd, f"{pre}.mlp.w3", m["w3"], i, h, d)
        else:
            _block_linear(sd, f"{pre}.mlp.fc1", m["fc1"], i, d, spec.mlp_hidden)
            _block_linear(sd, f"{pre}.mlp.fc2", m["fc2"], i, spec.mlp_hidden, d)
        _block_linear(sd, f"{pre}.adaLN_modulation.1", b["adaln"], i, d, na * d)
        if spec.use_rmsnorm:
            sd[f"{pre}.norm1.weight"] = _t(b["norm1"]["scale"][i])
            sd[f"{pre}.norm2.weight"] = _t(b["norm2"]["scale"][i])

    fl = params["final_layer"]
    sd["final_layer.adaLN_modulation.1.weight"] = _t(np.asarray(fl["adaln"]["w"]).reshape(d, 2 * d).T)
    sd["final_layer.adaLN_modulation.1.bias"] = _t(np.asarray(fl["adaln"]["b"]).reshape(2 * d))
    sd["final_layer.linear.weight"] = _t(np.asarray(fl["linear"]["w"]).T)
    sd["final_layer.linear.bias"] = _t(fl["linear"]["b"])
    if spec.use_rmsnorm:
        sd["final_layer.norm_final.weight"] = _t(fl["norm"]["scale"])
    return sd


def vmae_state_dict_from_jax(params: Any, spec: VMAESpec) -> StateDict:
    d, dd, p = spec.embed_dim, spec.decoder_embed_dim, spec.patch_size
    sd: StateDict = {}
    sd["patch_embed.proj.weight"] = _conv_from_linear(params["patch_embed"]["w"], p, spec.in_chans)
    sd["patch_embed.proj.bias"] = _t(params["patch_embed"]["b"])
    for key, dim in (("pos_embed", d), ("decoder_pos_embed", dd)):
        sd[key] = _t(get_2d_sincos_pos_embed(
            dim, spec.grid, cls_token=not spec.no_cls, extra_tokens=spec.num_extra_tokens
        )[None])

    def lin(name, node):
        sd[f"{name}.weight"] = _t(np.asarray(node["w"]).T)
        if "b" in node:
            sd[f"{name}.bias"] = _t(node["b"])

    def blocks(prefix, node, depth, dim):
        for i in range(depth):
            pre = f"{prefix}.{i}"
            for nm in ("norm1", "norm2"):
                sd[f"{pre}.{nm}.weight"] = _t(node[nm]["scale"][i])
                sd[f"{pre}.{nm}.bias"] = _t(node[nm]["bias"][i])
            sd[f"{pre}.attn.qkv.weight"] = _t(np.asarray(node["attn"]["qkv"]["w"][i]).reshape(dim, 3 * dim).T)
            sd[f"{pre}.attn.qkv.bias"] = _t(np.asarray(node["attn"]["qkv"]["b"][i]).reshape(3 * dim))
            sd[f"{pre}.attn.proj.weight"] = _t(np.asarray(node["attn"]["proj"]["w"][i]).T)
            sd[f"{pre}.attn.proj.bias"] = _t(node["attn"]["proj"]["b"][i])
            for fc in ("fc1", "fc2"):
                sd[f"{pre}.mlp.{fc}.weight"] = _t(np.asarray(node["mlp"][fc]["w"][i]).T)
                sd[f"{pre}.mlp.{fc}.bias"] = _t(node["mlp"][fc]["b"][i])

    blocks("blocks", params["blocks"], spec.depth, d)
    sd["norm.weight"] = _t(params["norm"]["scale"])
    sd["norm.bias"] = _t(params["norm"]["bias"])
    blocks("decoder_blocks", params["decoder_blocks"], spec.decoder_depth, dd)
    sd["decoder_norm.weight"] = _t(params["decoder_norm"]["scale"])
    sd["decoder_norm.bias"] = _t(params["decoder_norm"]["bias"])
    lin("decoder_embed", params["decoder_embed"])
    if spec.down_nonlinear:
        for side in ("to_latent", "from_latent"):
            lin(f"{side}.layers.0", params[side]["fc1"])
            lin(f"{side}.layers.2", params[side]["fc2"])
    else:
        lin("to_latent", params["to_latent"])
        lin("from_latent", params["from_latent"])
    if "cls_token" in params:
        sd["cls_token"] = _t(np.asarray(params["cls_token"]).reshape(1, 1, -1))
    if "mask_token" in params:
        sd["mask_token"] = _t(np.asarray(params["mask_token"]).reshape(1, 1, -1))
    dp = params["decoder_pred"]
    if spec.smooth_output:
        if not spec.pred_with_conv:
            lin("decoder_pred.linear_pred", dp["linear_pred"])
        sd["decoder_pred.conv_smoother.weight"] = _t(dp["conv_smoother"]["w"])
        sd["decoder_pred.conv_smoother.bias"] = _t(dp["conv_smoother"]["b"])
    else:
        lin("decoder_pred", dp)
    return sd


def _stack(trees: list) -> Any:
    """A list of nested dicts of arrays -> one nested dict of arrays stacked
    on a new leading axis (the JAX package's stacked block layout)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([np.asarray(t) for t in trees])


def vmae_gradual_state_dict_from_jax(params: Any, spec: VMAESpec, down_after: int, up_after: int) -> StateDict:
    """A ``vmae_variants.init_gradual_params`` tree (block lists, the token
    convolutions ``encoder_downsample`` / ``decoder_upsample``) -> the
    ``GradualVMAE`` state dict, the reference's gradual layout: the
    convolution at ``blocks.{down_after}.conv`` and
    ``decoder_blocks.{up_after}.conv``, the later blocks one index up; the
    decoder's positional table on grid // 2."""
    tree = dict(params, blocks=_stack(params["blocks"]), decoder_blocks=_stack(params["decoder_blocks"]))
    flat = vmae_state_dict_from_jax(tree, spec)
    sd: StateDict = {}
    for key, v in flat.items():
        head, _, rest = key.partition(".")
        at = {"blocks": down_after, "decoder_blocks": up_after}.get(head)
        if at is not None:
            i, _, rest = rest.partition(".")
            key = f"{head}.{int(i) + (int(i) >= at)}.{rest}"
        sd[key] = v
    for head, at, node in (("blocks", down_after, params["encoder_downsample"]),
                           ("decoder_blocks", up_after, params["decoder_upsample"])):
        sd[f"{head}.{at}.conv.weight"] = _t(node["w"])
        sd[f"{head}.{at}.conv.bias"] = _t(node["b"])
    sd["decoder_pos_embed"] = _t(get_2d_sincos_pos_embed(spec.decoder_embed_dim, spec.grid // 2)[None])
    sd["pos_embed"] = _t(get_2d_sincos_pos_embed(spec.embed_dim, spec.grid)[None])
    return sd


def conv_vae_state_dict_from_jax(params: Any, spec: ConvVAESpec) -> StateDict:
    """The JAX package's conv VAE parameters -> ``ConvVAE``'s (the reference
    LDM) state dict: the tree's names are the LDM names, convolutions' {w,
    b} become weight / bias and group norms' {scale, bias} weight / bias.
    Raises if the keys are not those of ``ConvVAE(spec)``."""
    from .models.conv_vae import ConvVAE

    sd: StateDict = {}

    def walk(prefix, node):
        if "w" in node or "scale" in node:
            sd[f"{prefix}.weight"] = _t(node["w"] if "w" in node else node["scale"])
            sd[f"{prefix}.bias"] = _t(node["b"] if "w" in node else node["bias"])
            return
        for name, child in node.items():
            path = f"{prefix}.{name}" if prefix else name
            if isinstance(child, (list, tuple)):
                for i, item in enumerate(child):
                    walk(f"{path}.{i}", item)
            else:
                walk(path, child)

    walk("", params)
    want = set(ConvVAE(spec, device="meta").state_dict())
    if set(sd) != want:
        raise KeyError(f"conv VAE keys differ: missing {sorted(want - set(sd))[:5]}, "
                       f"unexpected {sorted(set(sd) - want)[:5]}")
    return sd


def inception_state_dict_from_jax(params: Any) -> StateDict:
    """The JAX package's folded InceptionV3 parameters ({conv: {w, scale,
    shift}}, nested by Mixed block) -> ``models.inception.InceptionV3``'s
    state dict."""
    sd: StateDict = {}

    def walk(prefix, node):
        if "w" in node:
            sd[f"{prefix}.weight"], sd[f"{prefix}.scale"], sd[f"{prefix}.shift"] = (
                _t(node["w"]), _t(node["scale"]), _t(node["shift"]))
            return
        for name, child in node.items():
            walk(f"{prefix}.{name}" if prefix else name, child)

    walk("", params)
    return sd


def lpips_state_dict_from_jax(params: Any) -> StateDict:
    """The JAX package's LPIPS parameters ({"vgg": {"s{slice}_{conv}": {w,
    b}}, "lins": [(1, C, 1, 1)]}) -> ``models.lpips.LPIPS``'s state dict."""
    sd: StateDict = {}
    for si, convs in enumerate(VGG_SLICES):
        for li, (idx, _, _) in enumerate(convs):
            p = params["vgg"][f"s{si}_{li}"]
            sd[f"net.slice{si + 1}.{idx}.weight"] = _t(p["w"])
            sd[f"net.slice{si + 1}.{idx}.bias"] = _t(p["b"])
    for k, w in enumerate(params["lins"]):
        sd[f"lin{k}.model.1.weight"] = _t(w)
    return sd

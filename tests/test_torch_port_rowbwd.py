"""#3's backward kernel on the CPU: its routing and a numpy model of its sums.

* On ``meta`` tensors, with the ``fused_norm_modulate`` library's C entries
  replaced by recorders: the autograd Function's backward calls the kernel's
  C entry (``ldmae_fused_norm_modulate_bwd``, after its grid query) at every
  width of the DiT registry, bf16 and fp32, rms with and without a weight
  and layer, counted as a launch, and never the plain version
  (``fused_norm_modulate_bwd``); the kernel's wrapper raises for a width it
  does not take. The kernel itself is in ``test_torch_port_gpu.py``.
* A numpy model of the kernel's two-stage column sums (``rows::bwd`` in
  ``csrc/norm_rows.cuh``): each block's contiguous row range, four warps
  taking its rows in turn, one partial per (block, batch element) at slot
  block + b, the zeros of a slot no pair takes, then the sums over the
  blocks that meet b (a compensated sum in block order) and dw's over every
  slot (32 strided compensated sums added in order); all in fp32. dw, dshift and dscale within 1e-5 of
  ``jax.vjp`` of ``ldmae_tpu.ops.fused_adaln.fused_norm_modulate``, the
  tolerance of ``test_torch_port_train.py``'s backward test, at row counts
  that the grid does not divide, one grid with a block that meets three
  batch elements. The model's rule for which blocks meet a batch element is
  held against a brute-force count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldmae_tpu.ops.fused_adaln import fused_norm_modulate as jfused_norm_modulate

from ldmae_tpu_torch import kernels
from ldmae_tpu_torch.ops import fused_adaln as tfad

# the DiT registry's widths: B, L, XL, 1p0B, 1p6B
WIDTHS = [768, 1024, 1152, 1536, 1792]
WARPS, DW_GROUPS = 4, 32  # rows::kWarps, rows::kDwGroups


class _Recorder:
    """Stands for the ``fused_norm_modulate`` library: the grid query returns
    ``grid``, every other C entry records its arguments and returns success."""

    def __init__(self, grid: int):
        self.grid, self.calls = grid, []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return self.grid if name.endswith("_grid") else 0
        return entry


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder(grid=7)
    monkeypatch.setattr(kernels, "load", lambda name: lib)
    monkeypatch.setattr(kernels, "on_device", lambda x, entry, *args: entry(*args, None))
    monkeypatch.setattr(tfad, "fused_norm_modulate_bwd",
                        lambda *a, **k: pytest.fail("the plain backward ran on a device tensor"))
    tfad._bwd_grid.cache_clear()  # the grid query is cached by shape
    yield lib
    tfad._bwd_grid.cache_clear()


@pytest.mark.parametrize("case", ["rms", "rms_no_weight", "layer"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", WIDTHS)
def test_function_backward_calls_the_kernel_entry(recorder, d, dtype, case):
    b, n = 2, 256
    kind = "layer" if case == "layer" else "rms"
    x = torch.empty(b, n, d, device="meta", dtype=dtype, requires_grad=True)
    w = None if case == "rms_no_weight" else torch.empty(d, device="meta", requires_grad=True)
    ada = torch.empty(b, 6, d, device="meta", dtype=dtype, requires_grad=True)
    before = tfad.fused_norm_modulate_bwd_kernel.launches
    out = tfad.fused_norm_modulate(x, w, ada[:, 0], ada[:, 1], kind=kind)
    leaves = (x, ada) if w is None else (x, w, ada)
    grads = torch.autograd.grad(out, leaves, torch.empty_like(out))
    assert tfad.fused_norm_modulate_bwd_kernel.launches == before + 1
    assert [shape.shape for shape in grads] == [t.shape for t in leaves]
    assert grads[0].dtype == dtype and grads[-1].dtype == dtype
    names = [name for name, _ in recorder.calls]
    assert names == ["ldmae_fused_norm_modulate", "ldmae_fused_norm_modulate_bwd_grid",
                     "ldmae_fused_norm_modulate_bwd"]
    fp32 = int(dtype == torch.float32)
    assert recorder.calls[1][1][:4] == (b, n, d, fp32)
    args = recorder.calls[2][1]
    # (..., ws_slots, b, n, d, layer, eps, fp32, sums_bf16): the workspace holds grid + b slots
    assert args[10:18] == (7 + b, b, n, d, int(kind == "layer"), 1e-6, fp32, fp32 ^ 1)
    assert (args[2] is None) == (kind == "layer" or w is None)  # the weight the kernel reads
    assert (args[6] is None) == (kind == "layer" or w is None)  # dw, written only with one


@pytest.mark.parametrize("d,dtype", [(2056, torch.bfloat16), (772, torch.bfloat16), (2052, torch.float32),
                                     (770, torch.float32)])
def test_backward_kernel_raises_for_what_it_does_not_take(recorder, d, dtype):
    """D past the row engine's 2,048, or off its 16-byte vector (8 bf16, 4
    fp32 elements): a ValueError before any launch."""
    x = torch.empty(2, 16, d, device="meta", dtype=dtype)
    ada = torch.empty(2, 6, d, device="meta", dtype=dtype)
    with pytest.raises(ValueError):
        tfad.fused_norm_modulate_bwd_kernel(x, None, ada[:, 0], ada[:, 1], torch.empty_like(x))
    assert recorder.calls == []


# -- the two-stage column sums ------------------------------------------------


def _blocks_of(b, n, rows, grid):
    """The first and last block whose row range meets batch element b
    (``rows::blocks_of``)."""
    lo = ((b * n + 1) * grid + rows - 1) // rows - 1
    hi = ((b + 1) * n * grid + rows - 1) // rows - 1
    return max(lo, 0), min(hi, grid - 1)


@pytest.mark.parametrize("bsz,n,grid", [(7, 3, 3), (7, 3, 4), (5, 13, 6), (3, 64, 5), (2, 100, 48), (9, 1, 4)])
def test_blocks_of_meets_the_brute_force_count(bsz, n, grid):
    rows = bsz * n
    for b in range(bsz):
        meets = [i for i in range(grid)
                 if rows * i // grid < (b + 1) * n and rows * (i + 1) // grid > b * n]
        assert _blocks_of(b, n, rows, grid) == (meets[0], meets[-1])


def _kahan(values):
    s = k = np.float32(0)
    for v in values:
        y = np.float32(v - k)
        t = np.float32(s + y)
        k = np.float32(np.float32(t - s) - y)
        s = t
    return np.float32(s - k)


def _model_column_sums(x, w, scale, g, grid, kind, eps=1e-6):
    """dw, dshift, dscale as the kernel sums them, in fp32 (see the module
    note)."""
    f32 = np.float32
    bsz, n, d = x.shape
    rows = bsz * n
    xr, gr = x.reshape(rows, d).astype(f32), g.reshape(rows, d).astype(f32)
    # each row's terms (the order inside a row does not reach the sums)
    if kind == "layer":
        xc = xr - xr.mean(-1, keepdims=True, dtype=f32)
        r = (f32(1) / np.sqrt((xc * xc).mean(-1, keepdims=True, dtype=f32) + f32(eps))).astype(f32)
        xhat = (xc * r).astype(f32)
        tdw = np.zeros_like(xr)
    else:
        r = (f32(1) / np.sqrt((xr * xr).mean(-1, keepdims=True, dtype=f32) + f32(eps))).astype(f32)
        u = (xr * r).astype(f32)
        xhat = (u * w.astype(f32)).astype(f32)
        op = (f32(1) + scale.astype(f32))[np.arange(rows) // n]
        tdw = ((gr * op).astype(f32) * u).astype(f32)
    terms = np.stack([tdw, gr, (gr * xhat).astype(f32)], axis=1)  # (rows, 3, d)
    slots = np.zeros((grid + bsz, 3, d), f32)
    for i in range(grid):
        r0, r1 = rows * i // grid, rows * (i + 1) // grid
        s0 = r0
        while s0 < r1:
            b = s0 // n
            s1 = min(r1, (b + 1) * n)
            warp_sums = np.zeros((WARPS, 3, d), f32)
            for row in range(s0, s1):  # warp w takes rows s0 + w, s0 + w + 4, ...
                warp_sums[(row - s0) % WARPS] += terms[row]
            part = warp_sums[0]
            for k in range(1, WARPS):
                part = (part + warp_sums[k]).astype(f32)
            slots[i + b] = part
            s0 = s1
    dshift, dscale = np.zeros((bsz, d), f32), np.zeros((bsz, d), f32)
    dw = np.zeros(d, f32)
    for c in range(d):
        for b in range(bsz):
            lo, hi = _blocks_of(b, n, rows, grid)
            idx = np.arange(lo, hi + 1) + b
            dshift[b, c] = _kahan(slots[idx, 1, c])
            dscale[b, c] = _kahan(slots[idx, 2, c])
        groups = [_kahan(slots[y:grid + bsz - 1:DW_GROUPS, 0, c]) for y in range(DW_GROUPS)]
        total = groups[0]
        for v in groups[1:]:
            total = np.float32(total + v)
        dw[c] = total
    return dw, dshift, dscale


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("kind", ["rms", "layer"])
@pytest.mark.parametrize("bsz,n,grid", [(7, 3, 3), (5, 13, 6), (3, 64, 5), (2, 100, 48)])
def test_model_column_sums_match_jax_vjp(bsz, n, grid, kind):
    """Grid (7, 3, 3): block 0 takes rows 0-6 of batch elements 0, 1 and 2;
    the others' row counts do not divide by their grids (65 rows over 6
    blocks, 192 over 5, 200 over 48)."""
    d = 16
    rng = np.random.default_rng(bsz * 1000 + n * 10 + grid)
    x = rng.standard_normal((bsz, n, d)).astype(np.float32) * 2
    w = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    sh, sc = (rng.standard_normal((bsz, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((bsz, n, d)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w, sh, sc: jfused_norm_modulate(x, w, sh, sc, kind=kind), x, w, sh, sc)
    _, jdw, jdsh, jdsc = vjp(jnp.asarray(g))
    dw, dshift, dscale = _model_column_sums(x, w, sc, g, grid, kind)
    assert _rel_max(dshift, jdsh) < 1e-5 and _rel_max(dscale, jdsc) < 1e-5
    if kind == "rms":
        assert _rel_max(dw, jdw) < 1e-5
    else:
        assert not np.asarray(jdw).any()

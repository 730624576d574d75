"""#9 ``fused_norm_modulate_quant``'s int8 step, as the CUDA kernel computes
it (``csrc/fused_quant.cu``, ``ModulateQuant::finish``), modelled in numpy float32
and held bit for bit to the true quotient's rounding on the CPU.

The kernel takes r = 1 / qs once per row and rounds t = o * r half to even
by adding 1.5 * 2^23; a lane (the elements c with (c // kE) % 32 equal: kE
= 8 for bf16 x, 4 for fp32) that holds an element with t within 2^-14 of a
half-integer, and every lane of a row whose qs or r is not a normal number,
redoes its elements with the true quotient. The model below repeats those
steps in float32 (numpy rounds each operation once, as the kernel's
``__f*_rn`` intrinsics do). The tests hold its int8 output equal to
``rint(o / qs)`` (numpy's correctly rounded float32 division, half to even)
on quotients within 1-4 ulps of k + 0.5, on |o| = absmax (q = +-127), at
qs's 1e-8 floor, at tiny and subnormal qs, on hypothesis-drawn rows, and to
the port's plain version and the JAX package's ``fused_norm_modulate_quant``
(Pallas, interpret mode) on seeded and adversarial rows: x = 0 makes the
normalised row 0, so o = shift exactly on every side and no row sum enters.
Tolerance: none, bit-identical int8 values and row scales; only XLA's row
scales may sit one ulp off (it multiplies by 1 / 127 for the division), and
the rule then runs on those scales.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

try:  # a test-only dependency: without it only the hypothesis test skips
    from hypothesis import given, settings
    from hypothesis import strategies as st
    from hypothesis.extra import numpy as hnp
except ImportError:
    given = None

from ldmae_tpu.ops import fused_adaln as jfad

from ldmae_tpu_torch.ops import fused_adaln as tfad

F32 = np.float32
MAGIC = F32(12582912.0)  # 1.5 * 2^23
NEAR_HALF = F32(0.5) - F32(2.0**-14)


def row_scale(o):
    """The kernel's qs = max(absmax / 127, 1e-8) per row (last axis)."""
    return np.maximum(np.abs(o).max(-1, keepdims=True) / F32(127), F32(1e-8)).astype(F32)


def true_int8(o, qs):
    """rint(o / qs) (true float32 division, half to even) as int8, as the
    kernel converts it (NaN to 0)."""
    with np.errstate(all="ignore"):
        q = np.rint(o.astype(F32) / qs.astype(F32))
    q = np.where(np.isnan(q), 0, np.clip(q, -(2.0**31), 2.0**31 - 1))
    return (q.astype(np.int64) & 0xFF).astype(np.uint8).view(np.int8)


def model_int8(o, qs, ke=8):
    """The kernel's rule on rows o (..., D) with per-row qs (..., 1).
    Returns (int8, share of elements that took the reciprocal's path)."""
    o, qs = o.astype(F32), np.broadcast_to(qs.astype(F32), o.shape[:-1] + (1,))
    with np.errstate(all="ignore"):
        r = F32(1) / qs
        t = o * r
        y = t + MAGIC
        f = t - (y - MAGIC)
    fast_bytes = (y.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
    normal = (qs >= F32(2.0**-126)) & (r >= F32(2.0**-126)) & (r < F32(2.0**127))
    near = ~(np.abs(f) < NEAR_HALF)  # NaN counts as near
    d = o.shape[-1]
    lane = (np.arange(d) // ke) % 32
    redo = np.zeros(o.shape[:-1] + (32,), bool)
    for ln in range(32):
        redo[..., ln] = near[..., lane == ln].any(-1)
    redo = redo[..., lane] | ~normal
    return np.where(redo, true_int8(o, qs), fast_bytes), float((~redo).mean())


def _ulp_steps(v, steps):
    """v moved by `steps` float32 ulps (negative: towards -inf)."""
    v = v.astype(F32)
    to = F32(np.inf) if steps > 0 else F32(-np.inf)
    for _ in range(abs(steps)):
        v = np.nextafter(v, to).astype(F32)
    return v


def _near_half_rows(absmax, rng):
    """A row of absmax A whose other elements have quotients by the row's
    qs (= max(A / 127, 1e-8)) within 0-4 ulps of k + 0.5, for every k
    with |o| <= A: +A and -A first, the rest shuffled."""
    absmax = F32(absmax)
    qs = row_scale(np.array([absmax], F32))[0]
    k = np.arange(-127, 127, dtype=F32) + F32(0.5)
    o = np.concatenate([_ulp_steps(k * qs, s) for s in range(-4, 5)])
    o = o[np.abs(o) <= absmax]
    return np.concatenate([[absmax, -absmax], rng.permutation(o)]).astype(F32)


def _assert_exact(o, qs, ke):
    got, fast = model_int8(o, qs, ke)
    np.testing.assert_array_equal(got, true_int8(o, qs))
    return fast


@pytest.mark.parametrize("ke", [8, 4])
@pytest.mark.parametrize("family", ["unit", "wide", "floor"])
def test_reciprocal_rule_near_half_integers(family, ke):
    """Quotients within 1-4 ulps of k + 0.5, and +-absmax (q = +-127): the
    bare reciprocal rounds some of them the other way (checked), the rule
    none."""
    rng = np.random.default_rng({"unit": 0, "wide": 1, "floor": 2}[family])
    if family == "unit":  # activations of magnitude ~1-10
        absmax = F32(10.0) ** rng.uniform(-1, 1, 16).astype(F32)
    elif family == "wide":  # tiny (above the floor) to huge rows
        absmax = F32(10.0) ** rng.uniform(-5, 30, 16).astype(F32)
    else:  # absmax below 1.27e-6: qs is its 1e-8 floor
        absmax = rng.uniform(0.5e-6, 1.2e-6, 16).astype(F32)
    rows = [_near_half_rows(a, rng) for a in absmax]
    d = min(len(r) for r in rows) // (32 * ke) * (32 * ke)
    o = np.stack([r[:d] for r in rows])
    qs = row_scale(o)
    if family == "floor":
        assert (qs == F32(1e-8)).all()
    # the test bites: the bare reciprocal rounds some quotient differently
    assert (np.rint(o * (F32(1) / qs)) != np.rint(o / qs)).any()
    _assert_exact(o, qs, ke)
    if family != "floor":
        got, _ = model_int8(o, qs, ke)
        assert (got[:, 0] == 127).all() and (got[:, 1] == -127).all()


@pytest.mark.parametrize("qs", [2.0**-126, 2.0**-127, 1e-40, 2.0**-149 * 300, 1e-30, 1.5 * 2.0**126])
def test_reciprocal_rule_tiny_subnormal_and_huge_qs(qs):
    """qs below 2^-126 (subnormal: the kernel's 1e-8 floor never gives it,
    the rule still holds), at tiny normal values, and where r = 1 / qs is
    subnormal: the row is redone with the true quotient where r or qs is not
    normal, and the reciprocal's path is exact elsewhere."""
    qs = np.array([[qs]], F32)
    k = np.arange(-127, 127, dtype=F32) + F32(0.5)
    with np.errstate(over="ignore"):
        o = np.concatenate([_ulp_steps(k * qs[0, 0], s) for s in range(-3, 4)])
    o = o[np.isfinite(o)]
    o = o[None, : len(o) // 32 * 32].astype(F32)
    fast = _assert_exact(o, qs, 8)
    with np.errstate(over="ignore"):
        r = F32(1) / qs[0, 0]
    if not (qs[0, 0] >= 2.0**-126 and 2.0**-126 <= r < 2.0**127):
        assert fast == 0.0


if given is None:
    def test_reciprocal_rule_hypothesis():
        pytest.importorskip("hypothesis")
else:
    @settings(max_examples=300, deadline=None, derandomize=True, database=None)
    @given(
        ke=st.sampled_from([8, 4]),
        rows=hnp.arrays(F32, st.tuples(st.integers(1, 4), st.sampled_from([32, 64, 256])),
                        elements=st.floats(-1e4, 1e4, width=32, allow_subnormal=True)),
        scale=st.floats(float(F32(1e-12)), float(F32(1e12)), width=32),
    )
    def test_reciprocal_rule_hypothesis(ke, rows, scale):
        o = (rows * F32(scale)).astype(F32)
        o = np.where(np.isfinite(o), o, F32(0))
        _assert_exact(o, row_scale(o), ke)


def test_reciprocal_rule_takes_the_fast_path_on_random_rows():
    """On rows like the DiT's (normal, scale ~3), almost every lane of a
    row takes the reciprocal's path: the fix-up is rare."""
    rng = np.random.default_rng(7)
    o = (rng.standard_normal((256, 768)) * 3).astype(F32)
    fast = _assert_exact(o, row_scale(o), 8)
    assert fast > 0.9


def _adversarial_shift_rows(rng, d):
    """Rows of o for the JAX comparison: seeded normal rows at three scales
    and near-half-integer rows at two."""
    rows = [(rng.standard_normal(d) * s).astype(F32) for s in (0.05, 1.0, 40.0)]
    for s in (F32(3.0) / F32(127), F32(0.02)):
        rows.append(np.resize(_near_half_rows(F32(127) * s, rng), d).astype(F32))
    return np.stack(rows)


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_kernel_rule_matches_pallas_and_plain_bitwise(kind):
    """x = 0: the normalised row is 0 on every side, so o = shift exactly
    and the int8 step alone differs; the model, the Pallas kernel (interpret
    mode) and the port's plain version agree bit for bit."""
    rng = np.random.default_rng(11)
    d, n = 512, 8
    sh = _adversarial_shift_rows(rng, d)
    b = len(sh)
    sc = (0.3 * rng.standard_normal((b, d))).astype(F32)
    x = np.zeros((b, n, d), F32)
    w = (1.0 + 0.1 * rng.standard_normal(d)).astype(F32)
    jq, js = jfad.fused_norm_modulate_quant(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sh), jnp.asarray(sc),
                                            kind=kind)
    tq, ts = tfad.fused_norm_modulate_quant(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sh),
                                            torch.from_numpy(sc), kind=kind)
    o = np.broadcast_to(sh[:, None, :], (b, n, d))
    qs = row_scale(o)
    got, fast = model_int8(o, qs, 8)
    np.testing.assert_array_equal(ts.numpy(), qs)
    np.testing.assert_array_equal(got, tq.numpy())
    assert fast > 0.0
    # XLA computes absmax / 127 as absmax * (1 / 127), one ulp off at times
    # (the scales' tolerance in the other parity tests); from its own scales
    # the rule gives the Pallas kernel's int8 values bit for bit
    js = np.asarray(js)
    np.testing.assert_allclose(js, qs, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(model_int8(o, js, 8)[0], np.asarray(jq))

"""The port's samplers vs ``ldmae_tpu``'s on the CPU: the SDE half of the
path math (diffusion forms, score / noise / velocity conversions,
``get_score``, ``check_interval`` under ``sde=True``), fixed-step RK4 and
the SDE Euler-Maruyama / Heun samplers with every last-step rule, the
adaptive dopri5 solver, the probability-flow likelihood, the sampling
chain in SDE, RK4 and dopri5 mode, the ``sdpa`` / ``cudnn`` attention impls
and ``transport.utils``.

Inputs are numpy draws from a fixed seed handed to both packages; the SDE's
normal draws and the likelihood's Rademacher probes are the JAX package's
own (``jax.random.normal`` over ``jax.random.split(key, n - 1)``, and
``randint``), injected into the port, since the two generators differ.

Tolerances: elementwise float32 path math at rtol 1e-6 (an exp or a
division may round one ulp apart); float32 integrations at 1e-5 (XLA and
PyTorch may contract or order a float32 expression differently, and 7-250
steps carry the ulp); bf16 chains as the existing chain tests allow
(latents within 2e-2 of their scale, images within 2 levels); float32
chains through the debug DiT within 1e-4 of their scale (summation order
in the matmuls, over the steps). The likelihood on the debug DiT: JAX
forms eps^T J eps forward (``jax.jvp``), the port in reverse mode, so the
divergence is the same sum taken in another order: per-sample logp within
1e-4 relative.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ldmae_tpu.eval import sampling as jsampling
from ldmae_tpu.models import lightningdit as jdit
from ldmae_tpu.models import vmae as jvmae
from ldmae_tpu.ops import attention as jatt
from ldmae_tpu.ops import rope as jrope
from ldmae_tpu.transport import adaptive as jadaptive
from ldmae_tpu.transport import create_transport as jcreate_transport
from ldmae_tpu.transport import paths as jpaths
from ldmae_tpu.transport import samplers as jsamplers
from ldmae_tpu.transport import utils as jutils

from ldmae_tpu_torch.eval.sampling import make_sample_fn
from ldmae_tpu_torch.ops import attention as tatt
from ldmae_tpu_torch.transport import EasyDict, create_transport, log_state, paths, samplers
from ldmae_tpu_torch.transport.adaptive import dopri5, make_likelihood_fn, prior_logp

from test_torch_port_sampling import CHAIN, IMPLS, _pipelines

PLANS = ["ICPlan", "VPCPlan", "GVPCPlan"]
FORMS = ["constant", "SBDM", "sigma", "linear", "decreasing", "inccreasing-decreasing"]


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(jnp.asarray(x).astype(jnp.float32))


def _xt(seed=0, shape=(4, 3, 2, 2)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    t = rng.uniform(0.1, 0.9, shape[0]).astype(np.float32)
    return x, t


def _transports(path, prediction):
    eps = dict(train_eps=1e-3, sample_eps=1e-3)
    return create_transport(path, prediction, **eps), jcreate_transport(path, prediction, **eps)


# ---------------------------------------------------------------------------
# path math and the transport
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("plan", PLANS)
def test_compute_diffusion_matches_jax(plan, form):
    x, t = _xt()
    got = getattr(paths, plan)().compute_diffusion(torch.from_numpy(x), torch.from_numpy(t), form=form, norm=0.7)
    ref = getattr(jpaths, plan)().compute_diffusion(jnp.asarray(x), jnp.asarray(t), form=form, norm=0.7)
    np.testing.assert_allclose(*np.broadcast_arrays(_np(got), _np(ref)), rtol=1e-6, atol=1e-7)


def test_compute_diffusion_refuses_an_unknown_form():
    x, t = _xt()
    with pytest.raises(NotImplementedError, match="increasing-decreasing"):
        paths.ICPlan().compute_diffusion(torch.from_numpy(x), torch.from_numpy(t), form="increasing-decreasing")


@pytest.mark.parametrize("plan", PLANS)
def test_score_velocity_noise_conversions_match_jax(plan):
    x, t = _xt(1)
    v = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    tp, jp = getattr(paths, plan)(), getattr(jpaths, plan)()
    for name in ("get_score_from_velocity", "get_noise_from_velocity", "get_velocity_from_score"):
        got = getattr(tp, name)(torch.from_numpy(v), torch.from_numpy(x), torch.from_numpy(t))
        ref = getattr(jp, name)(jnp.asarray(v), jnp.asarray(x), jnp.asarray(t))
        np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-6, atol=1e-6, err_msg=name)


def _toy_model(x, t, **kw):
    """A smooth nonlinear field of x and t, the same in both packages."""
    tt = t.reshape(-1, *([1] * (x.ndim - 1)))
    if isinstance(x, torch.Tensor):
        return (torch.sin(x) * (1 + tt) - 0.3 * x).to(x.dtype)
    return (jnp.sin(x) * (1 + tt) - 0.3 * x).astype(x.dtype)


@pytest.mark.parametrize("prediction", ["noise", "score", "velocity"])
@pytest.mark.parametrize("path", ["Linear", "VP", "GVP"])
def test_get_score_and_drift_match_jax(path, prediction):
    """get_score, and get_drift_and_score: the drift and the score of one
    model evaluation equal get_drift's and get_score's."""
    x, t = _xt(3)
    tt, jt = _transports(path, prediction)
    tx, tt_ = torch.from_numpy(x), torch.from_numpy(t)
    got = tt.get_score()(tx, tt_, _toy_model)
    ref = jt.get_score()(jnp.asarray(x), jnp.asarray(t), _toy_model)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-6, atol=1e-6)
    calls = []

    def counted(x, t, **kw):
        calls.append(1)
        return _toy_model(x, t)

    drift, score = tt.get_drift_and_score()(tx, tt_, counted)
    assert len(calls) == 1
    torch.testing.assert_close(drift, tt.get_drift()(tx, tt_, _toy_model), rtol=0, atol=0)
    torch.testing.assert_close(score, got, rtol=0, atol=0)


@pytest.mark.parametrize("last_step_size", [0.0, 0.04])
@pytest.mark.parametrize("form", ["SBDM", "sigma"])
@pytest.mark.parametrize("prediction", ["noise", "velocity"])
@pytest.mark.parametrize("path", ["Linear", "VP", "GVP"])
def test_check_interval_sde_matches_jax(path, prediction, form, last_step_size):
    # the factory's defaults leave sample_eps None off the velocity linear
    # path (its eps quirk), so those are checked on the training side only
    for eps, evals in ((dict(train_eps=1e-3, sample_eps=1e-3), (True, False)), ({}, (False,))):
        tt, jt = create_transport(path, prediction, **eps), jcreate_transport(path, prediction, **eps)
        for kw in [dict(sde=True, eval=e, reverse=r) for e in evals for r in (False, True)]:
            args = (tt.train_eps, tt.sample_eps)
            assert tt.check_interval(*args, diffusion_form=form, last_step_size=last_step_size, **kw) == \
                jt.check_interval(*args, diffusion_form=form, last_step_size=last_step_size, **kw)


# ---------------------------------------------------------------------------
# fixed-step samplers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_ode_sample_rk4_matches_jax(dt):
    """RK4 on a nonlinear field; each stage state cast back to the state's
    dtype (bf16: within a rounding)."""
    jd, td = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dt]
    x, _ = _xt(4)
    grid = samplers.make_time_grid(0.0, 1.0, 8, 0.3)

    def tdrift(x, t):
        return _toy_model(x, torch.full((x.shape[0],), float(t), dtype=x.dtype))

    def jdrift(x, t):
        return _toy_model(x, jnp.full((x.shape[0],), t, dtype=x.dtype))

    got = samplers.ode_sample(tdrift, torch.from_numpy(x).to(td), grid, method="rk4")
    ref = jsamplers.ode_sample(jdrift, jnp.asarray(x).astype(jd), jnp.asarray(grid), method="rk4")
    assert got.dtype == td
    tol = dict(rtol=1e-5, atol=1e-5) if dt == "float32" else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(_np(got), _np(ref), **tol)


def _jax_draws(key, n, shape, dtype=jnp.float32):
    """The normal draws of the JAX ``sde_sample``, one a step."""
    return [np.array(jax.random.normal(k, shape, dtype=dtype).astype(jnp.float32))
            for k in jax.random.split(key, n - 1)]


def _noise_model(x, t, **kw):
    """The exact noise prediction for data ~ N(0, 1) on the linear path:
    E[x0 | x_t] = (1 - t) x_t / (t^2 + (1 - t)^2)."""
    tt = t.reshape(-1, *([1] * (x.ndim - 1)))
    return (1 - tt) * x / (tt**2 + (1 - tt) ** 2)


@pytest.mark.parametrize("last_step", ["Mean", "Tweedie", "Euler", None])
@pytest.mark.parametrize("method", ["Euler", "Heun"])
def test_sample_sde_matches_jax(method, last_step):
    x, _ = _xt(5)
    n = 12
    tt, jt = _transports("Linear", "noise")
    kw = dict(sampling_method=method, num_steps=n, last_step=last_step)
    ref = jsamplers.Sampler(jt).sample_sde(**kw)(jax.random.key(3), jnp.asarray(x), _noise_model)
    noise = [torch.from_numpy(w) for w in _jax_draws(jax.random.key(3), n, x.shape)]
    got = samplers.Sampler(tt).sample_sde(**kw)(torch.from_numpy(x), _noise_model, noise=noise)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)
    assert np.abs(_np(got) - x).max() > 0.1


@pytest.mark.parametrize("path,prediction,form", [("GVP", "velocity", "sigma"), ("VP", "score", "linear"),
                                                  ("Linear", "velocity", "decreasing")])
def test_sample_sde_paths_and_forms_match_jax(path, prediction, form):
    x, _ = _xt(6)
    n = 10
    tt, jt = _transports(path, prediction)

    def model(x, t, **kw):
        return 0.5 * _toy_model(x, t)

    kw = dict(sampling_method="Heun", num_steps=n, diffusion_form=form, diffusion_norm=0.5)
    ref = jsamplers.Sampler(jt).sample_sde(**kw)(jax.random.key(4), jnp.asarray(x), model)
    noise = [torch.from_numpy(w) for w in _jax_draws(jax.random.key(4), n, x.shape)]
    got = samplers.Sampler(tt).sample_sde(**kw)(torch.from_numpy(x), model, noise=noise)
    np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-5, atol=1e-5)


def test_sde_noise_from_a_generator_is_reproducible_and_counted():
    """Draws come from the generator one a step; one model call a drift
    evaluation: Euler 249 + the Mean step, Heun 2 a step + 1."""
    tt, _ = _transports("Linear", "noise")
    x = torch.from_numpy(_xt(7)[0])
    for method, n, calls_expected in (("Euler", 20, 20), ("Heun", 20, 39)):
        calls = []

        def model(x, t, **kw):
            calls.append(1)
            return _noise_model(x, t)

        fn = samplers.Sampler(tt).sample_sde(sampling_method=method, num_steps=n)
        a, b, c = (fn(x, model, generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2))
        assert len(calls) == 3 * calls_expected
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not torch.equal(a, c)
    with pytest.raises(ValueError, match="3 noise draws for 19 steps"):
        fn(x, _noise_model, noise=[x] * 3)


# ---------------------------------------------------------------------------
# dopri5
# ---------------------------------------------------------------------------


def test_dopri5_exponential_decay():
    out = dopri5(lambda x, t: -x, torch.ones(()), 0.0, 1.0, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(float(out), np.exp(-1), rtol=1e-5)


def test_dopri5_stiffish_oscillator():
    w = 8.0

    def f(s, t):
        return torch.stack([s[1], -(w**2) * s[0]])

    out = dopri5(f, torch.tensor([1.0, 0.0]), 0.0, 1.0, rtol=1e-6, atol=1e-8, max_steps=5000)
    np.testing.assert_allclose(out.numpy(), [np.cos(w), -w * np.sin(w)], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("t0,t1,expected", [(1.0, 0.0, np.e**-1), (0.0, 1.0, np.e)])
def test_dopri5_reverse_interval_integrates(t0, t1, expected):
    out = dopri5(lambda x, t: x, torch.ones(4), t0, t1, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(out.numpy(), expected, rtol=1e-4)


def _jax_dopri5_tally(f, x, t0, t1, **kw):
    """JAX's dopri5 with its accepted and rejected steps, read from the
    times of its drift evaluations (1 + 6 an attempted step): a step
    starting at s with size h evaluates stage 2 at s + h/5 and stage 6 at
    s + h; the next attempt starts at s + h if it was accepted, else at s.
    The last attempt is accepted (the loop ends at t1)."""
    times = []

    def drift(x, t):
        jax.debug.callback(lambda tt: times.append(float(tt)), t, ordered=True)
        return f(x, t)

    out = np.asarray(jadaptive.dopri5(drift, jnp.asarray(x), t0, t1, **kw))
    evals = np.asarray(times[1:], np.float64).reshape(-1, 6)
    t2, t6 = evals[:, 0], evals[:, 4]
    start = t6 - (t6 - t2) * 5 / 4
    acc = [abs(start[i + 1] - t6[i]) < abs(start[i + 1] - start[i]) for i in range(len(start) - 1)] + [True]
    return out, sum(acc), len(acc) - sum(acc)


def test_dopri5_matches_jax_with_the_same_steps():
    """A nonlinear field whose error control rejects steps: the outputs and
    the accepted/rejected tallies agree."""
    x = np.random.default_rng(8).standard_normal((3, 5)).astype(np.float32)

    def f(x, t):
        mod = torch if isinstance(x, torch.Tensor) else jnp
        return -4.0 * mod.sin(3 * x) * (1 + 5 * t) + mod.cos(7 * t)

    ref, acc, rej = _jax_dopri5_tally(f, x, 0.0, 1.0, rtol=1e-5, atol=1e-7, initial_step=0.5)
    dopri5.accepted = dopri5.rejected = 0
    got = dopri5(f, torch.from_numpy(x), 0.0, 1.0, rtol=1e-5, atol=1e-7, initial_step=0.5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert rej > 0 and acc > 5
    assert (dopri5.accepted, dopri5.rejected) == (acc, rej)


def test_dopri5_bf16_state_and_max_steps():
    """A bf16 state stays bf16 (the JAX solver refuses one); max_steps
    attempted steps end the loop."""
    out = dopri5(lambda x, t: -x, torch.ones(4, dtype=torch.bfloat16), 0.0, 1.0)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.exp(-1), rtol=2**-7)
    dopri5.accepted = dopri5.rejected = 0
    dopri5(lambda x, t: -x, torch.ones(4), 0.0, 1.0, max_steps=3)
    assert dopri5.accepted + dopri5.rejected == 3


# ---------------------------------------------------------------------------
# the likelihood
# ---------------------------------------------------------------------------


def test_prior_logp_matches_jax():
    z = np.random.default_rng(9).standard_normal((3, 4, 2, 2)).astype(np.float32)
    np.testing.assert_allclose(prior_logp(torch.from_numpy(z)).numpy(),
                               np.asarray(jadaptive.prior_logp(jnp.asarray(z))), rtol=1e-6)
    np.testing.assert_allclose(prior_logp(torch.zeros(2, 3, 4)).numpy(), -6 * np.log(2 * np.pi), rtol=1e-6)


def test_likelihood_of_a_zero_field_is_the_prior():
    fn = make_likelihood_fn(create_transport("Linear", "velocity"), num_steps=20)
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(0))
    logp, z = fn(x, lambda x, t, **kw: torch.zeros_like(x), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(z, x, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(logp, prior_logp(x), rtol=1e-4, atol=0)


def test_likelihood_of_a_scaling_field_has_the_log_det():
    """v = c x over t in [0, 1]: z = x e^-c, logp(x) = prior(z) - c dim."""
    c, dim = 0.5, 4
    fn = make_likelihood_fn(create_transport("Linear", "velocity"), num_steps=400)
    x = torch.randn(16, dim, generator=torch.Generator().manual_seed(0)) * 0.3
    logp, z = fn(x, lambda x, t, **kw: c * x, generator=torch.Generator().manual_seed(1))
    expected_z = x * np.exp(-c)
    torch.testing.assert_close(z, expected_z, rtol=2e-2, atol=1e-3)
    torch.testing.assert_close(logp, prior_logp(expected_z) - c * dim, rtol=2e-2, atol=0)


def test_likelihood_rk4_beats_euler():
    transport = create_transport("Linear", "velocity")
    x = torch.randn(4, 2, 2, 2, generator=torch.Generator().manual_seed(0))

    def run(n, method):
        return make_likelihood_fn(transport, n, method)(
            x, lambda x, t, **kw: -0.5 * x, generator=torch.Generator().manual_seed(1))[0]

    ref = run(400, "rk4")
    assert (run(12, "rk4") - ref).abs().mean() < (run(12, "euler") - ref).abs().mean()


def _rademacher(key, shape):
    return np.array(jax.random.randint(key, shape, 0, 2).astype(jnp.float32) * 2 - 1)


@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_likelihood_matches_jax_on_a_toy_field(method):
    """The same probes: (logp, z) of the port's reverse-mode estimator
    against JAX's forward-mode one."""
    x = np.random.default_rng(10).standard_normal((4, 3, 2, 2)).astype(np.float32)
    transport, jtransport = create_transport("Linear", "velocity"), jcreate_transport("Linear", "velocity")
    jlogp, jz = jadaptive.make_likelihood_fn(jtransport, 10, method)(jax.random.key(2), jnp.asarray(x), _toy_model)
    eps = torch.from_numpy(_rademacher(jax.random.key(2), x.shape))
    logp, z = make_likelihood_fn(transport, 10, method)(torch.from_numpy(x), _toy_model, eps=eps)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=1e-5)


@pytest.mark.parametrize("impls", ["xla", "kernels"])
def test_likelihood_matches_jax_on_the_debug_dit(impls):
    """The debug DiT in fp32 (Euler over 3 steps: one traced model in the
    JAX scan; RK4's arithmetic is checked on the toy field), JAX through
    xla; the port through xla or through the kernel path's wrappers (flash_rope's autograd Function and
    the fused adaLN, their plain versions on the CPU; the MLP is xla, as
    the kernel path needs). The DiT's parameters stop requiring grad for
    the call and are restored."""
    (js, _, jbundle), (ts, _, tbundle) = _pipelines(seed=11)
    dit = tbundle["dit"]
    x = np.random.default_rng(12).standard_normal((2, 16, 8, 8)).astype(np.float32)
    y = np.array([3, 5])
    xla = dict(rope_layout="half", attn_impl="xla", adaln_impl="xla", mlp_impl="xla")
    kw = dict(IMPLS, mlp_impl="xla") if impls == "kernels" else xla

    def jmodel(x, t, y):
        return jdit.dit_forward(jbundle["dit"], js, jdit.DiTConsts(js), x, t, y, train=False,
                                compute_dtype=jnp.float32, **xla).astype(x.dtype)

    seen = []

    def tmodel(x, t, y):
        seen.append(any(p.requires_grad for p in dit.parameters()))
        return dit(x, t, y, compute_dtype=torch.float32, **kw).to(x.dtype)

    transport, jtransport = create_transport(), jcreate_transport()
    jlogp, jz = jadaptive.make_likelihood_fn(jtransport, 4, "euler")(
        jax.random.key(5), jnp.asarray(x), jmodel, y=jnp.asarray(y))
    eps = torch.from_numpy(_rademacher(jax.random.key(5), x.shape))
    logp, z = make_likelihood_fn(transport, 4, "euler")(torch.from_numpy(x), tmodel, eps=eps, module=dit,
                                                        y=torch.from_numpy(y))
    assert seen and not any(seen)
    assert all(p.requires_grad for p in dit.parameters())
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-4 * np.abs(np.asarray(jz)).max())
    np.testing.assert_allclose(logp.numpy(), np.asarray(jlogp), rtol=1e-4)
    assert np.abs(np.asarray(jlogp) - np.asarray(jadaptive.prior_logp(jz))).max() > 1.0  # the divergence moved it


def test_likelihood_refuses_inference_mode_but_takes_its_tensors():
    """Called inside inference_mode it raises; outside, x and eps may be
    inference tensors (a sampler's output)."""
    fn = make_likelihood_fn(create_transport(), 3)
    with torch.inference_mode():
        x, eps = torch.randn(2, 3), torch.ones(2, 3)
        with pytest.raises(RuntimeError, match="inference_mode"):
            fn(x, lambda x, t, **kw: x)
    logp, z = fn(x, lambda x, t, **kw: 0.5 * x, eps=eps)
    torch.testing.assert_close(logp, prior_logp(z) - 0.5 * 3, rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# the sampling chain
# ---------------------------------------------------------------------------


def _jax_sde_sample_cast(drift, diffusion, key, x, t_grid, method="Euler", last_step_fn=None):
    """The JAX package's ``sde_sample`` with each step's state, and Heun's
    stage states, cast back to the state's dtype: the port's rule (a no-op
    in float32, where the two functions are the same)."""
    n, dtype = t_grid.shape[0], x.dtype
    dt = t_grid[1] - t_grid[0]

    def step(carry, inp):
        t, k = inp
        dw = jax.random.normal(k, carry.shape, dtype=carry.dtype) * jnp.sqrt(dt)
        if method == "Euler":
            nxt = carry + drift(carry, t) * dt + jnp.sqrt(2 * diffusion(carry, t)) * dw
        else:
            xhat = (carry + jnp.sqrt(2 * diffusion(carry, t)) * dw).astype(dtype)
            k1 = drift(xhat, t)
            k2 = drift((xhat + dt * k1).astype(dtype), t + dt)
            nxt = xhat + 0.5 * dt * (k1 + k2)
        return nxt.astype(dtype), None

    final, _ = jax.lax.scan(step, x, (t_grid[:-1], jax.random.split(key, n - 1)))
    return final if last_step_fn is None else last_step_fn(final, t_grid[-1])


def _check_chain(dtype, transports, noise_steps=None, lat_tol=None, px_tol=None, **chain):
    """One JAX run to latents (its images: the JAX decode of those); the
    port's chain to latents and to images."""
    (js, jvs, jbundle), (ts, tvs, tbundle) = _pipelines(seed=13)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    z = np.random.default_rng(14).standard_normal((2, 16, 8, 8)).astype(np.float32)
    y = np.array([1, 7])
    transport, jtransport = transports
    jfn = jsampling.make_sample_fn(js, jdit.DiTConsts(js), jtransport, compute_dtype=jd, **chain, **IMPLS)
    tfn = make_sample_fn(ts, transport, compute_dtype=td, device="cpu", **chain, **IMPLS)
    key = jax.random.key(0)
    kw = {}
    if noise_steps:  # the JAX sample_fn's draws: split(key) -> (k_z, k_sde), one a step of the doubled batch
        draws = _jax_draws(jax.random.split(key)[1], noise_steps, (4, 16, 8, 8), jd)
        kw["sde_noise"] = [torch.from_numpy(w) for w in draws]
    jlat = jfn(dict(jbundle, vae=None), key, jnp.asarray(y), z=jnp.asarray(z))
    jimgs = np.asarray(jvmae.decode_to_images(jbundle["vae"], jvs, jvmae.VMAEConsts(jvs), jlat, compute_dtype=jd,
                                              attn_impl=IMPLS["attn_impl"]))
    jlat = np.asarray(jlat)
    tlat = tfn(dict(tbundle, vae=None), torch.from_numpy(y), z=torch.from_numpy(z), **kw).numpy()
    timgs = tfn(tbundle, torch.from_numpy(y), z=torch.from_numpy(z), **kw).numpy()
    assert np.abs(tlat - jlat).max() <= lat_tol * np.abs(jlat).max()
    assert np.abs(tlat - (z * tbundle["latent_std"].numpy() + tbundle["latent_mean"].numpy())).max() > 1e-2
    assert timgs.dtype == np.uint8 and timgs.shape == (2, 64, 64, 3)
    assert np.abs(timgs.astype(int) - jimgs.astype(int)).max() <= px_tol


SDE_CHAIN = dict(CHAIN, num_steps=8, sampling_method="euler", mode="SDE")


def test_sde_chain_matches_jax_fp32():
    """Heun against the JAX package's own SDE chain (float32, where it runs)."""
    _check_chain("float32", _transports("Linear", "noise"), noise_steps=8, lat_tol=1e-4, px_tol=1,
                 **dict(SDE_CHAIN, sampling_method="heun"))


def test_sde_chain_matches_jax_bf16(monkeypatch):
    """bf16 against the JAX chain with its SDE state cast back a step
    (``_jax_sde_sample_cast``; the JAX sampler itself refuses a bf16
    state). Latents within 5e-2 of their scale, not the ODE chains' 2e-2:
    from t0 = 1e-3 the SBDM diffusion (about 1/t) and the random DiT's
    noise prediction make this SDE chaotic, so a rounding flipped early
    grows: JAX's own bf16 chain lies 12 % (Euler) to 130 % (Heun) of the
    scale from its float32 chain, and the two packages' bf16 chains 1.0 %
    (Euler) and 2.1 % (Heun) apart. Euler here, Heun in float32 above."""
    monkeypatch.setattr(jsamplers, "sde_sample", _jax_sde_sample_cast)
    _check_chain("bfloat16", _transports("Linear", "noise"), noise_steps=8, lat_tol=5e-2, px_tol=2, **SDE_CHAIN)


def test_rk4_chain_matches_jax_bf16():
    _check_chain("bfloat16", (create_transport(), jcreate_transport()), lat_tol=2e-2, px_tol=2,
                 **dict(CHAIN, num_steps=5, sampling_method="rk4"))


def test_dopri5_chain_matches_jax_fp32():
    _check_chain("float32", (create_transport(), jcreate_transport()), lat_tol=1e-4, px_tol=1,
                 **dict(CHAIN, sampling_method="dopri5"))


def test_sde_chain_draws_after_z_from_the_generator():
    """With a generator and no z, z comes first and the SDE draws follow:
    the same seed gives the same batch, and the batch equals the one given
    that z and those draws explicitly."""
    _, (ts, _, tbundle) = _pipelines(seed=15)
    fn = make_sample_fn(ts, _transports("Linear", "noise")[0], compute_dtype=torch.float32, device="cpu",
                        **dict(SDE_CHAIN, num_steps=4))
    bundle, y = dict(tbundle, vae=None), torch.tensor([2, 4])
    a, b = (fn(bundle, y, generator=torch.Generator().manual_seed(9)) for _ in range(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    g = torch.Generator().manual_seed(9)
    z = torch.randn(2, 16, 8, 8, generator=g)
    noise = [torch.randn(4, 16, 8, 8, generator=g) for _ in range(3)]
    torch.testing.assert_close(fn(bundle, y, z=z, sde_noise=noise), a, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# sdpa / cudnn, transport.utils
# ---------------------------------------------------------------------------


class _Lin(torch.nn.Module):
    def __init__(self, w, b=None):
        super().__init__()
        self.weight, self.bias = w, b


@pytest.mark.parametrize("impl", ["sdpa", "cudnn"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_sdpa_impls_match_jax(impl, dt):
    """RoPE (half layout) applied outside, then the library attention, with
    an RMS qk-norm; bf16 within a rounding."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dt == "bfloat16" else (jnp.float32, torch.float32)
    rng = np.random.default_rng(16)
    d, heads, grid = 64, 4, 4
    hd = d // heads
    x = jnp.asarray(rng.standard_normal((2, grid * grid, d)).astype(np.float32)).astype(jd)
    wqkv = rng.standard_normal((d, 3, d)).astype(np.float32) * d**-0.5
    bqkv = rng.standard_normal((3, d)).astype(np.float32) * 0.1
    wp = rng.standard_normal((d, d)).astype(np.float32) * d**-0.5
    s = (1 + 0.1 * rng.standard_normal(hd)).astype(np.float32)
    jp = {"qkv": {"w": jnp.asarray(wqkv), "b": jnp.asarray(bqkv)}, "proj": {"w": jnp.asarray(wp)},
          "q_norm": {"scale": jnp.asarray(s)}, "k_norm": {"scale": jnp.asarray(s)}}
    tp = torch.nn.Module()
    tp.qkv = _Lin(torch.from_numpy(wqkv.reshape(d, 3 * d).T.copy()), torch.from_numpy(bqkv.reshape(-1)))
    tp.proj = _Lin(torch.from_numpy(wp.T.copy()))
    tp.q_norm = tp.k_norm = _Lin(torch.from_numpy(s))
    cos, sin = (jrope.to_half_layout(a) for a in jrope.build_rope_table(hd // 2, grid))
    kw = dict(rope_layout="half", qk_norm_kind="rms", impl=impl)
    ref = jatt.multi_head_attention(x, jp, heads, rope=(jnp.asarray(cos), jnp.asarray(sin)), **kw)
    out = tatt.multi_head_attention(torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(td), tp, heads,
                                    rope=(torch.from_numpy(cos), torch.from_numpy(sin)), **kw)
    assert out.dtype == td
    tol = dict(rtol=1e-5, atol=1e-5) if dt == "float32" else dict(rtol=2**-7, atol=2**-7)
    np.testing.assert_allclose(_np(out), _np(ref), **tol)
    xla = tatt.multi_head_attention(torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(td), tp, heads,
                                    rope=(torch.from_numpy(cos), torch.from_numpy(sin)), **dict(kw, impl="xla"))
    np.testing.assert_allclose(_np(out), _np(xla), **tol)


def test_unknown_attention_impl_raises():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="unknown attention impl 'flash2'"):
        tatt.sdpa(q, q, q, impl="flash2")


def test_easydict_and_log_state():
    d = EasyDict(a=1)
    d.b = 2
    assert d["b"] == 2 and d.a == 1
    del d.a
    with pytest.raises(AttributeError):
        d.a
    jd = jutils.EasyDict(b=2)
    assert dict(jd) == dict(d)
    # a transport's configuration: the JAX package's lines, objects by class
    tt, jt = create_transport("Linear", "noise", train_eps=1e-3, sample_eps=1e-3), jcreate_transport(
        "Linear", "noise", train_eps=1e-3, sample_eps=1e-3)
    lines, jlines = log_state(tt).splitlines(), jutils.log_state(jt).splitlines()
    assert [ln.split(":")[0] for ln in lines] == [ln.split(":")[0] for ln in jlines]
    assert [ln for ln in lines if "path_sampler" not in ln] == [ln for ln in jlines if "path_sampler" not in ln]
    assert "  path_sampler: [ICPlan]" in lines
    # a module: its state dict's tensors by shape, dtype and device
    lin = torch.nn.Linear(3, 2)
    assert log_state(lin) == "Linear:\n  bias: Tensor(2,) float32 on cpu\n  weight: Tensor(2, 3) float32 on cpu"
    assert log_state(lin.state_dict()).splitlines()[1:] == log_state(lin).splitlines()[1:]

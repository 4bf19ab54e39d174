"""The port's diffusion diagnostics against npcd_tpu on the CPU: the four
util functions (both tails of the discretized likelihood, and its 1e-12
clips bitwise in each branch), the forward-process helpers
q_mean_variance, q_sample_next and predict_eps_from_xstart, the bound's
term _vb_terms_bpd at t 0 (the decoder NLL) and 25 (a KL), calc_bpd_loop's
ten outputs on npcd_tpu's replayed draws with the tiny denoiser of
tests/diffusion_tiny.py at T 50, the oracle denoiser's bound (npcd_tpu's
tests/test_gaussian_diffusion.py) and prior_bpd.

Tolerances: the elementwise functions and helpers 1e-6 (f32, the same
formulas; exp/log/tanh of two libraries an ulp apart), the likelihood's
bin probabilities 8 half-ulps of 1 and its log-probs the log of that
relative change; _vb_terms_bpd and calc_bpd_loop 1e-5 relative and
absolute (the denoiser's f32 forward sums in another order, ~1e-7 of its
outputs, and bits per dim divide by log 2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tiny import (C, P, T, bpd_draws, jax_denoiser, jax_process, latents, models,
                            port_process, replay)
from npcd_tpu.utils import util as jax_util
from npcd_tpu_torch.utils import util

TOL = dict(rtol=1e-6, atol=1e-6)
VB_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny models: their small ops gain
    nothing from a thread pool, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    return models(seed=0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got.detach().numpy() if isinstance(got, torch.Tensor) else got,
                               np.asarray(want), err_msg=what, **tol)


def test_util_functions_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    _close(util.mean_flat(_t(x)), jax_util.mean_flat(jnp.asarray(x)))
    m1, m2 = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    v1, v2 = rng.normal(scale=0.5, size=(2, 3, 4, 5)).astype(np.float32)
    _close(util.normal_kl(_t(m1), _t(v1), _t(m2), _t(v2)),
           jax_util.normal_kl(*map(jnp.asarray, (m1, v1, m2, v2))))
    _close(util.normal_kl(_t(m1), _t(v1), 0.0, 0.0),  # the prior's form
           jax_util.normal_kl(jnp.asarray(m1), jnp.asarray(v1), 0.0, 0.0))
    z = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(util.approx_standard_normal_cdf(_t(z)),
           jax_util.approx_standard_normal_cdf(jnp.asarray(z)))


ULP1 = 2.0**-24  # half an ulp of 1 in f32
CLIPPED = np.float32(np.log(np.float32(1e-12)))  # log of the 1e-12 clip


def _saturated(x, means, log_scales):
    """Where the likelihood's CDFs saturate (tanh's argument beyond 10,
    which tanh rounds to +-1 in f32, computed here in f64): the lower tail's
    cdf_plus is 0, the upper tail's 1 - cdf_min is 0, a bin's two CDFs are
    both 0 or both 1. There each library's probability is 0 and its clip
    gives log(1e-12) exactly."""
    inv = np.exp(-log_scales.astype(np.float64))
    cx = x.astype(np.float64) - means

    def arg(z):
        return np.sqrt(2 / np.pi) * (z + 0.044715 * z**3)

    up, um = arg(inv * (cx + 1 / 255)), arg(inv * (cx - 1 / 255))
    return np.where(x < -0.999, up < -10, np.where(
        x > 0.999, um > 10, ((up < -10) & (um < -10)) | ((up > 10) & (um > 10))))


@pytest.mark.parametrize("log_scale", [-4.0, -1.0, 0.5])
def test_discretized_log_likelihood_matches_jax_on_both_tails(log_scale):
    """x at the edges (below -0.999: the lower tail, above 0.999: the upper
    tail) and inside; at log_scale -4 the bins far from the mean clip at
    1e-12, in each of the three branches."""
    rng = np.random.default_rng(1)
    x = np.concatenate([[-1.0, -0.9995, 0.9995, 1.0, -0.999, 0.999],
                        rng.uniform(-1, 1, 58)]).astype(np.float32).reshape(4, 16)
    means = rng.uniform(-1, 1, (4, 16)).astype(np.float32)
    scales = np.full((4, 16), log_scale, np.float32)
    got = util.discretized_gaussian_log_likelihood(_t(x), means=_t(means), log_scales=_t(scales))
    want = np.asarray(jax_util.discretized_gaussian_log_likelihood(
        jnp.asarray(x), means=jnp.asarray(means), log_scales=jnp.asarray(scales)))
    got = got.numpy()
    # saturated CDFs: both sides take the clip, bitwise
    sat = _saturated(x, means, scales)
    np.testing.assert_array_equal(got[sat], np.full(sat.sum(), CLIPPED))
    np.testing.assert_array_equal(want[sat], np.full(sat.sum(), CLIPPED))
    # elsewhere a bin's probability is the difference of two CDFs, each
    # 0.5 (1 + tanh) with tanh an ulp or two apart between the libraries:
    # the probabilities within 8 half-ulps of 1, and the log-probs of bins
    # above 1e-6 within the log of that relative change
    live = ~sat
    p_got, p_want = np.exp(got[live].astype(np.float64)), np.exp(want[live].astype(np.float64))
    assert np.abs(p_got - p_want).max() <= 8 * ULP1
    big = p_want >= 1e-6
    bound = -np.log1p(-8 * ULP1 / p_want[big])
    assert (np.abs(got[live][big].astype(np.float64) - want[live][big]) <= bound).all()
    tails = (np.abs(x) > 0.999) & live  # one CDF, no difference: within 1e-6
    _close(got[tails], want[tails])
    if log_scale == -4.0:
        assert sat.any() and big.any()


def test_discretized_log_likelihood_clips_each_branch_at_1e_12():
    """The lower tail, the upper tail and a bin, each four scales from its
    mean at log_scale -4 (probability 0 in f32): log(1e-12) exactly, as
    npcd_tpu's, in each branch (a clip at another floor, or none, differs)."""
    x = np.array([-1.0, 1.0, 0.0], np.float32)
    means = np.array([0.5, -0.5, 0.5], np.float32)
    scales = np.full(3, -4.0, np.float32)
    assert _saturated(x, means, scales).all()
    got = util.discretized_gaussian_log_likelihood(_t(x), means=_t(means), log_scales=_t(scales))
    want = np.asarray(jax_util.discretized_gaussian_log_likelihood(
        jnp.asarray(x), means=jnp.asarray(means), log_scales=jnp.asarray(scales)))
    np.testing.assert_array_equal(want, np.full(3, CLIPPED))
    np.testing.assert_array_equal(got.numpy(), want)


def test_forward_helpers_match_jax():
    jgd, gd = jax_process(), port_process()
    rng = np.random.default_rng(2)
    x0, xt, noise = rng.normal(size=(3, 4, C, P)).astype(np.float32)
    t = np.array([0, 1, 25, T - 1])
    for name, args in (("q_mean_variance", (x0,)), ("q_sample_next", (xt, noise)),
                       ("predict_eps_from_xstart", (xt, x0))):
        jargs = [jnp.asarray(args[0]), jnp.asarray(t)] + [jnp.asarray(a) for a in args[1:]]
        want = getattr(jgd, name)(*jargs)
        got = getattr(gd, name)(_t(args[0]), _t(t), *map(_t, args[1:]))
        for g, w in zip(*((got, want) if isinstance(want, tuple) else ((got,), (want,)))):
            _close(g, w, what=name)


@pytest.mark.parametrize("t_value", [0, 25])
def test_vb_terms_bpd_matches_jax(tiny, t_value):
    jmodel, jstate, pmodel, _ = tiny
    coords, feats = latents(3)
    noise_c, noise_f = latents(4)
    t = np.full((2,), t_value)
    jgd, gd = jmodel.process, pmodel.process
    jct = jgd.q_sample(jnp.asarray(coords), jnp.asarray(t), jnp.asarray(noise_c))
    jft = jgd.q_sample(jnp.asarray(feats), jnp.asarray(t), jnp.asarray(noise_f))
    want = jgd._vb_terms_bpd(jax_denoiser(jmodel, jstate), jnp.asarray(coords), jct,
                             jnp.asarray(feats), jft, jnp.asarray(t))
    with torch.no_grad():
        ct = gd.q_sample(_t(coords), _t(t), _t(noise_c))
        ft = gd.q_sample(_t(feats), _t(t), _t(noise_f))
        got = gd._vb_terms_bpd(pmodel.denoiser, _t(coords), ct, _t(feats), ft, _t(t))
    for g, w, name in zip(got, want, ("vb_coords", "coords_recon", "vb_feats", "feats_recon")):
        _close(g, w, VB_TOL, name)
    assert float(got[2].abs().min()) > 0


def test_calc_bpd_loop_matches_jax(tiny):
    jmodel, jstate, pmodel, _ = tiny
    coords, feats = latents(5)
    rng = jax.random.PRNGKey(7)
    want = jax.jit(lambda r: jmodel.process.calc_bpd_loop(
        r, jax_denoiser(jmodel, jstate), jnp.asarray(coords), jnp.asarray(feats)))(rng)
    noise = replay(bpd_draws(rng, 2))
    got = pmodel.process.calc_bpd_loop(noise, pmodel.denoiser, _t(coords), _t(feats))
    assert not noise.left  # every JAX draw consumed, in order
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape == ((2, T) if k.startswith(("vb", "mse", "xstart"))
                                           else (2,)), k
        _close(got[k], w, VB_TOL, k)
    torch.testing.assert_close(got["total_bpd_feats"],
                               got["vb_feats"].sum(1) + got["prior_bpd_feats"], rtol=0, atol=0)


def test_calc_bpd_loop_oracle_denoiser():
    """An oracle that returns the noise implied by (x_t, x_0): every KL term
    but t = 0's, the eps-MSE and the x0-MSE vanish (npcd_tpu
    tests/test_gaussian_diffusion.py:120-155)."""
    gd = port_process()
    g = torch.Generator().manual_seed(0)
    x0_c = torch.randn((2, 3, 8), generator=g) * 0.1
    x0_f = torch.randn((2, 4, 8), generator=g) * 0.1
    s = gd.schedule

    def oracle(coords_t, feats_t, t):
        def eps(x_t, x_0):
            return ((x_t - s.sqrt_alphas_cumprod[t].reshape(-1, 1, 1) * x_0)
                    / s.sqrt_one_minus_alphas_cumprod[t].reshape(-1, 1, 1))
        return eps(coords_t, x0_c), eps(feats_t, x0_f)

    out = gd.calc_bpd_loop(lambda shape: torch.randn(shape, generator=g), oracle, x0_c, x0_f)
    assert out["vb_coords"].shape == (2, T) and out["total_bpd_coords"].shape == (2,)
    for part in ("coords", "feats"):
        torch.testing.assert_close(out[f"vb_{part}"][:, :-1], torch.zeros(2, T - 1), rtol=0,
                                   atol=1e-4)
        for k in ("mse", "xstart_mse"):
            torch.testing.assert_close(out[f"{k}_{part}"], torch.zeros(2, T), rtol=0, atol=1e-4)
        torch.testing.assert_close(out[f"total_bpd_{part}"],
                                   out[f"vb_{part}"].sum(1) + out[f"prior_bpd_{part}"],
                                   rtol=1e-6, atol=0)
    assert float(out["vb_coords"][:, -1].min()) > 0  # the decoder NLL at t = 0


def test_prior_bpd_matches_jax():
    jgd, gd = jax_process(), port_process()
    x0 = np.random.default_rng(6).normal(size=(3, C, P)).astype(np.float32)
    want = jgd.prior_bpd(jnp.asarray(x0))
    got = gd.prior_bpd(_t(x0))
    assert got.shape == (3,)
    _close(got, want)
    assert float(got.min()) > 0

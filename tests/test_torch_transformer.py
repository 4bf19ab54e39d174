"""The PyTorch port's denoiser and DDPM core against npcd_tpu: a tiny
NPCDTransformer (width 256, 2 layers, 4 heads, grouped qkv G = 2, nonzero
output_proj) carried over by utils/from_jax.py, the timestep embedding,
the schedule buffers, the normalizer fits and one sampler step with the
same draws. Tolerance on the denoiser: 1e-5 abs/rel (f32 through two
blocks, summation orders differ); buffers computed by the same numpy code
must match exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npcd_tpu.models.diffusion import gaussian_diffusion as jax_gd
from npcd_tpu.models.diffusion import normalizers as jax_norm
from npcd_tpu.models.diffusion import schedule as jax_schedule
from npcd_tpu.models.diffusion import transformer as jax_tf
from npcd_tpu_torch.models.diffusion import gaussian_diffusion, normalizers, schedule
from npcd_tpu_torch.models.diffusion.transformer import NPCDTransformer, timestep_embedding
from npcd_tpu_torch.utils.from_jax import denoiser_state_dict

TOL = dict(rtol=1e-5, atol=1e-5)
P, C, F = 13, 3, 5  # 13 points + time token = 14 valid of a 16-token sequence


def _tiny_pair(seed=0):
    kw = dict(coords_dim=C, feats_dim=F, width=256, layers=2, heads=4, qkv_groups=2)
    jmod = jax_tf.NPCDTransformer(**kw)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, C, P)), jnp.zeros((1, F, P)),
                       jnp.zeros((1,), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(seed)
    # npcd_tpu zero-inits output_proj; a nonzero one makes eps depend on every layer
    params["output_proj"]["kernel"] = rng.normal(
        scale=0.02, size=params["output_proj"]["kernel"].shape).astype(np.float32)
    tmod = NPCDTransformer(num_points=P, **kw)
    tmod.load_state_dict({k: torch.tensor(v) for k, v in denoiser_state_dict(params).items()})
    return jmod, params, tmod


def _latents(seed=1, n=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, C, P)).astype(np.float32),
            rng.normal(size=(n, F, P)).astype(np.float32),
            np.array([999, 17][:n], np.int32))


def test_denoiser_matches_jax_through_bridge():
    jmod, params, tmod = _tiny_pair()
    coords, feats, t = _latents()
    ref = jmod.apply({"params": params}, jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(t))
    with torch.no_grad():
        got = tmod(torch.from_numpy(coords), torch.from_numpy(feats), torch.from_numpy(t).long())
    assert tmod.seq == 16 and tmod.qkv_groups == 2
    for r, o in zip(ref, got):
        assert np.abs(np.asarray(r)).max() > 1e-3  # the comparison is not of zeros
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)


def test_timestep_embedding_matches_jax():
    # cos first, then sin; the two libraries' exp/sin/cos differ by an ulp,
    # and the phase t * freq reaches 999 rad, whose f32 ulp is 6e-5: 1e-5
    t = np.array([0, 1, 17, 500, 999], np.int32)
    for dim in (32, 33):
        ref = np.asarray(jax_tf.timestep_embedding(jnp.asarray(t), dim))
        got = timestep_embedding(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_schedule_buffers_match_jax():
    ref = jax_schedule.make_schedule()
    got = schedule.make_schedule()
    assert got.num_timesteps == 1000
    for f in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_recip_alphas_cumprod",
              "sqrt_recipm1_alphas_cumprod", "posterior_variance",
              "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("fit", ["fit_unit_gaussian", "fit_minus_one_to_one"])
def test_normalizer_fits_match_jax(fit):
    data = np.random.default_rng(2).normal(size=(4, 300)) * [[1], [2], [3], [0.5]] + 0.3
    ref, got = getattr(jax_norm, fit)(data), getattr(normalizers, fit)(data)
    for f in ("shift", "scale", "min", "max"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    x = np.random.default_rng(3).normal(size=(2, 4, 7)).astype(np.float32)
    np.testing.assert_allclose(
        normalizers.denormalize(got, normalizers.normalize(got, torch.from_numpy(x))).numpy(),
        x, rtol=1e-5, atol=1e-5)
    ident = normalizers.NormalizerStats.identity(4)
    assert float(ident.min) == -np.inf and float(ident.max) == np.inf


def test_p_sample_matches_jax_with_same_draws():
    jmod, params, tmod = _tiny_pair(seed=3)
    coords, feats, _ = _latents(seed=4)
    t = np.array([400, 0], np.int32)  # t = 0 adds no noise
    clip = (-1.5, 1.2)
    rng = jax.random.PRNGKey(7)
    rng_c, rng_f = jax.random.split(rng)
    draws = [np.asarray(jax.random.normal(rng_c, coords.shape)),
             np.asarray(jax.random.normal(rng_f, feats.shape))]
    ref = jax_gd.GaussianDiffusion().p_sample(
        rng, lambda c, f, tt: jmod.apply({"params": params}, c, f, tt),
        jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(t), clip, clip)
    clip_t = tuple(torch.tensor(v) for v in clip)
    with torch.no_grad():
        got = gaussian_diffusion.GaussianDiffusion().p_sample(
            lambda shape: torch.from_numpy(draws.pop(0)), tmod, torch.from_numpy(coords),
            torch.from_numpy(feats), torch.from_numpy(t).long(), clip_t, clip_t)
    for r, o in zip(ref, got):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **TOL)

"""The tiny denoiser the diffusion-diagnostics, trajectory and remat tests
share: npcd_tpu's DiffusionModel and the port's with the same weights (2
layers, width 64, 4 heads of D 16, 16 points, 3 coords + 4 feats,
output_proj drawn nonzero), normalizers fitted on seeded data, and both
processes at T 50; plus the draws npcd_tpu's sampler and bound make,
replayed in order."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from npcd_tpu.models.diffusion import DiffusionModel as JaxDiffusionModel
from npcd_tpu.models.diffusion.gaussian_diffusion import GaussianDiffusion as JaxGaussianDiffusion
from npcd_tpu.models.diffusion.schedule import make_schedule as jax_make_schedule
from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel, DiffusionState
from npcd_tpu_torch.models.diffusion.gaussian_diffusion import GaussianDiffusion
from npcd_tpu_torch.models.diffusion.normalizers import NormalizerStats
from npcd_tpu_torch.models.diffusion.schedule import make_schedule
from npcd_tpu_torch.utils.from_jax import denoiser_state_dict

C, F, P, T = 3, 4, 16, 50
MODEL = dict(coords_dim=C, feats_dim=F, num_points=P, width=64, layers=2, heads=4)


def jax_process():
    return JaxGaussianDiffusion(jax_make_schedule(num_diffusion_steps=T))


def port_process():
    return GaussianDiffusion(make_schedule(num_diffusion_steps=T))


def models(seed=0, jax_kw=None, port_kw=None):
    """(npcd_tpu's model, its DiffusionState, the port's model, its
    DiffusionState), both at T 50 with the same weights and normalizers."""
    jmodel = JaxDiffusionModel(**MODEL, **(jax_kw or {}))
    jmodel.process = jax_process()
    jstate = jmodel.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    params["output_proj"]["kernel"] = rng.normal(
        scale=0.05, size=params["output_proj"]["kernel"].shape).astype(np.float32)
    jstate = jmodel.fit_normalizers(jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                                                 params)),
                                    rng.uniform(-0.6, 0.6, (C, 8 * P)), rng.normal(size=(F, 8 * P)))
    pmodel = DiffusionModel(**MODEL, qkv_groups=jmodel.denoiser.resolved_qkv_groups(),
                            **(port_kw or {}))
    pmodel.process = port_process()
    pmodel.denoiser.load_state_dict({k: torch.from_numpy(np.array(v))
                                     for k, v in denoiser_state_dict(params).items()})
    norms = [NormalizerStats(*(torch.tensor(np.asarray(getattr(n, f)))
                               for f in ("shift", "scale", "min", "max")))
             for n in (jstate.coords_norm, jstate.feats_norm)]
    return jmodel, jstate, pmodel, DiffusionState(*norms)


def replay(draws):
    """A noise function that hands out ``draws`` in order (each checked for
    the shape asked)."""
    draws = list(draws)

    def noise(shape):
        d = draws.pop(0)
        assert d.shape == tuple(shape), (d.shape, shape)
        return torch.from_numpy(np.array(d))

    noise.left = draws
    return noise


def sampler_draws(rng, batch, steps=T):
    """The normal draws of npcd_tpu's p_sample_loop from ``rng``: two a step
    (split, then split again into coords and feats)."""
    def step(r, _):
        r, r_step = jax.random.split(r)
        r_c, r_f = jax.random.split(r_step)
        return r, (jax.random.normal(r_c, (batch, C, P)), jax.random.normal(r_f, (batch, F, P)))

    _, (nc, nf) = jax.lax.scan(step, rng, None, length=steps)
    return [d for pair in zip(np.asarray(nc), np.asarray(nf)) for d in pair]


def generate_draws(rng, sizes, steps=T):
    """The draws of npcd_tpu's DiffusionModel.generate over batches of
    ``sizes``: per batch the start latents, then the sampler's."""
    draws = []
    for bs in sizes:
        rng, rng_batch = jax.random.split(rng)
        rng_c, rng_f, rng_loop = jax.random.split(rng_batch, 3)
        draws += [np.asarray(jax.random.normal(rng_c, (bs, C, P))),
                  np.asarray(jax.random.normal(rng_f, (bs, F, P)))]
        draws += sampler_draws(rng_loop, bs, steps)
    return draws


def bpd_draws(rng, batch, steps=T):
    """The draws of npcd_tpu's calc_bpd_loop: at each t, split(rng, 3),
    then the coords noise and the feats noise."""
    def step(r, _):
        r, r_c, r_f = jax.random.split(r, 3)
        return r, (jax.random.normal(r_c, (batch, C, P)), jax.random.normal(r_f, (batch, F, P)))

    _, (nc, nf) = jax.lax.scan(step, rng, None, length=steps)
    return [d for pair in zip(np.asarray(nc), np.asarray(nf)) for d in pair]


def jax_denoiser(jmodel, jstate):
    return jmodel.denoise_fn(jstate.params)


def latents(seed, batch=2):
    """Normalized-space clouds: coords and feats [batch, C|F, P] in about
    [-1, 1], a few feats past the decoder's +-0.999 edges."""
    rng = np.random.default_rng(seed)
    coords = np.clip(rng.normal(scale=0.5, size=(batch, C, P)), -1, 1).astype(np.float32)
    feats = rng.uniform(-1, 1, (batch, F, P)).astype(np.float32)
    feats[:, 0, :2] = [-1.0, 1.0]
    return coords, feats

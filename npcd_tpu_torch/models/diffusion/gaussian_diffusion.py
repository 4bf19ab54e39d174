"""DDPM over joint (coords, feats) latents: the forward process and the
training loss, and the ancestral sampler. Port of
npcd_tpu/models/diffusion/gaussian_diffusion.py (q_sample, p_losses and the
reverse process). The reverse process is a Python loop over t = T-1 .. 0
(the JAX package runs it as one lax.scan). Every random draw of the sampler
comes from ``noise``, a callable shape -> tensor: by default a
torch.Generator's normal draws, in tests the draws JAX made; the loss takes
its noise as tensors."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .schedule import DiffusionSchedule, extract, make_schedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                     Tuple[torch.Tensor, torch.Tensor]]
NoiseFn = Callable[[Tuple[int, ...]], torch.Tensor]
ClipRange = Optional[Tuple[torch.Tensor, torch.Tensor]]


class PSampleOut(NamedTuple):
    coords: torch.Tensor
    feats: torch.Tensor
    coords_recon: torch.Tensor
    feats_recon: torch.Tensor


class GaussianDiffusion:
    def __init__(self, schedule: Optional[DiffusionSchedule] = None):
        self.schedule = schedule if schedule is not None else make_schedule()

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    def to(self, device) -> "GaussianDiffusion":
        return GaussianDiffusion(self.schedule.to(device))

    def q_sample(self, x_start, t, noise):
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, x_start.dim()) * x_start
                + extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.dim()) * noise)

    def p_losses(self, denoise_fn: DenoiseFn, coords_start, feats_start, t,
                 coords_noise, feats_noise):
        """Joint eps-MSE on coords and feats, each halved so their sum is the
        average -> (loss, {"00_coords_loss", "01_feats_loss"})."""
        coords_t = self.q_sample(coords_start, t, coords_noise)
        feats_t = self.q_sample(feats_start, t, feats_noise)
        eps_coords, eps_feats = denoise_fn(coords_t, feats_t, t)
        coords_loss = ((coords_noise - eps_coords.float()) ** 2 / 2.0).mean()
        feats_loss = ((feats_noise - eps_feats.float()) ** 2 / 2.0).mean()
        return coords_loss + feats_loss, {"00_coords_loss": coords_loss,
                                          "01_feats_loss": feats_loss}

    def q_posterior_mean_variance(self, x_start, x_t, t):
        s = self.schedule
        mean = (extract(s.posterior_mean_coef1, t, x_t.dim()) * x_start
                + extract(s.posterior_mean_coef2, t, x_t.dim()) * x_t)
        return (mean, extract(s.posterior_variance, t, x_t.dim()),
                extract(s.posterior_log_variance_clipped, t, x_t.dim()))

    def predict_xstart_from_eps(self, x_t, t, eps):
        s = self.schedule
        return (extract(s.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t
                - extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.dim()) * eps)

    def _mean_recon(self, x_t, t, eps, clip_range: ClipRange):
        recon = self.predict_xstart_from_eps(x_t, t, eps)
        if clip_range is not None:
            recon = torch.clamp(recon, clip_range[0], clip_range[1])
        mean, _, log_variance = self.q_posterior_mean_variance(recon, x_t, t)
        return mean, log_variance, recon

    def p_mean_variance(self, denoise_fn: DenoiseFn, coords_t, feats_t, t,
                        coords_clip_range: ClipRange = None,
                        feats_clip_range: ClipRange = None):
        eps_coords, eps_feats = denoise_fn(coords_t, feats_t, t)
        c_mean, c_logvar, c_recon = self._mean_recon(coords_t, t, eps_coords, coords_clip_range)
        f_mean, f_logvar, f_recon = self._mean_recon(feats_t, t, eps_feats, feats_clip_range)
        return c_mean, c_logvar, c_recon, f_mean, f_logvar, f_recon

    def p_sample(self, noise: NoiseFn, denoise_fn: DenoiseFn, coords_t, feats_t, t,
                 coords_clip_range: ClipRange = None,
                 feats_clip_range: ClipRange = None) -> PSampleOut:
        """One ancestral step x_t -> x_{t-1}; no noise is added at t == 0,
        but the two normal draws are taken at every step."""
        c_mean, c_logvar, c_recon, f_mean, f_logvar, f_recon = self.p_mean_variance(
            denoise_fn, coords_t, feats_t, t, coords_clip_range, feats_clip_range)
        nonzero = (t != 0).to(coords_t.dtype).reshape(-1, *([1] * (coords_t.dim() - 1)))
        coords_next = c_mean + nonzero * torch.exp(0.5 * c_logvar) * noise(coords_t.shape)
        feats_next = f_mean + nonzero * torch.exp(0.5 * f_logvar) * noise(feats_t.shape)
        return PSampleOut(coords_next, feats_next, c_recon, f_recon)

    @torch.no_grad()
    def p_sample_loop(self, noise: NoiseFn, denoise_fn: DenoiseFn, coords_start,
                      feats_start, coords_clip_range: ClipRange = None,
                      feats_clip_range: ClipRange = None):
        """The full reverse process from (coords_start, feats_start) at
        t = T-1 down to t = 0 -> final (coords, feats)."""
        coords, feats = coords_start, feats_start
        n = coords.shape[0]
        for step in range(self.num_timesteps - 1, -1, -1):
            t = torch.full((n,), step, dtype=torch.long, device=coords.device)
            out = self.p_sample(noise, denoise_fn, coords, feats, t,
                                coords_clip_range, feats_clip_range)
            coords, feats = out.coords, out.feats
        return coords, feats

"""DDPM over joint (coords, feats) latents: the forward process and the
training loss, the ancestral sampler with its optional trajectory, and the
variational bound in bits per dim. Port of
npcd_tpu/models/diffusion/gaussian_diffusion.py. The reverse process and the
bound are Python loops over t = T-1 .. 0 (the JAX package runs each as one
lax.scan). Every random draw of the sampler and of the bound comes from
``noise``, a callable shape -> tensor: by default a torch.Generator's normal
draws, in tests the draws JAX made; the loss takes its noise as tensors."""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ...utils.util import discretized_gaussian_log_likelihood, mean_flat, normal_kl
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


class Trajectory(NamedTuple):
    """The reverse process's kept states, stacked on a leading axis:
    coords_ts and feats_ts hold K+1 (x_T, then the state after the last step
    of each group of ``trajectory_stride`` steps, ending at x_0), the recon
    fields K (each kept step's x0 prediction); K = T / stride."""

    coords_ts: torch.Tensor
    coords_recons: torch.Tensor
    feats_ts: torch.Tensor
    feats_recons: torch.Tensor


class GaussianDiffusion:
    def __init__(self, schedule: Optional[DiffusionSchedule] = None):
        self.schedule = schedule if schedule is not None else make_schedule()

    @property
    def num_timesteps(self) -> int:
        return self.schedule.num_timesteps

    def to(self, device) -> "GaussianDiffusion":
        return GaussianDiffusion(self.schedule.to(device))

    def q_mean_variance(self, x_start, t):
        """Mean, variance and log variance of q(x_t | x_0)."""
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, x_start.dim()) * x_start,
                extract(1.0 - s.alphas_cumprod, t, x_start.dim()),
                extract(s.log_one_minus_alphas_cumprod, t, x_start.dim()))

    def q_sample(self, x_start, t, noise):
        s = self.schedule
        return (extract(s.sqrt_alphas_cumprod, t, x_start.dim()) * x_start
                + extract(s.sqrt_one_minus_alphas_cumprod, t, x_start.dim()) * noise)

    def q_sample_next(self, x_t, t, noise):
        """One forward step x_t -> x_{t+1} with the noise scaled by beta_t
        (not its square root), as npcd_tpu and the reference compute it."""
        s = self.schedule
        return (extract(s.sqrt_one_minus_betas, t, x_t.dim()) * x_t
                + extract(s.betas, t, x_t.dim()) * noise)

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

    def predict_eps_from_xstart(self, x_t, t, x_start):
        s = self.schedule
        return ((extract(s.sqrt_recip_alphas_cumprod, t, x_t.dim()) * x_t - x_start)
                / extract(s.sqrt_recipm1_alphas_cumprod, t, x_t.dim()))

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
                      feats_clip_range: ClipRange = None, return_trajectory: bool = False,
                      trajectory_stride: int = 1):
        """The full reverse process from (coords_start, feats_start) at
        t = T-1 down to t = 0 -> final (coords, feats); with
        ``return_trajectory`` also a ``Trajectory`` of the state and x0
        prediction after the last step of each group of
        ``trajectory_stride`` steps (which must divide T), kept on the
        device. The draws are the same in both modes, so the final sample
        is too."""
        if return_trajectory and self.num_timesteps % trajectory_stride:
            raise ValueError(f"trajectory_stride {trajectory_stride} must divide num_timesteps "
                             f"{self.num_timesteps}")
        coords, feats = coords_start, feats_start
        n = coords.shape[0]
        kept = []
        for i, step in enumerate(range(self.num_timesteps - 1, -1, -1)):
            t = torch.full((n,), step, dtype=torch.long, device=coords.device)
            out = self.p_sample(noise, denoise_fn, coords, feats, t,
                                coords_clip_range, feats_clip_range)
            coords, feats = out.coords, out.feats
            if return_trajectory and (i + 1) % trajectory_stride == 0:
                kept.append(out)
        if not return_trajectory:
            return coords, feats
        trajectory = Trajectory(
            coords_ts=torch.stack([coords_start] + [o.coords for o in kept]),
            coords_recons=torch.stack([o.coords_recon for o in kept]),
            feats_ts=torch.stack([feats_start] + [o.feats for o in kept]),
            feats_recons=torch.stack([o.feats_recon for o in kept]))
        return coords, feats, trajectory

    # -- diagnostics ----------------------------------------------------------

    def _vb_terms_bpd(self, denoise_fn: DenoiseFn, coords_start, coords_t, feats_start,
                      feats_t, t):
        """The bound's term at t in bits per dim, for coords and feats: the
        KL of the model's posterior from the true one for t > 0, the
        discretized decoder NLL at t = 0 -> (vb_coords [N], coords_recon,
        vb_feats [N], feats_recon)."""
        c_mean, c_logvar, c_recon, f_mean, f_logvar, f_recon = self.p_mean_variance(
            denoise_fn, coords_t, feats_t, t)

        def vb(x_start, x_t, mean, logvar):
            true_mean, _, true_logvar = self.q_posterior_mean_variance(x_start, x_t, t)
            kl = mean_flat(normal_kl(true_mean, true_logvar, mean, logvar)) / math.log(2.0)
            nll = -discretized_gaussian_log_likelihood(x_start, means=mean,
                                                       log_scales=0.5 * logvar)
            nll = mean_flat(nll) / math.log(2.0)
            return torch.where(t == 0, nll, kl)

        return (vb(coords_start, coords_t, c_mean, c_logvar), c_recon,
                vb(feats_start, feats_t, f_mean, f_logvar), f_recon)

    @torch.no_grad()
    def calc_bpd_loop(self, noise: NoiseFn, denoise_fn: DenoiseFn, coords_start,
                      feats_start) -> Dict[str, torch.Tensor]:
        """The variational bound over all T timesteps, one denoiser forward
        each; at each t the coords noise is drawn, then the feats noise.
        Returns, for coords and for feats: total_bpd [N], vb [N, T],
        prior_bpd [N], xstart_mse [N, T] and mse [N, T], the t axis ordered
        T-1 .. 0."""
        n = coords_start.shape[0]
        per_t: Dict[str, list] = {k: [] for k in (
            "vb_coords", "vb_feats", "xstart_mse_coords", "xstart_mse_feats", "mse_coords",
            "mse_feats")}
        for step in range(self.num_timesteps - 1, -1, -1):
            t = torch.full((n,), step, dtype=torch.long, device=coords_start.device)
            noise_c = noise(coords_start.shape)
            noise_f = noise(feats_start.shape)
            coords_t = self.q_sample(coords_start, t, noise_c)
            feats_t = self.q_sample(feats_start, t, noise_f)
            vb_c, recon_c, vb_f, recon_f = self._vb_terms_bpd(
                denoise_fn, coords_start, coords_t, feats_start, feats_t, t)
            per_t["vb_coords"].append(vb_c)
            per_t["vb_feats"].append(vb_f)
            per_t["xstart_mse_coords"].append(mean_flat((recon_c - coords_start) ** 2))
            per_t["xstart_mse_feats"].append(mean_flat((recon_f - feats_start) ** 2))
            per_t["mse_coords"].append(mean_flat(
                (self.predict_eps_from_xstart(coords_t, t, recon_c) - noise_c) ** 2))
            per_t["mse_feats"].append(mean_flat(
                (self.predict_eps_from_xstart(feats_t, t, recon_f) - noise_f) ** 2))
        per_t = {k: torch.stack(v, dim=1) for k, v in per_t.items()}  # [N, T]
        out = {}
        for part, x_start in (("coords", coords_start), ("feats", feats_start)):
            prior = self.prior_bpd(x_start)
            out.update({f"total_bpd_{part}": per_t[f"vb_{part}"].sum(dim=1) + prior,
                        f"vb_{part}": per_t[f"vb_{part}"], f"prior_bpd_{part}": prior,
                        f"xstart_mse_{part}": per_t[f"xstart_mse_{part}"],
                        f"mse_{part}": per_t[f"mse_{part}"]})
        return out

    def prior_bpd(self, x_start) -> torch.Tensor:
        """KL of q(x_{T-1} | x_0) from N(0, I) in bits per dim [N]."""
        t = torch.full((x_start.shape[0],), self.num_timesteps - 1, dtype=torch.long,
                       device=x_start.device)
        qt_mean, _, qt_log_variance = self.q_mean_variance(x_start, t)
        return mean_flat(normal_kl(qt_mean, qt_log_variance, 0.0, 0.0)) / math.log(2.0)

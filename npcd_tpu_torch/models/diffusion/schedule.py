"""DDPM noise-schedule buffers. Port of
npcd_tpu/models/diffusion/schedule.py: a linear beta schedule over T steps,
every derived buffer computed in float64 and stored in float32."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def get_beta_schedule(schedule_type: str, *, num_diffusion_steps: int,
                      beta_start: float | None = None,
                      beta_end: float | None = None) -> np.ndarray:
    if schedule_type == "linear":
        scale = 1000.0 / num_diffusion_steps
        beta_start = scale * 0.0001 if beta_start is None else beta_start
        beta_end = scale * 0.02 if beta_end is None else beta_end
        return np.linspace(beta_start, beta_end, num_diffusion_steps, dtype=np.float64)
    raise NotImplementedError(schedule_type)


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """The DDPM buffers the sampler and the training loss read, each f32 of
    shape [T]."""

    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_one_minus_betas: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    log_one_minus_alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])

    def to(self, device) -> "DiffusionSchedule":
        return DiffusionSchedule(**{f.name: getattr(self, f.name).to(device)
                                    for f in dataclasses.fields(self)})


def make_schedule(schedule_type: str = "linear", num_diffusion_steps: int = 1000,
                  beta_start: float | None = None,
                  beta_end: float | None = None) -> DiffusionSchedule:
    betas = get_beta_schedule(schedule_type, num_diffusion_steps=num_diffusion_steps,
                              beta_start=beta_start, beta_end=beta_end)
    if not ((betas > 0).all() and (betas <= 1).all()):
        raise ValueError("betas must lie in (0, 1]")
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.append(1.0, alphas_cumprod[:-1])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    # clipped: the posterior variance is 0 at t = 0
    posterior_log_variance_clipped = np.log(
        np.concatenate([posterior_variance[1:2], posterior_variance[1:]]))
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return DiffusionSchedule(
        betas=f32(betas),
        alphas_cumprod=f32(alphas_cumprod),
        sqrt_one_minus_betas=f32(np.sqrt(1.0 - betas)),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
        log_one_minus_alphas_cumprod=f32(np.log(1.0 - alphas_cumprod)),
        alphas_cumprod_prev=f32(alphas_cumprod_prev),
        sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod)),
        sqrt_recipm1_alphas_cumprod=f32(np.sqrt(1.0 / alphas_cumprod - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(posterior_log_variance_clipped),
        posterior_mean_coef1=f32(betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)),
    )


def extract(buf: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """buf[t] reshaped to broadcast against an [N, ...] tensor of ``ndim`` dims."""
    out = buf[t]
    return out.reshape(out.shape[0], *([1] * (ndim - 1)))

"""Diffusion model facade: denoiser + DDPM process + normalizers. Port of
npcd_tpu/models/diffusion/diffusion_model.py (normalizer fit, training
loss, generation). The denoiser's weights live in the module; the
normalizer stats, which the JAX package keeps beside the params in its
DiffusionState, are a ``DiffusionState`` here."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...utils.util import split_num
from .gaussian_diffusion import GaussianDiffusion, NoiseFn, Trajectory
from .normalizers import (NormalizerStats, denormalize, fit_minus_one_to_one, fit_unit_gaussian,
                          normalize)
from .transformer import NPCDTransformer


def sharded_noise(noise: NoiseFn, mesh) -> NoiseFn:
    """``noise`` drawn for the whole batch (the leading dimension times the
    world), this rank's rows kept."""
    return lambda shape: noise((shape[0] * mesh.world, *shape[1:]))[mesh.rows(
        shape[0] * mesh.world)]


@dataclasses.dataclass(frozen=True)
class DiffusionState:
    coords_norm: NormalizerStats
    feats_norm: NormalizerStats

    @classmethod
    def fit(cls, all_coords, all_feats) -> "DiffusionState":
        """all_coords [coords_dim, num_data], all_feats [feats_dim, num_data]."""
        return cls(fit_unit_gaussian(all_coords), fit_minus_one_to_one(all_feats))


class DiffusionModel(nn.Module):
    def __init__(self, coords_dim: int = 3, feats_dim: int = 32, num_points: int = 512,
                 width: int = 1024, layers: int = 24, heads: int = 16,
                 qkv_groups: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = "full"):
        """``dtype`` (float32 or bfloat16), ``remat`` and ``remat_policy``
        (npcd_tpu's, "full" only) are the denoiser's
        (models/diffusion/transformer.py); the parameters are f32 in either
        dtype."""
        super().__init__()
        self.coords_dim, self.feats_dim, self.num_points = coords_dim, feats_dim, num_points
        self.denoiser = NPCDTransformer(coords_dim, feats_dim, num_points, width, layers,
                                        heads, qkv_groups, dtype, remat, remat_policy)
        self.process = GaussianDiffusion()

    def fit_normalizers(self, all_coords, all_feats) -> DiffusionState:
        """all_coords [coords_dim, num_data], all_feats [feats_dim, num_data]
        (npcd_tpu diffusion_model.py:87-93)."""
        return DiffusionState.fit(all_coords, all_feats)

    def compute_loss(self, state: DiffusionState, coords: torch.Tensor, feats: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None):
        """coords [N, C, P], feats [N, F, P] in latent space -> (loss,
        sub_losses): normalize, noise at t, eps-MSE (npcd_tpu
        diffusion_model.py:102-148). ``draws`` = (t, coords_noise,
        feats_noise) replaces the draws from ``generator`` (t in [0, T), then
        the two normal draws); tests pass the draws npcd_tpu made from its
        per-example fold_in keys."""
        device = coords.device
        coords = normalize(state.coords_norm.to(device), coords)
        feats = normalize(state.feats_norm.to(device), feats)
        if draws is None:
            if generator is None:
                raise ValueError("compute_loss needs a torch.Generator or explicit draws")
            draws = self.loss_draws(coords.shape[0], coords.shape[1:], feats.shape[1:], generator)
        t, coords_noise, feats_noise = draws
        process = self.process.to(device)
        return process.p_losses(self.denoiser, coords, feats, t, coords_noise, feats_noise)

    def loss_draws(self, n: int, coords_shape, feats_shape, generator: torch.Generator):
        """The loss's draws for n examples from ``generator``, in its order:
        t [n] in [0, T), then coords noise [n, *coords_shape] and feats
        noise [n, *feats_shape]."""
        device = generator.device
        return (torch.randint(0, self.process.num_timesteps, (n,), generator=generator,
                              device=device),
                torch.randn((n, *coords_shape), generator=generator, device=device),
                torch.randn((n, *feats_shape), generator=generator, device=device))

    @torch.no_grad()
    def generate_batch(self, state: DiffusionState, batch_size: int, noise: NoiseFn,
                       return_trajectory: bool = False, trajectory_stride: int = 1):
        """One batch through the full sampler: draws the start latents
        (coords, then feats) and then two normal draws per step from
        ``noise``, clips x0 predictions to the normalizer min/max and
        denormalizes -> (coords [B, C, P], feats [B, F, P]); with
        ``return_trajectory`` also the sampler's ``Trajectory`` on the
        device, in normalized latent space."""
        device = next(self.parameters()).device
        state = DiffusionState(state.coords_norm.to(device), state.feats_norm.to(device))
        coords_start = noise((batch_size, self.coords_dim, self.num_points))
        feats_start = noise((batch_size, self.feats_dim, self.num_points))
        out = self.process.to(device).p_sample_loop(
            noise, self.denoiser, coords_start, feats_start,
            coords_clip_range=(state.coords_norm.min[0], state.coords_norm.max[0]),
            feats_clip_range=(state.feats_norm.min[0], state.feats_norm.max[0]),
            return_trajectory=return_trajectory, trajectory_stride=trajectory_stride)
        coords = denormalize(state.coords_norm, out[0])
        feats = denormalize(state.feats_norm, out[1])
        return (coords, feats, out[2]) if return_trajectory else (coords, feats)

    def generate(self, state: DiffusionState, num: int, batch_size: int = 8,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[NoiseFn] = None, return_trajectory: bool = False,
                 trajectory_stride: int = 1, mesh=None):
        """``num`` neural point clouds -> numpy (coords [num, C, P],
        feats [num, F, P]). Draws come from ``noise`` when given, else from
        ``generator`` (a torch.Generator on the model's device). With
        ``return_trajectory`` a third element, the sampler's ``Trajectory``
        in numpy, each field stacked over the batch axis (axis 1) across
        the generate batches, in normalized latent space (only the final
        state is denormalized); ``trajectory_stride`` keeps the state after
        every stride-th step.

        With ``mesh`` (parallel.Mesh) each generate batch runs data-parallel:
        every rank draws the batch's noise for the whole batch and samples
        its own rows, and the clouds (and trajectory) are gathered, so every
        rank returns all ``num``; a batch that does not divide by the world
        runs whole on every rank (npcd_tpu's unsharded tail)."""
        if noise is None:
            if generator is None:
                raise ValueError("generate needs a torch.Generator or a noise function")
            device = next(self.parameters()).device
            noise = lambda shape: torch.randn(shape, generator=generator, device=device)
        coords, feats, trajectories = [], [], []
        for bs in split_num(num, batch_size):
            if mesh is None or bs % mesh.world:
                out = self.generate_batch(state, bs, noise, return_trajectory, trajectory_stride)
                gather = lambda x, dim=0: x.cpu()
            else:
                out = self.generate_batch(state, bs // mesh.world, sharded_noise(noise, mesh),
                                          return_trajectory, trajectory_stride)
                gather = mesh.gather
            coords.append(gather(out[0]).numpy())
            feats.append(gather(out[1]).numpy())
            if return_trajectory:
                trajectories.append(Trajectory(*(gather(x, 1).numpy() for x in out[2])))
        coords, feats = np.concatenate(coords, 0), np.concatenate(feats, 0)
        if not return_trajectory:
            return coords, feats
        return coords, feats, Trajectory(*(np.concatenate(xs, 1) for xs in zip(*trajectories)))

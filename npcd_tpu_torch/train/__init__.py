"""Training: stage 1 (the PointNeRF autodecoder) and stage 2 (the
diffusion model, with the fused AdamW + EMA update)."""
from .diffusion_training import DiffusionTraining, FlatParams
from .fused_update import AdamState, FusedAdamWEma
from .pointnerf_training import PointNeRFTraining

__all__ = ["AdamState", "DiffusionTraining", "FlatParams", "FusedAdamWEma",
           "PointNeRFTraining"]

"""Stage-2 training: the fused AdamW + EMA update and the trainer."""
from .diffusion_training import DiffusionTraining, FlatParams
from .fused_update import AdamState, FusedAdamWEma

__all__ = ["AdamState", "DiffusionTraining", "FlatParams", "FusedAdamWEma"]

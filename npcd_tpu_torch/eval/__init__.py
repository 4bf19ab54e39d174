"""The evals: FID/KID of generated clouds and PSNR of stage 1."""
from .diffusion_evaluation import DiffusionEvaluation
from .pointnerf_evaluation import PointNeRFEvaluation

__all__ = ["DiffusionEvaluation", "PointNeRFEvaluation"]

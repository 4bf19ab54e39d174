from .pointnerf_loss import PointNeRFLossWeights, pointnerf_loss

__all__ = ["PointNeRFLossWeights", "pointnerf_loss"]

"""Stage-2 data: the latent dataset and the batch loader."""
from .dataset import BatchLoader
from .pointnerf_dataset import PointNeRFDataset

__all__ = ["BatchLoader", "PointNeRFDataset"]

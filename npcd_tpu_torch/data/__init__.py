"""Training data: the stage-1 synthetic dataset, the stage-2 latent
dataset and the batch loader."""
from .dataset import BatchLoader
from .pointnerf_dataset import PointNeRFDataset
from .synthetic import SyntheticNPCTrain, random_cameras

__all__ = ["BatchLoader", "PointNeRFDataset", "SyntheticNPCTrain", "random_cameras"]

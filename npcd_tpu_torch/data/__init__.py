"""Training data: the registry of the datasets a config names (the SRN
datasets, the stage-1 synthetic dataset, the stage-2 latent dataset), the
batch loader, collate and device prefetch."""
from .dataset import BatchLoader, Dataset, collate, get_path, prefetch_to_device
from .factory import create_dataset
from .pointnerf_dataset import PointNeRFDataset
from .registry import get_dataset_class, list_datasets, register_dataset
from .srn import SRNCarsTrain, SRNChairsTrain
from .synthetic import SyntheticNPCTrain, random_cameras

__all__ = ["BatchLoader", "Dataset", "PointNeRFDataset", "SRNCarsTrain", "SRNChairsTrain",
           "SyntheticNPCTrain", "collate", "create_dataset", "get_dataset_class", "get_path",
           "list_datasets", "prefetch_to_device", "random_cameras", "register_dataset"]

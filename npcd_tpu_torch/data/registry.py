"""Dataset registry. Copy of npcd_tpu/data/registry.py: the datasets a
config's ``train_dataset`` names, by class name."""
from __future__ import annotations

from typing import Dict, List, Type

_DATASETS: Dict[str, Type] = {}


def register_dataset(cls):
    _DATASETS[cls.__name__] = cls
    return cls


def get_dataset_class(name: str):
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset {name!r}; available: {sorted(_DATASETS)}")
    return _DATASETS[name]


def list_datasets() -> List[str]:
    return sorted(_DATASETS)

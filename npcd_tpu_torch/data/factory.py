"""Dataset factory. Copy of npcd_tpu/data/factory.py."""
from __future__ import annotations

from .registry import get_dataset_class


def create_dataset(name: str, **kwargs):
    return get_dataset_class(name)(**kwargs)

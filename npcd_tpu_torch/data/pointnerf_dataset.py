"""Stage-2 dataset of stage-1 latents. Port of
npcd_tpu/data/pointnerf_dataset.py: one sample per object, coords [3, P]
and feats [F, P], from the autodecoder's coordinate table and the mean half
of its feature table (read from the bridged .npz, utils/from_jax.py:
``latents.coords_table`` [n_obj, P, 3], ``latents.feats_table``
[n_obj, P, F]). The samples stay two stacked tables; a batch is a gather."""
from __future__ import annotations

from typing import Dict

import numpy as np

from .registry import register_dataset


@register_dataset
class PointNeRFDataset:
    def __init__(self, all_coords, all_feats):
        """all_coords [n_obj, P, 3], all_feats [n_obj, P, F]."""
        self.coords = np.ascontiguousarray(np.asarray(all_coords, np.float32).transpose(0, 2, 1))
        self.feats = np.ascontiguousarray(np.asarray(all_feats, np.float32).transpose(0, 2, 1))

    def __len__(self) -> int:
        return len(self.coords)

    def batch(self, indices) -> Dict[str, np.ndarray]:
        """{coords [n, 3, P], feats [n, F, P]} of the objects ``indices``."""
        return {"coords": self.coords[indices], "feats": self.feats[indices]}

    def get_all_coords(self) -> np.ndarray:
        """[3, n_obj * P], objects one after another."""
        return self.coords.transpose(1, 0, 2).reshape(self.coords.shape[1], -1)

    def get_all_feats(self) -> np.ndarray:
        """[F, n_obj * P], objects one after another."""
        return self.feats.transpose(1, 0, 2).reshape(self.feats.shape[1], -1)

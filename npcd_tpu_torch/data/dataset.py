"""The batch loader of stage 2. Port of npcd_tpu/data/dataset.py's
BatchLoader as stage 2 uses it (shuffled, last partial batch dropped, one
shard): each epoch draws a permutation with ``np.random.default_rng(seed)``,
so the same seed gives the same batch order as npcd_tpu's."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class BatchLoader:
    """Shuffled epochs of full batches over a dataset with ``len`` and
    ``batch(indices)``. Each ``iter()`` is one epoch and draws the next
    permutation; ``epoch_order`` draws it without building batches, which
    lets a resumed run skip the epochs it has done."""

    def __init__(self, dataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        self._rng.shuffle(order)
        return order

    def batches(self, order: np.ndarray, skip: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The batches of one epoch's ``order``, from batch ``skip`` on."""
        for i in range(skip, len(self)):
            yield self.dataset.batch(order[i * self.batch_size:(i + 1) * self.batch_size])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self.batches(self.epoch_order())

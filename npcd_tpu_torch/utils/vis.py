"""Image grids. Port of ``tile_images`` of npcd_tpu/utils/vis.py, numpy
only; the PNG is written by generate_samples.write_png."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np


def tile_images(images: Sequence[np.ndarray], cols: Optional[int] = None) -> np.ndarray:
    """Same-shaped [H, W, 3] arrays into one float32 grid, row-major,
    ``cols`` a row (default ceil(sqrt(n))), the cells past the last image
    white."""
    images = [np.asarray(im, np.float32) for im in images]
    n = len(images)
    cols = cols or math.ceil(math.sqrt(n))
    rows = math.ceil(n / cols)
    h, w, c = images[0].shape
    grid = np.ones((rows * h, cols * w, c), np.float32)
    for i, im in enumerate(images):
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = im
    return grid

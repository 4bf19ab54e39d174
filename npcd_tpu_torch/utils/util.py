"""Small shared helpers of the evals. Port of ``chunks`` and ``psnr`` of
npcd_tpu/utils/util.py (``split_num`` lives in
models/diffusion/diffusion_model.py), and the evals' csv writer."""
from __future__ import annotations

import csv
from typing import Any, Iterable, Iterator, Sequence

import numpy as np


def chunks(lst: Sequence[Any], n: int) -> Iterator[Sequence[Any]]:
    """Successive n-sized chunks of lst."""
    for i in range(0, len(lst), n):
        yield lst[i:i + n]


def write_csv(path: str, header: Sequence[Any], rows: Iterable[Sequence[Any]]) -> None:
    """A header and rows, as the evals write what npcd_tpu writes with pandas
    (the index in the first column)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def psnr(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio over the whole array, the mean squared
    error in float64; inf where the two are equal (skimage's
    peak_signal_noise_ratio, as npcd_tpu's)."""
    pred = np.asarray(pred, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    mse = np.mean((pred - gt) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range ** 2) / mse))

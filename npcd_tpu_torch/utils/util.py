"""Small shared helpers. Port of npcd_tpu/utils/util.py: ``chunks``,
``split_num``, ``set_seed``, ``to_numpy``, ``backend_initializes``,
``count_parameters``, ``psnr`` and the diffusion diagnostics'
``mean_flat``, ``normal_kl``, ``approx_standard_normal_cdf`` and
``discretized_gaussian_log_likelihood``; and the evals' csv writer."""
from __future__ import annotations

import csv
import math
import random
from typing import Any, Iterable, Iterator, List, Sequence

import numpy as np
import torch


def chunks(lst: Sequence[Any], n: int) -> Iterator[Sequence[Any]]:
    """Successive n-sized chunks of lst."""
    for i in range(0, len(lst), n):
        yield lst[i:i + n]


def split_num(num: int, max_size: int) -> List[int]:
    """``num`` in parts of at most ``max_size``."""
    if num <= 0:
        return []
    return [max_size] * (num // max_size) + ([num % max_size] if num % max_size else [])


def set_seed(seed: int) -> None:
    """Seed Python's and numpy's global RNGs, as npcd_tpu seeds them. The
    port's torch draws come from explicit torch.Generators."""
    random.seed(seed)
    np.random.seed(seed)


def to_numpy(tree: Any) -> Any:
    """Tensors in nested dicts, lists and tuples, detached and copied to the
    host as numpy arrays; other leaves through np.asarray, None kept (an
    empty subtree, as jax.tree_util's)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def backend_initializes(timeout_s: float = 300.0) -> bool:
    """True if CUDA initializes in a fresh subprocess within ``timeout_s``.

    A probe in this process cannot be bounded or retried: a driver that
    hangs takes the process with it, and a failed CUDA initialization
    stays failed. A subprocess can be killed, and leaves this process free
    to choose the CPU afterwards. Call before anything initializes CUDA
    here."""
    import subprocess
    import sys

    try:
        r = subprocess.run(
            [sys.executable, "-c", "import torch; torch.cuda.init()"],
            timeout=timeout_s,
            capture_output=True,
        )
        return r.returncode == 0
    except (subprocess.TimeoutExpired, OSError):
        return False


def count_parameters(params: Any) -> int:
    """The elements of a module's parameters, or of the tensors and arrays
    in nested dicts, lists and tuples (None counts 0)."""
    if params is None:
        return 0
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(count_parameters(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_parameters(v) for v in params)
    return int(np.prod(np.shape(params)))


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


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch dimensions."""
    return x.mean(dim=tuple(range(1, x.dim())))


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL divergence between two diagonal gaussians; any argument but one
    may be a Python number (the prior's 0.0)."""
    like = next(a for a in (mean1, logvar1, mean2, logvar2) if isinstance(a, torch.Tensor))
    mean1, logvar1, mean2, logvar2 = (torch.as_tensor(a, dtype=like.dtype, device=like.device)
                                      for a in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of the standard normal CDF."""
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x: torch.Tensor, *, means: torch.Tensor,
                                        log_scales: torch.Tensor) -> torch.Tensor:
    """Log-likelihood of a gaussian discretized to 255 bins in [-1, 1] (the
    DDPM decoder NLL): the bin's CDF difference, the lower tail below
    -0.999 and the upper tail above 0.999, each clipped at 1e-12."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))

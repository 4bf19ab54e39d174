"""K4: batched k-nearest-neighbour search (CUDA C++, ``csrc/knn.cu``).

Replaces npcd_tpu/ops/pallas/knn.py:pallas_knn_t (and its row-major shim
pallas_knn). ``knn`` launches the kernel for CUDA tensors and runs
``knn_plain`` for CPU tensors. Both compute the squared distance directly
as sum((p - x)**2), order neighbours by ascending distance and break ties
towards the lower point index (lax.top_k's order). npcd_tpu's XLA fallback
computes |x|^2 - 2x.p + |p|^2 instead, so near-ties can swap against it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_NAME = "knn"
KERNEL_K = 8  # the kernel's compile-time k, the configs' aggregator k
MAX_POINTS = 4096  # the points of one instance must fit 48 KB of shared memory


def knn_plain(x: torch.Tensor, points: torch.Tensor, k: int):
    """x [I, N, 3], points [I, P, 3] -> (idx [I, N, k] int32,
    d2 [I, N, k] f32); slots past P hold (0, inf)."""
    d2 = ((points[:, None, :, :] - x[:, :, None, :]) ** 2).sum(-1)  # [I, N, P]
    d2, idx = torch.sort(d2, dim=-1, stable=True)
    k_eff = min(k, points.shape[1])
    d2, idx = d2[..., :k_eff], idx[..., :k_eff].to(torch.int32)
    if k_eff < k:
        pad = k - k_eff
        d2 = torch.cat([d2, d2.new_full(d2.shape[:-1] + (pad,), float("inf"))], -1)
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (pad,))], -1)
    return idx, d2


def _lib():
    fn = build.load(_NAME).knn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def knn(x: torch.Tensor, points: torch.Tensor, k: int):
    """k nearest of each instance's points for each query: x [I, N, 3],
    points [I, P, 3] -> (idx [I, N, k] int32, d2 [I, N, k] f32)."""
    what = "knn"
    build.require(x.dim() == 3 and x.shape[-1] == 3 and points.dim() == 3
                  and points.shape[-1] == 3 and points.shape[0] == x.shape[0],
                  what, f"need x [I, N, 3] and points [I, P, 3], got "
                        f"{tuple(x.shape)} and {tuple(points.shape)}")
    if build.route(what, x, points) == "cpu":
        return knn_plain(x, points, k)
    build.require(k == KERNEL_K, what, f"the kernel is built for k = {KERNEL_K}, got {k}")
    build.require(points.shape[1] <= MAX_POINTS, what,
                  f"at most {MAX_POINTS} points per instance, got {points.shape[1]}")
    build.require_f32_contiguous(what, aligned=False, x=x, points=points)
    inst, n, _ = x.shape
    idx = torch.empty((inst, n, k), device=x.device, dtype=torch.int32)
    d2 = torch.empty((inst, n, k), device=x.device, dtype=torch.float32)
    if n:
        err = _lib()(x.data_ptr(), points.data_ptr(), idx.data_ptr(), d2.data_ptr(),
                     inst, n, points.shape[1], k, build.stream_ptr())
        build.check(err, what)
        knn.launches += 1
    return idx, d2


knn.launches = 0

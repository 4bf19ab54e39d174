"""K4: batched k-nearest-neighbour search, and K5: the minimum squared
distance (CUDA C++, ``csrc/knn.cu``).

K4 replaces npcd_tpu/ops/pallas/knn.py:pallas_knn_t (and its row-major
shim pallas_knn), K5 pallas_min_d2_t (and its shim pallas_min_d2). ``knn``
and ``min_d2`` launch their kernels for CUDA tensors and run ``knn_plain``
and ``min_d2_plain`` for CPU tensors. All compute the squared distance
directly as ((dx*dx + dy*dy) + dz*dz), rounded after each operation; K4
orders neighbours by ascending distance and breaks ties towards the lower
point index (lax.top_k's order), so kernel and plain version return the
same indices and distances, bitwise. K4 takes any k from 1 to MAX_K: it
bounds each query's k-th nearest distance in a first sweep over the points
and collects the few points under the bound in a second, then sorts those
into a list of 8, 16 or 32, the smallest that holds k (``csrc/knn.cu``; the
CPU transcription in ``tests/test_torch_knn.py``). Launches count apart by
k: ``launches`` at the configs' k of 8, ``launches_other_k`` at any other. K5 sweeps every pair with
|p|^2 - 2x.p as a filter, keeps its minimum per group of points, and takes
the exact distance only of the points in the groups whose minimum lies
within a proven error bound of the least (``csrc/knn.cu``; the CPU
transcription in ``tests/min_d2_filter.py``). npcd_tpu's XLA fallback
returns |x|^2 - 2x.p + |p|^2 itself, so near-ties can swap against it.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

_NAME = "knn"
CONFIG_K = 8  # the configs' aggregator k
MAX_K = 32  # the kernel's largest k
MAX_POINTS = 4096  # an instance's points in shared memory: 64 KB in K4 and in K5


def knn_plain(x: torch.Tensor, points: torch.Tensor, k: int):
    """x [I, N, 3], points [I, P, 3] -> (idx [I, N, k] int32,
    d2 [I, N, k] f32); slots past P hold (0, inf). The sum is written out
    as ((dx*dx + dy*dy) + dz*dz), the kernel's order, so both give the same
    float. Instances go in chunks, so that the [chunk, N, P] temporaries
    stay near 2**26 elements."""
    inst, n, _ = x.shape
    k_eff = min(k, points.shape[1])
    step = max(1, (1 << 26) // max(1, n * points.shape[1]))
    d2s, idxs = [], []
    for i0 in range(0, inst, step):
        xs, ps = x[i0:i0 + step, :, None, :], points[i0:i0 + step, None, :, :]
        d = [ps[..., c] - xs[..., c] for c in range(3)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        d2, idx = torch.sort(d2, dim=-1, stable=True)
        d2s.append(d2[..., :k_eff])
        idxs.append(idx[..., :k_eff].to(torch.int32))
    d2 = torch.cat(d2s) if d2s else x.new_empty((0, n, k_eff))
    idx = torch.cat(idxs) if idxs else x.new_empty((0, n, k_eff), dtype=torch.int32)
    if k_eff < k:
        pad = k - k_eff
        d2 = torch.cat([d2, d2.new_full(d2.shape[:-1] + (pad,), float("inf"))], -1)
        idx = torch.cat([idx, idx.new_zeros(idx.shape[:-1] + (pad,))], -1)
    return idx, d2


def min_d2_plain(x: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """x [I, N, 3], points [I, P, 3] -> min over p of the squared distance
    [I, N] f32 (inf where P = 0). The sum is written out as
    ((dx*dx + dy*dy) + dz*dz), the kernel's order, so both give the same
    float. Instances go in chunks, so that the [chunk, N, P] temporaries
    stay near 2**26 elements."""
    inst, n, _ = x.shape
    p = points.shape[1]
    out = x.new_full((inst, n), float("inf"))
    if not (n and p):
        return out
    step = max(1, (1 << 26) // (n * p))
    for i0 in range(0, inst, step):
        xs, ps = x[i0:i0 + step, :, None, :], points[i0:i0 + step, None, :, :]
        d = [ps[..., c] - xs[..., c] for c in range(3)]
        out[i0:i0 + step] = (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]).amin(-1)
    return out


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
    build.require(1 <= k <= MAX_K, what, f"the kernel takes k from 1 to {MAX_K}, got {k}")
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
        if k == CONFIG_K:
            knn.launches += 1
        else:
            knn.launches_other_k += 1
    return idx, d2


knn.launches = knn.launches_other_k = 0


def _min_d2_lib():
    fn = build.load(_NAME).min_d2_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def min_d2(x: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Squared distance from each query to the nearest of its instance's
    points: x [I, N, 3], points [I, P, 3] -> [I, N] f32."""
    what = "min_d2"
    build.require(x.dim() == 3 and x.shape[-1] == 3 and points.dim() == 3
                  and points.shape[-1] == 3 and points.shape[0] == x.shape[0],
                  what, f"need x [I, N, 3] and points [I, P, 3], got "
                        f"{tuple(x.shape)} and {tuple(points.shape)}")
    if build.route(what, x, points) == "cpu":
        return min_d2_plain(x, points)
    build.require(points.shape[1] <= MAX_POINTS, what,
                  f"at most {MAX_POINTS} points per instance, got {points.shape[1]}")
    build.require_f32_contiguous(what, aligned=False, x=x, points=points)
    inst, n, _ = x.shape
    out = torch.empty((inst, n), device=x.device, dtype=torch.float32)
    if n:
        err = _min_d2_lib()(x.data_ptr(), points.data_ptr(), out.data_ptr(), inst, n,
                            points.shape[1], build.stream_ptr())
        build.check(err, what)
        min_d2.launches += 1
    return out


min_d2.launches = 0

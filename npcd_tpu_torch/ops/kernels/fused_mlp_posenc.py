"""K6: posenc-fused aggregation MLP + k-weighted sum, forward
(CUDA C++, ``csrc/fused_mlp_posenc.cu``).

Replaces npcd_tpu/ops/pallas/fused_mlp.py:fused_mlp_posenc_wsum, forward
only. ``fused_mlp_posenc_wsum`` launches the kernel for CUDA tensors and
runs ``fused_mlp_posenc_wsum_plain`` for CPU tensors. Same interface as the
TPU kernel: feat_t [I, F, M] gathered neighbour features, pos_t [I, >=4, M]
with x_rel on rows 0-2 and the pair weight w on row 3; pairs of one shading
point are contiguous (pair m belongs to point m // k).
"""
from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ...models.pointnerf.nn_core import apply_mlp, positional_encoding, posenc_dim
from . import build

_NAME = "fused_mlp_posenc"
HIDDEN = 256  # the kernel's layer width (one thread per output column)
PAIRS_PER_BLOCK = 64

Weights = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def fused_mlp_posenc_wsum_plain(feat_t: torch.Tensor, pos_t: torch.Tensor,
                                weights: Weights, k: int, n_freqs: int,
                                freq_mult: float = 1.0,
                                method: str = "anchored") -> torch.Tensor:
    """-> [I, M // k, d_out]: row n = sum_j w[n*k+j] * mlp([feat | x | posenc(x)])
    over the k pairs of point n, the MLP linear in its last layer and
    leaky_relu(0.01) elsewhere (nn_core.apply_mlp)."""
    inst, _, m = feat_t.shape
    x = pos_t[:, :3].transpose(1, 2)  # [I, M, 3]
    h = torch.cat([feat_t.transpose(1, 2),
                   positional_encoding(x, n_freqs, freq_mult, method)], dim=-1)
    out = apply_mlp([{"w": w, "b": b} for w, b in weights], h)  # [I, M, d_out]
    wsum = out * pos_t[:, 3, :, None]
    return wsum.reshape(inst, m // k, k, -1).sum(2)


def _lib():
    fn = build.load(_NAME).fused_mlp_posenc_wsum_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def fused_mlp_posenc_wsum(feat_t: torch.Tensor, pos_t: torch.Tensor,
                          weights: Weights, k: int, n_freqs: int,
                          freq_mult: float = 1.0,
                          method: str = "anchored") -> torch.Tensor:
    """Aggregation MLP with in-kernel positional encoding and the k-neighbour
    weighted reduction: -> [I, M // k, d_out]."""
    what = "fused_mlp_posenc_wsum"
    build.require(feat_t.dim() == 3 and pos_t.dim() == 3
                  and pos_t.shape[0] == feat_t.shape[0]
                  and pos_t.shape[2] == feat_t.shape[2] and pos_t.shape[1] >= 4,
                  what, f"need feat_t [I, F, M] and pos_t [I, >=4, M], got "
                        f"{tuple(feat_t.shape)} and {tuple(pos_t.shape)}")
    inst, f_dim, m = feat_t.shape
    build.require(k > 0 and m % k == 0, what, f"M = {m} is not a multiple of k = {k}")
    build.require(method in ("anchored", "direct", "recurrence"), what,
                  f"unknown posenc method {method!r}")
    d1 = f_dim + posenc_dim(3, n_freqs)
    build.require(weights[0][0].shape[0] == d1, what,
                  f"W1 has {weights[0][0].shape[0]} rows, the input is {d1} wide")
    tensors = [feat_t, pos_t] + [t for wb in weights for t in wb]
    if build.route(what, *tensors) == "cpu":
        return fused_mlp_posenc_wsum_plain(feat_t, pos_t, weights, k, n_freqs,
                                           freq_mult, method)

    build.require(PAIRS_PER_BLOCK % k == 0, what,
                  f"k must divide {PAIRS_PER_BLOCK}, got {k}")
    build.require(method == "anchored", what,
                  f"the kernel computes the 'anchored' posenc, got {method!r}")
    for i, (w, b) in enumerate(weights):
        k_in = d1 if i == 0 else HIDDEN
        build.require(tuple(w.shape) == (k_in, HIDDEN) and tuple(b.shape) == (HIDDEN,),
                      what, f"layer {i} must be [{k_in}, {HIDDEN}] + [{HIDDEN}], got "
                            f"{tuple(w.shape)} + {tuple(b.shape)}")
        build.require_f32_contiguous(what, aligned=False, w=w, b=b)
    build.require_f32_contiguous(what, aligned=False, feat_t=feat_t, pos_t=pos_t)
    params = torch.cat([t.reshape(-1) for wb in weights for t in wb])
    out = torch.empty((inst, m // k, HIDDEN), device=feat_t.device, dtype=torch.float32)
    if m:
        freq_c0 = float(np.float32(freq_mult * math.pi))
        err = _lib()(feat_t.data_ptr(), pos_t.data_ptr(), params.data_ptr(),
                     out.data_ptr(), inst, m, f_dim, pos_t.shape[1], len(weights),
                     n_freqs, freq_c0, k, build.stream_ptr())
        build.check(err, what)
        fused_mlp_posenc_wsum.launches += 1
    return out


fused_mlp_posenc_wsum.launches = 0

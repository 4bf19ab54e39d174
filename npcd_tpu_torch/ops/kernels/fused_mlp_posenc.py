"""K6f/K6b: posenc-fused aggregation MLP + k-weighted sum, forward and
backward (CUDA C++, ``csrc/fused_mlp_posenc.cu``).

Replaces npcd_tpu/ops/pallas/fused_mlp.py:fused_mlp_posenc_wsum: the
forward (_fwd_posenc_kernel) and its VJP (_bwd_posenc_kernel) with
``need_dw=False, need_dp=False``, the aggregator's gradient contract
(npcd_tpu models/pointnerf/aggregator.py:197-211): the pair weights and
x_rel in pos_t get no gradient. ``fused_mlp_posenc_wsum`` is an
``autograd.Function``: its forward saves only its inputs, its backward
recomputes. Each wrapper launches its kernel for CUDA tensors and runs its
plain version (``fused_mlp_posenc_wsum_plain``,
``fused_mlp_posenc_wsum_bwd_plain``) for CPU tensors. Same interface as the
TPU kernel: feat_t [I, F, M] gathered neighbour features, pos_t [I, >=4, M]
with x_rel on rows 0-2 and the pair weight w on row 3; pairs of one shading
point are contiguous (pair m belongs to point m // k).
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ...models.pointnerf.nn_core import apply_mlp, positional_encoding, posenc_dim
from . import build

_NAME = "fused_mlp_posenc"
HIDDEN = 256  # the kernel's layer width (one thread per output column)
PAIRS_PER_BLOCK = 64
MAX_LAYERS = 8  # the backward kernel's per-layer offset tables

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


def fused_mlp_posenc_wsum_bwd_plain(feat_t: torch.Tensor, pos_t: torch.Tensor,
                                    weights: Weights, g: torch.Tensor, k: int,
                                    n_freqs: int, freq_mult: float = 1.0,
                                    method: str = "anchored"):
    """The VJP of ``fused_mlp_posenc_wsum_plain`` for the output cotangent
    g [I, M // k, d_out], pos_t held constant -> (dfeat_t [I, F, M],
    [(dW, db), ...] per layer)."""
    with torch.enable_grad():
        f = feat_t.detach().requires_grad_(True)
        ws = [(w.detach().requires_grad_(True), b.detach().requires_grad_(True))
              for w, b in weights]
        out = fused_mlp_posenc_wsum_plain(f, pos_t.detach(), ws, k, n_freqs, freq_mult,
                                          method)
        grads = torch.autograd.grad(out, [f] + [t for wb in ws for t in wb], g)
    return grads[0], [(grads[1 + 2 * i], grads[2 + 2 * i]) for i in range(len(ws))]


def leaky_kinks(feat_t: torch.Tensor, pos_t: torch.Tensor, weights: Weights, n_freqs: int,
                freq_mult: float = 1.0, method: str = "anchored",
                delta: float = 1e-5) -> torch.Tensor:
    """[I, M] bool: the pairs with a leaky_relu pre-activation within
    ``delta`` of 0 (recomputed in float64). There the derivative steps from
    1 to 0.01, and two f32 forwards that differ in their last bits can take
    different slopes, so a comparison of two backwards leaves those pairs
    out (by zeroing their weight w in pos_t)."""
    x = pos_t[:, :3].transpose(1, 2)
    h = torch.cat([feat_t.transpose(1, 2),
                   positional_encoding(x, n_freqs, freq_mult, method)], dim=-1).double()
    near = torch.zeros(h.shape[:2], dtype=torch.bool, device=h.device)
    for w, b in weights[:-1]:
        z = h @ w.double() + b.double()
        near |= (z.abs() < delta).any(-1)
        h = torch.maximum(z, 0.01 * z)
    return near


def _check(what: str, feat_t, pos_t, weights: Weights, k: int, n_freqs: int,
           method: str) -> str:
    """Shape checks common to both directions -> the route."""
    build.require(feat_t.dim() == 3 and pos_t.dim() == 3
                  and pos_t.shape[0] == feat_t.shape[0]
                  and pos_t.shape[2] == feat_t.shape[2] and pos_t.shape[1] >= 4,
                  what, f"need feat_t [I, F, M] and pos_t [I, >=4, M], got "
                        f"{tuple(feat_t.shape)} and {tuple(pos_t.shape)}")
    m = feat_t.shape[2]
    build.require(k > 0 and m % k == 0, what, f"M = {m} is not a multiple of k = {k}")
    build.require(method in ("anchored", "direct", "recurrence"), what,
                  f"unknown posenc method {method!r}")
    d1 = feat_t.shape[1] + posenc_dim(3, n_freqs)
    build.require(weights[0][0].shape[0] == d1, what,
                  f"W1 has {weights[0][0].shape[0]} rows, the input is {d1} wide")
    return build.route(what, feat_t, pos_t, *[t for wb in weights for t in wb])


def _check_kernel(what: str, feat_t, pos_t, weights: Weights, k: int, method: str) -> None:
    """What the CUDA kernels take beyond ``_check``."""
    d1 = weights[0][0].shape[0]
    build.require(PAIRS_PER_BLOCK % k == 0, what, f"k must divide {PAIRS_PER_BLOCK}, got {k}")
    build.require(method == "anchored", what,
                  f"the kernel computes the 'anchored' posenc, got {method!r}")
    for i, (w, b) in enumerate(weights):
        k_in = d1 if i == 0 else HIDDEN
        build.require(tuple(w.shape) == (k_in, HIDDEN) and tuple(b.shape) == (HIDDEN,),
                      what, f"layer {i} must be [{k_in}, {HIDDEN}] + [{HIDDEN}], got "
                            f"{tuple(w.shape)} + {tuple(b.shape)}")
        build.require_f32_contiguous(what, aligned=False, w=w, b=b)
    build.require_f32_contiguous(what, aligned=False, feat_t=feat_t, pos_t=pos_t)


def _freq_c0(freq_mult: float) -> float:
    return float(np.float32(freq_mult * math.pi))


def _lib():
    fn = build.load(_NAME).fused_mlp_posenc_wsum_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    fn = build.load(_NAME).fused_mlp_posenc_wsum_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _forward(feat_t, pos_t, weights: Weights, k, n_freqs, freq_mult, method) -> torch.Tensor:
    what = "fused_mlp_posenc_wsum"
    if _check(what, feat_t, pos_t, weights, k, n_freqs, method) == "cpu":
        return fused_mlp_posenc_wsum_plain(feat_t, pos_t, weights, k, n_freqs,
                                           freq_mult, method)
    _check_kernel(what, feat_t, pos_t, weights, k, method)
    inst, f_dim, m = feat_t.shape
    params = torch.cat([t.reshape(-1) for wb in weights for t in wb])
    out = torch.empty((inst, m // k, HIDDEN), device=feat_t.device, dtype=torch.float32)
    if m:
        err = _lib()(feat_t.data_ptr(), pos_t.data_ptr(), params.data_ptr(),
                     out.data_ptr(), inst, m, f_dim, pos_t.shape[1], len(weights),
                     n_freqs, _freq_c0(freq_mult), k, build.stream_ptr())
        build.check(err, what)
        fused_mlp_posenc_wsum.launches += 1
    return out


@torch.no_grad()
def fused_mlp_posenc_wsum_bwd(feat_t: torch.Tensor, pos_t: torch.Tensor, weights: Weights,
                              g: torch.Tensor, k: int, n_freqs: int, freq_mult: float = 1.0,
                              method: str = "anchored"):
    """Backward of ``fused_mlp_posenc_wsum`` for the output cotangent
    g [I, M // k, 256]: -> (dfeat_t [I, F, M], [(dW, db), ...] per layer).
    pos_t (x_rel and w) gets no gradient."""
    what = "fused_mlp_posenc_wsum_bwd"
    inst, f_dim, m = feat_t.shape
    if _check(what, feat_t, pos_t, weights, k, n_freqs, method) == "cpu":
        build.route(what, feat_t, g)
        return fused_mlp_posenc_wsum_bwd_plain(feat_t, pos_t, weights, g, k, n_freqs,
                                               freq_mult, method)
    _check_kernel(what, feat_t, pos_t, weights, k, method)
    n_layers = len(weights)
    build.require(2 <= n_layers <= MAX_LAYERS, what,
                  f"the kernel takes 2 to {MAX_LAYERS} layers, got {n_layers}")
    build.require(tuple(g.shape) == (inst, m // k, HIDDEN), what,
                  f"g must be [{inst}, {m // k}, {HIDDEN}], got {tuple(g.shape)}")
    build.require(g.device == feat_t.device, what, "g lies on another device")
    build.require_f32_contiguous(what, aligned=False, g=g)
    params = torch.cat([t.reshape(-1) for wb in weights for t in wb])
    params_t = torch.cat([w.t().contiguous().reshape(-1) for w, _ in weights])
    dfeat_t = torch.empty_like(feat_t)
    dparams = torch.zeros_like(params)
    tiles = inst * (-(-m // PAIRS_PER_BLOCK))
    if tiles:
        # one block per SM: a fixed grid keeps the dW sums in a fixed order
        sms = torch.cuda.get_device_properties(feat_t.device).multi_processor_count
        n_blocks = min(sms, tiles)
        partial = torch.zeros((n_blocks, params.numel()), device=feat_t.device,
                              dtype=torch.float32)
        scratch = torch.empty((n_blocks * (n_layers - 2) * PAIRS_PER_BLOCK * HIDDEN,),
                              device=feat_t.device, dtype=torch.float32)
        err = _bwd_lib()(feat_t.data_ptr(), pos_t.data_ptr(), params.data_ptr(),
                         params_t.data_ptr(), g.data_ptr(), dfeat_t.data_ptr(),
                         dparams.data_ptr(), partial.data_ptr(), scratch.data_ptr(), inst, m,
                         f_dim, pos_t.shape[1], n_layers, n_freqs, _freq_c0(freq_mult), k,
                         n_blocks, params.numel(), build.stream_ptr())
        build.check(err, what)
        fused_mlp_posenc_wsum_bwd.launches += 1
    dws: List[Tuple[torch.Tensor, torch.Tensor]] = []
    off = 0
    for w, b in weights:
        dw = dparams[off:off + w.numel()].view(w.shape)
        off += w.numel()
        dws.append((dw, dparams[off:off + b.numel()].view(b.shape)))
        off += b.numel()
    return dfeat_t, dws


fused_mlp_posenc_wsum_bwd.launches = 0


class _FusedMlpPosencWsum(torch.autograd.Function):
    """Forward saves only its inputs; backward runs K6b (or its plain
    version on the CPU) and returns no gradient for pos_t."""

    @staticmethod
    def forward(ctx, feat_t, pos_t, meta, *flat):
        ctx.meta = meta
        ctx.save_for_backward(feat_t, pos_t, *flat)
        return _forward(feat_t, pos_t, list(zip(flat[::2], flat[1::2])), *meta)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        feat_t, pos_t, *flat = ctx.saved_tensors
        dfeat_t, dws = fused_mlp_posenc_wsum_bwd(
            feat_t, pos_t, list(zip(flat[::2], flat[1::2])), g.contiguous(), *ctx.meta)
        return (dfeat_t, None, None, *[t for dw in dws for t in dw])


def fused_mlp_posenc_wsum(feat_t: torch.Tensor, pos_t: torch.Tensor,
                          weights: Weights, k: int, n_freqs: int,
                          freq_mult: float = 1.0,
                          method: str = "anchored") -> torch.Tensor:
    """Aggregation MLP with in-kernel positional encoding and the k-neighbour
    weighted reduction: -> [I, M // k, d_out]. Differentiable in feat_t and
    the weights; pos_t gets no gradient (the aggregator's contract)."""
    return _FusedMlpPosencWsum.apply(feat_t, pos_t, (k, n_freqs, freq_mult, method),
                                     *[t for wb in weights for t in wb])


fused_mlp_posenc_wsum.launches = 0

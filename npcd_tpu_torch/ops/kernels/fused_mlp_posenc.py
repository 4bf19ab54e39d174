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

Two flavours, chosen by feat_t's dtype: f32, and bf16 (feat_t, the
weights, the output and the cotangent bf16; pos_t f32) with npcd_tpu's bf16
rounding points: x and the octaves rounded to bf16 as layer 1's input, each
layer bf16(bf16(f32 sum) + b), the w-sum in f32 and its result bf16; the
backward keeps the cotangent chain in f32 and rounds the dW and dX operands,
dfeat and, once at the end, dW/db to bf16, and contracts the last layer's dW
over points (npcd_tpu's ``fast_last``). The f32 forward and backward run
their products on the tensor cores in 3xTF32 (``tf::mlp_posenc_wsum``,
``tf::mlp_posenc_wsum_bwd``: each product a_lo b_hi + a_hi b_lo + a_hi b_hi
of tf32 hi + lo splits, ~2**-21 of f32), 64 pairs a block, the last layer
once per point (folded after the w-sum forward; ``fast_last`` and its dX per
point backward); the backward's recompute of the hidden layers, which sets
leaky_relu's slopes, is exact f32 on the CUDA cores. The bf16 kernels run
on the CUDA cores. Every kernel takes any k that divides its block of 64
pairs; each backward recomputes its own forward. Launches count per
flavour: ``launches`` (f32) and ``launches_bf16``.
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
from .fused_mlp import fused_mlp_plain, leaky_bf16, leaky_kinks_bf16, linear_bf16

_NAME = "fused_mlp_posenc"
HIDDEN = 256  # the kernels' layer width
PAIRS_PER_BLOCK = 64  # every kernel's tile of (point, neighbour) pairs
MAX_LAYERS = 8  # the backward kernels' layer limit

Weights = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def fused_mlp_posenc_wsum_plain(feat_t: torch.Tensor, pos_t: torch.Tensor,
                                weights: Weights, k: int, n_freqs: int,
                                freq_mult: float = 1.0,
                                method: str = "anchored") -> torch.Tensor:
    """-> [I, M // k, d_out]: row n = sum_j w[n*k+j] * mlp([feat | x | posenc(x)])
    over the k pairs of point n, the MLP linear in its last layer and
    leaky_relu(0.01) elsewhere (nn_core.apply_mlp)."""
    inst, _, m = feat_t.shape
    h = _layer1_input(feat_t, pos_t, n_freqs, freq_mult, method)
    if feat_t.dtype == torch.bfloat16:
        out = fused_mlp_plain(h, weights).float()  # [I, M, d_out]
        wsum = out * pos_t[:, 3, :, None]
        return wsum.reshape(inst, m // k, k, -1).sum(2).to(torch.bfloat16)
    out = apply_mlp([{"w": w, "b": b} for w, b in weights], h)  # [I, M, d_out]
    wsum = out * pos_t[:, 3, :, None]
    return wsum.reshape(inst, m // k, k, -1).sum(2)


def _layer1_input(feat_t: torch.Tensor, pos_t: torch.Tensor, n_freqs: int, freq_mult: float,
                  method: str) -> torch.Tensor:
    """[feat | x | posenc(x)] [I, M, d1] in feat_t's dtype: x and the
    encoding are computed in f32 and cast (torch.cat would promote bf16
    features to f32)."""
    x = pos_t[:, :3].transpose(1, 2)  # [I, M, 3]
    enc = positional_encoding(x, n_freqs, freq_mult, method)
    return torch.cat([feat_t.transpose(1, 2), enc.to(feat_t.dtype)], dim=-1)


def _bwd_plain_bf16(feat_t, pos_t, weights: Weights, g, k: int, n_freqs: int,
                    freq_mult: float, method: str):
    """The bf16 backward as npcd_tpu's kernel computes it (_bwd_posenc_kernel
    with bf16 weights, need_dw=False, need_dp=False): the cotangent chain in
    f32, gd = bf16(g) into every dW and dX product, db the f32 sum of g, and
    the last layer's dW over points, bf16(sum_j w_j act[n*k+j])^T g_out[n]
    (fast_last)."""
    inst, f_dim, m = feat_t.shape
    n_pts, n = m // k, len(weights)
    hs = [_layer1_input(feat_t, pos_t, n_freqs, freq_mult, method).reshape(inst * m, -1)]
    for w, b in weights[:-1]:  # each layer's bf16 input
        hs.append(leaky_bf16(linear_bf16(hs[-1], w, b)))
    w_pair = pos_t[:, 3].reshape(inst * m, 1)
    g_out = g.float().reshape(inst * n_pts, -1)
    g = g_out.repeat_interleave(k, dim=0) * w_pair  # [I*M, d_out] f32
    dws: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for i in range(n - 1, -1, -1):
        w = weights[i][0]
        if i < n - 1:  # leaky'(z): z > 0 exactly where leaky(z) > 0
            g = g * torch.where(hs[i + 1] > 0, 1.0, 0.01)
        gd = g.to(torch.bfloat16).float()
        if i == n - 1:
            hw = (hs[i].float() * w_pair).reshape(inst * n_pts, k, -1).sum(1)
            dw = hw.to(torch.bfloat16).float().T @ g_out
        else:
            dw = hs[i].float().T @ gd
        dws.append((dw.to(torch.bfloat16), g.sum(0).to(torch.bfloat16)))
        g = gd @ (w.float() if i else w[:f_dim].float()).T
    dfeat_t = g.to(torch.bfloat16).reshape(inst, m, f_dim).transpose(1, 2).contiguous()
    return dfeat_t, dws[::-1]


def fused_mlp_posenc_wsum_bwd_plain(feat_t: torch.Tensor, pos_t: torch.Tensor,
                                    weights: Weights, g: torch.Tensor, k: int,
                                    n_freqs: int, freq_mult: float = 1.0,
                                    method: str = "anchored"):
    """The VJP of ``fused_mlp_posenc_wsum_plain`` for the output cotangent
    g [I, M // k, d_out], pos_t held constant -> (dfeat_t [I, F, M],
    [(dW, db), ...] per layer); in bf16, as the TPU kernel computes it
    (``_bwd_plain_bf16``)."""
    if feat_t.dtype == torch.bfloat16:
        return _bwd_plain_bf16(feat_t, pos_t, weights, g, k, n_freqs, freq_mult, method)
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
    out (by zeroing their weight w in pos_t). For bf16 feat_t, also the
    pairs whose bf16 pre-activation can change sign with the order of an
    f32 sum (``fused_mlp.leaky_kinks_bf16``)."""
    if feat_t.dtype == torch.bfloat16:
        inst, _, m = feat_t.shape
        h = _layer1_input(feat_t, pos_t, n_freqs, freq_mult, method).reshape(inst * m, -1)
        near = leaky_kinks_bf16(h, weights).reshape(inst, m)
        return near | leaky_kinks(feat_t.float(), pos_t, weights, n_freqs, freq_mult, method,
                                  delta)
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


def _check_kernel(what: str, feat_t, pos_t, weights: Weights, k: int, method: str,
                  pairs: int) -> None:
    """What the CUDA kernels take beyond ``_check`` (``pairs``: the
    kernel's block)."""
    d1 = weights[0][0].shape[0]
    build.require(pairs % k == 0, what, f"k must divide {pairs}, got {k}")
    build.require(method == "anchored", what,
                  f"the kernel computes the 'anchored' posenc, got {method!r}")
    dtype = feat_t.dtype
    build.require(dtype in (torch.float32, torch.bfloat16), what,
                  f"feat_t must be float32 or bfloat16, got {dtype}")
    for i, (w, b) in enumerate(weights):
        k_in = d1 if i == 0 else HIDDEN
        build.require(tuple(w.shape) == (k_in, HIDDEN) and tuple(b.shape) == (HIDDEN,),
                      what, f"layer {i} must be [{k_in}, {HIDDEN}] + [{HIDDEN}], got "
                            f"{tuple(w.shape)} + {tuple(b.shape)}")
        build.require(w.dtype == b.dtype == dtype and w.is_contiguous() and b.is_contiguous(),
                      what, f"layer {i} must be contiguous {dtype}, feat_t's dtype")
    build.require(feat_t.is_contiguous(), what, "feat_t must be contiguous")
    build.require_f32_contiguous(what, aligned=False, pos_t=pos_t)


def _freq_c0(freq_mult: float) -> float:
    return float(np.float32(freq_mult * math.pi))


def _suffix(dtype: torch.dtype) -> str:
    return "_bf16" if dtype == torch.bfloat16 else ""


def _lib(dtype: torch.dtype):
    fn = getattr(build.load(_NAME), "fused_mlp_posenc_wsum_fwd" + _suffix(dtype))
    if dtype == torch.bfloat16:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    else:  # and the split weights' scratch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_lib(dtype: torch.dtype):
    fn = getattr(build.load(_NAME), "fused_mlp_posenc_wsum_bwd" + _suffix(dtype))
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _partial_len(d1: int, n_layers: int) -> int:
    """The length of a block's f32 dW/db partial, in the kernel's layout."""
    fn = build.load(_NAME).fused_mlp_posenc_partial_len
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_long
    return fn(d1, n_layers)


def _check_d1(what: str, f32: bool, weights: Weights) -> None:
    d1 = weights[0][0].shape[0]
    build.require(not f32 or d1 <= HIDDEN, what,
                  f"the f32 kernels take a layer-1 input of at most {HIDDEN} columns, got {d1}")


def _wsplit(n_slabs: int, device) -> torch.Tensor:
    """Scratch for ``n_slabs`` k-steps of the weights split into tf32 hi +
    lo: 8 rows x 256 columns x 2 words, 16 KB each."""
    return torch.empty((n_slabs, 8 * HIDDEN * 2), device=device, dtype=torch.int32)


def _forward(feat_t, pos_t, weights: Weights, k, n_freqs, freq_mult, method) -> torch.Tensor:
    what = "fused_mlp_posenc_wsum"
    if _check(what, feat_t, pos_t, weights, k, n_freqs, method) == "cpu":
        return fused_mlp_posenc_wsum_plain(feat_t, pos_t, weights, k, n_freqs,
                                           freq_mult, method)
    f32 = feat_t.dtype == torch.float32
    _check_kernel(what, feat_t, pos_t, weights, k, method, PAIRS_PER_BLOCK)
    _check_d1(what, f32, weights)
    d1 = weights[0][0].shape[0]
    inst, f_dim, m = feat_t.shape
    params = torch.cat([t.reshape(-1) for wb in weights for t in wb])
    out = torch.empty((inst, m // k, HIDDEN), device=feat_t.device, dtype=feat_t.dtype)
    if not m:
        return out
    tail = (inst, m, f_dim, pos_t.shape[1], len(weights), n_freqs, _freq_c0(freq_mult), k,
            build.stream_ptr())
    if f32:  # the weights split into tf32 hi + lo, 16 KB a k-step of 8 rows
        wsplit = _wsplit(-(-d1 // 8) + (len(weights) - 1) * HIDDEN // 8, feat_t.device)
        err = _lib(feat_t.dtype)(feat_t.data_ptr(), pos_t.data_ptr(), params.data_ptr(),
                                 wsplit.data_ptr(), out.data_ptr(), *tail)
    else:
        err = _lib(feat_t.dtype)(feat_t.data_ptr(), pos_t.data_ptr(), params.data_ptr(),
                                 out.data_ptr(), *tail)
    build.check(err, what)
    build.count_launch(fused_mlp_posenc_wsum, feat_t.dtype)
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
    _check_kernel(what, feat_t, pos_t, weights, k, method, PAIRS_PER_BLOCK)
    f32 = feat_t.dtype == torch.float32
    _check_d1(what, f32, weights)
    n_layers = len(weights)
    build.require(2 <= n_layers <= MAX_LAYERS, what,
                  f"the kernel takes 2 to {MAX_LAYERS} layers, got {n_layers}")
    build.require(tuple(g.shape) == (inst, m // k, HIDDEN), what,
                  f"g must be [{inst}, {m // k}, {HIDDEN}], got {tuple(g.shape)}")
    build.require(g.device == feat_t.device and g.dtype == feat_t.dtype and g.is_contiguous(),
                  what, f"g must be a contiguous {feat_t.dtype} on feat_t's device")
    params = torch.cat([t.reshape(-1) for wb in weights for t in wb])
    # the weights as the kernel reads them: f32, W^T of layers L-1 .. 1 and
    # W_0[:F]^T split into tf32 hi + lo; bf16, W^T of every layer
    d1 = weights[0][0].shape[0]
    if f32:
        wt = _wsplit((n_layers - 1) * HIDDEN // 8 + -(-f_dim // 8), feat_t.device)
    else:
        wt = torch.cat([w.t().contiguous().reshape(-1) for w, _ in weights])
    dfeat_t = torch.empty_like(feat_t)
    dparams = torch.zeros_like(params)
    tiles = inst * (-(-m // PAIRS_PER_BLOCK))
    if tiles:
        # one block per SM: a fixed grid keeps the dW sums in a fixed order
        sms = torch.cuda.get_device_properties(feat_t.device).multi_processor_count
        n_blocks = min(sms, tiles)
        n_partial = _partial_len(d1, n_layers) if f32 else params.numel()
        partial = torch.zeros((n_blocks, n_partial), device=feat_t.device, dtype=torch.float32)
        # a block's [64, 256] buffers: the recomputed act_0 .. act_{L-3}, and (f32)
        # the last layer's batch of hw and g_out
        kept = n_layers if f32 else n_layers - 2
        scratch = torch.empty((n_blocks * kept * PAIRS_PER_BLOCK * HIDDEN,),
                              device=feat_t.device, dtype=torch.float32)
        err = _bwd_lib(feat_t.dtype)(feat_t.data_ptr(), pos_t.data_ptr(), params.data_ptr(),
                         wt.data_ptr(), g.data_ptr(), dfeat_t.data_ptr(),
                         dparams.data_ptr(), partial.data_ptr(), scratch.data_ptr(), inst, m,
                         f_dim, pos_t.shape[1], n_layers, n_freqs, _freq_c0(freq_mult), k,
                         n_blocks, n_partial, build.stream_ptr())
        build.check(err, what)
        build.count_launch(fused_mlp_posenc_wsum_bwd, feat_t.dtype)
    dws: List[Tuple[torch.Tensor, torch.Tensor]] = []
    off = 0
    for w, b in weights:
        dw = dparams[off:off + w.numel()].view(w.shape)
        off += w.numel()
        dws.append((dw, dparams[off:off + b.numel()].view(b.shape)))
        off += b.numel()
    return dfeat_t, dws


fused_mlp_posenc_wsum_bwd.launches = fused_mlp_posenc_wsum_bwd.launches_bf16 = 0


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


fused_mlp_posenc_wsum.launches = fused_mlp_posenc_wsum.launches_bf16 = 0

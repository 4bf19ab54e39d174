"""K2: LayerNorm and residual-add + LayerNorm, forward (Triton).

Replaces npcd_tpu/ops/pallas/layer_norm.py:layer_norm (_ln_fwd_kernel) and
layer_norm_residual (_lnres_fwd_kernel), forward only: y = LN(x) and
(r, y) = (x + delta, LN(x + delta)) over the last dim, statistics in f32,
outputs in the input dtype.

What bounds it on the H100: a row of W = 1024 is read once (twice with the
residual) and written once (twice), with ~10 flops per element, so it is
bound by memory bandwidth; at the denoiser's [B*520, 1024] slabs it is also
small enough that launch latency matters. Design: one Triton program per
row with the whole row (BLOCK = next power of two >= W) in registers, so x
and delta are read once and the residual sum is written from registers.
The sequence-pad rows of the denoiser are all zeros: their variance is 0,
rsqrt(eps) stays finite and y = beta.

``layer_norm`` / ``layer_norm_residual`` launch the kernel for CUDA tensors
and run the plain PyTorch versions for CPU tensors. Triton is imported
only when a kernel is launched.
"""
from __future__ import annotations

import functools

import torch

from . import build


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-5, delta: torch.Tensor | None = None):
    """npcd_tpu FusedLayerNorm's XLA path (transformer.py:167-176): returns
    y, or (r, y) when delta is given."""
    r32 = x.float()
    if delta is not None:
        r32 = r32 + delta.float()
    mean = r32.mean(-1, keepdim=True)
    var = ((r32 - mean) ** 2).mean(-1, keepdim=True)
    y = ((r32 - mean) * torch.rsqrt(var + eps) * gamma.float() + beta.float()).to(x.dtype)
    if delta is None:
        return y
    return r32.to(x.dtype), y


@functools.cache
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def ln_fwd(x_ptr, d_ptr, g_ptr, b_ptr, y_ptr, r_ptr, width, eps,
               HAS_RESIDUAL: tl.constexpr, BLOCK: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK)
        in_row = cols < width
        offs = row * width + cols
        x = tl.load(x_ptr + offs, mask=in_row, other=0.0).to(tl.float32)
        if HAS_RESIDUAL:
            x = x + tl.load(d_ptr + offs, mask=in_row, other=0.0).to(tl.float32)
            tl.store(r_ptr + offs, x.to(r_ptr.dtype.element_ty), mask=in_row)
        mean = tl.sum(x, axis=0) / width
        xc = tl.where(in_row, x - mean, 0.0)
        var = tl.sum(xc * xc, axis=0) / width
        rstd = tl.rsqrt(var + eps)
        g = tl.load(g_ptr + cols, mask=in_row, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + cols, mask=in_row, other=0.0).to(tl.float32)
        y = xc * rstd * g + b
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=in_row)

    return triton, ln_fwd


def _check(what, x, gamma, beta, delta=None):
    build.require(x.dim() >= 1 and gamma.shape == (x.shape[-1],)
                  and beta.shape == (x.shape[-1],), what,
                  f"gamma/beta must be [{x.shape[-1]}]")
    if delta is not None:
        build.require(delta.shape == x.shape and delta.dtype == x.dtype, what,
                      "delta must match x in shape and dtype")


def _launch(x, gamma, beta, eps, delta):
    build.require(x.dtype in (torch.float32, torch.bfloat16), "layer_norm",
                  f"unsupported dtype {x.dtype}")
    tensors = [x, gamma, beta] + ([delta] if delta is not None else [])
    for t in tensors:
        build.require(t.is_contiguous(), "layer_norm", "inputs must be contiguous")
    triton, kernel = _kernel()
    width = x.shape[-1]
    rows = x.numel() // width
    y = torch.empty_like(x)
    r = torch.empty_like(x) if delta is not None else y
    block = triton.next_power_of_2(width)
    kernel[(rows,)](x, delta if delta is not None else x, gamma, beta, y, r,
                    width, eps, HAS_RESIDUAL=delta is not None, BLOCK=block,
                    num_warps=min(max(block // 256, 1), 16))
    return r, y


@torch.no_grad()
def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim, f32 statistics, output in x.dtype."""
    _check("layer_norm", x, gamma, beta)
    if build.route("layer_norm", x, gamma, beta) == "cpu":
        return layer_norm_plain(x, gamma, beta, eps)
    _, y = _launch(x, gamma, beta, eps, None)
    layer_norm.launches += 1
    return y


@torch.no_grad()
def layer_norm_residual(x: torch.Tensor, delta: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float = 1e-5):
    """r = x + delta, y = LN(r): returns (r, y)."""
    _check("layer_norm_residual", x, gamma, beta, delta)
    if build.route("layer_norm_residual", x, delta, gamma, beta) == "cpu":
        return layer_norm_plain(x, gamma, beta, eps, delta)
    r, y = _launch(x, gamma, beta, eps, delta)
    layer_norm_residual.launches += 1
    return r, y


layer_norm.launches = 0
layer_norm_residual.launches = 0

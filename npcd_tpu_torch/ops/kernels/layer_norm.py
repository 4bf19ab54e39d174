"""K2: LayerNorm and residual-add + LayerNorm, forward and backward (CUDA
C++, ``csrc/layer_norm.cu``).

Replaces npcd_tpu/ops/pallas/layer_norm.py: layer_norm (_ln_fwd_kernel,
K2a; _ln_bwd_kernel, K2c) and layer_norm_residual (_lnres_fwd_kernel, K2b;
_lnres_bwd_kernel, K2d): y = LN(x) and (r, y) = (x + delta, LN(x + delta))
over the last dim, statistics in f32, outputs in the input dtype. When a
gradient is needed the forward also writes the per-row mean and rstd (f32),
and the backward computes

    dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) [+ gr],
    dxhat = gy * gamma,

with dgamma = sum(gy * xhat) and dbeta = sum(gy) over rows, summed in a
fixed order (no atomics: the sums are deterministic). The residual form
takes both cotangents, gr of r and gy of y, and returns the same dr for x
and for delta.

What bounds it on the H100: a row of W = 1024 is read once (twice with the
residual) and written once (twice), with ~10 flops per element, so forward
and backward are bound by memory bandwidth; the denoiser's f32 [2·520,
1024] slabs of the sampler are so small (8.5 MB, ~2.5 us of HBM) that the
host's cost per launch sets the forward's time. Both directions are CUDA
kernels for f32 and bf16 (one warp per row, the row in registers, shuffle
reductions; see the source's note), bound with ctypes and launched from a
short host path: the C function is looked up once, each output comes from
one allocation, and only the checks the kernel needs run. The backward
runs a persistent grid of the blocks the card holds resident, each warp
keeping its dgamma/dbeta columns across its rows and each block writing
one partial row, which a second kernel of the same call sums. Widths up to
``MAX_WIDTH`` are built; a wider row raises. The sequence-pad rows of the
denoiser are all zeros: their variance is 0, rsqrt(eps) stays finite, y =
beta, and with a zero cotangent their dx is exactly 0.

In bf16 (x, delta and the cotangents bf16, gamma and beta f32) every
kernel loads into f32 and stores in the element type, as npcd_tpu's bf16
kernels do: r = bf16(x + delta) is what the forward writes and the
backward reads, while mean and rstd are those of the unrounded f32 sum, so
the backward recomputes rhat from the bf16 r with the f32 statistics; dx
(dr) is rounded to bf16 once, after gr is added in f32; dgamma and dbeta
are summed in f32. The plain versions do the same. Launches on bf16 inputs
are counted apart, in each wrapper's ``launches_bf16``.

``layer_norm`` / ``layer_norm_residual`` launch the forward kernel for CUDA
tensors (or raise) and run the plain PyTorch versions for CPU tensors;
under autograd they go through a ``torch.autograd.Function`` whose backward
calls ``layer_norm_bwd`` / ``layer_norm_residual_bwd`` (kernel on CUDA,
plain version on the CPU).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

MAX_WIDTH = 2048  # the widest row the kernels take (64 values a lane)
_IO_DTYPES = (torch.float32, torch.bfloat16)


def layer_norm_fwd_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         eps: float = 1e-5, delta: torch.Tensor | None = None):
    """npcd_tpu FusedLayerNorm's XLA path (transformer.py:167-176) ->
    (r, y, mean, rstd); r is x when delta is None, mean/rstd are f32 [rows]."""
    r32 = x.float()
    if delta is not None:
        r32 = r32 + delta.float()
    mean = r32.mean(-1, keepdim=True)
    var = ((r32 - mean) ** 2).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = ((r32 - mean) * rstd * gamma.float() + beta.float()).to(x.dtype)
    r = x if delta is None else r32.to(x.dtype)
    return r, y, mean.reshape(-1), rstd.reshape(-1)


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-5, delta: torch.Tensor | None = None):
    """y, or (r, y) when delta is given."""
    r, y, _, _ = layer_norm_fwd_plain(x, gamma, beta, eps, delta)
    return y if delta is None else (r, y)


def layer_norm_bwd_plain(x: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                         rstd: torch.Tensor, gy: torch.Tensor,
                         gr: torch.Tensor | None = None):
    """The backward of npcd_tpu's _ln_bwd_kernel / _lnres_bwd_kernel:
    x (or r) [..., W], per-row f32 mean/rstd, cotangents gy (and gr) ->
    (dx, dgamma, dbeta). In f32 (float64 when x is float64: the gate that
    holds the kernel's long sums against an exact evaluation)."""
    w = x.shape[-1]
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    x2 = x.reshape(-1, w).to(acc)
    g2 = gy.reshape(-1, w).to(acc)
    xhat = (x2 - mean[:, None]) * rstd[:, None]
    dxhat = g2 * gamma.to(acc)
    m1 = dxhat.sum(-1, keepdim=True) / w
    m2 = (dxhat * xhat).sum(-1, keepdim=True) / w
    dx = rstd[:, None] * (dxhat - m1 - xhat * m2)
    if gr is not None:
        dx = dx + gr.reshape(-1, w).to(acc)
    dgamma = (g2 * xhat).sum(0)
    dbeta = g2.sum(0)
    return dx.to(x.dtype).reshape(x.shape), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


# the ctypes signatures of csrc/layer_norm.cu's C entry points
ARGTYPES = {
    "layer_norm_fwd": [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_int, ctypes.c_void_p],
    "layer_norm_bwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "layer_norm_bwd_blocks": [ctypes.c_int] * 3,
}


@functools.cache
def _c_fn(name: str):
    """A C entry point of csrc/layer_norm.cu, built on first use."""
    fn = getattr(build.load("layer_norm"), name)
    fn.argtypes = ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def _check(what, x, gamma, beta, delta=None):
    width = x.shape[-1] if x.dim() else None
    if width is None or gamma.shape != (width,) or beta.shape != (width,):
        raise ValueError(f"{what}: gamma/beta must be [{width}]")
    if delta is not None and (delta.shape != x.shape or delta.dtype != x.dtype):
        raise ValueError(f"{what}: delta must match x in shape and dtype")


def _launch_fwd(x, gamma, beta, eps, delta, save_stats):
    """The forward kernel on CUDA tensors; the host path is kept short (the
    f32 sampler's launches are host-bound): one condition, one allocation
    per output, the statistics in one."""
    width = x.shape[-1]
    if not (x.dtype in _IO_DTYPES and gamma.dtype == beta.dtype == torch.float32
            and width <= MAX_WIDTH and x.is_contiguous() and gamma.is_contiguous()
            and beta.is_contiguous() and (delta is None or delta.is_contiguous())):
        raise ValueError(
            f"{'layer_norm' if delta is None else 'layer_norm_residual'}: the kernel takes "
            f"contiguous float32 or bfloat16 x and delta, float32 gamma/beta and widths up to "
            f"{MAX_WIDTH}; got x {x.dtype}, gamma {gamma.dtype}, width {width}")
    rows = x.numel() // width
    y = torch.empty_like(x)
    r = x if delta is None else torch.empty_like(x)
    stats = torch.empty((2, rows), device=x.device, dtype=torch.float32) if save_stats else None
    stats_ptr = stats.data_ptr() if save_stats else None
    bf16 = x.dtype == torch.bfloat16
    err = _c_fn("layer_norm_fwd")(
        x.data_ptr(), None if delta is None else delta.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), y.data_ptr(), None if delta is None else r.data_ptr(), stats_ptr,
        None if stats_ptr is None else stats_ptr + 4 * rows, rows, width, eps, bf16,
        build.stream_ptr())
    wrapper = layer_norm if delta is None else layer_norm_residual
    build.check(err, wrapper.__name__)
    build.count_launch(wrapper, x.dtype)
    return (r, y) + ((None, None) if stats is None else tuple(stats.unbind(0)))


def _forward(x, gamma, beta, eps, delta, save_stats):
    what = "layer_norm" if delta is None else "layer_norm_residual"
    tensors = (x, gamma, beta) + ((delta,) if delta is not None else ())
    if build.route(what, *tensors) == "cpu":
        return layer_norm_fwd_plain(x, gamma, beta, eps, delta)
    return _launch_fwd(x, gamma, beta, eps, delta, save_stats)


def layer_norm_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float = 1e-5, delta: torch.Tensor | None = None):
    """K2a (K2b with ``delta``) as the autograd Function's forward runs it,
    with the saved statistics -> (r, y, mean, rstd), mean/rstd f32 [rows];
    counts as a launch of ``layer_norm`` (``layer_norm_residual``)."""
    _check("layer_norm" if delta is None else "layer_norm_residual", x, gamma, beta, delta)
    return _forward(x, gamma, beta, eps, delta, save_stats=True)


def _launch_bwd(wrapper, x, gamma, mean, rstd, gy, gr):
    """The backward kernel on CUDA tensors; the host path is kept short, as
    the forward's: one condition, the cotangents made contiguous only where
    they are not, one allocation for dx, one for dgamma/dbeta, one for the
    partials (as many rows as the C side says its grid takes), one launch."""
    width = x.shape[-1]
    rows = x.numel() // width if width else 0
    if not gy.is_contiguous():
        gy = gy.contiguous()
    if gr is not None and not gr.is_contiguous():
        gr = gr.contiguous()
    if not (x.dtype in _IO_DTYPES and 0 < width <= MAX_WIDTH and x.is_contiguous()
            and gy.dtype == x.dtype and gy.shape == x.shape
            and (gr is None or (gr.dtype == x.dtype and gr.shape == x.shape))
            and gamma.dtype == mean.dtype == rstd.dtype == torch.float32
            and gamma.shape == (width,) and mean.shape == rstd.shape == (rows,)
            and gamma.is_contiguous() and mean.is_contiguous() and rstd.is_contiguous()):
        raise ValueError(
            f"{wrapper.__name__}: the kernel takes contiguous float32 or bfloat16 x, with "
            f"cotangents of its shape and dtype, float32 gamma [width] and mean/rstd [rows], and "
            f"widths up to {MAX_WIDTH}; got x {x.dtype} {tuple(x.shape)}, gy {gy.dtype} "
            f"{tuple(gy.shape)}, gamma {gamma.dtype} {tuple(gamma.shape)}, mean "
            f"{tuple(mean.shape)}")
    bf16 = x.dtype == torch.bfloat16
    blocks = _c_fn("layer_norm_bwd_blocks")(rows, width, bf16)
    if blocks < 0:
        build.check(-blocks, wrapper.__name__)
    dx = torch.empty_like(x)
    out = torch.empty((2, width), device=x.device, dtype=torch.float32)
    part = torch.empty((max(blocks, 1), 2, width), device=x.device, dtype=torch.float32)
    err = _c_fn("layer_norm_bwd")(
        x.data_ptr(), gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(), gy.data_ptr(),
        None if gr is None else gr.data_ptr(), dx.data_ptr(), out.data_ptr(), part.data_ptr(),
        rows, width, blocks, bf16, build.stream_ptr())
    build.check(err, wrapper.__name__)
    build.count_launch(wrapper, x.dtype)
    return dx, out[0], out[1]


def _backward(wrapper, x, gamma, mean, rstd, gy, gr):
    tensors = (x, gamma, mean, rstd, gy) + ((gr,) if gr is not None else ())
    if build.route(wrapper.__name__, *tensors) == "cpu":
        return layer_norm_bwd_plain(x, gamma, mean, rstd, gy, gr)
    return _launch_bwd(wrapper, x, gamma, mean, rstd, gy, gr)


def layer_norm_bwd(x: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, gy: torch.Tensor):
    """K2c: the backward of ``layer_norm`` -> (dx, dgamma, dbeta)."""
    return _backward(layer_norm_bwd, x, gamma, mean, rstd, gy, None)


def layer_norm_residual_bwd(r: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                            rstd: torch.Tensor, gr: torch.Tensor | None, gy: torch.Tensor):
    """K2d: the backward of ``layer_norm_residual`` from the cotangents of
    r (``gr``, None when r is unused) and y -> (dr, dgamma, dbeta); dr is
    the gradient of both x and delta."""
    return _backward(layer_norm_residual_bwd, r, gamma, mean, rstd, gy, gr)


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, delta, eps):
        r, y, mean, rstd = _forward(x, gamma, beta, eps, delta, save_stats=True)
        ctx.save_for_backward(r, gamma, mean, rstd)
        ctx.residual = delta is not None
        ctx.set_materialize_grads(False)
        return (r, y) if ctx.residual else y

    @staticmethod
    def backward(ctx, *grads):
        r, gamma, mean, rstd = ctx.saved_tensors
        gr, gy = grads if ctx.residual else (None, grads[0])
        if gy is None:
            gy = torch.zeros_like(r)
        if ctx.residual:
            dr, dg, db = layer_norm_residual_bwd(r, gamma, mean, rstd, gr, gy)
            return dr, dg, db, dr, None
        dx, dg, db = layer_norm_bwd(r, gamma, mean, rstd, gy)
        return dx, dg, db, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim, f32 statistics, output in x.dtype."""
    _check("layer_norm", x, gamma, beta)
    if _needs_grad(x, gamma, beta):
        return _LayerNorm.apply(x, gamma, beta, None, eps)
    return _forward(x, gamma, beta, eps, None, save_stats=False)[1]


def layer_norm_residual(x: torch.Tensor, delta: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float = 1e-5):
    """r = x + delta, y = LN(r): returns (r, y)."""
    _check("layer_norm_residual", x, gamma, beta, delta)
    if _needs_grad(x, delta, gamma, beta):
        return _LayerNorm.apply(x, gamma, beta, delta, eps)
    r, y, _, _ = _forward(x, gamma, beta, eps, delta, save_stats=False)
    return r, y


layer_norm.launches = layer_norm.launches_bf16 = 0
layer_norm_residual.launches = layer_norm_residual.launches_bf16 = 0
layer_norm_bwd.launches = layer_norm_bwd.launches_bf16 = 0
layer_norm_residual_bwd.launches = layer_norm_residual_bwd.launches_bf16 = 0

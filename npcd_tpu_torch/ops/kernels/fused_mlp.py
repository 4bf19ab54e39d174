"""K7f/K7b: the fused leaky-ReLU MLP stack of the field heads in bf16,
forward and backward (CUDA C++ on the tensor cores, ``csrc/fused_mlp.cu``:
bf16 mma.sync on the layer routines of ``csrc/bf16_mlp.cuh``, which the bf16
K6f and K6b share).

Replaces npcd_tpu/ops/pallas/fused_mlp.py:fused_mlp (_fwd_kernel and, with
its bf16 low-precision backward, _bwd_kernel), which npcd_tpu's
nn_core.apply_mlp reaches for bf16 compute. ``fused_mlp`` is an
``autograd.Function``: its forward saves x and the bf16 weights, its
backward recomputes the layers. The wrappers launch their kernels for CUDA
tensors and run the plain versions (``fused_mlp_plain``,
``fused_mlp_bwd_plain``) for CPU tensors.

Numerics (npcd_tpu's bf16 path, reproduced by both routes):
  * forward: each layer z = bf16(bf16(f32-accumulated h @ W) + b), the
    activation max(z, bf16(z * bf16(0.01))) after every layer but the last;
  * backward: the cotangent chain runs in f32 (leaky' = 1 where z > 0, else
    f32 0.01), every dW and dX product takes bf16-rounded operands and
    accumulates in f32, db is an f32 row sum; dW and db are rounded to bf16
    once, at the end, and dx is the bf16 of the last f32 product.
A product of two bf16 values is exact in f32, so the plain versions compute
each product as ``a.float() @ b.float()``.

The kernels take an input of any width up to MAX_IN (npcd_tpu sends every
bf16 leaky stack up to 512 wide to its kernel; the channel net with view
directions is 256 + 51 = 307 wide): the wrappers pad x with zero columns
and W_0 with zero rows to a multiple of 64 (``_padded_in``), which add
exactly 0 to every sum, and drop dx's and dW_0's pad. Launches at a width
other than 256 count apart, on ``launches_wide``.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from . import build

_NAME = "fused_mlp"
HIDDEN = 256  # the kernels' hidden width
MAX_IN = 512  # the widest input the kernels take
OUT_WIDTHS = (1, 3, HIDDEN)  # the last layer's widths the kernel takes
MAX_LAYERS = 8
TILE = 256  # the backward's rows a tile (its dW products contract over them)
# bf16(0.01): npcd_tpu multiplies a bf16 activation by the weakly typed 0.01,
# which becomes a bf16 constant; torch would multiply by the f32 0.01
LEAKY_BF16 = 0.010009765625

Weights = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def leaky_bf16(z: torch.Tensor) -> torch.Tensor:
    """npcd_tpu's bf16 leaky_relu: max(z, bf16(z * bf16(0.01)))."""
    return torch.maximum(z, z * LEAKY_BF16)


def linear_bf16(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16(bf16(h @ w accumulated in f32) + b) for bf16 h, w and b."""
    return (h.float() @ w.float()).to(torch.bfloat16) + b


def fused_mlp_plain(x: torch.Tensor, weights: Weights) -> torch.Tensor:
    """x [..., d_in] bf16 -> [..., d_out] bf16 through the bf16 layers
    (leaky_relu after every layer but the last)."""
    h = x
    for i, (w, b) in enumerate(weights):
        h = linear_bf16(h, w, b)
        if i < len(weights) - 1:
            h = leaky_bf16(h)
    return h


def fused_mlp_bwd_plain(x: torch.Tensor, weights: Weights, g: torch.Tensor):
    """The backward of ``fused_mlp_plain`` as npcd_tpu's kernel computes it
    in bf16, for the cotangent g [..., d_out] -> (dx bf16, [(dW, db)] bf16)."""
    n = len(weights)
    hs = [x.reshape(-1, x.shape[-1])]  # each layer's bf16 input
    for w, b in weights[:-1]:
        hs.append(leaky_bf16(linear_bf16(hs[-1], w, b)))
    g = g.reshape(-1, g.shape[-1]).float()
    dws: List[Tuple[torch.Tensor, torch.Tensor]] = []
    for i in range(n - 1, -1, -1):
        w = weights[i][0]
        if i < n - 1:  # leaky'(z): z > 0 exactly where leaky(z) > 0
            g = g * torch.where(hs[i + 1] > 0, 1.0, 0.01)
        gd = g.to(torch.bfloat16).float()
        dws.append(((hs[i].float().T @ gd).to(torch.bfloat16), g.sum(0).to(torch.bfloat16)))
        g = gd @ w.float().T
    return g.to(torch.bfloat16).reshape(x.shape), dws[::-1]


def leaky_kinks_bf16(h: torch.Tensor, weights: Weights, rel: float = 4e-6) -> torch.Tensor:
    """[rows] bool: the rows of h [rows, d_in] (the layer-1 input, bf16
    values) with a hidden unit on leaky_relu's kink in bf16: the sign of
    z = bf16(bf16(acc) + b) changes when the f32 sum acc moves by ``rel`` of
    the sum of its terms' magnitudes, as a sum in another order can (acc in
    float64; each layer's input is the bf16 activation). Two correct
    backwards can take slopes 1 and 0.01 there, so a comparison of two
    backwards leaves those rows out."""
    h = h.double()
    near = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
    for w, b in weights[:-1]:
        acc, eps = h @ w.double(), rel * (h.abs() @ w.double().abs())
        b = b.to(torch.bfloat16)
        lo, hi = ((a.float().to(torch.bfloat16) + b) > 0 for a in (acc - eps, acc + eps))
        near |= (lo != hi).any(-1)
        h = leaky_bf16(acc.float().to(torch.bfloat16) + b).double()
    return near


@torch.no_grad()
def slope_flips_bf16(x: torch.Tensor, weights: Weights) -> torch.Tensor:
    """[rows] bool: the rows of x [rows, d_in] where ``fused_mlp`` and
    ``fused_mlp_plain`` take a different leaky_relu slope at a hidden unit:
    the sign of z_l = bf16(bf16(acc) + b), each route's output of the stack
    cut after hidden layer l (a last layer has no activation), differs. Sums
    in another order flip a hidden activation's rounding by an ulp and the
    next layers carry it, so a pre-activation can change sign where
    ``leaky_kinks_bf16``, which moves one layer's sum at a time, does not
    see it; two correct backwards then differ by a whole row's product, so
    a comparison of K7b with its plain version leaves those rows out too.
    All False on the CPU, where both are the plain version."""
    flips = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for l in range(1, len(weights)):
        cut = list(weights[:l])
        flips |= ((fused_mlp(x, cut) > 0) != (fused_mlp_plain(x, cut) > 0)).any(-1)
    return flips


def _check(what: str, x: torch.Tensor, weights: Weights) -> str:
    build.require(x.dtype == torch.bfloat16, what, f"x must be bfloat16, got {x.dtype}")
    build.require(len(weights) >= 1 and weights[0][0].shape[0] == x.shape[-1], what,
                  "the first layer's input width must be x's")
    for w, b in weights:
        build.require(w.dtype == b.dtype == torch.bfloat16, what, "weights must be bfloat16")
    return build.route(what, x, *[t for wb in weights for t in wb])


def _check_kernel(what: str, x: torch.Tensor, weights: Weights) -> None:
    """What the CUDA kernels take: x [rows, d_in <= MAX_IN], 256-wide hidden
    layers, a last layer 1, 3 or 256 wide, at most MAX_LAYERS layers, and a
    hidden or 256-wide first layer where d_in is not 256."""
    n = len(weights)
    d_in = x.shape[-1]
    build.require(x.dim() == 2 and d_in <= MAX_IN and x.is_contiguous(), what,
                  f"x must be a contiguous [rows, <= {MAX_IN}], got {tuple(x.shape)}")
    build.require(n <= MAX_LAYERS, what, f"at most {MAX_LAYERS} layers, got {n}")
    build.require(d_in == HIDDEN or n >= 2 or weights[-1][0].shape[1] == HIDDEN, what,
                  f"an input {d_in} wide needs a hidden or a 256-wide first layer, got "
                  f"{n} layer(s)")
    for i, (w, b) in enumerate(weights):
        d_out = w.shape[1]
        ok = d_out in OUT_WIDTHS if i == n - 1 else d_out == HIDDEN
        k_in = d_in if i == 0 else HIDDEN
        build.require(w.shape[0] == k_in and ok and tuple(b.shape) == (d_out,), what,
                      f"layer {i} must be [{k_in}, {HIDDEN}] (the last [{k_in}, 1, 3 or "
                      f"{HIDDEN}]) with its bias, got {tuple(w.shape)} + {tuple(b.shape)}")


def _padded_in(x: torch.Tensor, weights: Weights):
    """x [rows, d_in] and W_0 padded with zeros to the kernels' input width,
    d_in rounded up to a multiple of 64 -> (x, weights, padded width)."""
    d_in = x.shape[1]
    d_pad = -(-d_in // 64) * 64
    if d_pad == d_in:
        return x, weights, d_in
    w0, b0 = weights[0]
    w0 = torch.cat([w0, w0.new_zeros((d_pad - d_in, w0.shape[1]))])
    return (torch.nn.functional.pad(x, (0, d_pad - d_in)), [(w0, b0)] + list(weights[1:]),
            d_pad)


def _pack(weights: Weights) -> torch.Tensor:
    """params: W_l [k_in, d_out] row-major then b_l per layer, bf16."""
    return torch.cat([t.reshape(-1) for wb in weights for t in wb])


def _fwd_lib():
    fn = build.load(_NAME).fused_mlp_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    fn = build.load(_NAME).fused_mlp_bwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_long] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _scratch_len(n_layers: int, d_out: int) -> int:
    """bf16 elements of a block's scratch in K7b: the kept layer inputs and
    the leaky' mask words."""
    fn = build.load(_NAME).fused_mlp_bwd_scratch_len
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_long
    return int(fn(n_layers, d_out))


def _count(fn, d_in: int) -> None:
    if d_in == HIDDEN:
        fn.launches += 1
    else:
        fn.launches_wide += 1


def _forward(x: torch.Tensor, weights: Weights) -> torch.Tensor:
    what = "fused_mlp"
    if _check(what, x, weights) == "cpu":
        return fused_mlp_plain(x, weights)
    _check_kernel(what, x, weights)
    rows, d_out, d_in = x.shape[0], weights[-1][0].shape[1], x.shape[1]
    xp, wp, d_pad = _padded_in(x, weights)
    params = _pack(wp)
    out = torch.empty((rows, d_out), device=x.device, dtype=torch.bfloat16)
    if rows:
        err = _fwd_lib()(xp.data_ptr(), params.data_ptr(), out.data_ptr(), rows, len(weights),
                         d_out, d_pad, build.stream_ptr())
        build.check(err, what)
        _count(fused_mlp, d_in)
    return out


@torch.no_grad()
def fused_mlp_bwd(x: torch.Tensor, weights: Weights, g: torch.Tensor):
    """Backward of ``fused_mlp`` for the cotangent g [rows, d_out] ->
    (dx [rows, d_in] bf16, [(dW, db), ...] bf16 per layer)."""
    what = "fused_mlp_bwd"
    if _check(what, x, weights) == "cpu":
        build.route(what, x, g)
        return fused_mlp_bwd_plain(x, weights, g)
    _check_kernel(what, x, weights)
    rows, n, d_in = x.shape[0], len(weights), x.shape[1]
    d_out = weights[-1][0].shape[1]
    build.require(tuple(g.shape) == (rows, d_out) and g.dtype == torch.bfloat16
                  and g.is_contiguous() and g.device == x.device, what,
                  f"g must be a contiguous bf16 [{rows}, {d_out}] on x's device")
    xp, wp, d_pad = _padded_in(x, weights)
    params = _pack(wp)
    dx = torch.empty_like(xp)
    dparams = torch.zeros_like(params)
    tiles = -(-rows // TILE)
    if tiles:
        # a fixed grid of one block per SM keeps the dW sums in a fixed order
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        n_blocks = min(sms, tiles)
        stride = -(-params.numel() // 4) * 4  # each block's partial 16-byte aligned
        partial = torch.zeros((n_blocks, stride), device=x.device, dtype=torch.float32)
        scratch = torch.empty((n_blocks * _scratch_len(n, d_out),), device=x.device,
                              dtype=torch.bfloat16)
        err = _bwd_lib()(xp.data_ptr(), params.data_ptr(), g.data_ptr(), dx.data_ptr(),
                         dparams.data_ptr(), partial.data_ptr(), scratch.data_ptr(), rows, n,
                         d_out, d_pad, n_blocks, params.numel(), stride, build.stream_ptr())
        build.check(err, what)
        _count(fused_mlp_bwd, d_in)
    dws: List[Tuple[torch.Tensor, torch.Tensor]] = []
    off = 0
    for w, b in wp:
        dw = dparams[off:off + w.numel()].view(w.shape)
        off += w.numel()
        dws.append((dw, dparams[off:off + b.numel()].view(b.shape)))
        off += b.numel()
    if d_pad != d_in:
        dx = dx[:, :d_in].contiguous()
        dws[0] = (dws[0][0][:d_in], dws[0][1])
    return dx, dws


fused_mlp_bwd.launches = fused_mlp_bwd.launches_wide = 0


class _FusedMlp(torch.autograd.Function):
    """Forward saves x and the bf16 weights; backward runs K7b (or its plain
    version on the CPU), which recomputes the layers."""

    @staticmethod
    def forward(ctx, x, *flat):
        ctx.save_for_backward(x, *flat)
        return _forward(x, list(zip(flat[::2], flat[1::2])))

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *flat = ctx.saved_tensors
        dx, dws = fused_mlp_bwd(x, list(zip(flat[::2], flat[1::2])), g.contiguous())
        return (dx, *[t for dw in dws for t in dw])


def fused_mlp(x: torch.Tensor, weights: Weights) -> torch.Tensor:
    """The bf16 MLP stack over x [rows, d_in] -> [rows, d_out] bf16:
    leaky_relu(0.01) after every layer but the last (nn_core.apply_mlp's
    contract). Differentiable in x and the weights."""
    return _FusedMlp.apply(x, *[t for wb in weights for t in wb])


fused_mlp.launches = fused_mlp.launches_wide = 0

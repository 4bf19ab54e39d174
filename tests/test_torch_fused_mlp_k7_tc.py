"""The port's field-head MLP kernels on the tensor cores (K7f and K7b,
``tc::mlp_fwd`` and ``tc::mlp_bwd`` in ``csrc/fused_mlp.cu``): a
transcription of their arithmetic on the CPU, held against npcd_tpu's Pallas
``fused_mlp`` and its ``jax.vjp`` in interpret mode (bf16 weights, compiled
with XLA's excess precision off so that its bf16 casts round as the TPU
kernel's do).

The transcription follows the kernels: each layer product over 16-deep
k-steps (``_stepped`` of ``tests/test_torch_fused_mlp_bwd_bf16_tc.py``: one
mma.sync.m16n8k16 a step, its exact bf16 products summed into the f32
accumulator with one rounding), npcd_tpu's rounding points (z =
bf16(bf16(acc) + b), act = max(z, bf16(z bf16(0.01))) after every layer but
the last), a last layer 1 or 3 wide on the CUDA cores (a warp per row, lane
l summing columns 8 l .. 8 l + 7 in order, then a butterfly of shuffles).
The backward takes tiles of 256 rows on a simulated grid of 3 blocks (block
b takes tiles b, b + 3, ...; rows past the last are zero in x and g), walks
back with leaky' = 1 or 0.01 (f32) from the recomputed z, gd = bf16(g), dW
over the tile's rows into each block's f32 partial, db in the kernel's
order (dx_epilogue's column sums, and the narrow last layer's), dx =
bf16(gd_0 W_0^T), and sums the partials in block order, rounded to bf16
once. What is left against npcd_tpu is f32 sums in another order.

Tolerances (chip_smoke.py's phase 11): the forward within one bf16 ulp of
each element plus one of the output's scale and at least 99% bitwise
(``_bf16_err``); the backward's outputs each within 1e-2 of its own scale
and dx at least 98% bitwise, the rows on a kink (``leaky_kinks_bf16``) or
where the transcription's and npcd_tpu's forwards take another slope given
a zero cotangent (under 5% of the rows). Read on the CPU, channel_net and
shape_net: the forward 99.85% and 99.89% bitwise (the worst element at 0.15
and 0.29 of its bound); the backward's worst output 4.5e-3 and 3.9e-4 of
its scale, dx 99.51% and 99.99% bitwise, 19 and 12 rows zeroed. A control
with one rounding point removed (z = bf16(acc + b), the f32 sum not rounded
before the bias) reads 40.5% and 40.2% bitwise forward and falls outside."""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops.pallas.fused_mlp import fused_mlp as pallas_mlp
from npcd_tpu_torch.ops.kernels.fused_mlp import LEAKY_BF16, leaky_kinks_bf16
from test_torch_fused_mlp_bf16 import CHANNEL_NET, SHAPE_NET, _bf16, _exact, _forward_close, _j, \
    _mlp
from test_torch_fused_mlp_bwd_bf16_tc import _dx_col_sums, _rnd, _seq_sum, _stepped

ROWS = 900  # tiles of 256: three full and a ragged one of 132, block 0 takes two
TILE, SUB, BLOCKS, HID = 256, 128, 3, 256  # the backward's tile and sub-tile; the grid
REL, DX_SHARE, SHARE = 1e-2, 0.98, 0.99


def _layer(h, w, b, exact_rounding):
    acc = _stepped(h, w)
    return _rnd(_rnd(acc) + b) if exact_rounding else _rnd(acc + b)


def _hidden(x, ws, exact_rounding):
    """Each layer's input h_0 = x .. h_{L-1} and the hidden z_0 .. z_{L-2}."""
    hs, zs = [x], []
    for w, b in ws[:-1]:
        zs.append(_layer(hs[-1], w, b, exact_rounding))
        hs.append(torch.maximum(zs[-1], _rnd(zs[-1] * LEAKY_BF16)))
    return hs, zs


def _narrow(h, w, b, exact_rounding):
    """A last layer 1 or 3 wide: lane l sums its columns 8 l .. 8 l + 7 in
    order (f32; each bf16 product exact), a butterfly over the 32 lanes,
    lane 0's sum."""
    s = torch.zeros(h.shape[0], 32, w.shape[1])
    for c in range(8):
        s = s + h.reshape(-1, 32, 8)[:, :, c, None] * w.reshape(32, 8, -1)[None, :, c]
    for m in (16, 8, 4, 2, 1):
        s = s + s[:, torch.arange(32) ^ m]
    return _rnd(_rnd(s[:, 0]) + b) if exact_rounding else _rnd(s[:, 0] + b)


def _k7f(x, ws, exact_rounding=True):
    """K7f's arithmetic on x [rows, 256] and layers [(W, b)] (f32 tensors of
    bf16 values) -> [rows, d_out] bf16 values in f32."""
    hs, _ = _hidden(x, ws, exact_rounding)
    w, b = ws[-1]
    return _layer(hs[-1], w, b, exact_rounding) if w.shape[1] == HID else \
        _narrow(hs[-1], w, b, exact_rounding)


def _k7b(x, ws, g_out, exact_rounding=True):
    """K7b's arithmetic -> (dx, [(dW, db), ...]) as bf16 values in f32."""
    rows, n, d_out = x.shape[0], len(ws), ws[-1][0].shape[1]
    dx = torch.zeros(rows, HID)
    tiles = list(range(0, rows, TILE))
    partials = []
    for blk in range(min(BLOCKS, len(tiles))):
        dw = [torch.zeros_like(w) for w, _ in ws]
        db = [torch.zeros_like(b) for _, b in ws]
        for r0 in tiles[blk::BLOCKS]:
            valid = min(TILE, rows - r0)
            xt, gt = torch.zeros(TILE, HID), torch.zeros(TILE, d_out)
            xt[:valid], gt[:valid] = x[r0:r0 + valid], g_out[r0:r0 + valid]
            hs, zs = _hidden(xt, ws, exact_rounding)
            if d_out == HID:  # gd_{L-1} = g_out; db by halves of the tile, in row order
                gd = gt
                db[n - 1] = db[n - 1] + (_seq_sum(gt[:SUB]) + _seq_sum(gt[SUB:]))
                top = n - 1
            else:  # the narrow last layer on the CUDA cores
                w = ws[n - 1][0]
                prod = hs[-1][:, :, None] * gt[:, None]  # [TILE, 256, d_out], exact
                dw[n - 1] = dw[n - 1] + (_seq_sum(prod[:SUB].reshape(SUB, -1))
                                         + _seq_sum(prod[SUB:].reshape(SUB, -1))).reshape(w.shape)
                # db by warp 0: lane l sums rows l, l + 32, ... in order, then a butterfly
                lanes = _seq_sum(gt.reshape(TILE // 32, -1)).reshape(32, d_out)
                for m in (16, 8, 4, 2, 1):
                    lanes = lanes + lanes[torch.arange(32) ^ m]
                db[n - 1] = db[n - 1] + lanes[0]
                g = torch.zeros(TILE, HID)
                for o in range(d_out):  # fmaf(G_2, w_2, fmaf(G_1, w_1, G_0 w_0))
                    g = g + gt[:, o, None] * w[:, o]
                if n > 1:
                    g = g * torch.where(zs[n - 2] > 0, 1.0, 0.01)
                    for s in range(2):
                        db[n - 2] = db[n - 2] + _dx_col_sums(g[s * SUB:(s + 1) * SUB])
                gd = _rnd(g)
                top = n - 2
            for l in range(top, -1, -1):
                dw[l] = dw[l] + _stepped(hs[l].T, gd)
                g = _stepped(gd, ws[l][0].T)
                if l:
                    g = g * torch.where(zs[l - 1] > 0, 1.0, 0.01)
                    for s in range(2):
                        db[l - 1] = db[l - 1] + _dx_col_sums(g[s * SUB:(s + 1) * SUB])
                gd = _rnd(g)
            dx[r0:r0 + valid] = gd[:valid]
        partials.append((dw, db))
    sums = []
    for l in range(n):
        dw, db = partials[0][0][l], partials[0][1][l]
        for p in partials[1:]:
            dw, db = dw + p[0][l], db + p[1][l]
        sums.append((_rnd(dw), _rnd(db)))
    return dx, sums


@functools.lru_cache(maxsize=None)
def _case(dims):
    """900 rows of bf16 x, bf16 weights and a seeded bf16 cotangent; the
    Pallas forward and its hidden pre-activations (the stack cut after each
    hidden layer) in interpret mode."""
    rng = np.random.default_rng(len(dims) + 10)
    x = _bf16(rng.normal(size=(ROWS, 256)))
    layers = _mlp(dims, 256, seed=len(dims) + 11)
    g = _bf16(rng.normal(size=(ROWS, dims[-1])))

    def fn(x_, ws):
        with pltpu.force_tpu_interpret_mode():
            return [pallas_mlp(x_, ws[:l], True)[0] for l in range(1, len(ws) + 1)]

    outs = _exact(fn, _j(x[None]), tuple((_j(w), _j(b)) for w, b in layers))
    return x, layers, g, [torch.from_numpy(np.array(o.astype(np.float32))) for o in outs]


@functools.lru_cache(maxsize=None)
def _vjp(dims, g_bytes):
    """npcd_tpu's Pallas VJP of _case(dims)'s forward for the cotangent g
    (its bytes) -> [dx, dW_0, db_0, ...] as f32 tensors."""
    x, layers, g, _ = _case(dims)
    g = np.frombuffer(g_bytes, np.float32).reshape(g.shape)

    def fn(x_, ws, g_):
        with pltpu.force_tpu_interpret_mode():
            return jax.vjp(lambda a, w: pallas_mlp(a, w, True), x_, ws)[1](g_)

    dx, dws = _exact(fn, _j(x[None]), tuple((_j(w), _j(b)) for w, b in layers), _j(g[None]))
    return [torch.from_numpy(np.array(t.astype(np.float32)))
            for t in [dx[0]] + [t for wb in dws for t in wb]]


@pytest.mark.parametrize("exact_rounding", [True, False])
@pytest.mark.parametrize("dims", [CHANNEL_NET, SHAPE_NET])
def test_k7_tensor_core_contract(dims, exact_rounding):
    """At 900 rows, channel_net 256 -> 256 x 4 -> 3 and shape_net 256 ->
    256 -> 1: the transcriptions of K7f and K7b agree with npcd_tpu's Pallas
    forward and VJP by phase 11's gates; without the rounding of the f32 sum
    before the bias the forward does not."""
    x, layers, g, want_outs = _case(dims)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g).clone()
    ws = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]
    out = _k7f(xt, ws, exact_rounding)
    share = float((out == want_outs[-1]).float().mean())
    if not exact_rounding:  # the forward falls outside by its bitwise share
        assert share < SHARE, share
        return
    _forward_close(out, want_outs[-1], bitwise=SHARE)
    # a zero cotangent for the rows on a kink or where the two forwards take
    # another slope
    _, zs = _hidden(xt, ws, exact_rounding)
    skip = leaky_kinks_bf16(xt, ws)
    for z, want_z in zip(zs, want_outs):
        skip |= ((z > 0) != (want_z > 0)).any(-1)
    assert float(skip.float().mean()) < 0.05
    gt[skip] = 0.0
    want = _vjp(dims, gt.numpy().tobytes())
    dx, dws = _k7b(xt, ws, gt, exact_rounding)
    got = [dx] + [t for wb in dws for t in wb]
    rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))
    dx_share = float((got[0] == want[0]).float().mean())
    assert rel <= REL and dx_share >= DX_SHARE, (rel, dx_share)

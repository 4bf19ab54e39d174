"""K1: fused-qkv attention, forward and backward (CUDA C++,
``csrc/fused_qkv_attention.cu``).

Replaces npcd_tpu/ops/pallas/fused_qkv_attention.py:fused_qkv_attention_2d,
its forward (K1f) and its custom_vjp backward (K1b).
``fused_qkv_attention`` launches the forward kernel on CUDA tensors and
runs ``fused_qkv_attention_plain`` on CPU tensors; the plain version is the
einsum formulation of npcd_tpu/ops/attention.py:_einsum_attention. Under
autograd it goes through a ``torch.autograd.Function`` that keeps qkv, the
output and the base-2 log-sum-exp, and whose backward calls
``fused_qkv_attention_bwd`` (kernel on CUDA, plain version on the CPU) for
dqkv in the grouped column order of qkv.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

_NAME = "fused_qkv_attention"
HEAD_DIM = 64  # the kernel's compile-time head dim
LOG2_E = 1.4426950408889634


def split_grouped_qkv(qkv: torch.Tensor, heads: int, groups: int = 1):
    """Split fused qkv [..., 3W] in the grouped [Q|K|V] channel layout
    (``groups`` head groups, each [Q_g|K_g|V_g] with heads contiguous;
    groups=1 is the global [Q|K|V] order) into q, k, v each [..., H, D]."""
    *lead, w3 = qkv.shape
    d = w3 // 3 // heads
    x = qkv.reshape(*lead, groups, 3, heads // groups, d)
    return tuple(x[..., t, :, :].reshape(*lead, heads, d) for t in range(3))


def merge_grouped_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      groups: int = 1) -> torch.Tensor:
    """The inverse of ``split_grouped_qkv``: q, k, v [..., H, D] -> [..., 3W]."""
    *lead, heads, d = q.shape
    parts = [t.reshape(*lead, groups, heads // groups, d) for t in (q, k, v)]
    return torch.stack(parts, dim=-3).reshape(*lead, 3 * heads * d)


def _valid(valid_len, seq):
    return seq if valid_len is None or valid_len >= seq else valid_len


def fused_qkv_attention_plain(qkv: torch.Tensor, heads: int, batch: int, seq: int,
                              valid_len: int | None = None, groups: int = 1,
                              return_lse: bool = False):
    """qkv [B*S, 3W] -> [B*S, W]: softmax attention per head with keys at
    positions >= valid_len masked (npcd_tpu/ops/attention.py:24-36); with
    ``return_lse`` also the base-2 log-sum-exp of the scaled scores
    [B, H, S], the residual the backward reads."""
    w = qkv.shape[-1] // 3
    q, k, v = split_grouped_qkv(qkv.reshape(batch, seq, 3 * w), heads, groups)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(math.sqrt(d))
    logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale).float()
    valid_len = _valid(valid_len, seq)
    if valid_len < seq:
        keep = torch.arange(seq, device=qkv.device) < valid_len
        logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhts,bshc->bthc", weights, v).reshape(batch * seq, w)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1) * LOG2_E


def fused_qkv_attention_bwd_plain(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                                  dout: torch.Tensor, heads: int, batch: int, seq: int,
                                  valid_len: int | None = None,
                                  groups: int = 1) -> torch.Tensor:
    """The backward of npcd_tpu's _bwd_kernel from (qkv, out, base-2 lse,
    dout): p = exp2(s - lse) recomputed, delta = rowsum(dout * out), ds =
    p (dp - delta) -> dqkv [B*S, 3W] in the grouped column order of qkv."""
    w = qkv.shape[-1] // 3
    q, k, v = split_grouped_qkv(qkv.reshape(batch, seq, 3 * w), heads, groups)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    s2 = torch.einsum("bthc,bshc->bhts", q * (scale * LOG2_E), k)
    valid_len = _valid(valid_len, seq)
    if valid_len < seq:
        keep = torch.arange(seq, device=qkv.device) < valid_len
        s2 = torch.where(keep, s2, torch.full_like(s2, -torch.inf))
    p = torch.exp2(s2 - lse[..., None])  # pad keys: exp2(-inf) = 0
    g = dout.reshape(batch, seq, heads, d)
    o = out.reshape(batch, seq, heads, d)
    dp = torch.einsum("bthc,bshc->bhts", g, v)
    delta = (g * o).sum(-1).transpose(1, 2)  # [B, H, S]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhts,bshc->bthc", ds, k) * scale
    dk = torch.einsum("bhts,bthc->bshc", ds, q) * scale
    dv = torch.einsum("bhts,bthc->bshc", p, g)
    return merge_grouped_qkv(dq, dk, dv, groups).reshape(batch * seq, 3 * w)


def _lib():
    lib = build.load(_NAME)
    fwd = lib.fused_qkv_attention_fwd
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.fused_qkv_attention_bwd
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(what, qkv, heads, batch, seq, groups):
    w3 = qkv.shape[-1]
    build.require(qkv.dim() == 2 and qkv.shape[0] == batch * seq and w3 % 3 == 0,
                  what, f"qkv must be [batch*seq, 3W], got {tuple(qkv.shape)}")
    build.require(heads % groups == 0 and (w3 // 3) % heads == 0, what,
                  f"heads {heads} / groups {groups} do not tile W {w3 // 3}")


def _check_kernel(what, qkv, heads, **tensors):
    d = qkv.shape[-1] // 3 // heads
    build.require(d == HEAD_DIM, what, f"the kernel is built for head dim {HEAD_DIM}, got {d}")
    build.require_f32_contiguous(what, qkv=qkv, **tensors)


def fused_qkv_attention_fwd(qkv: torch.Tensor, heads: int, batch: int, seq: int,
                            valid_len: int, groups: int = 1, with_lse: bool = True):
    """K1f as the autograd Function's forward runs it -> (out [B*S, W],
    base-2 lse [B, H, S] or None); counts as a launch of
    ``fused_qkv_attention``."""
    what = "fused_qkv_attention"
    valid_len = _valid(valid_len, seq)
    if build.route(what, qkv) == "cpu":
        return fused_qkv_attention_plain(qkv, heads, batch, seq, valid_len, groups,
                                         return_lse=True) if with_lse else (
            fused_qkv_attention_plain(qkv, heads, batch, seq, valid_len, groups), None)
    _check_kernel(what, qkv, heads)
    w = qkv.shape[-1] // 3
    out = torch.empty((batch * seq, w), device=qkv.device, dtype=torch.float32)
    lse = (torch.empty((batch, heads, seq), device=qkv.device, dtype=torch.float32)
           if with_lse else None)
    scale_log2 = (1.0 / math.sqrt(HEAD_DIM)) * LOG2_E
    err = _lib()[0](qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
                    batch, seq, heads, groups, valid_len, scale_log2, build.stream_ptr())
    build.check(err, what)
    fused_qkv_attention.launches += 1
    return out, lse


def fused_qkv_attention_bwd(qkv: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                            dout: torch.Tensor, heads: int, batch: int, seq: int,
                            valid_len: int | None = None, groups: int = 1) -> torch.Tensor:
    """K1b: dqkv [B*S, 3W] (grouped [Q|K|V] columns, every element written;
    rows of pad keys >= valid_len are 0 in the K and V columns) from the
    forward's qkv, output and base-2 lse [B, H, S], and the output's
    cotangent dout [B*S, W]."""
    what = "fused_qkv_attention_bwd"
    _check(what, qkv, heads, batch, seq, groups)
    w = qkv.shape[-1] // 3
    build.require(out.shape == (batch * seq, w) and dout.shape == out.shape
                  and lse.shape == (batch, heads, seq), what,
                  "out/dout must be [batch*seq, W] and lse [batch, heads, seq]")
    valid_len = _valid(valid_len, seq)
    if build.route(what, qkv, out, lse, dout) == "cpu":
        return fused_qkv_attention_bwd_plain(qkv, out, lse, dout, heads, batch, seq,
                                             valid_len, groups)
    dout = dout.contiguous()
    _check_kernel(what, qkv, heads, out=out, lse=lse, dout=dout)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)
    err = _lib()[1](qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), dqkv.data_ptr(), batch, seq, heads, groups, valid_len,
                    (1.0 / math.sqrt(HEAD_DIM)) * LOG2_E, 1.0 / math.sqrt(HEAD_DIM),
                    build.stream_ptr())
    build.check(err, what)
    fused_qkv_attention_bwd.launches += 1
    return dqkv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, batch, seq, valid_len, groups):
        out, lse = fused_qkv_attention_fwd(qkv, heads, batch, seq, valid_len, groups)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (heads, batch, seq, valid_len, groups)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        return (fused_qkv_attention_bwd(qkv, out, lse, dout, *ctx.args),
                None, None, None, None, None)


def fused_qkv_attention(qkv: torch.Tensor, heads: int, batch: int, seq: int,
                        valid_len: int | None = None,
                        groups: int = 1) -> torch.Tensor:
    """Attention over fused qkv [B*S, 3W] (grouped [Q|K|V] columns) ->
    [B*S, W] head-major; rows batch-major. Pad-query rows (>= valid_len)
    are finite and discarded by the caller."""
    what = "fused_qkv_attention"
    _check(what, qkv, heads, batch, seq, groups)
    valid_len = _valid(valid_len, seq)
    build.require(valid_len > 0, what, "valid_len must be positive")
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _Attention.apply(qkv, heads, batch, seq, valid_len, groups)
    return fused_qkv_attention_fwd(qkv, heads, batch, seq, valid_len, groups,
                                   with_lse=False)[0]


fused_qkv_attention.launches = 0
fused_qkv_attention_bwd.launches = 0

"""K1: fused-qkv attention forward (CUDA C++, ``csrc/fused_qkv_attention.cu``).

Replaces npcd_tpu/ops/pallas/fused_qkv_attention.py:fused_qkv_attention_2d,
forward only. ``fused_qkv_attention`` launches the kernel on CUDA tensors
and runs ``fused_qkv_attention_plain`` on CPU tensors; the plain version is
the einsum formulation of npcd_tpu/ops/attention.py:_einsum_attention.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

_NAME = "fused_qkv_attention"
HEAD_DIM = 64  # the kernel's compile-time head dim


def split_grouped_qkv(qkv: torch.Tensor, heads: int, groups: int = 1):
    """Split fused qkv [..., 3W] in the grouped [Q|K|V] channel layout
    (``groups`` head groups, each [Q_g|K_g|V_g] with heads contiguous;
    groups=1 is the global [Q|K|V] order) into q, k, v each [..., H, D]."""
    *lead, w3 = qkv.shape
    d = w3 // 3 // heads
    x = qkv.reshape(*lead, groups, 3, heads // groups, d)
    return tuple(x[..., t, :, :].reshape(*lead, heads, d) for t in range(3))


def fused_qkv_attention_plain(qkv: torch.Tensor, heads: int, batch: int, seq: int,
                              valid_len: int | None = None,
                              groups: int = 1) -> torch.Tensor:
    """qkv [B*S, 3W] -> [B*S, W]: softmax attention per head with keys at
    positions >= valid_len masked (npcd_tpu/ops/attention.py:24-36)."""
    w = qkv.shape[-1] // 3
    q, k, v = split_grouped_qkv(qkv.reshape(batch, seq, 3 * w), heads, groups)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(math.sqrt(d))
    logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale).float()
    if valid_len is not None and valid_len < seq:
        keep = torch.arange(seq, device=qkv.device) < valid_len
        logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshc->bthc", weights, v).reshape(batch * seq, w)


def _lib():
    lib = build.load(_NAME)
    fn = lib.fused_qkv_attention_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@torch.no_grad()
def fused_qkv_attention(qkv: torch.Tensor, heads: int, batch: int, seq: int,
                        valid_len: int | None = None,
                        groups: int = 1) -> torch.Tensor:
    """Attention over fused qkv [B*S, 3W] (grouped [Q|K|V] columns) ->
    [B*S, W] head-major; rows batch-major. Pad-query rows (>= valid_len)
    are unspecified and discarded by the caller."""
    what = "fused_qkv_attention"
    w3 = qkv.shape[-1]
    build.require(qkv.dim() == 2 and qkv.shape[0] == batch * seq and w3 % 3 == 0,
                  what, f"qkv must be [batch*seq, 3W], got {tuple(qkv.shape)}")
    build.require(heads % groups == 0 and (w3 // 3) % heads == 0, what,
                  f"heads {heads} / groups {groups} do not tile W {w3 // 3}")
    if valid_len is None or valid_len >= seq:
        valid_len = seq
    build.require(valid_len > 0, what, "valid_len must be positive")
    if build.route(what, qkv) == "cpu":
        return fused_qkv_attention_plain(qkv, heads, batch, seq, valid_len, groups)

    d = w3 // 3 // heads
    build.require(d == HEAD_DIM, what, f"the kernel is built for head dim {HEAD_DIM}, got {d}")
    build.require_f32_contiguous(what, qkv=qkv)
    out = torch.empty((batch * seq, w3 // 3), device=qkv.device, dtype=torch.float32)
    scale_log2 = (1.0 / math.sqrt(d)) * 1.4426950408889634
    err = _lib()(qkv.data_ptr(), out.data_ptr(), batch, seq, heads, groups,
                 valid_len, scale_log2, build.stream_ptr())
    build.check(err, what)
    fused_qkv_attention.launches += 1
    return out


fused_qkv_attention.launches = 0

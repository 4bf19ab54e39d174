"""K8: flash attention over [B, S, H, D], forward and backward (CUDA C++,
``csrc/flash_attention.cu``).

Replaces npcd_tpu/ops/pallas/flash_attention.py:flash_attention, its
forward (K8f, ``_attn_kernel``) and its custom_vjp backward (K8b,
``_attn_bwd_kernel``): softmax(Q K^T / sqrt(D)) V per (batch, head) with q,
k, v upcast to f32, the output and the gradients cast to the input dtype
(float32 or bfloat16). ``flash_attention`` launches the forward kernel on
CUDA tensors (head dim 64 or 128; anything else raises) and runs
``flash_attention_plain`` on CPU tensors; under autograd it goes through a
``torch.autograd.Function`` that keeps q, k, v and the forward's base-e
log-sum-exp [B, H, S], and whose backward calls ``flash_attention_bwd``
(kernel on CUDA, ``flash_attention_bwd_plain`` on the CPU, which recomputes
the softmax as the TPU kernel does). f32 inputs run exact f32 on the CUDA
cores; bf16 inputs run on the tensor cores (mma.sync), with P and dS, f32
in the TPU kernel, fed to each product as a bf16 pair hi = bf16(x), lo =
bf16(x - hi) so that the outputs keep the f32 contract (see the source's
note). Launches on bf16 inputs are counted apart, in each wrapper's
``launches_bf16``. It is reached through
``ops.attention.multi_head_attention(impl="pallas" | "auto")``; the
denoiser takes kernel K1.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

_NAME = "flash_attention"
HEAD_DIMS = (64, 128)  # the head dims the kernels are built for


def _softmax_f32(q, k):
    """P = softmax(q k^T / sqrt(D)) [B, H, S, S] from f32 [B, S, H, D]."""
    logits = torch.einsum("bthc,bshc->bhts", q, k) * (1.0 / math.sqrt(q.shape[-1]))
    return torch.softmax(logits, dim=-1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          return_lse: bool = False):
    """npcd_tpu's _attn_kernel: q, k, v [B, S, H, D] upcast to f32,
    softmax(q k^T / sqrt(D)) v cast to q's dtype; with ``return_lse`` also
    the base-e log-sum-exp of the scaled scores [B, H, S]."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    out = torch.einsum("bhts,bshc->bthc", _softmax_f32(q32, k32), v32).to(q.dtype)
    if not return_lse:
        return out
    logits = torch.einsum("bthc,bshc->bhts", q32, k32) * (1.0 / math.sqrt(q.shape[-1]))
    return out, torch.logsumexp(logits, dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              dout: torch.Tensor):
    """npcd_tpu's _attn_bwd_kernel: P recomputed in f32, dV = P^T dO, dP =
    dO V^T, dS = P (dP - rowsum(P dP)) / sqrt(D), dQ = dS K, dK = dS^T Q ->
    (dq, dk, dv) in q's dtype."""
    q32, k32, v32, g = q.float(), k.float(), v.float(), dout.float()
    p = _softmax_f32(q32, k32)
    dv = torch.einsum("bhts,bthc->bshc", p, g)
    dp = torch.einsum("bthc,bshc->bhts", g, v32)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * (1.0 / math.sqrt(q.shape[-1]))
    dq = torch.einsum("bhts,bshc->bthc", ds, k32)
    dk = torch.einsum("bhts,bthc->bshc", ds, q32)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _lib():
    lib = build.load(_NAME)
    fwd = lib.flash_attention_fwd
    fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.flash_attention_bwd
    bwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _check(what, q, k, v):
    build.require(q.dim() == 4 and k.shape == q.shape and v.shape == q.shape, what,
                  f"q, k, v must be one [B, S, H, D] shape, got {tuple(q.shape)}, "
                  f"{tuple(k.shape)}, {tuple(v.shape)}")
    build.require(q.dtype in (torch.float32, torch.bfloat16) and k.dtype == v.dtype == q.dtype,
                  what, f"q, k, v must be float32 or bfloat16 alike, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def _check_kernel(what, q, **tensors):
    build.require(q.shape[-1] in HEAD_DIMS, what,
                  f"the kernels are built for head dims {HEAD_DIMS}, got {q.shape[-1]}")
    build.require_contiguous(what, q.dtype, q=q, **tensors)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K8f as the autograd Function's forward runs it -> (out [B, S, H, D],
    lse [B, H, S] f32); counts as a launch of ``flash_attention``."""
    what = "flash_attention"
    _check(what, q, k, v)
    if build.route(what, q, k, v) == "cpu":
        return flash_attention_plain(q, k, v, return_lse=True)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check_kernel(what, q, k=k, v=v)
    b, s, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    err = _lib()[0](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    b, s, h, d, int(q.dtype == torch.bfloat16), build.stream_ptr())
    build.check(err, what)
    build.count_launch(flash_attention, q.dtype)
    return out, lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor):
    """K8b: (dq, dk, dv) [B, S, H, D] in q's dtype from q, k, v, the
    forward's lse [B, H, S] and the output's cotangent dout (the plain
    version recomputes the softmax and does not read lse)."""
    what = "flash_attention_bwd"
    _check(what, q, k, v)
    b, s, h, d = q.shape
    build.require(dout.shape == q.shape and lse.shape == (b, h, s), what,
                  "dout must be q's shape and lse [B, H, S]")
    if build.route(what, q, k, v, lse, dout) == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout)
    q, k, v, dout = q.contiguous(), k.contiguous(), v.contiguous(), dout.to(q.dtype).contiguous()
    _check_kernel(what, q, k=k, v=v, dout=dout)
    build.require_f32_contiguous(what, lse=lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    err = _lib()[1](q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d,
                    int(q.dtype == torch.bfloat16), build.stream_ptr())
    build.check(err, what)
    build.count_launch(flash_attention_bwd, q.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, lse, dout)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal attention over q, k, v [B, S, H, D] (float32 or bfloat16)
    -> [B, S, H, D] in their dtype, f32 arithmetic inside."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v)
    _check("flash_attention", q, k, v)
    if build.route("flash_attention", q, k, v) == "cpu":
        return flash_attention_plain(q, k, v)
    return flash_attention_fwd(q, k, v)[0]


flash_attention.launches = flash_attention.launches_bf16 = 0
flash_attention_bwd.launches = flash_attention_bwd.launches_bf16 = 0

"""K1: fused-qkv attention, forward and backward (CUDA C++,
``csrc/fused_qkv_attention.cu``), in f32 and bf16.

Replaces npcd_tpu/ops/pallas/fused_qkv_attention.py:fused_qkv_attention_2d,
its forward (K1f) and its custom_vjp backward (K1b).
``fused_qkv_attention`` launches the forward kernel on CUDA tensors and
runs the plain version on CPU tensors: in f32 ``fused_qkv_attention_plain``,
the einsum formulation of npcd_tpu/ops/attention.py:_einsum_attention; in
bf16 ``fused_qkv_attention_bf16_plain``, which rounds to bf16 where the TPU
kernel casts (the csrc file's header lists the points). Under autograd it
goes through a ``torch.autograd.Function`` that keeps qkv, the output (f32
only) and the base-2 log-sum-exp, and whose backward calls
``fused_qkv_attention_bwd`` (kernel on CUDA, plain version on the CPU) for
dqkv in the grouped column order of qkv. The f32 forward and backward
run on the tensor cores in 3xTF32 (every operand split into tf32 hi + lo,
three products summed in f32), the bf16 flavour on the tensor cores at the
TPU kernel's rounding points. Launches on bf16 inputs are counted apart,
in each wrapper's ``launches_bf16``.
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


def _c2(d: int) -> float:
    """bf16(log2(e) / sqrt(d)): the TPU kernel's query scale in bf16."""
    return float(torch.tensor(LOG2_E / math.sqrt(d)).to(torch.bfloat16))


def _base2_scores(q, k, c2: float, seq: int, valid_len: int):
    """s = bf16(q * c2) . k in f32 [B, H, S, S], pad keys at -inf; q, k bf16."""
    s = torch.einsum("bthc,bshc->bhts", (q * c2).float(), k.float())
    if valid_len < seq:
        keep = torch.arange(seq, device=q.device) < valid_len
        s = torch.where(keep, s, torch.full_like(s, -torch.inf))
    return s


def fused_qkv_attention_bf16_plain(qkv: torch.Tensor, heads: int, batch: int, seq: int,
                                   valid_len: int | None = None, groups: int = 1,
                                   return_lse: bool = False):
    """The bf16 flavour of npcd_tpu's _fwd_kernel at its rounding points:
    s = bf16(q * c2) . k, e = bf16(exp2(s - max)), l = the f32 sum of e, out
    = bf16((e . v) / l) [B*S, W]; with ``return_lse`` also lse = max +
    log2(l) [B, H, S] in f32."""
    w = qkv.shape[-1] // 3
    q, k, v = split_grouped_qkv(qkv.reshape(batch, seq, 3 * w), heads, groups)
    s = _base2_scores(q, k, _c2(q.shape[-1]), seq, _valid(valid_len, seq))
    m = s.amax(-1, keepdim=True)
    e = torch.exp2(s - m).to(torch.bfloat16).float()  # pad keys: exp2(-inf) = 0
    lsum = e.sum(-1, keepdim=True)
    o = torch.einsum("bhts,bshc->bthc", e, v.float())
    out = (o / lsum.transpose(1, 2)).to(torch.bfloat16).reshape(batch * seq, w)
    if not return_lse:
        return out
    return out, (m + torch.log2(lsum)).squeeze(-1)


def fused_qkv_attention_bwd_bf16_plain(qkv: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                                       heads: int, batch: int, seq: int,
                                       valid_len: int | None = None,
                                       groups: int = 1) -> torch.Tensor:
    """The bf16 flavour of npcd_tpu's _bwd_kernel: p = exp2(s - lse) in f32,
    dv = bf16(p)^T dout, delta = rowsum(p * dp), ds = bf16(p (dp - delta)),
    dq = bf16(scale ds k), dk = bf16(scale ds^T q), dv rounded -> dqkv
    [B*S, 3W] bf16 in the grouped column order of qkv."""
    w = qkv.shape[-1] // 3
    q, k, v = split_grouped_qkv(qkv.reshape(batch, seq, 3 * w), heads, groups)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    p = torch.exp2(_base2_scores(q, k, _c2(d), seq, _valid(valid_len, seq)) - lse[..., None])
    g = dout.reshape(batch, seq, heads, d).float()
    dv = torch.einsum("bhts,bthc->bshc", p.to(torch.bfloat16).float(), g)
    dp = torch.einsum("bthc,bshc->bhts", g, v.float())
    delta = (p * dp).sum(-1, keepdim=True)
    ds = (p * (dp - delta)).to(torch.bfloat16).float()
    dq = torch.einsum("bhts,bshc->bthc", ds, k.float()) * scale
    dk = torch.einsum("bhts,bthc->bshc", ds, q.float()) * scale
    bf = lambda t: t.to(torch.bfloat16)
    return merge_grouped_qkv(bf(dq), bf(dk), bf(dv), groups).reshape(batch * seq, 3 * w)


def _lib(dtype):
    """(forward, backward) C entry points of the ``dtype`` flavour."""
    lib = build.load(_NAME)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    fwd = getattr(lib, f"fused_qkv_attention_fwd{suffix}")
    fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = getattr(lib, f"fused_qkv_attention_bwd{suffix}")
    bwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2 + [
        ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return fwd, bwd


def _scale_log2(dtype) -> float:
    """The query scale with log2(e) folded in, rounded to bf16 in bf16."""
    return _c2(HEAD_DIM) if dtype == torch.bfloat16 else (1.0 / math.sqrt(HEAD_DIM)) * LOG2_E


def _check(what, qkv, heads, batch, seq, groups):
    w3 = qkv.shape[-1]
    build.require(qkv.dim() == 2 and qkv.shape[0] == batch * seq and w3 % 3 == 0,
                  what, f"qkv must be [batch*seq, 3W], got {tuple(qkv.shape)}")
    build.require(heads % groups == 0 and (w3 // 3) % heads == 0, what,
                  f"heads {heads} / groups {groups} do not tile W {w3 // 3}")


def _check_kernel(what, qkv, heads, lse=None, **tensors):
    """What the kernels take: head dim 64, qkv and the other [rows, W]
    tensors float32 or bfloat16 alike, lse float32, all contiguous and
    16-byte aligned."""
    d = qkv.shape[-1] // 3 // heads
    build.require(d == HEAD_DIM, what, f"the kernel is built for head dim {HEAD_DIM}, got {d}")
    build.require(qkv.dtype in (torch.float32, torch.bfloat16), what,
                  f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    build.require_contiguous(what, qkv.dtype, qkv=qkv, **tensors)
    if lse is not None:
        build.require_f32_contiguous(what, lse=lse)


def fused_qkv_attention_fwd(qkv: torch.Tensor, heads: int, batch: int, seq: int,
                            valid_len: int, groups: int = 1, with_lse: bool = True):
    """K1f as the autograd Function's forward runs it -> (out [B*S, W],
    base-2 lse [B, H, S] or None); counts as a launch of
    ``fused_qkv_attention``."""
    what = "fused_qkv_attention"
    valid_len = _valid(valid_len, seq)
    if build.route(what, qkv) == "cpu":
        plain = (fused_qkv_attention_bf16_plain if qkv.dtype == torch.bfloat16
                 else fused_qkv_attention_plain)
        return plain(qkv, heads, batch, seq, valid_len, groups, return_lse=True) if with_lse \
            else (plain(qkv, heads, batch, seq, valid_len, groups), None)
    _check_kernel(what, qkv, heads)
    w = qkv.shape[-1] // 3
    out = torch.empty((batch * seq, w), device=qkv.device, dtype=qkv.dtype)
    lse = (torch.empty((batch, heads, seq), device=qkv.device, dtype=torch.float32)
           if with_lse else None)
    err = _lib(qkv.dtype)[0](qkv.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None,
                             batch, seq, heads, groups, valid_len, _scale_log2(qkv.dtype),
                             build.stream_ptr())
    build.check(err, what)
    build.count_launch(fused_qkv_attention, qkv.dtype)
    return out, lse


def fused_qkv_attention_bwd(qkv: torch.Tensor, out: torch.Tensor | None, lse: torch.Tensor,
                            dout: torch.Tensor, heads: int, batch: int, seq: int,
                            valid_len: int | None = None, groups: int = 1) -> torch.Tensor:
    """K1b: dqkv [B*S, 3W] (grouped [Q|K|V] columns, every element written;
    rows of pad keys >= valid_len are 0 in the K and V columns) from the
    forward's qkv, output and base-2 lse [B, H, S], and the output's
    cotangent dout [B*S, W]. In bf16 the output is not read (None is
    taken): delta is rowsum(p * dp), as in the TPU kernel."""
    what = "fused_qkv_attention_bwd"
    _check(what, qkv, heads, batch, seq, groups)
    w = qkv.shape[-1] // 3
    bf16 = qkv.dtype == torch.bfloat16
    build.require((bf16 or out is not None and out.shape == (batch * seq, w))
                  and dout.shape == (batch * seq, w) and lse.shape == (batch, heads, seq), what,
                  "out/dout must be [batch*seq, W] and lse [batch, heads, seq]")
    valid_len = _valid(valid_len, seq)
    outs = () if bf16 else (out,)
    if build.route(what, qkv, lse, dout, *outs) == "cpu":
        if bf16:
            return fused_qkv_attention_bwd_bf16_plain(qkv, lse, dout, heads, batch, seq,
                                                      valid_len, groups)
        return fused_qkv_attention_bwd_plain(qkv, out, lse, dout, heads, batch, seq,
                                             valid_len, groups)
    dout = dout.contiguous()
    _check_kernel(what, qkv, heads, lse=lse, dout=dout, **({} if bf16 else {"out": out}))
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)
    err = _lib(qkv.dtype)[1](qkv.data_ptr(), None if bf16 else out.data_ptr(), dout.data_ptr(),
                             lse.data_ptr(), delta.data_ptr(), dqkv.data_ptr(), batch, seq, heads,
                             groups, valid_len, _scale_log2(qkv.dtype), 1.0 / math.sqrt(HEAD_DIM),
                             build.stream_ptr())
    build.check(err, what)
    build.count_launch(fused_qkv_attention_bwd, qkv.dtype)
    return dqkv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, heads, batch, seq, valid_len, groups):
        out, lse = fused_qkv_attention_fwd(qkv, heads, batch, seq, valid_len, groups)
        # the bf16 backward does not read the output
        ctx.save_for_backward(qkv, None if qkv.dtype == torch.bfloat16 else out, lse)
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


fused_qkv_attention.launches = fused_qkv_attention.launches_bf16 = 0
fused_qkv_attention_bwd.launches = fused_qkv_attention_bwd.launches_bf16 = 0

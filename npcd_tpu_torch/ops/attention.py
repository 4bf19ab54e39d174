"""Multi-head attention backends. Port of npcd_tpu/ops/attention.py: the
grouped [Q|K|V] column layout of the denoiser's fused qkv projection and
its default group count, and the dispatch over [B, S, H, D] q, k, v:

  * ``einsum``: plain softmax attention (``einsum_attention``), q and k
    pre-scaled by d^-1/4 in their own dtype;
  * ``pallas``: kernel K8, ops/kernels/flash_attention.py (the name is
    npcd_tpu's; on the CPU it runs K8's plain version);
  * ``xla``: F.scaled_dot_product_attention, the library path, as npcd_tpu's
    jax.nn.dot_product_attention; not a port of a kernel;
  * ``auto``: K8 on CUDA tensors of head dim 64 or 128, f32 or bf16, without
    ``valid_len``; einsum otherwise.

With ``valid_len`` (keys at positions >= valid_len masked) every impl but
einsum raises. The denoiser's 2D-token attention over the fused qkv
(npcd_tpu's fused_qkv_attention_tokens) is kernel K1,
ops/kernels/fused_qkv_attention.py:fused_qkv_attention, re-exported here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernels.flash_attention import HEAD_DIMS, flash_attention
from .kernels.fused_qkv_attention import fused_qkv_attention, split_grouped_qkv

__all__ = ["default_qkv_groups", "einsum_attention", "fused_qkv_attention",
           "multi_head_attention", "split_grouped_qkv"]

_DTYPES = (torch.float32, torch.bfloat16)


def _heads_per_block(heads: int, d: int, groups: int = 1) -> int:
    """npcd_tpu/ops/pallas/fused_qkv_attention.py:_heads_per_block: the
    largest head block (8, 4 or 2) whose column width is a multiple of 128
    within one layout group, else the whole group."""
    hg = heads // groups
    for hpb in (8, 4, 2):
        if hg % hpb == 0 and (hpb * d) % 128 == 0:
            return hpb
    return hg


def default_qkv_groups(heads: int, d: int) -> int:
    """Group count of the grouped [Q|K|V] layout that npcd_tpu picks for a
    head geometry (G = 2 at 16 heads x D 64; 1 where the head block cannot
    tile 128 columns). The bridged c_qkv weights are stored in this order,
    so the port must pick the same G."""
    hpb = _heads_per_block(heads, d, 1)
    if (hpb * d) % 128 == 0 and heads % hpb == 0:
        return heads // hpb
    return 1


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: int | None = None) -> torch.Tensor:
    """npcd_tpu's _einsum_attention over [B, S, H, D]: q and k times
    1 / dtype(sqrt(sqrt(d))) in their dtype, the logits in that dtype, then
    an f32 softmax (keys >= valid_len at -1e30) cast back for the product
    with v."""
    root = torch.tensor(float(q.shape[-1]), dtype=torch.float32).sqrt().sqrt()
    scale = 1.0 / root.to(q.dtype)
    logits = torch.einsum("bthc,bshc->bhts", q * scale, k * scale).float()
    if valid_len is not None and valid_len < k.shape[1]:
        keep = torch.arange(k.shape[1], device=q.device) < valid_len
        logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshc->bthc", weights, v)


def _k8_supported(q: torch.Tensor) -> bool:
    """npcd_tpu's _pallas_supported with CUDA in place of the TPU."""
    return q.is_cuda and q.shape[-1] in HEAD_DIMS and q.dtype in _DTYPES


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, impl: str = "auto",
                         valid_len: int | None = None) -> torch.Tensor:
    """Non-causal multi-head attention over [B, S, H, D] tensors."""
    if impl == "auto":
        impl = "pallas" if _k8_supported(q) and valid_len is None else "einsum"
    if impl == "einsum":
        return einsum_attention(q, k, v, valid_len)
    if valid_len is not None:
        raise NotImplementedError(f"valid_len masking not supported for impl={impl}")
    if impl == "xla":
        heads_first = lambda t: t.transpose(1, 2)
        return heads_first(F.scaled_dot_product_attention(
            heads_first(q), heads_first(k), heads_first(v)))
    if impl == "pallas":
        return flash_attention(q, k, v)
    raise ValueError(f"unknown attention impl: {impl}")


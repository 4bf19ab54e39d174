"""Attention over the denoiser's fused qkv projection. Port of the parts of
npcd_tpu/ops/attention.py the sampler runs: the grouped [Q|K|V] column
layout and its default group count. The 2D-token attention itself
(npcd_tpu's fused_qkv_attention_tokens) is kernel K1,
ops/kernels/fused_qkv_attention.py:fused_qkv_attention."""
from __future__ import annotations

from .kernels.fused_qkv_attention import fused_qkv_attention, split_grouped_qkv

__all__ = ["default_qkv_groups", "fused_qkv_attention", "split_grouped_qkv"]


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

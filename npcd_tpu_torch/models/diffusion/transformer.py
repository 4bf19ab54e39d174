"""NPCD transformer denoiser. Port of
npcd_tpu/models/diffusion/transformer.py: a pre-LN transformer over the P
point tokens plus one prepended timestep token, with the sequence padded to
a multiple of 8 (513 -> 520) so the [N*S, W] token matrix reshapes freely;
pad keys are masked out of attention and pad rows sliced off at the end.

Module and parameter names follow the flax tree (input_proj, time_embed,
ln_pre, resblocks.{i}.{ln_1, attn.c_qkv, attn.c_proj, ln_2, mlp.c_fc,
mlp.c_proj}, ln_post, output_proj) so utils/from_jax.py maps one onto the
other. c_qkv's output channels keep npcd_tpu's grouped [Q|K|V] order.
LayerNorms run through kernel K2 and attention through kernel K1, forward
and, under autograd, backward (their wrappers' autograd Functions).

``dtype`` is the compute dtype, float32 or bfloat16, as npcd_tpu's
``NPCDTransformer.dtype``: the parameters stay f32 and are cast at use. In
bf16 every dense layer but output_proj follows flax's nn.Dense,
bf16(bf16(x) @ bf16(W)) + bf16(b) with one rounding after the product and
one after the bias; the input, the timestep embedding and the pad zeros are
bf16, the residual stream and every sublayer's input bf16 (K1 and K2 run
their bf16 flavours), and ln_post's output goes to output_proj in f32.
The blocks' GELU takes the tanh form in bf16 and the exact (erf) form in
f32, npcd_tpu's gelu="auto"; time_embed keeps erf. ``remat`` recomputes
each whole block in the backward (torch.utils.checkpoint), so K1's and K2's
forwards run again there: npcd_tpu's ``remat_policy`` "full". Its "dots"
(save the blocks' GEMM outputs, recompute the rest) ran the bf16 stage-2
step slower than "full" and with more memory on the H100 (PERF.md), and
raises NotImplementedError.

``tp`` > 1 with a ``mesh`` (parallel/mesh.py's Mesh.with_tp) builds this
model rank's part of the denoiser for tensor parallelism, as npcd_tpu's
modules with tp inside its shard_map step (parallel/tp_step.py): c_qkv and
c_fc (of every block and of time_embed) hold 1/tp of their output columns,
each block's attention runs K1 on heads / tp heads in qkv_groups / tp
groups, and c_proj holds 1/tp of its input rows, its partial product
summed over the model group before the bias is added once (parallel/tp.py's
tp_reduce). tp_replicate at each column-parallel input sums the
activation's cotangent over the model group in the backward. Block remat
runs a block's forward reduces again in the backward.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.attention import default_qkv_groups, fused_qkv_attention
from ...ops.kernels.layer_norm import layer_norm, layer_norm_residual
from ...parallel.tp import tp_reduce, tp_replicate


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: int = 10000):
    """Sinusoidal embeddings [N] -> [N, dim], cos first, then sin."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class FusedLayerNorm(nn.Module):
    """LayerNorm with f32 statistics; ``forward(x, delta)`` returns
    (x + delta, LN(x + delta)) with the residual add fused."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.eps = eps

    def forward(self, x: torch.Tensor, delta: Optional[torch.Tensor] = None):
        if delta is None:
            return layer_norm(x, self.weight, self.bias, self.eps)
        return layer_norm_residual(x, delta, self.weight, self.bias, self.eps)


class Dense(nn.Linear):
    """nn.Linear with a compute dtype: f32 as nn.Linear; bf16 as flax's
    nn.Dense(dtype=bfloat16) over f32 parameters, bf16(bf16(x) @ bf16(W))
    + bf16(b), the product and the sum each rounded to bf16."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x):
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class RowParallelDense(Dense):
    """Dense whose weight holds this model rank's input rows [out, in / tp]:
    the partial product is summed over the model group (tp_reduce) and the
    replicated bias added once after it, in the compute dtype (npcd_tpu's
    RowParallelDense)."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype, mesh):
        super().__init__(in_features, out_features, dtype)
        self.mesh = mesh

    def forward(self, x):
        dt = self.compute_dtype
        y = tp_reduce(F.linear(x.to(dt), self.weight.to(dt)), self.mesh)
        return y + self.bias.to(dt)


def _dense_out(in_features: int, out_features: int, dtype: torch.dtype, tp: int, mesh):
    """An output projection: Dense, or row-parallel over in_features / tp."""
    if tp == 1:
        return Dense(in_features, out_features, dtype)
    return RowParallelDense(in_features // tp, out_features, dtype, mesh)


class TransformerMLP(nn.Module):
    """4x MLP with the exact (erf) GELU, or its tanh form; with tp, this
    model rank's 4W / tp hidden columns."""

    def __init__(self, width: int, dtype: torch.dtype = torch.float32, tanh: bool = False,
                 tp: int = 1, mesh=None):
        super().__init__()
        self.c_fc = Dense(width, 4 * width // tp, dtype)
        self.c_proj = _dense_out(4 * width, width, dtype, tp, mesh)
        self.approximate = "tanh" if tanh else "none"
        self.tp, self.mesh = tp, mesh

    def forward(self, x):
        if self.tp > 1:
            x = tp_replicate(x, self.mesh)
        return self.c_proj(F.gelu(self.c_fc(x), approximate=self.approximate))


class MultiheadAttention(nn.Module):
    """Attention over 2D token matrices [N*seq, W] (rows batch-major); with
    tp, this model rank's heads / tp heads (qkv_groups / tp whole layout
    groups)."""

    def __init__(self, width: int, heads: int, seq: int, valid_len: int, qkv_groups: int,
                 dtype: torch.dtype = torch.float32, tp: int = 1, mesh=None):
        super().__init__()
        self.c_qkv = Dense(width, 3 * width // tp, dtype)
        self.c_proj = _dense_out(width, width, dtype, tp, mesh)
        self.heads, self.seq, self.valid_len = heads // tp, seq, valid_len
        self.qkv_groups = qkv_groups // tp
        self.tp, self.mesh = tp, mesh

    def forward(self, x):
        if self.tp > 1:
            x = tp_replicate(x, self.mesh)
        qkv = self.c_qkv(x)
        out = fused_qkv_attention(qkv, self.heads, qkv.shape[0] // self.seq, self.seq,
                                  self.valid_len, self.qkv_groups)
        return self.c_proj(out)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block with deferred residual adds: takes (x, pending), where
    pending is the previous sublayer's un-added output, and returns
    (x', mlp_out) with the MLP output left pending for the next LayerNorm."""

    def __init__(self, width, heads, seq, valid_len, qkv_groups, dtype=torch.float32, tp=1,
                 mesh=None):
        super().__init__()
        self.ln_1 = FusedLayerNorm(width)
        self.attn = MultiheadAttention(width, heads, seq, valid_len, qkv_groups, dtype, tp, mesh)
        self.ln_2 = FusedLayerNorm(width)
        self.mlp = TransformerMLP(width, dtype, tanh=dtype == torch.bfloat16, tp=tp, mesh=mesh)

    def forward(self, x, pending=None):
        if pending is None:
            y1 = self.ln_1(x)
        else:
            x, y1 = self.ln_1(x, pending)
        x, y2 = self.ln_2(x, self.attn(y1))
        return x, self.mlp(y2)


class NPCDTransformer(nn.Module):
    """Joint coords+feats epsilon-prediction denoiser:
    (coords [N, C, P], feats [N, F, P], t [N]) -> (eps_coords, eps_feats)."""

    def __init__(self, coords_dim: int = 3, feats_dim: int = 32, num_points: int = 512,
                 width: int = 1024, layers: int = 24, heads: int = 16,
                 qkv_groups: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = "full", tp: int = 1, mesh=None):
        super().__init__()
        self._args = dict(coords_dim=coords_dim, feats_dim=feats_dim, num_points=num_points,
                          width=width, layers=layers, heads=heads, qkv_groups=qkv_groups,
                          dtype=dtype, remat=remat, remat_policy=remat_policy, tp=tp, mesh=mesh)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
        if remat_policy == "dots":
            raise NotImplementedError(
                'remat_policy="dots": selective checkpointing of the blocks\' GEMM outputs ran '
                'the bf16 stage-2 step 13-29% slower than "full", with 6.6 GiB more peak '
                'memory (H100 80GB HBM3 at 700 W, PERF.md); use "full"')
        if remat_policy != "full":
            raise ValueError(f'remat_policy must be "full", got {remat_policy!r}')
        self.coords_dim, self.feats_dim, self.width = coords_dim, feats_dim, width
        self.dtype, self.remat = dtype, remat
        self.qkv_groups = (qkv_groups if qkv_groups is not None
                           else default_qkv_groups(heads, width // heads))
        if tp > 1 and (self.qkv_groups % tp or heads % tp):
            raise ValueError(
                f"tensor parallelism needs tp | qkv_groups and tp | heads; got tp={tp}, "
                f"qkv_groups={self.qkv_groups}, heads={heads} (set qkv_groups explicitly on "
                f"the model)")
        if tp > 1 and mesh is None:
            raise ValueError(f"tp={tp} needs the mesh whose model group it splits over")
        self.tp, self.mesh = tp, mesh
        self.valid = num_points + 1  # points + the time token
        self.seq = -(-self.valid // 8) * 8
        in_ch = coords_dim + feats_dim
        self.input_proj = Dense(in_ch, width, dtype)
        self.time_embed = TransformerMLP(width, dtype, tp=tp, mesh=mesh)
        self.ln_pre = FusedLayerNorm(width)
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, self.seq, self.valid, self.qkv_groups, dtype,
                                   tp, mesh)
            for _ in range(layers))
        self.ln_post = FusedLayerNorm(width)
        self.output_proj = nn.Linear(width, in_ch)

    def clone(self, **overrides) -> "NPCDTransformer":
        """A new denoiser of this one's arguments, ``overrides`` replacing some
        (npcd_tpu's ``denoiser.clone(tp=, tp_axis=)``); its parameters are
        fresh."""
        return NPCDTransformer(**{**self._args, **overrides})

    @torch.no_grad()
    def init_seeded(self, generator: torch.Generator, init_scale: float = 0.25) -> None:
        """npcd_tpu's init scheme from a torch.Generator: blocks and
        time_embed N(0, (init_scale/sqrt(W))^2) with zero biases, input_proj
        U(+-1/sqrt(in)), LayerNorms (1, 0). Unlike npcd_tpu, output_proj is
        drawn like the blocks rather than zeroed, so an untrained model
        predicts a nonzero epsilon that depends on every layer."""
        std = init_scale / math.sqrt(self.width)
        for name, p in self.named_parameters():
            if name.startswith("input_proj"):
                bound = 1.0 / math.sqrt(self.input_proj.in_features)
                p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
            elif ".ln_" in f".{name}" or name.startswith("ln_"):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=generator) * std)

    @torch.no_grad()
    def init_scratch(self, generator: torch.Generator, init_scale: float = 0.25) -> None:
        """npcd_tpu's from-scratch init (transformer.py:460-541): as
        ``init_seeded``, with output_proj zeroed, so an untrained model
        predicts eps = 0 and its first step trains output_proj alone."""
        self.init_seeded(generator, init_scale)
        self.output_proj.weight.zero_()
        self.output_proj.bias.zero_()

    def forward(self, coords: torch.Tensor, feats: torch.Tensor, t: torch.Tensor):
        n, _, p = coords.shape
        dt = self.dtype
        x = torch.cat([coords, feats], dim=1)  # [N, C, P]
        h = self.input_proj(x.transpose(1, 2).to(dt).reshape(n * p, -1))
        t_embed = self.time_embed(timestep_embedding(t, self.width).to(dt))  # [N, W]
        parts = [t_embed[:, None, :], h.reshape(n, p, self.width)]
        if self.seq != self.valid:
            parts.append(h.new_zeros((n, self.seq - self.valid, self.width)))
        h = torch.cat(parts, dim=1).reshape(n * self.seq, self.width)
        h = self.ln_pre(h)
        pending = None
        for block in self.resblocks:
            if self.remat and torch.is_grad_enabled():
                h, pending = checkpoint(block, h, pending, use_reentrant=False)
            else:
                h, pending = block(h, pending)
        _, h = self.ln_post(h, pending)
        h = self.output_proj(h.float()).reshape(n, self.seq, -1)[:, 1:self.valid]
        pred = h.transpose(1, 2)  # [N, C, P]
        return pred[:, :self.coords_dim], pred[:, self.coords_dim:]

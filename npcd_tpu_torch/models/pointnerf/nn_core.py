"""Functional MLP and positional-encoding primitives of the PointNeRF path.

Port of npcd_tpu/models/pointnerf/nn_core.py. Layers are lists of
{"w": [in, out], "b": [out]} tensors, the layout the JAX params use, so an
MLP is ``h @ w + b`` and the bridged weights need no transpose.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ...ops.kernels.fused_mlp import MAX_IN, fused_mlp, leaky_bf16, linear_bf16

Layers = List[Dict[str, torch.Tensor]]


def init_mlp(dims: Sequence[int], d_in: int, d_out: Optional[int],
             generator: torch.Generator, device=None) -> Layers:
    """Hidden layers ``dims`` plus an optional final projection to d_out,
    with torch.nn.Linear's default init U(+-1/sqrt(in)) for w and b."""
    layers = []
    cur = d_in
    for dim in list(dims) + ([d_out] if d_out is not None else []):
        bound = 1.0 / math.sqrt(cur)
        w = (torch.rand((cur, dim), generator=generator) * 2 - 1) * bound
        b = (torch.rand((dim,), generator=generator) * 2 - 1) * bound
        layers.append({"w": w.to(device), "b": b.to(device)})
        cur = dim
    return layers


def apply_mlp(layers: Layers, x: torch.Tensor, act: str = "leaky_relu",
              final_linear: bool = True,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Activation after every layer except the last when final_linear.

    compute_dtype bfloat16 (npcd_tpu's bf16 compute): x and the weights are
    cast to bf16 and each layer is bf16(bf16(f32-accumulated h @ w) + b).
    Leaky-ReLU stacks with a linear last layer and no layer wider than
    MAX_IN (512) run in kernel K7 (ops/kernels/fused_mlp.py; its plain
    version on the CPU), npcd_tpu's gate (nn_core.py:77-92); wider stacks
    (the heads' inputs with a feature encoding) and other activations run
    the same bf16 layers as plain tensor code, npcd_tpu's XLA branch. None
    or float32: the f32 layers h @ w + b."""
    if act == "leaky_relu":
        act_fn = lambda h: torch.maximum(h, 0.01 * h)
    elif act == "relu":
        act_fn = torch.relu
    else:
        raise ValueError(act)
    if compute_dtype == torch.bfloat16:
        h = x.to(torch.bfloat16)
        weights = [(l["w"].to(torch.bfloat16), l["b"].to(torch.bfloat16)) for l in layers]
        if (act == "leaky_relu" and final_linear
                and max(max(w.shape) for w, _ in weights) <= MAX_IN):
            out = fused_mlp(h.reshape(-1, h.shape[-1]), weights)
            return out.reshape(*h.shape[:-1], out.shape[-1])
        act_fn = leaky_bf16 if act == "leaky_relu" else torch.relu
        for i, (w, b) in enumerate(weights):
            h = linear_bf16(h, w, b)
            if not (final_linear and i == len(weights) - 1):
                h = act_fn(h)
        return h
    if compute_dtype not in (None, torch.float32):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    h = x
    n = len(layers)
    for i, layer in enumerate(layers):
        h = h @ layer["w"] + layer["b"]
        if not (final_linear and i == n - 1):
            h = act_fn(h)
    return h


def positional_encoding(x: torch.Tensor, n_freqs: int, freq_mult: float = 1.0,
                        method: str = "recurrence") -> torch.Tensor:
    """[..., d] -> [..., d*(1+2*n_freqs)]: [x, then per input dim
    sin(2^0 pi x)..sin(2^{n-1} pi x), cos(2^0 pi x)..cos(2^{n-1} pi x)].

    'direct' evaluates every octave; 'recurrence' only octave 0 and derives
    the rest by the double-angle identities; 'anchored' re-anchors with a
    direct evaluation every 5 octaves (see npcd_tpu's nn_core)."""
    if method == "direct":
        bands = (freq_mult * 2.0 ** torch.arange(n_freqs, dtype=torch.float32,
                                                 device=x.device)) * torch.pi
        spectrum = x[..., None] * bands.to(torch.float32)
        enc = torch.cat([torch.sin(spectrum), torch.cos(spectrum)], dim=-1)
    else:
        anchor_every = 5 if method == "anchored" else n_freqs
        xf = x.float()
        sins, coss = [], []
        for g0 in range(0, n_freqs, anchor_every):
            # fm*2^g0*pi rounded to f32 is a power-of-2 scaling of fl(fm*pi)
            base = float(np.float32(freq_mult * float(2 ** g0) * math.pi)) * xf
            s, c = torch.sin(base), torch.cos(base)
            sins.append(s)
            coss.append(c)
            for _ in range(min(anchor_every, n_freqs - g0) - 1):
                s, c = 2.0 * s * c, 2.0 * c * c - 1.0
                sins.append(s)
                coss.append(c)
        enc = torch.stack(sins + coss, dim=-1).to(x.dtype)  # [..., d, 2n]
    enc = enc.reshape(*x.shape[:-1], x.shape[-1] * 2 * n_freqs)
    return torch.cat([x, enc], dim=-1)


def posenc_dim(d_in: int, n_freqs: int) -> int:
    return d_in * (1 + 2 * n_freqs)

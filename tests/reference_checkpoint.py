"""Synthetic checkpoints in the reference NPCD's state-dict layout, and the
reference denoiser's math that reads them (no JAX): the CPU tests of the
converters and chip_smoke.py's reference-weights phase build their
checkpoints here.

The layout: FlexEmbedding tables in extra state (``pointnerf.coords`` [n_obj,
P*3], ``pointnerf.feats`` [n_obj, P*2F], mean half first), the field's
Sequentials (a Linear at each even index), the denoiser with per-head
[q|k|v] c_qkv under ``backbone.resblocks``, and the normalizer buffers."""
from __future__ import annotations

import math
from typing import Dict

import torch

COORDS_DIM = 3


def reference_state(width: int, seed: int = 0, n_obj: int = 3, points: int = 8,
                    feat_dim: int = 4, layers: int = 2, mlp: int = 256,
                    device="cpu") -> Dict[str, object]:
    """Every tensor drawn from ``seed`` on ``device``: Linear weights
    N(0, 1/in), biases N(0, 0.02^2), LayerNorm
    weights 1 + 0.1 N(0, 1) and biases 0.1 N(0, 1), coords in [-0.4, 0.4],
    feats N(0, 1), normalizer shifts N(0, 1), scales in [0.5, 1.5], min/max
    -1 - U and 1 + U. c_qkv's output channels are per-head [q|k|v] for any
    head count that divides ``width``."""
    g = torch.Generator(device=device).manual_seed(seed)
    sd: Dict[str, object] = {}
    draw = lambda *shape: torch.randn(*shape, generator=g, device=device)
    uniform = lambda *shape: torch.rand(*shape, generator=g, device=device)

    def lin(name, d_in, d_out):
        sd[f"{name}.weight"] = draw(d_out, d_in) / math.sqrt(d_in)
        sd[f"{name}.bias"] = draw(d_out) * 0.02

    def ln(name, d):
        sd[f"{name}.weight"] = 1 + 0.1 * draw(d)
        sd[f"{name}.bias"] = 0.1 * draw(d)

    sd["pointnerf.coords._extra_state"] = {"emb": {"weight": (uniform(n_obj, points * 3) - 0.5)
                                                   * 0.8}}
    sd["pointnerf.feats._extra_state"] = {"emb": {"weight": draw(n_obj, points * 2 * feat_dim)}}
    for i, (di, do) in enumerate([(feat_dim + 63, mlp)] + [(mlp, mlp)] * 4):
        lin(f"pointnerf.field.aggregator.local_field.{2 * i}", di, do)
    lin("pointnerf.field.shape_net.0", mlp, mlp)
    lin("pointnerf.field.shape_net.2", mlp, 1)
    for i, (di, do) in enumerate([(mlp, mlp)] * 4 + [(mlp, 3)]):
        lin(f"pointnerf.field.channel_net.{2 * i}", di, do)

    pre = "diffusion.denoiser."
    lin(pre + "input_proj", COORDS_DIM + feat_dim, width)
    lin(pre + "output_proj", width, COORDS_DIM + feat_dim)
    ln(pre + "ln_pre", width)
    ln(pre + "ln_post", width)
    lin(pre + "time_embed.c_fc", width, 4 * width)
    lin(pre + "time_embed.c_proj", 4 * width, width)
    for i in range(layers):
        b = pre + f"backbone.resblocks.{i}."
        ln(b + "ln_1", width)
        ln(b + "ln_2", width)
        lin(b + "attn.c_qkv", width, 3 * width)
        lin(b + "attn.c_proj", width, width)
        lin(b + "mlp.c_fc", width, 4 * width)
        lin(b + "mlp.c_proj", 4 * width, width)
    for name, dim in [("coords_normalization", COORDS_DIM), ("feats_normalization", feat_dim)]:
        sd[f"diffusion.{name}.shift"] = draw(dim)
        sd[f"diffusion.{name}.scale"] = uniform(1) + 0.5
        sd[f"diffusion.{name}.min"] = -1 - uniform(1)
        sd[f"diffusion.{name}.max"] = 1 + uniform(1)
    return sd


def reference_forward(sd, coords, feats, t, heads: int, layers: int):
    """The reference denoiser (coords [N, 3, P], feats [N, F, P], t [N]) ->
    (eps_coords, eps_feats) in plain torch on the inputs' device, reading
    the per-head [q|k|v] c_qkv as stored: exact GELU, LayerNorm eps 1e-5, q
    and k each scaled by d^-1/4, the time token first."""
    pre = "diffusion.denoiser."
    lin = lambda name, x: x @ sd[f"{name}.weight"].T + sd[f"{name}.bias"]
    norm = lambda name, x: torch.nn.functional.layer_norm(
        x, (x.shape[-1],), sd[f"{name}.weight"], sd[f"{name}.bias"], 1e-5)
    gelu = torch.nn.functional.gelu
    width = sd[pre + "ln_pre.weight"].shape[0]
    x = torch.cat([coords, feats], dim=1).permute(0, 2, 1)
    h = lin(pre + "input_proj", x)
    half = width // 2
    freqs = torch.exp(-math.log(10000)
                      * torch.arange(half, dtype=torch.float32, device=x.device) / half)
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    t_tok = lin(pre + "time_embed.c_proj", gelu(lin(pre + "time_embed.c_fc", emb)))
    h = norm(pre + "ln_pre", torch.cat([t_tok[:, None], h], dim=1))
    n, s, _ = h.shape
    d = width // heads
    scale = 1 / math.sqrt(math.sqrt(d))
    for i in range(layers):
        b = pre + f"backbone.resblocks.{i}."
        qkv = lin(b + "attn.c_qkv", norm(b + "ln_1", h)).view(n, s, heads, 3 * d)
        q, k, v = torch.split(qkv, d, dim=-1)
        att = torch.softmax(torch.einsum("bthc,bshc->bhts", q * scale, k * scale), dim=-1)
        h = h + lin(b + "attn.c_proj", torch.einsum("bhts,bshc->bthc", att, v).reshape(n, s, -1))
        h = h + lin(b + "mlp.c_proj", gelu(lin(b + "mlp.c_fc", norm(b + "ln_2", h))))
    out = lin(pre + "output_proj", norm(pre + "ln_post", h)[:, 1:]).permute(0, 2, 1)
    return out[:, :COORDS_DIM], out[:, COORDS_DIM:]

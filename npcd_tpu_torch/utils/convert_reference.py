"""Convert a reference PyTorch checkpoint (npcd_srncars.pt) into the port's
weights, for PSNR/FID parity without retraining. Port of
npcd_tpu/utils/convert_reference.py, in numpy and torch only.

Source layout (the reference NPCD state_dict):
  pointnerf.feats._extra_state        {"emb": {"weight": [n_obj, P*2F]}}
                                      (FlexEmbedding keeps its table in
                                      extra state, mean half first)
  pointnerf.coords._extra_state       {"emb": {"weight": [n_obj, P*3]}}
  pointnerf.field.aggregator.local_field.{0,2,4,6,8}.weight/bias
  pointnerf.field.shape_net.{0,2}.weight/bias
  pointnerf.field.channel_net.{0,2,4,6,8}.weight/bias
  diffusion.denoiser.{input_proj,output_proj,ln_pre,ln_post,time_embed.*}
  diffusion.denoiser.backbone.resblocks.N.{ln_1,ln_2,attn.c_qkv,attn.c_proj,
                                           mlp.c_fc,mlp.c_proj}
  diffusion.{coords,feats}_normalization.{shift,scale,min,max}

Target: the flat dict of utils/from_jax.py that ``load_flat`` reads
(``diffusion.denoiser.*`` as the port's NPCDTransformer names them,
``pointnerf.*`` as its PointNeRF names them, ``<coords|feats>_norm.<stat>``)
plus the stage-1 latent tables ``latents.coords_table`` [n_obj, P, 3] and
``latents.feats_table`` [n_obj, P, F] (the mean half). The denoiser's
nn.Linear weights stay [out, in]; the PointNeRF MLPs' ``w`` become [in,
out]. The reference's fused qkv projection emits per-head [q|k|v] channel
groups; the port's attention kernel K1 reads npcd_tpu's grouped [Q|K|V]
order (``qkv_groups`` head groups, each [Q_g|K_g|V_g]), so c_qkv's output
channels are permuted once here, to the group count the model will use.

Saved with ``save_converted`` (the bridged .npz and its ``qkv_groups``
layout sidecar), the result is what every ``--weights`` of the port reads:

    python -m npcd_tpu_torch.utils.convert_reference --weights npcd_srncars.pt \\
        --config configs/npcd_srncars.yaml --out weights/npcd_srncars.npz

then ``generate_samples`` / ``eval_diffusion --weights weights/npcd_srncars.npz``,
``eval_pointnerf --weights`` and ``train_diffusion --pointnerf_weights`` on
the same file.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.diffusion.normalizers import NormalizerStats
from ..ops.attention import default_qkv_groups
from .checkpoint import write_layout_meta
from .from_jax import LATENTS, save_npz

_STATS = ("shift", "scale", "min", "max")
_NORMS = (("coords_norm", "diffusion.coords_normalization"),
          ("feats_norm", "diffusion.feats_normalization"))
# the port's PointNeRF MLP -> (reference Sequential, its Linear count)
_MLPS = (("local_field", "field.aggregator.local_field", 5),
         ("shape_net", "field.shape_net", 2),
         ("channel_net", "field.channel_net", 5))


def _t(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w, np.float32).T)


def _a(w) -> np.ndarray:
    return np.asarray(w, np.float32)


def load_torch_state_dict(path: str) -> Dict[str, Any]:
    """The reference checkpoint's state dict (inside ``"model"`` where it is
    wrapped), tensors as numpy. The file is the reference's own release,
    whose FlexEmbedding extra state is a nested dict."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "model" in state:
        state = state["model"]
    return {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in state.items()}


def _mlp_from_sequential(state: Mapping[str, Any], prefix: str, name: str,
                         num_linears: int) -> Dict[str, np.ndarray]:
    """Reference define_mlp Sequential (a Linear at each even index) -> the
    port's ParameterList names: ``<name>.<2i>`` w [in, out],
    ``<name>.<2i+1>`` b."""
    out = {}
    for i in range(num_linears):
        out[f"{name}.{2 * i}"] = _t(state[f"{prefix}.{2 * i}.weight"])
        out[f"{name}.{2 * i + 1}"] = _a(state[f"{prefix}.{2 * i}.bias"])
    return out


def convert_pointnerf_params(state: Mapping[str, Any], n_obj: int, num_points: int = 512,
                             feat_dim: int = 32, prefix: str = "pointnerf.") -> Dict[str, np.ndarray]:
    """-> the port's PointNeRF state dict with its latent tables:
    ``tables.coords_table`` [n_obj, P, 3], ``tables.feats_table`` [n_obj, P,
    2F] (mean half first) and the MLPs as utils/from_jax.pointnerf_state_dict
    names them."""
    def extra_weight(key):
        return np.asarray(state[f"{prefix}{key}._extra_state"]["emb"]["weight"], np.float32)

    out = {"tables.coords_table": extra_weight("coords").reshape(n_obj, num_points, 3),
           "tables.feats_table": extra_weight("feats").reshape(n_obj, num_points, 2 * feat_dim)}
    for name, sequential, n in _MLPS:
        out.update(_mlp_from_sequential(state, f"{prefix}{sequential}", name, n))
    return out


def _permute_qkv_grouped(weight: np.ndarray, bias: np.ndarray, heads: int, groups: int):
    """Per-head [q|k|v] output channels -> the grouped [Q|K|V] layout.

    weight: [3W, in] (nn.Linear); bias: [3W]. Group g owns the output
    channels [g*3*Wg, (g+1)*3*Wg), ordered [Q_g | K_g | V_g] with its heads
    contiguous inside each third (groups=1 is the global [Q|K|V] order).
    Source channel h*3d + t*d + j goes to (h//hg)*3*hg*d + t*hg*d +
    (h%hg)*d + j with hg = heads/groups."""
    w3 = weight.shape[0]
    d = w3 // (3 * heads)
    hg = heads // groups
    w = weight.reshape(groups, hg, 3, d, -1).transpose(0, 2, 1, 3, 4).reshape(w3, -1)
    b = bias.reshape(groups, hg, 3, d).transpose(0, 2, 1, 3).reshape(w3)
    return np.ascontiguousarray(w), np.ascontiguousarray(b)


def relayout_qkv(weight: np.ndarray, bias: np.ndarray, heads: int, from_groups: int,
                 to_groups: int):
    """Permute c_qkv's output channels (weight [3W, in], bias [3W]) between
    grouped [Q|K|V] layouts, e.g. weights saved under the global layout
    (from_groups=1) for a model of the default qkv_groups=2."""
    if from_groups == to_groups:
        return weight, bias
    w3 = weight.shape[0]
    d = w3 // (3 * heads)
    hg = heads // from_groups
    # grouped -> per-head [q|k|v] (the inverse of _permute_qkv_grouped)
    w = weight.reshape(from_groups, 3, hg, d, -1).transpose(0, 2, 1, 3, 4).reshape(w3, -1)
    b = bias.reshape(from_groups, 3, hg, d).transpose(0, 2, 1, 3).reshape(w3)
    return _permute_qkv_grouped(w, b, heads, to_groups)


def convert_denoiser_params(state: Mapping[str, Any], layers: int = 24, heads: int = 16,
                            qkv_groups: Optional[int] = None,
                            prefix: str = "diffusion.denoiser.") -> Dict[str, np.ndarray]:
    """-> the port's NPCDTransformer state dict (utils/from_jax.denoiser_state_dict's
    names), c_qkv in the grouped order of ``qkv_groups`` (None: the default
    of the head geometry, as the model picks it)."""
    out: Dict[str, np.ndarray] = {}

    def copy(src, dst):
        for p in ("weight", "bias"):
            out[f"{dst}.{p}"] = _a(state[f"{prefix}{src}.{p}"])

    for name in ("input_proj", "time_embed.c_fc", "time_embed.c_proj", "ln_pre", "ln_post",
                 "output_proj"):
        copy(name, name)
    for i in range(layers):
        src, dst = f"backbone.resblocks.{i}", f"resblocks.{i}"
        for name in ("ln_1", "ln_2", "attn.c_proj", "mlp.c_fc", "mlp.c_proj"):
            copy(f"{src}.{name}", f"{dst}.{name}")
        weight = _a(state[f"{prefix}{src}.attn.c_qkv.weight"])
        groups = qkv_groups
        if groups is None:
            groups = default_qkv_groups(heads, weight.shape[0] // (3 * heads))
        out[f"{dst}.attn.c_qkv.weight"], out[f"{dst}.attn.c_qkv.bias"] = _permute_qkv_grouped(
            weight, _a(state[f"{prefix}{src}.attn.c_qkv.bias"]), heads, groups)
    return out


def convert_normalizer_stats(state: Mapping[str, Any], prefix: str) -> NormalizerStats:
    return NormalizerStats(*(torch.from_numpy(_a(state[f"{prefix}.{f}"]).copy())
                             for f in _STATS))


def convert_checkpoint(path: str, config: Mapping[str, Any]) -> Tuple[Dict[str, np.ndarray], dict]:
    """Full reference checkpoint at ``path`` -> (the flat dict ``load_flat``
    reads, plus ``latents.*``; the layout meta ``{"qkv_groups": G}`` of its
    c_qkv columns, or {} without diffusion weights), for the model of
    ``config`` (its ``model`` section: n_obj, num_points, feats_dim, width,
    layers, heads and the optional qkv_groups)."""
    m = config["model"]
    feat_dim = m.get("feats_dim", 32)
    state = load_torch_state_dict(path)
    pn = convert_pointnerf_params(state, m["n_obj"], m.get("num_points", 512), feat_dim)
    flat = {f"pointnerf.{k}": v for k, v in pn.items() if not k.startswith("tables.")}
    flat[f"{LATENTS}.coords_table"] = pn["tables.coords_table"]
    flat[f"{LATENTS}.feats_table"] = pn["tables.feats_table"][..., :feat_dim]
    layout: dict = {}
    if any(k.startswith("diffusion.") for k in state):
        heads, width = m.get("heads", 16), m.get("width", 1024)
        groups = m.get("qkv_groups") or default_qkv_groups(heads, width // heads)
        flat.update({f"diffusion.denoiser.{k}": v for k, v in convert_denoiser_params(
            state, m.get("layers", 24), heads, groups).items()})
        for name, prefix in _NORMS:
            stats = convert_normalizer_stats(state, prefix)
            flat.update({f"{name}.{f}": getattr(stats, f).numpy() for f in _STATS})
        layout = {"qkv_groups": groups}
    return flat, layout


def save_converted(path: str, flat: Mapping[str, np.ndarray], layout: Mapping[str, Any]) -> None:
    """The bridged .npz at ``path`` and its layout sidecar, which ``load_npz``
    checks against the model it loads into."""
    save_npz(path, flat)
    if layout:
        write_layout_meta(path, dict(layout))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", required=True, help="reference checkpoint (npcd_srncars.pt)")
    p.add_argument("--config", default="configs/npcd_srncars.yaml")
    p.add_argument("--out", required=True, help="the bridged .npz to write")
    args = p.parse_args(argv)

    from .config import load_config

    flat, layout = convert_checkpoint(args.weights, load_config(args.config))
    save_converted(args.out, flat, layout)
    print(f"wrote {args.out}: {len(flat)} arrays, layout {layout}")


if __name__ == "__main__":
    main()

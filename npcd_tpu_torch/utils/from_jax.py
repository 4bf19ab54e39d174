"""Bridge npcd_tpu parameters into the port.

The JAX package keeps its parameters as nested dicts of arrays (flax for
the denoiser, plain lists of {"w", "b"} for PointNeRF). ``bridge`` turns
them, given as numpy arrays, into one flat dict keyed by the port's
``NPCD`` state-dict names plus the normalizer stats, which ``save_npz``
writes and ``load_npz`` (the CLI's ``--weights``) reads back:

  * denoiser Dense kernels [in, out] become nn.Linear weights [out, in]; the
    column order of c_qkv (npcd_tpu's grouped [Q|K|V], with the group count
    of ops/attention.default_qkv_groups) is kept as stored;
  * LayerNorm scale/bias become weight/bias;
  * PointNeRF MLP layers keep w as [in, out].

From npcd_tpu's NPCD params (in a process that has JAX):
    dstate = params["diffusion"]  # npcd_tpu DiffusionState
    flat = bridge(jax.device_get(dstate.params), dstate.coords_norm,
                  dstate.feats_norm, jax.device_get(params["pointnerf"]))
    save_npz("weights/npcd.npz", flat)

Stage 2 reads the stage-1 latent tables from the same format:
``pointnerf_latents`` adds ``latents.coords_table`` [n_obj, P, 3] and
``latents.feats_table`` [n_obj, P, F] (the mean half of npcd_tpu's
variational feats table) beside the ``pointnerf.*`` weights; model loading
skips them. ``train_state_from_jax`` carries a whole stage-2 train state
(params, Adam moments and count, EMAs, step, normalizers) over, and
``pointnerf_train_state_from_jax`` a stage-1 one (the latent tables, the
MLPs, Adam's moments and count, step).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..models.diffusion.diffusion_model import DiffusionState
from ..models.diffusion.normalizers import NormalizerStats
from .checkpoint import check_layout_meta

_NORMS = ("coords_norm", "feats_norm")
_STATS = ("shift", "scale", "min", "max")
LATENTS = "latents"


def denoiser_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """flax NPCDTransformer params -> the port's NPCDTransformer state dict."""
    out: Dict[str, np.ndarray] = {}

    def dense(name, d):
        out[f"{name}.weight"] = np.ascontiguousarray(np.asarray(d["kernel"]).T)
        out[f"{name}.bias"] = np.asarray(d["bias"])

    def norm(name, d):
        out[f"{name}.weight"] = np.asarray(d["scale"])
        out[f"{name}.bias"] = np.asarray(d["bias"])

    dense("input_proj", params["input_proj"])
    for sub in ("c_fc", "c_proj"):
        dense(f"time_embed.{sub}", params["time_embed"][sub])
    norm("ln_pre", params["ln_pre"])
    i = 0
    while f"resblocks_{i}" in params:
        blk, pre = params[f"resblocks_{i}"], f"resblocks.{i}"
        norm(f"{pre}.ln_1", blk["ln_1"])
        norm(f"{pre}.ln_2", blk["ln_2"])
        for sub in ("c_qkv", "c_proj"):
            dense(f"{pre}.attn.{sub}", blk["attn"][sub])
        for sub in ("c_fc", "c_proj"):
            dense(f"{pre}.mlp.{sub}", blk["mlp"][sub])
        i += 1
    norm("ln_post", params["ln_post"])
    dense("output_proj", params["output_proj"])
    return out


def pointnerf_state_dict(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """npcd_tpu PointNeRF params (aggregator/local_field,
    field/{shape_net, channel_net}) -> the port's PointNeRF state dict."""
    out: Dict[str, np.ndarray] = {}
    nets = {"local_field": params["aggregator"]["local_field"],
            "shape_net": params["field"]["shape_net"],
            "channel_net": params["field"]["channel_net"]}
    for name, layers in nets.items():
        for i, layer in enumerate(layers):
            out[f"{name}.{2 * i}"] = np.asarray(layer["w"])
            out[f"{name}.{2 * i + 1}"] = np.asarray(layer["b"])
    return out


def bridge(diffusion_params, coords_norm, feats_norm, pointnerf_params) -> Dict[str, np.ndarray]:
    """-> flat {NPCD state-dict name or '<norm>.<stat>': array}."""
    flat = {f"diffusion.denoiser.{k}": v
            for k, v in denoiser_state_dict(diffusion_params).items()}
    flat.update({f"pointnerf.{k}": v for k, v in pointnerf_state_dict(pointnerf_params).items()})
    for name, stats in zip(_NORMS, (coords_norm, feats_norm)):
        for f in _STATS:
            flat[f"{name}.{f}"] = np.asarray(getattr(stats, f), np.float32)
    return flat


def pointnerf_latents(pointnerf_params: Mapping[str, Any], feats_dim: int) -> Dict[str, np.ndarray]:
    """npcd_tpu PointNeRF params -> the stage-1 latent tables
    {latents.coords_table [n_obj, P, 3], latents.feats_table [n_obj, P, F]},
    the feats table's mean half (npcd_tpu pointnerf.py:163-168)."""
    return {f"{LATENTS}.coords_table": np.asarray(pointnerf_params["coords_table"], np.float32),
            f"{LATENTS}.feats_table": np.asarray(
                pointnerf_params["feats_table"], np.float32)[..., :feats_dim]}


def _find_adam_state(opt_state):
    """The optax ScaleByAdamState inside an optax chain state (nested
    tuples), found by its fields (count, mu, nu) as npcd_tpu
    train/fused_update.py:43-53 does by type."""
    found = []

    def walk(node):
        if hasattr(node, "_fields") and {"count", "mu", "nu"} <= set(node._fields):
            found.append(node)
        elif isinstance(node, (list, tuple)):
            for child in node:
                walk(child)
        elif isinstance(node, dict):  # optax.multi_transform's inner states
            for child in node.values():
                walk(child)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected exactly one ScaleByAdamState in opt_state, got {len(found)}")
    return found[0]


def _norm_dict(stats) -> Dict[str, np.ndarray]:
    return {f: np.asarray(getattr(stats, f), np.float32) for f in _STATS}


def train_state_from_jax(params, opt_state, ema_params, step, coords_norm,
                         feats_norm) -> Dict[str, Any]:
    """npcd_tpu's DiffusionTrainState fields, as numpy trees -> the port's
    bridged train state: {"params", "mu", "nu": denoiser state dicts,
    "emas": a list of them, "count", "step": ints, "coords_norm",
    "feats_norm": {shift, scale, min, max}} (train/diffusion_training.py
    ``DiffusionTraining.load_bridged_state`` reads it)."""
    adam = _find_adam_state(opt_state)
    return {"params": denoiser_state_dict(params), "mu": denoiser_state_dict(adam.mu),
            "nu": denoiser_state_dict(adam.nu),
            "emas": [denoiser_state_dict(e) for e in ema_params],
            "count": int(np.asarray(adam.count)), "step": int(np.asarray(step)),
            "coords_norm": _norm_dict(coords_norm), "feats_norm": _norm_dict(feats_norm)}


def _pointnerf_trainables(tree) -> Dict[str, np.ndarray]:
    """npcd_tpu PointNeRF params (or an Adam moment of them) -> the port's
    trainable parameters by name (tables.feats_table and the MLPs)."""
    out = {"tables.feats_table": np.asarray(tree["feats_table"], np.float32)}
    out.update({k: np.asarray(v, np.float32) for k, v in pointnerf_state_dict(tree).items()})
    return out


def pointnerf_train_state_from_jax(params, opt_state, step) -> Dict[str, Any]:
    """npcd_tpu's PointNeRFTrainState fields (params, the optax
    multi_transform state of make_pointnerf_optimizer, step), as numpy
    trees -> the port's bridged stage-1 train state: {"params": the
    PointNeRF state dict with its tables, "mu", "nu": Adam's moments of the
    trainable parameters, "count", "step": ints}
    (train/pointnerf_training.py ``PointNeRFTraining.load_bridged_state``)."""
    adam = _find_adam_state(opt_state)
    state = _pointnerf_trainables(params)
    state["tables.coords_table"] = np.asarray(params["coords_table"], np.float32)
    return {"params": state, "mu": _pointnerf_trainables(adam.mu),
            "nu": _pointnerf_trainables(adam.nu), "count": int(np.asarray(adam.count)),
            "step": int(np.asarray(step))}


def npcd_flat(model: torch.nn.Module, state: DiffusionState) -> Dict[str, np.ndarray]:
    """An ``NPCD``'s parameters and ``state``'s normalizer stats -> the flat
    dict ``load_flat`` reads back."""
    flat = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    for name, stats in zip(_NORMS, (state.coords_norm, state.feats_norm)):
        flat.update({f"{name}.{f}": v for f, v in _norm_dict(stats).items()})
    return flat


def save_npz(path: str, flat: Mapping[str, np.ndarray]) -> None:
    np.savez(path, **{k: np.asarray(v, np.float32) for k, v in flat.items()})


def load_flat(model: torch.nn.Module, flat: Mapping[str, np.ndarray]) -> DiffusionState:
    """Load a bridged flat dict into an ``NPCD`` (strict: every parameter
    must be present; latent tables are skipped) -> the DiffusionState of
    the normalizer stats."""
    weights = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in flat.items()
               if k.split(".")[0] not in _NORMS + (LATENTS,)}
    model.load_state_dict(weights, strict=True)
    norms = [NormalizerStats(*(torch.tensor(np.asarray(flat[f"{n}.{f}"], np.float32))
                               for f in _STATS)) for n in _NORMS]
    return DiffusionState(*norms)


def load_npz(model: torch.nn.Module, path: str) -> DiffusionState:
    """``load_flat`` from a .npz; a layout sidecar beside it (the trainer's
    exports write one) must agree with the model's qkv_groups."""
    check_layout_meta(path, {"qkv_groups": model.diffusion.denoiser.qkv_groups},
                      what="weights", required=False)
    with np.load(path) as z:
        return load_flat(model, {k: z[k] for k in z.files})

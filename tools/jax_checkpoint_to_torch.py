#!/usr/bin/env python
"""Carry an npcd_tpu (JAX, orbax) checkpoint over to the PyTorch port.

Runs where JAX is: it restores the checkpoint with npcd_tpu's own
utils/checkpoint.py into the tree the JAX CLIs build from ``--config``, and
writes the port's formats through npcd_tpu_torch/utils/from_jax.py. The port
itself never imports JAX; it only reads what this writes. ``--kind``:

  npcd             an NPCD weights-only export {pointnerf, diffusion}, the
                   tree eval_diffusion.py / tools/generate_samples.py
                   --weights read -> the bridged .npz of the port's
                   generate_samples / eval_diffusion --weights (also holding
                   the latent tables, so train_diffusion --pointnerf_weights
                   and eval_pointnerf --weights read it too);
  diffusion        a stage-2 trainer's export (npcd[-ema_<...>]-iter-N: a
                   DiffusionState), with --pointnerf, the stage-1 export
                   whose decoder renders it -> the same .npz;
  pointnerf        a stage-1 export (pointnerf-iter-N) -> pointnerf.* and
                   latents.* for eval_pointnerf --weights and
                   train_diffusion --pointnerf_weights;
  diffusion-state  a stage-2 train-state snapshot
                   (checkpoints/diffusion_training-iter-N) -> a checkpoint
                   of the port's train_diffusion under --out, which it
                   resumes from (params, Adam moments and count, EMAs, step,
                   normalizers);
  pointnerf-state  a stage-1 snapshot (checkpoints/pointnerf_training-iter-N)
                   -> a checkpoint of the port's train_pointnerf under --out
                   (the latent tables, the MLPs, Adam's moments and count,
                   step).

npcd_tpu's ``qkv_groups`` layout sidecar is checked against the config's
model (a mismatch raises) and written beside the port's files, where the
port's loaders check it again.

    python tools/jax_checkpoint_to_torch.py --config configs/npcd_srncars.yaml \\
        --kind diffusion --checkpoint runs/diff/weights_only_checkpoints_dir/npcd-ema_<...>-iter-<n> \\
        --pointnerf runs/pn/weights_only_checkpoints_dir/pointnerf-iter-<m> --out weights/npcd.npz
    python tools/jax_checkpoint_to_torch.py --config configs/npcd_srncars.yaml \\
        --kind diffusion-state --checkpoint runs/diff/checkpoints/diffusion_training-iter-<n> \\
        --out runs/diff_torch
    python -m npcd_tpu_torch.train_diffusion --config configs/npcd_srncars.yaml \\
        --output runs/diff_torch --pointnerf_weights weights/pointnerf.npz
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import re
import sys
from typing import Dict, Optional

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

KINDS = ("npcd", "diffusion", "pointnerf", "diffusion-state", "pointnerf-state")


def _numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _layout(config) -> dict:
    """The qkv_groups npcd_tpu's model of ``config`` resolves, which must be
    the port's too (both pick default_qkv_groups of the head geometry)."""
    from npcd_tpu.utils.builders import build_diffusion_model
    from npcd_tpu_torch.ops.attention import default_qkv_groups

    m = config["model"]
    groups = build_diffusion_model(config).denoiser.resolved_qkv_groups()
    port = m.get("qkv_groups") or default_qkv_groups(m["heads"], m["width"] // m["heads"])
    if port != groups:
        raise ValueError(f"qkv_groups: npcd_tpu resolves {groups}, the port {port}")
    return {"qkv_groups": groups}


def _abstract(fn):
    """The shapes and dtypes of fn()'s tree, without computing it: the
    restore target."""
    import jax

    return jax.eval_shape(fn)


def _restore_weights(path: str, target_fn, layout: Optional[dict]):
    from npcd_tpu.utils.checkpoint import load_weights_only

    return _numpy(load_weights_only(path, _abstract(target_fn), expected_layout=layout))


def _pointnerf_export(config, path: str):
    import jax
    from npcd_tpu.utils.builders import build_pointnerf

    pn = build_pointnerf(config)
    return _restore_weights(path, lambda: pn.init_params(jax.random.PRNGKey(0)), None)


def _diffusion_export(config, path: str, layout: dict):
    import jax
    from npcd_tpu.utils.builders import build_diffusion_model

    model = build_diffusion_model(config)
    return _restore_weights(path, lambda: model.init(jax.random.PRNGKey(0)), layout)


def _npcd_export(config, path: str, layout: dict):
    import jax
    from npcd_tpu.models.npcd import NPCD

    model = NPCD.from_config(config)
    tree = _restore_weights(path, lambda: model.init_params(jax.random.PRNGKey(0)), layout)
    return tree["pointnerf"], tree["diffusion"]


def _snapshot(path: str, target_fn, layout: Optional[dict]):
    """A full train-state snapshot <dir>/<name>-iter-<n> restored by
    npcd_tpu's CheckpointSaver into target_fn()'s structure."""
    from npcd_tpu.utils.checkpoint import CheckpointSaver

    path = osp.abspath(path)
    m = re.match(r"(.+)-iter-\d{9}$", osp.basename(path.rstrip("/")))
    if not m or not osp.isdir(path):
        raise FileNotFoundError(f"{path} is not a <name>-iter-<n> snapshot directory")
    saver = CheckpointSaver(osp.dirname(path), m.group(1), layout_meta=layout)
    state, _ = saver.restore(_abstract(target_fn), path=path)
    return _numpy(state)


def _write_npz(out: str, flat: Dict[str, np.ndarray], layout: Optional[dict]) -> None:
    from npcd_tpu_torch.utils.checkpoint import write_layout_meta
    from npcd_tpu_torch.utils.from_jax import save_npz

    os.makedirs(osp.dirname(osp.abspath(out)), exist_ok=True)
    save_npz(out, flat)
    if layout:
        write_layout_meta(out, layout)


def _npcd_flat(config, pointnerf, dstate) -> Dict[str, np.ndarray]:
    from npcd_tpu_torch.utils.from_jax import bridge, pointnerf_latents

    flat = bridge(dstate.params, dstate.coords_norm, dstate.feats_norm, pointnerf)
    flat.update(pointnerf_latents(pointnerf, config["model"]["feats_dim"]))
    return flat


def _fresh_out(out: str) -> None:
    ckpts = osp.join(out, "checkpoints")
    if osp.isdir(ckpts) and os.listdir(ckpts):
        raise FileExistsError(f"{ckpts} already holds checkpoints; the port's trainer would "
                              "restore the newest of them")


def _diffusion_state(config, path: str, out: str, layout: dict) -> str:
    """npcd_tpu's DiffusionTrainState -> the port's DiffusionTraining
    checkpoint under ``out``."""
    import jax
    import jax.numpy as jnp
    from npcd_tpu.train.diffusion_training import DiffusionTrainState
    from npcd_tpu.train.fused_update import FusedAdamWEma
    from npcd_tpu.utils.builders import build_diffusion_model
    from npcd_tpu.utils.ema import EmaConfig
    from npcd_tpu_torch.data import PointNeRFDataset
    from npcd_tpu_torch.train import DiffusionTraining
    from npcd_tpu_torch.utils.builders import build_diffusion_model as port_model
    from npcd_tpu_torch.utils.from_jax import train_state_from_jax

    tc = config["diffusion_training"]
    ema_cfgs = tuple(EmaConfig.from_tuple(t) for t in (tc.get("ema_params") or [])) \
        if tc.get("use_ema") else ()
    model = build_diffusion_model(config)
    fused = FusedAdamWEma(learning_rate=tc["base_learning_rate"],
                          weight_decay=tc["weight_decay"],
                          clip_max_norm=tc.get("grad_clip_max_norm"), ema_cfgs=ema_cfgs)

    def target():  # the structure npcd_tpu's DiffusionTraining saves
        dstate = model.init(jax.random.PRNGKey(0))
        return DiffusionTrainState(
            params=dstate.params, opt_state=fused.make_tx().init(dstate.params),
            ema_params=tuple(dstate.params for _ in ema_cfgs), step=jnp.zeros((), jnp.int32),
            coords_norm=dstate.coords_norm, feats_norm=dstate.feats_norm)

    s = _snapshot(path, target, layout)
    bridged = train_state_from_jax(s.params, s.opt_state, list(s.ema_params), s.step,
                                   s.coords_norm, s.feats_norm)
    # the trainer fits its normalizers to its dataset when it is built;
    # load_bridged_state replaces them, so two seeded clouds stand in
    m = config["model"]
    rng = np.random.default_rng(0)
    stand_in = PointNeRFDataset(rng.normal(size=(2, m["num_points"], m["coords_dim"])),
                                rng.normal(size=(2, m["num_points"], m["feats_dim"])))
    trainer = DiffusionTraining(out_dir=out, model=port_model(config), dataset=stand_in,
                                device="cpu", verbose=False, **tc)
    trainer.load_bridged_state(bridged)
    saved = trainer.saver.save(trainer.state_dict(), trainer.step)
    trainer.saver.finish()
    return saved


class _Tables:
    """The stage-1 trainer's dataset as its constructor reads it: the object
    count and the coords table (load_bridged_state replaces the tables)."""

    def __init__(self, coords: np.ndarray):
        self.coords = coords

    def __len__(self) -> int:
        return len(self.coords)

    def get_all_coords(self) -> np.ndarray:
        return self.coords


def _pointnerf_state(config, path: str, out: str) -> str:
    """npcd_tpu's PointNeRFTrainState -> the port's PointNeRFTraining
    checkpoint under ``out``; its pixel presampling resumes from the draws
    of seed 42, the CLI's default."""
    import jax
    import jax.numpy as jnp
    from npcd_tpu.train.pointnerf_training import PointNeRFTrainState, make_pointnerf_optimizer
    from npcd_tpu.utils.builders import build_pointnerf
    from npcd_tpu_torch.train import PointNeRFTraining
    from npcd_tpu_torch.utils.builders import build_pointnerf as port_pointnerf
    from npcd_tpu_torch.utils.from_jax import pointnerf_train_state_from_jax

    tc = config["pointnerf_training"]
    pn = build_pointnerf(config)
    tx = make_pointnerf_optimizer(tc["base_learning_rate"], tc.get("grad_clip_max_norm"))

    def target():  # the structure npcd_tpu's PointNeRFTraining saves
        params = pn.init_params(jax.random.PRNGKey(0))
        return PointNeRFTrainState(params=params, opt_state=tx.init(params),
                                   step=jnp.zeros((), jnp.int32))

    s = _snapshot(path, target, None)
    bridged = pointnerf_train_state_from_jax(s.params, s.opt_state, s.step)
    trainer = PointNeRFTraining(out, port_pointnerf(config, with_tables=True),
                                _Tables(bridged["params"]["tables.coords_table"]),
                                device="cpu", verbose=False, **tc)
    trainer.load_bridged_state(bridged)
    saved = trainer.saver.save(trainer.state_dict(), trainer.step)
    trainer.saver.finish()
    return saved


def convert(kind: str, checkpoint: str, config, out: str, pointnerf: Optional[str] = None) -> str:
    """Convert ``checkpoint`` of ``kind`` for the model of ``config`` (a
    loaded config dict) -> the path written (the .npz, or the port's
    checkpoint directory under ``out``)."""
    if kind not in KINDS:
        raise ValueError(f"--kind must be one of {KINDS}, got {kind!r}")
    if kind == "pointnerf":
        pn = _pointnerf_export(config, checkpoint)
        from npcd_tpu_torch.utils.from_jax import pointnerf_latents, pointnerf_state_dict

        flat = {f"pointnerf.{k}": v for k, v in pointnerf_state_dict(pn).items()}
        flat.update(pointnerf_latents(pn, config["model"]["feats_dim"]))
        _write_npz(out, flat, None)
        return out
    if kind == "pointnerf-state":
        _fresh_out(out)
        return _pointnerf_state(config, checkpoint, out)
    layout = _layout(config)
    if kind == "npcd":
        _write_npz(out, _npcd_flat(config, *_npcd_export(config, checkpoint, layout)), layout)
        return out
    if kind == "diffusion":
        if pointnerf is None:
            raise ValueError("--kind diffusion needs --pointnerf, the stage-1 export whose "
                             "decoder renders the generated clouds")
        dstate = _diffusion_export(config, checkpoint, layout)
        _write_npz(out, _npcd_flat(config, _pointnerf_export(config, pointnerf), dstate), layout)
        return out
    _fresh_out(out)
    return _diffusion_state(config, checkpoint, out, layout)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--checkpoint", required=True, help="npcd_tpu's orbax checkpoint directory")
    p.add_argument("--out", required=True,
                   help="the .npz to write, or the port's run directory for a snapshot")
    p.add_argument("--pointnerf", help="the stage-1 export, with --kind diffusion")
    args = p.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")  # the restore is host work
    from npcd_tpu_torch.utils.config import load_config

    written = convert(args.kind, args.checkpoint, load_config(args.config), args.out,
                      args.pointnerf)
    print(f"wrote {written}")
    return written


if __name__ == "__main__":
    main()

"""Stage-1 eval CLI: PSNR of the autodecoder on its training scenes, with
the PyTorch port.

Port of eval_pointnerf.py (same flags and config schema), plus ``--device``
(default cuda). ``--weights`` is the stage-1 trainer's weights-only export,
``<output>/weights_only_checkpoints_dir/pointnerf-iter-<n>.npz`` (its
``latents.feats_table`` is the feats mean the eval renders with):

    python -m npcd_tpu_torch.eval_pointnerf --config configs/npcd_synthetic_tiny.yaml \\
        --weights runs/pointnerf/weights_only_checkpoints_dir/pointnerf-iter-<n>.npz \\
        --output runs/eval_psnr --device cpu

Rows of (obj_idx, view, psnr) go to ``<output>/results.json`` and
``results.csv``, their mean to ``summary.csv`` with the time of a forward
and the peak device memory (``--eval_batch_size 1``, after 3 burn-in
objects); a run whose results exist is skipped. The dataset is the
config's, built through the dataset registry as ``train_pointnerf`` builds
it (the SRN views shuffled by ``random.Random(--seed)``).
``--matmul_precision`` (default ``highest``) is set into the config's
``render_config.matmul_precision`` unless the config sets one or the flag
is ``default``; the PSNR forwards (``eval_forward``, a ``render``) run
under it (highest / float32: exact f32 GEMMs; tensorfloat32: TF32).
``--mesh`` evaluates data parallel as eval_diffusion's does: each render
call's views shard over the ranks (PointNeRFEvaluation) and rank 0 writes.
``--platform`` is refused.
"""
from __future__ import annotations

import argparse
import random

import numpy as np


def parse_args(argv=None):
    from .models.pointnerf.pointnerf import CLI_MATMUL_PRECISIONS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output", help="Path to folder for output data.")
    p.add_argument("--config", help="Path to config file.", required=True)
    p.add_argument("--weights", help="Path to the stage-1 export (.npz).", required=True)
    p.add_argument("--seed", type=int, default=42, help="Random seed. Default: 42.")
    p.add_argument("--eval_batch_size", type=int, default=1,
                   help="Views per render batch; runtime measurement requires 1.")
    p.add_argument("--eval_name", type=str, help="Name of the evaluation. Optional.")
    p.add_argument("--finished_iterations", type=int,
                   help="Training iterations of the model (logging only).")
    p.add_argument("--num_samples", type=int, help="Number of objects to evaluate. Default: all.")
    p.add_argument("--samples", type=int, nargs="*", help="Specific sample indices to evaluate.")
    p.add_argument("--num_qualitatives", type=int, default=10,
                   help="Number of qualitative renders to save.")
    p.add_argument("--qualitatives", type=int, nargs="*", help="Specific qualitative indices.")
    p.add_argument("--log_dir", help="Folder for tensorboard logs. Default: output dir.")
    p.add_argument("--no_tensorboard", action="store_true")
    p.add_argument("--wandb", action="store_true",
                   help="Log to Weights & Biases (requires the wandb package).")
    p.add_argument("--exp_id", type=str)
    p.add_argument("--comment", type=str)
    p.add_argument("--matmul_precision", default="highest",
                   choices=CLI_MATMUL_PRECISIONS,
                   help="The render's f32 matmul precision (render_config."
                        "matmul_precision): highest / float32 exact, tensorfloat32 TF32, "
                        "default the config's or PyTorch's.")
    p.add_argument("--mesh", action="store_true",
                   help="Data parallelism over every visible card (or the launcher's group).")
    p.add_argument("--platform", type=str, default=None,
                   help="A JAX backend flag; the port refuses it (use --device).")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def stage1_state(flat) -> dict:
    """A bridged flat dict's ``pointnerf.*`` MLPs, coords table and feats
    mean -> the state dict of a PointNeRF with tables; the log-variance half
    of its feats table, which the eval does not read, is 0."""
    from .utils.from_jax import LATENTS

    state = {k[len("pointnerf."):]: v for k, v in flat.items() if k.startswith("pointnerf.")}
    feats = np.asarray(flat[f"{LATENTS}.feats_table"])
    state["tables.coords_table"] = flat[f"{LATENTS}.coords_table"]
    state["tables.feats_table"] = np.concatenate([feats, np.zeros_like(feats)], -1)
    return state


def load_stage1_weights(model, path: str) -> None:
    """The stage-1 export at ``path`` into ``model`` (a PointNeRF with
    tables of the same size; strict), as ``stage1_state`` lays it out."""
    import torch

    from .utils.from_jax import LATENTS

    with np.load(path) as z:  # not the denoiser of a full NPCD file
        state = stage1_state({k: z[k] for k in z.files
                              if k.startswith(("pointnerf.", f"{LATENTS}."))})
    model.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                           for k, v in state.items()})


def evaluate(args, config=None, dataset=None) -> dict:
    """Build and run the evaluation as the CLI does; ``config`` replaces the
    file's (a loaded config dict) and ``dataset`` the config's dataset ->
    {"rows", "summary"}."""
    from .eval import PointNeRFEvaluation
    from .eval_diffusion import close_output, open_output, start
    from .models.pointnerf.pointnerf import set_render_precision
    from .utils import logging
    from .utils.builders import build_dataset, build_pointnerf
    from .parallel import is_main
    from .utils.config import load_config, print_config

    device, mesh = start(args)
    open_output(args, args.output, mesh)
    try:
        config = set_render_precision(config if config is not None else load_config(args.config),
                                      args.matmul_precision)
        if is_main(mesh):
            print_config(config)
        if dataset is None:
            dataset = build_dataset(config, view_rng=random.Random(args.seed))
        model = build_pointnerf(config, with_tables=True)
        load_stage1_weights(model, args.weights)
        model = model.to(device).eval()
        logging.info(f"Loaded weights from {args.weights}")
        evaluation = PointNeRFEvaluation(out_dir=args.output, eval_batch_size=args.eval_batch_size,
                                         mesh=mesh)
        return evaluation(dataset, model, samples=args.num_samples, sample_indices=args.samples,
                          qualitatives=args.num_qualitatives,
                          resolution=model.opts.default_resolution)
    finally:
        close_output(args.output, mesh)


def main(argv=None):
    """The command line -> the result (None where ``--mesh`` alone started a
    worker a card)."""
    from .parallel import spawn_cli

    args = parse_args(argv)
    if args.mesh and spawn_cli(main, argv, args.device):
        return None
    return evaluate(args)


if __name__ == "__main__":
    main()

"""Stage-2 CLI: train the diffusion model on stage-1 latents, with the
PyTorch port.

Port of train_diffusion.py (same flags and config schema), plus
``--device`` (default cuda). ``--dtype float16`` (the default) and
``bfloat16`` train with bf16 compute over f32 master weights and every
denoiser block recomputed in the backward, as the JAX CLI maps them;
``float32`` trains in exact f32 (TF32 off). Parameters, Adam state, EMAs,
checkpoints and exports are f32 either way.
``--pointnerf_weights`` is a bridged ``.npz`` (utils/from_jax.py) holding
the stage-1 latent tables ``latents.coords_table`` [n_obj, P, 3] and
``latents.feats_table`` [n_obj, P, F] and the ``pointnerf.*`` weights,
which every weights-only export carries on, so that

    python -m npcd_tpu_torch.train_diffusion --config configs/npcd_srncars.yaml \\
        --output runs/diffusion --pointnerf_weights weights/pointnerf.npz
    python -m npcd_tpu_torch.generate_samples --config configs/npcd_srncars.yaml \\
        --out runs/samples --weights \\
        runs/diffusion/weights_only_checkpoints_dir/npcd-ema_<...>-iter-<n>.npz

generates from what it trained (sampling in f32). ``--mesh`` trains data
parallel, one process a card (parallel/mesh.py): under a launcher's
environment (``python -m torch.distributed.run --nproc-per-node N -m
npcd_tpu_torch.train_diffusion --mesh ...``) it joins that group; alone it
starts one worker a visible card (a group of one on one card or with
``--device cpu``). The config's batch_size is the global batch, and rank 0
writes the outputs. ``--tp N`` trains with tensor parallelism
(parallel/tp_step.py) over a (world // N, N) mesh of the same group,
joined or started as ``--mesh`` does; N must divide the world, the model's
heads and its qkv_groups (ValueError otherwise, as npcd_tpu raises). NCCL
takes one card a rank; ranks that share a card run under a launcher with
gloo (parallel.make_mesh(backend="gloo")). Checkpoints and exports hold
full arrays, as a tp=1 run writes them. ``--platform`` chooses a JAX
backend and is refused.
"""
from __future__ import annotations

import argparse

import numpy as np

# --dtype -> (compute dtype name, remat), as the JAX CLI maps it: float16
# requests the low precision, which is bf16 (train_diffusion.py:42-47, 60)
DTYPES = {"float32": ("float32", False), "float16": ("bfloat16", True),
          "bfloat16": ("bfloat16", True)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output", help="Path to folder for output data.", required=True)
    p.add_argument("--config", help="Path to config file.", required=True)
    p.add_argument("--pointnerf_weights", required=True,
                   help="Bridged .npz with the stage-1 latent tables and pointnerf weights.")
    p.add_argument("--dtype", type=str, default="float16", choices=sorted(DTYPES),
                   help="float32, or float16 / bfloat16 (both bf16 compute with block remat). "
                        "Default: float16.")
    p.add_argument("--seed", type=int, default=42, help="Random seed. Default: 42.")
    p.add_argument("--num_workers", type=int, default=8,
                   help="Accepted for flag parity; batches are collated in-process.")
    p.add_argument("--no_tensorboard", action="store_true",
                   help="Do not log to tensorboard. Default: do log.")
    p.add_argument("--wandb", action="store_true",
                   help="Log to Weights & Biases (requires the wandb package).")
    p.add_argument("--exp_id", type=str, help="Experiment ID.")
    p.add_argument("--comment", type=str, help="Comment for the experiment.")
    p.add_argument("--tp", type=int, default=1,
                   help="Megatron tensor-parallel degree over a (world // tp, tp) mesh of the "
                        "launcher's group (or of a worker a visible card); tp must divide the "
                        "world, the model's heads and its qkv_groups. Default: 1.")
    p.add_argument("--mesh", action="store_true",
                   help="Data parallelism over every visible card (or the launcher's group).")
    p.add_argument("--platform", type=str, default=None,
                   help="A JAX backend flag; the port refuses it (use --device).")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def load_pointnerf_weights(path: str, num_points: int, feats_dim: int):
    """-> (PointNeRFDataset of the latent tables, {pointnerf.*: array})."""
    from .data import PointNeRFDataset
    from .utils.from_jax import LATENTS

    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    coords = flat[f"{LATENTS}.coords_table"]
    feats = flat[f"{LATENTS}.feats_table"]
    if coords.shape[1:] != (num_points, 3) or feats.shape[1:] != (num_points, feats_dim):
        raise ValueError(f"latent tables {coords.shape}, {feats.shape} do not match the "
                         f"config's {num_points} points x {feats_dim} features")
    pointnerf = {k: v for k, v in flat.items() if k.startswith("pointnerf.")}
    return PointNeRFDataset(all_coords=coords, all_feats=feats), pointnerf


def train(args, config=None):
    """Build and run the trainer as the CLI does; ``config`` replaces the
    file's (a loaded config dict, e.g. with overrides) -> the trainer."""
    from .eval_diffusion import close_output, open_output, start
    from .parallel import is_main
    from .train import DiffusionTraining
    from .utils import logging
    from .utils.builders import build_diffusion_model, torch_dtype
    from .utils.config import load_config, print_config

    args.mesh = args.mesh or args.tp > 1  # tensor parallelism runs on a mesh
    device, mesh = start(args)
    if args.tp > 1:  # npcd_tpu's ValueError before anything is loaded
        mesh = mesh.with_tp(args.tp)
    open_output(args, args.output, mesh)
    try:
        config = config if config is not None else load_config(args.config)
        if is_main(mesh):
            print_config(config)
        m = config["model"]
        dataset, pointnerf = load_pointnerf_weights(args.pointnerf_weights, m["num_points"],
                                                    m["feats_dim"])
        logging.info(f"Loaded latent tables and pointnerf weights from {args.pointnerf_weights}")
        dtype, remat = DTYPES[args.dtype]
        model = build_diffusion_model(config, dtype=torch_dtype(dtype), remat=remat)
        training = DiffusionTraining(out_dir=args.output, model=model,
                                     dataset=dataset, seed=args.seed, device=device,
                                     export_extra=pointnerf, mesh=mesh, tp=args.tp,
                                     **config["diffusion_training"])
        training()
    finally:
        close_output(args.output, mesh)
    return training


def main(argv=None):
    """The command line -> the trainer. ``--mesh`` or ``--tp`` > 1 alone on
    several cards starts a worker a card, each running this again under the
    launcher's environment, and -> None."""
    from .parallel import spawn_cli

    args = parse_args(argv)
    if (args.mesh or args.tp > 1) and spawn_cli(main, argv, args.device):
        return None
    return train(args)


if __name__ == "__main__":
    main()

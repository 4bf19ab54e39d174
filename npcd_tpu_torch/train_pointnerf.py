"""Stage-1 CLI: train the PointNeRF autodecoder with the PyTorch port.

Port of train_pointnerf.py (same flags and config schema), plus
``--device`` (default cuda). The config's ``train_dataset`` is built through
the dataset registry from its ``dataset_kwargs``: ``SRNCarsTrain`` (the SRN
configs) reads the tree under ``NPCD_TPU_SRN_ROOT`` or ``[srn] root`` of
npcd_tpu_torch/data/paths.toml, its views shuffled by
``random.Random(--seed)`` as npcd_tpu's ``random.seed(--seed)`` shuffles
them. TF32 is off; the MLPs run in the config's
``render_config.compute_dtype`` (bfloat16 in configs/npcd_srncars_fast.yaml),
the parameters, Adam's state, checkpoints and exports in f32. The final
weights-only export, ``<output>/weights_only_checkpoints_dir/
pointnerf-iter-<n>.npz``, is the bridged ``.npz`` that stage 2 and
generation read:

    python -m npcd_tpu_torch.train_pointnerf --config configs/npcd_synthetic_tiny.yaml \\
        --output runs/pointnerf --device cpu
    python -m npcd_tpu_torch.train_diffusion --config configs/npcd_synthetic_tiny.yaml \\
        --output runs/diffusion --dtype float32 --device cpu --pointnerf_weights \\
        runs/pointnerf/weights_only_checkpoints_dir/pointnerf-iter-<n>.npz

``--mesh`` trains data parallel, one process a card, as train_diffusion's
does (the config's batch_size is the global batch; rank 0 writes);
``--platform`` chooses a JAX backend and is refused.
"""
from __future__ import annotations

import argparse
import random


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output", help="Path to folder for output data.", required=True)
    p.add_argument("--config", help="Path to config file.", required=True)
    p.add_argument("--seed", type=int, default=42, help="Random seed. Default: 42.")
    p.add_argument("--num_workers", type=int, default=8,
                   help="Accepted for flag parity; batches are collated in-process.")
    p.add_argument("--no_tensorboard", action="store_true",
                   help="Do not log to tensorboard. Default: do log.")
    p.add_argument("--wandb", action="store_true",
                   help="Log to Weights & Biases (requires the wandb package).")
    p.add_argument("--exp_id", type=str, help="Experiment ID.")
    p.add_argument("--comment", type=str, help="Comment for the experiment.")
    p.add_argument("--mesh", action="store_true",
                   help="Data parallelism over every visible card (or the launcher's group).")
    p.add_argument("--platform", type=str, default=None,
                   help="A JAX backend flag; the port refuses it (use --device).")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def train(args, config=None, dataset=None):
    """Build and run the trainer as the CLI does; ``config`` replaces the
    file's (a loaded config dict, e.g. with overrides) and ``dataset`` the
    config's dataset -> the trainer."""
    import torch

    from .eval_diffusion import close_output, open_output, start
    from .losses import PointNeRFLossWeights
    from .parallel import is_main
    from .train import PointNeRFTraining
    from .utils.builders import build_dataset, build_pointnerf
    from .utils.config import load_config, print_config

    device, mesh = start(args)
    open_output(args, args.output, mesh)
    try:
        config = config if config is not None else load_config(args.config)
        if is_main(mesh):
            print_config(config)
        if dataset is None:
            dataset = build_dataset(config, view_rng=random.Random(args.seed))
        training = PointNeRFTraining(
            out_dir=args.output, model=build_pointnerf(
                config, torch.Generator().manual_seed(args.seed), with_tables=True),
            dataset=dataset,
            loss_weights=PointNeRFLossWeights(image_reconstruction=1.0,
                                              neural_point_cloud_kl=1e-7,
                                              neural_point_cloud_tv=3.5e-7),
            seed=args.seed, device=device, mesh=mesh, **config["pointnerf_training"])
        training()
    finally:
        close_output(args.output, mesh)
    return training


def main(argv=None):
    """The command line -> the trainer. ``--mesh`` alone on several cards
    starts a worker a card, each running this again under the launcher's
    environment, and -> None."""
    from .parallel import spawn_cli

    args = parse_args(argv)
    if args.mesh and spawn_cli(main, argv, args.device):
        return None
    return train(args)


if __name__ == "__main__":
    main()

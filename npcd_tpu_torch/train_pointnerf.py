"""Stage-1 CLI: train the PointNeRF autodecoder with the PyTorch port.

Port of train_pointnerf.py (same flags and config schema), plus
``--device`` (default cuda). Runs in exact f32 (TF32 off). The final
weights-only export, ``<output>/weights_only_checkpoints_dir/
pointnerf-iter-<n>.npz``, is the bridged ``.npz`` that stage 2 and
generation read:

    python -m npcd_tpu_torch.train_pointnerf --config configs/npcd_synthetic_tiny.yaml \\
        --output runs/pointnerf --device cpu
    python -m npcd_tpu_torch.train_diffusion --config configs/npcd_synthetic_tiny.yaml \\
        --output runs/diffusion --dtype float32 --device cpu --pointnerf_weights \\
        runs/pointnerf/weights_only_checkpoints_dir/pointnerf-iter-<n>.npz

``--mesh`` (data parallelism) is not ported yet and raises
NotImplementedError; ``--platform`` chooses a JAX backend and is refused.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import sys


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
    p.add_argument("--mesh", action="store_true", help="Data parallelism (not ported yet).")
    p.add_argument("--platform", type=str, default=None,
                   help="A JAX backend flag; the port refuses it (use --device).")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def train(args, config=None, dataset=None):
    """Build and run the trainer as the CLI does; ``config`` replaces the
    file's (a loaded config dict, e.g. with overrides) and ``dataset`` the
    config's dataset -> the trainer."""
    from .generate_samples import _device, exact_f32
    from .losses import PointNeRFLossWeights
    from .train import PointNeRFTraining
    from .utils import logging, writer
    from .utils.builders import build_dataset, build_pointnerf
    from .utils.config import load_config, print_config

    if args.platform:
        raise ValueError(f"--platform {args.platform}: a JAX backend flag; the PyTorch port "
                         "takes --device cuda or --device cpu")
    if args.mesh:
        raise NotImplementedError("--mesh: multi-GPU training is the 'Data parallelism' item "
                                  "of ROADMAP Queue 1")
    import torch

    exact_f32()
    device = _device(args.device)
    os.makedirs(args.output, exist_ok=True)
    logging.add_log_file(osp.join(args.output, "log.txt"))
    with open(osp.join(args.output, "cmd.txt"), "a") as f:
        f.write(" ".join(sys.argv) + "\n")
    writer.setup_writers(args.output, tensorboard=not args.no_tensorboard, wandb=args.wandb,
                         exp_id=args.exp_id, comment=args.comment)
    try:
        config = config if config is not None else load_config(args.config)
        print_config(config)
        dataset = dataset if dataset is not None else build_dataset(config)
        training = PointNeRFTraining(
            out_dir=args.output, model=build_pointnerf(
                config, torch.Generator().manual_seed(args.seed), with_tables=True),
            dataset=dataset,
            loss_weights=PointNeRFLossWeights(image_reconstruction=1.0,
                                              neural_point_cloud_kl=1e-7,
                                              neural_point_cloud_tv=3.5e-7),
            seed=args.seed, device=device, **config["pointnerf_training"])
        training()
    finally:
        writer.close_writers()
        logging.remove_log_file(osp.join(args.output, "log.txt"))
    return training


if __name__ == "__main__":
    train(parse_args())

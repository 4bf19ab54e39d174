"""Stage-2 eval CLI: FID/KID of unconditional generation, with the PyTorch
port.

Port of eval_diffusion.py (same flags and config schema), plus ``--device``
(default cuda): generate the config's ``diffusion_evaluation.num_samples``
clouds, render each from the fixed test poses and compute FID and KID
against precomputed Inception statistics; results in
``<output>/results.json`` and ``results.csv``, a run whose results exist is
skipped. ``--weights`` is the bridged ``.npz`` that generate_samples reads
(utils/from_jax.py):

    python -m npcd_tpu_torch.eval_diffusion --config configs/npcd_srncars.yaml \\
        --weights runs/diffusion/weights_only_checkpoints_dir/npcd-ema_<...>-iter-<n>.npz \\
        --output runs/eval_fid

The config's ``diffusion_evaluation`` section is passed to
DiffusionEvaluation; ``--render_dtype`` overrides its ``render_dtype``.
``--matmul_precision`` (default ``highest``) is set into the config's
``render_config.matmul_precision`` unless the config sets one or the flag
is ``default``: the render's cuBLAS GEMMs run in exact f32 under
``highest`` / ``float32`` and in TF32 under ``tensorfloat32``. The sampler
runs in exact f32 under every setting, as npcd_tpu's keeps its own
precision. ``--mesh`` evaluates data parallel, one process a card
(parallel/mesh.py; under a launcher's environment it joins that group,
alone it starts one worker a visible card): the objects shard over the
ranks and rank 0 computes FID/KID and writes (DiffusionEvaluation).
``--platform`` chooses a JAX backend and is refused.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import sys


def parse_args(argv=None):
    from .models.pointnerf.pointnerf import CLI_MATMUL_PRECISIONS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output", help="Path to folder for output data.")
    p.add_argument("--config", help="Path to config file.", required=True)
    p.add_argument("--weights", help="Path to weights of the model (.npz).", required=True)
    p.add_argument("--seed", type=int, default=42, help="Random seed. Default: 42.")
    p.add_argument("--eval_name", type=str, help="Name of the evaluation. Optional.")
    p.add_argument("--finished_iterations", type=int,
                   help="Training iterations of the model (logging only).")
    p.add_argument("--num_qualitatives", type=int, default=10,
                   help="Number of qualitative renders to save.")
    p.add_argument("--log_dir", help="Folder for tensorboard logs. Default: output dir.")
    p.add_argument("--render_dtype", choices=["float32", "bfloat16"],
                   help="Override the FID render precision (float32: exact; bfloat16: the "
                        "render's MLPs in bf16, as configs/npcd_srncars_fast.yaml sets it).")
    p.add_argument("--no_tensorboard", action="store_true")
    p.add_argument("--wandb", action="store_true",
                   help="Log to Weights & Biases (requires the wandb package).")
    p.add_argument("--exp_id", type=str)
    p.add_argument("--comment", type=str)
    p.add_argument("--platform", type=str, default=None,
                   help="A JAX backend flag; the port refuses it (use --device).")
    p.add_argument("--matmul_precision", default="highest",
                   choices=CLI_MATMUL_PRECISIONS,
                   help="The render's f32 matmul precision (render_config."
                        "matmul_precision): highest / float32 exact, tensorfloat32 TF32, "
                        "default the config's or PyTorch's.")
    p.add_argument("--mesh", action="store_true",
                   help="Data parallelism over every visible card (or the launcher's group).")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def start(args):
    """Refuse --platform before anything is built or written, seed Python's
    and numpy's RNGs with --seed (as npcd_tpu's CLIs), then the eval's
    device and mesh (None without --mesh) -> (device, mesh)."""
    from .generate_samples import _device, exact_f32
    from .parallel import make_mesh
    from .utils.util import set_seed

    if args.platform:
        raise ValueError(f"--platform {args.platform}: a JAX backend flag; the PyTorch port "
                         "takes --device cuda or --device cpu")
    set_seed(args.seed)
    exact_f32()
    device = _device(args.device)
    mesh = make_mesh(device) if args.mesh else None
    return (device if mesh is None else mesh.device), mesh


def open_output(args, out_dir, mesh=None) -> None:
    """The log file, cmd.txt and the metric writers of a CLI's run (rank 0's
    under a mesh); the writers in ``args.log_dir`` where the CLI has one."""
    from .parallel import is_main
    from .utils import logging, writer

    if out_dir and is_main(mesh):
        os.makedirs(out_dir, exist_ok=True)
        logging.add_log_file(osp.join(out_dir, "log.txt"))
        with open(osp.join(out_dir, "cmd.txt"), "a") as f:
            f.write(" ".join(sys.argv) + "\n")
        writer.setup_writers(getattr(args, "log_dir", None) or out_dir,
                             tensorboard=not args.no_tensorboard,
                             wandb=args.wandb, exp_id=args.exp_id, comment=args.comment)


def close_output(out_dir, mesh=None) -> None:
    from .parallel import is_main
    from .utils import logging, writer

    if not is_main(mesh):
        return
    writer.close_writers()
    if out_dir:
        logging.remove_log_file(osp.join(out_dir, "log.txt"))


def evaluate(args, config=None) -> dict:
    """Build and run the evaluation as the CLI does; ``config`` replaces the
    file's (a loaded config dict) -> the results {fid, fid_mean, fid_cov,
    kid}."""
    import torch

    from .eval import DiffusionEvaluation
    from .models.npcd import NPCD
    from .models.pointnerf.pointnerf import set_render_precision
    from .utils import logging
    from .parallel import is_main
    from .utils.config import load_config, print_config
    from .utils.from_jax import load_npz

    device, mesh = start(args)
    open_output(args, args.output, mesh)
    try:
        config = set_render_precision(config if config is not None else load_config(args.config),
                                      args.matmul_precision)
        if is_main(mesh):
            print_config(config)
        model = NPCD.from_config(config, seed=args.seed)
        state = load_npz(model, args.weights)
        model = model.to(device).eval()
        logging.info(f"Loaded weights from {args.weights}")
        eval_kw = dict(config["diffusion_evaluation"])
        if args.render_dtype:
            eval_kw["render_dtype"] = None if args.render_dtype == "float32" else args.render_dtype
        evaluation = DiffusionEvaluation(out_dir=args.output, device=device, mesh=mesh,
                                         **eval_kw)
        results = evaluation(model, state,
                             generator=torch.Generator(device=device).manual_seed(args.seed),
                             num_qualitatives=args.num_qualitatives, kid_seed=args.seed)
    finally:
        close_output(args.output, mesh)
    return results


def main(argv=None):
    """The command line -> the results (None where ``--mesh`` alone started a
    worker a card)."""
    from .parallel import spawn_cli

    args = parse_args(argv)
    if args.mesh and spawn_cli(main, argv, args.device):
        return None
    return evaluate(args)


if __name__ == "__main__":
    main()

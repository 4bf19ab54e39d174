"""Where the device time of a stage-2 training step goes, on one GPU.

    python -m npcd_tpu_torch.profile_training [--dtype float32|float16|bfloat16]

Builds the trainer as ``python -m npcd_tpu_torch.train_diffusion`` does on
configs/npcd_srncars.yaml (302M denoiser, batch 32; ``--dtype`` as the
CLI's, default float32: exact f32; float16 and bfloat16: bf16 compute with
block remat) over seeded
latent tables of the config's size (2347 objects x 512 points x (3 + 32)),
runs WARMUP steps (which compile the Triton kernels), then times WINDOWS
windows of STEPS steps each (host clock after a device synchronize: the
spread between windows), and profiles PROFILED steps with torch.profiler:
wall time, summed device time, device busy share and the TOP kernels by
self device time. Writes nothing outside runs/profile_training. Run it
from the repository root.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .data import PointNeRFDataset
from .generate_samples import exact_f32
from .profile_generation import _report
from .train import DiffusionTraining
from .train_diffusion import DTYPES
from .utils.builders import build_diffusion_model, torch_dtype
from .utils.config import load_config

WARMUP, WINDOWS, STEPS, PROFILED = 3, 3, 5, 2


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a GPU")
    exact_f32()
    config = load_config("configs/npcd_srncars.yaml")
    m = config["model"]
    rng = np.random.default_rng(0)
    dataset = PointNeRFDataset(
        rng.uniform(-0.5, 0.5, (m["n_obj"], m["num_points"], 3)).astype(np.float32),
        rng.standard_normal((m["n_obj"], m["num_points"], m["feats_dim"]), dtype=np.float32))
    dtype, remat = DTYPES[args.dtype]
    model = build_diffusion_model(config, dtype=torch_dtype(dtype), remat=remat)
    trainer = DiffusionTraining("runs/profile_training", model,
                                dataset, seed=0, device="cuda", verbose=False,
                                **config["diffusion_training"])
    batches = trainer.batches(trainer.step)
    for _ in range(WARMUP):
        trainer.train_step(next(batches))
    rates = []
    for _ in range(WINDOWS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            trainer.train_step(next(batches))
        torch.cuda.synchronize()
        rates.append(STEPS / (time.perf_counter() - t0))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train x{STEPS}] {args.dtype} (compute {dtype}, remat {remat}) steps/s per window: "
          + " ".join(f"{r:.4f}" for r in rates) + f"; peak {peak_gib:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            trainer.train_step(next(batches))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"train step x{PROFILED}", prof, wall)


if __name__ == "__main__":
    main()

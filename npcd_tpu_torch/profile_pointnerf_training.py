"""Where the device time of a stage-1 training step goes, on one GPU.

    python -m npcd_tpu_torch.profile_pointnerf_training

Builds the trainer as ``python -m npcd_tpu_torch.train_pointnerf`` does on
configs/npcd_srncars.yaml (B 8 objects x V 50 views, 112 rays x 128
samples, validity 'knn', remat on, exact f32) over a seeded synthetic
dataset of the config's 2347 clouds at 128^2 (no SRN data is in the
repository), runs WARMUP steps, then times WINDOWS windows of STEPS steps
each (host clock after a device synchronize: the spread between windows),
and profiles PROFILED steps with torch.profiler: wall time, summed device
time, device busy share and the TOP kernels by self device time. Writes
nothing outside runs/profile_pointnerf_training. Run it from the
repository root.
"""
from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

from .data import SyntheticNPCTrain
from .generate_samples import exact_f32
from .profile_generation import _report
from .train import PointNeRFTraining
from .utils.builders import build_pointnerf
from .utils.config import load_config

WARMUP, WINDOWS, STEPS, PROFILED = 2, 3, 3, 2


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_pointnerf_training needs a GPU")
    exact_f32()
    config = load_config("configs/npcd_srncars.yaml")
    m = config["model"]
    model = build_pointnerf(config, torch.Generator().manual_seed(0), with_tables=True)
    dataset = SyntheticNPCTrain(n_obj=m["n_obj"], num_views=50,
                                image_size=model.opts.default_resolution,
                                num_points=m["num_points"], seed=0)
    trainer = PointNeRFTraining("runs/profile_pointnerf_training", model, dataset, seed=0,
                                device="cuda", verbose=False, **config["pointnerf_training"])
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
    print(f"[stage1 x{STEPS}] steps/s per window: " + " ".join(f"{r:.4f}" for r in rates)
          + f"; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            trainer.train_step(next(batches))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"stage1 step x{PROFILED}", prof, wall)


if __name__ == "__main__":
    main()

"""Where the time of a stage-1 training step goes, on one GPU.

    python -m npcd_tpu_torch.profile_pointnerf_training [--config CONFIG]

Builds the trainer as ``python -m npcd_tpu_torch.train_pointnerf`` does on
CONFIG (default configs/npcd_srncars.yaml: B 8 objects x V 50 views, 112
rays x 128 samples, validity 'knn', remat on, exact f32;
configs/npcd_srncars_fast.yaml adds bf16 compute, the shading budget of
1792 and one instance chunk, remat off) over a seeded synthetic dataset of
the config's 2347 clouds at 128^2, and steps it as its loop does: each
step on the next device feed, which a thread prefetches (``feeds``). Runs
WARMUP steps, then times WINDOWS windows of STEPS steps each (host clock
after a device synchronize: the spread between windows), and profiles
PROFILED steps with torch.profiler: wall time, summed device time, device
busy share, the TOP kernels by self device time, and the host's time a
step by cause (host clock, each on its own thread): the step's thread in
the step (the launches) and waiting for its next feed, the prefetch
thread in a feed (the loader's presample and gather, and the copies to
the device). Writes nothing outside runs/profile_pointnerf_training. Run
it from the repository root.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
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


class _Clock:
    """Host seconds and counts by name, summed from several threads."""

    def __init__(self):
        self.s, self.n = collections.Counter(), collections.Counter()

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.s[name] += time.perf_counter() - t0
            self.n[name] += 1

    def ms(self, name: str) -> float:
        return 1e3 * self.s[name] / max(1, self.n[name])


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/npcd_srncars.yaml")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_pointnerf_training needs a GPU")
    exact_f32()
    config = load_config(args.config)
    m = config["model"]
    model = build_pointnerf(config, torch.Generator().manual_seed(0), with_tables=True)
    dataset = SyntheticNPCTrain(n_obj=m["n_obj"], num_views=50,
                                image_size=model.opts.default_resolution,
                                num_points=m["num_points"], seed=0)
    trainer = PointNeRFTraining("runs/profile_pointnerf_training", model, dataset, seed=0,
                                device="cuda", verbose=False, **config["pointnerf_training"])
    clock = _Clock()
    feed_fn, to_device = trainer._feed, trainer._to_device

    def feed(indices):
        with clock("feed"):
            return feed_fn(indices)

    def copy(*args):
        with clock("copy"):
            return to_device(*args)

    trainer._feed, trainer._to_device = feed, copy

    def step(feeds):
        with clock("wait"):
            f = next(feeds)
        with clock("step"):
            trainer.train_feed(f)

    with contextlib.closing(trainer.feeds(trainer.step)) as feeds:
        for _ in range(WARMUP):
            step(feeds)
        rates = []
        for _ in range(WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                step(feeds)
            torch.cuda.synchronize()
            rates.append(STEPS / (time.perf_counter() - t0))
        print(f"[stage1 {args.config} x{STEPS}] steps/s per window: "
              + " ".join(f"{r:.4f}" for r in rates)
              + f"; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            clock = _Clock()
            t0 = time.perf_counter()
            for _ in range(PROFILED):
                step(feeds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _report(f"stage1 step x{PROFILED}", prof, wall)
    print(f"[stage1 step x{PROFILED}] host ms: wall {wall * 1e3 / PROFILED:.3f} a step; step "
          f"thread: launches {clock.ms('step'):.3f}, waiting for its feed {clock.ms('wait'):.3f}; "
          f"prefetch thread ({clock.n['feed']} feeds): loader "
          f"{clock.ms('feed') - clock.ms('copy'):.3f}, copies to the device {clock.ms('copy'):.3f}")


if __name__ == "__main__":
    main()

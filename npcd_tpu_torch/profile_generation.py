"""Where the device time of the generation path goes, on one GPU.

    python -m npcd_tpu_torch.profile_generation

Runs generate_samples at chip_smoke.py's main-path shapes
(configs/npcd_srncars.yaml, seeded weights, batch 2, validity 'voxel',
exact f32), which also warms up every kernel, then profiles with
torch.profiler (1) STEPS sampler steps at that batch and (2) one render of
the generated clouds from 4 SRN test poses at 128². For each window it
prints the wall time, the summed device time of its kernels, their share
of the wall time (device busy share) and the TOP kernels by self device
time. Run it from the repository root.
"""
from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .generate_samples import parse_args, render, run

ARGV = ["--config", "configs/npcd_srncars.yaml", "--out", "runs/profile_generation",
        "--num", "2", "--batch-size", "2", "--seed", "0", "--render", "2",
        "--render-poses", "4", "--poses", "data/srncars_test_poses.npy",
        "--intrinsics", "data/srncars_test_intrinsics.npy", "--resolution", "128"]
STEPS = 5  # sampler steps in the profiled window
TOP = 12  # kernels listed per window


def _report(name: str, prof, wall_s: float) -> None:
    # device-side rows only: a CPU op's row repeats the time of its kernels
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_us = sum(e.self_device_time_total for e in events)
    print(f"[{name}] wall {wall_s * 1e3:.3f} ms, device {busy_us / 1e3:.3f} ms, "
          f"busy share {busy_us / (wall_s * 1e6):.3f}")
    for e in events[:TOP]:
        print(f"[{name}]   {e.self_device_time_total / 1e3:10.3f} ms "
              f"{100 * e.self_device_time_total / busy_us:5.1f}%  x{e.count:<6d} {e.key[:90]}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_generation needs a GPU")
    args = parse_args(ARGV)
    out = run(args)  # the model, the warm-up and the clouds to render
    model, state, dm = out["model"], out["state"], out["model"].diffusion
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    noise = lambda shape: torch.randn(shape, generator=gen, device=dev)
    process = dm.process.to(dev)
    c = noise((args.batch_size, dm.coords_dim, dm.num_points))
    f = noise((args.batch_size, dm.feats_dim, dm.num_points))
    clip = lambda s: (s.min[0].to(dev), s.max[0].to(dev))
    torch.cuda.synchronize()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(STEPS):
            t = torch.full((args.batch_size,), 999 - step, dtype=torch.long, device=dev)
            step_out = process.p_sample(noise, dm.denoiser, c, f, t,
                                        clip(state.coords_norm), clip(state.feats_norm))
            c, f = step_out.coords, step_out.feats
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(f"sampler x{STEPS}", prof, wall)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(model, out["coords"], out["feats"], out["poses"], out["intrinsics"],
               args.resolution, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report("render", prof, wall)


if __name__ == "__main__":
    main()

"""Generate neural point clouds with the PyTorch port and render them.

Port of tools/generate_samples.py: sample ``--num`` point clouds with the
1000-step DDPM sampler, save them as ``samples.npz`` (coords [N, 3, P],
feats [N, F, P]) and optionally render the first ``--render`` of them from
``--render-poses`` fixed test poses (one PNG per object, poses side by
side). ``--trajectory-stride N`` also saves the reverse process's states
after every N-th step (``trajectory_coords`` [T/N + 1, num, 3, P] and
``trajectory_feats``, x_T first, in normalized latent space) in
``samples.npz``. ``--swap N`` renders ``swap_grid.png``: an N x N grid from
the first pose whose cell (i, j) has the coords (shape) of sample i and the
feats (appearance) of sample j. Runs in exact f32 (TF32 off for matmuls and
convolutions).

    python -m npcd_tpu_torch.generate_samples --config configs/npcd_srncars.yaml \\
        --out runs/samples --num 2 --batch-size 2 --render 2 \\
        --poses data/srncars_test_poses.npy --intrinsics data/srncars_test_intrinsics.npy

``--weights PATH.npz`` (required, as in the JAX CLI) holds the parameters
and normalizer stats bridged from the JAX package or exported by the port's
trainers (utils/from_jax.py). Samples render with the config's
``render_config.validity`` ('knn' unless it says otherwise); ``--validity``
overrides it. ``--mesh`` samples data parallel, one process a card
(parallel/mesh.py; under a launcher's environment it joins that group,
alone it starts one worker a visible card): each rank samples its rows of
every generate batch that divides by the world, from the batch's noise drawn
whole on every rank, and the clouds are gathered; rank 0 renders and writes
the files. ``--platform`` chooses a JAX backend and is refused.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import struct
import time
import zlib

import numpy as np
import torch

from .utils.vis import tile_images


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--weights", required=True, help="bridged parameters (.npz)")
    p.add_argument("--num", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--trajectory-stride", type=int, default=0,
                   help="if > 0, also save the reverse-process trajectory, every N-th step")
    p.add_argument("--render", type=int, default=0,
                   help="render the first N generated objects")
    p.add_argument("--poses", help="[V, 4, 4] .npy of world2cam poses")
    p.add_argument("--intrinsics", help="[V, 3, 3] .npy")
    p.add_argument("--render-poses", type=int, default=4, help="poses per rendered object")
    p.add_argument("--swap", type=int, default=0,
                   help="render an N x N grid crossing the first N samples' shapes (coords, "
                        "rows) with their appearances (feats, columns) from the first pose")
    p.add_argument("--resolution", type=int, default=128)
    p.add_argument("--device", default="cuda")
    p.add_argument("--validity", choices=["voxel", "knn"], default=None,
                   help="the render's sample-validity test; default: the config's")
    p.add_argument("--mesh", action="store_true",
                   help="data-parallel sampling over every visible card (or the launcher's "
                        "group)")
    p.add_argument("--platform", default=None, choices=["cpu", "tpu"],
                   help="a JAX backend; refused (use --device)")
    args = p.parse_args(argv)
    for flag in ("render", "swap"):
        if getattr(args, flag) > 0 and not (args.poses and args.intrinsics):
            p.error(f"--{flag} requires --poses and --intrinsics")
    return args


def exact_f32() -> None:
    """The 'highest' numerics of record: no TF32 in PyTorch's matmuls and
    convolutions, and bf16 GEMMs reduce in f32 (as XLA's bf16 dots
    accumulate). The port's own f32 kernels on the tensor cores (K1f, K1b,
    K8f, K8b, K6f and K6b's products) run in 3xTF32, split products held
    within 1e-5 of their outputs' scale of float64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no GPU found")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def write_seeded_weights(config_path: str, path: str, seed: int = 0) -> str:
    """Seeded weights (``NPCD.from_config``) and normalizer stats
    (``NPCD.seeded_state``) of the config's model, written to ``path`` as
    the bridged .npz ``--weights`` reads, for runs without trained weights
    -> path."""
    from .models.npcd import NPCD
    from .utils.config import load_config
    from .utils.from_jax import npcd_flat, save_npz

    model = NPCD.from_config(load_config(config_path), seed=seed)
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    save_npz(path, npcd_flat(model, model.seeded_state(seed)))
    return path


def run(args) -> dict:
    """Build, sample and render as the CLI does, without writing files:
    -> {model, state, coords, feats, trajectory (a Trajectory) or None,
    channels [n, V, R, 3] or None, swap [n*n, 1, R, 3] or None, poses,
    intrinsics, sample_s, render_s, swap_s, mesh}; under ``--mesh`` every
    rank has the samples and rank 0 the renders."""
    from .models.npcd import NPCD
    from .parallel import is_main, make_mesh
    from .utils.config import load_config
    from .utils.from_jax import load_npz

    if args.platform:
        raise ValueError(f"--platform {args.platform}: a JAX backend flag; the PyTorch port "
                         "takes --device cuda or --device cpu")
    exact_f32()
    device = _device(args.device)
    mesh = make_mesh(device) if args.mesh else None
    if mesh is not None:
        device = mesh.device
    model = NPCD.from_config(load_config(args.config), validity=args.validity, seed=args.seed)
    state = load_npz(model, args.weights)
    model = model.to(device).eval()

    generator = torch.Generator(device=device).manual_seed(args.seed)
    _sync(device)
    t0 = time.perf_counter()
    gen = model.diffusion.generate(state, args.num, args.batch_size, generator=generator,
                                   return_trajectory=args.trajectory_stride > 0,
                                   trajectory_stride=max(args.trajectory_stride, 1), mesh=mesh)
    sample_s = time.perf_counter() - t0
    coords, feats = gen[0], gen[1]

    out = {"model": model, "state": state, "coords": coords, "feats": feats,
           "trajectory": gen[2] if args.trajectory_stride > 0 else None,
           "channels": None, "swap": None, "sample_s": sample_s, "render_s": 0.0,
           "swap_s": 0.0, "mesh": mesh}
    if not is_main(mesh):
        return out
    if args.swap > 0:
        pose = np.load(args.poses)[:1].astype(np.float32)
        intr = np.load(args.intrinsics)[:1].astype(np.float32)
        _sync(device)
        t0 = time.perf_counter()
        swap = render_swap(model, coords, feats, pose, intr, min(args.swap, args.num),
                           args.resolution, device)
        _sync(device)
        out.update(swap=swap, swap_s=time.perf_counter() - t0)
    if args.render > 0:
        poses = np.load(args.poses)[: args.render_poses].astype(np.float32)
        intr = np.load(args.intrinsics)[: args.render_poses].astype(np.float32)
        n = min(args.render, args.num)
        _sync(device)
        t0 = time.perf_counter()
        res = render(model, coords[:n], feats[:n], poses, intr, args.resolution, device)
        _sync(device)
        out.update(channels=res["channels"], render_s=time.perf_counter() - t0,
                   poses=poses, intrinsics=intr)
    return out


def render(model, coords: np.ndarray, feats: np.ndarray, poses: np.ndarray,
           intrinsics: np.ndarray, resolution: int, device: torch.device) -> dict:
    """Each cloud (coords [n, 3, P], feats [n, F, P]) from every pose
    (poses [V, 4, 4], intrinsics [V, 3, 3]) -> PointNeRF.render's dict
    (channels [n, V, resolution**2, 3])."""
    n = coords.shape[0]
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return model.pointnerf.render(
        as_t(coords.transpose(0, 2, 1)), as_t(feats.transpose(0, 2, 1)),
        as_t(np.broadcast_to(poses[None], (n,) + poses.shape)),
        as_t(np.broadcast_to(intrinsics[None], (n,) + intrinsics.shape)), resolution=resolution)


def render_swap(model, coords: np.ndarray, feats: np.ndarray, pose: np.ndarray,
                intrinsics: np.ndarray, n: int, resolution: int,
                device: torch.device) -> torch.Tensor:
    """The first n clouds' shapes crossed with their appearances, each of
    the n*n instances rendered from pose [1, 4, 4], intrinsics [1, 3, 3]:
    instance i*n + j has the coords of cloud i and the feats of cloud j
    -> channels [n*n, 1, resolution**2, 3]."""
    return render(model, np.repeat(coords[:n], n, axis=0), np.tile(feats[:n], (n, 1, 1)),
                  pose, intrinsics, resolution, device)["channels"]


def write_png(path: str, img: np.ndarray) -> None:
    """img [H, W, 3] in [0, 1] -> 8-bit RGB PNG."""
    h, w, _ = img.shape
    rows = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    raw = b"".join(b"\x00" + rows[i].tobytes() for i in range(h))
    chunk = lambda tag, data: (struct.pack(">I", len(data)) + tag + data
                               + struct.pack(">I", zlib.crc32(tag + data)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def main(argv=None) -> dict:
    """The command line -> run's dict (None where ``--mesh`` alone started a
    worker a card). Under a mesh only rank 0 writes, and the others wait for
    it."""
    from .parallel import barrier, is_main, spawn_cli

    args = parse_args(argv)
    if args.mesh and spawn_cli(main, argv, args.device):
        return None
    out = run(args)
    if is_main(out["mesh"]):
        write_outputs(args, out)
    barrier(out["mesh"])
    return out


def write_outputs(args, out: dict) -> None:
    """samples.npz, and the PNGs of --swap and --render, under --out."""
    os.makedirs(args.out, exist_ok=True)
    arrays = {"coords": out["coords"], "feats": out["feats"]}
    if out["trajectory"] is not None:
        arrays.update(trajectory_coords=out["trajectory"].coords_ts,
                      trajectory_feats=out["trajectory"].feats_ts)
    np.savez(osp.join(args.out, "samples.npz"), **arrays)
    print(f"saved {args.num} point clouds to {osp.join(args.out, 'samples.npz')} "
          f"({out['sample_s']:.1f} s)")
    if out["swap"] is not None:
        res = args.resolution
        n = min(args.swap, args.num)
        grid = out["swap"].float().cpu().numpy().reshape(n * n, res, res, 3)
        write_png(osp.join(args.out, "swap_grid.png"), tile_images(list(grid), cols=n))
        print(f"saved the {n}x{n} shape (rows) x appearance (columns) grid to "
              f"{osp.join(args.out, 'swap_grid.png')} ({out['swap_s']:.1f} s)")
    if out["channels"] is not None:
        res = args.resolution
        images = out["channels"].float().cpu().numpy()
        n, v = images.shape[:2]
        images = images.reshape(n, v, res, res, 3)
        for i in range(n):
            write_png(osp.join(args.out, f"sample{i:04d}.png"),
                      np.concatenate(list(images[i]), axis=1))
        print(f"rendered {n} objects x {v} poses to {args.out} ({out['render_s']:.1f} s)")


if __name__ == "__main__":
    main()

"""Kernel K5's filtered minimum distance (``min_d2_kernel`` of
npcd_tpu_torch/csrc/knn.cu) transcribed in numpy, and the inputs on which
such a filter is easy to get wrong. tests/test_torch_min_d2.py holds the
transcription bitwise to min_d2_plain; tests/test_torch_kernels_cuda.py and
chip_smoke.py hold the kernel to it on ``hard_min_d2_inputs``.

    python -m tests.min_d2_filter  # from the repository root

prints, for the stage-1 step's own inputs (the first objects of the seeded
synthetic dataset from all 50 views, queries sampled along the step's rays
as its forward samples them), for uniform clouds and for
``hard_min_d2_inputs``, each at 14,336 queries against 512 points, how many
groups of points the filter lets through a query and how many exact
distances that costs. Runs on the CPU in about a minute."""
from __future__ import annotations

import numpy as np
import torch


def hard_min_d2_inputs(inst: int, n: int, p: int, seed: int = 0, device="cpu"):
    """Inputs on which a filtered minimum distance is easy to get wrong ->
    (x [inst, n, 3], points [inst, p, 3]) f32. The instances take four
    kinds of cloud in turn: uniform in the cloud's extent [-0.5, 0.5]^3; a
    grid of step 1/4 there (exact ties in d2, duplicated points); two
    positions only (about half the points on each); near the extent's
    corners (the largest |p|). Point 1 is a copy of point 0. The queries
    take four kinds in turn: uniform in the render cube [-1, 1]^3; near its
    corners (|x| near sqrt(3)); near the midpoint of a point and its
    nearest distinct point, on their bisector plane, where the two nearest
    d2 fall a few ulps apart and an approximate distance may order them
    the other way; on the nodes of a grid of step 1/4."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = lambda *shape: torch.rand(*shape, generator=g, device=device)
    kind = (torch.arange(inst, device=device) % 4)[:, None, None]
    two = u(inst, 2, 3) - 0.5
    side = torch.randint(0, 2, (inst, p), generator=g, device=device)
    clouds = (u(inst, p, 3) - 0.5,
              torch.randint(-2, 3, (inst, p, 3), generator=g, device=device) / 4,
              torch.gather(two, 1, side[..., None].expand(inst, p, 3)),
              torch.sign(u(inst, p, 3) - 0.5) * (0.5 - 0.02 * u(inst, p, 3)))
    pts = clouds[0]
    for k in (1, 2, 3):
        pts = torch.where(kind == k, clouds[k], pts)
    if p > 1:
        pts[:, 1] = pts[:, 0]
    x = 2 * u(inst, n, 3) - 1
    if p:
        j = torch.randint(0, p, (inst, n), generator=g, device=device)
        a = torch.gather(pts, 1, j[..., None].expand(inst, n, 3))
        d2 = (pts[:, :, None] - pts[:, None]).square().sum(-1)
        d2[d2 == 0] = float("inf")  # itself and its copies
        near = torch.where(d2.isinf().all(-1), torch.arange(p, device=device), d2.argmin(-1))
        b = torch.gather(pts, 1, torch.gather(near, 1, j)[..., None].expand(inst, n, 3))
        w = torch.linalg.cross(b - a, torch.randn(inst, n, 3, generator=g, device=device))
        w = w / w.norm(dim=-1, keepdim=True).clamp_min(1e-30)
        mid = (a + b) / 2 + 0.25 * (b - a).norm(dim=-1, keepdim=True) * u(inst, n, 1) * w
        x = torch.where((torch.arange(n, device=device) % 4 == 2)[None, :, None], mid, x)
    corner = torch.sign(u(inst, n, 3) - 0.5) * (1 - 0.01 * u(inst, n, 3))
    node = torch.randint(-4, 5, (inst, n, 3), generator=g, device=device) / 4
    q = (torch.arange(n, device=device) % 4)[None, :, None]
    x = torch.where(q == 1, corner, torch.where(q == 3, node, x))
    return x.contiguous(), pts.contiguous()


def fma(a, b, c):
    """fma in f32 as a product and sum in float64, rounded to f32 (the product
    of two f32 is exact in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def k5_filter(x, pts, pad_to):
    """K5's filter on x [I, N, 3] and pts [I, P, 3] (numpy f32): point j
    stored as (-px, -py, -pz, |p|^2), |p|^2 = fma(pz, pz, fma(py, py,
    px*px)), padded to ``pad_to`` points with (0, 0, 0, inf); s = fma(-pz,
    2 x2, fma(-py, 2 x1, fma(-px, 2 x0, |p|^2))) of every pair, |p - x|^2 -
    |x|^2 up to rounding -> (points as stored [I, pad_to, 4], s [I, N,
    pad_to])."""
    inst, p = pts.shape[:2]
    nn = fma(pts[..., 2], pts[..., 2], fma(pts[..., 1], pts[..., 1], pts[..., 0] * pts[..., 0]))
    filt = np.concatenate([np.concatenate([-pts, nn[..., None]], -1),
                           np.tile(np.array([0, 0, 0, np.inf], np.float32), (inst, pad_to - p, 1))],
                          1)
    f, x2 = filt[:, None], 2 * x
    return filt, fma(f[..., 2], x2[..., 2:3], fma(f[..., 1], x2[..., 1:2],
                                                  fma(f[..., 0], x2[..., 0:1], f[..., 3])))


def k5_sweep(x, pts, groups=32, fault=None):
    """K5's arithmetic on x [I, N, 3] and pts [I, P, 3] (numpy f32): the
    filter s of ``k5_filter`` over the points padded to a multiple of
    ``groups``; its minimum per group (group g: points g, g + groups, ...)
    and over the groups, s_min; r2 the instance's largest |p|^2 and t =
    fl(r2 + |x|^2), |x|^2 as |p|^2; the bound fl(s_min + fma(2**-18, t,
    2**-100)), every group when t > 2**100; the exact d2 ((dx*dx + dy*dy) +
    dz*dz), rounded after each operation, minimised over the real points of
    the groups whose minimum is at most the bound. ``fault``: "filter"
    returns fl(s_min + |x|^2), "argmin" the exact d2 of the point with the
    least s alone -> (out [I, N] f32, groups taken a query [I, N], exact
    distances a query [I, N]: the real points of the groups taken)."""
    inst, n, _ = x.shape
    p = pts.shape[1]
    pp = -(-p // groups) * groups
    filt, s = k5_filter(x, pts, pp)
    m = s.reshape(inst, n, pp // groups, groups).min(2)
    s_min = m.min(-1)
    r2 = filt[:, :p, 3].max(-1, initial=0)
    xx = fma(x[..., 2], x[..., 2], fma(x[..., 1], x[..., 1], x[..., 0] * x[..., 0]))
    t = r2[:, None].astype(np.float32) + xx
    bound = s_min + fma(np.float32(2**-18), t, np.float32(2**-100))
    taken = ~(t <= 2**100)[..., None] | (m <= bound[..., None])
    d = [x[:, :, None, c] - pts[:, None, :, c] for c in range(3)]
    exact = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    mine = taken[..., np.arange(p) % groups]
    out = np.where(mine, exact, np.float32(np.inf)).min(-1, initial=np.inf).astype(np.float32)
    if fault == "filter":
        out = s_min + xx
    elif fault == "argmin":
        out = np.take_along_axis(exact, s[..., :p].argmin(-1)[..., None], -1)[..., 0]
    return out, taken.sum(-1), mine.sum(-1)


def stage1_inputs(objects: int = 2, seed: int = 0):
    """The min_d2 inputs of the dense stage-1 step (configs/npcd_srncars.yaml)
    on the first ``objects`` objects of the seeded synthetic dataset the
    stage-1 runs train on, from all 50 views -> (x [objects * 50, 14,336,
    3], points [objects * 50, 512, 3]) f32: the port's PointNeRF forward on
    the CPU, stopped where it calls within_radius; the pixel subset drawn as
    the trainer draws it."""
    from pathlib import Path

    from npcd_tpu_torch.data import SyntheticNPCTrain
    from npcd_tpu_torch.models.pointnerf import pointnerf as pointnerf_module
    from npcd_tpu_torch.utils.builders import build_pointnerf, build_pointnerf_options
    from npcd_tpu_torch.utils.config import load_config

    config = load_config(str(Path(__file__).resolve().parents[1] / "configs/npcd_srncars.yaml"))
    config["model"]["n_obj"] = objects
    opts = build_pointnerf_options(config)
    ds = SyntheticNPCTrain(n_obj=objects, num_views=50, image_size=opts.default_resolution,
                           num_points=config["model"]["num_points"], seed=seed)
    model = build_pointnerf(config, torch.Generator().manual_seed(seed), with_tables=True)
    model.set_all_coords(ds.get_all_coords())
    batch = ds.batch(np.arange(objects))
    pixel_idx = np.random.default_rng(seed).choice(
        opts.default_resolution ** 2, size=opts.renderer.ray_subsamples, replace=False)
    seen = []

    def capture(x, points, radius):
        seen.append((x, points))
        raise StopIteration

    radius_test = pointnerf_module.within_radius
    pointnerf_module.within_radius = capture
    try:
        with torch.no_grad():
            model(torch.arange(objects), torch.as_tensor(batch["intrinsics"]),
                  torch.as_tensor(batch["extrinsics"]), torch.as_tensor(pixel_idx),
                  generator=torch.Generator().manual_seed(seed))
    except StopIteration:
        pass
    finally:
        pointnerf_module.within_radius = radius_test
    x, points = seen[0]
    return x.contiguous(), points.contiguous()


def report(name: str, x: torch.Tensor, pts: torch.Tensor) -> None:
    """Groups taken and exact distances a query of ``k5_sweep`` on these
    inputs, an instance at a time; raises unless it equals min_d2_plain."""
    from npcd_tpu_torch.ops.kernels.knn import min_d2_plain

    taken, exact = [], []
    for i in range(x.shape[0]):
        out, t, e = k5_sweep(x[i:i + 1].numpy(), pts[i:i + 1].numpy())
        want = min_d2_plain(x[i:i + 1], pts[i:i + 1]).numpy()
        if not np.array_equal(out.view(np.int32), want.view(np.int32)):
            raise AssertionError(f"{name}: the transcription differs from min_d2_plain")
        taken.append(t)
        exact.append(e)
    taken, exact = np.concatenate(taken), np.concatenate(exact)
    print(f"{name}: {x.shape[0]} x {x.shape[1]} queries x {pts.shape[1]} points: queries "
          f"taking more than one group {float((taken > 1).mean()):.6f}, groups a query mean "
          f"{float(taken.mean()):.4f} max {int(taken.max())}, exact distances a query mean "
          f"{float(exact.mean()):.2f}; bitwise min_d2_plain's")


if __name__ == "__main__":
    g = torch.Generator().manual_seed(0)
    report("stage-1 step, objects 0-1 x 50 views", *stage1_inputs())
    report("uniform (points in [-0.5, 0.5]^3, queries in [-1, 1]^3)",
           2 * torch.rand(8, 14336, 3, generator=g) - 1, torch.rand(8, 512, 3, generator=g) - 0.5)
    report("hard_min_d2_inputs, 2 instances of each kind", *hard_min_d2_inputs(8, 14336, 512, 2))

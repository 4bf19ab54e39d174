#!/usr/bin/env python3
"""Smoke run of the PyTorch port (npcd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:
  1. environment: card name and power limit (nvidia-smi), torch, CUDA,
     Triton and nvcc; fails without a GPU;
  2. build: compiles the CUDA kernels of npcd_tpu_torch/csrc with nvcc;
  3. kernels: each kernel of the generation path against its plain PyTorch
     version on the card, at the shapes the main path gives it (f32), with
     the stated tolerance, and both timed with CUDA events;
  4. main path: python -m npcd_tpu_torch.generate_samples's code path on
     configs/npcd_srncars.yaml (302M denoiser, 1000 DDPM steps) with seeded
     weights and validity 'voxel': 2 samples, each rendered from 4 SRN test
     poses at 128x128; checks finite outputs and images in [0, 1], renders
     one object x one pose again on the CPU with the plain versions and
     compares the channels;
  5. launch counts: every kernel must have launched during phase 4.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from npcd_tpu_torch.generate_samples import exact_f32, parse_args, run  # noqa: E402
from npcd_tpu_torch.models.pointnerf.nn_core import init_mlp  # noqa: E402
from npcd_tpu_torch.ops.kernels import build  # noqa: E402
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import (  # noqa: E402
    fused_mlp_posenc_wsum, fused_mlp_posenc_wsum_plain)
from npcd_tpu_torch.ops.kernels.fused_qkv_attention import (  # noqa: E402
    fused_qkv_attention, fused_qkv_attention_plain)
from npcd_tpu_torch.ops.kernels.knn import knn, knn_plain  # noqa: E402
from npcd_tpu_torch.ops.kernels.layer_norm import (  # noqa: E402
    layer_norm, layer_norm_plain, layer_norm_residual)

# the CLI's required --out; run() itself writes no files
OUT = ROOT / "runs" / "chip_smoke"

# name -> (wrapper, route, source, the TPU kernel it replaces)
KERNELS = {
    "fused_qkv_attention": (fused_qkv_attention, "cuda",
                            "npcd_tpu_torch/csrc/fused_qkv_attention.cu",
                            "npcd_tpu/ops/pallas/fused_qkv_attention.py:131"),
    "layer_norm": (layer_norm, "triton", "npcd_tpu_torch/ops/kernels/layer_norm.py",
                   "npcd_tpu/ops/pallas/layer_norm.py:99"),
    "layer_norm_residual": (layer_norm_residual, "triton",
                            "npcd_tpu_torch/ops/kernels/layer_norm.py",
                            "npcd_tpu/ops/pallas/layer_norm.py:206"),
    "knn": (knn, "cuda", "npcd_tpu_torch/csrc/knn.cu", "npcd_tpu/ops/pallas/knn.py:78"),
    "fused_mlp_posenc_wsum": (fused_mlp_posenc_wsum, "cuda",
                              "npcd_tpu_torch/csrc/fused_mlp_posenc.cu",
                              "npcd_tpu/ops/pallas/fused_mlp.py:382"),
}


def phase_env() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "missing"
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} triton {triton_version} "
          f"nvcc {build.nvcc_path()} device {torch.cuda.get_device_name(0)}")
    exact_f32()
    return smi.splitlines()[0]


def phase_build() -> None:
    t0 = time.perf_counter()
    names = build.build_all()
    print(f"[build] {', '.join(names)} built in {time.perf_counter() - t0:.1f} s")


def _time_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def phase_kernels() -> dict:
    """Kernel vs plain version at the main path's shapes -> {name: result}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    rand = lambda *s: torch.rand(s, generator=g, device=dev)
    results = {}

    def check(name, err, tol, kernel_fn, plain_fn, extra=""):
        ms, plain_ms = _time_ms(kernel_fn), _time_ms(plain_fn)
        ok = err <= tol
        print(f"[kernels] {name}: max_abs_err {err:.3e} (tol {tol:.0e}) "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{extra} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol}")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

    # K2: denoiser LayerNorms over [batch 2 x 520 tokens, 1024]; reduction
    # order differs from torch's, values are O(1): tol 1e-4
    x, d = randn(2 * 520, 1024), randn(2 * 520, 1024)
    gamma, beta = 1 + 0.1 * randn(1024), 0.1 * randn(1024)
    err = _err(layer_norm(x, gamma, beta), layer_norm_plain(x, gamma, beta))
    check("layer_norm", err, 1e-4, lambda: layer_norm(x, gamma, beta),
          lambda: layer_norm_plain(x, gamma, beta))
    r_k, y_k = layer_norm_residual(x, d, gamma, beta)
    r_p, y_p = layer_norm_plain(x, gamma, beta, delta=d)
    check("layer_norm_residual", max(_err(r_k, r_p), _err(y_k, y_p)), 1e-4,
          lambda: layer_norm_residual(x, d, gamma, beta),
          lambda: layer_norm_plain(x, gamma, beta, delta=d))

    # K1: qkv [2*520, 3072], 16 heads x D 64, G 2, 513 valid keys; rows past
    # valid_len are discarded by the denoiser and not compared. f32 online
    # softmax vs torch's softmax: tol 1e-4
    qkv = 0.5 * randn(2 * 520, 3 * 1024)
    args = (qkv, 16, 2, 520, 513, 2)
    got = fused_qkv_attention(*args).reshape(2, 520, -1)[:, :513]
    want = fused_qkv_attention_plain(*args).reshape(2, 520, -1)[:, :513]
    check("fused_qkv_attention", _err(got, want), 1e-4,
          lambda: fused_qkv_attention(*args), lambda: fused_qkv_attention_plain(*args))

    # K4: 8 instances x (1024 rays x 5-slot block) queries, 512 points, k 8.
    # Both sides use the direct sum((p - x)^2): the sorted d2 lists agree
    # within 1e-5, and each kernel d2 is the distance of the index it
    # returns, so an index that differs from the plain one is a near-tie
    pts = 2 * rand(8, 512, 3) - 1
    xq = pts[:, torch.randint(0, 512, (5120,), generator=g, device=dev)] + 0.05 * randn(8, 5120, 3)
    i_k, d_k = knn(xq, pts, 8)
    i_p, d_p = knn_plain(xq, pts, 8)
    nb = torch.gather(pts, 1, i_k.long().reshape(8, -1, 1).expand(-1, -1, 3)).reshape(8, 5120, 8, 3)
    if _err(((nb - xq[:, :, None]) ** 2).sum(-1), d_k) > 1e-6:
        raise AssertionError("knn: returned d2 is not the distance of the returned index")
    check("knn", _err(d_k, d_p), 1e-5, lambda: knn(xq, pts, 8), lambda: knn_plain(xq, pts, 8),
          extra=f" idx_mismatch {int((i_k != i_p).sum())}")

    # K6: 8 instances x 5120 shading points x k 8 pairs, F 32, the SRN
    # config's 95->256x4->256 aggregation MLP with torch-default init; x_rel
    # within the 0.16 kNN radius, weights normalized per point. Five f32
    # layers with different summation order: tol 1e-4 x max|plain|
    layers = init_mlp((256, 256, 256, 256), 95, 256, torch.Generator().manual_seed(0), dev)
    weights = [(l["w"], l["b"]) for l in layers]
    m = 5120 * 8
    feat_t = randn(8, 32, m)
    w = rand(8, 5120, 8)
    pos_t = torch.cat([0.32 * rand(8, 3, m) - 0.16, (w / w.sum(-1, keepdim=True)).reshape(8, 1, m),
                       torch.zeros(8, 4, m, device=dev)], dim=1)
    kargs = (feat_t, pos_t, weights, 8, 10, 1.0, "anchored")
    want = fused_mlp_posenc_wsum_plain(*kargs)
    err = _err(fused_mlp_posenc_wsum(*kargs), want)
    scale = max(1.0, float(want.abs().max()))
    check("fused_mlp_posenc_wsum", err, 1e-4 * scale, lambda: fused_mlp_posenc_wsum(*kargs),
          lambda: fused_mlp_posenc_wsum_plain(*kargs))
    return results


def phase_main() -> dict:
    args = parse_args([
        "--config", str(ROOT / "configs/npcd_srncars.yaml"), "--out", str(OUT),
        "--num", "2", "--batch-size", "2", "--seed", "0", "--render", "2",
        "--render-poses", "4", "--poses", str(ROOT / "data/srncars_test_poses.npy"),
        "--intrinsics", str(ROOT / "data/srncars_test_intrinsics.npy"),
        "--resolution", "128", "--device", "cuda", "--validity", "voxel"])
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats()
    out = run(args)
    launches = {name: wrapper.launches for name, (wrapper, *_) in KERNELS.items()}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    model = out["model"]
    n_params = sum(p.numel() for p in model.diffusion.denoiser.parameters())
    coords, feats, channels = out["coords"], out["feats"], out["channels"]
    steps = model.diffusion.process.num_timesteps
    rays = channels.shape[0] * channels.shape[1] * channels.shape[2]
    print(f"[main] denoiser {n_params / 1e6:.1f}M params, {steps} steps: coords "
          f"{coords.shape} feats {feats.shape}, {steps / out['sample_s']:.2f} sampler steps/s "
          f"({out['sample_s']:.1f} s); render {tuple(channels.shape)} "
          f"{rays / out['render_s']:.0f} rays/s ({out['render_s']:.2f} s); peak {peak_mb:.0f} MiB")
    for name, a in (("coords", coords), ("feats", feats), ("channels", channels.cpu().numpy())):
        if not np.isfinite(a).all():
            raise AssertionError(f"non-finite {name}")
    lo, hi = float(channels.min()), float(channels.max())
    # sum of compositing weights <= 1 up to f32 rounding: [0, 1] within 1e-5
    if lo < -1e-5 or hi > 1 + 1e-5:
        raise AssertionError(f"channels outside [0, 1]: [{lo}, {hi}]")

    # one object x one pose again on the CPU, through the plain versions
    cpu = copy.deepcopy(model.pointnerf).cpu()
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    res = cpu.render(t(coords[:1].transpose(0, 2, 1)), t(feats[:1].transpose(0, 2, 1)),
                     t(out["poses"][None, :1]), t(out["intrinsics"][None, :1]), resolution=128)
    cpu_err = _err(res["channels"][0, 0], channels[0, 0].cpu())
    # same arithmetic in another summation order, and sin/cos from two
    # libraries: tol 1e-3 on channels in [0, 1]
    print(f"[main] channels in [{lo:.4f}, {hi:.4f}]; GPU vs CPU plain render (1 object x 1 pose) "
          f"max_abs_err {cpu_err:.3e} (tol 1e-03)")
    if cpu_err > 1e-3:
        raise AssertionError(f"GPU render disagrees with the CPU render: {cpu_err}")
    return launches


def main() -> None:
    phase_env()
    phase_build()
    results = phase_kernels()
    launches = phase_main()
    print(f"[launches] {json.dumps(launches)}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")
    kernels = [{"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": launches[name], **results[name]}
               for name, (_, route, source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

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
  4. kernels, training: the attention forward with its log-sum-exp and its
     backward (pad rows of dq/dk/dv exactly 0), the LayerNorm forward with
     its mean/rstd and its backward in both forms, each backward fed its own
     side's forward outputs, and the AdamW + EMA pass (one [4096, 1024]
     leaf, then the whole 302M-parameter denoiser), each against its plain
     version at the stage-2 step's shapes, timed;
  5. main path, generation: python -m npcd_tpu_torch.generate_samples's code
     path on configs/npcd_srncars.yaml (302M denoiser, 1000 DDPM steps) with
     seeded weights and validity 'voxel': 2 samples, each rendered from 4
     SRN test poses at 128x128; checks finite outputs and images in [0, 1],
     renders one object x one pose again on the CPU with the plain versions
     and compares the channels;
  6. main path, training: python -m npcd_tpu_torch.train_diffusion's code
     path on configs/npcd_srncars.yaml, f32, batch 32, 8 steps, on seeded
     latent tables of the config's size (2347 objects x 512 points x
     (3 + 32)) written as the bridged .npz --pointnerf_weights reads;
     prints steps/s after warm-up, peak memory, loss and grad_norm (finite;
     the first step's loss ~1, output_proj starting at zero), restores the
     saved train state into a fresh trainer (bitwise) and loads the EMA
     export through load_npz;
  7. GPU vs CPU: one training step of a full-width 2-layer denoiser at
     batch 2 from the same weights and draws, on the card through the
     kernels and on the CPU through the plain versions: loss, every
     gradient leaf and the updated parameters;
  8. launch counts: every kernel must have launched during phase 5 or 6,
     each kernel of a path during that path.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from npcd_tpu_torch import train_diffusion  # noqa: E402
from npcd_tpu_torch.data import PointNeRFDataset  # noqa: E402
from npcd_tpu_torch.generate_samples import exact_f32, parse_args, run  # noqa: E402
from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel  # noqa: E402
from npcd_tpu_torch.models.npcd import NPCD  # noqa: E402
from npcd_tpu_torch.models.pointnerf.nn_core import init_mlp  # noqa: E402
from npcd_tpu_torch.ops.kernels import build  # noqa: E402
from npcd_tpu_torch.ops.kernels.fused_adamw import adamw_ema, adamw_ema_plain  # noqa: E402
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import (  # noqa: E402
    fused_mlp_posenc_wsum, fused_mlp_posenc_wsum_plain)
from npcd_tpu_torch.ops.kernels.fused_qkv_attention import (  # noqa: E402
    fused_qkv_attention, fused_qkv_attention_bwd, fused_qkv_attention_bwd_plain,
    fused_qkv_attention_fwd, fused_qkv_attention_plain, split_grouped_qkv)
from npcd_tpu_torch.ops.kernels.knn import knn, knn_plain  # noqa: E402
from npcd_tpu_torch.ops.kernels.layer_norm import (  # noqa: E402
    layer_norm, layer_norm_bwd, layer_norm_bwd_plain, layer_norm_fwd, layer_norm_fwd_plain,
    layer_norm_plain, layer_norm_residual, layer_norm_residual_bwd)
from npcd_tpu_torch.train import DiffusionTraining  # noqa: E402
from npcd_tpu_torch.utils.builders import build_diffusion_model  # noqa: E402
from npcd_tpu_torch.utils.config import load_config  # noqa: E402
from npcd_tpu_torch.utils.from_jax import load_npz, save_npz  # noqa: E402

# the generation CLI's required --out (run() itself writes no files); the
# training path writes its checkpoints and exports under OUT / "train"
OUT = ROOT / "runs" / "chip_smoke"
SRNCARS = ROOT / "configs/npcd_srncars.yaml"
TRAIN_STEPS = 8
WARMUP_STEPS = 2  # the first steps compile the Triton kernels

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
    "fused_qkv_attention_bwd": (fused_qkv_attention_bwd, "cuda",
                                "npcd_tpu_torch/csrc/fused_qkv_attention.cu",
                                "npcd_tpu/ops/pallas/fused_qkv_attention.py:203"),
    "layer_norm_bwd": (layer_norm_bwd, "triton", "npcd_tpu_torch/ops/kernels/layer_norm.py",
                       "npcd_tpu/ops/pallas/layer_norm.py:114"),
    "layer_norm_residual_bwd": (layer_norm_residual_bwd, "triton",
                                "npcd_tpu_torch/ops/kernels/layer_norm.py",
                                "npcd_tpu/ops/pallas/layer_norm.py:221"),
    "adamw_ema": (adamw_ema, "triton", "npcd_tpu_torch/ops/kernels/fused_adamw.py",
                  "npcd_tpu/ops/pallas/fused_adamw.py:36"),
}
GENERATION = ("fused_qkv_attention", "layer_norm", "layer_norm_residual", "knn",
              "fused_mlp_posenc_wsum")
TRAINING = ("fused_qkv_attention", "fused_qkv_attention_bwd", "layer_norm",
            "layer_norm_residual", "layer_norm_bwd", "layer_norm_residual_bwd", "adamw_ema")


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


def _worst(triples) -> tuple:
    """(got, want, rel) per output, each output's tolerance rel x max(1,
    max|want|) -> (max_abs_err, tol) of the output furthest past its own."""
    pairs = [(_err(got, want), rel * max(1.0, float(want.abs().max())))
             for got, want, rel in triples]
    return max(pairs, key=lambda p: p[0] / p[1])


def _record(results: dict, name: str, err: float, tol: float, kernel_fn, plain_fn,
            extra: str = "", tag: str = "kernels") -> None:
    """Time kernel and plain version, print, raise when err > tol."""
    ms, plain_ms = _time_ms(kernel_fn), _time_ms(plain_fn)
    ok = err <= tol
    print(f"[{tag}] {name}: max_abs_err {err:.3e} (tol {tol:.1e}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol}")
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_kernels() -> dict:
    """Kernel vs plain version at the main path's shapes -> {name: result}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    rand = lambda *s: torch.rand(s, generator=g, device=dev)
    results = {}
    check = lambda *a, **k: _record(results, *a, **k)

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


def phase_train_kernels() -> dict:
    """The training kernels vs their plain versions at the stage-2 step's
    shapes (batch 32 x 520 tokens, width 1024, 16 heads) -> {name: result}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    results = {}
    check = lambda *a, **k: _record(results, *a, tag="kernels-train", **k)
    b, s, h, w, valid = 32, 520, 16, 1024, 513

    # K2a/K2b with the saved statistics, then K2c/K2d, over [32*520, 1024];
    # each side's backward reads its own forward's r, mean and rstd. Every
    # output within 1e-5 of max(1, its own largest magnitude): y, r, mean,
    # rstd and dx are O(1) in another summation order than torch's; dgamma
    # and dbeta sum 16,640 rows, so their scale is ~1e2
    x, d, gy, gr = (randn(b * s, w) for _ in range(4))
    gamma, beta = 1 + 0.1 * randn(w), 0.1 * randn(w)
    for name, delta in (("layer_norm", None), ("layer_norm_residual", d)):
        fwd = lambda: layer_norm_fwd(x, gamma, beta, delta=delta)
        fwd_plain = lambda: layer_norm_fwd_plain(x, gamma, beta, delta=delta)
        (r_k, y_k, mean_k, rstd_k), (r_p, y_p, mean_p, rstd_p) = fwd(), fwd_plain()
        err, tol = _worst([(got, want, 1e-5) for got, want in
                           zip((r_k, y_k, mean_k, rstd_k), (r_p, y_p, mean_p, rstd_p))])
        check(f"{name} (with mean, rstd)", err, tol, fwd, fwd_plain)
        if delta is None:
            bwd = lambda: layer_norm_bwd(x, gamma, mean_k, rstd_k, gy)
            bwd_plain = lambda: layer_norm_bwd_plain(x, gamma, mean_p, rstd_p, gy)
        else:
            bwd = lambda: layer_norm_residual_bwd(r_k, gamma, mean_k, rstd_k, gr, gy)
            bwd_plain = lambda: layer_norm_bwd_plain(r_p, gamma, mean_p, rstd_p, gy, gr)
        err, tol = _worst([(got, want, 1e-5) for got, want in zip(bwd(), bwd_plain())])
        check(f"{name}_bwd", err, tol, bwd, bwd_plain)
    del x, d, gy, gr, r_k, y_k, mean_k, rstd_k, r_p, y_p, mean_p, rstd_p

    # K1f with its base-2 lse, then K1b: qkv [32*520, 3072], G 2, 513 valid
    # keys, the cotangent zero on pad-query rows as the denoiser's; each
    # side's backward reads its own forward's out and lse. Every row of out
    # is compared: pad-query rows attend to the valid keys like the others
    # and feed c_proj's weight gradient. f32 online softmax vs torch's, sums
    # over 513 keys: out and dqkv within 1e-4 of max(1, max|plain|), the lse
    # (~10) within 1e-5 of it
    qkv = 0.5 * randn(b * s, 3 * w)
    dout = randn(b * s, w)
    dout.reshape(b, s, w)[:, valid:] = 0
    fargs = (qkv, h, b, s, valid, 2)
    fwd = lambda: fused_qkv_attention_fwd(*fargs)
    fwd_plain = lambda: fused_qkv_attention_plain(*fargs, return_lse=True)
    (out_k, lse_k), (out_p, lse_p) = fwd(), fwd_plain()
    err, tol = _worst([(out_k, out_p, 1e-4), (lse_k, lse_p, 1e-5)])
    check("fused_qkv_attention (with lse)", err, tol, fwd, fwd_plain)
    bwd = lambda: fused_qkv_attention_bwd(qkv, out_k, lse_k, dout, h, b, s, valid, 2)
    bwd_plain = lambda: fused_qkv_attention_bwd_plain(qkv, out_p, lse_p, dout, h, b, s, valid, 2)
    got, want = bwd(), bwd_plain()
    dq, dk, dv = split_grouped_qkv(got.reshape(b, s, -1), h, 2)
    pad_nonzero = int((dq[:, valid:] != 0).sum() + (dk[:, valid:] != 0).sum()
                      + (dv[:, valid:] != 0).sum())
    if pad_nonzero or not torch.isfinite(got).all():
        raise AssertionError(f"fused_qkv_attention_bwd: {pad_nonzero} nonzero pad-row "
                             "dq/dk/dv values or non-finite dqkv")
    err, tol = _worst([(got, want, 1e-4)])
    check("fused_qkv_attention_bwd", err, tol, bwd, bwd_plain, extra=" pad-row dq/dk/dv all 0")
    del qkv, dout, out_k, lse_k, out_p, lse_p, got, want, dq, dk, dv

    # K3: one [4096, 1024] leaf, then the whole denoiser (its 302M
    # parameters as one flat buffer, one EMA). Elementwise f32 with an ulp
    # of difference per op (FMA contraction): each buffer within 1e-6 of its
    # largest magnitude (the reported error is the parameters'); the sum of
    # g^2 over up to 302M terms in another order: 1e-5 relative
    n_full = sum(p.numel() for p in DiffusionModel().denoiser.parameters())
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, lr=7e-5, wd=0.01, use_clip=False)
    scalars = torch.tensor([0.41, 0.0039, 1.0, 0.9999], device=dev)
    for label, n in (("[4096, 1024] leaf", 4096 * 1024), (f"{n_full} params", n_full)):
        grads, p = 1e-3 * randn(n), 0.02 * randn(n)
        mu, nu, ema = 1e-4 * randn(n), (1e-7 * randn(n)).abs(), p + 1e-4 * randn(n)
        emas = ema[None]
        ref = [t.clone() for t in (p, mu, nu, emas)]
        sumsq = adamw_ema(grads, p, mu, nu, emas, scalars, **kw)
        want_sumsq = adamw_ema_plain(grads, *ref, scalars, **kw)
        rel = {name: _err(a, b_) / float(b_.abs().max())
               for name, a, b_ in zip(("p", "mu", "nu", "ema"), (p, mu, nu, emas), ref)}
        err_sumsq = abs(float(sumsq) / float(want_sumsq) - 1)
        if max(rel.values()) > 1e-6 or err_sumsq > 1e-5:
            raise AssertionError(f"adamw_ema ({label}): relative errors {rel}, "
                                 f"sum of g^2 {err_sumsq}")
        # the buffers keep changing in place while timed; values stay finite
        check(f"adamw_ema ({label})", _err(p, ref[0]), 1e-6 * float(ref[0].abs().max()),
              lambda: adamw_ema(grads, p, mu, nu, emas, scalars, **kw),
              lambda: adamw_ema_plain(grads, *ref, scalars, **kw),
              extra=" rel err " + " ".join(f"{k} {v:.1e}" for k, v in rel.items())
              + f" sumsq {err_sumsq:.1e}")
        del grads, p, mu, nu, ema, emas, ref
    results["adamw_ema"] = results.pop(f"adamw_ema ({n_full} params)")
    torch.cuda.empty_cache()
    return results


def _reset_launches() -> None:
    for wrapper, *_ in KERNELS.values():
        wrapper.launches = 0


def _read_launches() -> dict:
    return {name: wrapper.launches for name, (wrapper, *_) in KERNELS.items()}


def phase_main() -> dict:
    args = parse_args([
        "--config", str(ROOT / "configs/npcd_srncars.yaml"), "--out", str(OUT),
        "--num", "2", "--batch-size", "2", "--seed", "0", "--render", "2",
        "--render-poses", "4", "--poses", str(ROOT / "data/srncars_test_poses.npy"),
        "--intrinsics", str(ROOT / "data/srncars_test_intrinsics.npy"),
        "--resolution", "128", "--device", "cuda", "--validity", "voxel"])
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    out = run(args)
    launches = _read_launches()
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
    del out, model
    torch.cuda.empty_cache()
    return launches


def _seeded_pointnerf_npz(config, path: Path) -> None:
    """The bridged .npz --pointnerf_weights reads, at the config's size:
    seeded latent tables (coords in [-0.5, 0.5]^3, feats standard normal)
    and the seeded PointNeRF weights the exports carry on."""
    m = config["model"]
    rng = np.random.default_rng(0)
    npcd = NPCD.from_config(config)
    flat = {f"pointnerf.{k}": v.numpy() for k, v in npcd.pointnerf.state_dict().items()}
    flat["latents.coords_table"] = rng.uniform(-0.5, 0.5, (m["n_obj"], m["num_points"], 3))
    flat["latents.feats_table"] = rng.standard_normal(
        (m["n_obj"], m["num_points"], m["feats_dim"]), dtype=np.float32)
    save_npz(str(path), flat)


def phase_train() -> dict:
    """python -m npcd_tpu_torch.train_diffusion's code path, full size."""
    out = OUT / "train"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    config = load_config(str(SRNCARS))
    config["diffusion_training"].update(max_iterations=TRAIN_STEPS, print_interval=1,
                                        log_scalars_interval=1)
    t0 = time.perf_counter()
    _seeded_pointnerf_npz(config, out / "pointnerf.npz")
    print(f"[train] seeded latent tables {config['model']['n_obj']} x "
          f"{config['model']['num_points']} x (3 + {config['model']['feats_dim']}) "
          f"written in {time.perf_counter() - t0:.1f} s")
    args = train_diffusion.parse_args([
        "--config", str(SRNCARS), "--output", str(out / "run"), "--pointnerf_weights",
        str(out / "pointnerf.npz"), "--dtype", "float32", "--device", "cuda",
        "--no_tensorboard", "--seed", "0"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    trainer = train_diffusion.train(args, config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    hist = trainer.history
    if [h["it"] for h in hist] != list(range(1, TRAIN_STEPS + 1)):
        raise AssertionError(f"expected {TRAIN_STEPS} logged steps, got {len(hist)}")
    for h in hist:
        if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
            raise AssertionError(f"non-finite loss or grad_norm at step {h['it']}: {h}")
    timed = TRAIN_STEPS - WARMUP_STEPS
    steps_s = timed / (hist[-1]["time"] - hist[WARMUP_STEPS - 1]["time"])
    n_params = trainer.flat.offsets[-1]
    print(f"[train] denoiser {n_params / 1e6:.1f}M params, batch {trainer.batch_size}, "
          f"{TRAIN_STEPS} steps in {wall:.1f} s (with the final checkpoint and exports): "
          f"{steps_s:.4f} steps/s over steps {WARMUP_STEPS + 1}-{TRAIN_STEPS}; "
          f"peak {peak_gib:.2f} GiB")
    print("[train] loss " + " ".join(f"{h['loss']:.5f}" for h in hist))
    print("[train] grad_norm " + " ".join(f"{h['grad_norm']:.5f}" for h in hist))
    # output_proj starts at zero: eps_hat = 0 and the first loss is
    # (mean(n_c^2) + mean(n_f^2)) / 2 over 32 x 512 x 35 normals, ~1
    if abs(hist[0]["loss"] - 1.0) > 0.05:
        raise AssertionError(f"first loss {hist[0]['loss']} is not ~1 with a zero output_proj")

    fresh = DiffusionTraining(str(out / "run"), build_diffusion_model(config), trainer.dataset,
                              device="cuda", verbose=False, **config["diffusion_training"])
    a, b = trainer.state_dict(), fresh.state_dict()
    same = all(torch.equal(a[k], b[k]) for k in ("params", "mu", "nu", "emas"))
    same = same and (a["count"], a["step"]) == (b["count"], b["step"]) == (TRAIN_STEPS,) * 2
    print(f"[train] checkpoint restored into a fresh trainer at step {fresh.step}: "
          f"{'bitwise equal' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError("restored train state differs from the saved one")
    del fresh, a, b
    ema_path = trainer.weights_only_paths(TRAIN_STEPS)[1]
    npcd = NPCD.from_config(config, seed=1)
    load_npz(npcd, ema_path)
    ema = trainer.flat.as_dict(trainer.emas[0].cpu())
    if not all(torch.equal(p.detach(), ema[n])
               for n, p in npcd.diffusion.denoiser.named_parameters()):
        raise AssertionError("the EMA export does not hold the trainer's EMA")
    print(f"[train] EMA export {Path(ema_path).name} loaded through load_npz: equal")
    del trainer, npcd, ema
    torch.cuda.empty_cache()
    return {"launches": launches, "steps_s": steps_s, "peak_gib": peak_gib}


def phase_cpu_step() -> None:
    """One training step of a full-width 2-layer denoiser at batch 2 from the
    same weights and draws: the card with its kernels vs the CPU with the
    plain versions."""
    config = load_config(str(SRNCARS))
    m = dict(config["model"])
    kw = {k: m[k] for k in ("coords_dim", "feats_dim", "num_points", "width", "heads")}
    rng = np.random.default_rng(0)
    n_obj, p = 4, m["num_points"]
    ds = PointNeRFDataset(rng.uniform(-0.5, 0.5, (n_obj, p, 3)).astype(np.float32),
                          rng.standard_normal((n_obj, p, m["feats_dim"]), dtype=np.float32))
    src = DiffusionModel(layers=2, **kw).denoiser
    src.init_seeded(torch.Generator().manual_seed(0))  # nonzero output_proj: every leaf trains
    weights = {k: v.numpy() for k, v in src.state_dict().items()}
    batch = {"coords": rng.uniform(-0.5, 0.5, (2, 3, p)).astype(np.float32),
             "feats": rng.standard_normal((2, m["feats_dim"], p), dtype=np.float32)}
    gen = torch.Generator().manual_seed(1)
    draws = (torch.randint(0, 1000, (2,), generator=gen),
             torch.randn((2, 3, p), generator=gen), torch.randn((2, m["feats_dim"], p),
                                                                  generator=gen))
    out, lr = {}, 7e-5
    for dev in ("cuda", "cpu"):
        trainer = DiffusionTraining(str(OUT / f"step_{dev}"), DiffusionModel(layers=2, **kw), ds,
                                    batch_size=2, base_learning_rate=lr, weight_decay=0.01,
                                    max_iterations=1, use_ema=True,
                                    ema_params=[(1, 0.9999, 0.9999, False)], device=dev,
                                    verbose=False)
        trainer.flat.from_dict(trainer.flat.params, weights)
        with torch.no_grad():
            trainer.emas.copy_(trainer.flat.params[None])
        metrics = trainer.train_step(batch, draws=tuple(t.to(dev) for t in draws))
        out[dev] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                    "grads": {k: v.cpu() for k, v in trainer.flat.as_dict(trainer.flat.grads).items()},
                    "params": trainer.flat.params.cpu()}
    gpu, cpu = out["cuda"], out["cpu"]
    loss_err = abs(gpu["loss"] / cpu["loss"] - 1)
    # f32 sums of up to 4096 terms and the attention softmax in another
    # order (cuBLAS, the kernels) than on the CPU: every gradient leaf within
    # 1e-4 of its largest magnitude, the loss within 1e-5 relative. The first
    # Adam step moves each parameter by lr * sign(g): a near-zero gradient
    # with another sign on the two sides moves it 2 lr apart, so every
    # parameter within 2 lr + 1e-6 and all but 0.1% within 1e-6
    worst = max((_err(gpu["grads"][k], g) / max(float(g.abs().max()), 1e-30), k)
                for k, g in cpu["grads"].items())
    zero = [k for k, g in gpu["grads"].items() if float(g.abs().max()) == 0]
    diff = (gpu["params"] - cpu["params"]).abs()
    param_err, param_frac = float(diff.max()), float((diff > 1e-6).float().mean())
    print(f"[gpu-vs-cpu] 2-layer full-width step at batch 2: loss {gpu['loss']:.6f} vs "
          f"{cpu['loss']:.6f} (rel err {loss_err:.1e}, tol 1e-5); grad_norm "
          f"{gpu['grad_norm']:.6f} vs {cpu['grad_norm']:.6f}; worst gradient leaf {worst[1]} "
          f"rel err {worst[0]:.2e} (tol 1e-4) over {len(cpu['grads'])} leaves; updated "
          f"params max_abs_err {param_err:.2e} (tol {2 * lr + 1e-6:.1e}), "
          f"{param_frac:.1e} of them beyond 1e-6 (tol 1e-3)")
    if (loss_err > 1e-5 or worst[0] > 1e-4 or zero or param_err > 2 * lr + 1e-6
            or param_frac > 1e-3):
        raise AssertionError(f"GPU and CPU training steps disagree (zero-gradient leaves {zero})")


def main() -> None:
    phase_env()
    phase_build()
    results = phase_kernels()
    results.update(phase_train_kernels())
    gen_launches = phase_main()
    train_out = phase_train()
    train_launches = train_out["launches"]
    phase_cpu_step()
    print(f"[launches] generation {json.dumps(gen_launches)}")
    print(f"[launches] training {json.dumps(train_launches)}")
    missing = [n for n in GENERATION if gen_launches[n] == 0] + [
        n for n in TRAINING if train_launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by their main path: {missing}")
    kernels = [{"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": gen_launches[name] + train_launches[name], **results[name]}
               for name, (_, route, source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

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
  8. kernels, stage 1, at the shapes the stage-1 step launches them: the
     min-distance kernel over all 400 instances x 14,336 queries (validity
     bits and distances bitwise equal to the plain version's), the kNN over
     400 x 5,600 shading points and over the TV loss's 8 x 512 points, and
     the aggregation MLP forward and backward over one 50-instance chunk
     (2.24M pairs), the backward fed K6f's own output as its cotangent
     (pairs on a leaky_relu kink left out), each against its plain version,
     timed;
  9. main path, stage 1: python -m npcd_tpu_torch.train_pointnerf's code
     path on configs/npcd_srncars.yaml, f32, B 8 x V 50, 112 rays x 128
     samples, validity 'knn', remat on, on a seeded synthetic dataset of the
     config's 2347 clouds (images from the first 56 objects, 128^2, so 7
     steps); prints stage-1 steps/s and train rays/s after 2 warm-up steps,
     peak memory; checks finite losses, the coords table unchanged, the
     checkpoint restored bitwise into a fresh trainer and the export loaded
     by train_diffusion's load_pointnerf_weights;
 10. GPU vs CPU, stage 1: one step at full MLP widths on 1 object x 2 views,
     112 rays x 128 samples, from the same weights and draws: loss, every
     gradient leaf and the updated parameters;
 11. launch counts: every kernel must have launched during phase 5, 6 or
     9, each kernel of a path during that path.
Every kernel's line gives its time, its plain version's, the least time
the card could take for the same work (bytes over 3.35 TB/s or FP32
operations over 67 TFLOP/s, whichever is larger, at the measured shape)
and, where one PyTorch call computes the same function, that call's time.
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
import torch.nn.functional as F  # noqa: E402

from npcd_tpu_torch import train_diffusion, train_pointnerf  # noqa: E402
from npcd_tpu_torch.data import PointNeRFDataset, SyntheticNPCTrain  # noqa: E402
from npcd_tpu_torch.generate_samples import exact_f32, parse_args, run  # noqa: E402
from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel  # noqa: E402
from npcd_tpu_torch.models.npcd import NPCD  # noqa: E402
from npcd_tpu_torch.models.pointnerf.nn_core import init_mlp  # noqa: E402
from npcd_tpu_torch.ops.kernels import build  # noqa: E402
from npcd_tpu_torch.ops.kernels.fused_adamw import adamw_ema, adamw_ema_plain  # noqa: E402
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import (  # noqa: E402
    fused_mlp_posenc_wsum, fused_mlp_posenc_wsum_bwd, fused_mlp_posenc_wsum_bwd_plain,
    fused_mlp_posenc_wsum_plain, leaky_kinks)
from npcd_tpu_torch.ops.kernels.fused_qkv_attention import (  # noqa: E402
    fused_qkv_attention, fused_qkv_attention_bwd, fused_qkv_attention_bwd_plain,
    fused_qkv_attention_fwd, fused_qkv_attention_plain, split_grouped_qkv)
from npcd_tpu_torch.ops.kernels.knn import knn, knn_plain, min_d2, min_d2_plain  # noqa: E402
from npcd_tpu_torch.ops.kernels.layer_norm import (  # noqa: E402
    layer_norm, layer_norm_bwd, layer_norm_bwd_plain, layer_norm_fwd, layer_norm_fwd_plain,
    layer_norm_plain, layer_norm_residual, layer_norm_residual_bwd)
from npcd_tpu_torch.train import DiffusionTraining, PointNeRFTraining  # noqa: E402
from npcd_tpu_torch.utils.builders import (  # noqa: E402
    build_diffusion_model, build_pointnerf, build_pointnerf_options)
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
    "min_d2": (min_d2, "cuda", "npcd_tpu_torch/csrc/knn.cu", "npcd_tpu/ops/pallas/knn.py:67"),
    "fused_mlp_posenc_wsum_bwd": (fused_mlp_posenc_wsum_bwd, "cuda",
                                  "npcd_tpu_torch/csrc/fused_mlp_posenc.cu",
                                  "npcd_tpu/ops/pallas/fused_mlp.py:430"),
}
GENERATION = ("fused_qkv_attention", "layer_norm", "layer_norm_residual", "knn",
              "fused_mlp_posenc_wsum")
TRAINING = ("fused_qkv_attention", "fused_qkv_attention_bwd", "layer_norm",
            "layer_norm_residual", "layer_norm_bwd", "layer_norm_residual_bwd", "adamw_ema")
STAGE1 = ("knn", "min_d2", "fused_mlp_posenc_wsum", "fused_mlp_posenc_wsum_bwd")
STAGE1_OBJECTS = 56  # objects with images in the stage-1 run: 7 steps of batch 8
STAGE1_WARMUP = 2
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s and
# FP32 operations/s outside the tensor cores
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12
# The operations K6 needs per (point, neighbour) pair, 95 -> 256 x 4 -> 256,
# k 8. The last layer is linear and its output is w-summed over a point's k
# pairs, so it is needed once per point: sum w*h per pair, then one
# 256 x 256 product per point. Forward: layers 0-3 per pair, then the last
# layer per point. Backward: the recompute of layers 0-3; dW of layers 0-3
# per pair and dW_last = (sum w*h)^T g per point; dX: g W_last^T per point,
# times w per pair, then layers 3-1 per pair and dfeat over the 32 feature
# rows of layer 0
_K6_HIDDEN = 2 * (95 * 256 + 3 * 256 * 256)  # layers 0-3 of one pair
_K6_LAST = 2 * 256 * 256 // 8  # one 256 x 256 product per point
K6F_FLOP = _K6_HIDDEN + 2 * 256 + _K6_LAST
K6B_FLOP = (_K6_HIDDEN + _K6_HIDDEN + 2 * 256 + _K6_LAST
            + _K6_LAST + 256 + 3 * 2 * 256 * 256 + 2 * 256 * 32)
DIST_FLOP = 9  # per (query, point): 3 sub, 3 mul, 2 add, 1 compare


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
            extra: str = "", tag: str = "kernels", flops: float = 0.0, nbytes: float = 0.0,
            library_fn=None) -> None:
    """Time kernel, plain version and (where there is one) the library call
    computing the same function; print; raise when err > tol. The bound is
    the larger of nbytes over the HBM rate and flops over the FP32 peak."""
    ms, plain_ms = _time_ms(kernel_fn), _time_ms(plain_fn)
    library_ms = _time_ms(library_fn) if library_fn is not None else None
    bound_by = "bytes" if nbytes / HBM_BYTES_S >= flops / FP32_FLOP_S else "operations"
    bound_ms = max(nbytes / HBM_BYTES_S, flops / FP32_FLOP_S) * 1e3
    ok = err <= tol
    lib = f" library {library_ms:.4f} ms" if library_ms is not None else ""
    print(f"[{tag}] {name}: max_abs_err {err:.3e} (tol {tol:.1e}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{lib} bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops:.3e} flop, {nbytes:.3e} B){extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: {err} > {tol}")
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms}


def _bhsd(qkv, b: int, s: int, heads: int, groups: int, grad: bool = False):
    """q, k, v [B, H, S, D] of a grouped qkv [B*S, 3W], for the library's
    scaled_dot_product_attention."""
    q, k, v = split_grouped_qkv(qkv.reshape(b, s, -1), heads, groups)
    return [t.transpose(1, 2).contiguous().requires_grad_(grad) for t in (q, k, v)]


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
    n_el = x.numel()
    err = _err(layer_norm(x, gamma, beta), layer_norm_plain(x, gamma, beta))
    check("layer_norm", err, 1e-4, lambda: layer_norm(x, gamma, beta),
          lambda: layer_norm_plain(x, gamma, beta), flops=8 * n_el, nbytes=4 * (2 * n_el + 2048),
          library_fn=lambda: F.layer_norm(x, (1024,), gamma, beta, 1e-5))
    r_k, y_k = layer_norm_residual(x, d, gamma, beta)
    r_p, y_p = layer_norm_plain(x, gamma, beta, delta=d)
    check("layer_norm_residual", max(_err(r_k, r_p), _err(y_k, y_p)), 1e-4,
          lambda: layer_norm_residual(x, d, gamma, beta),
          lambda: layer_norm_plain(x, gamma, beta, delta=d), flops=9 * n_el,
          nbytes=4 * (4 * n_el + 2048))

    # K1: qkv [2*520, 3072], 16 heads x D 64, G 2, 513 valid keys; rows past
    # valid_len are discarded by the denoiser and not compared. f32 online
    # softmax vs torch's softmax: tol 1e-4
    qkv = 0.5 * randn(2 * 520, 3 * 1024)
    args = (qkv, 16, 2, 520, 513, 2)
    got = fused_qkv_attention(*args).reshape(2, 520, -1)[:, :513]
    want = fused_qkv_attention_plain(*args).reshape(2, 520, -1)[:, :513]
    # the library call: scaled_dot_product_attention with the key mask, f32
    q, k, v = _bhsd(qkv, 2, 520, 16, 2)
    key_mask = (torch.arange(520, device=dev) < 513)[None, None, None, :]
    check("fused_qkv_attention", _err(got, want), 1e-4,
          lambda: fused_qkv_attention(*args), lambda: fused_qkv_attention_plain(*args),
          flops=4 * 2 * 16 * 520 * 513 * 64, nbytes=4 * (qkv.numel() + qkv.numel() // 3),
          library_fn=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask))
    del q, k, v

    # K4: 8 instances x (1024 rays x 5-slot block) queries, 512 points, k 8.
    # Both sides use the direct sum((p - x)^2)
    pts = 2 * rand(8, 512, 3) - 1
    xq = pts[:, torch.randint(0, 512, (5120,), generator=g, device=dev)] + 0.05 * randn(8, 5120, 3)
    _knn_check(check, "knn", xq, pts)

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
    n_w = sum(t.numel() for wb in weights for t in wb)
    check("fused_mlp_posenc_wsum", err, 1e-4 * scale, lambda: fused_mlp_posenc_wsum(*kargs),
          lambda: fused_mlp_posenc_wsum_plain(*kargs), flops=K6F_FLOP * 8 * m,
          nbytes=4 * (feat_t.numel() + pos_t.numel() + n_w + want.numel()))
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
        library_fn = None
        if delta is None:  # the library call: autograd's backward of F.layer_norm
            xg, gg, bg = (t.clone().requires_grad_(True) for t in (x, gamma, beta))
            y_lib = F.layer_norm(xg, (w,), gg, bg, 1e-5)
            library_fn = lambda: torch.autograd.grad(y_lib, (xg, gg, bg), gy, retain_graph=True)
        check(f"{name}_bwd", err, tol, bwd, bwd_plain, flops=10 * x.numel(),
              nbytes=4 * x.numel() * (3 if delta is None else 4), library_fn=library_fn)
        library_fn = y_lib = None
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
    # the library call: autograd's backward of scaled_dot_product_attention
    q, k, v = _bhsd(qkv, b, s, h, 2, grad=True)
    key_mask = (torch.arange(s, device=dev) < valid)[None, None, None, :]
    o_lib = F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)
    do_lib = dout.reshape(b, s, h, -1).transpose(1, 2).contiguous()
    check("fused_qkv_attention_bwd", err, tol, bwd, bwd_plain, extra=" pad-row dq/dk/dv all 0",
          flops=10 * b * h * s * valid * 64,
          nbytes=4 * (2 * qkv.numel() + 2 * dout.numel() + lse_k.numel()),
          library_fn=lambda: torch.autograd.grad(o_lib, (q, k, v), do_lib, retain_graph=True))
    del qkv, dout, out_k, lse_k, out_p, lse_p, got, want, dq, dk, dv, q, k, v, o_lib, do_lib

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
              + f" sumsq {err_sumsq:.1e}", flops=15 * n, nbytes=4 * 9 * n)
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


def _knn_check(check, name: str, xq, pts) -> None:
    """K4 vs knn_plain (k 8): the d2 lists within 1e-5, and each kernel d2
    the distance of the index it returns (an index that differs from the
    plain one is then a near-tie)."""
    i_k, d_k = knn(xq, pts, 8)
    i_p, d_p = knn_plain(xq, pts, 8)
    inst, n = xq.shape[:2]
    nb = torch.gather(pts, 1, i_k.long().reshape(inst, -1, 1).expand(-1, -1, 3)).reshape(
        inst, n, 8, 3)
    if _err(((nb - xq[:, :, None]) ** 2).sum(-1), d_k) > 1e-6:
        raise AssertionError(f"{name}: returned d2 is not the distance of the returned index")
    check(name, _err(d_k, d_p), 1e-5, lambda: knn(xq, pts, 8), lambda: knn_plain(xq, pts, 8),
          extra=f" idx_mismatch {int((i_k != i_p).sum())}",
          flops=DIST_FLOP * inst * n * pts.shape[1],
          nbytes=4 * (xq.numel() + pts.numel() + 2 * inst * n * 8))


def phase_stage1_kernels() -> dict:
    """K4, K5, K6f and K6b vs their plain versions at the shapes the stage-1
    step gives them (B 8 x V 50 = 400 instances, 112 rays x 128 samples,
    50 shading slots, k 8, chunks of 50 instances)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    results = {}
    check = lambda *a, **k: _record(results, *a, tag="kernels-stage1", **k)

    # K5: the step's one launch, 400 instances x 14,336 queries against each
    # instance's 512 points; queries in the render cube [-1, 1]^3, points in
    # [-0.5, 0.5]^3, radius 0.16 as the config's. The same rounded
    # arithmetic on both sides: distances and validity bits equal
    radius2 = build_pointnerf_options(load_config(str(SRNCARS))).knn_radius ** 2
    inst, n_q = 400, 112 * 128
    pts = torch.rand(inst, 512, 3, generator=g, device=dev) - 0.5
    xq = 2 * torch.rand(inst, n_q, 3, generator=g, device=dev) - 1
    d_k, d_p = min_d2(xq, pts), min_d2_plain(xq, pts)
    bits_differ = int(((d_k < radius2) != (d_p < radius2)).sum())
    if bits_differ or not torch.equal(d_k, d_p):
        raise AssertionError(f"min_d2: {bits_differ} validity bits differ, max distance error "
                             f"{_err(d_k, d_p)}")
    check("min_d2", _err(d_k, d_p), 0.0, lambda: min_d2(xq, pts), lambda: min_d2_plain(xq, pts),
          extra=f" valid share {float((d_k < radius2).float().mean()):.3f}, bits equal",
          flops=DIST_FLOP * inst * n_q * 512,
          nbytes=4 * (xq.numel() + pts.numel() + d_k.numel()))
    del xq, d_k, d_p

    # K4: the aggregation's launch, 400 instances x 112 selected rays x 50
    # slots = 5,600 shading points near the cloud, and the TV loss's, the 8
    # objects' 512 points against themselves
    xq = pts[:, torch.randint(0, 512, (112 * 50,), generator=g, device=dev)] \
        + 0.05 * torch.randn(inst, 112 * 50, 3, generator=g, device=dev)
    _knn_check(check, "knn (stage-1 aggregation)", xq, pts)
    _knn_check(check, "knn (stage-1 TV)", pts[:8].contiguous(), pts[:8].contiguous())
    del pts, xq
    torch.cuda.empty_cache()

    # K6f and K6b at one 50-instance chunk of the step: 5,600 shading points
    # x k 8 = 44,800 pairs per instance, F 32, the config's 95 -> 256 x 4 ->
    # 256 MLP; K6b's cotangent is K6f's own output on the same inputs. Pairs
    # with a hidden pre-activation within 1e-5 of 0 get weight 0 on both
    # sides (leaky_relu's kink: an ulp decides the slope). K6f within 1e-4 of
    # max(1, max|plain|) as in phase 3; each K6b output within 1e-5 of max(1,
    # its largest magnitude): f32 in another summation order, the dW sums
    # over 2.24M pairs
    layers = init_mlp((256, 256, 256, 256), 95, 256, torch.Generator().manual_seed(0), dev)
    weights = [(l["w"], l["b"]) for l in layers]
    inst, n_pts = 50, 112 * 50
    m = n_pts * 8
    feat_t = torch.randn(inst, 32, m, generator=g, device=dev)
    w = torch.rand(inst, n_pts, 8, generator=g, device=dev)
    pos_t = torch.cat([0.32 * torch.rand(inst, 3, m, generator=g, device=dev) - 0.16,
                       (w / w.sum(-1, keepdim=True)).reshape(inst, 1, m),
                       torch.zeros(inst, 4, m, device=dev)], dim=1)
    del w
    kinks = leaky_kinks(feat_t, pos_t, weights, 10)
    pos_t[:, 3][kinks] = 0.0
    n_w = sum(t.numel() for wb in weights for t in wb)
    fargs = (feat_t, pos_t, weights, 8, 10)
    gout = fused_mlp_posenc_wsum(*fargs)
    want = fused_mlp_posenc_wsum_plain(*fargs)
    check("fused_mlp_posenc_wsum (stage-1 chunk)", _err(gout, want),
          1e-4 * max(1.0, float(want.abs().max())), lambda: fused_mlp_posenc_wsum(*fargs),
          lambda: fused_mlp_posenc_wsum_plain(*fargs), flops=K6F_FLOP * inst * m,
          nbytes=4 * (feat_t.numel() + pos_t.numel() + n_w + want.numel()))
    del want
    torch.cuda.empty_cache()
    # K6b is held against its plain version evaluated in float64 (in slices
    # of 5 instances, the dW summed over the slices): its dW sums run over
    # 2.24M pairs, where the f32 plain version's own rounding (cuBLAS's
    # long f32 dot products) is of the order of the tolerance. The f32 plain
    # version is timed, and its distance to the float64 one printed
    bargs = (feat_t, pos_t, weights, gout, 8, 10)
    flat = lambda df, dws: [df] + [t for wb in dws for t in wb]
    got = flat(*fused_mlp_posenc_wsum_bwd(*bargs))
    plain = flat(*fused_mlp_posenc_wsum_bwd_plain(*bargs))
    exact = flat(*_bwd_plain_f64(*bargs))
    err, tol = _worst([(a, b, 1e-5) for a, b in zip(got, exact)])
    rel = lambda xs: max(_err(a, b) / max(1.0, float(b.abs().max())) for a, b in zip(xs, exact))
    rel_plain, rel_vs_plain = rel(plain), max(
        _err(a, b) / max(1.0, float(b.abs().max())) for a, b in zip(got, plain))
    again = flat(*fused_mlp_posenc_wsum_bwd(*bargs))
    if not all(torch.equal(a, b) for a, b in zip(again, got)):
        raise AssertionError("fused_mlp_posenc_wsum_bwd: two runs on the same inputs differ")
    scales = f"|dfeat| {float(exact[0].abs().max()):.2e}, |dW0| {float(exact[1].abs().max()):.2e}"
    del again, plain
    check("fused_mlp_posenc_wsum_bwd", err, tol, lambda: fused_mlp_posenc_wsum_bwd(*bargs),
          lambda: fused_mlp_posenc_wsum_bwd_plain(*bargs),
          extra=f" (vs the float64 plain version; worst output at {err / tol * 1e-5:.2e} of its "
                f"scale, the f32 plain version at {rel_plain:.2e}, kernel vs f32 plain "
                f"{rel_vs_plain:.2e}) kinked pairs {int(kinks.sum())} of {kinks.numel()}; "
                f"{scales}; repeatable bitwise",
          flops=K6B_FLOP * inst * m,
          nbytes=4 * (2 * feat_t.numel() + pos_t.numel() + gout.numel() + 2 * n_w))
    del feat_t, pos_t, gout, bargs, got, exact, kinks
    torch.cuda.empty_cache()
    return results


def _bwd_plain_f64(feat_t, pos_t, weights, g, k: int, n_freqs: int, step: int = 5):
    """fused_mlp_posenc_wsum_bwd_plain in float64, in slices of ``step``
    instances (the dW summed over the slices) -> (dfeat_t, [(dW, db)])."""
    f64 = lambda t: t.double()
    w64 = [(f64(w), f64(b)) for w, b in weights]
    dfs, dws = [], None
    for i0 in range(0, feat_t.shape[0], step):
        sl = slice(i0, i0 + step)
        df, dw = fused_mlp_posenc_wsum_bwd_plain(f64(feat_t[sl]), f64(pos_t[sl]), w64,
                                                 f64(g[sl]), k, n_freqs)
        dfs.append(df)
        dws = dw if dws is None else [(a + c, b + d) for (a, b), (c, d) in zip(dws, dw)]
    return torch.cat(dfs), dws


class _FirstObjects:
    """A dataset whose clouds (the coords table) are all of ``ds``'s and
    whose batches come from its first ``n`` objects: the stage-1 run takes
    n / batch steps of one epoch."""

    def __init__(self, ds, n: int):
        self.ds, self.n = ds, n

    def __len__(self) -> int:
        return self.n

    def batch(self, indices):
        return self.ds.batch(indices)

    def get_all_coords(self):
        return self.ds.get_all_coords()


def _stage1_dataset(config, n_obj: int, num_views: int):
    m = config["model"]
    return SyntheticNPCTrain(n_obj=n_obj, num_views=num_views,
                             image_size=build_pointnerf_options(config).default_resolution,
                             num_points=m["num_points"], seed=0)


def phase_stage1() -> dict:
    """python -m npcd_tpu_torch.train_pointnerf's code path, full geometry."""
    out = OUT / "stage1"
    shutil.rmtree(out, ignore_errors=True)
    config = load_config(str(SRNCARS))
    config["pointnerf_training"].update(max_epochs=1, print_interval=1, log_scalars_interval=1)
    m = config["model"]
    t0 = time.perf_counter()
    full = _stage1_dataset(config, m["n_obj"], 50)
    dataset = _FirstObjects(full, STAGE1_OBJECTS)
    print(f"[stage1] seeded synthetic dataset: {m['n_obj']} clouds x {m['num_points']} points, "
          f"50 views at 128^2, batches from the first {STAGE1_OBJECTS} objects "
          f"({time.perf_counter() - t0:.1f} s)")
    args = train_pointnerf.parse_args(["--config", str(SRNCARS), "--output", str(out),
                                       "--device", "cuda", "--no_tensorboard", "--seed", "0"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    trainer = train_pointnerf.train(args, config, dataset)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    steps = STAGE1_OBJECTS // trainer.batch_size
    hist = trainer.history
    if [h["it"] for h in hist] != list(range(1, steps + 1)):
        raise AssertionError(f"expected {steps} logged steps, got {len(hist)}")
    keys = ("loss", "00_image_reconstruction_loss", "01_neural_point_cloud_kl",
            "02_neural_point_cloud_tv")
    for h in hist:
        if not all(np.isfinite(h[k]) for k in keys):
            raise AssertionError(f"non-finite loss at step {h['it']}: {h}")
    steps_s = (steps - STAGE1_WARMUP) / (hist[-1]["time"] - hist[STAGE1_WARMUP - 1]["time"])
    model = trainer.model
    rays = trainer.batch_size * 50 * model.cfg.train_rays
    print(f"[stage1] B {trainer.batch_size} x V 50 x {model.cfg.train_rays} rays x "
          f"{model.opts.renderer.depth_resolution} samples, validity {model.cfg.validity}, remat "
          f"{model.cfg.resolved_train_remat()}: {steps} steps in {wall:.1f} s (with the final "
          f"checkpoint and export): {steps_s:.4f} steps/s, {rays * steps_s:.0f} train rays/s over "
          f"steps {STAGE1_WARMUP + 1}-{steps}; peak {peak_gib:.2f} GiB")
    for k in keys:
        print(f"[stage1] {k} " + " ".join(f"{h[k]:.6g}" for h in hist))
    coords = torch.as_tensor(full.get_all_coords(), device="cuda")
    if not torch.equal(model.tables.coords_table, coords):
        raise AssertionError("the frozen coords table changed")

    fresh = PointNeRFTraining(str(out), build_pointnerf(config, with_tables=True), dataset,
                              device="cuda", verbose=False, **config["pointnerf_training"])
    a, b = trainer.state_dict(), fresh.state_dict()
    same = a["step"] == b["step"] == steps and a["presample_rng"] == b["presample_rng"]
    same = same and all(torch.equal(v, b["model"][k]) for k, v in a["model"].items())
    opt_a, opt_b = a["optimizer"]["state"], b["optimizer"]["state"]
    same = same and opt_a.keys() == opt_b.keys() and all(
        torch.equal(v, opt_b[i][k]) for i, st in opt_a.items() for k, v in st.items())
    print(f"[stage1] checkpoint restored into a fresh trainer at step {fresh.step}: "
          f"{'bitwise equal' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError("restored stage-1 train state differs from the saved one")
    del fresh, a, b, opt_a, opt_b
    export = trainer.weights_only_path(steps)
    latents, pointnerf = train_diffusion.load_pointnerf_weights(export, m["num_points"],
                                                                m["feats_dim"])
    if len(latents) != m["n_obj"] or not np.array_equal(
            latents.get_all_feats(), model.get_all_feats().detach().cpu().numpy()
            .transpose(2, 0, 1).reshape(m["feats_dim"], -1)):
        raise AssertionError("the weights-only export does not hold the trained feats table")
    print(f"[stage1] export {Path(export).name} loaded by train_diffusion's "
          f"load_pointnerf_weights: {len(latents)} objects, {len(pointnerf)} pointnerf arrays")
    del trainer, model, full, dataset, latents
    torch.cuda.empty_cache()
    return {"launches": launches, "steps_s": steps_s, "peak_gib": peak_gib}


def phase_stage1_cpu_step() -> None:
    """One stage-1 step at full MLP widths on 1 object x 2 views (112 rays x
    128 samples) from the same weights and draws: the card with its kernels
    vs the CPU with the plain versions."""
    config = load_config(str(SRNCARS))
    config["model"]["n_obj"] = 2
    config["pointnerf_training"]["batch_size"] = 1
    dataset = _stage1_dataset(config, 2, 2)
    src = build_pointnerf(config, torch.Generator().manual_seed(0), with_tables=True)
    src.set_all_coords(dataset.get_all_coords())
    rng = np.random.default_rng(0)
    o = src.opts
    with torch.no_grad():  # a feats table away from its zero init
        src.tables.feats_table.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(1))
    state = {k: v.clone() for k, v in src.state_dict().items()}
    batch = dataset.batch([1])
    draws = {"pixel_idx": rng.choice(o.default_resolution ** 2, o.renderer.ray_subsamples,
                                     replace=False).astype(np.int32),
             "feats_eps": rng.standard_normal((1, o.num_points, o.feat_dim), dtype=np.float32),
             "depth_jitter": rng.uniform(size=(2, o.renderer.ray_subsamples,
                                               o.renderer.depth_resolution)).astype(np.float32)}
    out, lr = {}, config["pointnerf_training"]["base_learning_rate"]
    for dev in ("cuda", "cpu"):
        trainer = PointNeRFTraining(str(OUT / f"stage1_step_{dev}"),
                                    build_pointnerf(config, with_tables=True), dataset,
                                    device=dev, seed=0, verbose=False,
                                    save_checkpoint_interval_min=1e9,
                                    **{k: v for k, v in config["pointnerf_training"].items()
                                       if k != "save_checkpoint_interval_min"})
        trainer.model.load_state_dict(state)
        metrics = trainer.train_step(batch, draws=draws)
        named = dict(trainer.model.named_parameters())
        out[dev] = {"loss": float(metrics["loss"]),
                    "grads": {k: p.grad.detach().cpu()[1:2] if k == "tables.feats_table"
                              else p.grad.detach().cpu() for k, p in named.items()},
                    "params": {k: p.detach().cpu() for k, p in named.items()}}
    gpu, cpu = out["cuda"], out["cpu"]
    loss_err = abs(gpu["loss"] / cpu["loss"] - 1)
    # f32 in another summation order on the two devices (cuBLAS and the
    # kernels vs the CPU's plain versions): the loss within 1e-5 relative;
    # every gradient leaf (the batch's feats-table row for the table) within
    # 1e-3 of its largest magnitude: a pre-activation within an ulp of
    # leaky_relu's kink takes the other slope on the other device, and moves
    # a column of the lower layers' dW by ~1e-4 of its scale each. Adam's
    # first step moves each parameter by ~lr * sign(g), so a near-zero
    # gradient of the other sign moves it 2 lr apart: every parameter within
    # 2 lr + 1e-6 and all but 0.1% within 1e-6
    worst = max((_err(gpu["grads"][k], g) / max(float(g.abs().max()), 1e-30), k)
                for k, g in cpu["grads"].items())
    zero = [k for k, g in gpu["grads"].items() if float(g.abs().max()) == 0]
    diff = torch.cat([(gpu["params"][k] - v).abs().reshape(-1) for k, v in cpu["params"].items()])
    param_err, param_frac = float(diff.max()), float((diff > 1e-6).float().mean())
    print(f"[gpu-vs-cpu-stage1] full-width step on 1 object x 2 views: loss {gpu['loss']:.6f} vs "
          f"{cpu['loss']:.6f} (rel err {loss_err:.1e}, tol 1e-5); worst gradient leaf {worst[1]} "
          f"rel err {worst[0]:.2e} (tol 1e-3) over {len(cpu['grads'])} leaves; updated params "
          f"max_abs_err {param_err:.2e} (tol {2 * lr + 1e-6:.1e}), {param_frac:.1e} of them "
          f"beyond 1e-6 (tol 1e-3)")
    if (loss_err > 1e-5 or worst[0] > 1e-3 or zero or param_err > 2 * lr + 1e-6
            or param_frac > 1e-3):
        raise AssertionError(f"GPU and CPU stage-1 steps disagree (zero-gradient leaves {zero})")


def main() -> None:
    phase_env()
    phase_build()
    results = phase_kernels()
    results.update(phase_train_kernels())
    results.update(phase_stage1_kernels())
    gen_launches = phase_main()
    train_launches = phase_train()["launches"]
    stage1_launches = phase_stage1()["launches"]
    phase_cpu_step()
    phase_stage1_cpu_step()
    print(f"[launches] generation {json.dumps(gen_launches)}")
    print(f"[launches] training {json.dumps(train_launches)}")
    print(f"[launches] stage 1 {json.dumps(stage1_launches)}")
    missing = [n for n in GENERATION if gen_launches[n] == 0] + [
        n for n in TRAINING if train_launches[n] == 0] + [
        n for n in STAGE1 if stage1_launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by their main path: {missing}")
    kernels = [{"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": gen_launches[name] + train_launches[name] + stage1_launches[name],
                **results[name]}
               for name, (_, route, source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch port (npcd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:
  1. environment: card name and power limit (nvidia-smi), torch, CUDA,
     Triton and nvcc; fails without a GPU;
  2. build: compiles the CUDA kernels of npcd_tpu_torch/csrc with nvcc,
     then counts the tensor-core instructions (HMMA, HGMMA) in each K1 and
     K8 kernel's SASS (cuobjdump): every bf16 kernel of the two and every
     f32 one in namespace tf (3xTF32: K1b's tf::bwd_dq and tf::bwd_dkdv,
     K8f's tf::fwd, K8b's tf::bwd_dq and tf::bwd_dkdv) must have some, the
     f32 K1f (fqa_fwd, exact f32 on the CUDA cores) none; and in K6's
     (csrc/fused_mlp_posenc.cu) only the f32 forward and backward,
     tf::mlp_posenc_wsum and tf::mlp_posenc_wsum_bwd (3xTF32), have some;
  3. kernels: each kernel of the generation path against its plain PyTorch
     version on the card, at the shapes the main path gives it (f32), with
     the stated tolerance, and both timed with CUDA events; the LayerNorm
     forwards also by replaying a CUDA graph of 20 launches (device time
     without the host's launch cost) against their HBM bound; the f32 K6f
     (3xTF32 on the tensor cores) also against its plain version evaluated
     in float64 (within 1e-5 of its scale), beside the f32 plain version's
     own error against it. A kernel whose products run in 3xTF32 (the f32
     K1b, K8f, K8b and K6f) has its bound at the 3xTF32 rate (495/3
     TFLOP/s, the kernels line's bound_ms), its bound at the FP32 rate
     printed beside it;
  4. kernels, training: the attention forward with its log-sum-exp and its
     backward (pad rows of dq/dk/dv exactly 0), the LayerNorm forward with
     its mean/rstd and its backward in both forms, each backward fed its own
     side's forward outputs, and the AdamW + EMA pass (one [4096, 1024]
     leaf, then the whole 302M-parameter denoiser), each against its plain
     version at the stage-2 step's shapes, timed; the attention backward
     (3xTF32 on the tensor cores) also against a float64 evaluation of its
     plain version (dq, dk and dv each within 1e-5 of its scale), beside
     the f32 plain version's own error against it;
  5. main path, generation: python -m npcd_tpu_torch.generate_samples's code
     path on configs/npcd_srncars.yaml (302M denoiser, 1000 DDPM steps) with
     seeded weights, written first as the bridged .npz its required
     --weights reads, and validity 'voxel': 2 samples, each rendered from 4
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
     timed, K6f also against float64 as in phase 3; K6b (3xTF32) against its
     plain version evaluated in float64 (each output within 1e-5 of its
     scale), and two of its launches bitwise equal;
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
 11. kernels, fast stage 1 (configs/npcd_srncars_fast.yaml: bf16 compute,
     shading budget 1792, one chunk of 400 instances), at the shapes its step
     launches them: the field heads' MLP stack forward and backward (K7f/K7b)
     over 400 x 1,792 packed points for shape_net and channel_net, the bf16
     aggregation MLP forward and backward (K6f/K6b bf16) over the step's one
     launch of 400 x 14,336 pairs (the backward fed K6f's own output, held
     against the plain version in slices of instances), and the kNN over the
     400 x 1,792 packed points; rows and pairs on a leaky_relu kink in bf16
     are left out of the backward checks;
 12. main path, fast stage 1: phase 9 on configs/npcd_srncars_fast.yaml (bf16,
     budget 1792, remat off), 7 steps; also prints each instance's valid
     sample count (mean, max) and the share the budget drops;
 13. GPU vs CPU, fast stage 1: phase 10 on the fast config, the ray order
     injected so that both sides pack the same slots;
 14. kernels, bf16 stage 2, at the shapes the bf16 step (--dtype float16)
     launches them: the LayerNorm forward with its mean/rstd and its
     backward in both forms over [16,640, 1024] bf16, and the attention
     forward with its log-sum-exp and its backward over qkv [32*520, 3072]
     bf16, each against its bf16 plain version (the TPU kernels' rounding
     points), timed (the LayerNorm forwards also as a replayed CUDA graph),
     with F.layer_norm's and scaled_dot_product_attention's bf16 times
     beside them;
 15. attention: ops.attention.multi_head_attention(impl="auto") forward and
     backward over [32, 513, 16, 64] in f32 and in bf16, and over [32, 513,
     8, 128] in bf16 (the launch counts of its path), then the flash
     attention kernels forward and backward in each case against their
     plain versions, timed, with scaled_dot_product_attention's time beside
     them; the f32 forward and backward (3xTF32 on the tensor cores) also
     against a float64 evaluation of their plain versions (each output
     within 1e-5 of its scale), beside the f32 plain versions' own errors
     against it;
 16. main path, bf16 training: phase 6 with the CLI's default --dtype
     (float16: bf16 compute over f32 master weights, every block recomputed
     in the backward);
 17. GPU vs CPU, bf16: phase 7 with the bf16 denoiser and remat, then the
     card's step in f32 against the CPU's bf16 step, a control that must
     fail at least one of the bf16 limits;
 18. launch counts: every kernel must have launched during phase 5, 6, 9,
     12, 15 or 16, each kernel of a path during that path; the bf16 launches
     of K1, K2, K6 and K8 are counted apart from the f32 ones.
Every kernel's line gives its time, its plain version's, the least time
the card could take for the same work (bytes over 3.35 TB/s, or operations
over 67 TFLOP/s in FP32 and 989 TFLOP/s for the bf16 kernels (the dense
BF16 tensor-core peak), whichever is larger, at the measured shape; the f32
K1b, K8f, K8b, K6f and K6b also at 495 / 3 TFLOP/s, the TF32 peak over
their three products, K6b's recompute at the FP32 rate, where it runs) and,
where one PyTorch call computes the same function, that call's time. Each
phase prints its seconds. The line before the last is {"kernels": [...]};
the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import json
import re
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
from npcd_tpu_torch.generate_samples import (  # noqa: E402
    exact_f32, parse_args, run, write_seeded_weights)
from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel  # noqa: E402
from npcd_tpu_torch.models.npcd import NPCD  # noqa: E402
from npcd_tpu_torch.models.pointnerf import pointnerf as pointnerf_module  # noqa: E402
from npcd_tpu_torch.models.pointnerf.nn_core import init_mlp  # noqa: E402
from npcd_tpu_torch.ops.kernels import build  # noqa: E402
from npcd_tpu_torch.ops.kernels.fused_mlp import (  # noqa: E402
    fused_mlp, fused_mlp_bwd, fused_mlp_bwd_plain, fused_mlp_plain, leaky_kinks_bf16)
from npcd_tpu_torch.ops.kernels.fused_adamw import adamw_ema, adamw_ema_plain  # noqa: E402
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import (  # noqa: E402
    fused_mlp_posenc_wsum, fused_mlp_posenc_wsum_bwd, fused_mlp_posenc_wsum_bwd_plain,
    fused_mlp_posenc_wsum_plain, leaky_kinks)
from npcd_tpu_torch.ops.attention import multi_head_attention  # noqa: E402
from npcd_tpu_torch.ops.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_plain)
from npcd_tpu_torch.ops.kernels.fused_qkv_attention import (  # noqa: E402
    LOG2_E, fused_qkv_attention, fused_qkv_attention_bf16_plain, fused_qkv_attention_bwd,
    fused_qkv_attention_bwd_bf16_plain, fused_qkv_attention_bwd_plain, fused_qkv_attention_fwd,
    fused_qkv_attention_plain, split_grouped_qkv)
from npcd_tpu_torch.ops.kernels.knn import knn, knn_plain, min_d2, min_d2_plain  # noqa: E402
from npcd_tpu_torch.ops.kernels.layer_norm import (  # noqa: E402
    layer_norm, layer_norm_bwd, layer_norm_bwd_plain, layer_norm_fwd, layer_norm_fwd_plain,
    layer_norm_plain, layer_norm_residual, layer_norm_residual_bwd)
from npcd_tpu_torch.train import DiffusionTraining, PointNeRFTraining  # noqa: E402
from npcd_tpu_torch.utils.builders import (  # noqa: E402
    build_diffusion_model, build_pointnerf, build_pointnerf_options, torch_dtype)
from npcd_tpu_torch.utils.config import load_config  # noqa: E402
from npcd_tpu_torch.utils.from_jax import load_npz, save_npz  # noqa: E402

# the generation CLI's required --out (run() itself writes no files); the
# training path writes its checkpoints and exports under OUT / "train"
OUT = ROOT / "runs" / "chip_smoke"
SRNCARS = ROOT / "configs/npcd_srncars.yaml"
FAST = ROOT / "configs/npcd_srncars_fast.yaml"
TRAIN_STEPS = 8
WARMUP_STEPS = 2  # the first steps compile the Triton kernels

# name -> (wrapper, its launch counter, route, source, the TPU kernel it
# replaces)
KERNELS = {
    "fused_qkv_attention": (fused_qkv_attention, "launches", "cuda",
                            "npcd_tpu_torch/csrc/fused_qkv_attention.cu",
                            "npcd_tpu/ops/pallas/fused_qkv_attention.py:131"),
    "layer_norm": (layer_norm, "launches", "cuda", "npcd_tpu_torch/csrc/layer_norm.cu",
                   "npcd_tpu/ops/pallas/layer_norm.py:99"),
    "layer_norm_residual": (layer_norm_residual, "launches", "cuda",
                            "npcd_tpu_torch/csrc/layer_norm.cu",
                            "npcd_tpu/ops/pallas/layer_norm.py:206"),
    "knn": (knn, "launches", "cuda", "npcd_tpu_torch/csrc/knn.cu", "npcd_tpu/ops/pallas/knn.py:78"),
    "fused_mlp_posenc_wsum": (fused_mlp_posenc_wsum, "launches", "cuda",
                              "npcd_tpu_torch/csrc/fused_mlp_posenc.cu",
                              "npcd_tpu/ops/pallas/fused_mlp.py:382"),
    "fused_qkv_attention_bwd": (fused_qkv_attention_bwd, "launches", "cuda",
                                "npcd_tpu_torch/csrc/fused_qkv_attention.cu",
                                "npcd_tpu/ops/pallas/fused_qkv_attention.py:203"),
    "layer_norm_bwd": (layer_norm_bwd, "launches", "triton",
                       "npcd_tpu_torch/ops/kernels/layer_norm.py",
                       "npcd_tpu/ops/pallas/layer_norm.py:114"),
    "layer_norm_residual_bwd": (layer_norm_residual_bwd, "launches", "triton",
                                "npcd_tpu_torch/ops/kernels/layer_norm.py",
                                "npcd_tpu/ops/pallas/layer_norm.py:221"),
    "adamw_ema": (adamw_ema, "launches", "triton", "npcd_tpu_torch/ops/kernels/fused_adamw.py",
                  "npcd_tpu/ops/pallas/fused_adamw.py:36"),
    "min_d2": (min_d2, "launches", "cuda", "npcd_tpu_torch/csrc/knn.cu",
               "npcd_tpu/ops/pallas/knn.py:67"),
    "fused_mlp_posenc_wsum_bwd": (fused_mlp_posenc_wsum_bwd, "launches", "cuda",
                                  "npcd_tpu_torch/csrc/fused_mlp_posenc.cu",
                                  "npcd_tpu/ops/pallas/fused_mlp.py:430"),
    "fused_mlp": (fused_mlp, "launches", "cuda", "npcd_tpu_torch/csrc/fused_mlp.cu",
                  "npcd_tpu/ops/pallas/fused_mlp.py:120"),
    "fused_mlp_bwd": (fused_mlp_bwd, "launches", "cuda", "npcd_tpu_torch/csrc/fused_mlp.cu",
                      "npcd_tpu/ops/pallas/fused_mlp.py:130"),
    "fused_mlp_posenc_wsum (bf16)": (fused_mlp_posenc_wsum, "launches_bf16", "cuda",
                                     "npcd_tpu_torch/csrc/fused_mlp_posenc.cu",
                                     "npcd_tpu/ops/pallas/fused_mlp.py:382"),
    "fused_mlp_posenc_wsum_bwd (bf16)": (fused_mlp_posenc_wsum_bwd, "launches_bf16", "cuda",
                                         "npcd_tpu_torch/csrc/fused_mlp_posenc.cu",
                                         "npcd_tpu/ops/pallas/fused_mlp.py:430"),
    "fused_qkv_attention (bf16)": (fused_qkv_attention, "launches_bf16", "cuda",
                                   "npcd_tpu_torch/csrc/fused_qkv_attention.cu",
                                   "npcd_tpu/ops/pallas/fused_qkv_attention.py:131"),
    "fused_qkv_attention_bwd (bf16)": (fused_qkv_attention_bwd, "launches_bf16", "cuda",
                                       "npcd_tpu_torch/csrc/fused_qkv_attention.cu",
                                       "npcd_tpu/ops/pallas/fused_qkv_attention.py:203"),
    "layer_norm (bf16)": (layer_norm, "launches_bf16", "cuda",
                          "npcd_tpu_torch/csrc/layer_norm.cu",
                          "npcd_tpu/ops/pallas/layer_norm.py:99"),
    "layer_norm_residual (bf16)": (layer_norm_residual, "launches_bf16", "cuda",
                                   "npcd_tpu_torch/csrc/layer_norm.cu",
                                   "npcd_tpu/ops/pallas/layer_norm.py:206"),
    "layer_norm_bwd (bf16)": (layer_norm_bwd, "launches_bf16", "triton",
                              "npcd_tpu_torch/ops/kernels/layer_norm.py",
                              "npcd_tpu/ops/pallas/layer_norm.py:114"),
    "layer_norm_residual_bwd (bf16)": (layer_norm_residual_bwd, "launches_bf16", "triton",
                                       "npcd_tpu_torch/ops/kernels/layer_norm.py",
                                       "npcd_tpu/ops/pallas/layer_norm.py:221"),
    "flash_attention": (flash_attention, "launches", "cuda",
                        "npcd_tpu_torch/csrc/flash_attention.cu",
                        "npcd_tpu/ops/pallas/flash_attention.py:34"),
    "flash_attention_bwd": (flash_attention_bwd, "launches", "cuda",
                            "npcd_tpu_torch/csrc/flash_attention.cu",
                            "npcd_tpu/ops/pallas/flash_attention.py:95"),
    "flash_attention (bf16)": (flash_attention, "launches_bf16", "cuda",
                               "npcd_tpu_torch/csrc/flash_attention.cu",
                               "npcd_tpu/ops/pallas/flash_attention.py:34"),
    "flash_attention_bwd (bf16)": (flash_attention_bwd, "launches_bf16", "cuda",
                                   "npcd_tpu_torch/csrc/flash_attention.cu",
                                   "npcd_tpu/ops/pallas/flash_attention.py:95"),
}
GENERATION = ("fused_qkv_attention", "layer_norm", "layer_norm_residual", "knn",
              "fused_mlp_posenc_wsum")
TRAINING = ("fused_qkv_attention", "fused_qkv_attention_bwd", "layer_norm",
            "layer_norm_residual", "layer_norm_bwd", "layer_norm_residual_bwd", "adamw_ema")
TRAINING_BF16 = ("fused_qkv_attention (bf16)", "fused_qkv_attention_bwd (bf16)",
                 "layer_norm (bf16)", "layer_norm_residual (bf16)", "layer_norm_bwd (bf16)",
                 "layer_norm_residual_bwd (bf16)", "adamw_ema")
ATTENTION = ("flash_attention", "flash_attention_bwd", "flash_attention (bf16)",
             "flash_attention_bwd (bf16)")
STAGE1 = ("knn", "min_d2", "fused_mlp_posenc_wsum", "fused_mlp_posenc_wsum_bwd")
FAST_STAGE1 = ("knn", "min_d2", "fused_mlp", "fused_mlp_bwd", "fused_mlp_posenc_wsum (bf16)",
               "fused_mlp_posenc_wsum_bwd (bf16)")
STAGE1_OBJECTS = 56  # objects with images in the stage-1 run: 7 steps of batch 8
STAGE1_WARMUP = 2
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s, FP32
# operations/s outside the tensor cores, dense BF16 tensor-core
# operations/s (the bound of the bf16 kernels) and dense TF32 tensor-core
# operations/s (over 3, the rate of the split products of the f32 K1b, K8f,
# K8b, K6f and K6b)
HBM_BYTES_S, FP32_FLOP_S, BF16_FLOP_S, TF32_FLOP_S = 3.35e12, 67e12, 989e12, 495e12
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
# the part of K6B_FLOP that the f32 K6b runs in exact f32 on the CUDA cores:
# the recompute of layers 0-3
K6B_FP32_FLOP = _K6_HIDDEN
DIST_FLOP = 9  # per (query, point): 3 sub, 3 mul, 2 add, 1 compare


def _k7_flop(dims, d_in: int = 256) -> tuple:
    """(forward, backward) operations per row of the MLP stack d_in -> dims:
    the forward's products; the backward's recompute of the hidden layers,
    then dW and dX of every layer."""
    widths = list(zip((d_in,) + tuple(dims[:-1]), dims))
    fwd = sum(2 * a * b for a, b in widths)
    return fwd, fwd - 2 * widths[-1][0] * widths[-1][1] + 2 * fwd


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


def _kernel_name(mangled: str) -> str:
    """tc::fwd of _ZN<len>_GLOBAL__N_...<len>tc<len>fwdE... (the nested name
    without its anonymous namespace), tc::fwd<64> of ...<len>fwdILi64EEE...
    (a template's integer arguments)."""
    parts, i = [], 3
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    name = "::".join(p for p in parts if not p.startswith("_GLOBAL"))
    args = re.match(r"I((?:Li\d+E)+)E", mangled[i:])
    if args:
        name += "<" + ", ".join(re.findall(r"Li(\d+)E", args.group(1))) + ">"
    return name


def _sass_mma_counts(name: str) -> dict:
    """{(kernel, 'bf16' or 'f32'): tensor-core instructions (HMMA, HGMMA)
    in its SASS} of the built csrc/<name>.cu, read with cuobjdump."""
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(build.so_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            key = (_kernel_name(fn), "bf16" if "bfloat16" in fn else "f32")
            counts[key] = 0
        elif key is not None and re.search(r"\bHG?MMA\.", line):
            counts[key] += 1
    return counts


def phase_build() -> None:
    t0 = time.perf_counter()
    names = build.build_all()
    print(f"[build] {', '.join(names)} built in {time.perf_counter() - t0:.1f} s")
    # the bf16 K1 and K8 and every f32 kernel in namespace tf (3xTF32: the
    # f32 K1b, K8f, K8b, K6f and K6b) run their products on the tensor cores;
    # the f32 K1f (fqa_fwd: exact f32, no TF32) and every K6 kernel outside
    # tf (split_weights, split_weights_t, the bf16 forward and backward,
    # reduce_partials_bf16 and _tf32) on the CUDA cores; K1 has 6 kernels,
    # K8 12 (3 per flavour at D 64 and 128), K6 8
    in_tf = lambda k: k[0].startswith("tf::")
    tensor_cores = lambda k: k[1] == "bf16" or in_tf(k)
    for name, n_kernels, rule in (("fused_qkv_attention", 6, tensor_cores),
                                  ("flash_attention", 12, tensor_cores),
                                  ("fused_mlp_posenc", 8, in_tf)):
        counts = _sass_mma_counts(name)
        print(f"[build] {name} SASS tensor-core instructions: "
              + ", ".join(f"{k} ({t}) {n}" for (k, t), n in sorted(counts.items())))
        wrong = [k for k, n in counts.items() if (n > 0) != rule(k)]
        if len(counts) != n_kernels or wrong:
            raise AssertionError(f"{name}: tensor-core use differs from the design: "
                                 f"{wrong or counts}")


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


def _graph_ms(fn, iters: int = 20) -> float:
    """The device time of one ``fn()``: a CUDA graph of ``iters`` launches
    captured after a warm-up on a side stream, replayed once, timed with
    CUDA events (no Python or launch cost between the kernels)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _err64(a, exact) -> float:
    """The largest difference of ``a`` from a float64 ``exact``."""
    return float((a.double() - exact).abs().max())


def _f64_gate(name: str, got, exact) -> str:
    """A 3xTF32 kernel's outputs against a float64 evaluation of its plain
    version: each within 1e-5 of max(1, its largest magnitude), the f32
    tolerance of the card tests and of the CPU tests that transcribe the
    3xTF32 arithmetic (a kernel without its lo products reads ~3e-5 to 9e-4
    at these shapes) -> the errors as text; raises past it."""
    errs = [(_err64(a, e), 1e-5 * max(1.0, float(e.abs().max()))) for a, e in zip(got, exact)]
    text = " ".join(f"{err:.2e}" for err, _ in errs)
    if any(err > tol for err, tol in errs):
        raise AssertionError(f"{name} disagrees with float64: {text} against "
                             + " ".join(f"{tol:.1e}" for _, tol in errs))
    return text


def _furthest(pairs) -> tuple:
    """(max_abs_err, tol) per output -> the pair furthest past its own tol."""
    return max(pairs, key=lambda p: p[0] / p[1])


def _worst(triples) -> tuple:
    """(got, want, rel) per output, each output's tolerance rel x max(1,
    max|want|) -> (max_abs_err, tol) of the output furthest past its own."""
    return _furthest([(_err(got, want), rel * max(1.0, float(want.abs().max())))
                      for got, want, rel in triples])


def _record(results: dict, name: str, err: float, tol: float, kernel_fn, plain_fn,
            extra: str = "", tag: str = "kernels", flops: float = 0.0, nbytes: float = 0.0,
            library_fn=None, peak: float = FP32_FLOP_S, iters: int = 20,
            graph: bool = False, tf32: bool = False, fp32_flops: float = 0.0) -> None:
    """Time kernel, plain version and (where there is one) the library call
    computing the same function, ``iters`` runs each; print; raise when
    err > tol. The bound is the larger of nbytes over the HBM rate and flops
    over ``peak`` (operations/s); with ``tf32`` (an f32 kernel whose
    products run in 3xTF32), flops over the 3xTF32 rate but ``fp32_flops``
    of them (run in exact f32 on the CUDA cores) over the FP32 rate, its
    bounds at the FP32 rate and (with fp32_flops) all at the 3xTF32 rate
    printed beside it. With ``graph``, the kernel's device time
    from a replayed CUDA graph is printed too, with its share of the bound."""
    ms, plain_ms = _time_ms(kernel_fn, iters), _time_ms(plain_fn, iters)
    library_ms = _time_ms(library_fn, iters) if library_fn is not None else None
    op_s = flops / peak
    if tf32:
        extra += f"; bound at the FP32 rate {flops / FP32_FLOP_S * 1e3:.4f} ms"
        op_s = fp32_flops / FP32_FLOP_S + (flops - fp32_flops) / (TF32_FLOP_S / 3)
        if fp32_flops:
            extra += f", all at the 3xTF32 rate {flops / (TF32_FLOP_S / 3) * 1e3:.4f} ms"
    bound_by = "bytes" if nbytes / HBM_BYTES_S >= op_s else "operations"
    bound_ms = max(nbytes / HBM_BYTES_S, op_s) * 1e3
    if graph:
        graph_ms = _graph_ms(kernel_fn, iters)
        extra += f" graph replay {graph_ms:.4f} ms ({bound_ms / graph_ms:.3f} of the bound)"
    ok = err <= tol
    lib = f" library {library_ms:.4f} ms" if library_ms is not None else ""
    rate = " at the 3xTF32 rate" if tf32 else ""
    if fp32_flops:
        rate += " (its f32 part at the FP32 rate)"
    print(f"[{tag}] {name}: max_abs_err {err:.3e} (tol {tol:.1e}) "
          f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms{lib} bound{rate} {bound_ms:.4f} ms "
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
          library_fn=lambda: F.layer_norm(x, (1024,), gamma, beta, 1e-5), graph=True)
    r_k, y_k = layer_norm_residual(x, d, gamma, beta)
    r_p, y_p = layer_norm_plain(x, gamma, beta, delta=d)
    check("layer_norm_residual", max(_err(r_k, r_p), _err(y_k, y_p)), 1e-4,
          lambda: layer_norm_residual(x, d, gamma, beta),
          lambda: layer_norm_plain(x, gamma, beta, delta=d), flops=9 * n_el,
          nbytes=4 * (4 * n_el + 2048), graph=True)

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
    got = fused_mlp_posenc_wsum(*kargs)
    err = _err(got, want)
    scale = max(1.0, float(want.abs().max()))
    n_w = sum(t.numel() for wb in weights for t in wb)
    check("fused_mlp_posenc_wsum", err, 1e-4 * scale, lambda: fused_mlp_posenc_wsum(*kargs),
          lambda: fused_mlp_posenc_wsum_plain(*kargs), flops=K6F_FLOP * 8 * m,
          nbytes=4 * (feat_t.numel() + pos_t.numel() + n_w + want.numel()),
          extra=_k6f_vs_f64("fused_mlp_posenc_wsum", kargs, got, want), tf32=True)
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
    exact = split_grouped_qkv(_fqa_bwd_f64(qkv, dout, h, b, s, valid, 2).reshape(b, s, -1), h, 2)
    parts = lambda x: split_grouped_qkv(x.reshape(b, s, -1), h, 2)
    errs = lambda x: " ".join(f"{_err64(a, e):.2e}" for a, e in zip(parts(x), exact))
    flops = 10 * b * h * s * valid * 64
    extra = (f" pad-row dq/dk/dv all 0; vs float64 dq/dk/dv (tol 1e-5 of each scale): kernel "
             f"{_f64_gate('fused_qkv_attention_bwd', parts(got), exact)}, f32 plain "
             f"{errs(want)}")
    del exact
    # the library call: autograd's backward of scaled_dot_product_attention
    q, k, v = _bhsd(qkv, b, s, h, 2, grad=True)
    key_mask = (torch.arange(s, device=dev) < valid)[None, None, None, :]
    o_lib = F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)
    do_lib = dout.reshape(b, s, h, -1).transpose(1, 2).contiguous()
    check("fused_qkv_attention_bwd", err, tol, bwd, bwd_plain, extra=extra, flops=flops,
          nbytes=4 * (2 * qkv.numel() + 2 * dout.numel() + lse_k.numel()), tf32=True,
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


def _fqa_bwd_f64(qkv, dout, heads: int, b: int, s: int, valid: int, groups: int,
                 step: int = 8):
    """dqkv [B*S, 3W] float64 from qkv and dout: the plain forward's
    arithmetic (base-2 scores, keys >= valid masked) and then
    fused_qkv_attention_bwd_plain's, both in float64, in slices of ``step``
    sequences."""
    parts = []
    for i in range(0, b, step):
        n = min(step, b - i)
        qkv64 = qkv[i * s:(i + n) * s].double()
        q, k, v = split_grouped_qkv(qkv64.reshape(n, s, -1), heads, groups)
        s2 = torch.einsum("bthc,bshc->bhts", q * (LOG2_E / np.sqrt(q.shape[-1])), k)
        s2[..., valid:] = -torch.inf
        m = s2.amax(-1, keepdim=True)
        lse = m + torch.log2(torch.exp2(s2 - m).sum(-1, keepdim=True))
        out = torch.einsum("bhts,bshc->bthc", torch.exp2(s2 - lse), v).reshape(n * s, -1)
        del s2
        parts.append(fused_qkv_attention_bwd_plain(qkv64, out, lse[..., 0],
                                                   dout[i * s:(i + n) * s].double(), heads, n,
                                                   s, valid, groups))
    return torch.cat(parts)


def _reset_launches() -> None:
    for wrapper, counter, *_ in KERNELS.values():
        setattr(wrapper, counter, 0)


def _read_launches() -> dict:
    return {name: getattr(wrapper, counter) for name, (wrapper, counter, *_) in KERNELS.items()}


def phase_main() -> dict:
    weights = write_seeded_weights(str(SRNCARS), str(OUT / "seeded_npcd.npz"), seed=0)
    args = parse_args([
        "--config", str(SRNCARS), "--out", str(OUT), "--weights", weights,
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


def phase_train(dtype: str | None = "float32", tag: str = "train") -> dict:
    """python -m npcd_tpu_torch.train_diffusion's code path, full size, with
    ``--dtype dtype`` (None: the CLI's default, float16 = bf16 with remat)."""
    out = OUT / tag
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    config = load_config(str(SRNCARS))
    config["diffusion_training"].update(max_iterations=TRAIN_STEPS, print_interval=1,
                                        log_scalars_interval=1)
    t0 = time.perf_counter()
    _seeded_pointnerf_npz(config, out / "pointnerf.npz")
    print(f"[{tag}] seeded latent tables {config['model']['n_obj']} x "
          f"{config['model']['num_points']} x (3 + {config['model']['feats_dim']}) "
          f"written in {time.perf_counter() - t0:.1f} s")
    args = train_diffusion.parse_args([
        "--config", str(SRNCARS), "--output", str(out / "run"), "--pointnerf_weights",
        str(out / "pointnerf.npz"), "--device", "cuda", "--no_tensorboard", "--seed", "0"]
        + (["--dtype", dtype] if dtype is not None else []))
    compute, remat = train_diffusion.DTYPES[args.dtype]
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
    print(f"[{tag}] denoiser {n_params / 1e6:.1f}M params, batch {trainer.batch_size}, --dtype "
          f"{args.dtype} (compute {compute}, remat {remat}), "
          f"{TRAIN_STEPS} steps in {wall:.1f} s (with the final checkpoint and exports): "
          f"{steps_s:.4f} steps/s over steps {WARMUP_STEPS + 1}-{TRAIN_STEPS}; "
          f"peak {peak_gib:.2f} GiB")
    print(f"[{tag}] loss " + " ".join(f"{h['loss']:.5f}" for h in hist))
    print(f"[{tag}] grad_norm " + " ".join(f"{h['grad_norm']:.5f}" for h in hist))
    # output_proj starts at zero: eps_hat = 0 and the first loss is
    # (mean(n_c^2) + mean(n_f^2)) / 2 over 32 x 512 x 35 normals, ~1
    if abs(hist[0]["loss"] - 1.0) > 0.05:
        raise AssertionError(f"first loss {hist[0]['loss']} is not ~1 with a zero output_proj")

    fresh = DiffusionTraining(str(out / "run"),
                              build_diffusion_model(config, torch_dtype(compute), remat),
                              trainer.dataset, device="cuda", verbose=False,
                              **config["diffusion_training"])
    a, b = trainer.state_dict(), fresh.state_dict()
    same = all(torch.equal(a[k], b[k]) for k in ("params", "mu", "nu", "emas"))
    same = same and (a["count"], a["step"]) == (b["count"], b["step"]) == (TRAIN_STEPS,) * 2
    print(f"[{tag}] checkpoint restored into a fresh trainer at step {fresh.step}: "
          f"{'bitwise equal' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError("restored train state differs from the saved one")
    del fresh, a, b
    ema_path = trainer.weights_only_paths(TRAIN_STEPS)[1]
    npcd = NPCD.from_config(config, seed=1)  # generate_samples's model: f32
    load_npz(npcd, ema_path)
    ema = trainer.flat.as_dict(trainer.emas[0].cpu())
    if not all(torch.equal(p.detach(), ema[n])
               for n, p in npcd.diffusion.denoiser.named_parameters()):
        raise AssertionError("the EMA export does not hold the trainer's EMA")
    print(f"[{tag}] EMA export {Path(ema_path).name} loaded through load_npz: equal")
    del trainer, npcd, ema
    shutil.rmtree(out, ignore_errors=True)  # the 4.8 GB checkpoint
    torch.cuda.empty_cache()
    return {"launches": launches, "steps_s": steps_s, "peak_gib": peak_gib}


def phase_cpu_step(dtype: torch.dtype = torch.float32, tag: str = "gpu-vs-cpu") -> None:
    """One training step of a full-width 2-layer denoiser at batch 2 from the
    same weights and draws: the card with its kernels vs the CPU with the
    plain versions; in bf16 with the blocks recomputed, as --dtype float16
    trains, and then the card's step in f32, a control that must fall past
    the bf16 limits."""
    bf16 = dtype == torch.bfloat16
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
    lr = 7e-5

    def step(dev: str, compute: torch.dtype) -> dict:
        model = DiffusionModel(layers=2, dtype=compute, remat=compute == torch.bfloat16, **kw)
        trainer = DiffusionTraining(str(OUT / f"{tag}_{dev}"), model, ds,
                                    batch_size=2, base_learning_rate=lr, weight_decay=0.01,
                                    max_iterations=1, use_ema=True,
                                    ema_params=[(1, 0.9999, 0.9999, False)], device=dev,
                                    verbose=False)
        trainer.flat.from_dict(trainer.flat.params, weights)
        with torch.no_grad():
            trainer.emas.copy_(trainer.flat.params[None])
        metrics = trainer.train_step(batch, draws=tuple(t.to(dev) for t in draws))
        return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                "grads": {k: v.cpu() for k, v in trainer.flat.as_dict(trainer.flat.grads).items()},
                "params": trainer.flat.params.cpu()}

    def readings(gpu: dict, cpu: dict) -> dict:
        """The GPU step against the CPU step: the loss's and grad_norm's
        relative errors, the worst gradient leaf's error over its largest
        magnitude, the updated parameters' largest difference and the share
        of them more than 1e-6 apart."""
        leaf = max((_err(gpu["grads"][k], g) / max(float(g.abs().max()), 1e-30), k)
                   for k, g in cpu["grads"].items())
        diff = (gpu["params"] - cpu["params"]).abs()
        return {"loss": abs(gpu["loss"] / cpu["loss"] - 1),
                "grad_norm": abs(gpu["grad_norm"] / cpu["grad_norm"] - 1),
                "leaf": leaf[0], "leaf_name": leaf[1],
                "param_err": float(diff.max()), "param_frac": float((diff > 1e-6).float().mean())}

    def line(r: dict) -> str:
        return (f"loss rel err {r['loss']:.2e} (tol {limits['loss']:.1e}), grad_norm rel err "
                f"{r['grad_norm']:.2e} (tol {limits['grad_norm']:.1e}); worst gradient leaf "
                f"{r['leaf_name']} rel err {r['leaf']:.2e} (tol {limits['leaf']:.1e}); "
                f"updated params max_abs_err {r['param_err']:.2e} "
                f"(tol {2 * lr + 1e-6:.1e}), {r['param_frac']:.2e} of them beyond 1e-6 "
                f"(tol {limits['param_frac']:.1e})")

    # f32 sums of up to 4096 terms and the attention softmax in another
    # order (cuBLAS, the kernels) than on the CPU: every gradient leaf within
    # 1e-4 of its largest magnitude, the loss and grad_norm within 1e-5
    # relative. The first Adam step moves each parameter by lr * sign(g): a
    # near-zero gradient with another sign on the two sides moves it 2 lr
    # apart, so every parameter within 2 lr + 1e-6 and all but 0.1% within
    # 1e-6. In bf16 a rounding flips where an f32 sum runs in another order,
    # and the sums over tokens carry it; a gradient whose terms nearly cancel
    # may take the other sign on one side only. The bf16 limits lie between
    # the sound step's readings on an H100 (loss 7.3e-6, grad_norm 1.2e-5,
    # worst leaf 8.15e-3, 0.98% of the parameters) and those of a control
    # that computes the card's step in f32 on the same inputs (loss 1.9e-5,
    # grad_norm 1.03e-4, worst leaf 1.04e-2, 2.2%): the control must fail at
    # least one, so that a step that quietly ran in f32 fails
    limits = ({"loss": 1.2e-5, "grad_norm": 3.7e-5, "leaf": 9.2e-3, "param_frac": 1.5e-2}
              if bf16 else {"loss": 1e-5, "grad_norm": 1e-5, "leaf": 1e-4, "param_frac": 1e-3})
    past = lambda r: [k for k, v in limits.items() if r[k] > v] + (
        ["param_err"] if r["param_err"] > 2 * lr + 1e-6 else [])
    gpu, cpu = step("cuda", dtype), step("cpu", dtype)
    zero = [k for k, g in gpu["grads"].items() if float(g.abs().max()) == 0]
    sound = readings(gpu, cpu)
    print(f"[{tag}] 2-layer full-width {str(dtype).split('.')[-1]} step at batch 2: loss "
          f"{gpu['loss']:.6f} vs {cpu['loss']:.6f}, grad_norm {gpu['grad_norm']:.6f} vs "
          f"{cpu['grad_norm']:.6f} over {len(cpu['grads'])} leaves: {line(sound)}")
    if past(sound) or zero:
        raise AssertionError(f"GPU and CPU training steps disagree: past {past(sound)}, "
                             f"zero-gradient leaves {zero}")
    if bf16:
        control = readings(step("cuda", torch.float32), cpu)
        print(f"[{tag}] control, the card's step in f32 against the CPU's in bf16: "
              f"{line(control)}; past {past(control)}")
        if not past(control):
            raise AssertionError("the bf16 step's limits do not tell bf16 compute from f32")


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
          nbytes=4 * (feat_t.numel() + pos_t.numel() + n_w + want.numel()),
          extra=_k6f_vs_f64("fused_mlp_posenc_wsum (stage-1 chunk)", fargs, gout, want),
          tf32=True)
    del want
    torch.cuda.empty_cache()
    # K6b (3xTF32) is held against its plain version evaluated in float64
    # (in slices of 5 instances, the dW summed over the slices): its dW sums
    # run over 2.24M pairs, where the f32 plain version's own rounding (cuBLAS's
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
          flops=K6B_FLOP * inst * m, fp32_flops=K6B_FP32_FLOP * inst * m,
          nbytes=4 * (2 * feat_t.numel() + pos_t.numel() + gout.numel() + 2 * n_w), tf32=True)
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


def _k6f_f64(feat_t, pos_t, weights, k: int, n_freqs: int, step: int = 5):
    """fused_mlp_posenc_wsum_plain evaluated in float64, in slices of
    ``step`` instances (the 'anchored' posenc is computed in f32 by both
    sides)."""
    w64 = [(w.double(), b.double()) for w, b in weights]
    return torch.cat([fused_mlp_posenc_wsum_plain(feat_t[i:i + step].double(),
                                                  pos_t[i:i + step].double(), w64, k, n_freqs)
                      for i in range(0, feat_t.shape[0], step)])


def _k6f_vs_f64(name: str, kargs, got, want) -> str:
    """The f32 K6f (3xTF32) against the float64 plain version (raises past
    1e-5 of its scale), and the f32 plain version's own error against it ->
    text for its line."""
    exact = _k6f_f64(*kargs[:5])
    gate = _f64_gate(name, [got], [exact])
    plain_err = _err64(want, exact)
    del exact
    return f" vs float64 (tol 1e-5 of its scale): kernel {gate}, f32 plain {plain_err:.2e}"


def phase_fast_kernels() -> dict:
    """K7f/K7b, the bf16 K6f/K6b and K4 vs their plain versions at the shapes
    the fast stage-1 step gives them (400 instances x 1,792 packed shading
    points, k 8, bf16 compute)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    results = {}
    check = lambda *a, **k: _record(results, *a, tag="kernels-fast", peak=BF16_FLOP_S, **k)
    inst, cap, k = 400, 1792, 8
    m = cap * k
    bf16 = lambda layers: [(l["w"].bfloat16(), l["b"].bfloat16()) for l in layers]

    # K4 over the packed points, f32 as in the step
    pts = torch.rand(inst, 512, 3, generator=g, device=dev) - 0.5
    xq = pts[:, torch.randint(0, 512, (cap,), generator=g, device=dev)] \
        + 0.05 * torch.randn(inst, cap, 3, generator=g, device=dev)
    _knn_check(lambda *a, **kw: _record(results, *a, tag="kernels-fast", **kw),
               "knn (fast stage-1 aggregation)", xq, pts)
    del pts, xq

    # K6f and K6b in bf16 over the step's one launch: 400 x 14,336 pairs, F
    # 32, the 95 -> 256 x 4 -> 256 MLP in bf16; K6b's cotangent is K6f's
    # own output. Pairs on a bf16 leaky_relu kink (fused_mlp_posenc.
    # leaky_kinks, checked in slices of 20 instances) get weight 0. Forward
    # within one bf16 ulp of the element plus one of the output's scale and
    # 99% bitwise; each backward output within 1e-2 of max(1, its largest
    # magnitude) of the plain version, run in slices of 20 instances (the dW
    # summed over the slices)
    weights = bf16(init_mlp((256, 256, 256, 256), 95, 256, torch.Generator().manual_seed(0),
                            dev))
    feat_t = torch.randn(inst, 32, m, generator=g, device=dev).bfloat16()
    w = torch.rand(inst, cap, k, generator=g, device=dev)
    pos_t = torch.cat([0.32 * torch.rand(inst, 3, m, generator=g, device=dev) - 0.16,
                       (w / w.sum(-1, keepdim=True)).reshape(inst, 1, m),
                       torch.zeros(inst, 4, m, device=dev)], dim=1)
    del w
    step = 20
    kinks = torch.cat([leaky_kinks(feat_t[i:i + step], pos_t[i:i + step], weights, 10)
                       for i in range(0, inst, step)])
    pos_t[:, 3][kinks] = 0.0
    n_w = sum(t.numel() for wb in weights for t in wb)
    fargs = (feat_t, pos_t, weights, k, 10)
    gout = fused_mlp_posenc_wsum(*fargs)
    want = fused_mlp_posenc_wsum_plain(*fargs)
    err, tol, share = _bf16_err(gout, want)
    check("fused_mlp_posenc_wsum (bf16)", err, tol, lambda: fused_mlp_posenc_wsum(*fargs),
          lambda: fused_mlp_posenc_wsum_plain(*fargs), flops=K6F_FLOP * inst * m,
          nbytes=feat_t.numel() * 2 + pos_t.numel() * 4 + n_w * 2 + want.numel() * 2,
          extra=f" bitwise share {share:.4f}", iters=5)
    del want
    torch.cuda.empty_cache()
    bargs = (feat_t, pos_t, weights, gout, k, 10)
    flat = lambda df, dws: [df] + [t for wb in dws for t in wb]
    got = flat(*fused_mlp_posenc_wsum_bwd(*bargs))
    dfs, dws = [], None
    for i in range(0, inst, step):
        sl = slice(i, i + step)
        part = flat(*fused_mlp_posenc_wsum_bwd_plain(feat_t[sl], pos_t[sl], weights, gout[sl],
                                                     k, 10))
        dfs.append(part[0])
        dws = [t.float() for t in part[1:]] if dws is None else [
            a + b.float() for a, b in zip(dws, part[1:])]
    plain = [torch.cat(dfs)] + dws
    err, tol = _worst([(a, b, 1e-2) for a, b in zip(got, plain)])
    again = flat(*fused_mlp_posenc_wsum_bwd(*bargs))
    if not all(torch.equal(a, b) for a, b in zip(again, got)):
        raise AssertionError("fused_mlp_posenc_wsum_bwd (bf16): two runs on the same inputs "
                             "differ")
    del again, got, plain, dfs, dws, part
    torch.cuda.empty_cache()
    check("fused_mlp_posenc_wsum_bwd (bf16)", err, tol,
          lambda: fused_mlp_posenc_wsum_bwd(*bargs),
          lambda: fused_mlp_posenc_wsum_bwd_plain(*bargs),
          extra=f" kinked pairs {int(kinks.sum())} of {kinks.numel()}; repeatable bitwise",
          flops=K6B_FLOP * inst * m,
          nbytes=2 * (2 * feat_t.numel() + gout.numel() + 2 * n_w) + 4 * pos_t.numel(), iters=3)
    del feat_t, pos_t, bargs, kinks
    torch.cuda.empty_cache()

    # K7f and K7b for both heads over the 400 x 1,792 packed points: x is
    # K6f's output, the cotangent standard normal in bf16; rows on a bf16
    # leaky_relu kink (leaky_kinks_bf16) get a zero cotangent. Tolerances as
    # K6's
    x = gout.reshape(inst * cap, 256)
    rows = x.shape[0]
    for head, dims in (("channel_net", (256, 256, 256, 256, 3)), ("shape_net", (256, 1))):
        weights = bf16(init_mlp(dims[:-1], 256, dims[-1], torch.Generator().manual_seed(1), dev))
        n_w = sum(t.numel() for wb in weights for t in wb)
        fwd_flop, bwd_flop = _k7_flop(dims)
        want = fused_mlp_plain(x, weights)
        err, tol, share = _bf16_err(fused_mlp(x, weights), want)
        name = "fused_mlp" if head == "channel_net" else f"fused_mlp ({head})"
        check(name, err, tol, lambda: fused_mlp(x, weights), lambda: fused_mlp_plain(x, weights),
              flops=fwd_flop * rows, nbytes=2 * (x.numel() + n_w + want.numel()),
              extra=f" {head}; bitwise share {share:.4f}")
        gy = torch.randn(rows, dims[-1], generator=g, device=dev).bfloat16()
        kinks = torch.cat([leaky_kinks_bf16(x[i:i + 65536], weights)
                           for i in range(0, rows, 65536)])
        gy[kinks] = 0
        got = flat(*fused_mlp_bwd(x, weights, gy))
        plain = flat(*fused_mlp_bwd_plain(x, weights, gy))
        err, tol = _worst([(a, b, 1e-2) for a, b in zip(got, plain)])
        again = flat(*fused_mlp_bwd(x, weights, gy))
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            raise AssertionError(f"fused_mlp_bwd ({head}): two runs on the same inputs differ")
        name = "fused_mlp_bwd" if head == "channel_net" else f"fused_mlp_bwd ({head})"
        check(name, err, tol, lambda: fused_mlp_bwd(x, weights, gy),
              lambda: fused_mlp_bwd_plain(x, weights, gy), flops=bwd_flop * rows,
              nbytes=2 * (2 * x.numel() + gy.numel() + 2 * n_w),
              extra=f" {head}; kinked rows {int(kinks.sum())} of {rows}; repeatable bitwise")
        del want, gy, got, plain, again, kinks
    del x, gout
    torch.cuda.empty_cache()
    return results


def _bf16_err(got, want) -> tuple:
    """A bf16 kernel's output against its plain version -> (max_abs_err, tol,
    bitwise share): every element within one bf16 ulp of itself plus one of
    the output's largest magnitude (a hidden rounding that flips on an f32
    sum in another order reaches outputs that cancel), 99% bitwise equal."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    share = float((d == 0).float().mean())
    over = float((d - 2 ** -7 * (want.abs() + float(want.abs().max()))).max())
    if share < 0.99 or over > 0:
        raise AssertionError(f"bf16 kernel output: bitwise share {share}, {over} past one ulp")
    return float(d.max()), 2 ** -7 * 2 * float(want.abs().max()), share


def _bf16_grads_err(got, want) -> tuple:
    """A bf16 backward's dq, dk and dv against the plain version's, each held
    by ``_bf16_err`` at its own scale -> (max_abs_err, tol) of the one
    furthest past its tolerance, and the three bitwise shares."""
    res = [_bf16_err(a, w) for a, w in zip(got, want)]
    err, tol = _furthest([r[:2] for r in res])
    return err, tol, [r[2] for r in res]


def phase_bf16_train_kernels() -> dict:
    """The bf16 stage-2 step's kernels, K2a-d and K1f/K1b in bf16, vs their
    bf16 plain versions at the step's shapes (batch 32 x 520 tokens, width
    1024, 16 heads of D 64, G 2) -> {name: result}."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    results = {}
    check = lambda *a, **k: _record(results, *a, tag="kernels-bf16", peak=BF16_FLOP_S, **k)
    b, s, h, w, valid = 32, 520, 16, 1024, 513
    bf = torch.bfloat16

    # K2a/K2b with the saved statistics, then K2c/K2d, over [32*520, 1024]
    # in bf16 (gamma, beta f32); each side's backward reads its own forward's
    # r, mean and rstd. r = bf16(x + delta) bitwise equal; y within one bf16
    # ulp of itself plus one of its scale, 99% bitwise; mean and rstd (f32)
    # within 1e-5 of max(1, their scale); dx (bf16, rounded once) within
    # 1e-2 and the f32 dgamma/dbeta (sums over 16,640 rows) within 1e-4 of
    # max(1, their scale)
    x, d, gy, gr = (randn(b * s, w).to(bf) for _ in range(4))
    gamma, beta = 1 + 0.1 * randn(w), 0.1 * randn(w)
    n_el, rows = x.numel(), x.shape[0]
    for name, delta in (("layer_norm", None), ("layer_norm_residual", d)):
        fwd = lambda: layer_norm_fwd(x, gamma, beta, delta=delta)
        fwd_plain = lambda: layer_norm_fwd_plain(x, gamma, beta, delta=delta)
        (r_k, y_k, mean_k, rstd_k), (r_p, y_p, mean_p, rstd_p) = fwd(), fwd_plain()
        if not torch.equal(r_k, r_p):
            raise AssertionError(f"{name} (bf16): r differs from bf16(x + delta)")
        y_err, y_tol, share = _bf16_err(y_k, y_p)
        err, tol = _furthest([(y_err, y_tol),
                              _worst([(mean_k, mean_p, 1e-5), (rstd_k, rstd_p, 1e-5)])])
        library_fn = None
        if delta is None:  # the library call: F.layer_norm in bf16
            g16, b16 = gamma.to(bf), beta.to(bf)
            library_fn = lambda: F.layer_norm(x, (w,), g16, b16, 1e-5)
        check(f"{name} (bf16)", err, tol, fwd, fwd_plain,
              extra=f" y bitwise share {share:.4f}, r bitwise equal",
              flops=(8 if delta is None else 9) * n_el,
              nbytes=2 * n_el * (2 if delta is None else 4) + 8 * rows + 8 * w,
              library_fn=library_fn, graph=True)
        if delta is None:
            bwd = lambda: layer_norm_bwd(x, gamma, mean_k, rstd_k, gy)
            bwd_plain = lambda: layer_norm_bwd_plain(x, gamma, mean_p, rstd_p, gy)
        else:
            bwd = lambda: layer_norm_residual_bwd(r_k, gamma, mean_k, rstd_k, gr, gy)
            bwd_plain = lambda: layer_norm_bwd_plain(r_p, gamma, mean_p, rstd_p, gy, gr)
        got, want = bwd(), bwd_plain()
        if got[0].dtype != bf or not torch.isfinite(got[0]).all():
            raise AssertionError(f"{name}_bwd (bf16): dx is {got[0].dtype} or not finite")
        err, tol = _worst([(got[0], want[0], 1e-2), (got[1], want[1], 1e-4),
                           (got[2], want[2], 1e-4)])
        library_fn = None
        if delta is None:  # the library call: autograd's backward of F.layer_norm in bf16
            xg, gg, bg = (t.clone().requires_grad_(True) for t in (x, gamma.to(bf), beta.to(bf)))
            y_lib = F.layer_norm(xg, (w,), gg, bg, 1e-5)
            library_fn = lambda: torch.autograd.grad(y_lib, (xg, gg, bg), gy, retain_graph=True)
        check(f"{name}_bwd (bf16)", err, tol, bwd, bwd_plain, flops=10 * n_el,
              nbytes=2 * n_el * (3 if delta is None else 4) + 8 * rows + 12 * w,
              library_fn=library_fn)
        library_fn = y_lib = None
    del x, d, gy, gr, r_k, y_k, mean_k, rstd_k, r_p, y_p, mean_p, rstd_p, got, want
    torch.cuda.empty_cache()

    # K1f with its base-2 lse, then K1b, in bf16: qkv [32*520, 3072], G 2, 513
    # valid keys, the cotangent zero on pad-query rows; each side's backward
    # reads its own forward's lse. out over every row within one bf16 ulp of
    # itself plus one of its scale, 99% bitwise; the lse (f32, ~10) within
    # 2**-8 / ln 2 (an e whose bf16 rounding flips moves l by an ulp of e);
    # dq, dk and dv (bf16) each as the output, at its own scale (dq and dk
    # ~1e-2 here, so that a dropped delta term, ~5e-4, moves most of their
    # elements off the plain version's), pad-key rows of dk/dv and pad-query
    # rows of dq exactly 0
    qkv = (0.5 * randn(b * s, 3 * w)).to(bf)
    dout = randn(b * s, w).to(bf)
    dout.reshape(b, s, w)[:, valid:] = 0
    fargs = (qkv, h, b, s, valid, 2)
    fwd = lambda: fused_qkv_attention_fwd(*fargs)
    fwd_plain = lambda: fused_qkv_attention_bf16_plain(*fargs, return_lse=True)
    (out_k, lse_k), (out_p, lse_p) = fwd(), fwd_plain()
    out_err, out_tol, share = _bf16_err(out_k, out_p)
    lse_err = _err(lse_k, lse_p)
    if out_k.dtype != bf or lse_err > 2 ** -8 / np.log(2):
        raise AssertionError(f"fused_qkv_attention (bf16): out {out_k.dtype}, lse err {lse_err}")
    q, k, v = _bhsd(qkv, b, s, h, 2)
    key_mask = (torch.arange(s, device=dev) < valid)[None, None, None, :]
    check("fused_qkv_attention (bf16)", out_err, out_tol, fwd, fwd_plain,
          extra=f" bitwise share {share:.4f}, lse max_abs_err {lse_err:.3e} (tol "
                f"{2 ** -8 / np.log(2):.1e})",
          flops=4 * b * h * s * valid * 64, nbytes=2 * (qkv.numel() + out_k.numel())
          + 4 * lse_k.numel(),
          library_fn=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask))
    del q, k, v
    bwd = lambda: fused_qkv_attention_bwd(qkv, None, lse_k, dout, h, b, s, valid, 2)
    bwd_plain = lambda: fused_qkv_attention_bwd_bf16_plain(qkv, lse_p, dout, h, b, s, valid, 2)
    got, want = bwd(), bwd_plain()
    dq, dk, dv = split_grouped_qkv(got.reshape(b, s, -1), h, 2)
    pad_nonzero = int((dq[:, valid:] != 0).sum() + (dk[:, valid:] != 0).sum()
                      + (dv[:, valid:] != 0).sum())
    if got.dtype != bf or pad_nonzero or not torch.isfinite(got).all():
        raise AssertionError(f"fused_qkv_attention_bwd (bf16): {got.dtype}, {pad_nonzero} "
                             "nonzero pad-row dq/dk/dv values or non-finite dqkv")
    err, tol, shares = _bf16_grads_err(
        (dq, dk, dv), split_grouped_qkv(want.reshape(b, s, -1), h, 2))
    q, k, v = _bhsd(qkv, b, s, h, 2, grad=True)
    o_lib = F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)
    do_lib = dout.reshape(b, s, h, -1).transpose(1, 2).contiguous()
    check("fused_qkv_attention_bwd (bf16)", err, tol, bwd, bwd_plain,
          extra=" dq/dk/dv bitwise shares " + " ".join(f"{x:.4f}" for x in shares)
          + ", pad-row dq/dk/dv all 0", flops=10 * b * h * s * valid * 64,
          nbytes=2 * (2 * qkv.numel() + dout.numel()) + 4 * lse_k.numel(),
          library_fn=lambda: torch.autograd.grad(o_lib, (q, k, v), do_lib, retain_graph=True))
    del qkv, dout, out_k, lse_k, out_p, lse_p, got, want, dq, dk, dv, q, k, v, o_lib, do_lib
    torch.cuda.empty_cache()
    return results


def phase_attention() -> tuple:
    """K8f/K8b, the flash attention over [B, S, H, D] = [32, 513, 16, 64] in
    f32 and bf16, and over [32, 513, 8, 128] (the same width of 1024) in
    bf16. First the path: ops.attention.multi_head_attention(impl="auto")
    forward and backward under autograd in each case, with the launch counts
    reset before and read after; then each kernel vs its plain version,
    timed, with scaled_dot_product_attention's time beside it -> (launches,
    {name: result}); the D-128 lines are printed and kept apart from the
    D-64 entries of the kernels line."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    cases = [(torch.float32, (32, 513, 16, 64), ""), (torch.bfloat16, (32, 513, 16, 64), " (bf16)"),
             (torch.bfloat16, (32, 513, 8, 128), " (bf16, D 128)")]
    inputs = [[torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4)]
              for dtype, shape, _ in cases]
    torch.cuda.synchronize()
    _reset_launches()
    for (dtype, _, _), (q, k, v, dout) in zip(cases, inputs):
        ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = multi_head_attention(*ts, impl="auto")
        out.backward(dout)
        if out.dtype != dtype or not all(torch.isfinite(t.grad).all() for t in ts):
            raise AssertionError(f"multi_head_attention({dtype}): {out.dtype} or non-finite grads")
    torch.cuda.synchronize()
    launches = _read_launches()
    del ts, out

    results = {}
    for (dtype, (b, s, h, d), suffix), (q, k, v, dout) in zip(cases, inputs):
        bf16 = dtype == torch.bfloat16
        size, n = (2 if bf16 else 4), b * s * h * d
        check = lambda *a, **kw: _record(results, *a, tag="kernels-attention",
                                         peak=BF16_FLOP_S if bf16 else FP32_FLOP_S, **kw)
        # f32: out within 1e-4 of max(1, its scale) and the base-e lse within
        # 1e-5 (online softmax vs torch's, sums over 513 keys); bf16: out
        # within one bf16 ulp of itself plus one of its scale, 99% bitwise,
        # the lse (f32 math on the upcast inputs) within 1e-5
        fwd = lambda: flash_attention_fwd(q, k, v)
        fwd_plain = lambda: flash_attention_plain(q, k, v, return_lse=True)
        (out_k, lse_k), (out_p, lse_p) = fwd(), fwd_plain()
        extra = ""
        if bf16:
            out_err, out_tol, share = _bf16_err(out_k, out_p)
            err, tol = _furthest([(out_err, out_tol), _worst([(lse_k, lse_p, 1e-5)])])
            extra = f" bitwise share {share:.4f}"
        else:
            err, tol = _worst([(out_k, out_p, 1e-4), (lse_k, lse_p, 1e-5)])
            exact = _flash_fwd_f64(q, k, v)
            errs = lambda xs: " ".join(f"{_err64(a, e):.2e}" for a, e in zip(xs, exact))
            extra = (f" vs float64 out/lse (tol 1e-5 of each scale): kernel "
                     f"{_f64_gate('flash_attention', (out_k, lse_k), exact)}, f32 plain "
                     f"{errs((out_p, lse_p))}")
            del exact
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        check(f"flash_attention{suffix}", err, tol, fwd, fwd_plain, extra=extra,
              flops=4 * b * h * s * s * d, nbytes=size * 4 * n + 4 * b * h * s, tf32=not bf16,
              library_fn=lambda: F.scaled_dot_product_attention(qs, ks, vs))
        # the backward from each side's own forward (the plain version
        # recomputes the softmax): f32 within 1e-4 of max(1, each gradient's
        # scale); bf16 dq, dk and dv each as the bf16 output, at its own scale
        bwd = lambda: flash_attention_bwd(q, k, v, lse_k, dout)
        bwd_plain = lambda: flash_attention_bwd_plain(q, k, v, dout)
        got, want = bwd(), bwd_plain()
        if any(t.dtype != dtype or not torch.isfinite(t).all() for t in got):
            raise AssertionError(f"flash_attention_bwd{suffix}: wrong dtype or non-finite")
        extra = ""
        if bf16:
            err, tol, shares = _bf16_grads_err(got, want)
            extra = " dq/dk/dv bitwise shares " + " ".join(f"{x:.4f}" for x in shares)
        else:
            err, tol = _worst([(a, w, 1e-4) for a, w in zip(got, want)])
            exact = _flash_bwd_f64(q, k, v, dout)
            errs = lambda xs: " ".join(f"{_err64(a, e):.2e}" for a, e in zip(xs, exact))
            extra = (f" vs float64 dq/dk/dv (tol 1e-5 of each scale): kernel "
                     f"{_f64_gate('flash_attention_bwd', got, exact)}, f32 plain {errs(want)}")
            del exact
        ql, kl, vl = (t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v))
        o_lib = F.scaled_dot_product_attention(ql, kl, vl)
        do_lib = dout.transpose(1, 2)
        check(f"flash_attention_bwd{suffix}", err, tol, bwd, bwd_plain, extra=extra,
              flops=10 * b * h * s * s * d, nbytes=size * 7 * n + 4 * b * h * s, tf32=not bf16,
              library_fn=lambda: torch.autograd.grad(o_lib, (ql, kl, vl), do_lib,
                                                     retain_graph=True))
        del out_k, lse_k, out_p, lse_p, got, want, ql, kl, vl, o_lib, do_lib
        torch.cuda.empty_cache()
    return launches, results


def _flash_fwd_f64(q, k, v, step: int = 8) -> list:
    """flash_attention_plain's arithmetic in float64, in slices of ``step``
    batch rows -> [out [B, S, H, D], base-e lse [B, H, S]] float64."""
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    parts = []
    for i in range(0, q.shape[0], step):
        q64, k64, v64 = (t[i:i + step].double() for t in (q, k, v))
        logits = torch.einsum("bthc,bshc->bhts", q64, k64) * scale
        parts.append((torch.einsum("bhts,bshc->bthc", torch.softmax(logits, dim=-1), v64),
                      torch.logsumexp(logits, dim=-1)))
        del logits
    return [torch.cat(x) for x in zip(*parts)]


def _flash_bwd_f64(q, k, v, dout, step: int = 8) -> list:
    """flash_attention_bwd_plain's arithmetic in float64 (the plain version
    itself computes in f32), in slices of ``step`` batch rows -> [dq, dk,
    dv] float64."""
    ein = torch.einsum
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    parts = []
    for i in range(0, q.shape[0], step):
        q64, k64, v64, g = (t[i:i + step].double() for t in (q, k, v, dout))
        p = torch.softmax(ein("bthc,bshc->bhts", q64, k64) * scale, dim=-1)
        dp = ein("bthc,bshc->bhts", g, v64)
        ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
        parts.append((ein("bhts,bshc->bthc", ds, k64), ein("bhts,bthc->bshc", ds, q64),
                      ein("bhts,bthc->bshc", p, g)))
        del p, dp, ds
    return [torch.cat(x) for x in zip(*parts)]


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


def phase_stage1(path: Path = SRNCARS, tag: str = "stage1") -> dict:
    """python -m npcd_tpu_torch.train_pointnerf's code path, full geometry, on
    the config at ``path``; with a shading budget, also each instance's valid
    sample count and the share the budget drops."""
    out = OUT / tag
    shutil.rmtree(out, ignore_errors=True)
    config = load_config(str(path))
    config["pointnerf_training"].update(max_epochs=1, print_interval=1, log_scalars_interval=1)
    m = config["model"]
    t0 = time.perf_counter()
    full = _stage1_dataset(config, m["n_obj"], 50)
    dataset = _FirstObjects(full, STAGE1_OBJECTS)
    print(f"[{tag}] seeded synthetic dataset: {m['n_obj']} clouds x {m['num_points']} points, "
          f"50 views at 128^2, batches from the first {STAGE1_OBJECTS} objects "
          f"({time.perf_counter() - t0:.1f} s)")
    args = train_pointnerf.parse_args(["--config", str(path), "--output", str(out),
                                       "--device", "cuda", "--no_tensorboard", "--seed", "0"])
    n_valid = []  # each step's valid sample count per instance, where a budget packs

    def budget_ranks(pts_mask):
        rank, count = ranks(pts_mask)
        n_valid.append(count)
        return rank, count

    ranks = pointnerf_module.budget_ranks
    pointnerf_module.budget_ranks = budget_ranks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    try:
        trainer = train_pointnerf.train(args, config, dataset)
        torch.cuda.synchronize()
    finally:
        pointnerf_module.budget_ranks = ranks
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
    cfg = model.cfg
    rays = trainer.batch_size * 50 * cfg.train_rays
    print(f"[{tag}] B {trainer.batch_size} x V 50 x {cfg.train_rays} rays x "
          f"{model.opts.renderer.depth_resolution} samples, validity {cfg.validity}, "
          f"{str(cfg.compute_dtype).split('.')[-1]}, shading budget {cfg.shading_budget}, "
          f"instance chunk {cfg.train_instance_chunk}, remat {cfg.resolved_train_remat()}: "
          f"{steps} steps in {wall:.1f} s (with the final checkpoint and export): "
          f"{steps_s:.4f} steps/s, {rays * steps_s:.0f} train rays/s over steps "
          f"{STAGE1_WARMUP + 1}-{steps}; peak {peak_gib:.2f} GiB")
    for k in keys:
        print(f"[{tag}] {k} " + " ".join(f"{h[k]:.6g}" for h in hist))
    if cfg.shading_budget is not None:
        if len(n_valid) != steps:
            raise AssertionError(f"the budget packed {len(n_valid)} times in {steps} steps")
        counts = torch.stack(n_valid).float()  # [steps, instances]
        dropped = (counts - cfg.shading_budget).clamp(min=0).sum() / counts.sum()
        past = (counts > cfg.shading_budget).float().mean()
        print(f"[{tag}] valid samples per instance (of {cfg.train_rays} x "
              f"{model.opts.aggregator.max_shading_pts} slots): mean {float(counts.mean()):.1f}, "
              f"max {int(counts.max())}; the budget of {cfg.shading_budget} drops "
              f"{float(dropped):.4f} of them; instances past it {float(past):.4f}")
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
    print(f"[{tag}] checkpoint restored into a fresh trainer at step {fresh.step}: "
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
    print(f"[{tag}] export {Path(export).name} loaded by train_diffusion's "
          f"load_pointnerf_weights: {len(latents)} objects, {len(pointnerf)} pointnerf arrays")
    del trainer, model, dataset, latents
    torch.cuda.empty_cache()
    return {"launches": launches, "steps_s": steps_s, "peak_gib": peak_gib}


def phase_stage1_cpu_step(path: Path = SRNCARS, tag: str = "gpu-vs-cpu-stage1") -> None:
    """One stage-1 step at full MLP widths on 1 object x 2 views (112 rays x
    128 samples) of the config at ``path``, from the same weights and draws:
    the card with its kernels vs the CPU with the plain versions. In bf16
    compute the ray order is injected too, so that a shading budget packs
    the same slots on both sides."""
    config = load_config(str(path))
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
    bf16 = src.cfg.compute_dtype == torch.bfloat16
    if bf16:
        draws["ray_scores"] = rng.uniform(size=(2, o.renderer.ray_subsamples)).astype(np.float32)
    out, lr = {}, config["pointnerf_training"]["base_learning_rate"]
    for dev in ("cuda", "cpu"):
        trainer = PointNeRFTraining(str(OUT / f"{tag}_{dev}"),
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
    # 2 lr + 1e-6 and all but 0.1% within 1e-6. In bf16 a bf16 rounding
    # flips where an f32 sum runs in another order (an ulp is 2**-8): the
    # loss within 1e-3, each leaf within 5e-2 of its scale; a gradient near
    # Adam's eps (the feats table's KL and TV terms, weighted 1e-7) moves its
    # parameter by lr times the gradients' relative difference, so all but
    # 5% of the parameters within 1e-6 (1.5% measured on an H100)
    tol_loss, tol_leaf, tol_frac = (1e-3, 5e-2, 5e-2) if bf16 else (1e-5, 1e-3, 1e-3)
    worst = max((_err(gpu["grads"][k], g) / max(float(g.abs().max()), 1e-30), k)
                for k, g in cpu["grads"].items())
    zero = [k for k, g in gpu["grads"].items() if float(g.abs().max()) == 0]
    diff = torch.cat([(gpu["params"][k] - v).abs().reshape(-1) for k, v in cpu["params"].items()])
    param_err, param_frac = float(diff.max()), float((diff > 1e-6).float().mean())
    print(f"[{tag}] full-width step on 1 object x 2 views: loss {gpu['loss']:.6f} vs "
          f"{cpu['loss']:.6f} (rel err {loss_err:.1e}, tol {tol_loss:.0e}); worst gradient leaf "
          f"{worst[1]} rel err {worst[0]:.2e} (tol {tol_leaf:.0e}) over {len(cpu['grads'])} "
          f"leaves; updated params max_abs_err {param_err:.2e} (tol {2 * lr + 1e-6:.1e}), "
          f"{param_frac:.1e} of them beyond 1e-6 (tol {tol_frac:.0e})")
    if param_frac > tol_frac:  # where the parameters moved apart
        for k, v in cpu["params"].items():
            n = int(((gpu["params"][k] - v).abs() > 1e-6).sum())
            if n:
                print(f"[{tag}]   {k}: {n} of {v.numel()} beyond 1e-6, gradient scale "
                      f"{float(cpu['grads'][k].abs().max()):.2e}")
    if (loss_err > tol_loss or worst[0] > tol_leaf or zero or param_err > 2 * lr + 1e-6
            or param_frac > tol_frac):
        raise AssertionError(f"GPU and CPU stage-1 steps disagree (zero-gradient leaves {zero})")


def _timed(name: str, fn, *args):
    """fn(*args), then the phase's seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> None:
    t0 = time.perf_counter()
    _timed("env", phase_env)
    _timed("build", phase_build)
    results = _timed("kernels", phase_kernels)
    results.update(_timed("kernels-train", phase_train_kernels))
    results.update(_timed("kernels-stage1", phase_stage1_kernels))
    results.update(_timed("kernels-fast", phase_fast_kernels))
    results.update(_timed("kernels-bf16", phase_bf16_train_kernels))
    attention_launches, attention_results = _timed("attention", phase_attention)
    results.update(attention_results)
    paths = {"generation": (_timed("main", phase_main), GENERATION),
             "training": (_timed("train", phase_train)["launches"], TRAINING),
             "bf16 training": (_timed("train-bf16", phase_train, None, "train-bf16")["launches"],
                               TRAINING_BF16),
             "stage 1": (_timed("stage1", phase_stage1)["launches"], STAGE1),
             "fast stage 1": (_timed("fast-stage1", phase_stage1, FAST, "fast-stage1")["launches"],
                              FAST_STAGE1),
             "attention": (attention_launches, ATTENTION)}
    _timed("gpu-vs-cpu", phase_cpu_step)
    _timed("gpu-vs-cpu-bf16", phase_cpu_step, torch.bfloat16, "gpu-vs-cpu-bf16")
    _timed("gpu-vs-cpu-stage1", phase_stage1_cpu_step)
    _timed("gpu-vs-cpu-fast-stage1", phase_stage1_cpu_step, FAST, "gpu-vs-cpu-fast-stage1")
    for path, (launches, _) in paths.items():
        print(f"[launches] {path} {json.dumps(launches)}")
    missing = [(path, n) for path, (launches, names) in paths.items()
               for n in names if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by their main path: {missing}")
    print(f"[time] all phases: {time.perf_counter() - t0:.1f} s")
    kernels = [{"name": name, "route": route, "source": source, "replaces": replaces,
                "launches": sum(launches[name] for launches, _ in paths.values()),
                **results[name]}
               for name, (_, _, route, source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

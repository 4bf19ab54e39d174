#!/usr/bin/env python3
"""Smoke run of the PyTorch port (npcd_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:
  1. environment: card name and power limit (nvidia-smi), torch, CUDA,
     Triton and nvcc; fails without a GPU;
  2. build: compiles the CUDA kernels of npcd_tpu_torch/csrc with nvcc,
     then counts the tensor-core instructions (HMMA, HGMMA) in each K1 and
     K8 kernel's SASS (cuobjdump): every bf16 kernel of the two and every
     f32 one, all in namespace tf (3xTF32: K1f's tf::fwd, K1b's tf::bwd_dq
     and tf::bwd_dkdv, K8f's tf::fwd, K8b's tf::bwd_dq and tf::bwd_dkdv),
     must have some; and in K6's
     (csrc/fused_mlp_posenc.cu) only the f32 forward and backward,
     tf::mlp_posenc_wsum and tf::mlp_posenc_wsum_bwd (3xTF32), and the bf16
     forward and backward, tc::mlp_posenc_wsum and tc::mlp_posenc_wsum_bwd
     (bf16 mma.sync), have some;
  3. kernels: each kernel of the generation path against its plain PyTorch
     version on the card, at the shapes the main path gives it (f32), with
     the stated tolerance, and both timed with CUDA events; the LayerNorm
     forwards also by replaying a CUDA graph of 20 launches (device time
     without the host's launch cost) against their HBM bound; the f32 K1f
     and K6f (3xTF32 on the tensor cores) also against their plain versions
     evaluated in float64 (within 1e-5 of each output's scale), beside the
     f32 plain version's own error against it; the kNN (K4) with an exact
     tie planted, indices and distances bitwise equal to the plain
     version's, also timed as a replayed CUDA graph. A kernel whose
     products run in 3xTF32 (the f32 K1f, K1b, K8f, K8b and K6f) has its
     bound at the 3xTF32 rate (495/3 TFLOP/s, the kernels line's bound_ms),
     its bound at the FP32 rate printed beside it;
  4. kernels, training: the attention forward with its log-sum-exp (also
     against float64, with its bounds and scaled_dot_product_attention's
     time) and its backward (pad rows of dq/dk/dv exactly 0), the LayerNorm
     forward with its mean/rstd and its backward in both forms, each
     backward fed its own side's forward outputs, and the AdamW + EMA pass
     (one [4096, 1024] leaf, then the whole 302M-parameter denoiser), each
     against its plain version at the stage-2 step's shapes, timed; the
     attention backward (3xTF32 on the tensor cores) also against a float64
     evaluation of its plain version (dq, dk and dv each within 1e-5 of its
     scale), beside the f32 plain version's own error against it; the
     LayerNorm backward (CUDA, csrc/layer_norm.cu, both forms) also against
     a float64 evaluation of its plain version (dx, and dgamma/dbeta, sums
     over 16,640 rows, each within 1e-5 of its scale), two launches bitwise
     equal, with the rows permuted its dx the permuted dx bitwise, and timed
     as a replayed CUDA graph too;
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
     min-distance kernel over all 400 instances x 14,336 queries, on uniform
     clouds and on hard_min_d2_inputs' (tests/min_d2_filter.py: exact ties,
     duplicated and two-position clouds, corner and bisector queries), and
     at the render's shape, 8 x 128^3 queries, validity bits and distances
     bitwise equal to the plain version's, also timed as a replayed CUDA
     graph; the kNN over
     400 x 5,600 shading points and over the TV loss's 8 x 512 points (an
     exact tie planted, indices and distances bitwise equal), and
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
     over 400 x 1,792 packed points for shape_net and channel_net (K7b's
     outputs each within 1e-2 of its own scale, dx at least 98% bitwise
     equal; both kernels two launches bitwise equal, and with the rows
     reversed K7f's output and K7b's dx bitwise equal, dW/db at least 99%),
     the bf16
     aggregation MLP forward and backward (K6f/K6b bf16) over the step's one
     launch of 400 x 14,336 pairs (the backward fed K6f's own output; each
     of its outputs within its own tolerance of its own scale of the plain
     version's, dfeat at least 98% bitwise equal, every output's bitwise
     share printed, two launches bitwise equal), and the kNN over the 400 x
     1,792 packed points (as in phase 8); rows and pairs on a leaky_relu
     kink in bf16, and
     rows where K7f and its plain version take another slope, are left out
     of the backward checks;
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
     points), timed (the LayerNorm forwards and backwards also as a
     replayed CUDA graph), with F.layer_norm's and
     scaled_dot_product_attention's bf16 times beside them; the LayerNorm
     backward (CUDA) also twice bitwise equal, and with the rows permuted
     its dx the permuted dx bitwise;
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
 18. launch counts, checked after phase 27: every kernel must have launched
     during phase 5, 6, 9, 12, 15, 16, 19, 20, 21, 22, 23, 24, 25, 26 or 27,
     each kernel of a path during that path ("generation", "training", "bf16
     training", "stage 1", "fast stage 1", "attention", "fid eval", "psnr
     eval", "srn fast stage 1", "reference weights", "options V", "options
     O", "D", phase 26's five DP paths, and phase 27's "tp stage 2" and
     "sharded fast stage 1"); the bf16
     launches of K1, K2, K6 and K8 are counted apart from the f32 ones, and
     so are the forms of phases 23-24: K4 at a k other than 8, K6 by posenc
     method and its no-reduction form, K7 at an input other than 256 wide
     (the no-reduction backward and the forms of K6 the two option sets do
     not take run on no path: their kernels-forms lines give launches 0);
 19. main path, FID eval: python -m npcd_tpu_torch.eval_diffusion's code path
     on configs/npcd_srncars.yaml with phase 5's seeded weights and the
     config's validity (knn): 2 samples in one group of 2, each rendered
     from the first 32 SRN test poses at 128x128 in one call, quantized on
     the card and fed as a CUDA tensor to a device-resident random
     projection (16 features) against real statistics the phase writes;
     prints sampler steps/s, render rays/s, extraction ms a group, peak
     memory and FID/KID; checks finite results and the files, a second call
     that skips with zero launches, the extractor's features fed a CUDA
     tensor or host numpy bitwise equal, the quantization bitwise numpy's,
     the renders bitwise generate_samples.render's of the same clouds; then
     the same clouds again with render_dtype bfloat16: its cross-PSNR
     against the f32 renders, and one object x one pose against the CPU's
     plain bf16 render (both >= 40 dB). Path "fid eval": K1f, K2a, K2b, K4,
     K5, K6f in f32, the bf16 K6f and K7f;
 20. main path, PSNR eval: python -m npcd_tpu_torch.eval_pointnerf's code
     path on phase 9's export (f32) and phase 12's (the fast config, bf16),
     over their seeded synthetic dataset with 4 views: 5 objects at
     eval_batch_size 1 (3 burn-in, 2 timed); prints the time of a forward,
     rays/s, peak memory and PSNR; renders one view of each again (its PSNR
     bitwise the eval's) and holds the f32 one against the CPU's plain
     render of that view (within 1e-3, and the PSNRs within what that
     allows). Path "psnr eval": K4, K5, K6f in f32, the bf16 K6f and K7f;
 21. main path, SRN fast stage 1: writes an SRN-format tree (56 objects x 50
     views at 128^2, PNGs whose rows take all five filter types, cam2world
     poses, intrinsics.txt, 30,000-point clouds without the FPS cache; cut:
     the object count, 2347 -> 56), then runs python -m
     npcd_tpu_torch.train_pointnerf's code path on
     configs/npcd_srncars_fast.yaml with SRNCarsTrain built through the
     dataset registry over it: the preload (the port's PNG reader, FPS on
     the CPU), 7 steps of B 8 x V 50 through the prefetched loop, a
     qualitative re-render at step 7; prints the preload's seconds (decode,
     FPS), steps/s over steps 3-7, peak memory, and the device busy share
     of 3 more steps under torch.profiler; checks every decoded image
     bitwise equal to the uint8 array it was written from (/255 in f32),
     the caches written, FPS on the card picking the CPU's points, the
     coords table equal to them, the re-render's PSNR finite and the
     checkpoint restored bitwise. Path "srn fast stage 1": K4, K5, the bf16
     K6f/K6b, K7f/K7b;
 22. main path, reference weights: writes an SRN-format tree under the
     first 6 ids of the cars train list (cut: the object count, 2347 -> 6)
     and a synthetic checkpoint in the reference's layout at the full width
     of configs/npcd_srncars.yaml (tests/reference_checkpoint.py: per-head
     [q|k|v] c_qkv, FlexEmbedding extra state, normalizer buffers; 310.8M
     denoiser parameters, ~1.3 GB), converts it with
     utils/convert_reference.py, saves and loads it as the bridged .npz;
     holds the converted denoiser's forward (K1f, K2a/b) on a batch of 2 x
     513 tokens against the reference's math on its own per-head weights
     (exact f32 on the card, within 1e-4 of the outputs' scale; the
     unpermuted columns must miss by 100 times that); writes a stand-in
     TorchScript Inception graph (2048 features) and its statistics pickle
     with python -m npcd_tpu_torch.compute_inception_stats over 4 of the
     tree's objects; then python -m npcd_tpu_torch.parity_eval's code path
     with --check-assets and with --stage both (validity voxel: 2 PSNR
     samples of 5 views; 2 generated clouds x 4 SRN test poses for the
     FID); prints the sizes and the seconds of the write, the conversion
     and the load, PSNR, FID and KID; deletes the checkpoint. Path
     "reference weights": K1f, K2a, K2b, K4, K6f in f32.
 23. main path, options V: configs/npcd_srncars_fast.yaml with
     model.use_view_dir and pointnerf_options {posenc_method: direct}, built
     in memory: phase 12's stage 1 over the first 24 objects (3 steps of B 8
     x V 50, budget 1792, bf16), then the trained model's render of 2 objects
     x 4 SRN test poses at 128^2, one object x one pose at 16^2 again in
     chunks of one ray (fewer than 8 shading points a block: the
     aggregation's no-reduction form) against the config's chunks, and at
     64^2 against the CPU's plain bf16 render (>= 40 dB). Path "options V":
     K4, K5, the bf16 K6f/K6b with the 'direct' posenc and the no-reduction
     K6f, K7f/K7b for the shape net and at d_in 307 (256 + 3 x 17 encoded
     view-direction columns) for the channel net. Its kernel forms, and phase
     24's, are checked with the kernel phases, after phase 11
     ("kernels-forms"): K4 at k 16 (O's aggregation over 400 x 5,600 points
     and its TV loss's 8 x 512), 6 and 32, bitwise; the f32 K6f/K6b with
     'recurrence' and 'direct' at k 16 over one 50-instance chunk of O's
     step against float64, and at k 6 (run as 8 with zero-weight pairs); the
     bf16 K6f/K6b with 'direct' over V's launch (400 x 14,336 pairs) and
     'recurrence'; the no-reduction form forward and backward (f32 and bf16)
     at O's one-ray chunks; K7f/K7b at d_in 307 over V's 400 x 1,792 points,
     as phase 11 holds K7;
 24. main path, options O: configs/npcd_srncars.yaml with model.use_view_dir
     and pointnerf_options {k: 16, posenc_method: recurrence, dir_freqs: 4,
     feat_freqs: 1, disparity_space_sampling: true}: phase 9's stage 1 over
     the first 16 objects (2 dense f32 steps, remat on), then phase 23's
     renders, the 128^2 one with kp_weights (their sum over the points each
     ray's mask within 1e-4), the CPU comparison within 1e-3. Path "options
     O": K4 at k 16 (the aggregation and the TV loss), K5, the f32 K6f/K6b
     with 'recurrence' at k 16 and the no-reduction K6f; the heads read 768
     (shape) and 795 (channel) columns, past npcd_tpu's K7 gate, so they
     run the plain f32 layers.
 25. main path, diffusion options (path "D"): configs/npcd_srncars.yaml in
     f32 with phase 5's seeded weights and the config's validity (knn).
     (a) python -m npcd_tpu_torch.generate_samples's main with
     --trajectory-stride 100 --swap 2 --render 2 --render-poses 4: the
     saved trajectory [11, 2, 3 | 32, 512] finite, its denormalized last
     frame bitwise the samples, the samples bitwise phase 5's (or a run
     without the trajectory when phase 5 did not run), swap_grid.png 256 x
     256 and its diagonal bitwise --render's first-pose images; (b)
     calc_bpd_loop on the two clouds, normalized (1000 denoiser forwards):
     every output finite, total_bpd = sum(vb) + prior_bpd within 1e-6
     relative, and with the oracle denoiser the KL terms (t > 0), mse and
     xstart_mse within 1e-4 of 0; (c) the two clouds x 4 SRN test poses at
     128^2 under matmul_precision "highest", then "tensorfloat32", twice:
     rays/s of each, the two renders apart (> 0: TF32 reached cuBLAS) by at
     most 1e-2 and by >= 40 dB, the TF32 flags restored; (d)
     DiffusionEvaluation on the two clouds (one a group, 4 poses at 128^2,
     the extractor on its worker thread) with the render at
     "tensorfloat32": every render ran with TF32 on, and the extractor,
     fed again and again for 0.3 s a group, saw the flags off at every
     feed. Prints the phase's seconds.
 26. data parallelism (npcd_tpu_torch/parallel), paths "dp stage 2", "dp
     fast stage 1", "dp sampling", "dp fid eval" and "dp psnr eval": (a) two
     ranks sharing the one card over gloo (parallel.launch, make_mesh
     backend "gloo"), held against one process on the same global batches
     and seeded draws: 3 stage-2 steps at full width (310.8M, the CLI's
     --dtype float16: bf16 compute, f32 master weights, block remat) at
     batch 32 (16 a rank) on seeded latent tables of 2347 x 512 x (3 + 32),
     and 3 fast stage-1 steps (configs/npcd_srncars_fast.yaml) at B 8 x V 50
     (4 a rank) over phase 12's 2347 seeded clouds; each step's losses
     within 1e-3 relative and grad_norm within 1e-2 (bf16 GEMMs at another
     row count may sum in another order), the parameters after the steps
     (the feats table's included) each within 2 lr a step (a near-zero
     gradient of the other sign flips Adam's first steps) and >= 99% of
     them within 0.1 lr, the two ranks' parameters bitwise equal; prints
     the world and backend, the bytes and milliseconds of each step's
     gradient all-reduce, steps/s against one process, peak device memory
     and host RSS after the steps per rank (world 2 on one card measures
     the code path, not scaling); (b) the five CLIs with --mesh in one worker a card over NCCL
     (world = the card count): train_pointnerf (fast, 2 steps of B 8 over
     the first 16 objects), eval_pointnerf on its export (5 objects x 4
     views), train_diffusion (5 bf16 steps at batch 32, full size; steps/s
     over the last 3, then the same without --mesh in the same worker:
     steps/s, and at world 1 the losses within 1e-5), generate_samples (the
     full-width 1000-step sampler, 2 samples, one rendered from 2 poses at 128^2; the
     samples within 1e-4 of phase 5's when it ran), eval_diffusion (2
     samples x 8 SRN test poses at 128^2, the denoiser at full width and 2
     blocks); finite outputs and the files; each worker returns its launch
     counts to the parent. The peak device memory of a run of steps is read
     after the steps, before the parameters are gathered for the checks.
 27. tensor parallelism and row-sharded tables (npcd_tpu_torch/parallel's
     tp.py, tp_step.py, pointnerf_sharding.py), paths "tp stage 2" and
     "sharded fast stage 1": (c) K1f/K1b as a model rank of tp 2 launches
     them, 8 heads in one layout group over qkv [32*520, 1536], in f32 (also
     against float64) and bf16, held against their plain versions as phases
     4 and 14 hold the 16-head form, timed beside it; then two gloo ranks
     sharing the card against phase 26's one-process runs on the same
     batches and draws: (a) 3 bf16 stage-2 steps at full width with tp 2
     (dp 1), held to phase 26's stage-2 limits, the ranks' replicated
     parameters bitwise equal, with the count, bytes and ms of the model
     group's reduces a step, peak memory a rank and steps/s; (b) 3 f32
     steps at full width and 2 blocks with tp 2 against one process (loss
     within 1e-5 relative, grad_norm 1e-4); (d) 3 fast stage-1 steps with
     the tables row-sharded (2347 objects: 1174 + 1173 rows), held to phase
     26's stage-1 limits, with the tables' and moments' bytes and the peak a
     rank beside phase 26's replicated-table ranks; (e) python -m
     npcd_tpu_torch.train_diffusion --tp 2 through main(argv) in the two
     ranks' group (bf16, full width, 2 blocks, 3 steps): a tp=1 trainer
     restores its checkpoint (step 3, the parameters bitwise its export's),
     and --tp 2 over NCCL on the one card raises "tp=2 does not divide
     device count 1". Prints the phase's seconds.
 28. the FID eval through a full-width InceptionV3 (path "fid eval
     inception"): python -m npcd_tpu_torch.eval_diffusion's code path on
     configs/npcd_srncars.yaml (phase 5's seeded weights, validity from the
     config) with a KerasInceptionExtractor (utils/inception_keras.py) of
     seeded random keras weights on the card at 299^2, 2048 features,
     batch 64, in place of phase 19's projection: 2 samples x 32 SRN test
     poses at 128^2 in one group, the real statistics from the same
     extractor on 64 seeded images; fid and kid, finite. Then the extractor
     alone: a batch of 64 images at 128^2 timed with CUDA events (the
     median of 20) in images/s beside its FP32 bound (the conv table's
     operations over 67 TFLOP/s), the protocol's 251,000 images
     extrapolated; its features on 4 images against the port's CPU
     features, within INCEPTION_GATE of their scale, and a TF32 control
     (cuDNN's TF32 on) that must fall outside the gate.
Every kernel's line gives its time, its plain version's, the least time
the card could take for the same work (bytes over 3.35 TB/s, or operations
over 67 TFLOP/s in FP32 and 989 TFLOP/s for the bf16 kernels (the dense
BF16 tensor-core peak), whichever is larger, at the measured shape; the f32
K1f, K1b, K8f, K8b, K6f and K6b also at 495 / 3 TFLOP/s, the TF32 peak over
their three products, K6b's recompute at the FP32 rate, where it runs; K4
and K5 in FP32 instructions at half the FP32 rate: FILTER_INSTR) and,
where one PyTorch call computes the same function, that call's time. Each
phase prints its seconds. The line before the last is {"kernels": [...]};
the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import hashlib
import json
import os
import pickle
import re
import shutil
import struct
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]  # the port; the tests' K5 inputs

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
import yaml  # noqa: E402

from npcd_tpu_torch import (  # noqa: E402
    compute_inception_stats, eval_diffusion, eval_pointnerf, parity_eval, train_diffusion,
    train_pointnerf)
from npcd_tpu_torch.data import BatchLoader, PointNeRFDataset, SyntheticNPCTrain  # noqa: E402
from npcd_tpu_torch.eval import DiffusionEvaluation  # noqa: E402
from npcd_tpu_torch import generate_samples  # noqa: E402
from npcd_tpu_torch.generate_samples import (  # noqa: E402
    exact_f32, parse_args, render, run, write_seeded_weights)
from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel  # noqa: E402
from npcd_tpu_torch.models.diffusion.normalizers import denormalize, normalize  # noqa: E402
from npcd_tpu_torch.models.npcd import NPCD  # noqa: E402
from npcd_tpu_torch.models.pointnerf import pointnerf as pointnerf_module  # noqa: E402
from npcd_tpu_torch.data import srn as srn_module  # noqa: E402
from npcd_tpu_torch.models.pointnerf import nn_core as pointnerf_nn  # noqa: E402
from npcd_tpu_torch.models.pointnerf.nn_core import init_mlp  # noqa: E402
from npcd_tpu_torch.ops.kernels import build  # noqa: E402
from npcd_tpu_torch.ops.kernels.fused_mlp import (  # noqa: E402
    fused_mlp, fused_mlp_bwd, fused_mlp_bwd_plain, fused_mlp_plain, leaky_kinks_bf16,
    slope_flips_bf16)
from npcd_tpu_torch.ops.kernels.fused_adamw import adamw_ema, adamw_ema_plain  # noqa: E402
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import (  # noqa: E402
    fused_mlp_posenc, fused_mlp_posenc_bwd, fused_mlp_posenc_bwd_plain, fused_mlp_posenc_plain,
    fused_mlp_posenc_wsum, fused_mlp_posenc_wsum_bwd, fused_mlp_posenc_wsum_bwd_plain,
    fused_mlp_posenc_wsum_plain, leaky_kinks, unit_pairs)
from npcd_tpu_torch.ops.attention import multi_head_attention  # noqa: E402
from npcd_tpu_torch.ops.fps import farthest_point_sampling  # noqa: E402
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
from npcd_tpu_torch.losses import PointNeRFLossWeights  # noqa: E402
from npcd_tpu_torch.parallel import Mesh, launch, make_mesh  # noqa: E402
from npcd_tpu_torch.parallel import mesh as mesh_module  # noqa: E402
from npcd_tpu_torch.utils.builders import (  # noqa: E402
    build_diffusion_model, build_pointnerf, build_pointnerf_options, torch_dtype)
from npcd_tpu_torch.utils.config import load_config  # noqa: E402
from npcd_tpu_torch.utils.convert_reference import convert_checkpoint, save_converted  # noqa: E402
from npcd_tpu_torch.utils.fidkid import FIDKID, ProjectionExtractor  # noqa: E402
from npcd_tpu_torch.utils.from_jax import load_npz, save_npz  # noqa: E402
from npcd_tpu_torch.utils.inception_keras import (  # noqa: E402
    KerasInceptionExtractor, conv_flops, inception_v3_features, random_weights, resize)
from npcd_tpu_torch.profile_generation import _report  # noqa: E402
from npcd_tpu_torch.utils import builders  # noqa: E402
from npcd_tpu_torch.utils.util import psnr  # noqa: E402
from min_d2_filter import hard_min_d2_inputs  # noqa: E402
from reference_checkpoint import reference_forward, reference_state  # noqa: E402
from srn_fixture import VIEWS, fixture_image, write_srn_tree  # noqa: E402
from tp_split_control import split_products  # noqa: E402

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
    "layer_norm_bwd": (layer_norm_bwd, "launches", "cuda",
                       "npcd_tpu_torch/csrc/layer_norm.cu",
                       "npcd_tpu/ops/pallas/layer_norm.py:114"),
    "layer_norm_residual_bwd": (layer_norm_residual_bwd, "launches", "cuda",
                                "npcd_tpu_torch/csrc/layer_norm.cu",
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
    "layer_norm_bwd (bf16)": (layer_norm_bwd, "launches_bf16", "cuda",
                              "npcd_tpu_torch/csrc/layer_norm.cu",
                              "npcd_tpu/ops/pallas/layer_norm.py:114"),
    "layer_norm_residual_bwd (bf16)": (layer_norm_residual_bwd, "launches_bf16", "cuda",
                                       "npcd_tpu_torch/csrc/layer_norm.cu",
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
# the forms that phases 23 and 24 add: K4 at a k other than 8, K6f/K6b with
# the 'direct' and 'recurrence' posenc (f32 and bf16) and the no-reduction
# form, K7f/K7b at an input other than 256 wide (each with its counter)
_K6 = ("npcd_tpu_torch/csrc/fused_mlp_posenc.cu", "npcd_tpu/ops/pallas/fused_mlp.py:382",
       "npcd_tpu/ops/pallas/fused_mlp.py:430")
KERNELS.update({
    "knn (k other than 8)": (knn, "launches_other_k", "cuda", "npcd_tpu_torch/csrc/knn.cu",
                             "npcd_tpu/ops/pallas/knn.py:78"),
    **{f"fused_mlp_posenc_wsum{bwd} ({form})": (
        fn, counter, "cuda", _K6[0], _K6[2 if bwd else 1])
       for bwd, fn in (("", fused_mlp_posenc_wsum), ("_bwd", fused_mlp_posenc_wsum_bwd))
       for form, counter in (("direct", "launches_direct"),
                             ("direct, bf16", "launches_direct_bf16"),
                             ("recurrence, k 16", "launches_recurrence"),
                             ("recurrence, bf16", "launches_recurrence_bf16"))},
    **{f"fused_mlp_posenc{bwd} (no reduction{tag})": (fn, counter, "cuda", _K6[0],
                                                       _K6[2 if bwd else 1])
       for bwd, fn in (("", fused_mlp_posenc), ("_bwd", fused_mlp_posenc_bwd))
       for tag, counter in (("", "launches_recurrence"), (", bf16", "launches_direct_bf16"))},
    "fused_mlp (d_in 307)": (fused_mlp, "launches_wide", "cuda",
                             "npcd_tpu_torch/csrc/fused_mlp.cu",
                             "npcd_tpu/ops/pallas/fused_mlp.py:120"),
    "fused_mlp_bwd (d_in 307)": (fused_mlp_bwd, "launches_wide", "cuda",
                                 "npcd_tpu_torch/csrc/fused_mlp.cu",
                                 "npcd_tpu/ops/pallas/fused_mlp.py:130"),
})
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
# the evals: the FID protocol's chain on the first 32 SRN test poses with a
# device-resident random projection to 16 features, and the PSNR eval over 5
# objects (3 burn-in, 2 timed) x 4 views of phase 9's and phase 12's exports
FID_EVAL = ("fused_qkv_attention", "layer_norm", "layer_norm_residual", "knn", "min_d2",
            "fused_mlp_posenc_wsum", "fused_mlp_posenc_wsum (bf16)", "fused_mlp")
PSNR_EVAL = ("knn", "min_d2", "fused_mlp_posenc_wsum", "fused_mlp_posenc_wsum (bf16)",
             "fused_mlp")
# phases 23 and 24: (config, pointnerf_options overrides beside
# model.use_view_dir, objects with images in the stage-1 run: steps of batch 8)
OPTION_PATHS = {"V": (FAST, {"posenc_method": "direct"}, 24),
                "O": (SRNCARS, {"k": 16, "posenc_method": "recurrence", "dir_freqs": 4,
                                "feat_freqs": 1, "disparity_space_sampling": True}, 16)}
OPTIONS_V = ("knn", "min_d2", "fused_mlp_posenc_wsum (direct, bf16)",
             "fused_mlp_posenc_wsum_bwd (direct, bf16)", "fused_mlp_posenc (no reduction, bf16)",
             "fused_mlp", "fused_mlp_bwd", "fused_mlp (d_in 307)", "fused_mlp_bwd (d_in 307)")
OPTIONS_O = ("knn (k other than 8)", "min_d2", "fused_mlp_posenc_wsum (recurrence, k 16)",
             "fused_mlp_posenc_wsum_bwd (recurrence, k 16)", "fused_mlp_posenc (no reduction)")
# phase 25: the generation options (trajectory, swap), the bound in bits per
# dim and the render's matmul precision, alone and beside the overlapped
# FID extractor
DIFFUSION_OPTIONS = ("fused_qkv_attention", "layer_norm", "layer_norm_residual", "knn",
                     "min_d2", "fused_mlp_posenc_wsum")
TRAJ_STRIDE, SWAP, PROBE_HOLD = 100, 2, 0.3
MAIN_SAMPLES: dict = {}  # phase 5's samples, for phase 25's bitwise check
FID_POSES, FID_FEATURES = 32, 16
PSNR_OBJECTS, PSNR_VIEWS = 5, 4
STAGE1_OBJECTS = 56  # objects with images in the stage-1 run: 7 steps of batch 8
STAGE1_WARMUP = 2
SRN_CLOUD, SRN_PROFILED = 30_000, 3  # points in an object's pointcloud3.npz; profiled steps
# the reference-weights phase: objects of its SRN tree (the checkpoint's
# tables), views a dataset sample, points a cloud, PSNR samples, FID poses,
# objects of the Inception statistics, and the stand-in graph's features
REF_OBJECTS, REF_VIEWS, REF_CLOUD, REF_PSNR_SAMPLES, REF_POSES = 6, 5, 4096, 2, 4
REF_STATS_OBJECTS, INCEPTION_FEATURES = 4, 2048
REFERENCE_WEIGHTS = ("fused_qkv_attention", "layer_norm", "layer_norm_residual", "knn",
                     "fused_mlp_posenc_wsum")
# phase 26: steps of the DP runs against one process and of the stage-2 CLI
# (steps/s over its last 3), objects of the CLI's fast stage-1 run (2 steps
# of batch 8), blocks of the FID eval's denoiser (full width, depth cut)
# and its poses; the DP evals' paths
DP_STEPS, DP_CLI_STEPS, DP_STAGE1_OBJECTS, DP_EVAL_LAYERS, DP_FID_POSES = 3, 5, 16, 2, 8
# _dp_steps's keys other than the step's metrics
REDUCE_KEYS = ("s", "reduce_bytes", "reduce_ms", "model_reduces", "model_bytes", "model_ms")
# phase 27: the f32 check's depth (full width) and the --tp 2 CLI's steps
# and depth
TP_F32_LAYERS, TP_CLI_STEPS, TP_CLI_LAYERS = 2, 3, 2
# phase 26 (a): each metric's limit, relative, of two ranks against one
# process: 100 times the largest reading of the H100 runs (PERF.md §6),
# but 10 times stage 1's grad_norm reading of 1.96e-3 (100 times would pass
# a gradient 20% off); the readings repeat to the last digit between runs
DP_TOLERANCE = {("stage2", "grad_norm"): 2.5e-4, ("stage2", "loss"): 2e-5,
                ("stage1", "grad_norm"): 2e-2, ("stage1", "loss"): 3e-4}
DP_FID = ("fused_qkv_attention", "layer_norm", "layer_norm_residual", "knn", "min_d2",
          "fused_mlp_posenc_wsum")
DP_PSNR = ("knn", "min_d2", "fused_mlp_posenc_wsum (bf16)", "fused_mlp")
# phase 28: the FID eval's InceptionV3 (the f32 render's kernels); its batch,
# timed runs, the protocol's images (1000 objects x 251 poses) and the gate
# of the card's features against the CPU's, relative to their scale: the
# convolutions in exact f32 sum in another order (~1e-6), TF32 rounds each
# product's operands to 10 mantissa bits (~1e-3)
FID_INCEPTION = ("fused_qkv_attention", "layer_norm", "layer_norm_residual", "knn", "min_d2",
                 "fused_mlp_posenc_wsum")
INCEPTION_BATCH, INCEPTION_RUNS, PROTOCOL_IMAGES, INCEPTION_GATE = 64, 20, 1000 * 251, 1e-4
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s, FP32
# operations/s outside the tensor cores, dense BF16 tensor-core
# operations/s (the bound of the bf16 kernels) and dense TF32 tensor-core
# operations/s (over 3, the rate of the split products of the f32 K1f, K1b,
# K8f, K8b, K6f and K6b)
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
# the bf16 K6b's: its last layer's dX per pair, not per point (npcd_tpu's
# bf16 backward rounds the per-pair cotangent w_r g_out[n] to bf16 before
# that product), 1,441,536 a pair
K6B_BF16_FLOP = K6B_FLOP - _K6_LAST + 2 * 256 * 256
# the bf16 K6f's: its last layer per pair, not per point (npcd_tpu's bf16
# forward rounds each pair's last-layer output z = bf16(bf16(acc) + b) before
# the w-sum, so folding that layer after the sum would drop a rounding point),
# 573,440 a pair
K6F_BF16_FLOP = _K6_HIDDEN + 2 * 256 * 256 + 2 * 256
# The least work of K4 and K5: a filter over every (query, point) pair, s =
# fma(-pz, 2 x2, fma(-py, 2 x1, fma(-px, 2 x0, |p|^2))) = |p - x|^2 - |x|^2
# up to rounding, three FP32-pipe instructions (csrc/knn.cu's min_d2_kernel
# sweeps every pair so), and the exact distance ((dx*dx + dy*dy) + dz*dz)
# the plain versions round, eight (3 sub, 3 mul, 2 add), for each result
# alone: K5's one a query, K4's k = 8. The exact distances a design takes
# beyond those (K5's whole groups, K4's candidates) are its own cost, not
# the work's. The min or compare on another pipe is not counted.
# FP32_FLOP_S counts an FMA as two operations, so they issue at half of it:
# 132 SMs x 128 lanes x 1.98 GHz = 33.45e12 instructions/s, their bound's rate
FILTER_INSTR, EXACT_INSTR = 3, 8
FP32_INSTR_S = FP32_FLOP_S / 2


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
    try:
        import PIL
        pil = PIL.__version__
    except ImportError:
        pil = "missing (the port reads PNGs itself)"
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} triton {triton_version} "
          f"nvcc {build.nvcc_path()} c++ {build.cxx_path()} PIL {pil} "
          f"device {torch.cuda.get_device_name(0)}")
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
    # the bf16 K1 and K8, every f32 kernel in namespace tf (3xTF32: the f32
    # K1f, K1b, K8f, K8b, K6f and K6b; K1 and K8 have no other f32 kernel)
    # and K6's in namespace tc (the bf16 K6f and K6b) run their products on
    # the tensor cores; every K6 kernel outside tf and tc (split_weights,
    # split_weights_t, reduce_partials_bf16 and _tf32) on the CUDA cores; so
    # K7f and K7b (tc::mlp_fwd, tc::mlp_bwd) but not their
    # tc::reduce_partials; K1 has 6 kernels (tf::fwd, tf::bwd_dq,
    # tf::bwd_dkdv and tc's three), K8 12 (3 per flavour at D 64 and 128),
    # K6 8, K7 3
    in_tf = lambda k: k[0].startswith("tf::")
    tensor_cores = lambda k: k[1] == "bf16" or in_tf(k)
    for name, n_kernels, rule in (("fused_qkv_attention", 6, tensor_cores),
                                  ("flash_attention", 12, tensor_cores),
                                  ("fused_mlp_posenc", 8,
                                   lambda k: k[0].startswith(("tf::", "tc::"))),
                                  ("fused_mlp", 3, lambda k: k[0] != "tc::reduce_partials")):
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
    """A 3xTF32 kernel's outputs, or an f32 kernel's long sums, against a
    float64 evaluation of its plain version: each within 1e-5 of max(1, its
    largest magnitude), the f32 tolerance of the card tests and of the CPU
    tests that transcribe the 3xTF32 arithmetic (a kernel without its lo
    products reads ~3e-5 to 9e-4 at these shapes) -> the errors as text;
    raises past it."""
    errs = [(_err64(a, e), 1e-5 * max(1.0, float(e.abs().max()))) for a, e in zip(got, exact)]
    text = " ".join(f"{err:.2e}" for err, _ in errs)
    if any(err > tol for err, tol in errs):
        raise AssertionError(f"{name} disagrees with float64: {text} against "
                             + " ".join(f"{tol:.1e}" for _, tol in errs))
    return text


def _ln_bwd_order(name: str, x, gamma, mean, rstd, gy, gr) -> str:
    """The LayerNorm backward kernel (K2c, or K2d with ``gr``) run twice on
    the same inputs, bitwise equal in every output, then on the rows in a
    random order (a generator of its own, so the phase's inputs stay as
    they were): dx must be the permuted dx bitwise (a row's dx depends on
    that row alone; dgamma/dbeta sum the rows in another order) -> text;
    raises otherwise."""
    run = ((lambda *t: layer_norm_bwd(t[0], gamma, *t[1:4])) if gr is None else
           (lambda *t: layer_norm_residual_bwd(t[0], gamma, t[1], t[2], t[4], t[3])))
    got = run(x, mean, rstd, gy, gr)
    if not all(torch.equal(a, b) for a, b in zip(got, run(x, mean, rstd, gy, gr))):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    perm = torch.randperm(x.shape[0], device=x.device,
                          generator=torch.Generator(device=x.device).manual_seed(17))
    moved = run(*(None if t is None else t[perm] for t in (x, mean, rstd, gy, gr)))[0]
    if not torch.equal(moved, got[0][perm]):
        raise AssertionError(f"{name}: {int((moved != got[0][perm]).sum())} elements of the "
                             f"permuted rows' dx differ from the permuted dx")
    return "; two launches bitwise equal, permuted rows' dx bitwise the permuted dx"


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
    # softmax vs torch's softmax: tol 1e-4; 3xTF32 on the tensor cores: out
    # (every row) and the base-2 lse also within 1e-5 of each one's scale of
    # float64
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
          library_fn=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask),
          extra=_k1f_vs_f64("fused_qkv_attention", args), tf32=True)
    del q, k, v

    # K4: 8 instances x (1024 rays x 5-slot block) queries, 512 points, k 8.
    # Both sides use the direct ((dx*dx + dy*dy) + dz*dz)
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
        got = bwd()
        err, tol = _worst([(a, want, 1e-5) for a, want in zip(got, bwd_plain())])
        # dx, dgamma and dbeta against float64 from the kernel forward's own
        # r, mean and rstd: dgamma/dbeta sum 16,640 rows, a sum the f32
        # plain version takes in another order
        src, res = (x, None) if delta is None else (r_k, gr)
        f64 = lambda t: None if t is None else t.double()
        exact = layer_norm_bwd_plain(*map(f64, (src, gamma, mean_k, rstd_k, gy, res)))
        plain = layer_norm_bwd_plain(src, gamma, mean_k, rstd_k, gy, res)
        extra = (f"; vs float64 dx/dgamma/dbeta (tol 1e-5 of each scale): kernel "
                 f"{_f64_gate(f'{name}_bwd', got, exact)}, f32 plain "
                 + " ".join(f"{_err64(a, e):.2e}" for a, e in zip(plain, exact)))
        del exact, plain, got
        extra += _ln_bwd_order(f"{name}_bwd", src, gamma, mean_k, rstd_k, gy, res)
        library_fn = None
        if delta is None:  # the library call: autograd's backward of F.layer_norm
            xg, gg, bg = (t.clone().requires_grad_(True) for t in (x, gamma, beta))
            y_lib = F.layer_norm(xg, (w,), gg, bg, 1e-5)
            library_fn = lambda: torch.autograd.grad(y_lib, (xg, gg, bg), gy, retain_graph=True)
        check(f"{name}_bwd", err, tol, bwd, bwd_plain, flops=10 * x.numel(),
              nbytes=4 * x.numel() * (3 if delta is None else 4), library_fn=library_fn,
              extra=extra, graph=True)
        library_fn = y_lib = None
    del x, d, gy, gr, r_k, y_k, mean_k, rstd_k, r_p, y_p, mean_p, rstd_p

    _k1_f32_checks(check, randn, b, s, h, w, valid, 2)

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


def _k1_f32_checks(check, randn, b: int, s: int, h: int, w: int, valid: int, groups: int,
                   suffix: str = "") -> None:
    """The f32 K1f (with its lse) and K1b against their plain versions and
    float64, over qkv [b*s, 3w] of h heads in ``groups`` layout groups;
    ``suffix`` ends the results' names."""
    dev = torch.device("cuda")
    # K1f with its base-2 lse, then K1b: qkv [b*s, 3w] (the step's [32*520,
    # 3072], G 2), 513 valid keys, the cotangent zero on pad-query rows as
    # the denoiser's; each side's backward reads its own forward's out and lse. Every row of out
    # is compared: pad-query rows attend to the valid keys like the others
    # and feed c_proj's weight gradient. f32 online softmax vs torch's, sums
    # over 513 keys: out and dqkv within 1e-4 of max(1, max|plain|), the lse
    # (~10) within 1e-5 of it
    qkv = 0.5 * randn(b * s, 3 * w)
    dout = randn(b * s, w)
    dout.reshape(b, s, w)[:, valid:] = 0
    fargs = (qkv, h, b, s, valid, groups)
    fwd = lambda: fused_qkv_attention_fwd(*fargs)
    fwd_plain = lambda: fused_qkv_attention_plain(*fargs, return_lse=True)
    (out_k, lse_k), (out_p, lse_p) = fwd(), fwd_plain()
    err, tol = _worst([(out_k, out_p, 1e-4), (lse_k, lse_p, 1e-5)])
    # the f32 stage-2 step's K1f row: 3xTF32, out and lse also against
    # float64; the library call is scaled_dot_product_attention in f32
    q, k, v = _bhsd(qkv, b, s, h, groups)
    key_mask = (torch.arange(s, device=dev) < valid)[None, None, None, :]
    check(f"fused_qkv_attention (with lse){suffix}", err, tol, fwd, fwd_plain,
          extra=_k1f_vs_f64(f"fused_qkv_attention (with lse){suffix}", fargs),
          flops=4 * b * h * s * valid * 64, nbytes=4 * (qkv.numel() + qkv.numel() // 3),
          library_fn=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask),
          tf32=True)
    del q, k, v
    bwd = lambda: fused_qkv_attention_bwd(qkv, out_k, lse_k, dout, h, b, s, valid, groups)
    bwd_plain = lambda: fused_qkv_attention_bwd_plain(qkv, out_p, lse_p, dout, h, b, s, valid,
                                                      groups)
    got, want = bwd(), bwd_plain()
    dq, dk, dv = split_grouped_qkv(got.reshape(b, s, -1), h, groups)
    pad_nonzero = int((dq[:, valid:] != 0).sum() + (dk[:, valid:] != 0).sum()
                      + (dv[:, valid:] != 0).sum())
    if pad_nonzero or not torch.isfinite(got).all():
        raise AssertionError(f"fused_qkv_attention_bwd{suffix}: {pad_nonzero} nonzero pad-row "
                             "dq/dk/dv values or non-finite dqkv")
    err, tol = _worst([(got, want, 1e-4)])
    exact = split_grouped_qkv(_fqa_bwd_f64(qkv, dout, h, b, s, valid, groups).reshape(b, s, -1),
                              h, groups)
    parts = lambda x: split_grouped_qkv(x.reshape(b, s, -1), h, groups)
    errs = lambda x: " ".join(f"{_err64(a, e):.2e}" for a, e in zip(parts(x), exact))
    flops = 10 * b * h * s * valid * 64
    extra = (f" pad-row dq/dk/dv all 0; vs float64 dq/dk/dv (tol 1e-5 of each scale): kernel "
             f"{_f64_gate(f'fused_qkv_attention_bwd{suffix}', parts(got), exact)}, f32 plain "
             f"{errs(want)}")
    del exact
    # the library call: autograd's backward of scaled_dot_product_attention
    q, k, v = _bhsd(qkv, b, s, h, groups, grad=True)
    key_mask = (torch.arange(s, device=dev) < valid)[None, None, None, :]
    o_lib = F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)
    do_lib = dout.reshape(b, s, h, -1).transpose(1, 2).contiguous()
    check(f"fused_qkv_attention_bwd{suffix}", err, tol, bwd, bwd_plain, extra=extra, flops=flops,
          nbytes=4 * (2 * qkv.numel() + 2 * dout.numel() + lse_k.numel()), tf32=True,
          library_fn=lambda: torch.autograd.grad(o_lib, (q, k, v), do_lib, retain_graph=True))
    del qkv, dout, out_k, lse_k, out_p, lse_p, got, want, dq, dk, dv, q, k, v, o_lib, do_lib


def _fqa_fwd_f64(qkv64, heads: int, b: int, s: int, valid: int, groups: int):
    """(out [B*S, W], base-2 lse [B, H, S]) float64 from a float64 qkv: the
    plain forward's arithmetic (base-2 scores, keys >= valid masked)."""
    q, k, v = split_grouped_qkv(qkv64.reshape(b, s, -1), heads, groups)
    s2 = torch.einsum("bthc,bshc->bhts", q * (LOG2_E / np.sqrt(q.shape[-1])), k)
    s2[..., valid:] = -torch.inf
    m = s2.amax(-1, keepdim=True)
    lse = m + torch.log2(torch.exp2(s2 - m).sum(-1, keepdim=True))
    out = torch.einsum("bhts,bshc->bthc", torch.exp2(s2 - lse), v).reshape(b * s, -1)
    return out, lse[..., 0]


def _k1f_vs_f64(name: str, args, step: int = 8) -> str:
    """The f32 K1f (3xTF32) on args = (qkv, heads, batch, seq, valid,
    groups): out (every row) and the base-2 lse against a float64 evaluation
    of its plain version (in slices of ``step`` sequences), each within 1e-5
    of its scale (_f64_gate), beside the f32 plain version's own errors ->
    the errors as text; raises past the gate."""
    qkv, heads, b, s, valid, groups = args
    got = fused_qkv_attention_fwd(*args)
    plain = fused_qkv_attention_plain(*args, return_lse=True)
    parts = [_fqa_fwd_f64(qkv[i * s:(i + step) * s].double(), heads, min(step, b - i), s,
                          valid, groups) for i in range(0, b, step)]
    exact = [torch.cat([part[j] for part in parts]) for j in (0, 1)]
    del parts
    text = (f"; vs float64 out/lse (tol 1e-5 of each scale): kernel {_f64_gate(name, got, exact)}"
            f", f32 plain " + " ".join(f"{_err64(a, e):.2e}" for a, e in zip(plain, exact)))
    del got, plain, exact
    return text


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
        out, lse = _fqa_fwd_f64(qkv64, heads, n, s, valid, groups)
        parts.append(fused_qkv_attention_bwd_plain(qkv64, out, lse,
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
    MAIN_SAMPLES.update(argv=(weights, args.seed, args.num, args.batch_size), coords=coords,
                        feats=feats, sample_s=out["sample_s"])
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
    # NPCD.from_config's PointNeRF (its first draws), without the denoiser
    pointnerf = build_pointnerf(config, torch.Generator().manual_seed(0))
    flat = {f"pointnerf.{k}": v.numpy() for k, v in pointnerf.state_dict().items()}
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


def _knn_check(check, name: str, xq, pts, k: int = 8) -> None:
    """K4 vs knn_plain (k 8 unless given) with point 1 made a copy of point
    0, an exact tie wherever both are among a query's k nearest (xq is pts:
    the TV loss's points against themselves, the copy in both): indices and
    distances bitwise equal (the same rounded ((dx*dx + dy*dy) + dz*dz),
    ties to the lower index). Timed, also as a replayed CUDA graph (device
    time without the host's launch cost), and printed before it raises."""
    same = xq is pts
    pts = pts.clone()
    pts[:, 1] = pts[:, 0]
    xq = pts if same else xq
    i_k, d_k = knn(xq, pts, k)
    i_p, d_p = knn_plain(xq, pts, k)
    inst, n = xq.shape[:2]
    mismatch = int((i_k != i_p).sum())
    tied = int(((i_p == 0).any(-1) & (i_p == 1).any(-1)).sum())
    check(name, _err(d_k, d_p), 0.0, lambda: knn(xq, pts, k), lambda: knn_plain(xq, pts, k),
          extra=f" idx_mismatch {mismatch} of {i_p.numel()} (queries with the planted tie "
                f"among their {k}: {tied}), d2 bitwise {torch.equal(d_k, d_p)}",
          flops=FILTER_INSTR * inst * n * pts.shape[1] + EXACT_INSTR * inst * n * k,
          peak=FP32_INSTR_S,
          nbytes=4 * (xq.numel() + pts.numel() + 2 * inst * n * k), graph=True)
    if mismatch or not torch.equal(d_k, d_p):
        raise AssertionError(f"{name}: {mismatch} indices differ from the plain version's")


def _min_d2_check(check, name: str, xq, pts, radius2: float) -> None:
    """K5 vs min_d2_plain: distances and validity bits bitwise equal. Timed,
    also as a replayed CUDA graph, against a bound of FILTER_INSTR a pair and
    EXACT_INSTR a query; printed before it raises."""
    d_k, d_p = min_d2(xq, pts), min_d2_plain(xq, pts)
    bits_differ = int(((d_k < radius2) != (d_p < radius2)).sum())
    inst, n, p = xq.shape[0], xq.shape[1], pts.shape[1]
    check(name, _err(d_k, d_p), 0.0, lambda: min_d2(xq, pts), lambda: min_d2_plain(xq, pts),
          extra=f" valid share {float((d_k < radius2).float().mean()):.3f}, validity bits "
                f"differing {bits_differ}, d2 differing {int((d_k != d_p).sum())}",
          flops=FILTER_INSTR * inst * n * p + EXACT_INSTR * inst * n, peak=FP32_INSTR_S,
          nbytes=4 * (xq.numel() + pts.numel() + d_k.numel()), graph=True)
    if bits_differ or not torch.equal(d_k, d_p):
        raise AssertionError(f"{name}: {bits_differ} validity bits differ, max distance error "
                             f"{_err(d_k, d_p)}")


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
    # [-0.5, 0.5]^3, radius 0.16 as the config's; then the same shape of
    # hard_min_d2_inputs (ties, duplicated and two-position clouds, corner
    # and bisector queries)
    radius2 = build_pointnerf_options(load_config(str(SRNCARS))).knn_radius ** 2
    inst, n_q = 400, 112 * 128
    pts = torch.rand(inst, 512, 3, generator=g, device=dev) - 0.5
    xq = 2 * torch.rand(inst, n_q, 3, generator=g, device=dev) - 1
    _min_d2_check(check, "min_d2", xq, pts, radius2)
    del xq
    _min_d2_check(check, "min_d2 (hard input)",
                  *hard_min_d2_inputs(inst, n_q, 512, seed=2, device=dev), radius2)
    # and the render's one launch where it tests validity by 'knn' (the
    # generation CLI's default; phase 5 renders with 'voxel'): 2 objects x 4
    # poses x 128^2 rays x 128 samples against the 512 points, uniform as above
    xq = 2 * torch.rand(8, 128 ** 3, 3, generator=g, device=dev) - 1
    _min_d2_check(check, "min_d2 (render, validity knn)", xq, pts[:8], radius2)
    del xq
    torch.cuda.empty_cache()

    # K4: the aggregation's launch, 400 instances x 112 selected rays x 50
    # slots = 5,600 shading points near the cloud, and the TV loss's, the 8
    # objects' 512 points against themselves
    xq = pts[:, torch.randint(0, 512, (112 * 50,), generator=g, device=dev)] \
        + 0.05 * torch.randn(inst, 112 * 50, 3, generator=g, device=dev)
    _knn_check(check, "knn (stage-1 aggregation)", xq, pts)
    tv = pts[:8].contiguous()
    _knn_check(check, "knn (stage-1 TV)", tv, tv)
    del pts, xq, tv
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
    # 99% bitwise; the backward by _bf16_bwd_gate against the plain version
    # over the whole launch (its dW summed over every pair in f32, then
    # rounded once)
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
    print(f"[kernels-fast] fused_mlp_posenc_wsum (bf16) output digest {_digest([gout])}")
    want = fused_mlp_posenc_wsum_plain(*fargs)
    # _bf16_err, the instances reversed and a repeat raise after the timing
    # below, so that an edited kernel's time reads too
    faults = []
    try:
        err, tol, share = _bf16_err(gout, want)
    except AssertionError as e:
        faults.append(str(e))
        err, tol = _err(gout, want), 2 ** -7 * 2 * float(want.abs().max())
        share = float((gout == want).float().mean())
    del want
    # each tile's output does not depend on the block that takes it: a
    # second launch, and the instances in reverse order, give it bitwise
    if not torch.equal(fused_mlp_posenc_wsum(*fargs), gout):
        faults.append("two runs on the same inputs differ")
    rev = torch.arange(inst - 1, -1, -1, device=dev)
    again = fused_mlp_posenc_wsum(feat_t[rev].contiguous(), pos_t[rev].contiguous(), weights,
                                  k, 10)[rev]
    if not torch.equal(again, gout):
        faults.append(f"the instances reversed give {float((again == gout).float().mean())} "
                      f"bitwise")
    del again
    torch.cuda.empty_cache()
    check("fused_mlp_posenc_wsum (bf16)", err, tol, lambda: fused_mlp_posenc_wsum(*fargs),
          lambda: fused_mlp_posenc_wsum_plain(*fargs), flops=K6F_BF16_FLOP * inst * m,
          nbytes=feat_t.numel() * 2 + pos_t.numel() * 4 + n_w * 2 + gout.numel() * 2,
          extra=f" bitwise share {share:.4f}"
                + ("" if faults else "; instances reversed and repeated bitwise"), iters=5)
    if faults:
        raise AssertionError("fused_mlp_posenc_wsum (bf16): " + "; ".join(faults))
    torch.cuda.empty_cache()
    bargs = (feat_t, pos_t, weights, gout, k, 10)
    flat = lambda df, dws: [df] + [t for wb in dws for t in wb]
    got = flat(*fused_mlp_posenc_wsum_bwd(*bargs))
    print(f"[kernels-fast] fused_mlp_posenc_wsum_bwd (bf16) output digest {_digest(got)}")
    err, tol, text, faults = _bf16_bwd_gate(got, flat(*fused_mlp_posenc_wsum_bwd_plain(*bargs)),
                                            "dfeat", K6B_BF16_REL, K6B_BF16_DFEAT_SHARE)
    again = flat(*fused_mlp_posenc_wsum_bwd(*bargs))
    if not all(torch.equal(a, b) for a, b in zip(again, got)):
        faults.append("two runs on the same inputs differ")
    # the instances in reverse order: each tile's contribution does not
    # depend on the block that takes it, so dfeat is equal and dW/db differ
    # by the f32 sums of the partials in another order only
    again = flat(*fused_mlp_posenc_wsum_bwd(feat_t[rev].contiguous(), pos_t[rev].contiguous(),
                                            weights, gout[rev].contiguous(), k, 10))
    again[0] = again[0][rev]
    order = min(float((a == b).float().mean()) for a, b in zip(again[1:], got[1:]))
    text += f"; instances reversed: dW/db bitwise {order:.4f}"
    if not torch.equal(again[0], got[0]) or order < K6B_BF16_ORDER_SHARE:
        faults.append(f"the instances reversed give dfeat equal "
                      f"{torch.equal(again[0], got[0])}, dW/db {order} bitwise, under "
                      f"{K6B_BF16_ORDER_SHARE}")
    del again, got
    torch.cuda.empty_cache()
    # timed and printed first, so that an edited kernel's time reads too
    check("fused_mlp_posenc_wsum_bwd (bf16)", err, tol,
          lambda: fused_mlp_posenc_wsum_bwd(*bargs),
          lambda: fused_mlp_posenc_wsum_bwd_plain(*bargs),
          extra=f" kinked pairs {int(kinks.sum())} of {kinks.numel()}; {text}"
                + ("" if faults else "; repeatable bitwise"),
          flops=K6B_BF16_FLOP * inst * m,
          nbytes=2 * (2 * feat_t.numel() + gout.numel() + 2 * n_w) + 4 * pos_t.numel(), iters=3)
    if faults:
        raise AssertionError("fused_mlp_posenc_wsum_bwd (bf16): " + "; ".join(faults))
    del feat_t, pos_t, bargs, kinks
    torch.cuda.empty_cache()

    # K7f and K7b for both heads over the 400 x 1,792 packed points: x is
    # K6f's output, the cotangent standard normal in bf16; rows on a bf16
    # leaky_relu kink (leaky_kinks_bf16) or where the kernel's and the plain
    # version's forwards take another slope (slope_flips_bf16) get a zero
    # cotangent. K7f by
    # _bf16_err, K7b by _bf16_bwd_gate. A row's results do not depend on the
    # tile or block that takes it, so a second launch is bitwise equal, and
    # so are K7f's output and K7b's dx with the rows in reverse order, once
    # put back; K7b's dW/db are then f32 sums in another order, at least
    # K6B_BF16_ORDER_SHARE bitwise. Each kernel is timed and printed before
    # these raise, so that an edited kernel's time reads too
    x = gout.reshape(inst * cap, 256)
    rows = x.shape[0]
    rev = torch.arange(rows - 1, -1, -1, device=dev)
    xr = x[rev].contiguous()
    for head, dims in (("channel_net", (256, 256, 256, 256, 3)), ("shape_net", (256, 1))):
        weights = bf16(init_mlp(dims[:-1], 256, dims[-1], torch.Generator().manual_seed(1), dev))
        n_w = sum(t.numel() for wb in weights for t in wb)
        fwd_flop, bwd_flop = _k7_flop(dims)
        want, got = fused_mlp_plain(x, weights), fused_mlp(x, weights)
        faults = []
        try:
            err, tol, share = _bf16_err(got, want)
        except AssertionError as e:
            faults.append(str(e))
            err, tol = _err(got, want), 2 ** -7 * 2 * float(want.abs().max())
            share = float((got == want).float().mean())
        if not torch.equal(fused_mlp(x, weights), got):
            faults.append("two runs on the same inputs differ")
        if not torch.equal(fused_mlp(xr, weights)[rev], got):
            faults.append("the rows reversed differ")
        name = "fused_mlp" if head == "channel_net" else f"fused_mlp ({head})"
        check(name, err, tol, lambda: fused_mlp(x, weights), lambda: fused_mlp_plain(x, weights),
              flops=fwd_flop * rows, nbytes=2 * (x.numel() + n_w + want.numel()),
              extra=f" {head}; bitwise share {share:.4f}"
                    + ("" if faults else "; rows reversed and repeated bitwise"))
        if faults:
            raise AssertionError(f"{name}: " + "; ".join(faults))
        del want, got
        gy = torch.randn(rows, dims[-1], generator=g, device=dev).bfloat16()
        kinks = torch.cat([leaky_kinks_bf16(x[i:i + 65536], weights)
                           for i in range(0, rows, 65536)])
        flips = slope_flips_bf16(x, weights)
        gy[kinks | flips] = 0
        got = flat(*fused_mlp_bwd(x, weights, gy))
        err, tol, text, faults = _bf16_bwd_gate(got, flat(*fused_mlp_bwd_plain(x, weights, gy)),
                                                "dx", K7B_BF16_REL, K7B_BF16_DX_SHARE)
        again = flat(*fused_mlp_bwd(x, weights, gy))
        if not all(torch.equal(a, b) for a, b in zip(again, got)):
            faults.append("two runs on the same inputs differ")
        again = flat(*fused_mlp_bwd(xr, weights, gy[rev].contiguous()))
        again[0] = again[0][rev]
        order = min(float((a == b).float().mean()) for a, b in zip(again[1:], got[1:]))
        text += f"; rows reversed: dW/db bitwise {order:.4f}"
        if not torch.equal(again[0], got[0]) or order < K6B_BF16_ORDER_SHARE:
            faults.append(f"the rows reversed give dx equal {torch.equal(again[0], got[0])}, "
                          f"dW/db {order} bitwise, under {K6B_BF16_ORDER_SHARE}")
        del again, got
        name = "fused_mlp_bwd" if head == "channel_net" else f"fused_mlp_bwd ({head})"
        check(name, err, tol, lambda: fused_mlp_bwd(x, weights, gy),
              lambda: fused_mlp_bwd_plain(x, weights, gy), flops=bwd_flop * rows,
              nbytes=2 * (2 * x.numel() + gy.numel() + 2 * n_w),
              extra=f" {head}; kinked rows {int(kinks.sum())}, slope flips {int(flips.sum())} "
                    f"({int((flips & ~kinks).sum())} not kinked) of {rows}; {text}"
                    + ("" if faults else "; repeatable bitwise"))
        if faults:
            raise AssertionError(f"{name}: " + "; ".join(faults))
        del gy, kinks, flips
        torch.cuda.empty_cache()
    del xr
    del x, gout
    torch.cuda.empty_cache()
    return results


# The bf16 K6b's gate (phase 11): each output's largest difference from the
# plain version within this share of the output's own largest magnitude
# (dfeat, then dW and db of each layer), and at least this share of dfeat's
# elements bitwise equal. What differs is bf16 roundings that flip on f32
# sums in another order and carry through the layers below. On an H100
# (PERF.md section 6) the CUDA-core kernel this one replaced, whose dX sums
# ran in the plain version's order, read dfeat exact and dW/db within 2.3e-3
# of their scale; the tensor-core one dfeat 6.0e-2 and 98.7% bitwise (9.6e-2
# and 98.6% with a normal cotangent), dW/db within 2.3e-3 (4.9e-3).
K6B_BF16_REL = (0.2,) + (2 ** -7,) * 10
K6B_BF16_DFEAT_SHARE = 0.98
# and on the instances in reverse order, each of dW and db at least this
# share bitwise equal to its own (both kernels 0.9999; a partial rounded to
# bf16 at each update 0.74)
K6B_BF16_ORDER_SHARE = 0.99


def _bf16_bwd_gate(got, want, first: str, rel, share: float) -> tuple:
    """A bf16 backward's outputs (first, then dW_0, db_0, ...) against its
    plain version's: each output's largest difference within rel[i] of the
    output's own largest magnitude, and at least ``share`` of the first
    output's elements bitwise equal -> (max_abs_err, tol) of the output
    furthest past its own tolerance, a text of each output's difference over
    its scale and bitwise share, and a list of what fails beside the
    tolerance (the first output's bitwise share)."""
    names = [first] + [f"{x}{i}" for i in range(len(got) // 2) for x in ("dW", "db")]
    rows = []
    for name, a, b, r in zip(names, got, want, rel):
        a, b = a.float(), b.float()
        scale = float(b.abs().max())
        rows.append((name, float((a - b).abs().max()), scale, r,
                     float((a == b).float().mean())))
    text = "err/scale, bitwise: " + ", ".join(
        f"{n} {e / max(s, 1e-30):.2e} {sh:.4f}" for n, e, s, _, sh in rows)
    faults = [] if rows[0][4] >= share else [f"{first} {rows[0][4]} bitwise, under {share}"]
    err, tol = _furthest([(e, r * s) for _, e, s, r, _ in rows])
    return err, tol, text, faults


# K7b's gate (phase 11): each output's largest difference from the plain
# version within 1e-2 of its own scale (the CUDA-core kernel's 1e-2 x max(1,
# scale), or tighter), and at least K7B_BF16_DX_SHARE of dx bitwise equal,
# the rows where the two take another leaky_relu slope given a zero
# cotangent. What differs is bf16 roundings that flip on f32 sums in another
# order and carry down the layers: on an H100 (PERF.md section 6) the
# tensor-core kernel read every output within 4.8e-3 of its scale and dx
# 99.0% bitwise; with only the kinked rows zeroed, the 294 rows whose slope
# flipped moved dx by 0.10 and db3 by 1.3e-2 of their scales.
K7B_BF16_REL = (1e-2,) * 17  # dx, then dW and db of up to 8 layers
K7B_BF16_DX_SHARE = 0.98


def _digest(tensors) -> str:
    """A short sha256 of the tensors' bits, to show two builds agree."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


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
        src, res = (x, None) if delta is None else (r_k, gr)
        extra = _ln_bwd_order(f"{name}_bwd (bf16)", src, gamma, mean_k, rstd_k, gy, res)
        library_fn = None
        if delta is None:  # the library call: autograd's backward of F.layer_norm in bf16
            xg, gg, bg = (t.clone().requires_grad_(True) for t in (x, gamma.to(bf), beta.to(bf)))
            y_lib = F.layer_norm(xg, (w,), gg, bg, 1e-5)
            library_fn = lambda: torch.autograd.grad(y_lib, (xg, gg, bg), gy, retain_graph=True)
        check(f"{name}_bwd (bf16)", err, tol, bwd, bwd_plain, flops=10 * n_el,
              nbytes=2 * n_el * (3 if delta is None else 4) + 8 * rows + 12 * w,
              library_fn=library_fn, extra=extra, graph=True)
        library_fn = y_lib = None
    del x, d, gy, gr, r_k, y_k, mean_k, rstd_k, r_p, y_p, mean_p, rstd_p, got, want
    torch.cuda.empty_cache()

    _k1_bf16_checks(check, randn, b, s, h, w, valid, 2)
    torch.cuda.empty_cache()
    return results


def _k1_bf16_checks(check, randn, b: int, s: int, h: int, w: int, valid: int, groups: int,
                    suffix: str = "") -> None:
    """The bf16 K1f (with its lse) and K1b against their bf16 plain versions
    over qkv [b*s, 3w] of h heads in ``groups`` layout groups; ``suffix``
    ends the results' names."""
    dev = torch.device("cuda")
    bf = torch.bfloat16
    # K1f with its base-2 lse, then K1b, in bf16: qkv [b*s, 3w] (the step's
    # [32*520, 3072], G 2), 513 valid keys, the cotangent zero on pad-query
    # rows; each side's backward reads its own forward's lse. out over every
    # row within one bf16 ulp of itself plus one of its scale, 99% bitwise;
    # the lse (f32, ~10) within
    # 2**-8 / ln 2 (an e whose bf16 rounding flips moves l by an ulp of e);
    # dq, dk and dv (bf16) each as the output, at its own scale (dq and dk
    # ~1e-2 here, so that a dropped delta term, ~5e-4, moves most of their
    # elements off the plain version's), pad-key rows of dk/dv and pad-query
    # rows of dq exactly 0
    qkv = (0.5 * randn(b * s, 3 * w)).to(bf)
    dout = randn(b * s, w).to(bf)
    dout.reshape(b, s, w)[:, valid:] = 0
    fargs = (qkv, h, b, s, valid, groups)
    fwd = lambda: fused_qkv_attention_fwd(*fargs)
    fwd_plain = lambda: fused_qkv_attention_bf16_plain(*fargs, return_lse=True)
    (out_k, lse_k), (out_p, lse_p) = fwd(), fwd_plain()
    out_err, out_tol, share = _bf16_err(out_k, out_p)
    lse_err = _err(lse_k, lse_p)
    if out_k.dtype != bf or lse_err > 2 ** -8 / np.log(2):
        raise AssertionError(f"fused_qkv_attention (bf16){suffix}: out {out_k.dtype}, lse err "
                             f"{lse_err}")
    q, k, v = _bhsd(qkv, b, s, h, groups)
    key_mask = (torch.arange(s, device=dev) < valid)[None, None, None, :]
    check(f"fused_qkv_attention (bf16){suffix}", out_err, out_tol, fwd, fwd_plain,
          extra=f" bitwise share {share:.4f}, lse max_abs_err {lse_err:.3e} (tol "
                f"{2 ** -8 / np.log(2):.1e})",
          flops=4 * b * h * s * valid * 64, nbytes=2 * (qkv.numel() + out_k.numel())
          + 4 * lse_k.numel(),
          library_fn=lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask))
    del q, k, v
    bwd = lambda: fused_qkv_attention_bwd(qkv, None, lse_k, dout, h, b, s, valid, groups)
    bwd_plain = lambda: fused_qkv_attention_bwd_bf16_plain(qkv, lse_p, dout, h, b, s, valid, groups)
    got, want = bwd(), bwd_plain()
    dq, dk, dv = split_grouped_qkv(got.reshape(b, s, -1), h, groups)
    pad_nonzero = int((dq[:, valid:] != 0).sum() + (dk[:, valid:] != 0).sum()
                      + (dv[:, valid:] != 0).sum())
    if got.dtype != bf or pad_nonzero or not torch.isfinite(got).all():
        raise AssertionError(f"fused_qkv_attention_bwd (bf16){suffix}: {got.dtype}, {pad_nonzero} "
                             "nonzero pad-row dq/dk/dv values or non-finite dqkv")
    err, tol, shares = _bf16_grads_err(
        (dq, dk, dv), split_grouped_qkv(want.reshape(b, s, -1), h, groups))
    q, k, v = _bhsd(qkv, b, s, h, groups, grad=True)
    o_lib = F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)
    do_lib = dout.reshape(b, s, h, -1).transpose(1, 2).contiguous()
    check(f"fused_qkv_attention_bwd (bf16){suffix}", err, tol, bwd, bwd_plain,
          extra=" dq/dk/dv bitwise shares " + " ".join(f"{x:.4f}" for x in shares)
          + ", pad-row dq/dk/dv all 0", flops=10 * b * h * s * valid * 64,
          nbytes=2 * (2 * qkv.numel() + dout.numel()) + 4 * lse_k.numel(),
          library_fn=lambda: torch.autograd.grad(o_lib, (q, k, v), do_lib, retain_graph=True))
    del qkv, dout, out_k, lse_k, out_p, lse_p, got, want, dq, dk, dv, q, k, v, o_lib, do_lib


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

    def batch(self, indices, pixel_idx=None):
        return self.ds.batch(indices, pixel_idx)

    def get_all_coords(self):
        return self.ds.get_all_coords()


def _stage1_dataset(config, n_obj: int, num_views: int):
    m = config["model"]
    return SyntheticNPCTrain(n_obj=n_obj, num_views=num_views,
                             image_size=build_pointnerf_options(config).default_resolution,
                             num_points=m["num_points"], seed=0)


def phase_stage1(path: Path = SRNCARS, tag: str = "stage1", config=None,
                 objects: int = STAGE1_OBJECTS) -> dict:
    """python -m npcd_tpu_torch.train_pointnerf's code path, full geometry, on
    the config at ``path`` (or ``config``, that file's with overrides), over
    the first ``objects`` objects; with a shading budget, also each
    instance's valid sample count and the share the budget drops -> the
    launches, steps/s, peak memory and the trainer."""
    out = OUT / tag
    shutil.rmtree(out, ignore_errors=True)
    config = config or load_config(str(path))
    config["pointnerf_training"].update(max_epochs=1, print_interval=1, log_scalars_interval=1)
    m = config["model"]
    t0 = time.perf_counter()
    full = _stage1_dataset(config, m["n_obj"], 50)
    dataset = _FirstObjects(full, objects)
    print(f"[{tag}] seeded synthetic dataset: {m['n_obj']} clouds x {m['num_points']} points, "
          f"50 views at 128^2, batches from the first {objects} objects "
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

    steps = objects // trainer.batch_size
    warmup = min(STAGE1_WARMUP, steps - 1)
    hist = trainer.history
    if [h["it"] for h in hist] != list(range(1, steps + 1)):
        raise AssertionError(f"expected {steps} logged steps, got {len(hist)}")
    keys = ("loss", "00_image_reconstruction_loss", "01_neural_point_cloud_kl",
            "02_neural_point_cloud_tv")
    for h in hist:
        if not all(np.isfinite(h[k]) for k in keys):
            raise AssertionError(f"non-finite loss at step {h['it']}: {h}")
    steps_s = (steps - warmup) / (hist[-1]["time"] - hist[warmup - 1]["time"])
    model = trainer.model
    cfg = model.cfg
    rays = trainer.batch_size * 50 * cfg.train_rays
    print(f"[{tag}] B {trainer.batch_size} x V 50 x {cfg.train_rays} rays x "
          f"{model.opts.renderer.depth_resolution} samples, validity {cfg.validity}, "
          f"{str(cfg.compute_dtype).split('.')[-1]}, shading budget {cfg.shading_budget}, "
          f"instance chunk {cfg.train_instance_chunk}, remat {cfg.resolved_train_remat()}: "
          f"{steps} steps in {wall:.1f} s (with the final checkpoint and export): "
          f"{steps_s:.4f} steps/s, {rays * steps_s:.0f} train rays/s over steps "
          f"{warmup + 1}-{steps}; peak {peak_gib:.2f} GiB")
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
    del model, dataset, latents
    torch.cuda.empty_cache()
    return {"launches": launches, "steps_s": steps_s, "peak_gib": peak_gib, "trainer": trainer}


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


def _psnr_db(a, b) -> float:
    """Cross-PSNR of two renders in [0, 1]."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float("inf") if mse == 0 else float(10 * np.log10(1.0 / mse))


def phase_fid_eval() -> dict:
    """python -m npcd_tpu_torch.eval_diffusion's code path on
    configs/npcd_srncars.yaml (phase 5's seeded weights, validity from the
    config): 2 samples in one group, each rendered from the first 32 SRN test
    poses at 128^2 in one call, quantized, fed to a device-resident random
    projection against real statistics the phase writes; then one group
    again with render_dtype bfloat16 on the same clouds."""
    out = OUT / "fid-eval"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    weights = OUT / "seeded_npcd.npz"
    if not weights.exists():  # phase 5 writes it
        write_seeded_weights(str(SRNCARS), str(weights), seed=0)
    res = 128
    proj = np.random.default_rng(0).normal(size=(res * res * 3, FID_FEATURES)).astype(np.float32)
    real = np.random.default_rng(1).uniform(0, 1, (64, res * res * 3)).astype(np.float32) @ proj
    pkl = out / "real_stats.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"mean": real.mean(0), "cov": np.cov(real, rowvar=False), "feats_np": real}, f)
    config = load_config(str(SRNCARS))
    config["diffusion_evaluation"].update(
        num_samples=2, generate_batch_size=2, max_poses=FID_POSES, resolution=res,
        feature_extractor=f"random_projection:{FID_FEATURES}", inception_pkl_path=str(pkl),
        poses_path=str(ROOT / "data/srncars_test_poses.npy"),
        intrinsics_path=str(ROOT / "data/srncars_test_intrinsics.npy"))
    args = eval_diffusion.parse_args([
        "--config", str(SRNCARS), "--weights", str(weights), "--output", str(out / "run"),
        "--device", "cuda", "--no_tensorboard", "--seed", "0", "--num_qualitatives", "1"])

    # the eval's stages, each between two synchronizes, and what they saw
    seen = {"sample_s": 0.0, "render_s": 0.0, "extract_s": [], "channels": [], "images": []}
    orig = DiffusionEvaluation.generate, DiffusionEvaluation.render_objects, FIDKID.feed

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    def generate(self, model, state, num, noise):
        seen.update(ev=self, model=model, state=state)
        seen["clouds"], dt = timed(lambda: orig[0](self, model, state, num, noise))
        seen["sample_s"] += dt
        return seen["clouds"]

    def render_objects(self, pointnerf, coords, feats):
        channels, dt = timed(lambda: orig[1](self, pointnerf, coords, feats))
        seen["channels"].append(channels)
        seen["render_s"] += dt
        return channels

    def feed(self, images, kind):  # on the eval's worker thread
        _, dt = timed(lambda: orig[2](self, images, kind))
        seen["images"].append(images)
        seen["extract_s"].append(dt)
        seen["extract"] = self.extract

    DiffusionEvaluation.generate, DiffusionEvaluation.render_objects, FIDKID.feed = (
        generate, render_objects, feed)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        results = eval_diffusion.evaluate(args, config)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20

        ev, model, state = seen["ev"], seen["model"], seen["state"]
        coords, feats = seen["clouds"]
        channels, images = seen["channels"][0], seen["images"][0]
        steps = model.diffusion.process.num_timesteps
        rays = channels.shape[0] * channels.shape[1] * channels.shape[2]
        print(f"[fid-eval] 2 samples x {FID_POSES} SRN test poses at {res}^2 in one group, "
              f"validity {model.pointnerf.cfg.validity}, random_projection:{FID_FEATURES}: "
              f"sampler {steps / seen['sample_s']:.2f} steps/s ({seen['sample_s']:.1f} s), "
              f"render {rays / seen['render_s']:.0f} rays/s ({seen['render_s']:.2f} s), "
              f"extraction {1e3 * seen['extract_s'][0]:.1f} ms a group of {len(images)} images; "
              f"peak {peak_mib:.0f} MiB; {wall:.1f} s with the model's build and load")
        print(f"[fid-eval] " + " ".join(f"{k} {v:.6g}" for k, v in results.items()))
        if not np.isfinite(list(results.values())).all():
            raise AssertionError(f"non-finite results {results}")
        files = [out / "run" / n for n in ("results.json", "results.csv", "sample0000.png")]
        if not all(f.exists() for f in files):
            raise AssertionError(f"missing outputs: {[str(f) for f in files if not f.exists()]}")

        _reset_launches()
        again = ev(model, state, torch.Generator(device="cuda").manual_seed(0))
        relaunched = {k: v for k, v in _read_launches().items() if v}
        print(f"[fid-eval] second call: {'skipped' if again == results else 'DIFFERS'}, "
              f"launches {relaunched or 0}")
        if again != results or relaunched:
            raise AssertionError("the second call did not skip")

        if not (isinstance(images, torch.Tensor) and images.is_cuda):
            raise AssertionError("the device-resident extractor was not fed a CUDA tensor")
        host = images.cpu().numpy()
        same_feats = np.array_equal(seen["extract"](images), seen["extract"](host))
        want_q = np.round(np.clip(channels.cpu().numpy(), 0.0, 1.0) * 255.0) / 255.0
        same_q = np.array_equal(host.reshape(want_q.shape), want_q)
        again = render(model, coords.cpu().numpy(), feats.cpu().numpy(), ev.poses, ev.intrinsics,
                       res, torch.device("cuda"))["channels"]
        same_render = torch.equal(again, channels)
        print(f"[fid-eval] features fed as a CUDA tensor vs as host numpy: "
              f"{'bitwise equal' if same_feats else 'DIFFER'}; quantized on the card vs numpy's "
              f"round(clip(x) * 255) / 255: {'bitwise equal' if same_q else 'DIFFER'}; renders vs "
              f"generate_samples.render of the same clouds: "
              f"{'bitwise equal' if same_render else 'DIFFER'}")
        if not (same_feats and same_q and same_render):
            raise AssertionError("the FID eval's feed, quantization or renders disagree")
        del again

        # one group again, the render's MLPs in bf16, on the same clouds
        seen["channels"].clear()
        render_s, seen["render_s"] = seen["render_s"], 0.0
        ev16 = DiffusionEvaluation(out_dir=str(out / "bf16"), device="cuda",
                                   **{**config["diffusion_evaluation"],
                                      "render_dtype": "bfloat16"})
        ev16.generate = lambda *a: (coords, feats)
        _reset_launches()
        r16 = ev16(model, state, torch.Generator(device="cuda").manual_seed(0), kid_seed=0)
        torch.cuda.synchronize()
        launches = {k: v + _read_launches()[k] for k, v in launches.items()}
        ch16 = seen["channels"][0]
    finally:
        DiffusionEvaluation.generate, DiffusionEvaluation.render_objects, FIDKID.feed = orig
    cross = _psnr_db(ch16, channels)
    print(f"[fid-eval] bf16 render: {rays / seen['render_s']:.0f} rays/s (f32 "
          f"{rays / render_s:.0f}); "
          f"cross-PSNR against the f32 renders {cross:.2f} dB; "
          + " ".join(f"{k} {v:.6g}" for k, v in r16.items()))

    # one object x one pose of the bf16 render on the CPU, plain versions
    cpu = copy.deepcopy(model.pointnerf).cpu()
    cpu.cfg = dataclasses.replace(cpu.cfg, compute_dtype=torch.bfloat16)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    ref = cpu.render(coords[:1].transpose(1, 2).contiguous().cpu(),
                     feats[:1].transpose(1, 2).contiguous().cpu(), t(ev.poses[None, :1]),
                     t(ev.intrinsics[None, :1]), resolution=res)["channels"][0, 0]
    db = _psnr_db(ch16[0, 0].cpu(), ref)
    # the kernels round at npcd_tpu's bf16 points, the plain version too, but
    # sum in another order, so ~1% of the roundings flip by a bf16 ulp (2**-8
    # relative); the render is also discontinuous where a flip moves a sample
    # across a decision. Held to the bound the bf16 render is qualified
    # against f32 with (npcd_tpu's test_fid_eval_bf16_render): 40 dB, an rms
    # of 1e-2 on channels in [0, 1]
    print(f"[fid-eval] bf16 GPU vs CPU plain render (1 object x 1 pose): {db:.2f} dB "
          f"(tol >= 40), max_abs_err {_err(ch16[0, 0].cpu(), ref):.3e}")
    if cross < 40 or db < 40 or not np.isfinite(list(r16.values())).all():
        raise AssertionError(f"bf16 FID render: cross-PSNR {cross} dB, CPU {db} dB, {r16}")
    del seen, model, ev, ev16, cpu
    torch.cuda.empty_cache()
    return {"launches": launches}


def phase_psnr_eval() -> dict:
    """python -m npcd_tpu_torch.eval_pointnerf's code path on phase 9's
    export (configs/npcd_srncars.yaml, f32) and phase 12's (the fast config,
    bf16), over their seeded synthetic dataset with 4 views: 5 objects at
    eval_batch_size 1 (3 burn-in, 2 timed); one view of each rendered again
    bitwise, and the f32 one against the CPU's plain render."""
    launches = {}
    for path, trained, tag in ((SRNCARS, "stage1", "psnr-eval"),
                               (FAST, "fast-stage1", "psnr-eval-fast")):
        exports = sorted((OUT / trained).glob("weights_only_checkpoints_dir/pointnerf-iter-*.npz"))
        if not exports:
            raise AssertionError(f"no stage-1 export under {OUT / trained}: run its phase first")
        config = load_config(str(path))
        dataset = _stage1_dataset(config, config["model"]["n_obj"], PSNR_VIEWS)
        out = OUT / tag
        shutil.rmtree(out, ignore_errors=True)
        args = eval_pointnerf.parse_args([
            "--config", str(path), "--weights", str(exports[-1]), "--output", str(out),
            "--device", "cuda", "--no_tensorboard", "--num_samples", str(PSNR_OBJECTS),
            "--num_qualitatives", "1"])
        models = []
        load = eval_pointnerf.load_stage1_weights
        eval_pointnerf.load_stage1_weights = lambda m, p: models.append(m) or load(m, p)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            res = eval_pointnerf.evaluate(args, config, dataset)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: launches.get(k, 0) + v for k, v in _read_launches().items()}
        finally:
            eval_pointnerf.load_stage1_weights = load
        model, rows, summary = models[0], res["rows"], res["summary"]
        cfg, r = model.cfg, model.opts.default_resolution
        bf16 = cfg.compute_dtype == torch.bfloat16
        print(f"[{tag}] {PSNR_OBJECTS} objects x {PSNR_VIEWS} views at {r}^2 of "
              f"{exports[-1].name}, eval_batch_size 1, validity {cfg.validity}, "
              f"{str(cfg.compute_dtype).split('.')[-1]}: "
              f"{1e3 * summary['time_per_forward_s']:.2f} ms a forward "
              f"({r * r / summary['time_per_forward_s']:.0f} rays/s) over "
              f"{(PSNR_OBJECTS - 3) * PSNR_VIEWS} forwards after 3 burn-in objects; peak "
              f"{summary['peak_device_mem_mib']:.0f} MiB; PSNR {summary['psnr']:.4f}; "
              f"{wall:.1f} s with the model's build and load")
        if len(rows) != PSNR_OBJECTS * PSNR_VIEWS or not np.isfinite(
                [x["psnr"] for x in rows]).all():
            raise AssertionError(f"expected {PSNR_OBJECTS * PSNR_VIEWS} finite rows: {rows}")
        for name in ("results.json", "results.csv", "summary.csv"):
            if not (out / name).exists():
                raise AssertionError(f"missing {out / name}")

        # the first row's view again on the card (bitwise the eval's) and, in
        # f32, on the CPU with the plain versions (phase 19 holds the bf16
        # kernels against the CPU; a full view there takes ~20 s)
        sample = dataset[rows[0]["obj_idx"]]
        view = [torch.as_tensor(a) for a in (sample["obj_idx"][None], sample["intrinsics"][None, :1],
                                             sample["extrinsics"][None, :1])]
        gpu = model.eval_forward(*(a.to("cuda") for a in view))["channels"][0, 0].float().cpu()
        gt = sample["images"][0]
        p_gpu = psnr(gpu.numpy(), gt)
        text = (f"[{tag}] object {rows[0]['obj_idx']} view 0: eval PSNR {rows[0]['psnr']:.6f}, "
                f"the card again {p_gpu:.6f}")
        if not bf16:
            cpu = copy.deepcopy(model).cpu().eval_forward(*view)["channels"][0, 0].float()
            p_cpu = psnr(cpu.numpy(), gt)
            # renders within 1e-3 on every channel (phase 5's tolerance) make
            # PSNRs within 20 log10(1 + 1e-3 / rmse) dB (Minkowski)
            rmse = float(np.sqrt(np.mean((cpu.double().numpy() - gt) ** 2)))
            bound = 20 * np.log10(1 + 1e-3 / rmse)
            err = _err(gpu, cpu)
            text += (f", CPU plain render {p_cpu:.6f} (|diff| {abs(rows[0]['psnr'] - p_cpu):.2e}, "
                     f"tol {bound:.2e}); GPU vs CPU render max_abs_err {err:.3e} (tol 1e-03)")
            if abs(rows[0]["psnr"] - p_cpu) > bound or err > 1e-3:
                raise AssertionError(f"{tag}: the eval's PSNR disagrees with the CPU's render")
        print(text)
        if rows[0]["psnr"] != p_gpu:
            raise AssertionError(f"{tag}: the same view rendered again gives another PSNR")
        del model, models, dataset
        torch.cuda.empty_cache()
    return {"launches": launches}


def phase_srn_stage1(tag: str = "srn-fast-stage1") -> dict:
    """python -m npcd_tpu_torch.train_pointnerf's code path on the fast
    config with SRNCarsTrain, built through the registry, over an SRN-format
    tree the phase writes."""
    out = OUT / tag
    shutil.rmtree(out, ignore_errors=True)
    config = load_config(str(FAST))
    size = build_pointnerf_options(config).default_resolution
    t0 = time.perf_counter()
    ids = [f"obj{o:04d}" for o in range(STAGE1_OBJECTS)]
    sample_list = write_srn_tree(out / "srn", "cars", ids, size, SRN_CLOUD)
    print(f"[{tag}] wrote an SRN-format tree: {len(ids)} objects x {VIEWS} views at {size}^2, "
          f"PNG rows under all five filter types, cam2world poses, intrinsics.txt, "
          f"{SRN_CLOUD}-point clouds without the FPS cache ({time.perf_counter() - t0:.1f} s); "
          f"cut: the object count, {config['model']['n_obj']} -> {len(ids)}")
    config["model"]["n_obj"] = len(ids)
    config["dataset_kwargs"] = {"root": str(out / "srn"), "sample_list": sample_list}
    steps = len(ids) // config["pointnerf_training"]["batch_size"]
    config["pointnerf_training"].update(max_epochs=1, print_interval=1, log_scalars_interval=1,
                                        log_interval=steps)
    args = train_pointnerf.parse_args(["--config", str(FAST), "--output", str(out / "train"),
                                       "--device", "cuda", "--no_tensorboard", "--seed", "0"])
    spent = {"build": [], "decode": [], "fps": []}  # seconds of each call, on the loader threads
    built = []

    def timed(name, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name].append(time.perf_counter() - t)
        return wrapper

    patched = {(builders, "build_dataset"): builders.build_dataset,
               (srn_module, "_load_image"): srn_module._load_image,
               (srn_module, "farthest_point_sampling"): srn_module.farthest_point_sampling}

    def build_dataset(*a, **kw):
        built.append(patched[builders, "build_dataset"](*a, **kw))
        return built[-1]

    builders.build_dataset = timed("build", build_dataset)
    srn_module._load_image = timed("decode", patched[srn_module, "_load_image"])
    srn_module.farthest_point_sampling = timed("fps", patched[srn_module, "farthest_point_sampling"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    try:
        trainer = train_pointnerf.train(args, config)
        torch.cuda.synchronize()
    finally:
        for (module, name), fn in patched.items():
            setattr(module, name, fn)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    dataset = built[0]
    if type(dataset).__name__ != "SRNCarsTrain" or trainer.dataset is not dataset:
        raise AssertionError(f"the CLI's path built {type(dataset).__name__}")
    print(f"[{tag}] SRNCarsTrain through the registry: preload {spent['build'][0]:.2f} s on 8 "
          f"threads (thread-seconds: PNG decode {sum(spent['decode']):.2f} for "
          f"{len(spent['decode'])} images, FPS {sum(spent['fps']):.2f} for {len(spent['fps'])} "
          f"clouds of {SRN_CLOUD} -> {config['model']['num_points']})")

    hist = trainer.history
    if [h["it"] for h in hist] != list(range(1, steps + 1)):
        raise AssertionError(f"expected {steps} logged steps, got {len(hist)}")
    if not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"non-finite loss: {[h['loss'] for h in hist]}")
    steps_s = (steps - STAGE1_WARMUP) / (hist[-1]["time"] - hist[STAGE1_WARMUP - 1]["time"])
    print(f"[{tag}] {steps} steps of B {trainer.batch_size} x V {VIEWS} through the prefetched "
          f"loop in {wall:.1f} s (with the preload, the final checkpoint and export): "
          f"{steps_s:.4f} steps/s over steps {STAGE1_WARMUP + 1}-{steps}; peak {peak_gib:.2f} GiB; "
          f"loss " + " ".join(f"{h['loss']:.6g}" for h in hist))
    with open(out / "train" / "metrics.jsonl") as f:
        logged = [json.loads(line) for line in f]
    names = ("full_render_psnr", "feats_mean_abs", "feats_std_mean")
    quali = {e["name"]: e["value"] for e in logged if e["step"] == steps
             and e["name"] in [f"pointnerf_train/{n}" for n in names]}
    if len(quali) != len(names) or not all(map(np.isfinite, quali.values())):
        raise AssertionError(f"the qualitative re-render at step {steps} logged {quali}")
    print(f"[{tag}] qualitative re-render at step {steps}: " + ", ".join(
        f"{k.split('/')[1]} {v:.6g}" for k, v in quali.items()))

    # the images bitwise what was written; the caches, FPS on the card, the coords table
    for sample in dataset.samples:
        o = int(sample["obj_idx"])
        for image, v in zip(sample["images"], sample["view_indices"]):
            want = fixture_image(0, o, int(v), size).astype(np.float32) / 255.0
            if not np.array_equal(image, want.reshape(-1, 3)):
                raise AssertionError(f"object {o} view {v}: the decoded image differs")
    coords = trainer.model.tables.coords_table
    for o, (c, name, _) in enumerate(sample_list):
        path = out / "srn" / c / name
        with np.load(path / "pointcloud3.npz") as z:
            points, normals = z["points"], z["normals"]
        with np.load(path / f"pointcloud3_{config['model']['num_points']}.npz") as z:
            cached, cached_normals = z["points"], z["normals"]
        sampled, idx = farthest_point_sampling(torch.from_numpy(points).cuda(),
                                               config["model"]["num_points"])
        if not (torch.equal(sampled.cpu(), torch.from_numpy(cached))
                and np.array_equal(normals[idx.cpu().numpy()], cached_normals)
                and torch.equal(coords[o], sampled)):
            raise AssertionError(f"object {o}: FPS on the card, the cache and the coords table "
                                 "disagree")
    print(f"[{tag}] {len(dataset)} x {VIEWS} decoded images bitwise the uint8 arrays written "
          f"/255; {len(ids)} caches written; FPS on the card picks the CPU's points; the coords "
          f"table holds them")

    fresh = PointNeRFTraining(str(out / "train"), build_pointnerf(config, with_tables=True),
                              dataset, device="cuda", verbose=False, **config["pointnerf_training"])
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

    with contextlib.closing(trainer.feeds(trainer.step)) as feeds:
        trainer.train_feed(next(feeds))
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(SRN_PROFILED):
                trainer.train_feed(next(feeds))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    _report(f"{tag} x{SRN_PROFILED}", prof, wall)
    del trainer, dataset, built, prof
    torch.cuda.empty_cache()
    return {"launches": launches, "steps_s": steps_s, "peak_gib": peak_gib}


class _StandInInception(torch.nn.Module):
    """The StyleGAN Inception graph's signature, ``model(x, return_features=True)``
    on uint8 [N, 3, 128, 128], and its 2048 features: a fixed projection of
    the 8x8-pooled pixels."""

    def __init__(self, res: int = 128, dims: int = INCEPTION_FEATURES):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.proj = torch.nn.Parameter(torch.randn(3 * (res // 8) ** 2, dims, generator=g) / 255)

    def forward(self, x: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        return F.avg_pool2d(x.float(), 8).flatten(1) @ self.proj


def phase_reference_weights(tag: str = "reference-weights") -> dict:
    """A synthetic checkpoint in the reference's layout at the full width of
    configs/npcd_srncars.yaml, converted by utils/convert_reference.py and
    loaded; the converted denoiser held against the reference's math on its
    own per-head weights; then python -m npcd_tpu_torch.parity_eval's code
    path with a stand-in Inception graph and its statistics pickle from
    python -m npcd_tpu_torch.compute_inception_stats."""
    out = OUT / tag
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t_phase = time.perf_counter()
    with open(ROOT / "npcd_tpu_torch/data/sample_lists/srn_cars_train.list") as f:
        ids = [line.strip() for line in f if line.strip()][:REF_OBJECTS]
    config = json.loads(json.dumps(load_config(str(SRNCARS))))  # plain dicts, for YAML
    m = config["model"]
    t0 = time.perf_counter()
    sample_list = write_srn_tree(out / "srn", "cars", ids, 128, REF_CLOUD)
    print(f"[{tag}] wrote an SRN-format tree under the train list's first {len(ids)} ids "
          f"({len(ids)} objects x {VIEWS} views at 128^2, {REF_CLOUD}-point clouds; "
          f"{time.perf_counter() - t0:.1f} s); cut: the object count, {m['n_obj']} -> {len(ids)}")
    m["n_obj"] = len(ids)
    config["dataset_kwargs"] = {"sample_list": [list(e) for e in sample_list],
                                "views_per_sample": REF_VIEWS}
    config["diffusion_evaluation"].update(
        poses_path=str(ROOT / "data/srncars_test_poses.npy"),
        intrinsics_path=str(ROOT / "data/srncars_test_intrinsics.npy"))
    cfg = out / "config.yaml"
    cfg.write_text(yaml.safe_dump(config))

    ckpt, npz = out / "npcd_reference.pt", out / "npcd_reference.npz"
    try:
        t0 = time.perf_counter()
        sd = reference_state(m["width"], seed=0, n_obj=len(ids), points=m["num_points"],
                             feat_dim=m["feats_dim"], layers=m["layers"], device="cuda")
        host = {k: ({"emb": {"weight": v["emb"]["weight"].cpu()}} if isinstance(v, dict)
                    else v.cpu()) for k, v in sd.items()}
        torch.save(host, ckpt)
        del host
        write_s = time.perf_counter() - t0
        n_params = sum(v.numel() for k, v in sd.items() if k.startswith("diffusion.denoiser."))
        t0 = time.perf_counter()
        flat, layout = convert_checkpoint(str(ckpt), config)
        convert_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_converted(str(npz), flat, layout)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = NPCD.from_config(config)
        load_npz(model, str(npz))
        model = model.cuda().eval()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f"[{tag}] reference checkpoint: denoiser {n_params / 1e6:.1f}M params "
              f"({m['width']} x {m['layers']} x {m['heads']} heads), {len(sd)} keys, "
              f"{ckpt.stat().st_size / 1e9:.3f} GB, drawn and written in {write_s:.1f} s; "
              f"convert_checkpoint {convert_s:.1f} s ({len(flat)} arrays, layout {layout}); "
              f"save_converted {save_s:.1f} s ({npz.stat().st_size / 1e9:.3f} GB); "
              f"NPCD.from_config + load_npz + to the card {load_s:.1f} s")
        del flat

        # the converted denoiser (K1f, K2a/b) against the reference's math on
        # its own per-head [q|k|v] weights, exact f32 on the card, a batch of
        # 2 at the full 513 tokens
        denoiser = model.diffusion.denoiser
        g = torch.Generator(device="cuda").manual_seed(1)
        coords = torch.randn(2, 3, m["num_points"], generator=g, device="cuda")
        feats = torch.randn(2, m["feats_dim"], m["num_points"], generator=g, device="cuda")
        t = torch.tensor([3, 700], device="cuda")
        with torch.no_grad():
            _reset_launches()
            got = denoiser(coords, feats, t)
            torch.cuda.synchronize()
            gate_launches = {k: v for k, v in _read_launches().items() if v}
            want = reference_forward(sd, coords, feats, t, m["heads"], m["layers"])
            # control: the reference's own c_qkv order in the port's model
            for i, block in enumerate(denoiser.resblocks):
                name = f"diffusion.denoiser.backbone.resblocks.{i}.attn.c_qkv"
                block.attn.c_qkv.weight.copy_(sd[f"{name}.weight"])
                block.attn.c_qkv.bias.copy_(sd[f"{name}.bias"])
            wrong = denoiser(coords, feats, t)
        scale = max(float(w.abs().max()) for w in want)
        err = max(_err(a, b) for a, b in zip(got, want))
        err_wrong = max(_err(a, b) for a, b in zip(wrong, want))
        # f32 through 24 blocks in other summation orders, K1f's products in
        # 3xTF32: 1e-4 of the output's scale; the unpermuted columns must miss
        # by 100 times that
        tol = 1e-4 * max(1.0, scale)
        print(f"[{tag}] converted denoiser vs the reference's per-head math (2 x "
              f"{m['num_points'] + 1} tokens, launches {gate_launches}): max_abs_err {err:.3e} "
              f"(tol {tol:.1e}, outputs up to "
              f"{scale:.3f}); with c_qkv left in the reference's order {err_wrong:.3e} "
              f"(must exceed {100 * tol:.1e})")
        if not err <= tol or not err_wrong > 100 * tol:
            raise AssertionError(f"{tag}: converted denoiser {err}, control {err_wrong}")
        del model, denoiser, sd, got, want, wrong
        torch.cuda.empty_cache()

        graph, pkl = out / "inception.pt", out / "stats.pkl"
        torch.jit.save(torch.jit.script(_StandInInception()), str(graph))
        t0 = time.perf_counter()
        stats = compute_inception_stats.main([
            "--srn-test-root", str(out / "srn" / "cars"), "--inception", str(graph), "--out",
            str(pkl), "--max-objects", str(REF_STATS_OBJECTS), "--device", "cuda"])
        print(f"[{tag}] compute_inception_stats: {stats['feats_np'].shape[0]} images -> "
              f"{stats['feats_np'].shape[1]} features of a stand-in TorchScript graph in "
              f"{time.perf_counter() - t0:.1f} s")

        common = ["--weights", str(ckpt), "--config", str(cfg), "--srn-root", str(out / "srn"),
                  "--inception", str(graph), "--inception-pkl", str(pkl)]
        t0 = time.perf_counter()
        parity_eval.main(common + ["--check-assets"])  # exits 1 on a problem
        print(f"[{tag}] --check-assets {time.perf_counter() - t0:.1f} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        t0 = time.perf_counter()
        summary = parity_eval.main(common + [
            "--out", str(out / "parity"), "--stage", "both", "--psnr-samples",
            str(REF_PSNR_SAMPLES), "--num-samples", "2", "--max-poses", str(REF_POSES),
            "--generate-batch-size", "2", "--seed", "0", "--device", "cuda"])
        torch.cuda.synchronize()
        parity_s = time.perf_counter() - t0
        launches = _read_launches()
    finally:
        os.environ.pop("NPCD_TPU_SRN_ROOT", None)
        for path in (ckpt, npz, Path(f"{npz}.layout.json")):
            path.unlink(missing_ok=True)
    with open(out / "parity" / "parity.json") as f:
        written = json.load(f)
    print(f"[{tag}] parity_eval --stage both (validity voxel, {REF_PSNR_SAMPLES} samples x "
          f"{REF_VIEWS} views for the PSNR, 2 generated x {REF_POSES} poses for the FID): "
          f"psnr {summary['psnr']} fid {summary['fid']} kid_x1000 {summary['kid_x1000']} in "
          f"{parity_s:.1f} s with its conversion, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; the checkpoint deleted; "
          f"phase {time.perf_counter() - t_phase:.1f} s")
    if written != summary or not np.isfinite(
            [summary["psnr"], summary["fid"], summary["kid_x1000"]]).all():
        raise AssertionError(f"{tag}: parity.json {written}, printed {summary}")
    return {"launches": launches}


def phase_options(name: str) -> dict:
    """Phase 23 (V) or 24 (O): PointNeRF at its configurable options, the
    config at OPTION_PATHS[name][0] with model.use_view_dir and the
    pointnerf_options overrides there, built in memory: stage 1 through
    train_pointnerf's code path (phase 9's, over the first objects of the
    seeded synthetic dataset), then the trained model's render of 2 objects
    x 4 SRN test poses at 128^2 (O with kp_weights, whose sum over the points
    must be each ray's mask), one object x one pose at 16^2 again in chunks
    of one ray (fewer than 8 shading points a block: the aggregation's
    no-reduction form) against the same render in the config's chunks, and
    one object x one pose at 64^2 against the CPU's plain render (f32 within
    1e-3, bf16 at least 40 dB cross-PSNR, as phases 5 and 19) -> the
    launches of the whole phase."""
    path, options, objects = OPTION_PATHS[name]
    tag = f"options-{name}"
    config = load_config(str(path))
    config["model"]["use_view_dir"] = True
    config["pointnerf_options"] = {**config.get("pointnerf_options", {}), **options}
    res = phase_stage1(path, tag, config, objects)
    model = res.pop("trainer").model
    o, cd = model.opts, model.cfg.compute_dtype
    widths = {n: tuple(getattr(model, n)[0].shape) for n in ("local_field", "shape_net",
                                                             "channel_net")}
    if not (o.field.use_dir and all(getattr(o.aggregator if k in ("k", "posenc_method") else
                                            o.renderer if k.startswith("disparity") else
                                            o.field, k) == v for k, v in options.items())):
        raise AssertionError(f"{tag}: the options did not reach the model: {o}")
    print(f"[{tag}] options {options}, use_view_dir: first layers {widths}")

    _reset_launches()
    poses = np.load(ROOT / "data/srncars_test_poses.npy")[:4].astype(np.float32)
    intr = np.load(ROOT / "data/srncars_test_intrinsics.npy")[:4].astype(np.float32)
    cuda = lambda a: torch.as_tensor(np.ascontiguousarray(a), device="cuda")
    ext = cuda(np.broadcast_to(poses, (2, 4, 4, 4)))
    intr = cuda(np.broadcast_to(intr, (2, 4, 3, 3)))
    coords, feats = model.get_all_coords()[:2], model.get_all_feats()[:2].detach()
    kp = name == "O"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.render(coords, feats, ext, intr, resolution=128, kp_weights=kp)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    ch = out["channels"]
    lo, hi = float(ch.min()), float(ch.max())
    if not torch.isfinite(ch).all() or lo < -1e-5 or hi > 1 + 1e-5:
        raise AssertionError(f"{tag}: render channels non-finite or outside [0, 1]: [{lo}, {hi}]")
    text = ""
    if kp:
        # each shaded sample's pair weights sum to 1, so a ray's point weights
        # sum to its compositing weight total: f32 sums in another order
        kp_err = _err(out["kp_weights"].sum(-1), out["mask"][..., 0])
        text = (f"; kp_weights {tuple(out['kp_weights'].shape)}, sum over points vs mask "
                f"{kp_err:.2e} (tol 1e-4)")
        if kp_err > 1e-4:
            raise AssertionError(f"{tag}: kp_weights do not sum to the mask: {kp_err}")
    print(f"[{tag}] render 2 x 4 poses at 128^2 ({str(cd).split('.')[-1]}): "
          f"{ch.numel() // 3 / render_s:.0f} rays/s ({render_s:.2f} s), valid rays "
          f"{float(out['ray_valid'].float().mean()):.3f}, channels in [{lo:.4f}, {hi:.4f}]{text}")
    del out, ch
    small = lambda m, dev=None, res=16: m.render(*(a if dev is None else a.to(dev) for a in (
        coords[:1], feats[:1], ext[:1, :1], intr[:1, :1])), resolution=res)
    ref = small(model)["channels"]
    cfg = model.cfg
    model.cfg = dataclasses.replace(cfg, eval_ray_chunk=1)
    launched = fused_mlp_posenc.launches_recurrence + fused_mlp_posenc.launches_direct_bf16
    one = small(model)["channels"]
    model.cfg = cfg
    launched = fused_mlp_posenc.launches_recurrence + fused_mlp_posenc.launches_direct_bf16 \
        - launched
    tol = 1e-4 if cd == torch.float32 else 2 ** -7
    err = _err(one, ref)
    print(f"[{tag}] 1 x 1 pose at 16^2 in chunks of one ray: {launched} launches of the "
          f"no-reduction form; channels vs the config's chunks max_abs_err {err:.3e} "
          f"(tol {tol:.0e})")
    if not launched or err > tol:
        raise AssertionError(f"{tag}: the one-ray chunks' render differs or took no "
                             f"no-reduction launch: {err}, {launched}")
    launches = _read_launches()
    cpu = copy.deepcopy(model).cpu()
    want = small(cpu, "cpu", 64)["channels"][0, 0]
    got = small(model, None, 64)["channels"][0, 0].cpu()
    if cd == torch.float32:
        err = _err(got, want)
        print(f"[{tag}] GPU vs CPU plain render (1 object x 1 pose, 64^2) max_abs_err "
              f"{err:.3e} (tol 1e-03)")
        if err > 1e-3:
            raise AssertionError(f"{tag}: the render disagrees with the CPU's: {err}")
    else:
        db = _psnr_db(got, want)
        print(f"[{tag}] GPU vs CPU plain bf16 render (1 object x 1 pose, 64^2): cross-PSNR "
              f"{db:.2f} dB (>= 40)")
        if db < 40:
            raise AssertionError(f"{tag}: the bf16 render is {db} dB from the CPU's")
    del cpu, model
    torch.cuda.empty_cache()
    return {"launches": {k: v + launches[k] for k, v in res["launches"].items()}}


def _k6_f64(feat_t, pos_t, weights, k: int, n_freqs: int, method: str, g=None,
            step: int = 5):
    """K6's function in float64 over the f32 layer-1 input [feat | x |
    posenc(x)] (the encoding computed in f32, as the kernel and the plain
    version compute it: 'direct' in float64 would move octave 9's sin by
    ~1e-4), in slices of ``step`` instances: the w-sum over each point's k
    pairs; with g, its VJP with pos_t constant -> (dfeat_t, [(dW, db)]),
    the dW summed over the slices."""
    grad = g is not None
    w64 = [(w.double().requires_grad_(grad), b.double().requires_grad_(grad))
           for w, b in weights]
    flat = [t for wb in w64 for t in wb]
    outs, dfs, dws = [], [], None
    for i0 in range(0, feat_t.shape[0], step):
        sl = slice(i0, i0 + step)
        with torch.enable_grad():
            f = feat_t[sl].double().requires_grad_(grad)
            enc = pointnerf_nn.positional_encoding(pos_t[sl, :3].transpose(1, 2), n_freqs, 1.0,
                                                   method)
            h = torch.cat([f.transpose(1, 2), enc.double()], dim=-1)
            out = pointnerf_nn.apply_mlp([{"w": w, "b": b} for w, b in w64], h)
            inst, m = h.shape[:2]
            ws = (out * pos_t[sl, 3, :, None].double()).reshape(inst, m // k, k, -1).sum(2)
            if not grad:
                outs.append(ws.detach())
                continue
            gr = torch.autograd.grad(ws, [f] + flat, g[sl].double())
        dfs.append(gr[0])
        pairs = list(zip(gr[1::2], gr[2::2]))
        dws = pairs if dws is None else [(a + c, b + d) for (a, b), (c, d) in zip(dws, pairs)]
    return torch.cat(outs) if not grad else (torch.cat(dfs), dws)


def phase_form_kernels() -> dict:
    """The kernel forms that phases 23 and 24 run, each against its plain
    version at the shapes those paths give it: K4 at k 16 over the O
    path's stage-1 aggregation (400 x 5,600 shading points) and its TV
    loss (8 x 512), and at k 6 and 32 over the aggregation's shape, indices
    and distances bitwise; K6f/K6b in f32 with the 'recurrence' and 'direct'
    posenc at k 16 over one 50-instance chunk of O's step (4.48M pairs)
    against float64 (_f64_gate: within 1e-5 of each output's scale), and k
    6 (run as 8 with zero-weight pairs) 'recurrence' over 5 instances; in
    bf16 with 'direct' at k 8 over the V path's one launch (400 x 14,336
    pairs) and 'recurrence' over 20 instances of it, by _bf16_err and
    _bf16_bwd_gate (pairs on a bf16 kink left out); the no-reduction form
    (k 1, unit pair weights) forward and backward at the shape of O's
    one-ray render chunks (8 instances x 5 points x k 16) in f32 and bf16;
    K7f/K7b at d_in 307 over V's 400 x 1,792 packed points for the channel
    net, by _bf16_err and _bf16_bwd_gate with the kink and slope-flip
    filters, a second launch and the rows reversed bitwise as in phase 11."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    results = {}
    check = lambda *a, **k: _record(results, *a, tag="kernels-forms", **k)
    flat = lambda df, dws: [df] + [t for wb in dws for t in wb]

    # K4 at k 16, 6 and 32 (O's stage-1 aggregation and TV loss)
    pts = torch.rand(400, 512, 3, generator=g, device=dev) - 0.5
    xq = pts[:, torch.randint(0, 512, (112 * 50,), generator=g, device=dev)] \
        + 0.05 * torch.randn(400, 112 * 50, 3, generator=g, device=dev)
    _knn_check(check, "knn (k other than 8)", xq, pts, 16)
    for k in (6, 32):
        _knn_check(check, f"knn (k {k}, stage-1 aggregation)", xq, pts, k)
    tv = pts[:8].contiguous()
    _knn_check(check, "knn (k 16, TV)", tv, tv, 16)
    del pts, xq, tv
    torch.cuda.empty_cache()

    def k6_inputs(inst, n_pts, k, dtype):
        feat_t = torch.randn(inst, 32, n_pts * k, generator=g, device=dev).to(dtype)
        w = torch.rand(inst, n_pts, k, generator=g, device=dev)
        pos_t = torch.cat([0.32 * torch.rand(inst, 3, n_pts * k, generator=g, device=dev) - 0.16,
                           (w / w.sum(-1, keepdim=True)).reshape(inst, 1, n_pts * k),
                           torch.zeros(inst, 4, n_pts * k, device=dev)], dim=1)
        return feat_t, pos_t

    layers = init_mlp((256, 256, 256, 256), 95, 256, torch.Generator().manual_seed(0), dev)
    w32 = [(l["w"], l["b"]) for l in layers]
    w16 = [(w.bfloat16(), b.bfloat16()) for w, b in w32]
    n_w = sum(t.numel() for wb in w32 for t in wb)

    # f32 K6f/K6b (3xTF32): 'recurrence' and 'direct' at k 16 over one
    # 50-instance chunk of O's step; 'recurrence' at k 6, run as k 8
    for method, inst, n_pts, k, name in (
            ("recurrence", 50, 112 * 50, 16, "fused_mlp_posenc_wsum (recurrence, k 16)"),
            ("direct", 50, 112 * 50, 16, "fused_mlp_posenc_wsum (direct)"),
            ("recurrence", 5, 112 * 50, 6, "fused_mlp_posenc_wsum (recurrence, k 6)")):
        feat_t, pos_t = k6_inputs(inst, n_pts, k, torch.float32)
        kinks = leaky_kinks(feat_t, pos_t, w32, 10, method=method)
        pos_t[:, 3][kinks] = 0.0
        fargs = (feat_t, pos_t, w32, k, 10, 1.0, method)
        gout = fused_mlp_posenc_wsum(*fargs)
        want = fused_mlp_posenc_wsum_plain(*fargs)
        exact = _k6_f64(feat_t, pos_t, w32, k, 10, method)
        gate = _f64_gate(name, [gout], [exact])
        m = n_pts * k
        check(name, _err(gout, want), 1e-4 * max(1.0, float(want.abs().max())),
              lambda: fused_mlp_posenc_wsum(*fargs), lambda: fused_mlp_posenc_wsum_plain(*fargs),
              flops=(K6F_FLOP + _K6_LAST * (8 / k - 1)) * inst * m,
              nbytes=4 * (feat_t.numel() + pos_t.numel() + n_w + want.numel()),
              extra=f" vs float64 (tol 1e-5 of its scale): kernel {gate}, f32 plain "
                    f"{_err64(want, exact):.2e}", tf32=True, iters=3)
        del want, exact
        bargs = (feat_t, pos_t, w32, gout, k, 10, 1.0, method)
        got = flat(*fused_mlp_posenc_wsum_bwd(*bargs))
        exact = flat(*_k6_f64(feat_t, pos_t, w32, k, 10, method, gout))
        gate = _f64_gate(name.replace("wsum", "wsum_bwd"), got, exact)
        if not all(torch.equal(a, b) for a, b in zip(flat(*fused_mlp_posenc_wsum_bwd(*bargs)),
                                                      got)):
            raise AssertionError(f"{name} backward: two runs on the same inputs differ")
        err, tol = _worst([(a, b, 1e-5) for a, b in zip(got, exact)])
        check(name.replace("wsum", "wsum_bwd"), err, tol,
              lambda: fused_mlp_posenc_wsum_bwd(*bargs),
              lambda: fused_mlp_posenc_wsum_bwd_plain(*bargs),
              extra=f" vs float64: {gate}; kinked pairs {int(kinks.sum())} of {kinks.numel()}; "
                    f"repeatable bitwise",
              flops=(K6B_FLOP + 2 * _K6_LAST * (8 / k - 1)) * inst * m,
              fp32_flops=K6B_FP32_FLOP * inst * m,
              nbytes=4 * (2 * feat_t.numel() + pos_t.numel() + gout.numel() + 2 * n_w),
              tf32=True, iters=3)
        del feat_t, pos_t, gout, got, exact, bargs, kinks
        torch.cuda.empty_cache()

    # bf16 K6f/K6b: 'direct' at k 8 over V's launch, 'recurrence' over 20
    # instances of it
    for method, inst, name in (("direct", 400, "fused_mlp_posenc_wsum (direct, bf16)"),
                               ("recurrence", 20, "fused_mlp_posenc_wsum (recurrence, bf16)")):
        feat_t, pos_t = k6_inputs(inst, 1792, 8, torch.bfloat16)
        kinks = torch.cat([leaky_kinks(feat_t[i:i + 20], pos_t[i:i + 20], w16, 10,
                                       method=method) for i in range(0, inst, 20)])
        pos_t[:, 3][kinks] = 0.0
        fargs = (feat_t, pos_t, w16, 8, 10, 1.0, method)
        gout = fused_mlp_posenc_wsum(*fargs)
        err, tol, share = _bf16_err(gout, fused_mlp_posenc_wsum_plain(*fargs))
        if not torch.equal(fused_mlp_posenc_wsum(*fargs), gout):
            raise AssertionError(f"{name}: two runs on the same inputs differ")
        m = 1792 * 8
        check(name, err, tol, lambda: fused_mlp_posenc_wsum(*fargs),
              lambda: fused_mlp_posenc_wsum_plain(*fargs), flops=K6F_BF16_FLOP * inst * m,
              nbytes=feat_t.numel() * 2 + pos_t.numel() * 4 + n_w * 2 + gout.numel() * 2,
              extra=f" bitwise share {share:.4f}; repeated bitwise", peak=BF16_FLOP_S, iters=3)
        bargs = (feat_t, pos_t, w16, gout, 8, 10, 1.0, method)
        got = flat(*fused_mlp_posenc_wsum_bwd(*bargs))
        err, tol, text, faults = _bf16_bwd_gate(
            got, flat(*fused_mlp_posenc_wsum_bwd_plain(*bargs)), "dfeat", K6B_BF16_REL,
            K6B_BF16_DFEAT_SHARE)
        if not all(torch.equal(a, b) for a, b in zip(flat(*fused_mlp_posenc_wsum_bwd(*bargs)),
                                                      got)):
            faults.append("two runs on the same inputs differ")
        del got
        bname = name.replace("wsum", "wsum_bwd")
        check(bname, err, tol, lambda: fused_mlp_posenc_wsum_bwd(*bargs),
              lambda: fused_mlp_posenc_wsum_bwd_plain(*bargs),
              extra=f" kinked pairs {int(kinks.sum())} of {kinks.numel()}; {text}",
              flops=K6B_BF16_FLOP * inst * m, peak=BF16_FLOP_S,
              nbytes=2 * (2 * feat_t.numel() + gout.numel() + 2 * n_w) + 4 * pos_t.numel(),
              iters=3)
        if faults:
            raise AssertionError(f"{bname}: " + "; ".join(faults))
        del feat_t, pos_t, gout, bargs, kinks
        torch.cuda.empty_cache()

    # the no-reduction form at O's one-ray render chunks: 8 instances x 5
    # points x k 16 pairs, f32 'recurrence' (O's) and bf16 'direct'
    for dtype, method, weights, name in (
            (torch.float32, "recurrence", w32, "fused_mlp_posenc (no reduction)"),
            (torch.bfloat16, "direct", w16, "fused_mlp_posenc (no reduction, bf16)")):
        feat_t, pos_t = k6_inputs(8, 5, 16, dtype)
        kinks = leaky_kinks(feat_t, pos_t, weights, 10, method=method)
        fargs = (feat_t, pos_t, weights, 10, 1.0, method)
        got = fused_mlp_posenc(*fargs)
        want = fused_mlp_posenc_plain(*fargs)
        # and the pairs where the kernel's and the plain version's forwards
        # take another slope (slope_flips_bf16's test on the stack cut after
        # each hidden layer): a whole pair's product apart, which the 640
        # pairs' dW sums show
        flips = torch.zeros_like(kinks)
        for cut in range(1, len(weights) if dtype == torch.bfloat16 else 1):
            flips |= ((fused_mlp_posenc(feat_t, pos_t, weights[:cut], 10, 1.0, method) > 0)
                      != (fused_mlp_posenc_plain(feat_t, pos_t, weights[:cut], 10, 1.0, method)
                          > 0)).any(-1)
        gy = torch.randn(got.shape, generator=g, device=dev).to(dtype)
        gy[kinks | flips] = 0
        bargs = (feat_t, pos_t, weights, gy, 10, 1.0, method)
        bgot = flat(*fused_mlp_posenc_bwd(*bargs))
        bwant = flat(*fused_mlp_posenc_bwd_plain(*bargs))
        m = feat_t.shape[2]
        if dtype == torch.float32:
            exact = _k6_f64(feat_t, unit_pairs(pos_t), weights, 1, 10, method)
            extra = f" vs float64 {_f64_gate(name, [got], [exact])}"
            berr, btol = _worst([(a, b, 1e-5) for a, b in zip(
                bgot, flat(*_k6_f64(feat_t, unit_pairs(pos_t), weights, 1, 10, method,
                                    gy)))])
            err, tol = _err(got, want), 1e-4 * max(1.0, float(want.abs().max()))
            bextra, kw = " vs float64", {"tf32": True}
        else:
            err, tol, share = _bf16_err(got, want)
            extra = f" bitwise share {share:.4f}; slope flips {int((flips & ~kinks).sum())}"
            berr, btol, bextra, faults = _bf16_bwd_gate(bgot, bwant, "dfeat", K6B_BF16_REL,
                                                        K6B_BF16_DFEAT_SHARE)
            if faults:
                raise AssertionError(f"{name} backward: " + "; ".join(faults))
            bextra, kw = " " + bextra, {"peak": BF16_FLOP_S}
        size = 4 if dtype == torch.float32 else 2
        check(name, err, tol, lambda: fused_mlp_posenc(*fargs),
              lambda: fused_mlp_posenc_plain(*fargs), flops=K6F_BF16_FLOP * 8 * m,
              nbytes=size * (feat_t.numel() + n_w + got.numel()) + 4 * pos_t.numel(),
              extra=extra, **kw)
        check(name.replace("posenc", "posenc_bwd"), berr, btol,
              lambda: fused_mlp_posenc_bwd(*bargs), lambda: fused_mlp_posenc_bwd_plain(*bargs),
              flops=K6B_BF16_FLOP * 8 * m, extra=bextra,
              nbytes=size * (2 * feat_t.numel() + gy.numel() + 2 * n_w) + 4 * pos_t.numel(),
              **kw)

    # K7f/K7b at d_in 307: the V path's channel net, 256 features + the
    # view directions' 51 encoded columns, over 400 x 1,792 packed points
    rows = 400 * 1792
    x = torch.cat([torch.randn(rows, 256, generator=g, device=dev),
                   2 * torch.rand(rows, 51, generator=g, device=dev) - 1], 1).bfloat16()
    dims = (256, 256, 256, 256, 3)
    weights = [(l["w"].bfloat16(), l["b"].bfloat16())
               for l in init_mlp(dims[:-1], 307, 3, torch.Generator().manual_seed(1), dev)]
    n_w = sum(t.numel() for wb in weights for t in wb)
    fwd_flop, bwd_flop = _k7_flop(dims, 307)
    rev = torch.arange(rows - 1, -1, -1, device=dev)
    xr = x[rev].contiguous()
    got = fused_mlp(x, weights)
    err, tol, share = _bf16_err(got, fused_mlp_plain(x, weights))
    faults = []
    if not torch.equal(fused_mlp(x, weights), got):
        faults.append("two runs on the same inputs differ")
    if not torch.equal(fused_mlp(xr, weights)[rev], got):
        faults.append("the rows reversed differ")
    check("fused_mlp (d_in 307)", err, tol, lambda: fused_mlp(x, weights),
          lambda: fused_mlp_plain(x, weights), flops=fwd_flop * rows, peak=BF16_FLOP_S,
          nbytes=2 * (x.numel() + n_w + got.numel()),
          extra=f" channel_net with view directions; bitwise share {share:.4f}"
                + ("" if faults else "; rows reversed and repeated bitwise"))
    if faults:
        raise AssertionError("fused_mlp (d_in 307): " + "; ".join(faults))
    gy = torch.randn(rows, 3, generator=g, device=dev).bfloat16()
    kinks = torch.cat([leaky_kinks_bf16(x[i:i + 65536], weights)
                       for i in range(0, rows, 65536)])
    flips = slope_flips_bf16(x, weights)
    gy[kinks | flips] = 0
    got = flat(*fused_mlp_bwd(x, weights, gy))
    err, tol, text, faults = _bf16_bwd_gate(got, flat(*fused_mlp_bwd_plain(x, weights, gy)),
                                            "dx", K7B_BF16_REL, K7B_BF16_DX_SHARE)
    if got[0].shape != x.shape:
        faults.append(f"dx is {tuple(got[0].shape)}, x {tuple(x.shape)}")
    if not all(torch.equal(a, b) for a, b in zip(flat(*fused_mlp_bwd(x, weights, gy)), got)):
        faults.append("two runs on the same inputs differ")
    again = flat(*fused_mlp_bwd(xr, weights, gy[rev].contiguous()))
    order = min(float((a == b).float().mean()) for a, b in zip(again[1:], got[1:]))
    if not torch.equal(again[0][rev], got[0]) or order < K6B_BF16_ORDER_SHARE:
        faults.append(f"the rows reversed give dx equal {torch.equal(again[0][rev], got[0])}, "
                      f"dW/db {order} bitwise")
    del again, got
    check("fused_mlp_bwd (d_in 307)", err, tol, lambda: fused_mlp_bwd(x, weights, gy),
          lambda: fused_mlp_bwd_plain(x, weights, gy), flops=bwd_flop * rows, peak=BF16_FLOP_S,
          nbytes=2 * (2 * x.numel() + gy.numel() + 2 * n_w),
          extra=f" kinked rows {int(kinks.sum())}, slope flips {int(flips.sum())} of {rows}; "
                f"{text}; rows reversed: dW/db bitwise {order:.4f}")
    if faults:
        raise AssertionError("fused_mlp_bwd (d_in 307): " + "; ".join(faults))
    del x, xr, gy, kinks, flips
    torch.cuda.empty_cache()
    return results


class _FlagProbe:
    """A device-resident extractor, fed again and again for PROBE_HOLD
    seconds a group, with the TF32 flags it saw at each feed."""

    device_resident = True

    def __init__(self, inner):
        self.inner, self.seen = inner, []

    def __call__(self, images):
        end = time.perf_counter() + PROBE_HOLD
        while True:
            self.seen.append((torch.backends.cuda.matmul.allow_tf32,
                              torch.backends.cudnn.allow_tf32))
            feats = self.inner(images)
            if time.perf_counter() > end:
                return feats


def phase_diffusion_options() -> dict:
    """Phase 25: the diffusion diagnostics and the last generation and eval
    options on configs/npcd_srncars.yaml with phase 5's seeded weights, f32,
    validity from the config (knn): (a) python -m
    npcd_tpu_torch.generate_samples's code path with --trajectory-stride
    100 --swap 2 --render 2; (b) calc_bpd_loop on its two clouds (1000
    denoiser forwards), then with the oracle denoiser; (c) the two clouds x
    4 SRN test poses under matmul_precision "highest", then
    "tensorfloat32"; (d) DiffusionEvaluation on the two clouds with the
    render at "tensorfloat32" and the extractor overlapped. Path "D"."""
    out_dir = OUT / "diffusion-options"
    shutil.rmtree(out_dir, ignore_errors=True)
    weights = write_seeded_weights(str(SRNCARS), str(OUT / "seeded_npcd.npz"), seed=0)
    base = ["--config", str(SRNCARS), "--out", str(out_dir), "--weights", weights,
            "--num", "2", "--batch-size", "2", "--seed", "0", "--device", "cuda"]
    cams = ["--poses", str(ROOT / "data/srncars_test_poses.npy"),
            "--intrinsics", str(ROOT / "data/srncars_test_intrinsics.npy"), "--resolution", "128"]
    _reset_launches()

    # (a) trajectory and swap, through the CLI's main (it writes the files)
    out = generate_samples.main(base + cams + [
        "--trajectory-stride", str(TRAJ_STRIDE), "--swap", str(SWAP), "--render", "2",
        "--render-poses", "4"])
    model, state, coords, feats = out["model"], out["state"], out["coords"], out["feats"]
    steps = model.diffusion.process.num_timesteps
    with np.load(out_dir / "samples.npz") as z:
        tc, tf = z["trajectory_coords"], z["trajectory_feats"]
    d = model.diffusion
    frames = steps // TRAJ_STRIDE + 1
    if tc.shape != (frames, 2, d.coords_dim, d.num_points) or \
            tf.shape != (frames, 2, d.feats_dim, d.num_points):
        raise AssertionError(f"trajectory shapes {tc.shape}, {tf.shape}")
    if not (np.isfinite(tc).all() and np.isfinite(tf).all()):
        raise AssertionError("non-finite trajectory")
    dev_state = [n.to("cuda") for n in (state.coords_norm, state.feats_norm)]
    last = [denormalize(n, torch.from_numpy(x[-1]).cuda()).cpu().numpy()
            for n, x in zip(dev_state, (tc, tf))]
    if not (np.array_equal(last[0], coords) and np.array_equal(last[1], feats)):
        raise AssertionError("the trajectory's denormalized last frame differs from the samples")
    if MAIN_SAMPLES.get("argv") == (weights, 0, 2, 2):
        ref, ref_from = (MAIN_SAMPLES["coords"], MAIN_SAMPLES["feats"]), "phase 5's run"
    else:
        plain = run(parse_args(base))
        ref, ref_from = (plain["coords"], plain["feats"]), "a run without the trajectory"
        del plain
    if not (np.array_equal(ref[0], coords) and np.array_equal(ref[1], feats)):
        raise AssertionError(f"the samples with the trajectory differ from {ref_from}")
    traj_cost = out["sample_s"] / (MAIN_SAMPLES["sample_s"] if "sample_s" in MAIN_SAMPLES
                                   else float("nan"))
    with open(out_dir / "swap_grid.png", "rb") as f:
        w, h = struct.unpack(">II", f.read(24)[16:24])
    if (w, h) != (SWAP * 128, SWAP * 128):
        raise AssertionError(f"swap_grid.png is {w} x {h}")
    diag = torch.stack([out["swap"][i * SWAP + i, 0] for i in range(SWAP)])
    first_pose = out["channels"][:SWAP, 0]
    diag_err = _err(diag, first_pose)
    print(f"[diffusion-options] trajectory stride {TRAJ_STRIDE}: coords {tc.shape} feats "
          f"{tf.shape}, finite; sampler {steps / out['sample_s']:.2f} steps/s "
          f"({out['sample_s']:.2f} s; x{traj_cost:.4f} of phase 5's sampler); the denormalized "
          f"last frame bitwise the samples, the samples bitwise {ref_from}; swap_grid.png "
          f"{w} x {h} ({out['swap_s']:.2f} s), its diagonal against --render's first pose "
          f"max_abs_err {diag_err:.3e} ({'bitwise' if diag_err == 0 else 'not bitwise'})")
    if not torch.equal(diag, first_pose):
        raise AssertionError(f"swap grid diagonal differs from the renders: {diag_err}")

    # (b) the bound in bits per dim on the two clouds, normalized
    process = model.diffusion.process.to("cuda")
    x0 = [normalize(n, torch.from_numpy(x).cuda()) for n, x in zip(dev_state, (coords, feats))]
    generator = torch.Generator(device="cuda").manual_seed(0)
    noise = lambda shape: torch.randn(shape, generator=generator, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bpd = process.calc_bpd_loop(noise, model.diffusion.denoiser, *x0)
    torch.cuda.synchronize()
    bpd_s = time.perf_counter() - t0
    for k, v in bpd.items():
        want = (2, steps) if k.startswith(("vb", "mse", "xstart")) else (2,)
        if tuple(v.shape) != want or not torch.isfinite(v).all():
            raise AssertionError(f"bpd {k}: shape {tuple(v.shape)}, finite "
                                 f"{bool(torch.isfinite(v).all())}")
    sums = {}
    for part in ("coords", "feats"):
        total = bpd[f"total_bpd_{part}"].double()
        parts = bpd[f"vb_{part}"].double().sum(1) + bpd[f"prior_bpd_{part}"].double()
        sums[part] = float(((total - parts).abs() / total.abs()).max())
        if sums[part] > 1e-6:
            raise AssertionError(f"total_bpd_{part} != sum(vb) + prior: {sums[part]}")
    s = process.schedule

    def oracle(coords_t, feats_t, t):
        def eps(x_t, x_0):
            return ((x_t - s.sqrt_alphas_cumprod[t].reshape(-1, 1, 1) * x_0)
                    / s.sqrt_one_minus_alphas_cumprod[t].reshape(-1, 1, 1))
        return eps(coords_t, x0[0]), eps(feats_t, x0[1])

    ora = process.calc_bpd_loop(noise, oracle, *x0)
    ora_max = {k: float(ora[k][:, :-1].abs().max() if k.startswith("vb") else ora[k].abs().max())
               for k in ora if k.startswith(("vb", "mse", "xstart"))}
    print(f"[diffusion-options] calc_bpd_loop: {steps} denoiser forwards at batch 2 in "
          f"{bpd_s:.2f} s ({bpd_s / out['sample_s']:.3f} x the sampler), finite; total_bpd "
          f"coords {bpd['total_bpd_coords'].tolist()} feats {bpd['total_bpd_feats'].tolist()}, "
          f"prior {bpd['prior_bpd_coords'].tolist()} / {bpd['prior_bpd_feats'].tolist()}; "
          f"total vs sum(vb) + prior rel err {sums['coords']:.2e} / {sums['feats']:.2e} (tol "
          f"1e-6); oracle denoiser max |KL (t > 0)|, |mse|, |xstart_mse| "
          + ", ".join(f"{k} {v:.2e}" for k, v in ora_max.items()) + " (tol 1e-4)")
    bad = {k: v for k, v in ora_max.items() if v > 1e-4}
    if bad:
        raise AssertionError(f"the oracle denoiser's bound is not ~0: {bad}")

    # (c) the render's matmul precision: highest, then tensorfloat32, twice
    poses = np.load(ROOT / "data/srncars_test_poses.npy")[:4].astype(np.float32)
    intr = np.load(ROOT / "data/srncars_test_intrinsics.npy")[:4].astype(np.float32)
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    cfg = model.pointnerf.cfg
    renders, rates = {}, {}
    for value in ("highest", "tensorfloat32") * 2:
        model.pointnerf.cfg = dataclasses.replace(cfg, matmul_precision=value)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        renders[value] = render(model, coords, feats, poses, intr, 128, "cuda")["channels"]
        torch.cuda.synchronize()
        rates.setdefault(value, []).append(renders[value].shape[:3].numel()
                                           / (time.perf_counter() - t0))
        if (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) != flags:
            raise AssertionError(f"TF32 flags not restored after the {value} render")
    model.pointnerf.cfg = cfg
    tf32_err = _err(renders["tensorfloat32"], renders["highest"])
    tf32_db = _psnr_db(renders["tensorfloat32"], renders["highest"])
    print(f"[diffusion-options] render 2 x 4 poses at 128^2, rays/s: highest "
          + " / ".join(f"{r:.0f}" for r in rates["highest"]) + ", tensorfloat32 "
          + " / ".join(f"{r:.0f}" for r in rates["tensorfloat32"])
          + f"; tensorfloat32 vs highest max_abs_err {tf32_err:.3e} (> 0, tol 1e-2), "
          f"{tf32_db:.2f} dB (>= 40); TF32 flags restored {flags}")
    if not 0 < tf32_err <= 1e-2 or tf32_db < 40:
        raise AssertionError(f"tensorfloat32 render: max_abs_err {tf32_err}, {tf32_db} dB")
    # (d) the overlapped FID extractor beside a tensorfloat32 render
    res = 128
    proj = np.random.default_rng(0).normal(size=(res * res * 3, FID_FEATURES)).astype(np.float32)
    real = np.random.default_rng(1).uniform(0, 1, (64, res * res * 3)).astype(np.float32) @ proj
    with open(out_dir / "real_stats.pkl", "wb") as f:
        pickle.dump({"mean": real.mean(0), "cov": np.cov(real, rowvar=False), "feats_np": real}, f)
    probe = _FlagProbe(ProjectionExtractor(proj, "cuda"))
    ev = DiffusionEvaluation(num_samples=2, poses=poses, intrinsics=intr,
                             inception_pkl_path=str(out_dir / "real_stats.pkl"),
                             feature_extractor=probe, generate_batch_size=2,
                             render_pose_batch=4, render_object_batch=1, resolution=res,
                             verbose=False, overlap_extraction=True, device="cuda")
    clouds = (torch.from_numpy(coords).cuda(), torch.from_numpy(feats).cuda())
    ev.generate = lambda *_: clouds
    inside, orig_render = [], pointnerf_module.PointNeRF._render

    def render_flags(self, *a):
        inside.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return orig_render(self, *a)

    model.pointnerf.cfg = dataclasses.replace(cfg, matmul_precision="tensorfloat32")
    pointnerf_module.PointNeRF._render = render_flags
    try:
        fid = ev(model, state, noise=lambda shape: None, kid_seed=0)
    finally:
        pointnerf_module.PointNeRF._render = orig_render
        model.pointnerf.cfg = cfg
    print(f"[diffusion-options] DiffusionEvaluation, render at tensorfloat32, extractor "
          f"overlapped: flags inside the {len(inside)} renders {sorted(set(inside))}, at the "
          f"extractor's {len(probe.seen)} feeds {sorted(set(probe.seen))} (want off: "
          f"{flags}); fid {fid['fid']:.4f}")
    if inside != [(True, True)] * 2 or set(probe.seen) != {flags} or flags != (False, False):
        raise AssertionError(f"TF32 flags: renders {inside}, extractor {sorted(set(probe.seen))}")
    if not np.isfinite(list(fid.values())).all():
        raise AssertionError(f"non-finite FID/KID {fid}")
    sample_s = out["sample_s"]
    launches = _read_launches()
    del out, model, renders, bpd, ora, x0, diag, first_pose, ev, clouds
    torch.cuda.empty_cache()
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"launches": launches, "sample_s": sample_s, "bpd_s": bpd_s}


# -- phase 26: data parallelism ---------------------------------------------------------------


def _rss_mib() -> float:
    """This process's resident host memory now, MiB (/proc/self/statm;
    getrusage's ru_maxrss keeps the parent's peak across a spawned worker's
    exec, and the card's host has no VmHWM)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def _timed_reduces(log: list):
    """Mesh.all_reduce_ timed (host clock between synchronizes) into ``log``
    as (bytes, ms, axis); -> the original, to restore."""
    orig = Mesh.all_reduce_

    def timed(self, t, axis=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, t, axis)
        torch.cuda.synchronize()
        log.append((t.numel() * t.element_size(), 1e3 * (time.perf_counter() - t0), axis))
        return out
    Mesh.all_reduce_ = timed
    return orig


def _warm_output_proj(trainer) -> None:
    """output_proj drawn nonzero from a seed (U(+-1/sqrt(width)), as
    init_seeded draws the other layers), in the parameters and the EMAs.
    init_scratch zeroes it: the first step would then train output_proj
    alone and the next ones pass the rest a gradient scaled by its lr-sized
    weights, so that the losses and grad_norm of a few steps would see
    nothing of the rest. output_proj is replicated under tp: every rank
    draws the same values into its own buffers."""
    g = torch.Generator().manual_seed(27)
    bufs = [trainer.flat.params] + ([] if trainer.emas is None else list(trainer.emas))
    views = trainer.flat.as_dict(trainer.flat.params)
    bound = views["output_proj.weight"].shape[1] ** -0.5
    with torch.no_grad():
        for name in ("output_proj.weight", "output_proj.bias"):
            shape = views[name].shape
            value = ((torch.rand(shape, generator=g) * 2 - 1) * bound).to(views[name].device)
            for buf in bufs:
                trainer.flat.as_dict(buf)[name].copy_(value)


def _dp_stage2_trainer(out: Path, mesh=None, tp: int = 1, layers: int | None = None,
                       dtype: str = "float16", warm: bool = False, split: int = 1):
    """Stage 2 at full width as train_diffusion --dtype ``dtype`` builds it
    (float16: bf16 compute, f32 master weights, block remat), on phase 26's
    seeded latent tables; ``mesh`` or one process, ``tp`` its
    tensor-parallel degree, ``layers`` the depth (the config's when None),
    ``warm`` output_proj drawn nonzero (``_warm_output_proj``), ``split`` > 1
    the products split as that tp splits them, in one process
    (tests/tp_split_control.py)."""
    config = load_config(str(SRNCARS))
    if layers is not None:
        config["model"]["layers"] = layers
    dataset, _ = train_diffusion.load_pointnerf_weights(
        str(OUT / "dp" / "pointnerf.npz"), config["model"]["num_points"],
        config["model"]["feats_dim"])
    compute, remat = train_diffusion.DTYPES[dtype]
    model = build_diffusion_model(config, torch_dtype(compute), remat)
    trainer = DiffusionTraining(str(out), model, dataset, seed=0,
                                device=mesh.device if mesh else "cuda", verbose=False, mesh=mesh,
                                tp=tp, **config["diffusion_training"])
    if warm:
        _warm_output_proj(trainer)
    if split > 1:
        split_products(trainer.model.denoiser, split)
    return trainer, dataset


def _dp_stage1_trainer(out: Path, mesh=None, shard_tables: bool = False):
    """Fast stage 1 (configs/npcd_srncars_fast.yaml) as train_pointnerf
    builds it, over phase 12's seeded dataset of 2347 clouds; ``mesh`` or
    one process, the tables row-sharded with ``shard_tables``."""
    config = load_config(str(FAST))
    dataset = _stage1_dataset(config, config["model"]["n_obj"], 50)
    model = build_pointnerf(config, torch.Generator().manual_seed(0), with_tables=True)
    return PointNeRFTraining(str(out), model, dataset,
                             loss_weights=PointNeRFLossWeights(1.0, 1e-7, 3.5e-7),
                             seed=0, device=mesh.device if mesh else "cuda", verbose=False,
                             mesh=mesh, shard_tables=shard_tables,
                             **config["pointnerf_training"]), dataset


def _dp_steps(trainer, dataset, batches, mesh=None, params_path=None) -> dict:
    """train_step on this rank's rows of each global batch (indices) -> each
    step's metrics and seconds, the gradient reduces (and the model axis's,
    under tp), the launches, peak memory and RSS; with ``params_path`` the
    parameters (whole: the tp shards and the table rows gathered) are saved
    there (rank 0); the replicated ones are compared bitwise with rank 0's
    (the others)."""
    reduces: list = []
    orig = _timed_reduces(reduces)
    loader = BatchLoader(dataset, len(batches[0]))
    steps = []
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        for idx in batches:
            rows = idx[mesh.rows(len(idx))] if mesh else idx
            n = len(reduces)
            t0 = time.perf_counter()
            m = trainer.train_step(loader.batch(rows))
            torch.cuda.synchronize()
            model = [r for r in reduces[n:] if r[2] == "model"]
            big = max((r for r in reduces[n:] if r[2] != "model"),
                      default=(0, 0.0, None))  # the gradients' reduce
            steps.append({"s": time.perf_counter() - t0, "reduce_bytes": big[0],
                          "reduce_ms": big[1], "model_reduces": len(model),
                          "model_bytes": sum(r[0] for r in model),
                          "model_ms": sum(r[1] for r in model),
                          **{k: float(v) for k, v in m.items()}})
        launches = _read_launches()
        peak_mib = torch.cuda.max_memory_allocated() / 2**20  # the steps', not the gather's
    finally:
        Mesh.all_reduce_ = orig
    if isinstance(trainer, DiffusionTraining):
        params = trainer._full(trainer.flat.params).detach() if params_path else None
        mine = trainer.flat.params.detach()
        if trainer.tp_layout is not None:  # the leaves every model rank holds whole
            mine = mine[trainer.tp_layout.replicated_index(mine.device)]
    else:
        table = trainer.model.tables.feats_table
        params = torch.cat([(trainer._whole(p) if p is table else p).detach().reshape(-1)
                            for p in trainer.model.parameters()])
        mine = params
    same = None
    if mesh is not None:
        ref = mine.clone()
        mesh.broadcast_(ref)
        same = torch.equal(ref, mine)
        del ref
    if params_path is not None and (mesh is None or mesh.is_main):
        torch.save(params.cpu(), params_path)
    return {"steps": steps, "launches": launches, "same_as_rank0": same, "peak_mib": peak_mib,
            "rss_mib": _rss_mib()}


def _dp_worker(batches2: list, batches1: list) -> dict:
    """Phase 26's two gloo ranks on one card: the stage-2 and fast stage-1
    steps on each rank's rows of the global batches."""
    mesh = make_mesh("cuda", backend="gloo")
    exact_f32()
    out = {"world": mesh.world, "backend": mesh.backend}
    dp = OUT / "dp"
    trainer, dataset = _dp_stage2_trainer(dp / "gloo-stage2", mesh)
    out["stage2"] = _dp_steps(trainer, dataset, batches2, mesh, dp / "stage2-dp.pt")
    del trainer, dataset
    torch.cuda.empty_cache()
    trainer, dataset = _dp_stage1_trainer(dp / "gloo-stage1", mesh)
    out["stage1"] = _dp_steps(trainer, dataset, batches1, mesh, dp / "stage1-dp.pt")
    return out


def _write_config(config, path: Path) -> str:
    """A loaded config (with overrides) as a yaml file that load_config
    reads back (tuples as !!python/tuple) -> its path."""
    plain = lambda o: ({k: plain(v) for k, v in o.items()} if isinstance(o, dict) else
                       type(o)(plain(v) for v in o) if isinstance(o, (list, tuple)) else o)
    path.write_text(yaml.dump(plain(config), Dumper=yaml.Dumper))
    return str(path)


def _dp_cli_worker(cut_config: str, weights: str, pkl: str) -> dict:
    """Phase 26's five CLIs with --mesh, in a worker a card (NCCL), each
    with the launch counts of its run: through main(argv), with the
    config's overrides in a file, except the two stage-1 CLIs, which take
    the seeded clouds in memory."""
    dp = OUT / "dp"
    res, runs = {}, {}

    def cli(name, fn):
        reduces: list = []
        orig = _timed_reduces(reduces)
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            t0 = time.perf_counter()
            value = fn()
            torch.cuda.synchronize()
        finally:
            Mesh.all_reduce_ = orig
        runs[name] = {"launches": _read_launches(), "s": time.perf_counter() - t0,
                      "peak_mib": torch.cuda.max_memory_allocated() / 2**20,
                      "rss_mib": _rss_mib(), "reduces": reduces}
        return value

    # fast stage 1 over the first DP_STAGE1_OBJECTS objects, then its PSNR eval
    config = load_config(str(FAST))
    config["pointnerf_training"].update(max_epochs=1, print_interval=1, log_scalars_interval=1)
    full = _stage1_dataset(config, config["model"]["n_obj"], 50)
    args = train_pointnerf.parse_args(["--config", str(FAST), "--output", str(dp / "cli-pn"),
                                       "--device", "cuda", "--no_tensorboard", "--seed", "0",
                                       "--mesh"])
    trainer = cli("train_pointnerf", lambda: train_pointnerf.train(
        args, config, _FirstObjects(full, DP_STAGE1_OBJECTS)))
    res["train_pointnerf"] = [h["loss"] for h in trainer.history]
    export = trainer.weights_only_path(trainer.step)
    del trainer
    psnr_ds = _stage1_dataset(config, config["model"]["n_obj"], PSNR_VIEWS)
    args = eval_pointnerf.parse_args([
        "--config", str(FAST), "--weights", export, "--output", str(dp / "cli-psnr"),
        "--device", "cuda", "--no_tensorboard", "--num_samples", str(PSNR_OBJECTS),
        "--num_qualitatives", "1", "--mesh"])
    res["eval_pointnerf"] = cli("eval_pointnerf",
                                lambda: eval_pointnerf.evaluate(args, config, psnr_ds))["summary"]

    # stage 2 at full width, bf16 (the CLI's default --dtype)
    config = load_config(str(SRNCARS))
    config["diffusion_training"].update(max_iterations=DP_CLI_STEPS, print_interval=1,
                                        log_scalars_interval=1)
    argv = ["--config", _write_config(config, dp / "cli-diffusion.yaml"), "--pointnerf_weights",
            str(dp / "pointnerf.npz"), "--device", "cuda", "--no_tensorboard", "--seed", "0"]
    hist = cli("train_diffusion", lambda: train_diffusion.main(
        argv + ["--output", str(dp / "cli-diffusion"), "--mesh"]).history)
    res["train_diffusion"] = hist
    shutil.rmtree(dp / "cli-diffusion", ignore_errors=True)  # the 4.8 GB checkpoint
    import torch.distributed as dist

    if dist.get_rank() == 0:  # the same steps without --mesh in this process, for the steps/s
        res["train_diffusion_one"] = train_diffusion.main(
            argv + ["--output", str(dp / "cli-diffusion-one")]).history
        shutil.rmtree(dp / "cli-diffusion-one", ignore_errors=True)

    # the full-width 1000-step sampler, 2 samples, one rendered from 2 poses
    argv = ["--config", str(SRNCARS), "--out", str(dp / "cli-gen"), "--weights", weights,
            "--num", "2", "--batch-size", "2", "--seed", "0", "--render", "1",
            "--render-poses", "2", "--poses", str(ROOT / "data/srncars_test_poses.npy"),
            "--intrinsics", str(ROOT / "data/srncars_test_intrinsics.npy"), "--resolution",
            "128", "--device", "cuda", "--mesh"]
    gen = cli("generate_samples", lambda: generate_samples.main(argv))
    res["generate_samples"] = {"coords": gen["coords"], "feats": gen["feats"],
                               "sample_s": gen["sample_s"]}
    del gen

    # FID eval at full width and DP_EVAL_LAYERS blocks
    config = load_config(cut_config)
    config["diffusion_evaluation"].update(
        num_samples=2, generate_batch_size=2, max_poses=DP_FID_POSES, resolution=128,
        feature_extractor=f"random_projection:{FID_FEATURES}", inception_pkl_path=pkl,
        poses_path=str(ROOT / "data/srncars_test_poses.npy"),
        intrinsics_path=str(ROOT / "data/srncars_test_intrinsics.npy"))
    argv = ["--config", _write_config(config, dp / "cli-fid.yaml"), "--weights",
            str(dp / "cut.npz"), "--output", str(dp / "cli-fid"), "--device", "cuda",
            "--no_tensorboard", "--seed", "0", "--num_qualitatives", "1", "--mesh"]
    res["eval_diffusion"] = cli("eval_diffusion", lambda: eval_diffusion.main(argv))
    return {"results": res, "runs": runs, "world": dist.get_world_size(),
            "backend": dist.get_backend()}


def phase_dp() -> tuple:
    """Phase 26, data parallelism (npcd_tpu_torch/parallel): two ranks on
    the one card over gloo against one process, then the five CLIs with
    --mesh over NCCL at one rank a card -> the launches of each DP path, and
    what phase 27 compares with (the one-process runs, the DP ranks, the
    batches; their files stay under OUT / "dp" for it)."""
    dp = OUT / "dp"
    shutil.rmtree(dp, ignore_errors=True)
    dp.mkdir(parents=True)
    config = load_config(str(SRNCARS))
    _seeded_pointnerf_npz(config, dp / "pointnerf.npz")
    rng = np.random.default_rng(0)
    n_obj = config["model"]["n_obj"]
    b2 = config["diffusion_training"]["batch_size"]
    b1 = load_config(str(FAST))["pointnerf_training"]["batch_size"]
    batches2 = [rng.permutation(n_obj)[:b2] for _ in range(DP_STEPS)]
    batches1 = [np.arange(i * b1, (i + 1) * b1) for i in range(DP_STEPS)]
    lr2 = config["diffusion_training"]["base_learning_rate"]
    lr1 = load_config(str(FAST))["pointnerf_training"]["base_learning_rate"]
    exact_f32()

    # (a) one process, then two gloo ranks sharing the card, same global batches
    one = {}
    for tag, make, batches in (("stage2", _dp_stage2_trainer, batches2),
                               ("stage1", _dp_stage1_trainer, batches1)):
        trainer, dataset = make(dp / f"one-{tag}")
        one[tag] = _dp_steps(trainer, dataset, batches, None, dp / f"{tag}-one.pt")
        del trainer, dataset
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_module.LAUNCH_TIMEOUT_S = 900.0  # a hung phase fails inside the run's limit
    ranks = launch(_dp_worker, (batches2, batches1), world=2)
    gloo_s = time.perf_counter() - t0
    failures = []
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[dp] (a) world {ranks[0]['world']}, backend {ranks[0]['backend']}, both ranks on "
          f"one card ({smi}): these numbers measure the code path, not scaling; "
          f"{gloo_s:.1f} s with the workers' start")
    limits = {"stage2": (lr2, f"bf16 stage 2 at full width, batch {b2} = 2 x {b2 // 2}"),
              "stage1": (lr1, f"fast stage 1, B {b1} x V 50 = 2 x {b1 // 2}")}
    for tag, (lr, what) in limits.items():
        ref = one[tag]
        for r, rank in enumerate(ranks):
            got = rank[tag]
            per = got["steps"]
            print(f"[dp] {tag} rank {r} ({what}): gradient all-reduce a step "
                  + ", ".join(f"{s['reduce_bytes'] / 2**20:.2f} MiB in {s['reduce_ms']:.1f} ms"
                              for s in per)
                  + f"; steps/s over steps 2-{DP_STEPS} {(DP_STEPS - 1) / sum(s['s'] for s in per[1:]):.3f}"
                  f" (one process {(DP_STEPS - 1) / sum(s['s'] for s in ref['steps'][1:]):.3f});"
                  f" peak {got['peak_mib']:.0f} MiB (one process {ref['peak_mib']:.0f}), host RSS"
                  f" after the steps {got['rss_mib']:.0f} MiB; parameters bitwise rank 0's: "
                  f"{got['same_as_rank0']}")
            if r and not got["same_as_rank0"]:
                failures.append(f"{tag}: rank {r}'s parameters differ from rank 0's")
        per = ranks[0][tag]["steps"]
        keys = [k for k in per[0] if k not in REDUCE_KEYS]
        for k in keys:
            got_v = [s[k] for s in per]
            want_v = [s[k] for s in ref["steps"]]
            rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got_v, want_v))
            tol = DP_TOLERANCE[tag, "grad_norm" if k == "grad_norm" else "loss"]
            print(f"[dp] {tag} {k}: 2 ranks " + " ".join(f"{v:.6g}" for v in got_v)
                  + ", one process " + " ".join(f"{v:.6g}" for v in want_v)
                  + f"; max rel err {rel:.2e} (tol {tol:g})")
            if not (np.isfinite(got_v).all() and rel <= tol):
                failures.append(f"{tag} {k}: rel err {rel}")
        a = torch.load(dp / f"{tag}-dp.pt").cuda()
        b = torch.load(dp / f"{tag}-one.pt").cuda()
        d = (a - b).abs()
        near = float((d <= 0.1 * lr).float().mean())
        print(f"[dp] {tag} parameters after {DP_STEPS} steps, 2 ranks vs one process: "
              f"{d.numel()} values, max |diff| {float(d.max()):.3e} (tol {2 * DP_STEPS * lr:.1e}:"
              f" 2 lr a step, a near-zero gradient of the other sign), share within 0.1 lr "
              f"{near:.6f} (tol >= 0.99), bitwise equal {float((d == 0).float().mean()):.6f}")
        if float(d.max()) > 2 * DP_STEPS * lr or near < 0.99:
            failures.append(f"{tag} parameters: max {float(d.max())}, within 0.1 lr {near}")
        del a, b, d
        torch.cuda.empty_cache()

    # (b) the five CLIs with --mesh, a worker a card over NCCL
    weights = OUT / "seeded_npcd.npz"
    if not weights.exists():  # phase 5 writes it
        write_seeded_weights(str(SRNCARS), str(weights), seed=0)
    text = SRNCARS.read_text()
    if text.count("    layers: 24\n") != 1:
        raise AssertionError(f"{SRNCARS}: expected one 'layers: 24'")
    (dp / "cut.yaml").write_text(text.replace("    layers: 24\n",
                                              f"    layers: {DP_EVAL_LAYERS}\n"))
    write_seeded_weights(str(dp / "cut.yaml"), str(dp / "cut.npz"), seed=0)
    res = 128
    proj = np.random.default_rng(0).normal(size=(res * res * 3, FID_FEATURES)).astype(np.float32)
    real = np.random.default_rng(1).uniform(0, 1, (64, res * res * 3)).astype(np.float32) @ proj
    with open(dp / "real_stats.pkl", "wb") as f:
        pickle.dump({"mean": real.mean(0), "cov": np.cov(real, rowvar=False), "feats_np": real}, f)
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    clis = launch(_dp_cli_worker, (str(dp / "cut.yaml"), str(weights),
                                   str(dp / "real_stats.pkl")), world=world)
    cli_s = time.perf_counter() - t0
    c0 = clis[0]
    print(f"[dp] (b) the five CLIs with --mesh: world {c0['world']}, backend {c0['backend']}, "
          f"{cli_s:.1f} s with the workers' start ({smi})")
    for name, run in c0["runs"].items():
        big = [r for r in run["reduces"] if r[0] >= 2**20]
        print(f"[dp] {name} --mesh: {run['s']:.1f} s, peak {run['peak_mib']:.0f} MiB, host RSS "
              f"after it {run['rss_mib']:.0f} MiB"
              + (f"; gradient all-reduces " + ", ".join(f"{b / 2**20:.2f} MiB in {ms:.2f} ms"
                                                         for b, ms, _ in big)
                 + (" (world 1: no collective runs)" if c0["world"] == 1 else "")
                 if big else ""))
    out = c0["results"]
    hist, hist1 = out["train_diffusion"], out["train_diffusion_one"]
    rate = lambda h: 3 / (h[-1]["time"] - h[-4]["time"])
    print(f"[dp] train_diffusion --mesh (bf16, batch {b2}, world {c0['world']} over "
          f"{c0['backend']}): {rate(hist):.3f} steps/s over steps {DP_CLI_STEPS - 2}-"
          f"{DP_CLI_STEPS}, then without --mesh in the same process {rate(hist1):.3f}; loss "
          + " ".join(f"{h['loss']:.5f}" for h in hist)
          + ", grad_norm " + " ".join(f"{h['grad_norm']:.5f}" for h in hist))
    gen = out["generate_samples"]
    print(f"[dp] train_pointnerf --mesh loss " + " ".join(f"{v:.6g}" for v in
                                                         out["train_pointnerf"])
          + f"; eval_pointnerf --mesh PSNR {out['eval_pointnerf']['psnr']:.4f}; "
          f"generate_samples --mesh sampler {gen['sample_s']:.1f} s; eval_diffusion --mesh "
          + " ".join(f"{k} {v:.6g}" for k, v in out["eval_diffusion"].items()))
    if c0["world"] == 1:  # more ranks take other batches (each its loader shard)
        rel = max(abs(a["loss"] - b["loss"]) / b["loss"] for a, b in zip(hist, hist1))
        print(f"[dp] train_diffusion with and without --mesh at world 1: losses "
              f"{'bitwise equal' if rel == 0 else f'max rel err {rel:.2e}'} (tol 1e-5)")
        if rel > 1e-5:
            failures.append(f"train_diffusion --mesh against no mesh: loss rel err {rel}")
    finite = [np.isfinite([h["loss"] for h in hist] + [h["grad_norm"] for h in hist]).all(),
              np.isfinite(out["train_pointnerf"]).all(),
              np.isfinite(out["eval_pointnerf"]["psnr"]),
              np.isfinite(gen["coords"]).all() and np.isfinite(gen["feats"]).all(),
              np.isfinite(list(out["eval_diffusion"].values())).all()]
    if not all(finite):
        failures.append(f"non-finite CLI outputs: {finite}")
    for path in ("cli-gen/samples.npz", "cli-gen/sample0000.png", "cli-fid/results.json",
                 "cli-psnr/results.json", "cli-pn/cmd.txt"):
        if not (dp / path).exists():
            failures.append(f"missing {dp / path}")
    if MAIN_SAMPLES.get("argv") == (str(weights), 0, 2, 2):
        err = max(_err(torch.from_numpy(gen["coords"]), torch.from_numpy(MAIN_SAMPLES["coords"])),
                  _err(torch.from_numpy(gen["feats"]), torch.from_numpy(MAIN_SAMPLES["feats"])))
        print(f"[dp] generate_samples --mesh samples vs phase 5's (the same seed and weights): "
              f"max_abs_err {err:.3e} (tol 1e-4)")
        if err > 1e-4:
            failures.append(f"generate --mesh vs phase 5: {err}")
    if failures:
        raise AssertionError(f"phase 26: {failures}")

    total = lambda runs: {k: sum(r[k] for r in runs) for k in runs[0]}
    launches = {
        "dp stage 2": total([r["stage2"]["launches"] for r in ranks]
                            + [c["runs"]["train_diffusion"]["launches"] for c in clis]),
        "dp fast stage 1": total([r["stage1"]["launches"] for r in ranks]
                                 + [c["runs"]["train_pointnerf"]["launches"] for c in clis]),
        "dp sampling": total([c["runs"]["generate_samples"]["launches"] for c in clis]),
        "dp fid eval": total([c["runs"]["eval_diffusion"]["launches"] for c in clis]),
        "dp psnr eval": total([c["runs"]["eval_pointnerf"]["launches"] for c in clis])}
    torch.cuda.empty_cache()
    return launches, {"one": one, "ranks": ranks, "batches2": batches2, "batches1": batches1,
                      "lr2": lr2, "lr1": lr1, "smi": smi}


# -- phase 27: tensor parallelism and row-sharded tables ------------------------------------


def _tp_worker(batches2: list, batches1: list, cli_argv: list) -> dict:
    """Phase 27's two gloo ranks on one card: (a) the bf16 stage-2 steps at
    tp 2, then its control, the first step with the planted fault (b)
    (torch.distributed.nn's all_reduce as the "g" operator, whose backward
    sums the cotangent again), (b) the f32 steps at tp 2 and TP_F32_LAYERS
    blocks, (d) the fast stage-1 steps with the tables row-sharded, on each
    rank's rows of the global batches, then (e) train_diffusion --tp 2
    through main(argv) (joining this group)."""
    import torch.distributed.nn.functional as dist_fn
    from npcd_tpu_torch.models.diffusion import transformer

    mesh = make_mesh("cuda", backend="gloo")
    exact_f32()
    tp_dir = OUT / "tp"
    out = {"world": mesh.world, "backend": mesh.backend}
    trainer, dataset = _dp_stage2_trainer(tp_dir / "stage2", mesh, tp=2, warm=True)
    out["stage2"] = _dp_steps(trainer, dataset, batches2, trainer.mesh, tp_dir / "stage2-tp.pt")
    out["stage2"]["local_params"] = trainer.flat.params.numel()
    del trainer, dataset
    torch.cuda.empty_cache()
    reduce = transformer.tp_reduce
    transformer.tp_reduce = lambda y, m: dist_fn.all_reduce(y, group=m.model_group)
    try:
        trainer, dataset = _dp_stage2_trainer(tp_dir / "fault", mesh, tp=2, warm=True)
        out["fault"] = _dp_steps(trainer, dataset, batches2[:1], trainer.mesh)
    finally:
        transformer.tp_reduce = reduce
    del trainer, dataset
    torch.cuda.empty_cache()
    trainer, dataset = _dp_stage2_trainer(tp_dir / "f32", mesh, tp=2, layers=TP_F32_LAYERS,
                                          dtype="float32", warm=True)
    out["f32"] = _dp_steps(trainer, dataset, batches2, trainer.mesh, tp_dir / "f32-tp.pt")
    del trainer, dataset
    torch.cuda.empty_cache()
    trainer, dataset = _dp_stage1_trainer(tp_dir / "stage1", mesh, shard_tables=True)
    out["stage1"] = _dp_steps(trainer, dataset, batches1, mesh, tp_dir / "stage1-sharded.pt")
    tables = trainer.model.tables
    moments = trainer.optimizer.state[tables.feats_table]
    out["stage1"].update(rows=tables.feats_table.shape[0], own=(trainer.own.start,
                                                                trainer.own.stop),
                         table_bytes=sum(t.numel() * t.element_size() for t in (
                             tables.feats_table, tables.coords_table, moments["exp_avg"],
                             moments["exp_avg_sq"])))
    del trainer, dataset, tables, moments
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    hist = train_diffusion.main(cli_argv).history
    torch.cuda.synchronize()
    out["cli"] = {"history": hist, "launches": _read_launches(), "s": time.perf_counter() - t0,
                  "peak_mib": torch.cuda.max_memory_allocated() / 2**20}
    return out


def phase_tp(ref: dict, results: dict) -> dict:
    """Phase 27, tensor parallelism and row-sharded tables
    (npcd_tpu_torch/parallel/tp.py, tp_step.py, pointnerf_sharding.py):
    K1f/K1b in the local-head form, then two gloo ranks on the one card
    against one process (stage 2 from a warm output_proj, on phase 26's
    batches and draws; stage 1 phase 26's run, in ``ref``), and
    train_diffusion --tp 2 -> the launches of the paths "tp stage 2" and
    "sharded fast stage 1"."""
    dp, tp_dir = OUT / "dp", OUT / "tp"
    shutil.rmtree(tp_dir, ignore_errors=True)
    tp_dir.mkdir(parents=True)
    smi = ref["smi"]
    exact_f32()
    failures = []

    # (c) K1f/K1b as a model rank of tp 2 launches them: 8 heads in 1 group,
    # qkv [32*520, 1536], against their plain versions as phases 4 and 14
    # hold the 16-head form (f32 also against float64)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(27)
    randn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    local = {}
    b, seq, valid = 32, 520, 513
    suffix = " (8 heads, G 1)"
    _k1_f32_checks(lambda *a, **k: _record(local, *a, tag="tp-tables", **k), randn, b, seq, 8,
                   512, valid, 1, suffix)
    _k1_bf16_checks(lambda *a, **k: _record(local, *a, tag="tp-tables", peak=BF16_FLOP_S, **k),
                    randn, b, seq, 8, 512, valid, 1, suffix)
    for name16 in ("fused_qkv_attention (with lse)", "fused_qkv_attention_bwd",
                   "fused_qkv_attention (bf16)", "fused_qkv_attention_bwd (bf16)"):
        got, full = local[name16 + suffix], results.get(name16)
        print(f"[tp-tables] {name16}{suffix}: {got['ms']:.4f} ms (bound {got['bound_ms']:.4f}, "
              f"plain {got['plain_ms']:.4f}, library {got['library_ms']:.4f}); the 16-head "
              f"form of phase 4/14 "
              + (f"{full['ms']:.4f} ms" if full else "not run") + f" ({smi})")
    torch.cuda.empty_cache()

    # (a)'s and (b)'s references, one process on phase 26's batches and
    # draws, output_proj warm: bf16 at full width, plain and with tp 2's
    # split products and their roundings (tests/tp_split_control.py); f32
    # at TP_F32_LAYERS blocks
    batches2, batches1 = ref["batches2"], ref["batches1"]
    refs = {}
    for tag, kw in (("stage2-one", {}), ("stage2-split", {"split": 2}),
                    ("f32-one", {"layers": TP_F32_LAYERS, "dtype": "float32"})):
        trainer, dataset = _dp_stage2_trainer(tp_dir / tag, None, warm=True, **kw)
        refs[tag] = _dp_steps(trainer, dataset, batches2, None, tp_dir / f"{tag}.pt")
        del trainer, dataset
        torch.cuda.empty_cache()
    one2, split_one, one_f32 = refs["stage2-one"], refs["stage2-split"], refs["f32-one"]

    # (e)'s run: train_diffusion --tp 2 at full width, TP_CLI_LAYERS blocks
    config = load_config(str(SRNCARS))
    config["model"]["layers"] = TP_CLI_LAYERS
    config["diffusion_training"].update(max_iterations=TP_CLI_STEPS, print_interval=1,
                                        log_scalars_interval=1)
    cut = _write_config(config, tp_dir / "cli.yaml")
    argv = ["--config", cut, "--pointnerf_weights", str(dp / "pointnerf.npz"), "--device",
            "cuda", "--no_tensorboard", "--seed", "0", "--tp", "2"]

    t0 = time.perf_counter()
    mesh_module.LAUNCH_TIMEOUT_S = 900.0
    ranks = launch(_tp_worker, (batches2, batches1, argv + ["--output", str(tp_dir / "cli")]),
                   world=2)
    print(f"[tp-tables] world {ranks[0]['world']}, backend {ranks[0]['backend']}, both ranks on "
          f"one card ({smi}): these numbers measure the code path, not scaling; "
          f"{time.perf_counter() - t0:.1f} s with the workers' start")

    # (a), (b), (d): each step's metrics against one process. (a) is held
    # to phase 26's limits against its split-product control; against the
    # plain one process it may be as far apart as the control is, plus
    # those limits
    one = {"stage2": one2, "stage1": ref["one"]["stage1"]}
    s2 = (DP_TOLERANCE["stage2", "loss"], DP_TOLERANCE["stage2", "grad_norm"])
    tp2 = ranks[0]["stage2"]["steps"]
    apart = {}  # the split control's max rel err against one process, by metric
    cases = [("stage2", "2 ranks", tp2, "the split control", split_one["steps"], s2),
             ("stage2", "the split control", split_one["steps"], "one process",
              one["stage2"]["steps"], None),
             ("stage2", "2 ranks", tp2, "one process", one["stage2"]["steps"], "apart"),
             ("f32", "2 ranks", ranks[0]["f32"]["steps"], "one process", one_f32["steps"],
              (1e-5, 1e-4)),
             ("stage1", "2 ranks", ranks[0]["stage1"]["steps"], "one process",
              one["stage1"]["steps"], (DP_TOLERANCE["stage1", "loss"],
                                       DP_TOLERANCE["stage1", "grad_norm"]))]
    what = {"stage2": "bf16 stage 2 at full width, tp 2, batch 32",
            "f32": f"f32 stage 2 at full width, {TP_F32_LAYERS} blocks, tp 2, batch 32",
            "stage1": "fast stage 1 with row-sharded tables, B 8 x V 50 = 2 x 4"}
    for tag, name, got, against, want, tols in cases:
        for k in (k for k in got[0] if k not in REDUCE_KEYS):
            got_v, want_v = [x[k] for x in got], [x[k] for x in want]
            rel = max(abs(a - b_) / max(abs(b_), 1e-30) for a, b_ in zip(got_v, want_v))
            i_tol = 1 if k == "grad_norm" else 0
            tol = (None if tols is None else apart[k] + s2[i_tol] if tols == "apart"
                   else tols[i_tol])
            if tols is None:
                apart[k] = rel
            print(f"[tp-tables] {tag} {k}: {name} " + " ".join(f"{v:.6g}" for v in got_v)
                  + f", {against} " + " ".join(f"{v:.6g}" for v in want_v)
                  + f"; max rel err {rel:.2e} ("
                  + ("a reading" if tol is None else f"tol {tol:.3g}") + ")")
            if not (np.isfinite(got_v).all() and (tol is None or rel <= tol)):
                failures.append(f"{tag} {k}, {name} against {against}: rel err {rel}")
    # the planted fault (b) must miss (a)'s grad_norm limit at its first step
    # (its forward, and so its loss, is (a)'s)
    fault = ranks[0]["fault"]["steps"][0]
    for against, want in (("one process", one["stage2"]), ("the split control", split_one)):
        w = want["steps"][0]
        rel = abs(fault["grad_norm"] / w["grad_norm"] - 1)
        print(f"[tp-tables] planted fault (b), the \"g\" reduce summed again in the backward: "
              f"step 1 grad_norm {fault['grad_norm']:.6g}, {against} {w['grad_norm']:.6g}, rel "
              f"err {rel:.2e} (must pass {s2[1]:g}); loss {fault['loss']:.6g} against "
              f"{w['loss']:.6g}")
        if not rel > s2[1]:
            failures.append(f"planted fault (b) within (a)'s grad_norm limit of {against}: {rel}")
    for tag in what:
        want = one_f32 if tag == "f32" else one[tag]
        for r, rank in enumerate(ranks):
            got = rank[tag]
            rate = lambda steps: (len(steps) - 1) / sum(x["s"] for x in steps[1:])
            reduces = ", ".join(f"{x['model_reduces']} x {x['model_bytes'] / 2**20:.1f} MiB in "
                                f"{x['model_ms']:.0f} ms" for x in got["steps"])
            print(f"[tp-tables] {tag} rank {r} ({what[tag]}): "
                  + (f"model-group reduces a step {reduces}; " if tag != "stage1" else
                     f"table rows {got['rows']} ({got['own'][0]}:{got['own'][1]}), tables and "
                     f"moments {got['table_bytes'] / 2**20:.1f} MiB; ")
                  + f"steps/s over steps 2-{len(got['steps'])} {rate(got['steps']):.3f} (one "
                  f"process {rate(want['steps']):.3f}); peak {got['peak_mib']:.0f} MiB (one "
                  f"process {want['peak_mib']:.0f}"
                  + (f", phase 26's replicated-table rank "
                     f"{ref['ranks'][r]['stage1']['peak_mib']:.0f}" if tag == "stage1" else "")
                  + f"); {'replicated ' if tag != 'stage1' else ''}parameters bitwise rank 0's: "
                  f"{got['same_as_rank0']}")
            if r and not got["same_as_rank0"]:
                failures.append(f"{tag}: rank {r}'s parameters differ from rank 0's")
    # the parameters after the steps: every one within 2 lr a step (a
    # near-zero gradient of the other sign flips Adam's first steps), and
    # >= 99% within 0.1 lr; the split control's share against one process
    # is a reading, beside (a)'s
    for tag, lr, got, want, gate in (
            ("stage2 vs the split control", ref["lr2"], tp_dir / "stage2-tp.pt",
             tp_dir / "stage2-split.pt", True),
            ("the split control vs one process", ref["lr2"], tp_dir / "stage2-split.pt",
             tp_dir / "stage2-one.pt", False),
            ("stage2 vs one process", ref["lr2"], tp_dir / "stage2-tp.pt",
             tp_dir / "stage2-one.pt", True),
            ("f32 vs one process", ref["lr2"], tp_dir / "f32-tp.pt", tp_dir / "f32-one.pt", True),
            ("stage1 vs one process", ref["lr1"], tp_dir / "stage1-sharded.pt",
             dp / "stage1-one.pt", True)):
        d = (torch.load(got).cuda() - torch.load(want).cuda()).abs()
        share = float((d <= 0.1 * lr).float().mean())
        print(f"[tp-tables] {tag}, parameters after {DP_STEPS} steps: {d.numel()} values, max "
              f"|diff| {float(d.max()):.3e} (tol {2 * DP_STEPS * lr:.1e}), share within 0.1 lr "
              f"{share:.6f} (" + ("tol >= 0.99" if gate else "a reading") + "), bitwise "
              f"equal {float((d == 0).float().mean()):.6f}")
        if float(d.max()) > 2 * DP_STEPS * lr or (gate and share < 0.99):
            failures.append(f"{tag} parameters: max {float(d.max())}, within 0.1 lr {share}")
        del d
        torch.cuda.empty_cache()

    # (e) the CLI's run: finite, its checkpoint and export whole, restored at tp 1
    cli = ranks[0]["cli"]
    hist = cli["history"]
    print(f"[tp-tables] train_diffusion --tp 2 (gloo, 2 ranks, bf16, full width, "
          f"{TP_CLI_LAYERS} blocks): {cli['s']:.1f} s, peak {cli['peak_mib']:.0f} MiB, loss "
          + " ".join(f"{h['loss']:.5f}" for h in hist) + ", grad_norm "
          + " ".join(f"{h['grad_norm']:.5f}" for h in hist))
    if len(hist) != TP_CLI_STEPS or not np.isfinite([h["loss"] for h in hist]).all():
        failures.append(f"train_diffusion --tp 2: history {hist}")
    dataset, _ = train_diffusion.load_pointnerf_weights(
        str(dp / "pointnerf.npz"), config["model"]["num_points"], config["model"]["feats_dim"])
    compute, remat = train_diffusion.DTYPES["float16"]
    one_rank = DiffusionTraining(str(tp_dir / "cli"), build_diffusion_model(
        config, torch_dtype(compute), remat), dataset, seed=0, device="cuda", verbose=False,
        **config["diffusion_training"])
    export = tp_dir / "cli" / "weights_only_checkpoints_dir" / f"npcd-iter-{TP_CLI_STEPS:09d}.npz"
    with np.load(export) as z:
        same = all(np.array_equal(z[f"diffusion.denoiser.{n}"], v.cpu().numpy())
                   for n, v in one_rank.flat.as_dict(one_rank.flat.params).items())
    print(f"[tp-tables] a tp=1 trainer restores the --tp 2 checkpoint: step {one_rank.step}, "
          f"parameters bitwise the export's: {same}")
    if one_rank.step != TP_CLI_STEPS or not same:
        failures.append(f"tp=1 restore of the --tp 2 checkpoint: step {one_rank.step}, {same}")
    del one_rank, dataset
    torch.cuda.empty_cache()
    # --tp 2 over NCCL on the one card: a group of one, npcd_tpu's ValueError
    import torch.distributed as dist

    try:
        train_diffusion.main(argv + ["--output", str(tp_dir / "nccl")])
        failures.append("train_diffusion --tp 2 over NCCL on one card did not raise")
    except ValueError as e:
        print(f"[tp-tables] train_diffusion --tp 2 over NCCL on {torch.cuda.device_count()} "
              f"card: ValueError({e})")
        if "tp=2 does not divide device count 1" not in str(e):
            failures.append(f"--tp 2 over NCCL: {e}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        raise AssertionError(f"phase 27: {failures}")
    total = lambda runs: {k: sum(r[k] for r in runs) for k in runs[0]}
    launches = {"tp stage 2": total([r["stage2"]["launches"] for r in ranks]
                                    + [r["cli"]["launches"] for r in ranks]),
                "sharded fast stage 1": total([r["stage1"]["launches"] for r in ranks])}
    shutil.rmtree(tp_dir, ignore_errors=True)
    shutil.rmtree(dp, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def phase_fid_inception() -> dict:
    """Phase 28: the FID eval through a full-width keras-weights InceptionV3
    (see the module docstring)."""
    out = OUT / "fid-eval-inception"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    weights = OUT / "seeded_npcd.npz"
    if not weights.exists():  # phase 5 writes it
        write_seeded_weights(str(SRNCARS), str(weights), seed=0)
    res = 128
    keras = random_weights(0)
    ext = KerasInceptionExtractor(keras, batch_size=INCEPTION_BATCH, device="cuda")
    reals = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (64, res, res, 3)).astype(np.float32)).cuda()
    real = ext(reals)
    pkl = out / "real_stats.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"mean": real.mean(0), "cov": np.cov(real, rowvar=False), "feats_np": real}, f)

    fed = []

    class Feed:  # the extractor, and what the eval fed it
        device_resident = True

        def __call__(self, images):
            fed.append((images.is_cuda, tuple(images.shape)))
            return ext(images)

    config = load_config(str(SRNCARS))
    config["diffusion_evaluation"].update(
        num_samples=2, generate_batch_size=2, max_poses=FID_POSES, resolution=res,
        feature_extractor=Feed(), inception_pkl_path=str(pkl),
        poses_path=str(ROOT / "data/srncars_test_poses.npy"),
        intrinsics_path=str(ROOT / "data/srncars_test_intrinsics.npy"))
    args = eval_diffusion.parse_args([
        "--config", str(SRNCARS), "--weights", str(weights), "--output", str(out / "run"),
        "--device", "cuda", "--no_tensorboard", "--seed", "0", "--num_qualitatives", "1"])
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    results = eval_diffusion.evaluate(args, config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_launches()
    print(f"[fid-eval-inception] 2 samples x {FID_POSES} SRN test poses at {res}^2, InceptionV3 "
          f"at 299^2 (seeded keras weights), batch {INCEPTION_BATCH}, fed {fed}: "
          + " ".join(f"{k} {v:.6g}" for k, v in results.items())
          + f"; {wall:.1f} s with the model's build and load")
    if fed != [(True, (2 * FID_POSES, res, res, 3))] or not np.isfinite(
            list(results.values())).all() or not np.isfinite(real).all() or real.std() == 0:
        raise AssertionError(f"FID eval through InceptionV3: fed {fed}, {results}")

    # the extractor alone: a batch of the renders' size
    x = reals[:INCEPTION_BATCH]

    def tf32_features(images):  # the control: the extractor's network with cuDNN's TF32 on
        saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            return inception_v3_features(ext.params, resize(images) * 2.0 - 1.0)
        finally:
            torch.backends.cudnn.allow_tf32 = saved

    def median_ms(features) -> float:
        for _ in range(3):
            features(x)
        times = []
        for _ in range(INCEPTION_RUNS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            features(x)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    ms, ms_tf32 = median_ms(ext.features), median_ms(tf32_features)
    flops = INCEPTION_BATCH * conv_flops()
    moved = 4 * (x.numel() + sum(w.numel() + b.numel() for w, b in ext.params)
                 + INCEPTION_BATCH * ext.feature_dim)
    bound_ms = 1e3 * max(flops / FP32_FLOP_S, moved / HBM_BYTES_S)
    rate = INCEPTION_BATCH / ms * 1e3
    print(f"[fid-eval-inception] extractor, a batch of {INCEPTION_BATCH} at {res}^2 -> 299^2: "
          f"{ms:.4f} ms (median of {INCEPTION_RUNS}), {rate:.1f} images/s; FP32 bound "
          f"{bound_ms:.4f} ms ({flops / 1e12:.4f} TFLOP at 67 TFLOP/s; {moved / 1e6:.1f} MB), "
          f"{100 * bound_ms / ms:.1f}% of it; the protocol's {PROTOCOL_IMAGES} images "
          f"{PROTOCOL_IMAGES / rate:.1f} s; with cuDNN's TF32 on {ms_tf32:.4f} ms")

    four = x[:4]
    cpu = KerasInceptionExtractor(keras, device="cpu")(four.cpu().numpy())
    flags = torch.backends.cudnn.allow_tf32
    card = ext(four)
    if torch.backends.cudnn.allow_tf32 != flags:
        raise AssertionError("the extractor did not restore cuDNN's TF32 flag")
    with torch.no_grad():
        card_tf32 = tf32_features(four).cpu().numpy()
    scale = float(np.abs(cpu).max())
    err = float(np.abs(card - cpu).max()) / scale
    err_tf32 = float(np.abs(card_tf32 - cpu).max()) / scale
    print(f"[fid-eval-inception] card vs the port's CPU features (4 images, scale {scale:.4f}): "
          f"max_abs_err {err:.3e} of the scale (gate {INCEPTION_GATE:g}); the TF32 control "
          f"{err_tf32:.3e} (must exceed the gate)")
    if not (np.isfinite(card).all() and err <= INCEPTION_GATE < err_tf32):
        raise AssertionError(f"InceptionV3 on the card: {err} (TF32 {err_tf32}) of the scale")
    del ext, reals, x, four
    torch.cuda.empty_cache()
    shutil.rmtree(out, ignore_errors=True)
    return {"launches": launches}


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
    results.update(_timed("kernels-forms", phase_form_kernels))
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
    paths["fid eval"] = (_timed("fid-eval", phase_fid_eval)["launches"], FID_EVAL)
    paths["psnr eval"] = (_timed("psnr-eval", phase_psnr_eval)["launches"], PSNR_EVAL)
    paths["srn fast stage 1"] = (_timed("srn-fast-stage1", phase_srn_stage1)["launches"],
                                 FAST_STAGE1)
    paths["reference weights"] = (_timed("reference-weights", phase_reference_weights)["launches"],
                                  REFERENCE_WEIGHTS)
    paths["options V"] = (_timed("options-V", phase_options, "V")["launches"], OPTIONS_V)
    paths["options O"] = (_timed("options-O", phase_options, "O")["launches"], OPTIONS_O)
    paths["D"] = (_timed("diffusion-options", phase_diffusion_options)["launches"],
                  DIFFUSION_OPTIONS)
    dp, dp_ref = _timed("dp", phase_dp)
    paths.update({path: (dp[path], names) for path, names in (
        ("dp stage 2", TRAINING_BF16), ("dp fast stage 1", FAST_STAGE1),
        ("dp sampling", GENERATION), ("dp fid eval", DP_FID), ("dp psnr eval", DP_PSNR))})
    tp = _timed("tp-tables", phase_tp, dp_ref, results)
    paths.update({"tp stage 2": (tp["tp stage 2"], TRAINING_BF16),
                  "sharded fast stage 1": (tp["sharded fast stage 1"], FAST_STAGE1)})
    paths["fid eval inception"] = (_timed("fid-eval-inception", phase_fid_inception)["launches"],
                                   FID_INCEPTION)
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

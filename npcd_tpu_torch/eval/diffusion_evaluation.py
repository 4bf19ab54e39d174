"""Stage-2 evaluation: generate -> render from fixed test poses -> FID/KID.
Port of npcd_tpu/eval/diffusion_evaluation.py: sample ``num_samples``
neural point clouds in ``generate_batch_size`` groups, render
``render_object_batch`` of them x ``render_pose_batch`` poses a call (251
SRN test poses at 128² in the protocol), clip and quantize to 255 levels on
the device, and feed the images to the feature extractor into FID/KID
against precomputed real statistics.

A device-resident extractor (TorchScript Inception or the random
projection, utils/fidkid.py) takes the quantized renders as a tensor on the
device; any other callable takes numpy. With ``overlap_extraction`` one
worker thread feeds the extractor, at most two groups in flight, while the
next group renders; its exceptions are raised in the caller. Where the
render's ``matmul_precision`` flips PyTorch's process-wide TF32 flags, the
extractor finishes each group before the next render starts, so that its
GEMMs and convolutions keep the flags set outside the render. Results go to
``results.json`` and ``results.csv`` in ``out_dir``, and a run whose
``results.json`` exists is skipped. ``mesh`` (data parallelism) is not
ported.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import os.path as osp
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..generate_samples import write_png
from ..models.diffusion.diffusion_model import split_num
from ..models.pointnerf.pointnerf import changes_tf32_flags
from ..utils import logging, writer
from ..utils.builders import torch_dtype
from ..utils.fidkid import FIDKID, ProjectionExtractor, TorchScriptInceptionExtractor
from ..utils.util import chunks, write_csv


def quantize(channels: torch.Tensor) -> torch.Tensor:
    """Renders clipped to [0, 1] and rounded to 255 levels, round(x * 255) /
    255 as npcd_tpu computes it in numpy. The divisor is a tensor on the
    renders' device: PyTorch's CUDA division by a Python scalar multiplies by
    its reciprocal, which can be an ulp off x / 255."""
    x = torch.round(channels.clamp(0.0, 1.0) * 255.0)
    return x / torch.full((), 255.0, dtype=x.dtype, device=x.device)


class DiffusionEvaluation:
    def __init__(
        self,
        out_dir: Optional[str] = None,
        num_samples: int = 1000,
        poses_path: Optional[str] = None,
        intrinsics_path: Optional[str] = None,
        inception_pkl_path: Optional[str] = None,
        inception_path: Optional[str] = "data/inception-2015-12-05.pt",
        feature_extractor: Optional[Callable] = None,
        generate_batch_size: int = 16,
        render_pose_batch: int = 32,
        render_object_batch: int = 4,
        resolution: int = 128,
        poses: Optional[np.ndarray] = None,
        intrinsics: Optional[np.ndarray] = None,
        max_poses: Optional[int] = None,
        verbose: bool = True,
        mesh=None,
        render_dtype=None,
        overlap_extraction: bool = True,
        device="cuda",
    ):
        """npcd_tpu's arguments, plus ``device``, where the extractors built
        here run. ``render_dtype`` None or "float32": the model's own render
        precision; "bfloat16": the render's MLPs in bf16."""
        if mesh is not None:
            raise NotImplementedError("mesh: the data-parallel eval is ROADMAP Queue 1 item 7 "
                                      "('Data parallelism'), not ported yet")
        self.out_dir = out_dir
        self.num_samples = num_samples
        self.generate_batch_size = generate_batch_size
        self.render_pose_batch = render_pose_batch
        self.render_object_batch = render_object_batch
        self.resolution = resolution
        self.verbose = verbose
        self.inception_pkl_path = inception_pkl_path
        self.render_dtype = (torch_dtype(render_dtype) if isinstance(render_dtype, str)
                             else render_dtype)
        self.overlap_extraction = overlap_extraction
        self.device = torch.device(device)

        poses = poses if poses is not None else np.load(poses_path)
        intrinsics = intrinsics if intrinsics is not None else np.load(intrinsics_path)
        self.poses = np.asarray(poses, np.float32)[:max_poses]
        self.intrinsics = np.asarray(intrinsics, np.float32)[:max_poses]

        if isinstance(feature_extractor, str):
            kind, _, arg = feature_extractor.partition(":")
            if kind == "random_projection":
                proj = np.random.default_rng(0).normal(
                    size=(resolution * resolution * 3, int(arg or 8))).astype(np.float32)
                feature_extractor = ProjectionExtractor(proj, self.device)
            elif kind == "inception_jax":
                raise ValueError(
                    "feature_extractor='inception_jax': npcd_tpu's JAX InceptionV3 reads keras "
                    "h5 weights with JAX and h5py and is not ported; the port's device-resident "
                    "extractor is the TorchScript graph ('inception_torchscript[:path]')")
            elif kind == "inception_torchscript":
                feature_extractor = TorchScriptInceptionExtractor(arg or inception_path,
                                                                  device=self.device)
            else:
                raise ValueError(f"unknown feature_extractor: {feature_extractor!r}")
        if feature_extractor is None:
            if not osp.isfile(inception_path):
                raise FileNotFoundError(
                    f"Inception TorchScript graph not found at {inception_path!r}; "
                    "download it (ASSETS.md) or pass feature_extractor.")
            feature_extractor = TorchScriptInceptionExtractor(inception_path, device=self.device)
        self.feature_extractor = feature_extractor

    def generate(self, model, state, num: int, noise: Callable) -> tuple:
        """``num`` clouds in one sampler batch -> (coords [num, 3, P],
        feats [num, F, P]) on the model's device."""
        return model.diffusion.generate_batch(state, num, noise)

    def render_objects(self, pointnerf, coords: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
        """Clouds coords [g, P, 3], feats [g, P, F] from every pose,
        ``render_pose_batch`` poses a call -> channels [g, V, H*W, 3]."""
        g = coords.shape[0]
        poses = torch.as_tensor(self.poses, device=coords.device)
        intr = torch.as_tensor(self.intrinsics, device=coords.device)
        channels = []
        for idx in chunks(range(len(self.poses)), self.render_pose_batch):
            sl = slice(idx[0], idx[-1] + 1)
            channels.append(pointnerf.render(
                coords, feats, poses[None, sl].expand(g, -1, -1, -1).contiguous(),
                intr[None, sl].expand(g, -1, -1, -1).contiguous(),
                resolution=self.resolution)["channels"])
        return torch.cat(channels, 1)

    @torch.no_grad()
    def __call__(self, model, diffusion_state, generator: Optional[torch.Generator] = None,
                 noise: Optional[Callable] = None, num_qualitatives: int = 10,
                 kid_seed: Optional[int] = None) -> Dict[str, float]:
        """FID/KID of ``num_samples`` clouds generated by ``model`` (an
        ``NPCD``) with the normalizer stats ``diffusion_state``. Draws come
        from ``noise`` (a function of the shape, as ``generate_batch``
        takes it) or else from ``generator``; KID's subsets from
        ``kid_seed`` (None: fresh, as npcd_tpu's)."""
        results_file = None
        if self.out_dir is not None:
            os.makedirs(self.out_dir, exist_ok=True)
            results_file = osp.join(self.out_dir, "results.json")
            if osp.exists(results_file):
                logging.info("Diffusion evaluation already finished; skipping.")
                with open(results_file) as f:
                    return json.load(f)

        device = next(model.parameters()).device
        if noise is None:
            if generator is None:
                raise ValueError("the evaluation needs a torch.Generator or a noise function")
            noise = lambda shape: torch.randn(shape, generator=generator, device=device)
        fidkid = FIDKID(num_images=self.num_samples * len(self.poses),
                        feature_extractor=self.feature_extractor,
                        inception_pkl=self.inception_pkl_path)
        fidkid.prepare()

        pointnerf = model.pointnerf
        if self.render_dtype is not None:
            pointnerf = copy.copy(pointnerf)
            pointnerf.cfg = dataclasses.replace(pointnerf.cfg, compute_dtype=self.render_dtype)

        n_img = len(self.poses)
        res = self.resolution
        stride = max(1, self.num_samples // max(num_qualitatives, 1))
        device_feed = getattr(self.feature_extractor, "device_resident", False)

        def process_group(images_q: torch.Tensor, first_idx: int) -> None:
            """Feed one quantized group [g, V, H*W, 3] and write its
            qualitatives (the first 4 poses side by side)."""
            g = images_q.shape[0]
            images = images_q.reshape(g * n_img, res, res, 3)
            fidkid.feed(images if device_feed else images.cpu().numpy(), "fakes")
            if self.out_dir is not None:
                for j in range(g):
                    if (first_idx + j) % stride == 0:
                        img = images_q[j, :4].reshape(-1, res, res, 3).cpu().numpy()
                        write_png(osp.join(self.out_dir, f"sample{first_idx + j:04d}.png"),
                                  np.concatenate(list(img), axis=1))

        executor, futures = None, []
        if self.overlap_extraction:
            from concurrent.futures import ThreadPoolExecutor

            executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="fid-extract")
        # a render whose matmul_precision flips the process-wide TF32 flags
        # would flip them under the extractor too: then the extractor
        # finishes before each render starts
        serial_render = changes_tf32_flags(pointnerf.cfg.matmul_precision)
        try:
            done = 0
            for n_gen in split_num(self.num_samples, self.generate_batch_size):
                coords_b, feats_b = self.generate(model, diffusion_state, n_gen, noise)
                for j0 in range(0, n_gen, self.render_object_batch):
                    sl = slice(j0, j0 + self.render_object_batch)
                    while serial_render and futures:
                        futures.pop(0).result()
                    channels = self.render_objects(
                        pointnerf, coords_b[sl].transpose(1, 2).contiguous(),
                        feats_b[sl].transpose(1, 2).contiguous())
                    images_q = quantize(channels)
                    if executor is None:
                        process_group(images_q, done)
                    else:
                        while len(futures) >= 2:  # bound the image backlog
                            futures.pop(0).result()
                        futures.append(executor.submit(process_group, images_q, done))
                    done += images_q.shape[0]
                if self.verbose:
                    logging.info(f"diffusion eval: {done}/{self.num_samples} objects")
            for f in futures:  # drain; re-raises the worker's exceptions
                f.result()
        finally:
            if executor is not None:
                executor.shutdown(wait=True, cancel_futures=True)

        results = fidkid.summary(kid_seed)
        logging.info(f"Diffusion evaluation results: {results}")
        writer.put_scalar_dict("eval/diffusion/unconditional_generation", results, 0)
        writer.write_out_storage()
        if results_file is not None:
            with open(results_file, "w") as f:
                json.dump(results, f, indent=1)
            # one metric a row, as pandas writes a Series named "metric"
            write_csv(osp.join(self.out_dir, "results.csv"), ["", "metric"], results.items())
        return results

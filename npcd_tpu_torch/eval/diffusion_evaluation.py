"""Stage-2 evaluation: generate -> render from fixed test poses -> FID/KID.
Port of npcd_tpu/eval/diffusion_evaluation.py: sample ``num_samples``
neural point clouds in ``generate_batch_size`` groups, render
``render_object_batch`` of them x ``render_pose_batch`` poses a call (251
SRN test poses at 128² in the protocol), clip and quantize to 255 levels on
the device, and feed the images to the feature extractor into FID/KID
against precomputed real statistics.

A device-resident extractor (the TorchScript Inception or the random
projection of utils/fidkid.py, or ``inception_jax:<weights.h5>``'s
keras-weights InceptionV3 of utils/inception_keras.py) takes the quantized
renders as a tensor on the device; any other callable takes numpy. With ``overlap_extraction`` one
worker thread feeds the extractor, at most two groups in flight, while the
next group renders; its exceptions are raised in the caller. Where the
render's ``matmul_precision`` flips PyTorch's process-wide TF32 flags, the
extractor finishes each group before the next render starts, so that its
GEMMs and convolutions keep the flags set outside the render. Results go to
``results.json`` and ``results.csv`` in ``out_dir``, and a run whose
``results.json`` exists is skipped.

With ``mesh`` (parallel.Mesh) the objects shard over the ranks, as
npcd_tpu's mesh shards them: ``generate_batch_size`` and
``render_object_batch`` are rounded up to multiples of the world, each rank
samples its rows of every generate batch (from the batch's noise drawn whole
on every rank; an indivisible tail batch is sampled whole by every rank and
its objects split), renders its objects and runs the extractor on them, and
rank 0 gathers the features in the global object order, computes FID/KID and
writes the files.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import os.path as osp
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..generate_samples import write_png
from ..models.diffusion.diffusion_model import sharded_noise, split_num
from ..models.pointnerf.pointnerf import changes_tf32_flags
from ..parallel import is_main, mesh_world
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
        precision; "bfloat16": the render's MLPs in bf16. ``mesh``: a
        parallel.Mesh (data parallelism)."""
        self.out_dir = out_dir
        self.mesh = mesh
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
        world = mesh_world(mesh)
        if generate_batch_size % world or render_object_batch % world:
            up = lambda v: max(world, -(-v // world) * world)
            self.generate_batch_size = up(generate_batch_size)
            self.render_object_batch = up(render_object_batch)
            logging.info(f"diffusion eval on {world} ranks: batch sizes rounded to generate="
                         f"{self.generate_batch_size}, render_objects={self.render_object_batch}")

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
            elif kind == "inception_jax":  # npcd_tpu's name for the keras-weights InceptionV3
                if not arg:
                    raise ValueError("feature_extractor='inception_jax' needs a weights file: "
                                     "pass 'inception_jax:<keras_weights.h5>'")
                from ..utils.inception_keras import KerasInceptionExtractor

                feature_extractor = KerasInceptionExtractor(arg, device=self.device)
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
        ``kid_seed`` (None: fresh, as npcd_tpu's). Under a mesh every rank
        returns rank 0's results."""
        mesh = self.mesh
        main = is_main(mesh)
        results_file = None
        if self.out_dir is not None:
            results_file = osp.join(self.out_dir, "results.json")
            if osp.exists(results_file):
                logging.info("Diffusion evaluation already finished; skipping.")
                with open(results_file) as f:
                    return json.load(f)
            if main:
                os.makedirs(self.out_dir, exist_ok=True)

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
        world = mesh_world(mesh)
        # the global index of each object whose features this rank fed, in
        # feed order, and the qualitatives it rendered for rank 0 to write
        fed, qualitatives = [], []

        def process_group(images_q: torch.Tensor, objects: List[int]) -> None:
            """Feed one quantized group [g, V, H*W, 3] of the objects
            ``objects`` and keep its qualitatives (the first 4 poses side by
            side)."""
            g = images_q.shape[0]
            images = images_q.reshape(g * n_img, res, res, 3)
            fidkid.feed(images if device_feed else images.cpu().numpy(), "fakes")
            fed.extend(objects)
            if self.out_dir is not None:
                for j, idx in enumerate(objects):
                    if idx % stride == 0:
                        img = images_q[j, :4].reshape(-1, res, res, 3).cpu().numpy()
                        qualitatives.append((idx, np.concatenate(list(img), axis=1)))

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
                if mesh is None:
                    mine = np.arange(n_gen)
                    coords_b, feats_b = self.generate(model, diffusion_state, n_gen, noise)
                elif n_gen % world == 0:  # this rank's rows of the batch
                    mine = np.arange(n_gen)[mesh.rows(n_gen)]
                    coords_b, feats_b = self.generate(model, diffusion_state, len(mine),
                                                      sharded_noise(noise, mesh))
                else:  # the indivisible tail: sampled whole, rendered in parts
                    part = mesh.rows(n_gen, uneven=True)
                    mine = np.arange(n_gen)[part]
                    if len(mine):
                        coords_b, feats_b = self.generate(model, diffusion_state, n_gen, noise)
                        coords_b, feats_b = coords_b[part], feats_b[part]
                step = self.render_object_batch // world
                for j0 in range(0, len(mine), step):
                    sl = slice(j0, j0 + step)
                    while serial_render and futures:
                        futures.pop(0).result()
                    channels = self.render_objects(
                        pointnerf, coords_b[sl].transpose(1, 2).contiguous(),
                        feats_b[sl].transpose(1, 2).contiguous())
                    images_q = quantize(channels)
                    objects = [done + int(i) for i in mine[sl]]
                    if executor is None:
                        process_group(images_q, objects)
                    else:
                        while len(futures) >= 2:  # bound the image backlog
                            futures.pop(0).result()
                        futures.append(executor.submit(process_group, images_q, objects))
                done += n_gen
                if self.verbose:
                    logging.info(f"diffusion eval: {done}/{self.num_samples} objects")
            for f in futures:  # drain; re-raises the worker's exceptions
                f.result()
        finally:
            if executor is not None:
                executor.shutdown(wait=True, cancel_futures=True)

        if mesh is not None:
            fidkid.gather_fakes(mesh, fed, n_img)
            parts = mesh.gather_objects(qualitatives, to_main=True)
            qualitatives = sorted((q for part in parts or [] for q in part), key=lambda q: q[0])
        results = None
        if main:
            results = fidkid.summary(kid_seed)
            logging.info(f"Diffusion evaluation results: {results}")
            writer.put_scalar_dict("eval/diffusion/unconditional_generation", results, 0)
            writer.write_out_storage()
            if self.out_dir is not None:
                for idx, img in qualitatives:
                    write_png(osp.join(self.out_dir, f"sample{idx:04d}.png"), img)
                with open(results_file, "w") as f:
                    json.dump(results, f, indent=1)
                # one metric a row, as pandas writes a Series named "metric"
                write_csv(osp.join(self.out_dir, "results.csv"), ["", "metric"], results.items())
        if mesh is not None:
            results = mesh.gather_objects(results)[0]
        return results


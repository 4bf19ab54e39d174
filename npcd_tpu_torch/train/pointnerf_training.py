"""Stage-1 (PointNeRF autodecoder) training loop. Port of
npcd_tpu/train/pointnerf_training.py: Adam at a constant learning rate
(optax's adam: b1 0.9, b2 0.999, eps 1e-8, dense: every row of the feats
table decays and moves every step) over the variational feats table and the
three MLPs, optionally after optax's clip_by_global_norm; the coords table
is a buffer seeded once from the dataset and never updated. Loss =
reconstruction + KL + TV (losses/pointnerf_loss.py).

One step: the host presamples one shared subset of ``ray_subsamples``
pixels (``np.random.default_rng(seed + 0x51D).choice``, npcd_tpu's draw)
and ships only those ground-truth pixels; the forward draws feats eps,
depth jitter and the ray-selection scores from a torch.Generator seeded
from (seed, step), as the stage-2 trainer does (npcd_tpu draws them from
fold_in(PRNGKey(seed), step), which torch cannot reproduce; the tests
replay JAX's draws through ``train_step``'s ``draws``). The batch order
comes from a numpy generator seeded with ``seed``. Checkpoints hold the
model, Adam's state, the step and the presample generator's state, so a
resumed run takes the same steps as an uninterrupted one.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..data import BatchLoader
from ..losses import PointNeRFLossWeights, pointnerf_loss
from ..models.pointnerf.pointnerf import PointNeRF
from ..utils import logging, writer
from ..utils.checkpoint import CheckpointSaver, timed_save_due
from ..utils.from_jax import LATENTS, save_npz
from .diffusion_training import _step_seed


class PointNeRFTraining:
    def __init__(
        self,
        out_dir: str,
        model: PointNeRF,
        dataset,
        batch_size: int,
        base_learning_rate: float,
        max_epochs: int,
        loss_weights: PointNeRFLossWeights = PointNeRFLossWeights(1.0, 1e-7, 3.5e-7),
        grad_clip_max_norm: Optional[float] = None,
        seed: int = 42,
        device: str | torch.device = "cpu",
        print_interval: int = 100,
        log_scalars_interval: int = 100,
        save_checkpoint_interval_min: float = 20.0,
        verbose: bool = True,
        **_,
    ):
        """``model``: a PointNeRF with its latent tables (n_obj objects) and
        ``renderer.ray_subsamples`` set (the pixels presampled per step)."""
        self.out_dir = out_dir
        self.checkpoints_dir = os.path.join(out_dir, "checkpoints")
        self.weights_dir = os.path.join(out_dir, "weights_only_checkpoints_dir")
        os.makedirs(self.checkpoints_dir, exist_ok=True)
        os.makedirs(self.weights_dir, exist_ok=True)

        self.device = torch.device(device)
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_iterations = len(dataset) // batch_size * max_epochs
        self.loss_weights = loss_weights
        self.grad_clip_max_norm = grad_clip_max_norm
        self.seed = seed
        self.print_interval = print_interval
        self.log_scalars_interval = log_scalars_interval
        self.save_checkpoint_interval_min = save_checkpoint_interval_min
        self.verbose = verbose

        if model.tables is None:
            raise ValueError("PointNeRFTraining needs a PointNeRF with latent tables (n_obj)")
        if not model.opts.renderer.ray_subsamples:
            raise ValueError("PointNeRFTraining presamples renderer.ray_subsamples pixels per "
                             "step; full-frame training is not ported")
        self.model = model.to(self.device).train()
        model.set_all_coords(dataset.get_all_coords())  # npcd_tpu :119
        self.optimizer = torch.optim.Adam(model.parameters(), lr=base_learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self._presample_rng = np.random.default_rng(seed + 0x51D)
        self._generator = torch.Generator(device=self.device)
        self.step = 0
        self.history: List[Dict[str, float]] = []

        self.saver = CheckpointSaver(self.checkpoints_dir, "pointnerf_training", {})
        if self.saver.latest() is not None:
            state, it = self.saver.restore()
            self.load_state_dict(state)
            logging.info(f"Restored checkpoint at iteration {it}")
        if verbose:
            n_params = sum(p.numel() for p in model.parameters())
            logging.info(f"PointNeRFTraining: {n_params} trainable params, batch {batch_size}, "
                         f"max_iterations {self.max_iterations}, device {self.device}")

    # -- state ---------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """The full train state (tensors are the live buffers)."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step,
                "presample_rng": json.dumps(self._presample_rng.bit_generator.state)}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])
        self._presample_rng.bit_generator.state = json.loads(state["presample_rng"])

    def load_bridged_state(self, bridged: Mapping[str, Any]) -> None:
        """Start from an npcd_tpu train state carried over by
        utils/from_jax.pointnerf_train_state_from_jax."""
        named = dict(self.model.named_parameters())
        if set(bridged["mu"]) != set(named):
            raise ValueError(f"Adam moments for {sorted(bridged['mu'])}, "
                             f"parameters {sorted(named)}")
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in bridged["params"].items()})
        count = int(bridged["count"])
        with torch.no_grad():
            for name, p in named.items():
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": torch.as_tensor(bridged["mu"][name]).to(p.device).clone(),
                    "exp_avg_sq": torch.as_tensor(bridged["nu"][name]).to(p.device).clone()}
        self.step = int(bridged["step"])

    # -- step ----------------------------------------------------------------

    def train_step(self, batch: Mapping[str, np.ndarray],
                   draws: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` {obj_idx [B], images [B, V, H*W, 3],
        intrinsics [B, V, 3, 3], extrinsics [B, V, 4, 4]}: presample ->
        forward -> loss -> backward -> Adam. ``draws`` replaces draws of this
        step (pixel_idx, feats_eps, depth_jitter; see PointNeRF.forward).
        Returns the metrics as device tensors (no sync)."""
        dev = self.device
        draws = dict(draws or {})
        images = np.asarray(batch["images"])
        pixel_idx = draws.pop("pixel_idx", None)
        if pixel_idx is None:
            pixel_idx = self._presample_rng.choice(
                images.shape[2], size=self.model.opts.renderer.ray_subsamples,
                replace=False).astype(np.int32)
        pixel_idx = torch.as_tensor(pixel_idx)
        images = images[:, :, pixel_idx.cpu().numpy()]  # only these pixels go to the device
        draws = {k: torch.as_tensor(v).to(dev) for k, v in draws.items()}
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
        obj_idx = torch.as_tensor(np.asarray(batch["obj_idx"]), dtype=torch.long, device=dev)
        self.optimizer.zero_grad(set_to_none=False)
        generator = self._generator.manual_seed(_step_seed(self.seed, self.step))
        pred, aux = self.model(obj_idx, as_t(batch["intrinsics"]), as_t(batch["extrinsics"]),
                               pixel_idx, generator=generator, draws=draws)
        loss, sub_losses = pointnerf_loss({"images": as_t(images)}, pred, aux, self.model.opts,
                                          self.loss_weights)
        loss.backward()
        if self.grad_clip_max_norm:
            self._clip_by_global_norm(self.grad_clip_max_norm)
        self.optimizer.step()
        self.step += 1
        return {"loss": loss.detach(), **{k: v.detach() for k, v in sub_losses.items()}}

    def _clip_by_global_norm(self, max_norm: float) -> None:
        """optax.clip_by_global_norm: g * max_norm / |g| when |g| >= max_norm."""
        grads = [p.grad for p in self.model.parameters()]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        for g in grads:
            g.mul_(scale)

    # -- loop ----------------------------------------------------------------

    def batches(self, start: int):
        """Batches from iteration ``start`` on, epoch after epoch."""
        loader = BatchLoader(self.dataset, self.batch_size, self.seed)
        per_epoch = len(loader)
        if per_epoch == 0:
            raise ValueError(f"dataset of {len(self.dataset)} has no full batch of "
                             f"{self.batch_size}")
        epoch, skip = divmod(start, per_epoch)
        for _ in range(epoch):
            loader.epoch_order()
        while True:
            yield from loader.batches(loader.epoch_order(), skip)
            skip = 0

    def __call__(self):
        if self.step >= self.max_iterations:
            logging.info("Training already finished.")
            return self
        writer.set_max_iterations(self.max_iterations)
        it = self.step
        last_ckpt_time = time.time()
        t_print = time.perf_counter()
        for batch in self.batches(it):
            if it >= self.max_iterations:
                break
            metrics = self.train_step(batch)
            it += 1
            if it % self.print_interval == 0:
                values = {k: float(v) for k, v in metrics.items()}  # waits for the step
                now = time.perf_counter()
                dt = (now - t_print) / self.print_interval
                t_print = now
                self.history.append({"it": it, "time": now, **values})
                logging.info(f"iter {it}/{self.max_iterations} loss {values['loss']:.5f} "
                             f"({dt * 1000:.1f} ms/it)")
            if it % self.log_scalars_interval == 0:
                writer.put_scalar_dict("pointnerf_train",
                                       {k: float(v) for k, v in metrics.items()}, it)
                writer.write_out_storage()
            if timed_save_due(last_ckpt_time, self.save_checkpoint_interval_min, iteration=it):
                self.saver.save(self.state_dict(), it)
                last_ckpt_time = time.time()

        self.saver.save(self.state_dict(), it)
        self.save_weights_only(self.weights_only_path(it))
        self.saver.finish()  # the final snapshot is on disk before returning
        return self

    def weights_only_path(self, it: int) -> str:
        return os.path.join(self.weights_dir, f"pointnerf-iter-{it:09d}.npz")

    def save_weights_only(self, path: str) -> None:
        """The bridged .npz that train_diffusion --pointnerf_weights and
        generate_samples --weights read: latents.coords_table [n_obj, P, 3],
        latents.feats_table [n_obj, P, F] (the mean half) and pointnerf.*."""
        flat = {f"pointnerf.{k}": v.detach().cpu().numpy()
                for k, v in self.model.mlp_state_dict().items()}
        flat[f"{LATENTS}.coords_table"] = self.model.get_all_coords().cpu().numpy()
        flat[f"{LATENTS}.feats_table"] = self.model.get_all_feats().detach().cpu().numpy()
        save_npz(path, flat)

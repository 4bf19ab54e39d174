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
comes from a numpy generator seeded with ``seed``.

The loop feeds the step through ``prefetch_to_device`` (npcd_tpu's
``to_device``): a thread ahead of the step takes each batch's indices,
draws its pixel subset, gathers those pixels from each sample's images
and stacks them (the same values as gathering from the stacked batch,
~0.5 MB a step in place of the full frames), and copies the feed to the
device on the step's stream. Each feed carries the presample generator's
state after its own draw, and checkpoints hold the state of the last feed
the step consumed with the model, Adam's state and the step, so a resumed
run takes the same steps as an uninterrupted one. Every ``log_interval``
steps the consumed batch's first object is rendered again in eval mode
(``_log_qualitative``).

With ``mesh`` (parallel.Mesh, data parallelism) ``batch_size`` is the
global batch: each rank takes ``batch_size // world`` objects a step from
its shard of the dataset (BatchLoader's strided partition), draws the
shared pixel subset from the same generator as every other rank, and keeps
its rows of the global feats eps, depth jitter and ray scores. Its loss is
its share of the global loss (losses/pointnerf_loss.py), so the gradients
are summed over the ranks: one all-reduce of a buffer that holds the feats
table's gradient rows of this rank's objects at their places in the global
batch ([B, P, 2F], 1 MiB at B 8, beside the rows of the other ranks, which
are zero here), the objects' indices, the MLPs' gradients and the metrics;
the rows are then added back into the table's gradient at the global
batch's objects. The clip and Adam run after the reduce on every rank, so
the parameters stay equal across ranks. Rank 0 writes the checkpoints,
exports, scalars and qualitatives; the others wait for it at a barrier at
the end.

With ``shard_tables`` (npcd_tpu's shard_pointnerf_params, which its CLI
does not expose either) each rank keeps only the rows
``Mesh.rows(n_obj, uneven=True)`` of both tables and of Adam's moments of
the feats table (parallel/pointnerf_sharding.py). A step first fetches the
global batch's rows with an all-reduce of the batch's object indices and
one of the rows, each owner filling the rows it owns; the forward reads
this rank's rows of that, and their gradient takes the place of the table
gradient's rows in the reduce above, after which each owner adds the
summed rows into its shard's gradient. Adam then decays every owned row
every step, as npcd_tpu's dense adam does on the sharded table, and the
clip's norm counts each row once (one more all-reduce of the shards' sums
of squares). Checkpoints, exports and the qualitative re-render see the
rows they need: the tables are gathered whole (every rank joins, rank 0
writes) in the layout of an unsharded run, and a checkpoint of either
layout restores into the other.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from ..data import BatchLoader, collate, prefetch_to_device
from ..losses import PointNeRFLossWeights, pointnerf_loss
from ..models.pointnerf.embeddings import mean_log_var_std
from ..models.pointnerf.pointnerf import PointNeRF
from ..parallel import barrier, is_main, mesh_world, replicate
from ..parallel.pointnerf_sharding import add_rows_, fetch_rows, gather_rows, global_indices
from ..utils import logging, writer
from ..utils.checkpoint import CheckpointSaver, rank0_decides, timed_save_due
from ..utils.from_jax import LATENTS, save_npz
from ..utils.util import count_parameters, psnr
from .diffusion_training import _step_seed

FEED_KEYS = ("obj_idx", "images", "intrinsics", "extrinsics")


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
        log_interval: int = 5000,
        save_checkpoint_interval_min: float = 20.0,
        verbose: bool = True,
        mesh=None,
        shard_tables: bool = False,
        **_,
    ):
        """``model``: a PointNeRF with its latent tables (n_obj objects) and
        ``renderer.ray_subsamples`` set (the pixels presampled per step).
        ``mesh``: a parallel.Mesh whose device the trainer runs on.
        ``shard_tables``: each rank keeps its rows of the tables."""
        if batch_size % mesh_world(mesh):
            raise ValueError(f"global batch_size {batch_size} must divide by the world "
                             f"{mesh_world(mesh)}")
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
        self.log_interval = log_interval
        self.save_checkpoint_interval_min = save_checkpoint_interval_min
        self.verbose = verbose
        self.mesh = mesh

        if model.tables is None:
            raise ValueError("PointNeRFTraining needs a PointNeRF with latent tables (n_obj)")
        if not model.opts.renderer.ray_subsamples:
            raise ValueError("PointNeRFTraining presamples renderer.ray_subsamples pixels per "
                             "step; full-frame training is not ported")
        model.set_all_coords(dataset.get_all_coords())  # npcd_tpu :119
        self.n_obj = model.tables.coords_table.shape[0]
        self.own = None  # this rank's rows of the tables, when sharded
        if shard_tables:
            self.own = slice(0, self.n_obj) if mesh is None else mesh.rows(self.n_obj,
                                                                           uneven=True)
            model.tables.coords_table = model.tables.coords_table[self.own].clone()
            model.tables.feats_table = torch.nn.Parameter(
                model.tables.feats_table.detach()[self.own].clone())
        self.model = model.to(self.device).train()
        replicate([p for p in model.parameters()
                   if self.own is None or p is not model.tables.feats_table], mesh)
        self.optimizer = torch.optim.Adam(model.parameters(), lr=base_learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self._presample_rng = np.random.default_rng(seed + 0x51D)
        # the generator's state after the last draw the step consumed
        self._presample_state = json.dumps(self._presample_rng.bit_generator.state)
        self._generator = torch.Generator(device=self.device)
        self.step = 0
        self.history: List[Dict[str, float]] = []

        self.saver = CheckpointSaver(self.checkpoints_dir, "pointnerf_training", {})
        if self.saver.latest() is not None:
            state, it = self.saver.restore()
            self.load_state_dict(state)
            logging.info(f"Restored checkpoint at iteration {it}")
        if verbose:
            logging.info(f"PointNeRFTraining: {count_parameters(model)} trainable params, "
                         f"batch {batch_size}, "
                         f"max_iterations {self.max_iterations}, device {self.device}, "
                         f"world {mesh_world(mesh)}")

    # -- state ---------------------------------------------------------------

    def _table_index(self) -> int:
        """The feats table's place in the optimizer's parameter order."""
        return next(i for i, p in enumerate(self.model.parameters())
                    if p is self.model.tables.feats_table)

    def _whole(self, rows: torch.Tensor) -> torch.Tensor:
        """A table's (or a moment's) rows on this rank -> the whole table
        (gathered when sharded: every rank joins)."""
        return rows if self.own is None else gather_rows(rows, self.own, self.n_obj, self.mesh)

    def state_dict(self) -> Dict[str, Any]:
        """The full train state in the layout of an unsharded run (tensors
        are the live buffers; with sharded tables fresh whole ones: every
        rank must call it)."""
        model, optimizer = self.model.state_dict(), self.optimizer.state_dict()
        if self.own is not None:
            model = {**model, **{k: self._whole(model[k]) for k in
                                 ("tables.coords_table", "tables.feats_table")}}
            i = self._table_index()
            if i in optimizer["state"]:
                st = optimizer["state"][i]
                optimizer["state"][i] = {**st, "exp_avg": self._whole(st["exp_avg"]),
                                         "exp_avg_sq": self._whole(st["exp_avg_sq"])}
        return {"model": model, "optimizer": optimizer, "step": self.step,
                "presample_rng": self._presample_state}

    def _mine(self, full) -> torch.Tensor:
        """A whole table's (or moment's) rows of this rank."""
        full = torch.as_tensor(full)
        return full if self.own is None else full[self.own]

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy a ``state_dict`` (e.g. a restored checkpoint, sharded or
        not) into the trainer."""
        model, optimizer = dict(state["model"]), state["optimizer"]
        if self.own is not None:
            for k in ("tables.coords_table", "tables.feats_table"):
                model[k] = self._mine(model[k])
            i = self._table_index()
            if i in optimizer["state"]:
                st = optimizer["state"][i]
                optimizer = {**optimizer, "state": {**optimizer["state"], i: {
                    **st, "exp_avg": self._mine(st["exp_avg"]),
                    "exp_avg_sq": self._mine(st["exp_avg_sq"])}}}
        self.model.load_state_dict(model)
        self.optimizer.load_state_dict(optimizer)
        self.step = int(state["step"])
        self._presample_state = state["presample_rng"]
        self._presample_rng.bit_generator.state = json.loads(self._presample_state)

    def load_bridged_state(self, bridged: Mapping[str, Any]) -> None:
        """Start from an npcd_tpu train state carried over by
        utils/from_jax.pointnerf_train_state_from_jax."""
        named = dict(self.model.named_parameters())
        if set(bridged["mu"]) != set(named):
            raise ValueError(f"Adam moments for {sorted(bridged['mu'])}, "
                             f"parameters {sorted(named)}")
        rows = lambda k, v: self._mine(v) if k.startswith("tables.") else torch.as_tensor(v)
        self.model.load_state_dict({k: rows(k, v) for k, v in bridged["params"].items()})
        count = int(bridged["count"])
        with torch.no_grad():
            for name, p in named.items():
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(count)),
                    "exp_avg": rows(name, bridged["mu"][name]).to(p.device).clone(),
                    "exp_avg_sq": rows(name, bridged["nu"][name]).to(p.device).clone()}
        self.step = int(bridged["step"])

    # -- step ----------------------------------------------------------------

    def train_step(self, batch: Mapping[str, np.ndarray],
                   draws: Optional[Mapping[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` {obj_idx [B], images [B, V, H*W, 3],
        intrinsics [B, V, 3, 3], extrinsics [B, V, 4, 4]} (this rank's rows
        under a mesh): presample -> forward -> loss -> backward -> (the
        gradients' all-reduce) -> Adam. ``draws`` replaces draws of this
        step (pixel_idx, feats_eps, depth_jitter, ray_scores, those of the
        global batch; see PointNeRF.forward). Returns the metrics (global
        under a mesh) and grad_norm, the global norm of the (reduced)
        gradient before the clip, as device tensors (no sync)."""
        draws = dict(draws or {})
        images = np.asarray(batch["images"])
        pixel_idx = draws.pop("pixel_idx", None)
        if pixel_idx is None:
            pixel_idx = self._draw_pixels(images.shape[2])
        pixel_idx = np.asarray(pixel_idx)
        feed = self._to_device({**batch, "images": images[:, :, pixel_idx]}, pixel_idx)
        return self.train_feed(feed, draws)

    def _draw_pixels(self, frame_pixels: int) -> np.ndarray:
        """The step's shared pixel subset, npcd_tpu's draw."""
        return self._presample_rng.choice(
            frame_pixels, size=self.model.opts.renderer.ray_subsamples,
            replace=False).astype(np.int32)

    def _host_batch(self, indices, pixel_idx: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """FEED_KEYS of the objects ``indices``; with ``pixel_idx`` [R], images
        [n, V, R, 3] of those pixels only, gathered from each sample's own
        images before they are stacked."""
        if hasattr(self.dataset, "batch"):
            return self.dataset.batch(indices, pixel_idx)
        samples = []
        for i in indices:
            s = self.dataset[int(i)]
            images = s["images"] if pixel_idx is None else s["images"][:, pixel_idx]
            samples.append({**{k: s[k] for k in FEED_KEYS}, "images": images})
        return collate(samples)

    def _to_device(self, batch: Mapping[str, Any], pixel_idx: np.ndarray) -> Dict[str, Any]:
        """The step's inputs on the device (copied on the current stream),
        with the presample generator's state after pixel_idx's draw."""
        dev = self.device
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32).to(dev)
        return {"obj_idx": torch.as_tensor(np.asarray(batch["obj_idx"]), dtype=torch.long).to(dev),
                "images": as_t(batch["images"]), "intrinsics": as_t(batch["intrinsics"]),
                "extrinsics": as_t(batch["extrinsics"]),
                "pixel_idx": torch.as_tensor(pixel_idx).to(dev),
                "presample_state": json.dumps(self._presample_rng.bit_generator.state)}

    def _feed(self, indices) -> Dict[str, Any]:
        """npcd_tpu's ``to_device`` on the prefetch thread: the device feed
        of the objects ``indices``, its pixel subset drawn here."""
        pixel_idx = self._draw_pixels(self.model.opts.default_resolution ** 2)
        feed = self._to_device(self._host_batch(indices, pixel_idx), pixel_idx)
        feed["indices"] = indices
        return feed

    def train_feed(self, feed: Mapping[str, Any], draws: Optional[Mapping[str, Any]] = None
                   ) -> Dict[str, torch.Tensor]:
        """``train_step`` on a device feed (an item of ``feeds``)."""
        dev = self.device
        draws = {k: torch.as_tensor(v).to(dev) for k, v in (draws or {}).items()}
        self.optimizer.zero_grad(set_to_none=False)
        generator = self._generator.manual_seed(_step_seed(self.seed, self.step))
        rows = None
        if self.own is not None:  # the global batch's rows, then this rank's
            gidx = global_indices(feed["obj_idx"], self.mesh)
            tables = self.model.tables
            coords = fetch_rows(tables.coords_table, self.own, gidx, self.mesh)
            feats = fetch_rows(tables.feats_table, self.own, gidx, self.mesh).requires_grad_()
            mine = slice(None) if self.mesh is None else self.mesh.rows(len(gidx))
            rows = (gidx, feats, (coords[mine], feats[mine]))
        pred, aux = self.model(feed["obj_idx"], feed["intrinsics"], feed["extrinsics"],
                               feed["pixel_idx"], generator=generator, draws=draws,
                               mesh=self.mesh, table_rows=None if rows is None else rows[2])
        loss, sub_losses = pointnerf_loss({"images": feed["images"]}, pred, aux,
                                          self.model.opts, self.loss_weights, self.mesh)
        loss.backward()
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in sub_losses.items()}}
        if rows is not None:
            metrics = self._all_reduce_rows(rows[0], rows[1].grad, metrics)
        elif self.mesh is not None:
            metrics = self._all_reduce_sum(feed["obj_idx"], metrics)
        grads = [p.grad for p in self.model.parameters()]
        if rows is None:
            metrics["grad_norm"] = norm = torch.sqrt(sum((g * g).sum() for g in grads))
        else:  # the shards' rows summed over the ranks, counted once each
            table = self.model.tables.feats_table.grad
            table_sq = (table * table).sum().reshape(1)
            if self.mesh is not None:
                self.mesh.all_reduce_(table_sq)
            metrics["grad_norm"] = norm = torch.sqrt(
                sum((g * g).sum() for g in grads if g is not table) + table_sq[0])
        if self.grad_clip_max_norm:  # optax.clip_by_global_norm
            scale = torch.where(norm < self.grad_clip_max_norm, torch.ones_like(norm),
                                self.grad_clip_max_norm / norm)
            for g in grads:
                g.mul_(scale)
        self.optimizer.step()
        self.step += 1
        self._presample_state = feed["presample_state"]
        return metrics

    def _all_reduce_sum(self, obj_idx: torch.Tensor, metrics: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """The gradients and ``metrics`` summed over the ranks in one
        all-reduce -> the summed metrics. The feats table's gradient is
        non-zero only at the global batch's objects: each rank puts the rows
        of its objects (each once) and their indices at its places in the
        global batch, and the summed rows are added back into a zeroed
        table gradient at the summed indices."""
        mesh = self.mesh
        table = self.model.tables.feats_table
        others = [p for p in self.model.parameters() if p is not table]
        b = obj_idx.shape[0]
        n_rows = b * mesh.world
        row = table.shape[1:]
        row_numel = table[0].numel()
        n_other = sum(p.numel() for p in others)
        names = list(metrics)
        buf = torch.zeros(n_rows * row_numel + n_other + n_rows + len(names),
                          device=table.device)
        rows = buf[:n_rows * row_numel].view(n_rows, *row)
        other = buf[n_rows * row_numel:n_rows * row_numel + n_other]
        idx = buf[n_rows * row_numel + n_other:n_rows * row_numel + n_other + n_rows]
        mine = mesh.rows(n_rows)
        # an object twice in this rank's batch: its gradient row once
        repeat = (obj_idx[:, None] == obj_idx[None, :]).triu(1).any(0)
        rows[mine] = table.grad[obj_idx] * (~repeat).to(table.dtype).view(-1, *([1] * len(row)))
        torch.cat([p.grad.reshape(-1) for p in others], out=other)
        idx[mine] = obj_idx.to(idx.dtype)
        buf[-len(names):] = torch.stack([metrics[k].float() for k in names])
        mesh.all_reduce_(buf)
        table.grad.zero_()
        table.grad.index_put_((idx.long(),), rows, accumulate=True)
        offset = 0
        for p in others:
            p.grad.copy_(other[offset:offset + p.numel()].view_as(p.grad))
            offset += p.numel()
        return {k: buf[len(buf) - len(names) + i] for i, k in enumerate(names)}

    def _all_reduce_rows(self, gidx: torch.Tensor, rows_grad: torch.Tensor,
                         metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The sharded tables' reduce: the fetched rows' gradient [n x dp, P,
        2F] (this rank's rows of it nonzero), the MLPs' gradients and
        ``metrics`` summed over the ranks in one all-reduce; each owner adds
        the summed rows of its objects into its shard's zeroed gradient ->
        the summed metrics."""
        table = self.model.tables.feats_table
        others = [p for p in self.model.parameters() if p is not table]
        names = list(metrics)
        buf = torch.cat([rows_grad.reshape(-1)] + [p.grad.reshape(-1) for p in others]
                        + [torch.stack([metrics[k].float() for k in names])])
        if self.mesh is not None:
            self.mesh.all_reduce_(buf)
        n_rows = rows_grad.numel()
        if table.grad is None:  # the table is not in the autograd graph
            table.grad = torch.zeros_like(table)
        table.grad.zero_()
        add_rows_(table.grad, self.own, gidx, buf[:n_rows].view_as(rows_grad))
        offset = n_rows
        for p in others:
            p.grad.copy_(buf[offset:offset + p.numel()].view_as(p.grad))
            offset += p.numel()
        return {k: buf[offset + i] for i, k in enumerate(names)}

    # -- loop ----------------------------------------------------------------

    def index_batches(self, start: int) -> Iterator[np.ndarray]:
        """The object indices of each batch (this rank's under a mesh) from
        iteration ``start`` on, epoch after epoch."""
        loader = BatchLoader(self.dataset, self.batch_size, self.seed, mesh_world(self.mesh),
                             0 if self.mesh is None else self.mesh.rank)
        per_epoch = len(loader)
        if per_epoch == 0:
            raise ValueError(f"dataset of {len(self.dataset)} has no full batch of "
                             f"{self.batch_size}")
        epoch, skip = divmod(start, per_epoch)
        for _ in range(epoch):
            loader.epoch_order()
        while True:
            yield from loader.index_batches(loader.epoch_order(), skip)
            skip = 0

    def batches(self, start: int) -> Iterator[Dict[str, Any]]:
        """The full batches (``train_step``'s input) from iteration ``start``
        on, epoch after epoch."""
        return map(self._host_batch, self.index_batches(start))

    def feeds(self, start: int):
        """The loop's device feeds from iteration ``start`` on, prefetched on
        a thread; close it to stop that thread."""
        return prefetch_to_device(self.index_batches(start), self._feed)

    def __call__(self):
        if self.step >= self.max_iterations:
            logging.info("Training already finished.")
            return self
        writer.set_max_iterations(self.max_iterations)
        it = self.step
        main = is_main(self.mesh)
        last_ckpt_time = time.time()
        t_print = time.perf_counter()
        try:
            with contextlib.closing(self.feeds(it)) as feeds:
                for feed in feeds:
                    metrics = self.train_feed(feed)
                    it += 1
                    if it % self.print_interval == 0:
                        values = {k: float(v) for k, v in metrics.items()}  # waits for the step
                        now = time.perf_counter()
                        dt = (now - t_print) / self.print_interval
                        t_print = now
                        self.history.append({"it": it, "time": now, **values})
                        logging.info(f"iter {it}/{self.max_iterations} loss {values['loss']:.5f} "
                                     f"({dt * 1000:.1f} ms/it)")
                    if main and it % self.log_scalars_interval == 0:
                        writer.put_scalar_dict("pointnerf_train",
                                               {k: float(v) for k, v in metrics.items()}, it)
                        writer.write_out_storage()
                    if self.log_interval and it % self.log_interval == 0 and (
                            main or self.own is not None):
                        self._log_qualitative(feed, it)
                    due = main and timed_save_due(last_ckpt_time,
                                                  self.save_checkpoint_interval_min, iteration=it)
                    if self.own is not None:  # every rank joins the save
                        due = rank0_decides(self.mesh, due, it, self.device)
                    if due:
                        self._save(it)
                        last_ckpt_time = time.time()
                    if it >= self.max_iterations:
                        break
        finally:
            # the prefetch thread drew ahead; rewind to the last consumed draw
            self._presample_rng.bit_generator.state = json.loads(self._presample_state)

        self._save(it)
        self.save_weights_only(self.weights_only_path(it))
        if main:
            self.saver.finish()  # the final snapshot is on disk before returning
        barrier(self.mesh)
        return self

    def _save(self, it: int) -> None:
        """The train state to a checkpoint, written by rank 0 (with sharded
        tables every rank joins the gather)."""
        main = is_main(self.mesh)
        if main or self.own is not None:
            state = self.state_dict()
            if main:
                self.saver.save(state, it)

    def _log_qualitative(self, feed: Mapping[str, Any], it: int) -> None:
        """Eval-mode render of the consumed batch's first object and first
        view (npcd_tpu pointnerf_training.py:287-313): its PSNR against the
        ground truth, both images, and the object's feature statistics.
        A failure is logged and never stops training. With sharded tables
        every rank joins the fetch of rank 0's object, and rank 0 renders."""
        obj_idx = feed["obj_idx"][:1]
        rows = None
        if self.own is not None:
            gidx = global_indices(obj_idx, self.mesh)[:1]
            rows = (fetch_rows(self.model.tables.coords_table, self.own, gidx, self.mesh),
                    fetch_rows(self.model.tables.feats_table, self.own, gidx, self.mesh))
        if not is_main(self.mesh):
            return
        try:
            intrinsics, extrinsics = feed["intrinsics"][:1, :1], feed["extrinsics"][:1, :1]
            if rows is None:
                out = self.model.eval_forward(obj_idx, intrinsics, extrinsics)
                emb = self.model.tables.feats_table[obj_idx]
            else:
                emb = rows[1]
                out = self.model.render(rows[0], mean_log_var_std(emb)[0], extrinsics,
                                        intrinsics, resolution=self.model.opts.default_resolution)
            res = self.model.opts.default_resolution
            img = np.clip(out["channels"][0, 0].float().cpu().numpy().reshape(res, res, 3), 0, 1)
            gt = np.asarray(self._host_batch(feed["indices"][:1])["images"][0, 0])
            gt = gt.reshape(res, res, 3)
            writer.put_scalar("pointnerf_train/full_render_psnr", psnr(img, gt), it)
            writer.put_image("pointnerf_train/render", img, it)
            writer.put_image("pointnerf_train/gt", gt, it)
            with torch.no_grad():
                f_mean, _, f_std = mean_log_var_std(emb)
                writer.put_scalar("pointnerf_train/feats_mean_abs", float(f_mean.abs().mean()), it)
                writer.put_scalar("pointnerf_train/feats_std_mean", float(f_std.mean()), it)
            writer.write_out_storage()
        except Exception as e:  # logging must never stop training
            logging.warning(f"qualitative logging failed at iter {it}: {e!r}")

    def weights_only_path(self, it: int) -> str:
        return os.path.join(self.weights_dir, f"pointnerf-iter-{it:09d}.npz")

    def save_weights_only(self, path: str) -> None:
        """The bridged .npz that train_diffusion --pointnerf_weights and
        generate_samples --weights read: latents.coords_table [n_obj, P, 3],
        latents.feats_table [n_obj, P, F] (the mean half) and pointnerf.*,
        written by rank 0 (with sharded tables every rank joins the
        gather)."""
        main = is_main(self.mesh)
        if not main and self.own is None:
            return
        coords = self._whole(self.model.get_all_coords())
        feats = self._whole(self.model.get_all_feats().contiguous())
        if not main:
            return
        flat = {f"pointnerf.{k}": v.detach().cpu().numpy()
                for k, v in self.model.mlp_state_dict().items()}
        flat[f"{LATENTS}.coords_table"] = coords.cpu().numpy()
        flat[f"{LATENTS}.feats_table"] = feats.detach().cpu().numpy()
        save_npz(path, flat)

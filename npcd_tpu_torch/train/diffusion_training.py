"""Stage-2 (diffusion) training loop. Port of
npcd_tpu/train/diffusion_training.py: AdamW at a constant learning rate
over the denoiser's parameters, normalizers fitted from the whole latent
dataset up front, per-step EMAs, full-state checkpoints with resume, and
weights-only exports.

One step is loss -> backward -> fused update: the denoiser runs its
LayerNorms and attention through kernels K2 and K1 forward and backward,
and kernel K3 updates the parameters, Adam moments and EMAs in one pass.
For that pass the denoiser's parameters and gradients are views of two flat
f32 buffers (``FlatParams``); backward accumulates into the gradient views
in place.

Draws: the timesteps and noise of step ``n`` come from a torch.Generator
seeded from (seed, n), and the batch order from a numpy generator seeded
with ``seed`` (npcd_tpu's BatchLoader order for that seed), so a run
resumed from a checkpoint takes the same steps as an uninterrupted one.
npcd_tpu draws the former from fold_in(PRNGKey(seed), n), which torch
cannot reproduce; the tests replay JAX's draws through ``train_step``'s
``draws``.

With ``mesh`` (parallel.Mesh, data parallelism) ``batch_size`` is the
global batch and each rank takes ``batch_size // world`` of it a step from
its shard of the dataset (BatchLoader's strided partition, npcd_tpu's
multi-process loader); the step is parallel/shard_map_step.py's: each rank
keeps its rows of the global draws, and one all-reduce of the flat gradient
buffer gives the global mean before K3 runs on every rank, so the
parameters stay equal across ranks. Rank 0 writes the checkpoints, exports
and scalars, and the others wait for it at a barrier at the end; every rank
restores a checkpoint.

With ``tp`` > 1 (tensor parallelism, npcd_tpu's ``DiffusionTraining(tp=)``)
the ranks form npcd_tpu's default ('data', 'model') mesh of shape
(world // tp, tp) over ``mesh`` (or over the launcher's group), and the
step is parallel/tp_step.py's: every rank seeds the full denoiser alike and
keeps its model rank's shards (parallel/tp.py), batches and draws go by
data index, the gradients are averaged over the data group, grad_norm is
summed over the model group, and K3 updates the local buffers. Checkpoints
and exports hold full arrays in the layout of a tp=1 run (every rank joins
their gather, rank 0 writes), and every rank restores its shards from one,
so that a run restores across tp 1 and tp > 1.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import BatchLoader, prefetch_to_device
from ..models.diffusion.diffusion_model import DiffusionModel, DiffusionState
from ..models.diffusion.normalizers import NormalizerStats
from ..parallel import (all_reduce_mean_, barrier, global_row_draws, is_main, make_mesh,
                        replicate, shard_batch)
from ..parallel.tp import shard_denoiser_state
from ..parallel.tp_step import TPLayout, tp_grad_norm
from ..utils import logging, writer
from ..utils.checkpoint import (CheckpointSaver, rank0_decides, timed_save_due,
                                write_layout_meta)
from ..utils.ema import EmaConfig
from ..utils.from_jax import save_npz
from ..utils.util import count_parameters
from .fused_update import AdamState, FusedAdamWEma

_STATS = ("shift", "scale", "min", "max")


class FlatParams:
    """A module's parameters and their gradients as views of two flat f32
    buffers, ``params`` and ``grads``, in ``named_parameters`` order."""

    def __init__(self, module: torch.nn.Module):
        named = list(module.named_parameters())
        self.names = [n for n, _ in named]
        self.shapes = [tuple(p.shape) for _, p in named]
        sizes = [p.numel() for _, p in named]
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        device = named[0][1].device
        self.params = torch.empty(self.offsets[-1], device=device, dtype=torch.float32)
        self.grads = torch.zeros_like(self.params)
        self._modules = [p for _, p in named]
        for i, (_, p) in enumerate(named):
            if p.dtype != torch.float32:
                raise ValueError(f"FlatParams takes float32 parameters, got {p.dtype}")
            self.params[self.offsets[i]:self.offsets[i + 1]].copy_(p.detach().reshape(-1))
            p.data = self.view(self.params, i)
            p.grad = self.view(self.grads, i)
        self._grad_ptrs = [p.grad.data_ptr() for p in self._modules]

    def view(self, flat: torch.Tensor, i: int) -> torch.Tensor:
        return flat[self.offsets[i]:self.offsets[i + 1]].view(self.shapes[i])

    def as_dict(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: self.view(flat, i) for i, n in enumerate(self.names)}

    def from_dict(self, flat: torch.Tensor, values: Mapping[str, Any]) -> None:
        """Copy {name: array} into ``flat`` (every name, shapes checked)."""
        if set(values) != set(self.names):
            raise ValueError(f"parameter names differ: missing {set(self.names) - set(values)}, "
                             f"unexpected {set(values) - set(self.names)}")
        for i, n in enumerate(self.names):
            v = torch.tensor(np.asarray(values[n], np.float32))
            if tuple(v.shape) != self.shapes[i]:
                raise ValueError(f"{n}: shape {tuple(v.shape)} != {self.shapes[i]}")
            self.view(flat, i).copy_(v)

    def check_grads(self) -> None:
        """Raise unless every gradient is still a view of ``grads``."""
        for p, ptr in zip(self._modules, self._grad_ptrs):
            if p.grad is None or p.grad.data_ptr() != ptr:
                raise RuntimeError("a parameter's gradient left the flat gradient buffer")


def _step_seed(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([seed, step]).generate_state(1)[0])


class DiffusionTraining:
    def __init__(
        self,
        out_dir: str,
        model: DiffusionModel,
        dataset,
        batch_size: int,
        base_learning_rate: float,
        weight_decay: float,
        max_iterations: int,
        use_ema: bool = False,
        ema_params: Optional[Sequence[Tuple[float, float, float, bool]]] = None,
        grad_clip_max_norm: Optional[float] = None,
        seed: int = 42,
        device: str | torch.device = "cpu",
        export_extra: Optional[Mapping[str, np.ndarray]] = None,
        print_interval: int = 100,
        log_scalars_interval: int = 100,
        save_checkpoint_interval_min: float = 20.0,
        weights_only_interval: int = 200_000,
        verbose: bool = True,
        mesh=None,
        tp: int = 1,
        **_,
    ):
        """``export_extra``: flat arrays written into every weights-only
        export beside the denoiser and normalizers (the ``pointnerf.*``
        weights, so an export loads into an NPCD with ``load_npz``).
        ``mesh``: a parallel.Mesh whose device the trainer runs on. ``tp``:
        the tensor-parallel degree; above 1 the ranks of ``mesh`` (or of
        the launcher's group, joined here) form a (world // tp, tp) mesh."""
        if tp > 1:
            if mesh is None:
                mesh = make_mesh(device)
            if mesh.tp != tp:
                if mesh.tp != 1:
                    raise ValueError(f"mesh has tp={mesh.tp}, asked for tp={tp}")
                mesh = mesh.with_tp(tp)
        dp = 1 if mesh is None else mesh.dp
        if batch_size % dp:
            raise ValueError(f"global batch_size {batch_size} must divide by the data-parallel "
                             f"world {dp}")
        self.out_dir = out_dir
        self.checkpoints_dir = os.path.join(out_dir, "checkpoints")
        self.weights_dir = os.path.join(out_dir, "weights_only_checkpoints_dir")
        os.makedirs(self.checkpoints_dir, exist_ok=True)
        os.makedirs(self.weights_dir, exist_ok=True)

        self.device = torch.device(device)
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_iterations = max_iterations
        self.seed = seed
        self.print_interval = print_interval
        self.log_scalars_interval = log_scalars_interval
        self.save_checkpoint_interval_min = save_checkpoint_interval_min
        self.weights_only_interval = weights_only_interval
        self.verbose = verbose
        self.export_extra = dict(export_extra or {})
        self.mesh = mesh
        self.tp = tp
        self.ema_cfgs = tuple(EmaConfig.from_tuple(t) for t in (ema_params or [])) if use_ema \
            else ()

        model.denoiser.init_scratch(torch.Generator().manual_seed(seed))
        # tensor parallelism: the full denoiser seeded alike on every rank,
        # this model rank's shards kept (npcd_tpu's shard_train_state)
        self.tp_layout = None
        if tp > 1:
            full = model.denoiser.state_dict()
            named = list(model.denoiser.named_parameters())
            self.tp_layout = TPLayout([n for n, _ in named], [tuple(p.shape) for _, p in named],
                                      tp, mesh.model_index)
            model.denoiser = model.denoiser.clone(tp=tp, mesh=mesh)
            model.denoiser.load_state_dict(shard_denoiser_state(full, tp, mesh.model_index))
            del full, named
        self.model = model.to(self.device).train()
        # normalizers from the full latent dataset (npcd_tpu :163-169)
        self.state = model.fit_normalizers(dataset.get_all_coords(), dataset.get_all_feats())

        self.flat = FlatParams(model.denoiser)
        replicate([self.flat.params], mesh)
        self.fused = FusedAdamWEma(learning_rate=base_learning_rate, weight_decay=weight_decay,
                                   clip_max_norm=grad_clip_max_norm, ema_cfgs=self.ema_cfgs)
        self.adam = self.fused.init(self.flat.params)
        self.emas = (self.flat.params.repeat(len(self.ema_cfgs), 1) if self.ema_cfgs
                     else None)
        self.step = 0
        self._generator = torch.Generator(device=self.device)
        self.history: List[Dict[str, float]] = []

        # the fused-qkv channel grouping is recorded with every checkpoint:
        # another qkv_groups gives the same shapes with permuted c_qkv columns
        self.layout_meta = {"qkv_groups": model.denoiser.qkv_groups}
        self.saver = CheckpointSaver(self.checkpoints_dir, "diffusion_training",
                                     self.layout_meta)
        latest = self.saver.latest()
        if latest is not None:
            state, it = self.saver.restore()
            self.load_state_dict(state)
            logging.info(f"Restored checkpoint at iteration {it}")
        if verbose:
            logging.info(f"DiffusionTraining: {len(self._full_shapes)} leaves of "
                         f"{count_parameters(self.model.denoiser)} params on this rank, batch {batch_size}, "
                         f"max_iterations {max_iterations}, dataset size {len(dataset)}, "
                         f"device {self.device}, world {1 if mesh is None else mesh.world}, "
                         f"tp {tp}")

    # -- state ---------------------------------------------------------------

    @property
    def _full_shapes(self) -> List[Tuple[int, ...]]:
        """The parameters' shapes in a tp=1 run."""
        return self.flat.shapes if self.tp_layout is None else self.tp_layout.full_shapes

    def _full(self, buf: torch.Tensor) -> torch.Tensor:
        """A flat buffer ([n] or [k, n]) in the layout of a tp=1 run: the
        buffer itself, or under tp the model group's shards gathered (a
        collective every rank of the group joins)."""
        if self.tp_layout is None:
            return buf
        if buf.dim() == 2:
            return torch.stack([self.tp_layout.full(b, self.mesh) for b in buf]) if len(buf) \
                else buf
        return self.tp_layout.full(buf, self.mesh)

    def _local(self, full) -> torch.Tensor:
        """A flat buffer ([n] or [k, n]) of a tp=1 run -> this rank's."""
        full = torch.as_tensor(full)
        if self.tp_layout is None:
            return full
        if full.dim() == 2:
            return torch.stack([self.tp_layout.local(f) for f in full]) if len(full) else full
        return self.tp_layout.local(full)

    def state_dict(self) -> Dict[str, Any]:
        """The full train state in the layout of a tp=1 run (tensors are the
        live buffers; under tp, fresh full ones: every rank must call it)."""
        norms = {name: {f: getattr(stats, f) for f in _STATS}
                 for name, stats in (("coords_norm", self.state.coords_norm),
                                     ("feats_norm", self.state.feats_norm))}
        return {"names": list(self.flat.names), "shapes": [list(s) for s in self._full_shapes],
                "ema_params": [cfg.param_string() for cfg in self.ema_cfgs],
                "params": self._full(self.flat.params), "mu": self._full(self.adam.mu),
                "nu": self._full(self.adam.nu),
                "emas": self._full(self.emas) if self.emas is not None else torch.zeros(0),
                "count": self.adam.count, "step": self.step, **norms}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Copy a ``state_dict`` (e.g. a restored checkpoint, of any tp) into
        the live buffers; the names, shapes and EMA configs must match."""
        expect = (list(self.flat.names), [list(s) for s in self._full_shapes],
                  [cfg.param_string() for cfg in self.ema_cfgs])
        got = (list(state["names"]), [list(s) for s in state["shapes"]],
               list(state["ema_params"]))
        if got != expect:
            raise ValueError("checkpoint does not match this model's parameters or EMA configs")
        with torch.no_grad():
            self.flat.params.copy_(self._local(state["params"]))
            self.adam.mu.copy_(self._local(state["mu"]))
            self.adam.nu.copy_(self._local(state["nu"]))
            if self.emas is not None:
                self.emas.copy_(self._local(state["emas"]))
        self.adam = AdamState(int(state["count"]), self.adam.mu, self.adam.nu)
        self.step = int(state["step"])
        self.state = DiffusionState(*(NormalizerStats(*(torch.as_tensor(state[n][f])
                                                        for f in _STATS))
                                      for n in ("coords_norm", "feats_norm")))

    def load_bridged_state(self, bridged: Mapping[str, Any]) -> None:
        """Start from an npcd_tpu train state carried over by
        utils/from_jax.train_state_from_jax."""
        if len(bridged["emas"]) != len(self.ema_cfgs):
            raise ValueError(f"{len(bridged['emas'])} EMAs for {len(self.ema_cfgs)} configs")
        mine = (lambda d: d) if self.tp_layout is None else (
            lambda d: shard_denoiser_state(d, self.tp, self.mesh.model_index))
        with torch.no_grad():
            self.flat.from_dict(self.flat.params, mine(bridged["params"]))
            self.flat.from_dict(self.adam.mu, mine(bridged["mu"]))
            self.flat.from_dict(self.adam.nu, mine(bridged["nu"]))
            for i, ema in enumerate(bridged["emas"]):
                self.flat.from_dict(self.emas[i], mine(ema))
        self.adam = AdamState(int(bridged["count"]), self.adam.mu, self.adam.nu)
        self.step = int(bridged["step"])
        self.state = DiffusionState(*(NormalizerStats(*(torch.tensor(
            np.asarray(bridged[n][f], np.float32)) for f in _STATS))
            for n in ("coords_norm", "feats_norm")))

    # -- step ----------------------------------------------------------------

    def train_step(self, batch: Mapping[str, np.ndarray], draws=None) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` {coords [N, C, P], feats [N, F, P]} (this
        rank's rows under a mesh): loss -> backward -> (the gradients'
        all-reduce) -> fused AdamW + EMA. ``draws`` = (t, coords_noise,
        feats_noise) of the global batch replaces this step's seeded draws.
        Returns the metrics (global under a mesh) as device tensors (no
        sync)."""
        coords = torch.as_tensor(batch["coords"], dtype=torch.float32, device=self.device)
        feats = torch.as_tensor(batch["feats"], dtype=torch.float32, device=self.device)
        self.flat.grads.zero_()
        if draws is None:
            draws = global_row_draws(self.model, coords.shape[0], coords.shape[1:],
                                     feats.shape[1:],
                                     self._generator.manual_seed(_step_seed(self.seed, self.step)),
                                     self.mesh)
        else:
            draws = shard_batch(tuple(map(torch.as_tensor, draws)), self.mesh)
        loss, sub_losses = self.model.compute_loss(self.state, coords, feats, draws=draws)
        loss.backward()
        self.flat.check_grads()
        metrics = {"loss": loss.detach(), **{k: v.detach() for k, v in sub_losses.items()}}
        if self.mesh is not None:
            metrics = all_reduce_mean_(self.flat.grads, metrics, self.mesh)
        grad_norm = None
        if self.tp_layout is not None:
            grad_norm = tp_grad_norm(self.flat.grads, self.tp_layout, self.mesh)
        self.adam, grad_norm = self.fused.update(self.flat.grads, self.flat.params, self.adam,
                                                 self.emas, self.step, grad_norm)
        self.step += 1
        return {**metrics, "grad_norm": grad_norm}

    # -- loop ----------------------------------------------------------------

    def batches(self, start: int):
        """Batches (this rank's under a mesh) from iteration ``start`` on,
        epoch after epoch."""
        loader = BatchLoader(self.dataset, self.batch_size, self.seed,
                             1 if self.mesh is None else self.mesh.dp,
                             0 if self.mesh is None else self.mesh.data_index)
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

    def _to_device(self, batch: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """The batch's coords and feats on the device (copied on the current
        stream)."""
        return {k: torch.as_tensor(batch[k], dtype=torch.float32).to(self.device)
                for k in ("coords", "feats")}

    def __call__(self):
        if self.step >= self.max_iterations:
            logging.info("Training already finished.")
            return self
        writer.set_max_iterations(self.max_iterations)
        it = self.step
        main = is_main(self.mesh)
        last_ckpt_time = time.time()
        t_print = time.perf_counter()
        # the loader and the copy of the next batches run on a thread ahead
        # of the step (npcd_tpu's prefetch_to_device)
        with contextlib.closing(prefetch_to_device(self.batches(it), self._to_device)) as feeds:
            for batch in feeds:
                metrics = self.train_step(batch)
                it += 1
                if it % self.print_interval == 0:
                    values = {k: float(v) for k, v in metrics.items()}  # waits for the step
                    now = time.perf_counter()
                    dt = (now - t_print) / self.print_interval
                    t_print = now
                    self.history.append({"it": it, "time": now, **values})
                    logging.info(f"iter {it}/{self.max_iterations} loss {values['loss']:.5f} "
                                 f"grad_norm {values['grad_norm']:.5f} ({dt * 1000:.1f} ms/it)")
                if main and it % self.log_scalars_interval == 0:
                    writer.put_scalar_dict("diffusion_train",
                                           {k: float(v) for k, v in metrics.items()}, it)
                    writer.write_out_storage()
                due = main and timed_save_due(last_ckpt_time,
                                              self.save_checkpoint_interval_min, iteration=it)
                if self.tp_layout is not None:  # every rank joins the save
                    due = rank0_decides(self.mesh, due, it, self.device)
                if due:
                    self._save(it)
                    last_ckpt_time = time.time()
                if it % self.weights_only_interval == 0:
                    self._save_weights_only(it)
                if it >= self.max_iterations:
                    break

        self._save(it)
        self._save_weights_only(it)
        if main:
            self.saver.finish()  # the final snapshot is on disk before returning
        barrier(self.mesh)
        return self

    def _save(self, it: int) -> None:
        """The full train state to a checkpoint, written by rank 0 (under tp
        every rank joins the gather)."""
        main = is_main(self.mesh)
        if main or self.tp_layout is not None:
            state = self.state_dict()
            if main:
                self.saver.save(state, it)

    def weights_only_paths(self, it: int) -> List[str]:
        names = ["npcd"] + [f"npcd-ema_{cfg.param_string()}" for cfg in self.ema_cfgs]
        return [os.path.join(self.weights_dir, f"{n}-iter-{it:09d}.npz") for n in names]

    def _save_weights_only(self, it: int) -> None:
        """npcd-iter-%09d.npz and npcd-ema_<params>-iter-%09d.npz: bridged
        flat dicts (utils/from_jax.py) of full arrays that ``load_npz``
        loads into an NPCD, written by rank 0 (under tp every rank joins
        the gather)."""
        main = is_main(self.mesh)
        if not main and self.tp_layout is None:
            return
        bufs = [self._full(self.flat.params)] + [
            self._full(self.emas[i]) for i in range(len(self.ema_cfgs))]
        if not main:
            return
        as_dict = self.flat.as_dict if self.tp_layout is None else self.tp_layout.full_as_dict
        base = dict(self.export_extra)
        for name, stats in (("coords_norm", self.state.coords_norm),
                            ("feats_norm", self.state.feats_norm)):
            for f in _STATS:
                base[f"{name}.{f}"] = getattr(stats, f).cpu().numpy()
        for path, buf in zip(self.weights_only_paths(it), bufs):
            host = buf.detach().cpu()
            flat = dict(base)
            flat.update({f"diffusion.denoiser.{n}": v.numpy()
                         for n, v in as_dict(host).items()})
            save_npz(path, flat)
            write_layout_meta(path, self.layout_meta)

"""Full train-state checkpoints in torch's own format. Port of
npcd_tpu/utils/checkpoint.py (orbax there):

  * CheckpointSaver: ``<base>-iter-%09d`` directories holding ``state.pt``,
    the newest KEEP kept, ``latest``/``restore``, saves written by a
    background thread with at most one in flight;
  * the ``qkv_groups`` layout sidecar (``<checkpoint>.layout.json``) and
    its mismatch check, for full checkpoints and weights-only exports;
  * ``timed_save_due`` for one process.

The weights-only tier is the bridged ``.npz`` of utils/from_jax.py
(``save_npz`` / ``load_npz``), so what the trainer exports, the generation
CLI loads.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

KEEP = 3
_ITER_RE = re.compile(r"-iter-(\d{9})$")
_LAYOUT_SUFFIX = ".layout.json"
_STATE_FILE = "state.pt"


def write_layout_meta(ckpt_path: str, meta: dict) -> None:
    """Record parameter-layout metadata (the fused-qkv channel grouping,
    models/diffusion/transformer.py qkv_groups) in a sidecar JSON next to a
    checkpoint. Layouts with identical array shapes but permuted channels
    load without error and silently corrupt the model; the sidecar makes
    the mismatch detectable at load time."""
    with open(ckpt_path.rstrip("/") + _LAYOUT_SUFFIX, "w") as f:
        json.dump(meta, f)


def check_layout_meta(ckpt_path: str, expected: dict, what: str = "checkpoint",
                      required: bool = True) -> None:
    """Raise when a checkpoint's recorded layout disagrees with the layout
    the current model expects, or when it has no sidecar and ``required``."""
    p = ckpt_path.rstrip("/") + _LAYOUT_SUFFIX
    if not os.path.exists(p):
        if required:
            raise FileNotFoundError(f"{what} {ckpt_path} has no layout sidecar {p}")
        return
    with open(p) as f:
        meta = json.load(f)
    mismatch = {k: (meta.get(k), v) for k, v in expected.items() if k in meta and meta[k] != v}
    if mismatch:
        raise ValueError(
            f"{what} {ckpt_path} was saved under a different parameter layout: "
            + ", ".join(f"{k}: checkpoint={a} vs model={b}" for k, (a, b) in mismatch.items())
            + ". Shapes match, so a plain load would silently permute attention channels.")


# the iterations at which timed_save_due consults the clock
CHECK_EVERY = 50


def timed_save_due(last_save_time: float, interval_min: float,
                   iteration: Optional[int] = None, check_every: int = CHECK_EVERY) -> bool:
    """Wall-clock checkpoint trigger, consulted every ``check_every``
    iterations (one process: no broadcast needed)."""
    if iteration is not None and iteration % check_every != 0:
        return False
    return (time.time() - last_save_time) / 60 > interval_min


def rank0_decides(mesh, due: bool, iteration: int, device) -> bool:
    """Rank 0's ``due`` (a timed_save_due answer) on every rank of ``mesh``,
    for a save that every rank joins: a broadcast at the iterations the
    clock is consulted, False at the others."""
    if mesh is None or iteration % CHECK_EVERY:
        return due
    return bool(mesh.broadcast_(torch.tensor([float(due)], device=device)))


def _iter_of(path: str) -> Optional[int]:
    m = _ITER_RE.search(os.path.basename(path.rstrip("/")))
    return int(m.group(1)) if m else None


def to_host(state: Any) -> Any:
    """A host copy of a (nested) dict of tensors, taken now: the trainer
    updates its buffers in place, so a background save needs its own copy."""
    if isinstance(state, dict):
        return {k: to_host(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(to_host(v) for v in state)
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    return state


class CheckpointSaver:
    """Full train-state snapshots, the newest KEEP kept. ``save`` takes a
    host copy of the state dict (``to_host``) before it returns and a
    background thread writes it, at most one save in flight (a new ``save``
    first waits for the previous one). A save writes the layout sidecar,
    then the state into a temporary directory that it renames, so a crash
    mid-write never leaves a directory that ``latest``/``restore`` would
    pick up. Call ``finish`` before relying on the last checkpoint being on
    disk."""

    def __init__(self, base_dir: str, base_name: str, layout_meta: dict):
        self.base_dir = os.path.abspath(base_dir)
        self.base_name = base_name
        self.layout_meta = layout_meta
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(self.base_dir, exist_ok=True)

    def _path(self, iteration: int) -> str:
        return os.path.join(self.base_dir, f"{self.base_name}-iter-{iteration:09d}")

    def list_checkpoints(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.base_dir):
            if not name.startswith(self.base_name + "-iter-"):
                continue
            path = os.path.join(self.base_dir, name)
            it = _iter_of(path)
            if it is not None and os.path.isdir(path):
                out.append((it, path))
        return sorted(out)

    def _write(self, state: Dict[str, Any], path: str) -> None:
        try:
            write_layout_meta(path, self.layout_meta)
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(state, os.path.join(tmp, _STATE_FILE))
            if os.path.exists(path):
                shutil.rmtree(path)
            os.replace(tmp, path)
            for _, old in self.list_checkpoints()[:-KEEP]:
                shutil.rmtree(old, ignore_errors=True)
                os.remove(old + _LAYOUT_SUFFIX)
        except BaseException as e:  # noqa: BLE001 - re-raised by finish()
            self._error = e

    def finish(self) -> None:
        """Block until the save in flight (if any) is on disk; re-raise its
        error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint save failed") from err

    def save(self, state: Dict[str, Any], iteration: int) -> str:
        path = self._path(iteration)
        self.finish()
        self._thread = threading.Thread(target=self._write, args=(to_host(state), path),
                                        name="ckpt-save", daemon=True)
        self._thread.start()
        return path

    def latest(self) -> Optional[Tuple[int, str]]:
        ckpts = self.list_checkpoints()
        return ckpts[-1] if ckpts else None

    def restore(self) -> Tuple[Dict[str, Any], int]:
        """-> (state dict on the CPU, iteration) of the latest checkpoint."""
        latest = self.latest()
        if latest is None:
            raise FileNotFoundError(f"no checkpoints under {self.base_dir}")
        it, path = latest
        check_layout_meta(path, self.layout_meta)
        state = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                           weights_only=True)
        return state, it

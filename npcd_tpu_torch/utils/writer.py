"""Event-buffered metric writer fan-out.

Copy of npcd_tpu/utils/writer.py (which imports no JAX), a rebuild of the
reference writer (npcd/utils/writer.py): training code `put`s scalars,
images (the stage-1 trainer's qualitative renders) and histograms into a
global event buffer; `write_out_storage` flushes them to all registered
backends. Backends: JSONL (scalars; always available), TensorBoard (when
the tensorboard package is importable) and Weights & Biases (``--wandb``).
`TimeWriter` times a block and puts its duration, and with
`set_max_iterations` an ETA from the last 20 durations.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

EVENT_STORAGE: List[Dict[str, Any]] = []
_WRITERS: List["Writer"] = []
_max_iterations: Optional[int] = None


def set_max_iterations(n: int) -> None:
    global _max_iterations
    _max_iterations = n


class Writer:
    def write_scalar(self, name: str, value: float, step: int) -> None:
        raise NotImplementedError

    def write_image(self, name: str, image: np.ndarray, step: int) -> None:
        pass

    def write_histogram(self, name: str, values: np.ndarray, step: int) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlWriter(Writer):
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")

    def write_scalar(self, name: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"step": step, "name": name, "value": float(value), "t": time.time()}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TensorboardWriter(Writer):
    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter  # lazy

        self._tb = SummaryWriter(log_dir=log_dir)

    def write_scalar(self, name: str, value: float, step: int) -> None:
        self._tb.add_scalar(name, value, step)

    def write_image(self, name: str, image: np.ndarray, step: int) -> None:
        # image: [H, W, 3] float in [0, 1]
        self._tb.add_image(name, image, step, dataformats="HWC")

    def write_histogram(self, name: str, values: np.ndarray, step: int) -> None:
        self._tb.add_histogram(name, values, step)

    def close(self) -> None:
        self._tb.close()


class WandbWriter(Writer):
    """Weights & Biases backend (reference writer.py:299-333).

    wandb is not bundled on this image; setup_writers gates on
    importability and logs a warning instead of failing."""

    def __init__(self, out_dir: str, exp_id: Optional[str] = None,
                 comment: Optional[str] = None):
        import wandb  # lazy; gated by setup_writers

        self._wandb = wandb
        self._run = wandb.init(
            project="npcd_tpu", dir=out_dir, id=exp_id, notes=comment,
            resume="allow" if exp_id else None,
        )

    def write_scalar(self, name: str, value: float, step: int) -> None:
        self._wandb.log({name: value}, step=step)

    def write_image(self, name: str, image: np.ndarray, step: int) -> None:
        self._wandb.log({name: self._wandb.Image(image)}, step=step)

    def write_histogram(self, name: str, values: np.ndarray, step: int) -> None:
        self._wandb.log({name: self._wandb.Histogram(values)}, step=step)

    def close(self) -> None:
        self._run.finish()


def setup_writers(
    out_dir: str,
    tensorboard: bool = True,
    wandb: bool = False,
    exp_id: Optional[str] = None,
    comment: Optional[str] = None,
) -> None:
    _WRITERS.clear()
    _WRITERS.append(JsonlWriter(os.path.join(out_dir, "metrics.jsonl")))
    if tensorboard:
        try:
            _WRITERS.append(TensorboardWriter(os.path.join(out_dir, "tb")))
        except ImportError:
            pass
    if wandb:
        try:
            _WRITERS.append(WandbWriter(out_dir, exp_id=exp_id, comment=comment))
        except Exception as e:  # import, auth, or network failures alike
            from . import logging

            logging.warning(
                f"wandb requested but unavailable ({type(e).__name__}: {e}); "
                "continuing without it"
            )


def put_scalar(name: str, value: float, step: int) -> None:
    EVENT_STORAGE.append({"kind": "scalar", "name": name, "value": value, "step": step})


def put_scalar_dict(prefix: str, values: Dict[str, Any], step: int) -> None:
    for k, v in values.items():
        put_scalar(f"{prefix}/{k}", v, step)


def put_image(name: str, image: np.ndarray, step: int) -> None:
    """image: [H, W, 3] float in [0, 1]."""
    EVENT_STORAGE.append({"kind": "image", "name": name, "value": image, "step": step})


def put_histogram(name: str, values, step: int) -> None:
    """values: any array-like (a tensor on any device), kept flattened."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu()
    EVENT_STORAGE.append({
        "kind": "histogram", "name": name,
        "value": np.asarray(values).reshape(-1), "step": step,
    })


def put_histogram_dict(prefix: str, values: Dict[str, Any], step: int) -> None:
    for k, v in values.items():
        put_histogram(f"{prefix}/{k}", v, step)


def write_out_storage() -> None:
    for ev in EVENT_STORAGE:
        for w in _WRITERS:
            if ev["kind"] == "scalar":
                w.write_scalar(ev["name"], float(ev["value"]), ev["step"])
            elif ev["kind"] == "image":
                w.write_image(ev["name"], ev["value"], ev["step"])
            elif ev["kind"] == "histogram":
                w.write_histogram(ev["name"], ev["value"], ev["step"])
    EVENT_STORAGE.clear()


def close_writers() -> None:
    write_out_storage()
    for w in _WRITERS:
        w.close()
    _WRITERS.clear()


class TimeWriter:
    """Context manager measuring wall time (reference writer.py:176-208):
    with a ``step`` and ``write``, puts ``time/<name>`` and, after
    set_max_iterations, ``time/<name>_eta_hours`` from the mean of the
    name's last 20 durations."""

    def __init__(self, name: str = "", step: Optional[int] = None, write: bool = True):
        self.name = name
        self.step = step
        self.write = write
        self.duration = 0.0

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *args):
        self.duration = time.time() - self.start
        if self.write and self.step is not None:
            put_scalar(f"time/{self.name}", self.duration, self.step)
            # running-average ETA (reference writer.py:270-296)
            buf = _TIME_BUFFERS.setdefault(self.name, [])
            buf.append(self.duration)
            del buf[:-20]
            if _max_iterations is not None:
                avg = sum(buf) / len(buf)
                put_scalar(
                    f"time/{self.name}_eta_hours",
                    avg * max(_max_iterations - self.step, 0) / 3600.0,
                    self.step,
                )


_TIME_BUFFERS: Dict[str, List[float]] = {}

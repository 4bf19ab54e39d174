"""Profiling and tracing helpers. Port of npcd_tpu/utils/profiling.py:
torch.profiler traces in place of jax.profiler's, torch.cuda's allocator
statistics under the keys of JAX's device memory_stats, and a step timer
that synchronizes the result's device before it reads the clock.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a torch.profiler trace of the body (the CPU, and the card
    where there is one) and write it into ``log_dir`` as a Chrome trace,
    ``trace-<pid>-<ns>.json`` (chrome://tracing, Perfetto)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside a captured trace."""
    with torch.profiler.record_function(name):
        yield


# JAX's memory_stats keys -> torch.cuda.memory_stats keys
_MEMORY_KEYS = {
    "bytes_in_use": "allocated_bytes.all.current",
    "peak_bytes_in_use": "allocated_bytes.all.peak",
    "bytes_reserved": "reserved_bytes.all.current",
    "peak_bytes_reserved": "reserved_bytes.all.peak",
    "num_allocs": "allocation.all.allocated",
}


def device_memory_stats(device=None) -> Dict[str, int]:
    """A CUDA device's memory statistics in bytes under the keys of JAX's
    Device.memory_stats (bytes_in_use, peak_bytes_in_use, bytes_limit, ...;
    the caching allocator's allocated bytes stand for what is in use); an
    empty dict on the CPU, as npcd_tpu's there. ``device``: the current
    CUDA device by default."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    out = {key: int(stats.get(name, 0)) for key, name in _MEMORY_KEYS.items()}
    out["bytes_limit"] = int(torch.cuda.get_device_properties(device).total_memory)
    return out


def _synchronize(result: Any) -> None:
    """Wait for the devices of the tensors in ``result`` (nested lists,
    tuples and dicts)."""
    if isinstance(result, torch.Tensor):
        if result.is_cuda:
            torch.cuda.synchronize(result.device)
    elif isinstance(result, dict):
        for v in result.values():
            _synchronize(v)
    elif isinstance(result, (list, tuple)):
        for v in result:
            _synchronize(v)


class StepTimer:
    """Rolling step timer: ``measure(result)`` brackets a step and waits for
    ``result``'s device before it reads the clock (the reference eval's
    cuda.synchronize bracketing); the first ``burn_in`` steps are not kept."""

    def __init__(self, burn_in: int = 3):
        self.burn_in = burn_in
        self._times: List[float] = []
        self._count = 0

    @contextlib.contextmanager
    def measure(self, result=None) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if result is not None:
            _synchronize(result)
        dt = time.perf_counter() - t0
        self._count += 1
        if self._count > self.burn_in:
            self._times.append(dt)

    @property
    def mean(self) -> Optional[float]:
        return sum(self._times) / len(self._times) if self._times else None

"""Dataset base, data roots, collate, the batch loader and device prefetch.
Port of npcd_tpu/data/dataset.py.

Samples are dicts of numpy arrays. Data roots resolve from the
``NPCD_TPU_<KEY1>_<KEY2>...`` environment variable (e.g.
``NPCD_TPU_SRN_ROOT``), else from a ``paths.toml`` beside this file or
``~/npcd_tpu_data_paths.toml``. ``collate`` stacks with ``np.stack`` only
(npcd_tpu's native collate is not ported). ``prefetch_to_device`` runs a
loader and its transfer on a thread ahead of the step."""
from __future__ import annotations

import abc
import os
import os.path as osp
import queue
import threading
import tomllib
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np

from ..utils import logging


def get_paths() -> Dict[str, Any]:
    local = osp.join(osp.dirname(osp.realpath(__file__)), "paths.toml")
    home = osp.join(osp.expanduser("~"), "npcd_tpu_data_paths.toml")
    for path in (local, home):
        if osp.exists(path):
            with open(path, "rb") as f:
                return tomllib.load(f)
    raise FileNotFoundError(
        f"No paths.toml found; create {local} or {home} with dataset roots.")


def get_path(*keys: str) -> Optional[str]:
    """The data root under ``keys`` (e.g. "srn", "root"); the environment
    variable NPCD_TPU_<KEY1>_<KEY2>... overrides the files."""
    env = "NPCD_TPU_" + "_".join(k.upper() for k in keys)
    if os.environ.get(env):
        return os.environ[env]
    node: Any = get_paths()
    for key in keys:
        if not isinstance(node, dict) or key not in node:
            return None
        node = node[key]
    return node if isinstance(node, (str, list)) else None


class Dataset(abc.ABC):
    """Samples in ``self.samples``, filled by ``_init_samples(**kwargs)``."""

    def __init__(self, root: Optional[str] = None, verbose: bool = True, **kwargs):
        self.verbose = verbose
        self.root = root
        if self.verbose:
            logging.info(f"Initializing dataset {self.name}" + (f" from {root}" if root else ""))
        self.samples: List[Any] = []
        self._init_samples(**kwargs)
        if self.verbose:
            logging.info(f"\tNumber of samples: {len(self)}")

    @property
    def name(self) -> str:
        return type(self).__name__

    @abc.abstractmethod
    def _init_samples(self, **kwargs):
        ...

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        return self.samples[index]

    @staticmethod
    def preload_threading(load_func: Callable, idx_list: Sequence, num_workers: int = 8,
                          data_str: str = "items") -> List[Any]:
        """[load_func(x) for x in idx_list] on ``num_workers`` threads; the
        first exception a worker meets is raised here."""
        idx_list = list(idx_list)
        data_list: List[Any] = [None] * len(idx_list)
        errors: List[BaseException] = []
        q: "queue.Queue" = queue.Queue()
        for el in enumerate(idx_list):
            q.put(el)

        def worker():
            while not errors:
                try:
                    i, idx = q.get_nowait()
                except queue.Empty:
                    return
                try:
                    data_list[i] = load_func(idx)
                except BaseException as e:  # noqa: BLE001 - re-raised by the caller
                    errors.append(e)

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(num_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        if any(x is None for x in data_list):
            raise RuntimeError(f"failed preloading {data_str}")
        return data_list


def collate(samples: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Samples -> a batch: arrays stacked, scalars as one array, anything
    else as a list."""
    out: Dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


def prefetch_to_device(iterable: Iterable, transfer: Callable[[Any], Any], size: int = 2):
    """transfer(item) for each item of ``iterable``, run on a thread ahead of
    the consumer, in order, at most ``size`` items ahead of the one the
    consumer holds. The producer's exception is raised in the consumer.
    When the consumer stops early (``break``, an exception, ``close()``),
    the producer is stopped and joined before this generator returns, and
    the items it staged are dropped: close it explicitly
    (``contextlib.closing``) where the stop must not wait for the garbage
    collector."""
    size = max(1, size)
    q: "queue.Queue" = queue.Queue()
    slots = threading.Semaphore(size)
    stop = threading.Event()
    end = object()

    def producer():
        try:
            it = iter(iterable)
            while True:
                while not slots.acquire(timeout=0.05):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                try:
                    item = next(it)
                except StopIteration:
                    break
                q.put(transfer(item))
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            q.put(e)
            return
        q.put(end)

    t = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            slots.release()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()
        while not q.empty():
            q.get_nowait()


class BatchLoader:
    """Shuffled epochs of full batches over a dataset: each epoch draws a
    permutation with ``np.random.default_rng(seed + shard_index)`` (npcd_tpu's
    loader with drop_last), so the same seed gives the same order. A batch
    is ``dataset.batch(indices)`` where the dataset has one, else the
    collate of its samples. ``epoch_order`` draws an epoch without building
    batches, which lets a resumed run skip the epochs it has done.

    Data parallelism (``num_shards`` > 1), as npcd_tpu's multi-process
    loader: ``batch_size`` is the global batch and this shard's batches
    hold ``batch_size // num_shards`` of its indices, the strided partition
    ``[shard_index::num_shards]`` of the indices wrap-padded to a multiple
    of ``num_shards``, so every shard has as many batches an epoch."""

    def __init__(self, dataset, batch_size: int, seed: int = 0, num_shards: int = 1,
                 shard_index: int = 0):
        if batch_size % num_shards:
            raise ValueError(f"global batch_size {batch_size} must divide by num_shards "
                             f"{num_shards}")
        self.dataset = dataset
        self.batch_size = batch_size // num_shards  # this shard's
        indices = np.arange(len(dataset))
        if num_shards > 1 and len(indices) % num_shards:
            if len(indices) == 0:
                raise ValueError("cannot shard an empty dataset")
            pad = num_shards - len(indices) % num_shards
            indices = np.concatenate([indices, indices[:pad]])
        self.indices = indices[shard_index::num_shards]
        self._rng = np.random.default_rng(seed + shard_index)

    def __len__(self) -> int:
        return len(self.indices) // self.batch_size

    def epoch_order(self) -> np.ndarray:
        order = self.indices.copy()
        self._rng.shuffle(order)
        return order

    def index_batches(self, order: np.ndarray, skip: int = 0) -> Iterator[np.ndarray]:
        """The indices of one epoch's batches of ``order``, from batch
        ``skip`` on."""
        for i in range(skip, len(self)):
            yield order[i * self.batch_size:(i + 1) * self.batch_size]

    def batch(self, indices) -> Dict[str, Any]:
        if hasattr(self.dataset, "batch"):
            return self.dataset.batch(indices)
        return collate([self.dataset[int(i)] for i in indices])

    def batches(self, order: np.ndarray, skip: int = 0) -> Iterator[Dict[str, Any]]:
        """The batches of one epoch's ``order``, from batch ``skip`` on."""
        return map(self.batch, self.index_batches(order, skip))

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self.batches(self.epoch_order())

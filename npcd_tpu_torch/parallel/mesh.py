"""Data and tensor parallelism over torch.distributed: one process a rank.
Port of npcd_tpu/parallel/mesh.py.

npcd_tpu shards the global batch on its leading axis over a 1-D ('data',)
device mesh, with the parameters replicated, or over the 'data' axis of a
('data', 'model') mesh of shape (world // tp, tp) whose 'model' axis splits
the denoiser's layers (parallel/tp.py). Here every rank is a process that
owns one card (or shares one, over gloo) and holds this rank's rows of the
global batch, and the reductions are explicit collectives
(parallel/shard_map_step.py, parallel/tp_step.py, the trainers). A mesh
with ``tp`` > 1 (``Mesh.with_tp``) lays the ranks out as npcd_tpu's
``reshape(world // tp, tp)``: rank = data_index * tp + model_index; the
model group holds the ranks of one data index, the data group those of one
model index.

``make_mesh`` joins the group that a launcher's environment describes
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``,
as ``python -m torch.distributed.run`` sets them), or makes a group of one
without it. ``launch`` starts one worker a card on a free port, which is what
a CLI's ``--mesh`` does when no launcher started it. The backend is NCCL
where each rank owns a card and gloo on the CPU; ``backend="gloo"`` lets
ranks share a card (NCCL refuses two ranks on one device). Under gloo,
collectives on CUDA tensors are limited to all_reduce, broadcast and
barrier, so ``gather`` moves its rows to the host first.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..utils import logging

# a collective that one rank never enters fails after this long
DEFAULT_TIMEOUT_S = 1800.0
# launch: a whole launch still running after this long fails (None: no
# deadline; a hung collective fails its worker after DEFAULT_TIMEOUT_S)
LAUNCH_TIMEOUT_S: Optional[float] = None
# launch: once a worker has failed, the others' time to end before the kill
GRACE_S = 30.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, model) grid of ranks; ``tp`` 1
    (the default) makes every rank a data rank."""

    world: int
    rank: int
    local_rank: int
    device: torch.device
    backend: str
    tp: int = 1
    # the process groups of this rank's model and data axes (tp > 1 only)
    model_group: Any = dataclasses.field(default=None, compare=False, repr=False)
    data_group: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def dp(self) -> int:
        """The ranks of the 'data' axis: world // tp."""
        return self.world // self.tp

    @property
    def data_index(self) -> int:
        return self.rank // self.tp

    @property
    def model_index(self) -> int:
        return self.rank % self.tp

    def with_tp(self, tp: int) -> "Mesh":
        """This group as npcd_tpu's ('data', 'model') mesh of shape
        (world // tp, tp), with its model and data groups (every rank of the
        group must call it, in the same order)."""
        if tp < 1 or self.world % tp:
            raise ValueError(f"tp={tp} does not divide device count {self.world}")
        if tp == 1:
            return dataclasses.replace(self, tp=1, model_group=None, data_group=None)
        dp = self.world // tp
        model_group = data_group = None
        for d in range(dp):  # new_group is collective: every rank makes every group
            g = dist.new_group([d * tp + m for m in range(tp)])
            if d == self.rank // tp:
                model_group = g
        for m in range(tp):
            g = dist.new_group([d * tp + m for d in range(dp)])
            if m == self.rank % tp:
                data_group = g
        return dataclasses.replace(self, tp=tp, model_group=model_group, data_group=data_group)

    def rows(self, n: int, uneven: bool = False) -> slice:
        """This rank's rows of a global leading dimension of n, by its data
        index: n / dp each, or with ``uneven`` np.array_split's parts (the
        first n % dp data indices one more). The model ranks of one data
        index take the same rows."""
        parts, i = self.dp, self.data_index
        per, extra = divmod(n, parts)
        if extra and not uneven:
            raise ValueError(f"{n} rows do not divide over {parts} ranks")
        start = i * per + min(i, extra)
        return slice(start, start + per + (i < extra))

    def all_reduce_(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Sum ``t`` in place over the ranks (``axis`` None), over the ranks
        of this rank's data index ("model") or of its model index ("data")
        -> t."""
        if axis is None:
            if self.world > 1:
                dist.all_reduce(t)
        elif axis == "model":
            if self.tp > 1:
                dist.all_reduce(t, group=self.model_group)
        elif axis == "data":
            if self.dp > 1:
                if self.tp > 1:
                    dist.all_reduce(t, group=self.data_group)
                else:
                    dist.all_reduce(t)
        else:
            raise ValueError(f"axis must be None, 'data' or 'model', got {axis!r}")
        return t

    def broadcast_(self, t: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """Rank 0's ``t`` on every rank (``axis`` None), or data index 0's
        on the ranks of this rank's model index ("data"), in place -> t."""
        if axis is None:
            if self.world > 1:
                dist.broadcast(t, 0)
        elif axis == "data":
            if self.dp > 1:
                if self.tp > 1:
                    dist.broadcast(t, self.model_index, group=self.data_group)
                else:
                    dist.broadcast(t, 0)
        else:
            raise ValueError(f"axis must be None or 'data', got {axis!r}")
        return t

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
        rank order, on the host, on every rank."""
        if self.world == 1:
            return t.detach().cpu()
        t = t.detach().movedim(dim, 0).contiguous()
        if self.backend == "nccl":
            out = torch.empty((self.world * t.shape[0],) + t.shape[1:], dtype=t.dtype,
                              device=t.device)
            dist.all_gather_into_tensor(out, t)
            out = out.cpu()
        else:
            t = t.cpu()
            parts = [torch.empty_like(t) for _ in range(self.world)]
            dist.all_gather(parts, t)
            out = torch.cat(parts)
        return out.movedim(0, dim)

    def gather_objects(self, obj: Any, to_main: bool = False) -> Optional[List[Any]]:
        """Every rank's picklable ``obj``, in rank order, on every rank (with
        ``to_main``: on rank 0, and None on the others)."""
        if self.world == 1:
            return [obj]
        out: Optional[List[Any]] = [None] * self.world if self.is_main or not to_main else None
        if to_main:
            dist.gather_object(obj, out, dst=0)
        else:
            dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.world > 1:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launched() -> bool:
    """Whether a launcher's environment names this process's rank."""
    return "WORLD_SIZE" in os.environ


def make_mesh(device: str | torch.device = "cuda", backend: Optional[str] = None) -> Mesh:
    """Join the launcher's group (or make a group of one) -> the Mesh.
    ``device`` "cuda" takes card LOCAL_RANK (modulo the cards); the
    backend defaults to the backend of a group this process already joined,
    else to NCCL there and gloo on the CPU. Ranks other than 0 log warnings
    and errors only."""
    env = os.environ
    if backend is None and dist.is_initialized():
        backend = dist.get_backend()
    world = int(env.get("WORLD_SIZE", 1))
    rank = int(env.get("RANK", 0))
    local_rank = int(env.get("LOCAL_RANK", rank))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--mesh on cuda: no GPU found")
        n_cards = torch.cuda.device_count()
        backend = backend or "nccl"
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and local_world > n_cards:
            raise ValueError(f"NCCL takes one rank a card: {local_world} ranks on this host, "
                             f"{n_cards} cards (backend='gloo' lets ranks share a card)")
        device = torch.device("cuda", local_rank % n_cards if device.index is None
                              else device.index)
        torch.cuda.set_device(device)
    else:
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: only gloo")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank(), dist.get_backend()) != (world, rank, backend):
            raise RuntimeError(f"a process group of world {dist.get_world_size()}, rank "
                               f"{dist.get_rank()}, {dist.get_backend()} exists; asked for "
                               f"{world}, {rank}, {backend}")
    else:
        if world > 1 and "MASTER_PORT" not in env:
            raise ValueError(f"WORLD_SIZE {world} without MASTER_PORT")
        addr = env.get("MASTER_ADDR", "localhost")
        port = env.get("MASTER_PORT") or free_port()
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", world_size=world,
                                rank=rank, timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    if rank != 0:
        logging.set_level("warning")
    return Mesh(world, rank, local_rank, device, backend)


def shard_batch(batch: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's rows of every array or range (leading dimension) of a
    dict, list or tuple of them; the whole batch without a mesh."""
    if mesh is None:
        return batch
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return batch[mesh.rows(len(batch))]


def replicate(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Data index 0's values of ``tensors`` on every rank of its model index
    (a broadcast in place; with tp 1, rank 0's on every rank): a model rank's
    shards are never overwritten by another model rank's."""
    if mesh is not None and mesh.dp > 1:
        with torch.no_grad():
            for t in tensors:
                mesh.broadcast_(t.data, axis="data")


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        mesh.barrier()


def mesh_world(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.world


def is_main(mesh: Optional[Mesh]) -> bool:
    return mesh is None or mesh.is_main


def _worker(fn, args, rank, world, port, results) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    try:
        results.put((rank, True, fn(*args)))
    except BaseException:  # noqa: BLE001 - sent to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, args: tuple = (), world: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` new processes (default: one a visible
    card), each under a launcher's environment on a free port of this host
    -> their return values in rank order (picklable; ``fn`` a module-level
    function). A worker that raises or dies fails the launch: the others get
    GRACE_S seconds to end, then every worker still running is killed and a
    RuntimeError names the rank and its traceback; so does a launch still
    running after LAUNCH_TIMEOUT_S."""
    import multiprocessing as mp

    world = world if world is not None else torch.cuda.device_count()
    if world < 1:
        raise RuntimeError("launch: no GPU found (pass world)")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(fn, args, r, world, port, results),
                         name=f"npcd-rank{r}") for r in range(world)]
    for p in procs:
        p.start()
    deadline = None if LAUNCH_TIMEOUT_S is None else time.monotonic() + LAUNCH_TIMEOUT_S
    values: dict = {}
    failure = None
    try:
        while len(values) < world and failure is None:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in values]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif deadline is not None and time.monotonic() > deadline:
                    failure = f"still running after {LAUNCH_TIMEOUT_S} s"
                continue
            if ok:
                values[rank] = value
            else:
                failure = f"rank {rank} raised:\n{value}"
        end = time.monotonic() + (GRACE_S if failure else max(GRACE_S, 60.0))
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    if failure is not None:
        raise RuntimeError(f"launch of {getattr(fn, '__name__', fn)} over {world} ranks "
                           f"failed: {failure}")
    return [values[r] for r in range(world)]


def spawn_cli(main: Callable, argv: Optional[Sequence[str]], device: str) -> bool:
    """A CLI's ``--mesh`` without a launcher: on more than one visible card,
    run ``main(argv)`` in one worker a card (each then joins the group) and
    -> True; else -> False, and the caller runs in this process (a group of
    one)."""
    if launched() or torch.device(device).type != "cuda" or torch.cuda.device_count() < 2:
        return False
    import sys

    launch(main, (list(argv) if argv is not None else sys.argv[1:],))
    return True

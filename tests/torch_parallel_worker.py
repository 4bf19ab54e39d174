"""Ranks of a gloo group for the data-parallel tests of the PyTorch port,
on the CPU, without JAX.

``run_group(jobs, tmp, world)`` writes ``jobs`` ({name: (case, kwargs)},
pickled with the port's objects they name) and starts ``world`` processes
of this file under a launcher's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR/MASTER_PORT) with one torch thread; each runs every job's case
function on its rank in order and pickles {name: result}; a hang fails the
test (communicate's timeout kills the group) -> [rank 0's results, rank 1's,
...]. ``start_group`` starts them and returns the wait, so that the caller
computes its references meanwhile. ``run_ranks(module, argv, world)`` runs ``python -m module argv`` on
each rank the same way (a CLI under the launcher's environment) -> the
ranks' stdout and stderr.
"""
from __future__ import annotations

import contextlib
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(cmd, world, cwd):
    port = _free_port()
    procs = []
    for r in range(world):
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        env.update(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, cwd=cwd, env=env))
    return procs


def _wait(procs, what):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{what}: a rank hung past {TIMEOUT_S} s")
        outs.append(out)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {what} failed:\n{out[-4000:]}"
    return outs


def start_group(jobs: dict, tmp, world: int = 2):
    """``run_group`` started: -> a function that waits for the ranks and
    returns their results."""
    tmp = str(tmp)
    with open(os.path.join(tmp, "jobs.pkl"), "wb") as f:
        pickle.dump(jobs, f)
    procs = _start([sys.executable, os.path.abspath(__file__), tmp], world, REPO)

    def results() -> list:
        _wait(procs, f"group {sorted(jobs)}")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    return results


def run_group(jobs: dict, tmp, world: int = 2) -> list:
    return start_group(jobs, tmp, world)()


def run_ranks(module: str, argv, world: int = 2, cwd=REPO) -> list:
    return _wait(_start([sys.executable, "-m", module, *map(str, argv)], world, cwd), module)


def global_batches(dataset, batch_size: int, seed: int, world: int, steps: int) -> list:
    """The object indices of the first ``steps`` global batches of a
    data-parallel run: each rank's batch from its BatchLoader shard, in
    rank order (the rows each rank holds)."""
    from npcd_tpu_torch.data import BatchLoader

    loaders = [BatchLoader(dataset, batch_size, seed, world, r) for r in range(world)]
    out = []
    while len(out) < steps:
        epochs = [list(loader.index_batches(loader.epoch_order())) for loader in loaders]
        out += [np.concatenate(parts) for parts in zip(*epochs)]
    return out[:steps]


def assert_one_writer(out_dir) -> None:
    """cmd.txt holds one command line: one rank opened the outputs."""
    with open(os.path.join(out_dir, "cmd.txt")) as f:
        assert len(f.read().splitlines()) == 1


# -- the cases ------------------------------------------------------------------------------


def _mesh():
    from npcd_tpu_torch.parallel import make_mesh

    return make_mesh("cpu")


def _np(t):
    return t.detach().cpu().numpy().copy()


@contextlib.contextmanager
def _patched(module, name, value):
    """``module.name`` replaced by ``value`` (None: left as it is) inside."""
    old = getattr(module, name)
    if value is not None:
        setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def stage2_steps(model_kw, bridged, coords, feats, batches, draws, lr, wd, ema, out_dir,
                 fault=False):
    """DiffusionTraining.train_step on this rank's rows of each global batch
    with the global draws, from the bridged train state -> each step's
    metrics and reduced flat gradient, then the flat params, mu, nu, EMAs.
    ``fault``: the gradient all-reduce sums without dividing by the world."""
    from npcd_tpu_torch.data import PointNeRFDataset
    from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel
    from npcd_tpu_torch.parallel import shard_batch
    from npcd_tpu_torch.train import DiffusionTraining, diffusion_training

    def summed(grads, metrics, mesh):
        mesh.all_reduce_(grads)
        return {k: mesh.all_reduce_(v.detach().clone()) / mesh.world for k, v in metrics.items()}

    mesh = _mesh()
    with _patched(diffusion_training, "all_reduce_mean_", summed if fault else None):
        trainer = DiffusionTraining(out_dir, DiffusionModel(**model_kw),
                                    PointNeRFDataset(coords, feats),
                                    batch_size=len(batches[0]["coords"]), base_learning_rate=lr,
                                    weight_decay=wd, max_iterations=100, use_ema=True,
                                    ema_params=[ema], device="cpu",
                                    save_checkpoint_interval_min=1e9,
                                    weights_only_interval=10**9, verbose=False, mesh=mesh)
        trainer.load_bridged_state(bridged)
        steps = []
        for batch, d in zip(batches, draws):
            m = trainer.train_step(shard_batch(batch, mesh),
                                   draws=tuple(map(torch.as_tensor, d)))
            steps.append({**{k: float(v) for k, v in m.items()},
                          "grads": _np(trainer.flat.grads)})
    return {"steps": steps, "params": _np(trainer.flat.params), "mu": _np(trainer.adam.mu),
            "nu": _np(trainer.adam.nu), "emas": _np(trainer.emas), "step": trainer.step}


def stage2_run(model_kw, coords, feats, lr, wd, ema, out_dir, max_iterations):
    """A DiffusionTraining run under the mesh, then a fresh trainer on the
    same out_dir (a resume) called again -> its state and what it did."""
    from npcd_tpu_torch.data import PointNeRFDataset
    from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel
    from npcd_tpu_torch.train import DiffusionTraining

    mesh = _mesh()
    make = lambda: DiffusionTraining(
        out_dir, DiffusionModel(**model_kw), PointNeRFDataset(coords, feats), batch_size=4,
        base_learning_rate=lr, weight_decay=wd, max_iterations=max_iterations, use_ema=True,
        ema_params=[ema], device="cpu", save_checkpoint_interval_min=1e9,
        weights_only_interval=10**9, verbose=False, print_interval=1, mesh=mesh)
    trainer = make()()
    again = make()
    restored = again.step
    finished = again() is again and not again.history
    return {"params": _np(trainer.flat.params), "emas": _np(trainer.emas),
            "losses": [h["loss"] for h in trainer.history], "restored": restored,
            "finished": finished, "again_params": _np(again.flat.params)}


def stage1_steps(config, bridged, weights, lr, batches, draws, out_dir, fault=False):
    """PointNeRFTraining.train_step on this rank's rows of each global
    full-frame batch with the global draws, from the bridged train state ->
    each step's metrics and reduced gradients, then the parameters.
    ``fault``: each rank's loss is its own mean, averaged over the ranks
    (a per-rank reconstruction mean)."""
    from npcd_tpu_torch.data import SyntheticNPCTrain
    from npcd_tpu_torch.losses import PointNeRFLossWeights, pointnerf_loss
    from npcd_tpu_torch.parallel import shard_batch
    from npcd_tpu_torch.train import PointNeRFTraining, pointnerf_training
    from npcd_tpu_torch.utils.builders import build_pointnerf

    def per_rank_mean(sample, pred, aux, opts, w, mesh):
        loss, sub = pointnerf_loss(sample, pred, aux, opts, w)
        return loss / mesh.world, {k: v / mesh.world for k, v in sub.items()}

    mesh = _mesh()
    with _patched(pointnerf_training, "pointnerf_loss", per_rank_mean if fault else None):
        trainer = PointNeRFTraining(out_dir, build_pointnerf(config, with_tables=True),
                                    SyntheticNPCTrain(**config["dataset_kwargs"]),
                                    batch_size=len(batches[0]["obj_idx"]),
                                    base_learning_rate=lr, max_epochs=100,
                                    loss_weights=PointNeRFLossWeights(*weights), device="cpu",
                                    save_checkpoint_interval_min=1e9, verbose=False, mesh=mesh)
        trainer.load_bridged_state(bridged)
        steps = []
        for batch, d in zip(batches, draws):
            m = trainer.train_step(shard_batch(batch, mesh), draws=d)
            steps.append({**{k: float(v) for k, v in m.items()},
                          "grads": {n: _np(p.grad) for n, p in trainer.model.named_parameters()}})
    return {"steps": steps,
            "params": {n: _np(p) for n, p in trainer.model.named_parameters()}}


def generate(model, state, num, batch_size, draws, trajectory_stride=0):
    """DiffusionModel.generate under the mesh on the replayed draws ->
    coords, feats (and the trajectory's states) and the draws left."""
    draws = list(draws)
    out = model.diffusion.generate(state, num, batch_size,
                                   noise=lambda shape: torch.tensor(draws.pop(0)),
                                   return_trajectory=trajectory_stride > 0,
                                   trajectory_stride=max(trajectory_stride, 1), mesh=_mesh())
    res = {"coords": out[0], "feats": out[1], "left": len(draws)}
    if trajectory_stride:
        res.update(coords_ts=out[2].coords_ts, feats_ts=out[2].feats_ts)
    return res


def ids_noise():
    """A noise function whose rows are the global object ids of the
    generate batches in turn: with ``stub_generate`` each rank's clouds are
    its rows of ``clouds``."""
    done = [0]

    def noise(shape):
        ids = torch.arange(done[0], done[0] + shape[0], dtype=torch.float32)
        done[0] += shape[0]
        return ids.reshape(-1, *([1] * (len(shape) - 1))).expand(shape)
    return noise


def stub_generate(clouds):
    """A DiffusionEvaluation.generate returning the rows of ``clouds`` that
    ``ids_noise`` names."""
    def generate(model, state, num, noise):
        ids = noise((num, 1))[:, 0].long().numpy()
        return torch.from_numpy(clouds[0][ids]), torch.from_numpy(clouds[1][ids])
    return generate


def fid_eval(model, state, kw, clouds, out_dir, kid_seed):
    """DiffusionEvaluation under the mesh on the given clouds (global
    order) -> the results, the rounded batch sizes and the files written."""
    from npcd_tpu_torch.eval import DiffusionEvaluation

    ev = DiffusionEvaluation(out_dir=out_dir, device="cpu", mesh=_mesh(), **kw)
    ev.generate = stub_generate(clouds)
    res = ev(model, state, noise=ids_noise(), kid_seed=kid_seed)
    return {"results": res, "batches": (ev.generate_batch_size, ev.render_object_batch)}


def psnr_eval(model, dataset, eval_batch_size, resolution, out_dir):
    """PointNeRFEvaluation under the mesh -> its result."""
    from npcd_tpu_torch.eval import PointNeRFEvaluation

    ev = PointNeRFEvaluation(out_dir, eval_batch_size=eval_batch_size, verbose=False,
                             mesh=_mesh())
    return ev(dataset, model, qualitatives=1, resolution=resolution)


def launched_rank(tag):
    """A launch's worker: its rank, world and tag."""
    import torch.distributed as dist

    mesh = _mesh()
    total = mesh.all_reduce_(torch.ones(1))
    return {"rank": mesh.rank, "world": mesh.world, "sum": float(total), "tag": tag,
            "initialized": dist.is_initialized()}


def launched_failure(bad_rank):
    """A launch's worker that raises on ``bad_rank`` and waits in a
    collective on the others."""
    mesh = _mesh()
    if mesh.rank == bad_rank:
        raise RuntimeError(f"rank {bad_rank} fails")
    mesh.barrier()


# -- tensor parallelism and sharded tables ---------------------------------------------------


def _local_norm(grads, layout, mesh):
    """Planted fault: grad_norm from this rank's buffer alone."""
    return torch.linalg.vector_norm(grads)


def _summed_g(y, mesh):
    """Planted fault: torch.distributed.nn's all_reduce as the "g" operator,
    whose backward sums the cotangent over the model group again."""
    import torch.distributed.nn.functional as dist_fn

    return dist_fn.all_reduce(y, group=mesh.model_group)


def _world_mean(grads, metrics, mesh):
    """Planted fault: the data mean taken over the world."""
    mesh.all_reduce_(grads).div_(mesh.world)
    return {k: mesh.all_reduce_(v.detach().clone()) / mesh.world for k, v in metrics.items()}


TP_FAULTS = {"norm": ("diffusion_training", "tp_grad_norm", _local_norm),
             "g": ("transformer", "tp_reduce", _summed_g),
             "mean": ("diffusion_training", "all_reduce_mean_", _world_mean)}


def _tp_trainer(model_kw, coords, feats, batch_size, lr, wd, ema, clip, out_dir, tp, mesh,
                max_iterations=100):
    from npcd_tpu_torch.data import PointNeRFDataset
    from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel
    from npcd_tpu_torch.train import DiffusionTraining

    return DiffusionTraining(out_dir, DiffusionModel(**model_kw), PointNeRFDataset(coords, feats),
                             batch_size=batch_size, base_learning_rate=lr, weight_decay=wd,
                             max_iterations=max_iterations, use_ema=True, ema_params=[ema],
                             grad_clip_max_norm=clip, device="cpu",
                             save_checkpoint_interval_min=1e9, weights_only_interval=10**9,
                             verbose=False, print_interval=1, mesh=mesh, tp=tp)


def tp_steps(model_kw, bridged, coords, feats, batches, draws, lr, wd, ema, clip, out_dir,
             tp=2, fault=None):
    """DiffusionTraining(tp=).train_step on this rank's data rows of each
    global batch with the global draws, from the bridged train state -> each
    step's metrics, then the train state gathered full (params, mu, nu,
    EMAs), this rank's flat params and its (data, model) index. ``fault``:
    one of TP_FAULTS."""
    from npcd_tpu_torch.models.diffusion import transformer
    from npcd_tpu_torch.parallel import shard_batch
    from npcd_tpu_torch.train import diffusion_training

    where = {"diffusion_training": diffusion_training, "transformer": transformer}
    module, name, value = TP_FAULTS[fault] if fault else ("transformer", "tp_reduce", None)
    with _patched(where[module], name, value):
        trainer = _tp_trainer(model_kw, coords, feats, len(batches[0]["coords"]), lr, wd, ema,
                              clip, out_dir, tp, _mesh())
        trainer.load_bridged_state(bridged)
        steps = []
        for batch, d in zip(batches, draws):
            m = trainer.train_step(shard_batch(batch, trainer.mesh),
                                   draws=tuple(map(torch.as_tensor, d)))
            steps.append({k: float(v) for k, v in m.items()})
        state = trainer.state_dict()
    mesh = trainer.mesh
    return {"steps": steps, "params": _np(state["params"]), "mu": _np(state["mu"]),
            "nu": _np(state["nu"]), "emas": _np(state["emas"]), "step": trainer.step,
            "local": _np(trainer.flat.params), "index": (mesh.data_index, mesh.model_index)}


def tp_run(model_kw, coords, feats, lr, wd, ema, out_dir, tp1_dir, max_iterations):
    """A DiffusionTraining(tp=2) run of ``max_iterations`` steps at a global
    batch of 4 (rank 0 writes), then a tp=2 trainer on ``tp1_dir`` (a tp=1
    run's checkpoint) -> the run's losses, its local and gathered params
    and EMAs, and the restored trainer's step and gathered params."""
    mesh = _mesh()
    trainer = _tp_trainer(model_kw, coords, feats, 4, lr, wd, ema, None, out_dir, 2, mesh,
                          max_iterations)()
    state = trainer.state_dict()
    restored = _tp_trainer(model_kw, coords, feats, 4, lr, wd, ema, None, tp1_dir, 2, mesh,
                           max_iterations)
    return {"losses": [h["loss"] for h in trainer.history], "local": _np(trainer.flat.params),
            "params": _np(state["params"]), "emas": _np(state["emas"]),
            "restored_step": restored.step,
            "restored_params": _np(restored.state_dict()["params"])}


def _skip_decay(optimizer, table, gidx_of):
    """Planted fault: Adam moves only the owned rows of this step's batch;
    the other rows of the shard keep their values and moments."""
    step = optimizer.step

    def masked():
        keep = torch.ones(table.shape[0], dtype=torch.bool)
        keep[gidx_of()] = False
        st = optimizer.state.get(table)
        saved = [table.detach().clone()] + ([st["exp_avg"].clone(), st["exp_avg_sq"].clone()]
                                            if st else [])
        step()
        with torch.no_grad():
            table[keep] = saved[0][keep]
            if st:
                st["exp_avg"][keep] = saved[1][keep]
                st["exp_avg_sq"][keep] = saved[2][keep]
    optimizer.step = masked


def sharded_stage1_steps(config, bridged, weights, lr, batches, draws, out_dir, fault=False):
    """PointNeRFTraining(shard_tables=True).train_step on this rank's rows of
    each global batch with the global draws, from the bridged train state
    -> each step's metrics, the parameters with the tables gathered whole,
    this rank's table shards and its rows. ``fault``: the owner skips the
    decay of its rows outside the batch."""
    from npcd_tpu_torch.data import SyntheticNPCTrain
    from npcd_tpu_torch.losses import PointNeRFLossWeights
    from npcd_tpu_torch.parallel import shard_batch
    from npcd_tpu_torch.train import PointNeRFTraining
    from npcd_tpu_torch.utils.builders import build_pointnerf

    mesh = _mesh()
    trainer = PointNeRFTraining(out_dir, build_pointnerf(config, with_tables=True),
                                SyntheticNPCTrain(**config["dataset_kwargs"]),
                                batch_size=len(batches[0]["obj_idx"]), base_learning_rate=lr,
                                max_epochs=100, loss_weights=PointNeRFLossWeights(*weights),
                                device="cpu", save_checkpoint_interval_min=1e9, verbose=False,
                                mesh=mesh, shard_tables=True)
    trainer.load_bridged_state(bridged)
    table = trainer.model.tables.feats_table
    current = {}
    if fault:
        own = trainer.own
        _skip_decay(trainer.optimizer, table, lambda: [
            i - own.start for i in current["idx"] if own.start <= i < own.stop])
    steps = []
    for batch, d in zip(batches, draws):
        current["idx"] = [int(i) for i in batch["obj_idx"]]
        m = trainer.train_step(shard_batch(batch, mesh), draws=d)
        steps.append({k: float(v) for k, v in m.items()})
    params = {n: _np(p) for n, p in trainer.model.named_parameters()}
    params["tables.feats_table"] = _np(trainer._whole(table))
    params["tables.coords_table"] = _np(trainer._whole(trainer.model.tables.coords_table))
    return {"steps": steps, "params": params, "shard": _np(table),
            "coords_shard": _np(trainer.model.tables.coords_table),
            "own": (trainer.own.start, trainer.own.stop)}


def sharded_stage1_run(config, out_dir, replicated_dir):
    """A PointNeRFTraining(shard_tables=True) run of the config's steps
    (rank 0 writes), then a sharded trainer on ``replicated_dir`` (an
    unsharded run's checkpoint) -> the run's whole tables and shards, and
    the restored trainer's step, shard and rows."""
    import random

    from npcd_tpu_torch.losses import PointNeRFLossWeights
    from npcd_tpu_torch.train import PointNeRFTraining
    from npcd_tpu_torch.utils.builders import build_dataset, build_pointnerf

    mesh = _mesh()
    t = config["pointnerf_training"]

    def make(out):
        return PointNeRFTraining(out, build_pointnerf(config, torch.Generator().manual_seed(42),
                                                      with_tables=True),
                                 build_dataset(config, view_rng=random.Random(42)),
                                 loss_weights=PointNeRFLossWeights(1.0, 1e-7, 3.5e-7), seed=42,
                                 device="cpu", verbose=False, mesh=mesh, shard_tables=True,
                                 **t)
    trainer = make(out_dir)()
    table = trainer.model.tables.feats_table
    restored = make(replicated_dir)
    return {"step": trainer.step, "table": _np(trainer._whole(table)), "shard": _np(table),
            "own": (trainer.own.start, trainer.own.stop), "restored_step": restored.step,
            "restored_shard": _np(restored.model.tables.feats_table),
            "restored_mu": _np(restored.optimizer.state[
                restored.model.tables.feats_table]["exp_avg"])}


def main():
    tmp = sys.argv[1]
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "jobs.pkl"), "rb") as f:
        jobs = pickle.load(f)
    results = {name: globals()[case](**kw) for name, (case, kw) in jobs.items()}
    rank = int(os.environ["RANK"])
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    # leave the group together: a rank whose group outlives rank 0's store
    # can abort at exit ("terminate called without an active exception")
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    main()

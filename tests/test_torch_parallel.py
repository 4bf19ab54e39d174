"""Data parallelism of the PyTorch port (npcd_tpu_torch/parallel, the
stage-2 trainer under a mesh) against npcd_tpu on a 2-device CPU mesh.

One group of two gloo ranks (tests/torch_parallel_worker.py, subprocesses
with one torch thread each and a timeout) runs every case of this file:

  * three DiffusionTraining.train_steps on each rank's rows of global
    batches of 8, with JAX's draws replayed, from tests/test_torch_training's
    bridged train state (width 128, 2 layers), against npcd_tpu's
    make_diffusion_train_step with the state replicated and the batch sharded
    over make_mesh(n_devices=2): each step's loss within 1e-5 relative (the
    tolerance of npcd_tpu's DP test, tests/test_parallel.py), grad_norm
    within 1e-4, the reduced gradient within 1e-4 of each leaf's scale, and
    the state after the steps as tests/test_torch_training.py holds the
    single-process step; the two ranks' parameters, moments and EMAs
    bitwise equal, and equal to the port's own step on the whole batch in
    one process within npcd_tpu's DP tolerance (rtol 1e-4, atol 1e-6);
  * the same steps with the gradient all-reduce summing without dividing by
    the world (a planted fault): its gradient and grad_norm must fall
    outside those tolerances;
  * a 2-rank DiffusionTraining run of 3 steps at a global batch of 4: the
    ranks bitwise equal, one checkpoint and one set of exports, and a fresh
    trainer on the run's directory restores step 3 on each rank and reports
    the run finished.

Then the sharded BatchLoader against npcd_tpu's BatchLoader(num_shards=2,
shard_index=r) at 9 objects and batch 8 (bitwise, wrap padding included),
and parallel.launch: two workers on a free port, their return values in
rank order, and a worker that raises failing the launch with its traceback
while the other waits in a collective."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npcd_tpu.data.dataset import BatchLoader as JaxBatchLoader
from npcd_tpu.data.dataset import Dataset as JaxDataset
from npcd_tpu.parallel import make_mesh as jax_make_mesh
from npcd_tpu.parallel import replicate as jax_replicate
from npcd_tpu.parallel import shard_batch as jax_shard_batch
from npcd_tpu.train.diffusion_training import make_diffusion_train_step
from npcd_tpu_torch.data import BatchLoader, PointNeRFDataset
from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel
from npcd_tpu_torch.parallel import launch
from npcd_tpu_torch.parallel import mesh as mesh_module
from npcd_tpu_torch.train import DiffusionTraining
from npcd_tpu_torch.utils.from_jax import denoiser_state_dict
from test_torch_training import (EMA, LR, MODEL, START, WD, C, F, P, _bridged, _data, _jax_draws,
                                 _jax_state, _leaf_close)
from torch_parallel_worker import launched_failure, launched_rank, start_group

B = 8  # the global batch
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _global_batch(i):
    rng = np.random.default_rng(200 + i)
    return {"coords": rng.normal(size=(B, C, P)).astype(np.float32) * 0.4,
            "feats": rng.normal(size=(B, F, P)).astype(np.float32)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """npcd_tpu's three steps on the 2-device mesh, the port's on two ranks
    (and with the planted fault), the port's on one process, and the 2-rank
    trainer run."""
    tmp = tmp_path_factory.mktemp("dp2")
    model, fused, state = _jax_state()
    bridged = _bridged(state)
    batches = [_global_batch(i) for i in range(STEPS)]
    base = jax.random.PRNGKey(11)
    rngs = [jax.random.fold_in(base, START + i) for i in range(STEPS)]
    draws = [tuple(d.numpy() for d in _jax_draws(r, B)) for r in rngs]
    coords, feats = _data()
    kw = dict(model_kw=MODEL, bridged=bridged, coords=coords, feats=feats, batches=batches,
              draws=draws, lr=LR, wd=WD, ema=EMA)
    ranks = start_group({
        "steps": ("stage2_steps", dict(kw, out_dir=str(tmp / "steps"))),
        "fault": ("stage2_steps", dict(kw, out_dir=str(tmp / "fault"), fault=True)),
        "run": ("stage2_run", dict(model_kw=MODEL, coords=coords, feats=feats, lr=LR, wd=WD,
                                   ema=EMA, out_dir=str(tmp / "run"), max_iterations=3))}, tmp)

    mesh = jax_make_mesh(n_devices=2)
    step_fn = make_diffusion_train_step(model, fused, fused.ema_cfgs, donate=False)

    @jax.jit
    def grad_fn(state, batch, rng):
        return jax.grad(lambda p: model.compute_loss(state.diffusion_state(p), rng,
                                                     batch["coords"], batch["feats"])[0])(
            state.params)

    state = jax_replicate(state, mesh)
    want = []
    for batch, rng in zip(batches, rngs):
        sharded = jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
        grads = denoiser_state_dict(jax.tree_util.tree_map(np.asarray,
                                                           grad_fn(state, sharded, rng)))
        state, metrics = step_fn(state, sharded, rng)
        want.append({"grads": grads, **{k: float(v) for k, v in metrics.items()}})


    single = DiffusionTraining(str(tmp / "single"), DiffusionModel(**MODEL),
                               PointNeRFDataset(coords, feats), batch_size=B,
                               base_learning_rate=LR, weight_decay=WD, max_iterations=100,
                               use_ema=True, ema_params=[EMA], device="cpu",
                               save_checkpoint_interval_min=1e9, weights_only_interval=10**9,
                               verbose=False)
    single.load_bridged_state(bridged)
    for batch, d in zip(batches, draws):
        single.train_step(batch, draws=tuple(map(torch.from_numpy, d)))
    return {"want": want, "state": _bridged(state), "ranks": ranks(), "single": single,
            "tmp": tmp}


def _as_dict(flat_trainer, flat):
    return flat_trainer.flat.as_dict(torch.from_numpy(flat))


@pytest.mark.parametrize("step", range(STEPS))
def test_stage2_steps_match_jax_mesh(run, step):
    got = run["ranks"][0]["steps"]["steps"][step]
    want = run["want"][step]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for k in ("00_coords_loss", "01_feats_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    grads = _as_dict(run["single"], got["grads"])
    assert set(grads) == set(want["grads"])
    for name, g in grads.items():
        assert float(g.abs().max()) > 0, f"{name} got no gradient"
        _leaf_close(g.numpy(), want["grads"][name], 1e-4, f"step {step} grad {name}")
    # both ranks reduced to the same gradient
    np.testing.assert_array_equal(got["grads"], run["ranks"][1]["steps"]["steps"][step]["grads"])


def test_stage2_state_after_steps(run):
    ranks = [r["steps"] for r in run["ranks"]]
    for k in ("params", "mu", "nu", "emas"):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)  # bitwise
    assert ranks[0]["step"] == START + STEPS
    want = run["state"]
    single = run["single"]
    # against npcd_tpu's mesh step, as test_torch_training holds the
    # single-process step: every element within 2 lr a step, all but 0.1%
    # of each leaf within 1e-5 of its scale, the moments within 1e-4
    for name, flat, tree in [("params", ranks[0]["params"], want["params"]),
                             ("ema", ranks[0]["emas"][0], want["emas"][0])]:
        for leaf, v in _as_dict(single, flat).items():
            err = np.abs(v.numpy() - tree[leaf])
            assert err.max() <= 2 * STEPS * LR, f"{name} {leaf}: {err.max()}"
            assert (err > 1e-5 * np.abs(tree[leaf]).max()).mean() <= 1e-3, f"{name} {leaf}"
    for name, flat, tree in [("mu", ranks[0]["mu"], want["mu"]),
                             ("nu", ranks[0]["nu"], want["nu"])]:
        for leaf, v in _as_dict(single, flat).items():
            _leaf_close(v.numpy(), tree[leaf], 1e-4, f"{name} {leaf}")
    # against the port's own step on the whole batch in one process, at
    # npcd_tpu's DP tolerance
    for k, buf in (("params", single.flat.params), ("mu", single.adam.mu),
                   ("nu", single.adam.nu), ("emas", single.emas)):
        np.testing.assert_allclose(ranks[0][k], buf.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_stage2_sum_without_division_fails(run):
    """The planted fault: the reduced gradient is the sum over the ranks."""
    got = run["ranks"][0]["fault"]["steps"][0]
    want = run["want"][0]
    assert abs(got["grad_norm"] / want["grad_norm"] - 1) > 1e-4  # ~1, the sum's factor 2
    grads = _as_dict(run["single"], got["grads"])
    with pytest.raises(AssertionError):
        for name, g in grads.items():
            _leaf_close(g.numpy(), want["grads"][name], 1e-4, name)


def test_stage2_trainer_run_and_resume(run):
    r0, r1 = (r["run"] for r in run["ranks"])
    for k in ("params", "emas", "again_params"):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 3
    assert np.isfinite(r0["losses"]).all()
    assert r0["restored"] == r1["restored"] == 3
    assert r0["finished"] and r1["finished"]
    np.testing.assert_array_equal(r0["again_params"], r0["params"])
    out = run["tmp"] / "run"
    ckpts = sorted(n for n in os.listdir(out / "checkpoints") if not n.endswith(".json"))
    assert ckpts == ["diffusion_training-iter-000000003"]
    exports = sorted(os.listdir(out / "weights_only_checkpoints_dir"))
    assert [n for n in exports if n.endswith(".npz")] == [
        "npcd-ema_power1_0min0_9max0_999buffers0-iter-000000003.npz",
        "npcd-iter-000000003.npz"]


class _Idx(JaxDataset):
    def _init_samples(self, n):
        self.samples = [{"i": np.array([i])} for i in range(n)]


@pytest.mark.parametrize("shard", [0, 1])
def test_batch_loader_shards_match_jax(shard):
    n = 9
    jl = JaxBatchLoader(_Idx(n=n, verbose=False), 8, shuffle=True, drop_last=True, seed=77,
                        num_shards=2, shard_index=shard)
    ids = np.broadcast_to(np.arange(n, dtype=np.float32)[:, None, None], (n, 1, 3))
    pl = BatchLoader(PointNeRFDataset(ids, np.zeros((n, 1, 1))), 8, seed=77, num_shards=2,
                     shard_index=shard)
    assert pl.batch_size == jl.batch_size == 4
    np.testing.assert_array_equal(pl.indices, jl.indices)  # strided, wrap-padded
    assert len(pl) == len(jl) == 1
    for _ in range(3):  # three epochs
        want = [b["i"][:, 0].tolist() for b in jl]
        assert [b["coords"][:, 0, 0].astype(int).tolist() for b in pl] == want
    with pytest.raises(ValueError, match="divide"):
        BatchLoader(PointNeRFDataset(ids, np.zeros((n, 1, 1))), 7, num_shards=2)


@pytest.mark.parametrize("n", [6, 7, 2])
def test_mesh_rows_partition(n):
    """Mesh.rows: n / world rows each, in rank order; an indivisible n
    raises, or with uneven=True splits as np.array_split does."""
    world = 3
    meshes = [mesh_module.Mesh(world, r, r, torch.device("cpu"), "gloo") for r in range(world)]
    want = np.array_split(np.arange(n), world)
    for m, part in zip(meshes, want):
        np.testing.assert_array_equal(np.arange(n)[m.rows(n, uneven=True)], part)
        if n % world:
            with pytest.raises(ValueError, match="divide"):
                m.rows(n)
        else:
            assert m.rows(n) == m.rows(n, uneven=True)
            assert list(mesh_module.shard_batch(range(n), m)) == list(part)


def test_launch_returns_each_rank(monkeypatch):
    monkeypatch.setattr(mesh_module, "LAUNCH_TIMEOUT_S", 120.0)
    out = launch(launched_rank, ("t",), world=2)
    assert out == [{"rank": r, "world": 2, "sum": 2.0, "tag": "t", "initialized": True}
                   for r in range(2)]


def test_launch_fails_with_the_rank_that_raised(monkeypatch):
    monkeypatch.setattr(mesh_module, "LAUNCH_TIMEOUT_S", 120.0)
    monkeypatch.setattr(mesh_module, "GRACE_S", 5.0)
    with pytest.raises(RuntimeError, match="rank 1 raised:(.|\n)*rank 1 fails"):
        launch(launched_failure, (1,), world=2)

"""Row-sharded stage-1 tables of the PyTorch port
(npcd_tpu_torch/parallel/pointnerf_sharding.py,
PointNeRFTraining(shard_tables=True)) against npcd_tpu's step with
shard_pointnerf_params (tests/test_parallel.py:139's recipe) on a 2-device
CPU mesh, on tests/test_torch_pointnerf_training.py's tiny model with its
draws injected into both sides (tests/test_torch_parallel_stage1.py's
set-up).

At n_obj 8 and 9 (9 rows split 5 + 4, np.array_split's parts; npcd_tpu's
NamedSharding cannot split 9 rows over 2 devices, so there its reference
is the same step with the tables replicated, the math sharding must not
change): from a train state bridged after two of npcd_tpu's steps, two
steps on global batches of 4 objects, 2 a rank. Each step's loss within
1e-5 relative of npcd_tpu's (its DP tolerance); the tables after the steps
within rtol 1e-4 / atol 1e-6 of npcd_tpu's; every parameter bitwise equal to
the port's replicated-table DP step (tests/test_torch_parallel_stage1.py),
the tables gathered; each rank's shard holds its rows(n_obj, uneven=True)
and nothing else, the coords table's too. The planted fault, an owner that
leaves its rows outside the batch undecayed, must miss npcd_tpu's tables.

Then a 2-rank sharded run of configs/npcd_synthetic_tiny.yaml's 4 steps:
its checkpoint and export hold whole tables in the layout of an unsharded
run, bitwise the shards; an unsharded trainer restores it, and a sharded
trainer restores an unsharded run's checkpoint, each at step 4."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from npcd_tpu.losses import PointNeRFLossWeights as JaxWeights
from npcd_tpu.parallel import make_mesh as jax_make_mesh
from npcd_tpu.parallel import replicate as jax_replicate
from npcd_tpu.parallel import shard_batch as jax_shard_batch
from npcd_tpu.parallel import shard_pointnerf_params
from npcd_tpu.train.pointnerf_training import (PointNeRFTrainState, make_pointnerf_optimizer,
                                               make_pointnerf_train_step)
from npcd_tpu.utils.builders import build_pointnerf as jax_build_pointnerf
from npcd_tpu.utils.config import load_config as jax_load_config
from npcd_tpu_torch.data import SyntheticNPCTrain
from npcd_tpu_torch.losses import PointNeRFLossWeights
from npcd_tpu_torch.parallel import Mesh, pointnerf_param_specs
from npcd_tpu_torch.train import PointNeRFTraining
from npcd_tpu_torch.utils.builders import build_dataset, build_pointnerf
from npcd_tpu_torch.utils.config import load_config
from npcd_tpu_torch.utils.from_jax import LATENTS, pointnerf_train_state_from_jax
from test_torch_pointnerf_training import (LR, WEIGHTS, _assert_margins, _config, _draws,
                                           _jax_batch)
from torch_parallel_worker import start_group

# two single-process steps (for the moments), then the two sharded steps,
# which leave two objects out (4 and 7: only Adam's decay moves them); with
# 9 objects the last object is in both sharded steps
BATCHES = {8: ([0, 3, 5, 6], [1, 2, 4, 7], [0, 3, 1, 2], [5, 6, 0, 3]),
           9: ([0, 3, 5, 8], [1, 2, 4, 7], [0, 8, 1, 2], [5, 6, 8, 3])}
WARM = 2
# the draws' seeds: no sample within the margin of the kNN radius
SEEDS = {8: 40, 9: 44}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sized(loader, n_obj):
    cfg = _config(loader)
    cfg["dataset_kwargs"]["n_obj"] = cfg["model"]["n_obj"] = n_obj
    return cfg


def _jax_sharded(tree, mesh, n_obj, shard):
    """The leaves of a table's shape row-sharded over 'data' (when
    ``shard``), the rest replicated."""
    def put(x):
        spec = PartitionSpec("data") if shard and x.ndim and x.shape[0] == n_obj else \
            PartitionSpec()
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, tree)


@pytest.fixture(scope="module", params=[8, 9])
def run(request, tmp_path_factory):
    n_obj = request.param
    tmp = tmp_path_factory.mktemp(f"sharded{n_obj}")
    jmodel = jax_build_pointnerf(_sized(jax_load_config, n_obj))
    config = _sized(load_config, n_obj)
    ds = SyntheticNPCTrain(**config["dataset_kwargs"])
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(np.asarray, jmodel.set_all_coords(params,
                                                                     ds.get_all_coords()))
    rng = np.random.default_rng(1)
    f = jmodel.opts.feat_dim
    table = params["feats_table"].copy()
    table[..., :f] = rng.normal(scale=0.5, size=table[..., :f].shape)
    table[..., f:] = rng.normal(scale=0.2, size=table[..., f:].shape)
    params["feats_table"] = table
    tx = make_pointnerf_optimizer(LR)
    step_fn = make_pointnerf_train_step(jmodel, tx, JaxWeights(*WEIGHTS), donate=False,
                                        presampled_images=True)
    data = []
    for i, objs in enumerate(BATCHES[n_obj]):
        batch = ds.batch(objs)
        draws = _draws(SEEDS[n_obj] + i, len(objs), batch["extrinsics"].shape[1], jmodel.opts)
        _assert_margins(jmodel.opts, ds.get_all_coords()[objs], batch, draws)
        data.append((batch, draws))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = PointNeRFTrainState(params=params, opt_state=tx.init(params),
                                step=jnp.zeros((), jnp.int32))
    for i in range(WARM):
        state, _ = step_fn(state, _jax_batch(*data[i]), jax.random.PRNGKey(i))
    get = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    bridged = pointnerf_train_state_from_jax(get(state.params), get(state.opt_state), state.step)
    kw = dict(config=config, bridged=bridged, weights=WEIGHTS, lr=LR,
              batches=[b for b, _ in data[WARM:]], draws=[d for _, d in data[WARM:]])
    jobs = {"sharded": ("sharded_stage1_steps", dict(kw, out_dir=str(tmp / "sharded"))),
            "replicated": ("stage1_steps", dict(kw, out_dir=str(tmp / "replicated"))),
            "fault": ("sharded_stage1_steps", dict(kw, out_dir=str(tmp / "fault"), fault=True))}
    ranks = start_group(jobs, tmp)

    # npcd_tpu: the tables row-sharded over the 2-device mesh (replicated
    # where 'data' cannot split them), the batch sharded, the draws replicated
    mesh = jax_make_mesh(n_devices=2)
    shard = n_obj % 2 == 0
    state = PointNeRFTrainState(
        params=shard_pointnerf_params(state.params, mesh) if shard
        else jax_replicate(state.params, mesh),
        opt_state=_jax_sharded(state.opt_state, mesh, n_obj, shard),
        step=jax_replicate(state.step, mesh))
    want = []
    for i in range(WARM, len(BATCHES[n_obj])):
        jbatch = _jax_batch(*data[i])
        draws = jax_replicate(jbatch.pop("draws"), mesh)
        jbatch = {**jax_shard_batch(jbatch, mesh), "draws": draws}
        state, metrics = step_fn(state, jbatch, jax.random.PRNGKey(i))
        want.append({k: float(v) for k, v in metrics.items()})
    sharded_ok = not shard or not state.params["feats_table"].sharding.is_fully_replicated
    return {"n_obj": n_obj, "want": want, "ranks": ranks(), "sharded_ok": sharded_ok,
            "state": pointnerf_train_state_from_jax(get(state.params), get(state.opt_state),
                                                    state.step)}


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """An unsharded run of the tiny config in this process, then the 2-rank
    sharded run (which also restores the unsharded run's checkpoint)."""
    tmp = tmp_path_factory.mktemp("sharded_loop")
    unsharded = _tiny_trainer(tmp / "unsharded")()
    ranks = start_group({"run": ("sharded_stage1_run", dict(
        config=_config(load_config), out_dir=str(tmp / "run"),
        replicated_dir=str(tmp / "unsharded")))}, tmp)()
    return {"tmp": tmp, "unsharded": unsharded, "ranks": [r["run"] for r in ranks]}


def _tiny_trainer(out, mesh=None, shard_tables=False):
    import random

    config = _config(load_config)
    return PointNeRFTraining(str(out), build_pointnerf(config, torch.Generator().manual_seed(42),
                                                       with_tables=True),
                             build_dataset(config, view_rng=random.Random(42)),
                             loss_weights=PointNeRFLossWeights(1.0, 1e-7, 3.5e-7), seed=42,
                             device="cpu", verbose=False, mesh=mesh, shard_tables=shard_tables,
                             **config["pointnerf_training"])


def _outside(n_obj):
    """The objects in neither sharded step's batch."""
    return sorted(set(range(n_obj)) - set(np.concatenate(BATCHES[n_obj][WARM:]).tolist()))


def test_sharded_steps_match_jax(run):
    assert run["sharded_ok"]  # npcd_tpu's tables kept their row sharding (n_obj 8)
    for step, want in enumerate(run["want"]):
        for r, rank in enumerate(run["ranks"]):
            got = rank["sharded"]["steps"][step]
            for k in ("loss", "00_image_reconstruction_loss", "01_neural_point_cloud_kl",
                      "02_neural_point_cloud_tv"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           err_msg=f"step {step} rank {r} {k}")
    want = run["state"]["params"]
    outside = _outside(run["n_obj"])
    assert len(outside) == 2
    steps = len(BATCHES[run["n_obj"]]) - WARM
    w = want["tables.feats_table"]
    for rank in run["ranks"]:
        got = rank["sharded"]["params"]
        np.testing.assert_array_equal(got["tables.coords_table"], want["tables.coords_table"])
        g = got["tables.feats_table"]
        # rows in no batch, moved by Adam's decay alone: npcd_tpu's tolerance
        np.testing.assert_allclose(g[outside], w[outside], rtol=1e-4, atol=1e-6)
        # the batches' rows, as tests/test_torch_parallel_stage1.py holds the
        # replicated tables: a pair at a leaky_relu kink moves a gradient by
        # ~1e-3 of its scale, and a near-zero gradient of the other sign moves
        # Adam's step by up to 2 lr; every element within 2 lr a step, all but
        # 0.1% within 1e-3 of the table's scale
        err = np.abs(g - w)
        assert err.max() <= 2 * steps * LR, err.max()
        assert (err > 1e-3 * np.abs(w).max()).mean() <= 1e-3


def test_sharded_equals_replicated_dp_step(run):
    """Bitwise the port's replicated-table DP step: the same gradient rows
    reach each owner, and Adam updates every row alike."""
    for r, rank in enumerate(run["ranks"]):
        got, want = rank["sharded"], rank["replicated"]
        assert set(got["params"]) == set(want["params"]) | {"tables.coords_table"}
        for name, v in want["params"].items():
            np.testing.assert_array_equal(got["params"][name], v, err_msg=f"rank {r} {name}")
        for s, w in zip(got["steps"], want["steps"]):
            assert s["loss"] == w["loss"]
            np.testing.assert_allclose(s["grad_norm"], w["grad_norm"], rtol=1e-6)


def test_each_rank_holds_its_rows(run):
    n_obj = run["n_obj"]
    parts = np.array_split(np.arange(n_obj), 2)
    full = run["ranks"][0]["sharded"]["params"]
    for r, rank in enumerate(run["ranks"]):
        got = rank["sharded"]
        mesh = Mesh(2, r, r, torch.device("cpu"), "gloo")
        own = mesh.rows(n_obj, uneven=True)
        assert got["own"] == (own.start, own.stop) == (parts[r][0], parts[r][-1] + 1)
        assert got["shard"].shape[0] == got["coords_shard"].shape[0] == len(parts[r])
        np.testing.assert_array_equal(got["shard"], full["tables.feats_table"][own])
        np.testing.assert_array_equal(got["coords_shard"], full["tables.coords_table"][own])
    assert pointnerf_param_specs(list(full)) == {
        n: "data" if n.startswith("tables.") else None for n in full}


def test_skipped_decay_fails(run):
    """The planted fault: an owner leaves the rows outside the batch as they
    were (no Adam decay): its table misses npcd_tpu's rows in no batch."""
    outside = _outside(run["n_obj"])
    want = run["state"]["params"]["tables.feats_table"][outside]
    got = run["ranks"][0]["fault"]["params"]["tables.feats_table"][outside]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_sharded_loop_checkpoint_and_restore(loop):
    tmp = loop["tmp"]
    r0, r1 = loop["ranks"]
    assert r0["step"] == r1["step"] == 4
    np.testing.assert_array_equal(r0["table"], r1["table"])
    np.testing.assert_array_equal(np.concatenate([r0["shard"], r1["shard"]]), r0["table"])
    # the export: whole tables (the feats mean half), an unsharded run's names
    ckpts = sorted(n for n in os.listdir(tmp / "run" / "checkpoints") if not n.endswith(".json"))
    assert ckpts == ["pointnerf_training-iter-000000004"]
    unsharded = loop["unsharded"]
    with np.load(tmp / "run" / "weights_only_checkpoints_dir" / "pointnerf-iter-000000004.npz") \
            as z, np.load(tmp / "unsharded" / "weights_only_checkpoints_dir" /
                          "pointnerf-iter-000000004.npz") as w:
        assert {k: z[k].shape for k in z.files} == {k: w[k].shape for k in w.files}
        f = z[f"{LATENTS}.feats_table"].shape[-1]
        np.testing.assert_array_equal(z[f"{LATENTS}.feats_table"], r0["table"][..., :f])
    # an unsharded trainer restores the sharded run's checkpoint
    again = _tiny_trainer(tmp / "run")
    assert again.step == 4
    np.testing.assert_array_equal(again.model.tables.feats_table.detach().numpy(), r0["table"])
    assert again.optimizer.state[again.model.tables.feats_table]["exp_avg"].shape == \
        r0["table"].shape
    # a sharded trainer (both ranks) restored the unsharded run's checkpoint
    table = unsharded.model.tables.feats_table
    mu = unsharded.optimizer.state[table]["exp_avg"]
    for rank in (r0, r1):
        own = slice(*rank["own"])
        assert rank["restored_step"] == 4
        np.testing.assert_array_equal(rank["restored_shard"], table.detach().numpy()[own])
        np.testing.assert_array_equal(rank["restored_mu"], mu.numpy()[own])

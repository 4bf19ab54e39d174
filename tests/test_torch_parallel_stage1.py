"""Data parallelism of the PyTorch port's stage-1 step (PointNeRFTraining
under a mesh) against npcd_tpu's step on a 2-device CPU mesh, on
tests/test_torch_pointnerf_training.py's tiny model (train_rays =
ray_subsamples, so that npcd_tpu's ray selection is a permutation; feats
eps, pixel subset and depth jitter injected into both sides for the global
batch).

From a train state bridged after two of npcd_tpu's steps (nonzero Adam
moments), two steps on global batches of 4 objects, 2 a rank, chosen so
that the ranks see different valid-ray counts (asserted from npcd_tpu's
forward): the loss and its three parts within 1e-5 relative (npcd_tpu's DP
tolerance), every reduced gradient leaf, the feats table's included, within
5e-3 of its scale (tests/test_torch_pointnerf_training.py's tolerance: a
pair at a leaky_relu kink moves the lower layers' columns by ~1e-3), and the
parameters after the steps as that file holds the single-process step; the
ranks' parameters bitwise equal, and equal to the port's own step on the
whole batch in one process within npcd_tpu's DP tolerance (rtol 1e-4, atol
1e-6). The planted fault, each rank's loss its own mean averaged over the
ranks, must fall outside the loss's and the gradients' tolerances.

The margins of test_torch_pointnerf_training (no sample, shading point or
TV pair within 1e-4 of the kNN radius) are asserted for every batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npcd_tpu.losses import PointNeRFLossWeights as JaxWeights
from npcd_tpu.parallel import make_mesh as jax_make_mesh
from npcd_tpu.parallel import replicate as jax_replicate
from npcd_tpu.parallel import shard_batch as jax_shard_batch
from npcd_tpu.train.pointnerf_training import (PointNeRFTrainState, make_pointnerf_optimizer,
                                               make_pointnerf_train_step)
from npcd_tpu.utils.builders import build_pointnerf as jax_build_pointnerf
from npcd_tpu.utils.config import load_config as jax_load_config
from npcd_tpu_torch.data import SyntheticNPCTrain
from npcd_tpu_torch.losses import PointNeRFLossWeights
from npcd_tpu_torch.train import PointNeRFTraining
from npcd_tpu_torch.utils.builders import build_pointnerf
from npcd_tpu_torch.utils.config import load_config
from npcd_tpu_torch.utils.from_jax import pointnerf_train_state_from_jax
from test_torch_pointnerf_training import (LR, WEIGHTS, _assert_margins, _config, _draws,
                                           _jax_batch, _jax_loss_fn, _leaf_close)
from torch_parallel_worker import start_group

# two single-process steps (for the moments), then the two DP steps
BATCHES = ([0, 3, 5, 6], [1, 2, 4, 7], [0, 3, 1, 2], [5, 6, 4, 7])
WARM = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(jmodel, ds):
    o = jmodel.opts
    out = []
    for i, objs in enumerate(BATCHES):
        batch = ds.batch(objs)
        draws = _draws(40 + i, len(objs), batch["extrinsics"].shape[1], o)
        _assert_margins(o, ds.get_all_coords()[objs], batch, draws)
        out.append((batch, draws))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp1")
    jmodel = jax_build_pointnerf(_config(jax_load_config))
    config = _config(load_config)
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
    data = _data(jmodel, ds)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = PointNeRFTrainState(params=params, opt_state=tx.init(params),
                                step=jnp.zeros((), jnp.int32))
    for i in range(WARM):
        state, _ = step_fn(state, _jax_batch(*data[i]), jax.random.PRNGKey(i))
    get = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    bridged = pointnerf_train_state_from_jax(get(state.params), get(state.opt_state), state.step)
    kw = dict(config=config, bridged=bridged, weights=WEIGHTS, lr=LR,
              batches=[b for b, _ in data[WARM:]], draws=[d for _, d in data[WARM:]])
    ranks = start_group({"steps": ("stage1_steps", dict(kw, out_dir=str(tmp / "steps"))),
                         "fault": ("stage1_steps", dict(kw, out_dir=str(tmp / "fault"),
                                                        fault=True))}, tmp)

    @jax.jit
    def grads_and_valid(params, jbatch):
        pred, _ = jmodel.forward(params, jbatch["obj_idx"], jbatch["intrinsics"],
                                 jbatch["extrinsics"], rng=jax.random.PRNGKey(5), train=True,
                                 draws=jbatch["draws"])
        return jax.grad(_jax_loss_fn(jmodel, jbatch))(params), pred["ray_valid"]

    mesh = jax_make_mesh(n_devices=2)
    state = jax_replicate(state, mesh)
    want, valid = [], []
    for i in range(WARM, len(BATCHES)):
        jbatch = _jax_batch(*data[i])
        draws = jax_replicate(jbatch.pop("draws"), mesh)
        jbatch = {**jax_shard_batch(jbatch, mesh), "draws": draws}
        grads, ray_valid = grads_and_valid(state.params, jbatch)
        valid.append(np.asarray(ray_valid).reshape(2, -1).sum(1))  # each rank's rows
        grads = pointnerf_train_state_from_jax(get(grads), tx.init(get(grads)), 0)["params"]
        state, metrics = step_fn(state, jbatch, jax.random.PRNGKey(i))
        want.append({"grads": grads, **{k: float(v) for k, v in metrics.items()}})

    single = PointNeRFTraining(str(tmp / "single"), build_pointnerf(config, with_tables=True),
                               ds, batch_size=4, base_learning_rate=LR, max_epochs=100,
                               loss_weights=PointNeRFLossWeights(*WEIGHTS), device="cpu",
                               save_checkpoint_interval_min=1e9, verbose=False)
    single.load_bridged_state(bridged)
    for batch, draws in data[WARM:]:
        single.train_step(batch, draws)
    return {"want": want, "valid": valid, "ranks": ranks(), "single": single,
            "state": pointnerf_train_state_from_jax(get(state.params), get(state.opt_state),
                                                    state.step)}


@pytest.mark.parametrize("step", range(len(BATCHES) - WARM))
def test_stage1_steps_match_jax_mesh(run, step):
    counts = run["valid"][step]
    assert counts[0] != counts[1] and counts.min() > 0  # the ranks' valid rays differ
    got = run["ranks"][0]["steps"]["steps"][step]
    want = run["want"][step]
    for k in ("loss", "00_image_reconstruction_loss", "01_neural_point_cloud_kl",
              "02_neural_point_cloud_tv"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert set(got["grads"]) == set(want["grads"]) - {"tables.coords_table"}
    # grad_norm: the norm of the reduced gradient itself, and npcd_tpu's
    # global norm within the leaves' tolerance
    norm = lambda grads: np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                     for g in grads.values()))
    np.testing.assert_allclose(got["grad_norm"], norm(got["grads"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], norm({n: want["grads"][n] for n in got["grads"]}),
                               rtol=5e-3)
    for name, g in got["grads"].items():
        assert float(np.abs(g).max()) > 0, f"{name} got no gradient"
        _leaf_close(g, want["grads"][name], 5e-3, f"step {step} grad {name}")
    other = run["ranks"][1]["steps"]["steps"][step]["grads"]
    for name, g in got["grads"].items():
        np.testing.assert_array_equal(g, other[name], err_msg=name)  # the same reduce


def test_stage1_state_after_steps(run):
    r0, r1 = (r["steps"]["params"] for r in run["ranks"])
    for name in r0:
        np.testing.assert_array_equal(r0[name], r1[name], err_msg=name)  # bitwise
    want = run["state"]["params"]
    steps = len(BATCHES) - WARM
    for name, v in r0.items():
        err = np.abs(v - want[name])
        assert err.max() <= 2 * steps * LR, f"{name}: {err.max()}"
        assert (err > 1e-3 * np.abs(want[name]).max()).mean() <= 1e-3, name
    single = dict(run["single"].model.named_parameters())
    for name, v in r0.items():
        np.testing.assert_allclose(v, single[name].detach().numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_stage1_per_rank_mean_fails(run):
    """The planted fault: each rank's reconstruction a mean over its own
    valid rays, the ranks' losses averaged."""
    got = run["ranks"][0]["fault"]["steps"][0]
    want = run["want"][0]
    assert abs(got["00_image_reconstruction_loss"] / want["00_image_reconstruction_loss"]
               - 1) > 1e-5
    bad = []
    for name, g in got["grads"].items():
        try:
            _leaf_close(g, want["grads"][name], 5e-3, name)
        except AssertionError:
            bad.append(name)
    assert bad, "the per-rank mean's gradients pass the tolerance"

"""Stage-1 training of the PyTorch port against npcd_tpu, on the CPU, on
configs/npcd_synthetic_tiny.yaml (8 objects x 32 points x 8 features, 2
views of 16x16, 32 presampled rays x 24 depth samples, 8 shading slots,
k 8) with train_rays = ray_subsamples = 32, so that npcd_tpu's ray
selection (drawn from a key the port cannot replay) is only a permutation
of the presampled rays; pred is compared in presample order (ray_sel).
The other draws (feats eps, pixel subset, depth jitter) are injected into
both sides through ``draws``.

Discrete decisions: npcd_tpu's validity and kNN run its XLA dot form
|x|^2 - 2x.p + |p|^2 on the CPU (error ~3e-7 absolute at |x|^2 ~ 3, 1.2e-5
of radius^2), the port the direct sum. The tests assert that no sample,
shading point or TV pair lies within 1e-4 (relative) of the radius and
that no point has more than k in-radius neighbours, so that another seed
fails loudly instead of flakily.

Leaky_relu's kink: the layer-1 input differs by up to 2e-5 between the
two sides (torch's and XLA's sin/cos an ulp apart, doubled by each step of
the anchored recurrence), so a hidden pre-activation within a few 1e-6 of
0 can take slope 1 on one side and 0.01 on the other; at this size ~5% of
the (point, neighbour) pairs have one. Each such pair moves whole columns
of the lower layers' dW by up to ~1e-3 of the leaf's scale, while each
pair's share of a sum is large (a few hundred pairs per step). The
gradient tolerances below allow for that; the kernel tests
(test_torch_fused_mlp_bwd.py) take the kinked pairs out and hold the
backward at 1e-5.

Tolerances are stated where they are used."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npcd_tpu.losses import PointNeRFLossWeights as JaxWeights
from npcd_tpu.losses import pointnerf_loss as jax_loss
from npcd_tpu.train.pointnerf_training import (PointNeRFTrainState, make_pointnerf_optimizer,
                                               make_pointnerf_train_step)
from npcd_tpu.utils.builders import build_pointnerf as jax_build_pointnerf
from npcd_tpu.utils.config import load_config as jax_load_config
from npcd_tpu_torch.data import SyntheticNPCTrain
from npcd_tpu_torch.losses import PointNeRFLossWeights, pointnerf_loss
from npcd_tpu_torch.models.pointnerf.aggregator import compact_valid_samples
from npcd_tpu_torch.models.pointnerf.math_utils import (fill_invalid_ray_limits,
                                                        get_ray_limits_box)
from npcd_tpu_torch.models.pointnerf.ray_sampler import generate_rays
from npcd_tpu_torch.models.pointnerf.renderer import sample_depths
from npcd_tpu_torch.train import PointNeRFTraining
from npcd_tpu_torch.train_diffusion import load_pointnerf_weights
from npcd_tpu_torch.utils.builders import build_pointnerf
from npcd_tpu_torch.utils.config import load_config
from npcd_tpu_torch.utils.from_jax import pointnerf_train_state_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs/npcd_synthetic_tiny.yaml")
MARGIN = 1e-4
LR = 1e-3
# KL and TV weighted up from the CLI's 1e-7 / 3.5e-7, so that their
# gradients show next to the reconstruction's
WEIGHTS = (1.0, 1e-2, 1e-2)
BATCHES = ([0, 3, 5, 6], [1, 2, 4, 7], [2, 3, 6, 7], [0, 1, 4, 5], [1, 3, 5, 7])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny models: their small ops gain
    nothing from a thread pool, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(loader):
    cfg = loader(CONFIG)
    cfg["render_config"] = {**cfg["render_config"], "train_rays": 32}
    return cfg


@pytest.fixture(scope="module")
def setup():
    """npcd_tpu's PointNeRF with a random feats table (both halves) and the
    coords of the synthetic dataset, and the port's model bridged from it."""
    jmodel = jax_build_pointnerf(_config(jax_load_config))
    ds = SyntheticNPCTrain(**_config(load_config)["dataset_kwargs"])
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
    bridged = pointnerf_train_state_from_jax(params, tx.init(params), 0)
    return {"jmodel": jmodel, "params": params, "ds": ds, "tx": tx, "bridged": bridged}


def _port_model(setup):
    model = build_pointnerf(_config(load_config), with_tables=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in setup["bridged"]["params"].items()})
    return model


def _draws(seed, b, v, o):
    rng = np.random.default_rng(seed)
    r_pre, res = o.renderer.ray_subsamples, o.default_resolution
    return {"feats_eps": rng.normal(size=(b, o.num_points, o.feat_dim)).astype(np.float32),
            "pixel_idx": rng.choice(res * res, r_pre, replace=False).astype(np.int32),
            "depth_jitter": rng.uniform(size=(b * v, r_pre, o.renderer.depth_resolution)
                                        ).astype(np.float32)}


def _assert_margins(o, coords, batch, draws):
    """The discrete decisions of the step cannot differ between npcd_tpu's
    dot-form distances and the port's direct ones (see the module doc)."""
    r2 = o.knn_radius ** 2
    b, v = batch["extrinsics"].shape[:2]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    rays_o, rays_d = generate_rays(t(batch["extrinsics"]).reshape(-1, 4, 4),
                                   t(batch["intrinsics"]).reshape(-1, 3, 3),
                                   o.default_resolution, t(draws["pixel_idx"]))
    start, end = fill_invalid_ray_limits(*get_ray_limits_box(rays_o, rays_d,
                                                             o.renderer.cube_scale))
    depths = sample_depths(start[..., 0], end[..., 0], o.renderer.depth_resolution,
                           t(draws["depth_jitter"]), o.renderer.disparity_space_sampling)
    kp = np.repeat(coords, v, axis=0).astype(np.float64)  # [I, P, 3]

    def d2(x):  # x [I, N, 3] -> [I, N, P] in float64
        return ((x.astype(np.float64)[:, :, None] - kp[:, None]) ** 2).sum(-1)

    x = (rays_o[:, :, None] + depths[..., None] * rays_d[:, :, None]).numpy()
    dmin = d2(x.reshape(len(kp), -1, 3)).min(-1)
    assert (np.abs(dmin - r2) / r2).min() > MARGIN, "a sample lies at the radius: reseed"
    valid = torch.from_numpy((dmin < r2).reshape(depths.shape))
    assert 0.02 < valid.float().mean() < 0.98
    depths_c, mask = compact_valid_samples(valid, depths, o.aggregator.max_shading_pts)
    pts = (rays_o[:, :, None] + depths_c[..., None] * rays_d[:, :, None]).numpy()
    dp = d2(pts.reshape(len(kp), -1, 3))[mask.reshape(len(kp), -1).numpy()]
    assert (np.abs(dp - r2) / r2).min() > MARGIN, "a neighbour lies at the radius: reseed"
    assert (dp < r2).sum(-1).max() <= o.aggregator.k
    dtv = ((coords[:, :, None].astype(np.float64) - coords[:, None]) ** 2).sum(-1)
    assert (np.abs(dtv - r2) / r2).min() > MARGIN, "a TV pair lies at the radius: reseed"
    assert (dtv < r2).sum(-1).max() <= o.aggregator.k


def _batch(setup, i, seed):
    """(full-frame batch, draws), margins asserted."""
    o = setup["jmodel"].opts
    batch = setup["ds"].batch(BATCHES[i])
    draws = _draws(seed, len(BATCHES[i]), batch["extrinsics"].shape[1], o)
    _assert_margins(o, setup["ds"].get_all_coords()[BATCHES[i]], batch, draws)
    return batch, draws


def _jax_batch(batch, draws):
    j = {k: jnp.asarray(batch[k]) for k in ("obj_idx", "intrinsics", "extrinsics")}
    j["images"] = jnp.asarray(batch["images"][:, :, draws["pixel_idx"]])
    j["draws"] = {k: jnp.asarray(v) for k, v in draws.items()}
    return j


def _by_presample(a, sel):
    """[B, V, R, ...] in selection order -> presample order."""
    out = np.empty_like(a)
    np.put_along_axis(out, sel.reshape(sel.shape + (1,) * (a.ndim - 3)), a, axis=2)
    return out


def _forward(model, batch, draws):
    """The port's train forward on a full-frame batch with injected draws."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return model(t(batch["obj_idx"]).long(), t(batch["intrinsics"]), t(batch["extrinsics"]),
                 t(draws["pixel_idx"]), generator=torch.Generator().manual_seed(0),
                 draws={k: t(draws[k]) for k in ("feats_eps", "depth_jitter")})


def test_forward_train_matches_jax(setup):
    batch, draws = _batch(setup, 0, seed=10)
    jpred, jaux = setup["jmodel"].forward(
        setup["params"], jnp.asarray(batch["obj_idx"]), jnp.asarray(batch["intrinsics"]),
        jnp.asarray(batch["extrinsics"]), rng=jax.random.PRNGKey(3), train=True,
        draws={k: jnp.asarray(v) for k, v in draws.items()})
    model = _port_model(setup)
    pred, aux = _forward(model, batch, draws)
    jsel, sel = np.asarray(jpred["ray_sel"]), pred["ray_sel"].numpy()
    assert sorted(sel[0, 0]) == list(range(32))  # a permutation of the presampled rays
    np.testing.assert_array_equal(np.take(draws["pixel_idx"], sel), pred["ray_idx"].numpy())
    valid = _by_presample(np.asarray(jpred["ray_valid"]), jsel)
    np.testing.assert_array_equal(_by_presample(pred["ray_valid"].numpy(), sel), valid)
    assert 0.05 < valid.mean() < 0.95
    # f32 through the aggregation MLP, the heads and the ray march in another
    # summation order (sin/cos an ulp apart): 1e-5 on values in [0, 1]
    for key in ("channels", "mask", "depth"):
        np.testing.assert_allclose(_by_presample(pred[key].detach().numpy(), sel),
                                   _by_presample(np.asarray(jpred[key]), jsel), rtol=0,
                                   atol=1e-5, err_msg=key)
    for key in ("coords", "feats", "feats_mean", "feats_log_var", "feats_std"):
        np.testing.assert_allclose(aux[key].detach().numpy(), np.asarray(jaux[key]),
                                   rtol=1e-6, atol=0, err_msg=key)


@pytest.mark.parametrize("valid_share", [0.6, 1.0])
def test_loss_parts_match_jax(setup, valid_share):
    """The three losses on the same pred/aux (random numbers of the step's
    shapes; coords of the dataset, so the TV kNN has in-radius pairs), with
    some or all of the selected rays valid; the images are the presampled
    pixels, gathered through ray_sel."""
    o = setup["jmodel"].opts
    rng = np.random.default_rng(4)
    b, v, r, p, f = 4, 2, 32, o.num_points, o.feat_dim
    sel = np.stack([rng.permutation(r) for _ in range(b * v)]).reshape(b, v, r)
    pred = {"channels": rng.uniform(size=(b, v, r, 3)).astype(np.float32),
            "ray_valid": rng.uniform(size=(b, v, r)) < valid_share,
            "ray_sel": sel.astype(np.int32),
            "ray_idx": (sel * 7).astype(np.int32)}
    coords = setup["ds"].get_all_coords()[:b]
    aux = {"coords": coords, "feats": rng.normal(size=(b, p, f)).astype(np.float32),
           "feats_mean": rng.normal(size=(b, p, f)).astype(np.float32),
           "feats_log_var": rng.normal(scale=0.3, size=(b, p, f)).astype(np.float32)}
    images = rng.uniform(size=(b, v, r, 3)).astype(np.float32)
    dtv = ((coords[:, :, None].astype(np.float64) - coords[:, None]) ** 2).sum(-1)
    r2 = o.knn_radius ** 2
    assert (np.abs(dtv - r2) / r2).min() > MARGIN and (dtv < r2).sum(-1).max() <= o.aggregator.k
    assert ((dtv < r2).sum(-1) > 1).any()  # some point has a neighbour besides itself
    _, want = jax_loss({"images": jnp.asarray(images)},
                       {k: jnp.asarray(a) for k, a in pred.items()},
                       {k: jnp.asarray(a) for k, a in aux.items()}, o, JaxWeights(*WEIGHTS),
                       presampled_images=True)
    _, got = pointnerf_loss({"images": torch.from_numpy(images)},
                            {k: torch.from_numpy(a) for k, a in pred.items()},
                            {k: torch.from_numpy(a) for k, a in aux.items()}, o,
                            PointNeRFLossWeights(*WEIGHTS))
    assert set(got) == set(want)
    for k in want:  # f32 means in another summation order: 1e-6 relative
        assert float(want[k]) > 0, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def _jax_loss_fn(jmodel, jbatch):
    def loss_fn(params):
        pred, aux = jmodel.forward(params, jbatch["obj_idx"], jbatch["intrinsics"],
                                   jbatch["extrinsics"], rng=jax.random.PRNGKey(5), train=True,
                                   draws=jbatch["draws"])
        return jax_loss(jbatch, pred, aux, jmodel.opts, JaxWeights(*WEIGHTS),
                        presampled_images=True)[0]
    return loss_fn


def _leaf_close(got, want, rel, what):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()), f"{what}: max abs err {err}"


def test_every_gradient_leaf_matches_jax(setup):
    batch, draws = _batch(setup, 1, seed=11)
    jbatch = _jax_batch(batch, draws)
    want = jax.tree_util.tree_map(np.asarray, jax.grad(_jax_loss_fn(setup["jmodel"], jbatch))(
        setup["params"]))
    want = pointnerf_train_state_from_jax(want, setup["tx"].init(setup["params"]), 0)["params"]
    model = _port_model(setup)
    pred, aux = _forward(model, batch, draws)
    loss, _ = pointnerf_loss({"images": torch.from_numpy(np.asarray(jbatch["images"]))}, pred,
                             aux, model.opts, PointNeRFLossWeights(*WEIGHTS))
    loss.backward()
    assert not model.tables.coords_table.requires_grad  # the frozen coords: a buffer
    named = dict(model.named_parameters())
    assert set(named) == set(want) - {"tables.coords_table"}
    for name, p in named.items():
        # every leaf trains (the no_grad trap would leave local_field at 0)
        # and equals JAX's within 5e-3 of the leaf's scale: f32 backward in
        # another summation order is ~1e-6, a pair at a kink (see the module
        # doc) ~1e-3 on the layers below it
        assert float(p.grad.abs().max()) > 0, f"{name} got no gradient"
        _leaf_close(p.grad.numpy(), want[name], 5e-3, name)
    rows = model.tables.feats_table.grad.abs().sum((1, 2)).numpy() > 0
    np.testing.assert_array_equal(rows, np.isin(np.arange(8), BATCHES[1]))


def _trainer(tmp_path, setup, max_epochs=1, seed=0):
    return PointNeRFTraining(str(tmp_path), build_pointnerf(_config(load_config), with_tables=True),
                             setup["ds"], batch_size=4, base_learning_rate=LR,
                             max_epochs=max_epochs, loss_weights=PointNeRFLossWeights(*WEIGHTS),
                             seed=seed, device="cpu", save_checkpoint_interval_min=1e9,
                             verbose=False)


def test_three_train_steps_match_jax(tmp_path, setup):
    jmodel, tx = setup["jmodel"], setup["tx"]
    step_fn = make_pointnerf_train_step(jmodel, tx, JaxWeights(*WEIGHTS), donate=False,
                                        presampled_images=True)
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    state = PointNeRFTrainState(params=params, opt_state=tx.init(params),
                                step=jnp.zeros((), jnp.int32))
    data = [_batch(setup, i, seed=20 + i) for i in range(5)]
    for i in range(2):  # two steps on the JAX side first: nonzero Adam moments to bridge
        state, _ = step_fn(state, _jax_batch(*data[i]), jax.random.PRNGKey(i))
    get = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    trainer = _trainer(tmp_path, setup)
    trainer.load_bridged_state(pointnerf_train_state_from_jax(
        get(state.params), get(state.opt_state), state.step))
    assert trainer.step == 2
    for i in range(2, 5):
        state, metrics = step_fn(state, _jax_batch(*data[i]), jax.random.PRNGKey(i))
        got = trainer.train_step(*data[i])
        # f32 forward/backward, other summation order: 1e-5 relative
        for k in metrics:
            np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-5, err_msg=k)
    want = pointnerf_train_state_from_jax(get(state.params), get(state.opt_state), state.step)
    assert trainer.step == want["step"] == 5
    named = dict(trainer.model.named_parameters())
    # Adam moves a parameter by ~lr per step whatever its gradient's size, so
    # a near-zero gradient of the other sign can move it up to 2 lr apart per
    # step: every element within 6 lr; and all but 0.1% of each leaf within
    # 1e-3 of its scale, the moments within 5e-3 of theirs (the kinks move
    # whole columns of the lower layers' gradients, see the module doc)
    for name, p in named.items():
        err = np.abs(p.detach().numpy() - want["params"][name])
        assert err.max() <= 6 * LR, f"{name}: {err.max()}"
        assert (err > 1e-3 * np.abs(want["params"][name]).max()).mean() <= 1e-3, name
        st = trainer.optimizer.state[p]
        assert int(st["step"]) == want["count"] == 5
        _leaf_close(st["exp_avg"].numpy(), want["mu"][name], 5e-3, f"mu {name}")
        _leaf_close(st["exp_avg_sq"].numpy(), want["nu"][name], 5e-3, f"nu {name}")
    np.testing.assert_array_equal(trainer.model.tables.coords_table.numpy(),
                                  setup["params"]["coords_table"])


def test_resume_equals_uninterrupted_run(tmp_path, setup):
    full = _trainer(tmp_path / "full", setup, max_epochs=2)()
    cut = _trainer(tmp_path / "cut", setup, max_epochs=1)()
    assert cut.step == 2
    resumed = _trainer(tmp_path / "cut", setup, max_epochs=2)
    assert resumed.step == 2
    resumed()
    a, b = full.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 4 and a["presample_rng"] == b["presample_rng"]
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k  # bitwise on the CPU
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["optimizer"]["state"][i][k]), (i, k)
    # the coords stayed the dataset's; the export is what stage 2 reads
    np.testing.assert_array_equal(a["model"]["tables.coords_table"].numpy(),
                                  setup["ds"].get_all_coords())
    ds, pointnerf = load_pointnerf_weights(full.weights_only_path(4), 32, 8)
    np.testing.assert_array_equal(ds.get_all_feats(), full.model.get_all_feats().detach()
                                  .numpy().transpose(0, 2, 1).transpose(1, 0, 2).reshape(8, -1))
    assert set(pointnerf) == {f"pointnerf.{k}" for k in full.model.mlp_state_dict()}


def test_host_presample_draws_match_jax(tmp_path, setup):
    """The shared pixel subset of each step is the draw npcd_tpu's trainer
    makes from its presample generator (pointnerf_training.py:182,225-227)
    for the same seed."""
    from npcd_tpu.data import create_dataset
    from npcd_tpu.train import PointNeRFTraining as JaxTraining

    cfg = jax_load_config(CONFIG)
    jtr = JaxTraining(str(tmp_path / "jax"), jax_build_pointnerf(cfg),
                      create_dataset(cfg["train_dataset"], verbose=False,
                                     **cfg["dataset_kwargs"]),
                      seed=9, verbose=False, **cfg["pointnerf_training"])
    trainer = _trainer(tmp_path / "port", setup, seed=9)
    batch = setup["ds"].batch(BATCHES[0])
    res2, r_pre = batch["images"].shape[2], jtr.model.opts.renderer.ray_subsamples
    model_forward = trainer.model.forward
    for _ in range(2):  # npcd_tpu's to_device, step by step
        want = jtr._presample_rng.choice(res2, size=r_pre, replace=False).astype(np.int32)
        seen = {}

        def spy(obj_idx, intrinsics, extrinsics, pixel_idx, **kw):
            seen["pixel_idx"] = pixel_idx.numpy()
            return model_forward(obj_idx, intrinsics, extrinsics, pixel_idx, **kw)

        trainer.model.forward = spy
        trainer.train_step(batch)
        trainer.model.forward = model_forward
        np.testing.assert_array_equal(seen["pixel_idx"], want)


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def test_cli_chain_stage1_stage2_generation(tmp_path):
    config = load_config(CONFIG)
    m = config["model"]
    _run(["npcd_tpu_torch.train_pointnerf", "--config", CONFIG, "--output", str(tmp_path / "pn"),
          "--device", "cpu", "--no_tensorboard"], tmp_path)
    steps = m["n_obj"] // config["pointnerf_training"]["batch_size"] * \
        config["pointnerf_training"]["max_epochs"]
    export = tmp_path / "pn" / "weights_only_checkpoints_dir" / f"pointnerf-iter-{steps:09d}.npz"
    assert (tmp_path / "pn" / "checkpoints" / f"pointnerf_training-iter-{steps:09d}").is_dir()
    with np.load(export) as z:
        assert z["latents.coords_table"].shape == (m["n_obj"], m["num_points"], 3)
        assert z["latents.feats_table"].shape == (m["n_obj"], m["num_points"], m["feats_dim"])
        assert np.abs(z["latents.feats_table"]).max() > 0  # trained away from the zero init
    _run(["npcd_tpu_torch.train_diffusion", "--config", CONFIG, "--output",
          str(tmp_path / "diffusion"), "--pointnerf_weights", str(export), "--dtype", "float32",
          "--device", "cpu", "--no_tensorboard"], tmp_path)
    n2 = config["diffusion_training"]["max_iterations"]
    ema = tmp_path / "diffusion" / "weights_only_checkpoints_dir" / (
        f"npcd-ema_power1_0min0_9999max0_9999buffers0-iter-{n2:09d}.npz")
    _run(["npcd_tpu_torch.generate_samples", "--config", CONFIG, "--out", str(tmp_path / "gen"),
          "--weights", str(ema), "--num", "2", "--batch-size", "2", "--device", "cpu"], tmp_path)
    with np.load(tmp_path / "gen" / "samples.npz") as z:
        assert z["coords"].shape == (2, 3, m["num_points"]) and np.isfinite(z["feats"]).all()


def test_cli_refuses_what_is_not_ported(tmp_path):
    from npcd_tpu_torch.train_pointnerf import parse_args, train

    base = ["--config", CONFIG, "--output", str(tmp_path)]
    with pytest.raises(ValueError, match="JAX backend"):
        train(parse_args(base + ["--device", "cpu", "--platform", "cpu"]))
    assert parse_args(base).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            train(parse_args(base))
        with pytest.raises(RuntimeError, match="no GPU"):
            train(parse_args(base + ["--mesh"]))


def test_cli_mesh_on_two_ranks(tmp_path):
    """train_pointnerf --mesh on 2 gloo ranks (a launcher's environment):
    rank 0 writes one run, whose export equals the port's one-process steps
    on the same global batches (each rank's BatchLoader shard, rank 0's rows
    first; the same seeded draws of the global batch) within npcd_tpu's DP
    tolerance (rtol 1e-4, atol 1e-6)."""
    import random

    from npcd_tpu_torch.utils.builders import build_dataset
    from torch_parallel_worker import assert_one_writer, global_batches, run_ranks

    config = load_config(CONFIG)
    out = tmp_path / "dp"
    run_ranks("npcd_tpu_torch.train_pointnerf",
              ["--config", CONFIG, "--output", out, "--device", "cpu", "--no_tensorboard",
               "--mesh"], cwd=tmp_path)
    assert_one_writer(out)
    t = config["pointnerf_training"]
    steps = config["model"]["n_obj"] // t["batch_size"] * t["max_epochs"]
    assert sorted(os.listdir(out / "checkpoints")) == [
        f"pointnerf_training-iter-{steps:09d}", f"pointnerf_training-iter-{steps:09d}.layout.json"]

    ds = build_dataset(config, view_rng=random.Random(42))
    single = PointNeRFTraining(str(tmp_path / "single"), build_pointnerf(
        config, torch.Generator().manual_seed(42), with_tables=True), ds,
        loss_weights=PointNeRFLossWeights(1.0, 1e-7, 3.5e-7), seed=42, device="cpu",
        verbose=False, **t)
    for idx in global_batches(ds, t["batch_size"], 42, 2, steps):
        single.train_step(ds.batch(idx))
    single.save_weights_only(str(tmp_path / "single.npz"))
    with np.load(out / "weights_only_checkpoints_dir" / f"pointnerf-iter-{steps:09d}.npz") as z, \
            np.load(tmp_path / "single.npz") as w:
        assert set(z.files) == set(w.files)
        for k in w.files:
            np.testing.assert_allclose(z[k], w[k], rtol=1e-4, atol=1e-6, err_msg=k)

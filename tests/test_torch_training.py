"""Stage-2 training of the PyTorch port against npcd_tpu, on the CPU: the
loss with JAX's draws replayed, three whole train steps from one bridged
train state at step 5 against make_diffusion_train_step(model,
FusedAdamWEma) (losses, every gradient leaf, the state after the steps),
every parameter getting a nonzero gradient equal to JAX's, checkpoints and
resume, the batch order, and the CLI end to end (train, then generate from
the EMA export).

The tiny denoiser: width 128, 2 layers, 2 heads of D 64 in the grouped
[Q|K|V] layout with G = 2, 16 points (17 valid tokens of a 24-token
sequence), 3 coords + 4 feats, output_proj drawn nonzero so that every
layer gets a gradient. Tolerances are stated where they are used."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from npcd_tpu.data import PointNeRFDataset as JaxPointNeRFDataset
from npcd_tpu.data.dataset import BatchLoader as JaxBatchLoader
from npcd_tpu.data.dataset import Dataset as JaxDataset
from npcd_tpu.models.diffusion import DiffusionModel as JaxDiffusionModel
from npcd_tpu.models.pointnerf import PointNeRF as JaxPointNeRF
from npcd_tpu.train.diffusion_training import DiffusionTrainState, make_diffusion_train_step
from npcd_tpu.train.fused_update import FusedAdamWEma as JaxFused
from npcd_tpu.train.fused_update import _replace_adam_state
from npcd_tpu.utils.ema import EmaConfig as JaxEmaConfig
from npcd_tpu_torch.data import BatchLoader, PointNeRFDataset
from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel
from npcd_tpu_torch.models.npcd import NPCD
from npcd_tpu_torch.train import DiffusionTraining
from npcd_tpu_torch.train_diffusion import load_pointnerf_weights
from npcd_tpu_torch.utils.checkpoint import CheckpointSaver
from npcd_tpu_torch.utils.config import load_config
from npcd_tpu_torch.utils.from_jax import (denoiser_state_dict, load_npz, pointnerf_latents,
                                           pointnerf_state_dict, save_npz, train_state_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, F, P = 3, 4, 16
MODEL = dict(coords_dim=C, feats_dim=F, num_points=P, width=128, layers=2, heads=2,
             qkv_groups=2)
LR, WD = 1e-3, 0.01
EMA = (1.0, 0.9, 0.999, False)
START = 5  # the bridged state's step and Adam count


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny models: their small ops gain
    nothing from a thread pool, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n_obj=8, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(n_obj, P, C)).astype(np.float32) * 0.4
    feats = rng.normal(size=(n_obj, P, F)).astype(np.float32)
    return coords, feats


def _jax_draws(rng, n):
    """npcd_tpu compute_loss's per-example draws (diffusion_model.py:124-140)."""
    keys = jax.vmap(lambda i: jax.random.fold_in(rng, i))(jnp.arange(n))
    t = jax.vmap(lambda k: jax.random.randint(k, (), 0, 1000))(
        jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys))
    cn = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 1), (C, P)))(keys)
    fn = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 2), (F, P)))(keys)
    return (torch.from_numpy(np.asarray(t).astype(np.int64)), torch.from_numpy(np.array(cn)),
            torch.from_numpy(np.array(fn)))


def _jax_state(seed=0):
    """npcd_tpu train state at step START: random output_proj, Adam moments
    and EMA, normalizers fitted on the data."""
    model = JaxDiffusionModel(**{k: v for k, v in MODEL.items()})
    fused = JaxFused(LR, WD, ema_cfgs=(JaxEmaConfig.from_tuple(EMA),))
    dstate = model.init(jax.random.PRNGKey(seed))
    coords, feats = _data()
    dstate = model.fit_normalizers(dstate, coords.transpose(2, 0, 1).reshape(C, -1),
                                   feats.transpose(2, 0, 1).reshape(F, -1))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(np.asarray, dstate.params)
    params["output_proj"]["kernel"] = rng.normal(
        scale=0.02, size=params["output_proj"]["kernel"].shape).astype(np.float32)
    like = lambda scale, f=lambda a: a: jax.tree_util.tree_map(
        lambda a: jnp.asarray(f(rng.normal(size=a.shape) * scale).astype(np.float32)), params)
    opt_state = fused.make_tx().init(params)
    opt_state = _replace_adam_state(opt_state, optax.ScaleByAdamState(
        count=jnp.asarray(START, jnp.int32), mu=like(1e-3), nu=like(1e-6, np.abs)))
    ema = jax.tree_util.tree_map(lambda a, d: a + d, jax.tree_util.tree_map(jnp.asarray, params),
                                 like(1e-3))
    state = DiffusionTrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=opt_state,
        ema_params=(ema,), step=jnp.asarray(START, jnp.int32),
        coords_norm=dstate.coords_norm, feats_norm=dstate.feats_norm)
    return model, fused, state


def _bridged(state):
    get = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return train_state_from_jax(get(state.params), get(state.opt_state),
                                [get(e) for e in state.ema_params], state.step,
                                state.coords_norm, state.feats_norm)


def _port_trainer(tmp_path, max_iterations=3, **kw):
    coords, feats = _data()
    trainer = DiffusionTraining(str(tmp_path), DiffusionModel(**MODEL),
                                PointNeRFDataset(coords, feats), batch_size=4,
                                base_learning_rate=LR, weight_decay=WD,
                                max_iterations=max_iterations, use_ema=True, ema_params=[EMA],
                                seed=3, device="cpu", save_checkpoint_interval_min=1e9,
                                weights_only_interval=10**9, verbose=False, **kw)
    return trainer


def _batch(i):
    rng = np.random.default_rng(100 + i)
    return {"coords": rng.normal(size=(4, C, P)).astype(np.float32) * 0.4,
            "feats": rng.normal(size=(4, F, P)).astype(np.float32)}


def _leaf_close(got, want, rel, what, atol=0.0):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * float(np.abs(want).max()) + atol, f"{what}: max abs err {err}"


def test_compute_loss_matches_jax():
    model, _, state = _jax_state()
    port = _port_trainer_free_model(state)
    rng = jax.random.PRNGKey(7)
    b = _batch(0)
    loss, sub, _ = model.compute_loss(state.diffusion_state(), rng, jnp.asarray(b["coords"]),
                                      jnp.asarray(b["feats"]))
    dstate = port["state"]
    got, got_sub = port["model"].compute_loss(dstate, torch.from_numpy(b["coords"]),
                                              torch.from_numpy(b["feats"]),
                                              draws=_jax_draws(rng, 4))
    # f32 through two blocks in another summation order: 1e-5 relative
    np.testing.assert_allclose(float(got.detach()), float(loss), rtol=1e-5)
    for k in sub:
        np.testing.assert_allclose(float(got_sub[k]), float(sub[k]), rtol=1e-5)


def _port_trainer_free_model(state):
    """The port's DiffusionModel and normalizer state from a JAX state."""
    from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionState
    from npcd_tpu_torch.models.diffusion.normalizers import NormalizerStats

    bridged = _bridged(state)
    model = DiffusionModel(**MODEL)
    model.denoiser.load_state_dict({k: torch.tensor(v) for k, v in bridged["params"].items()})
    norms = [NormalizerStats(*(torch.tensor(bridged[n][f]) for f in ("shift", "scale", "min",
                                                                      "max")))
             for n in ("coords_norm", "feats_norm")]
    return {"model": model, "state": DiffusionState(*norms)}


def _jax_grads(model, state, batch, rng):
    def loss_fn(params):
        loss, _, _ = model.compute_loss(state.diffusion_state(params), rng,
                                        jnp.asarray(batch["coords"]), jnp.asarray(batch["feats"]))
        return loss
    return jax.tree_util.tree_map(np.asarray, jax.grad(loss_fn)(state.params))


def test_three_train_steps_match_jax(tmp_path):
    model, fused, state = _jax_state()
    step_fn = make_diffusion_train_step(model, fused, fused.ema_cfgs, donate=False)
    trainer = _port_trainer(tmp_path)
    trainer.load_bridged_state(_bridged(state))
    assert trainer.step == START and trainer.adam.count == START
    base = jax.random.PRNGKey(11)
    for i in range(3):
        rng = jax.random.fold_in(base, START + i)
        batch = _batch(i)
        want_grads = denoiser_state_dict(_jax_grads(model, state, batch, rng))
        state, metrics = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        got = trainer.train_step(batch, draws=_jax_draws(rng, 4))
        # f32 forward/backward through two blocks, summation orders differ
        np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]), float(metrics["grad_norm"]),
                                   rtol=1e-4)
        grads = trainer.flat.as_dict(trainer.flat.grads)
        assert set(grads) == set(want_grads)
        for name, g in grads.items():
            # every leaf nonzero (the no_grad trap would leave input_proj,
            # time_embed and the LayerNorms at 0) and equal to JAX's within
            # 1e-4 of the leaf's scale (f32 backward, other summation order)
            assert float(g.abs().max()) > 0, f"{name} got no gradient"
            _leaf_close(g.numpy(), want_grads[name], 1e-4, f"step {i} grad {name}")
    assert trainer.step == int(state.step) == START + 3
    want = _bridged(state)
    assert trainer.adam.count == want["count"]
    # A near-zero gradient that rounds to the other sign moves a parameter by
    # up to 2 lr per step through mu / sqrt(nu): every element of params and
    # EMA within 2 lr x 3 steps, and all but 0.1% of each leaf within 1e-5
    # of the leaf's scale; the moments within 1e-4 of theirs
    for name, buf, tree in [("params", trainer.flat.params, want["params"]),
                            ("ema", trainer.emas[0], want["emas"][0])]:
        for leaf, v in trainer.flat.as_dict(buf).items():
            err = np.abs(v.numpy() - tree[leaf])
            assert err.max() <= 6 * LR, f"{name} {leaf}: {err.max()}"
            assert (err > 1e-5 * np.abs(tree[leaf]).max()).mean() <= 1e-3, f"{name} {leaf}"
    for name, buf, tree in [("mu", trainer.adam.mu, want["mu"]),
                            ("nu", trainer.adam.nu, want["nu"])]:
        for leaf, v in trainer.flat.as_dict(buf).items():
            _leaf_close(v.numpy(), tree[leaf], 1e-4, f"{name} {leaf}")


def test_every_parameter_gets_a_gradient_equal_to_jax():
    model, _, state = _jax_state(seed=4)
    port = _port_trainer_free_model(state)
    rng = jax.random.PRNGKey(2)
    b = _batch(5)
    want = denoiser_state_dict(_jax_grads(model, state, b, rng))
    loss, _ = port["model"].compute_loss(port["state"], torch.from_numpy(b["coords"]),
                                         torch.from_numpy(b["feats"]), draws=_jax_draws(rng, 4))
    loss.backward()
    named = dict(port["model"].denoiser.named_parameters())
    assert set(named) == set(want)
    for name, p in named.items():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        _leaf_close(p.grad.numpy(), want[name], 1e-4, name)


def test_checkpoint_naming_keep3_and_layout(tmp_path):
    saver = CheckpointSaver(str(tmp_path), "diffusion_training", {"qkv_groups": 2})
    for it in range(1, 6):
        saver.save({"x": torch.full((3,), float(it)), "step": it}, it)
    saver.finish()
    names = sorted(n for n in os.listdir(tmp_path) if not n.endswith(".json"))
    assert names == [f"diffusion_training-iter-{i:09d}" for i in (3, 4, 5)]
    assert sorted(n for n in os.listdir(tmp_path) if n.endswith(".json")) == [
        f"diffusion_training-iter-{i:09d}.layout.json" for i in (3, 4, 5)]
    state, it = saver.restore()
    assert it == 5 and state["step"] == 5 and torch.equal(state["x"], torch.full((3,), 5.0))
    other = CheckpointSaver(str(tmp_path), "diffusion_training", {"qkv_groups": 1})
    with pytest.raises(ValueError, match="qkv_groups"):
        other.restore()
    os.remove(tmp_path / "diffusion_training-iter-000000005.layout.json")
    with pytest.raises(FileNotFoundError, match="layout sidecar"):
        saver.restore()


def test_resume_equals_uninterrupted_run(tmp_path):
    full = _port_trainer(tmp_path / "full", max_iterations=4)()
    _port_trainer(tmp_path / "cut", max_iterations=2)()
    resumed = _port_trainer(tmp_path / "cut", max_iterations=4)
    assert resumed.step == 2
    resumed()
    a, b = full.state_dict(), resumed.state_dict()
    assert a["step"] == b["step"] == 4 and a["count"] == b["count"] == 4
    for k in ("params", "mu", "nu", "emas"):
        assert torch.equal(a[k], b[k]), k  # bitwise on the CPU
    # finished: a new trainer restores and does nothing
    again = _port_trainer(tmp_path / "cut", max_iterations=4)
    assert again.step == 4 and again() is again


def test_weights_only_exports_load_through_load_npz(tmp_path):
    config = load_config(os.path.join(ROOT, "configs/npcd_synthetic_tiny.yaml"))
    npcd = NPCD.from_config(config)
    extra = {f"pointnerf.{k}": v.numpy() for k, v in npcd.pointnerf.state_dict().items()}
    m = config["model"]
    rng = np.random.default_rng(0)
    ds = PointNeRFDataset(rng.normal(size=(8, m["num_points"], 3)).astype(np.float32),
                          rng.normal(size=(8, m["num_points"], m["feats_dim"])).astype(np.float32))
    trainer = DiffusionTraining(str(tmp_path), npcd.diffusion, ds, batch_size=4,
                                base_learning_rate=LR, weight_decay=WD, max_iterations=2,
                                use_ema=True, ema_params=[EMA], device="cpu",
                                export_extra=extra, save_checkpoint_interval_min=1e9,
                                verbose=False)()
    paths = trainer.weights_only_paths(2)
    assert [os.path.basename(p) for p in paths] == [
        "npcd-iter-000000002.npz", "npcd-ema_power1_0min0_9max0_999buffers0-iter-000000002.npz"]
    target = NPCD.from_config(config, seed=1)
    state = load_npz(target, paths[1])
    ema = trainer.flat.as_dict(trainer.emas[0])
    for name, p in target.diffusion.denoiser.named_parameters():
        assert torch.equal(p.detach(), ema[name]), name
    assert torch.equal(state.coords_norm.shift, trainer.state.coords_norm.shift)
    with open(paths[1] + ".layout.json", "w") as f:  # an export of another grouping
        f.write('{"qkv_groups": 99}')
    with pytest.raises(ValueError, match="qkv_groups"):
        load_npz(target, paths[1])


def test_batch_order_matches_jax_loader():
    class Idx(JaxDataset):
        def _init_samples(self, n):
            self.samples = [{"i": np.array([i])} for i in range(n)]

    n = 23
    jl = JaxBatchLoader(Idx(n=n, verbose=False), 4, shuffle=True, drop_last=True, seed=1234)
    # object i's coords are all i, so a batch's coords name its objects
    ids = np.broadcast_to(np.arange(n, dtype=np.float32)[:, None, None], (n, 1, 3))
    pl = BatchLoader(PointNeRFDataset(ids, np.zeros((n, 1, 1))), 4, seed=1234)
    assert len(jl) == len(pl) == 5
    for _ in range(3):  # three epochs
        want = [b["i"][:, 0].tolist() for b in jl]
        assert [b["coords"][:, 0, 0].astype(int).tolist() for b in pl] == want


def test_pointnerf_latents_match_jax_tables(tmp_path):
    n_obj, feat_dim = 3, 8
    pn = JaxPointNeRF(n_obj=n_obj, feats_dim=feat_dim, num_points=P)
    params = pn.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = pn.set_all_coords(params, rng.uniform(-0.4, 0.4, (n_obj, P, 3)))
    # both halves of the variational feats table drawn apart, so taking the
    # log-variance half instead of the mean half would show
    params["feats_table"] = jnp.asarray(rng.normal(size=params["feats_table"].shape),
                                        jnp.float32)
    assert params["feats_table"].shape[-1] == 2 * feat_dim
    params = jax.tree_util.tree_map(np.asarray, params)
    latents = pointnerf_latents(params, feat_dim)
    np.testing.assert_array_equal(latents["latents.coords_table"], pn.get_all_coords(params))
    np.testing.assert_array_equal(latents["latents.feats_table"], pn.get_all_feats(params))
    # through the bridged .npz --pointnerf_weights reads: the same dataset
    # as npcd_tpu's, and the MLP weights passed on to the exports unchanged
    weights = {f"pointnerf.{k}": v for k, v in pointnerf_state_dict(params).items()}
    save_npz(str(tmp_path / "pointnerf.npz"), {**weights, **latents})
    ds, passed = load_pointnerf_weights(str(tmp_path / "pointnerf.npz"), P, feat_dim)
    want = JaxPointNeRFDataset(pointnerf=pn, params=params, verbose=False)
    np.testing.assert_array_equal(ds.get_all_coords(), want.get_all_coords())
    np.testing.assert_array_equal(ds.get_all_feats(), want.get_all_feats())
    assert passed.keys() == weights.keys()
    for k, v in weights.items():
        np.testing.assert_array_equal(passed[k], v)


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def test_cli_trains_then_generates_from_the_ema_export(tmp_path):
    cfg = os.path.join(ROOT, "configs/npcd_synthetic_tiny.yaml")
    config = load_config(cfg)
    m = config["model"]
    npcd = NPCD.from_config(config)
    rng = np.random.default_rng(0)
    flat = {f"pointnerf.{k}": v.numpy() for k, v in npcd.pointnerf.state_dict().items()}
    flat["latents.coords_table"] = rng.uniform(-0.5, 0.5, (m["n_obj"], m["num_points"], 3))
    flat["latents.feats_table"] = rng.normal(size=(m["n_obj"], m["num_points"], m["feats_dim"]))
    save_npz(str(tmp_path / "pointnerf.npz"), flat)
    out = tmp_path / "diffusion"
    _run(["npcd_tpu_torch.train_diffusion", "--config", cfg, "--output", str(out),
          "--pointnerf_weights", str(tmp_path / "pointnerf.npz"), "--dtype", "float32",
          "--device", "cpu", "--no_tensorboard"], tmp_path)
    steps = config["diffusion_training"]["max_iterations"]
    export = out / "weights_only_checkpoints_dir" / (
        f"npcd-ema_power1_0min0_9999max0_9999buffers0-iter-{steps:09d}.npz")
    assert export.exists() and (out / "checkpoints" /
                                f"diffusion_training-iter-{steps:09d}").is_dir()
    _run(["npcd_tpu_torch.generate_samples", "--config", cfg, "--out", str(tmp_path / "gen"),
          "--weights", str(export), "--num", "2", "--batch-size", "2", "--device", "cpu"],
         tmp_path)
    with np.load(tmp_path / "gen" / "samples.npz") as z:
        assert z["coords"].shape == (2, 3, m["num_points"])
        assert np.isfinite(z["coords"]).all() and np.isfinite(z["feats"]).all()


def test_cli_refuses_what_is_not_ported(tmp_path):
    """--platform (a JAX backend flag) is refused; --tp is ported, and a
    degree that does not divide the world (a group of one here) raises
    npcd_tpu's ValueError before anything is loaded."""
    import torch.distributed as dist

    from npcd_tpu_torch.train_diffusion import parse_args, train

    base = ["--config", "x.yaml", "--output", str(tmp_path), "--pointnerf_weights", "x.npz",
            "--device", "cpu"]
    with pytest.raises(ValueError, match="--platform tpu"):
        train(parse_args(base + ["--platform", "tpu"]))
    try:
        with pytest.raises(ValueError, match="tp=2 does not divide device count 1"):
            train(parse_args(base + ["--tp", "2"]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_cli_mesh_on_two_ranks(tmp_path):
    """train_diffusion --mesh on 2 gloo ranks (a launcher's environment):
    rank 0 writes one run, whose export equals the port's one-process
    steps on the same global batches (each rank's BatchLoader shard, rank 0's
    rows first) within npcd_tpu's DP tolerance (rtol 1e-4, atol 1e-6)."""
    from npcd_tpu_torch.utils.builders import build_diffusion_model
    from torch_parallel_worker import assert_one_writer, global_batches, run_ranks

    cfg = os.path.join(ROOT, "configs/npcd_synthetic_tiny.yaml")
    config = load_config(cfg)
    m = config["model"]
    npcd = NPCD.from_config(config)
    rng = np.random.default_rng(0)
    flat = {f"pointnerf.{k}": v.numpy() for k, v in npcd.pointnerf.state_dict().items()}
    flat["latents.coords_table"] = rng.uniform(-0.5, 0.5, (m["n_obj"], m["num_points"], 3))
    flat["latents.feats_table"] = rng.normal(size=(m["n_obj"], m["num_points"], m["feats_dim"]))
    save_npz(str(tmp_path / "pointnerf.npz"), flat)
    out = tmp_path / "dp"
    run_ranks("npcd_tpu_torch.train_diffusion",
              ["--config", cfg, "--output", out, "--pointnerf_weights", tmp_path / "pointnerf.npz",
               "--dtype", "float32", "--device", "cpu", "--no_tensorboard", "--mesh"],
              cwd=tmp_path)
    assert_one_writer(out)
    steps = config["diffusion_training"]["max_iterations"]
    assert sorted(os.listdir(out / "checkpoints")) == [
        f"diffusion_training-iter-{steps:09d}", f"diffusion_training-iter-{steps:09d}.layout.json"]

    dataset, _ = load_pointnerf_weights(str(tmp_path / "pointnerf.npz"), m["num_points"],
                                        m["feats_dim"])
    single = DiffusionTraining(str(tmp_path / "single"), build_diffusion_model(config),
                               dataset, seed=42, device="cpu", verbose=False,
                               **config["diffusion_training"])
    loader = BatchLoader(dataset, single.batch_size)
    for idx in global_batches(dataset, single.batch_size, 42, 2, steps):
        single.train_step(loader.batch(idx))
    with np.load(out / "weights_only_checkpoints_dir" / f"npcd-iter-{steps:09d}.npz") as z:
        for name, v in single.flat.as_dict(single.flat.params).items():
            np.testing.assert_allclose(z[f"diffusion.denoiser.{name}"], v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)

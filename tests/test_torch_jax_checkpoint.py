"""tools/jax_checkpoint_to_torch.py: npcd_tpu saves tiny orbax checkpoints
on the CPU (weights-only exports of an NPCD, of a stage-2 DiffusionState and
of stage 1; train-state snapshots of both stages), the tool converts them,
and the port's loaders and trainers reproduce npcd_tpu:

  * the NPCD export through generate_samples' ``load_npz``: the denoiser's
    output on the same inputs within 1e-5 of npcd_tpu's (f32, other
    summation orders), the normalizer stats bitwise; the stage-2 export with
    its stage-1 export gives the same file bitwise;
  * the stage-1 export through eval_pointnerf's ``load_stage1_weights``: a
    view's eval render within 1e-4 of npcd_tpu's (validity 'knn' with
    test_torch_eval's radius margins asserted), and through train_diffusion's
    ``load_pointnerf_weights`` the latent dataset bitwise npcd_tpu's;
  * a stage-2 snapshot: the port's trainer restores it (bitwise the bridged
    state) and its next step equals npcd_tpu's within
    test_torch_training.py's tolerances;
  * a stage-1 snapshot: the port's trainer restores the tables, MLPs, Adam
    moments and count and the step bitwise;
  * npcd_tpu's layout sidecar: a qkv_groups other than the config's raises,
    and the port's files carry the config's."""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from npcd_tpu.data import PointNeRFDataset as JaxPointNeRFDataset
from npcd_tpu.data import create_dataset as jax_create_dataset
from npcd_tpu.models.diffusion.normalizers import fit_minus_one_to_one, fit_unit_gaussian
from npcd_tpu.models.npcd import NPCD as JaxNPCD
from npcd_tpu.train.diffusion_training import make_diffusion_train_step
from npcd_tpu.train.fused_update import _is_adam
from npcd_tpu.train.pointnerf_training import PointNeRFTrainState, make_pointnerf_optimizer
from npcd_tpu.utils.checkpoint import CheckpointSaver as JaxSaver
from npcd_tpu.utils.checkpoint import save_weights_only
from npcd_tpu.utils.config import load_config as jax_load_config
from npcd_tpu_torch.data import PointNeRFDataset, SyntheticNPCTrain
from npcd_tpu_torch.eval_pointnerf import load_stage1_weights
from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel
from npcd_tpu_torch.models.npcd import NPCD
from npcd_tpu_torch.train import DiffusionTraining, PointNeRFTraining
from npcd_tpu_torch.train_diffusion import load_pointnerf_weights
from npcd_tpu_torch.utils.builders import build_pointnerf
from npcd_tpu_torch.utils.config import load_config
from npcd_tpu_torch.utils.from_jax import load_npz, pointnerf_train_state_from_jax
from test_torch_eval import _assert_radius_margins
from test_torch_training import (EMA, LR, MODEL, START, WD, _batch, _bridged, _data,
                                 _jax_state, _leaf_close)
from test_torch_training import _jax_draws as _train_draws
from tools import jax_checkpoint_to_torch as tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs/npcd_synthetic_tiny.yaml")
GROUPS = 2  # the tiny config's 2 heads in the grouped layout with G = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(loader):
    config = loader(CONFIG)
    config["model"]["qkv_groups"] = GROUPS
    return config


def _layout(groups=GROUPS):
    return {"qkv_groups": groups}


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """npcd_tpu's weights-only exports of one NPCD: the NPCD tree, its
    DiffusionState and its stage-1 params (the tables set to the dataset's
    clouds and a drawn feats table; output_proj drawn; fitted normalizers)."""
    tmp = tmp_path_factory.mktemp("jax_exports")
    config = _config(jax_load_config)
    jmodel = JaxNPCD.from_config(config)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    m = config["model"]
    ds = jax_create_dataset("SyntheticNPCTrain", **config["dataset_kwargs"])
    rng = np.random.default_rng(0)
    pn = dict(jax.tree_util.tree_map(np.asarray, jmodel.pointnerf.set_all_coords(
        params["pointnerf"], ds.get_all_coords())))
    pn["feats_table"] = rng.normal(size=pn["feats_table"].shape).astype(np.float32)
    dparams = params["diffusion"].params
    dparams["output_proj"]["kernel"] = rng.normal(
        scale=0.05, size=dparams["output_proj"]["kernel"].shape).astype(np.float32)
    n = m["n_obj"] * m["num_points"]
    dstate = type(params["diffusion"])(
        params=dparams, coords_norm=fit_unit_gaussian(rng.uniform(-0.6, 0.6, (3, n))),
        feats_norm=fit_minus_one_to_one(rng.normal(size=(m["feats_dim"], n))))
    paths = {k: str(tmp / k) for k in ("npcd", "diffusion", "pointnerf")}
    save_weights_only(paths["npcd"], {"pointnerf": pn, "diffusion": dstate}, _layout())
    save_weights_only(paths["diffusion"], dstate, _layout())
    save_weights_only(paths["pointnerf"], pn)
    return {"paths": paths, "jmodel": jmodel, "pn": pn, "dstate": dstate}


def test_npcd_export_loads_through_load_npz(exports, tmp_path):
    e = exports
    config = _config(load_config)
    out = tool.convert("npcd", e["paths"]["npcd"], config, str(tmp_path / "npcd.npz"))
    with open(out + ".layout.json") as f:
        assert json.load(f) == _layout()
    model = NPCD.from_config(config, seed=1)
    state = load_npz(model, out)
    for name in ("coords_norm", "feats_norm"):
        for f in ("shift", "scale", "min", "max"):
            np.testing.assert_array_equal(getattr(getattr(state, name), f).numpy(),
                                          np.asarray(getattr(getattr(e["dstate"], name), f)))
    rng = np.random.default_rng(3)
    m = config["model"]
    coords = rng.normal(size=(2, 3, m["num_points"])).astype(np.float32)
    feats = rng.normal(size=(2, m["feats_dim"], m["num_points"])).astype(np.float32)
    t = np.array([5, 640])
    with torch.no_grad():
        got = model.diffusion.denoiser(*(torch.from_numpy(a) for a in (coords, feats, t)))
    want = e["jmodel"].diffusion.denoiser.apply({"params": e["dstate"].params},
                                                *(jnp.asarray(a) for a in (coords, feats, t)))
    for g, w in zip(got, want):
        assert float(np.abs(np.asarray(w)).max()) > 0.01
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)

    # the stage-2 trainer's export with its stage-1 export: the same file
    other = tool.convert("diffusion", e["paths"]["diffusion"], config,
                         str(tmp_path / "diffusion.npz"), pointnerf=e["paths"]["pointnerf"])
    with np.load(out) as a, np.load(other) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(ValueError, match="--pointnerf"):
        tool.convert("diffusion", e["paths"]["diffusion"], config, str(tmp_path / "x.npz"))


def test_stage1_export_loads_into_eval_pointnerf_and_train_diffusion(exports, tmp_path):
    e = exports
    config = _config(load_config)
    out = tool.main(["--config", CONFIG, "--kind", "pointnerf", "--checkpoint",
                     e["paths"]["pointnerf"], "--out", str(tmp_path / "pn.npz")])
    model = build_pointnerf(config, with_tables=True)
    load_stage1_weights(model, out)
    ds = SyntheticNPCTrain(**config["dataset_kwargs"])
    sample, table = ds[3], model.get_all_coords()[3:4]
    _assert_radius_margins(types.SimpleNamespace(opts=model.opts, get_all_coords=lambda: table),
                           [sample])
    args = [sample["obj_idx"][None], sample["intrinsics"][None], sample["extrinsics"][None]]
    res = config["pointnerf_options"]["default_resolution"]
    with torch.no_grad():
        got = model.eval_forward(*(torch.as_tensor(a) for a in args), res)["channels"]
    want, _ = e["jmodel"].pointnerf.forward(e["pn"], *(jnp.asarray(a) for a in args),
                                            train=False, resolution=res)
    want = np.asarray(want["channels"])
    assert 0.05 < (want != 1.0).any(-1).mean() < 0.95  # object and background
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)

    m = config["model"]
    dataset, weights = load_pointnerf_weights(out, m["num_points"], m["feats_dim"])
    jds = JaxPointNeRFDataset(pointnerf=e["jmodel"].pointnerf, params=e["pn"], verbose=False)
    np.testing.assert_array_equal(dataset.get_all_coords(), jds.get_all_coords())
    np.testing.assert_array_equal(dataset.get_all_feats(), jds.get_all_feats())
    assert set(weights) == {f"pointnerf.{k}" for k in model.mlp_state_dict()}


def test_another_layout_is_refused(exports, tmp_path):
    config = _config(load_config)
    config["model"]["qkv_groups"] = 1
    with pytest.raises(ValueError, match="qkv_groups"):
        tool.convert("npcd", exports["paths"]["npcd"], config, str(tmp_path / "x.npz"))
    assert not (tmp_path / "x.npz").exists()


def _stage2_config():
    return {"model": {**MODEL, "n_obj": 8},
            "diffusion_training": {"batch_size": 4, "max_iterations": 10,
                                   "base_learning_rate": LR, "weight_decay": WD,
                                   "use_ema": True, "ema_params": [list(EMA)]}}


def test_stage2_snapshot_resumes_with_npcd_tpus_next_step(tmp_path):
    model, fused, state = _jax_state()
    saver = JaxSaver(str(tmp_path / "jax"), "diffusion_training", async_save=True,
                     layout_meta=_layout())
    path = saver.save(state, START)
    saver.finish()
    out = str(tmp_path / "port")
    written = tool.convert("diffusion-state", path, _stage2_config(), out)
    assert written.endswith(f"diffusion_training-iter-{START:09d}")
    with pytest.raises(FileExistsError):
        tool.convert("diffusion-state", path, _stage2_config(), out)

    trainer = DiffusionTraining(out, DiffusionModel(**MODEL), PointNeRFDataset(*_data()),
                                seed=3, device="cpu", save_checkpoint_interval_min=1e9,
                                verbose=False, **_stage2_config()["diffusion_training"])
    assert trainer.step == START and trainer.adam.count == START
    want = _bridged(state)
    for name, buf, tree in [("params", trainer.flat.params, want["params"]),
                            ("mu", trainer.adam.mu, want["mu"]), ("nu", trainer.adam.nu, want["nu"]),
                            ("ema", trainer.emas[0], want["emas"][0])]:
        for leaf, v in trainer.flat.as_dict(buf).items():
            np.testing.assert_array_equal(v.numpy(), tree[leaf], err_msg=f"{name} {leaf}")
    np.testing.assert_array_equal(trainer.state.feats_norm.max.numpy(), want["feats_norm"]["max"])

    rng = jax.random.fold_in(jax.random.PRNGKey(11), START)
    batch = _batch(0)
    step_fn = make_diffusion_train_step(model, fused, fused.ema_cfgs, donate=False)
    state, metrics = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    got = trainer.train_step(batch, draws=_train_draws(rng, 4))
    # test_torch_training.py's tolerances for one step
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)
    want = _bridged(state)
    assert trainer.step == want["step"] == START + 1 and trainer.adam.count == want["count"]
    for name, buf, tree in [("params", trainer.flat.params, want["params"]),
                            ("ema", trainer.emas[0], want["emas"][0])]:
        for leaf, v in trainer.flat.as_dict(buf).items():
            err = np.abs(v.numpy() - tree[leaf])
            assert err.max() <= 2 * LR, f"{name} {leaf}: {err.max()}"
            assert (err > 1e-5 * np.abs(tree[leaf]).max()).mean() <= 1e-3, f"{name} {leaf}"
    for name, buf, tree in [("mu", trainer.adam.mu, want["mu"]),
                            ("nu", trainer.adam.nu, want["nu"])]:
        for leaf, v in trainer.flat.as_dict(buf).items():
            _leaf_close(v.numpy(), tree[leaf], 1e-4, f"{name} {leaf}")


def _drawn_adam(opt_state, rng, count):
    """opt_state with its Adam state's moments drawn and its count set."""
    def draw(s):
        like = lambda scale, f: jax.tree_util.tree_map(
            lambda a: jnp.asarray(f(rng.normal(size=a.shape) * scale).astype(np.float32)), s.mu)
        return optax.ScaleByAdamState(count=jnp.asarray(count, jnp.int32),
                                      mu=like(1e-3, lambda a: a), nu=like(1e-6, np.abs))
    return jax.tree_util.tree_map(lambda s: draw(s) if _is_adam(s) else s, opt_state,
                                  is_leaf=_is_adam)


def test_stage1_snapshot_restores_into_the_port_trainer(exports, tmp_path):
    config = _config(load_config)
    tc = config["pointnerf_training"]
    tx = make_pointnerf_optimizer(tc["base_learning_rate"])
    params = jax.tree_util.tree_map(jnp.asarray, exports["pn"])
    state = PointNeRFTrainState(params=params, opt_state=_drawn_adam(
        tx.init(params), np.random.default_rng(1), 3), step=jnp.asarray(3, jnp.int32))
    saver = JaxSaver(str(tmp_path / "jax"), "pointnerf_training", async_save=True)
    path = saver.save(state, 3)
    saver.finish()
    out = str(tmp_path / "port")
    tool.convert("pointnerf-state", path, config, out)

    trainer = PointNeRFTraining(out, build_pointnerf(config, with_tables=True),
                                SyntheticNPCTrain(**config["dataset_kwargs"]), device="cpu",
                                verbose=False, **tc)
    get = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    want = pointnerf_train_state_from_jax(get(state.params), get(state.opt_state), state.step)
    assert trainer.step == want["step"] == 3
    model_state = trainer.model.state_dict()
    assert set(model_state) == set(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_array_equal(model_state[k].numpy(), v, err_msg=k)
    named = dict(trainer.model.named_parameters())
    assert set(named) == set(want["mu"])
    for name, p in named.items():
        st = trainer.optimizer.state[p]
        assert float(st["step"]) == want["count"] == 3
        np.testing.assert_array_equal(st["exp_avg"].numpy(), want["mu"][name], err_msg=name)
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), want["nu"][name], err_msg=name)

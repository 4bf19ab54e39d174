"""The port's CLIs take the JAX CLIs' flags with the JAX CLIs' defaults:
``generate_samples`` requires ``--weights`` and renders with the config's
``render_config.validity`` unless ``--validity`` overrides it, and
``train_diffusion`` accepts ``--platform`` (a JAX backend flag) only to
refuse it.

The render test runs ``generate_samples`` on configs/npcd_synthetic_tiny.yaml
(validity 'knn' by npcd_tpu's default) from weights bridged from npcd_tpu,
then renders the clouds it generated with npcd_tpu's
``NPCD.from_config`` model on the same weights: channels within 1e-4, as in
tests/test_torch_generation.py's 'knn' render test, on every ray with no
sample within 1e-4 (relative) of the kNN radius, where the two sides' forms
of the distance may decide validity apart (fewer than 5% of the rays)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from npcd_tpu.models.diffusion.normalizers import fit_minus_one_to_one, fit_unit_gaussian
from npcd_tpu.models.npcd import NPCD as JaxNPCD
from npcd_tpu.utils.config import load_config as jax_load_config
from npcd_tpu_torch.generate_samples import main as generate_main
from npcd_tpu_torch.generate_samples import parse_args as generate_args
from npcd_tpu_torch.utils.from_jax import bridge, save_npz

CONFIG = "configs/npcd_synthetic_tiny.yaml"
RES = 16


def _cameras(n_pose=2):
    poses = np.load("data/srncars_test_poses.npy")[:n_pose].astype(np.float32)
    intr = np.load("data/srncars_test_intrinsics.npy")[:n_pose].astype(np.float32)
    intr[:, :2] *= RES / 128.0  # the 128x128 intrinsics at 16x16
    return poses, intr


def _near_radius(model, coords, poses, intr):
    """[n, V, R] bool: the rays of cloud n from pose v with a sample whose
    squared distance to one of the cloud's points lies within 1e-4
    (relative) of the kNN radius², where npcd_tpu's dot form and the port's
    direct sum may take the validity decision apart."""
    import torch

    from npcd_tpu_torch.models.pointnerf.math_utils import (fill_invalid_ray_limits,
                                                            get_ray_limits_box)
    from npcd_tpu_torch.models.pointnerf.ray_sampler import generate_rays
    from npcd_tpu_torch.models.pointnerf.renderer import sample_depths

    o = model.pointnerf.opts
    rays_o, rays_d = generate_rays(torch.from_numpy(poses), torch.from_numpy(intr), RES)
    start, end = fill_invalid_ray_limits(*get_ray_limits_box(rays_o, rays_d, 1.0))
    depths = sample_depths(start[..., 0], end[..., 0], o.renderer.depth_resolution)
    x = (rays_o[:, :, None] + depths[..., None] * rays_d[:, :, None]).numpy().astype(np.float64)
    r2 = o.knn_radius ** 2
    near = []
    for cloud in coords.astype(np.float64):  # [P, 3]
        d2 = ((x[..., None, :] - cloud) ** 2).sum(-1)  # [V, R, S, P]
        near.append((np.abs(d2 - r2) / r2 < 1e-4).any(axis=(-2, -1)))
    return np.stack(near)


def test_generate_renders_with_the_configs_validity(tmp_path):
    jmodel = JaxNPCD.from_config(jax_load_config(CONFIG))
    assert jmodel.pointnerf.cfg.validity == "knn"  # npcd_tpu's default, as the config leaves it
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    dparams = params["diffusion"].params
    rng = np.random.default_rng(0)
    dparams["output_proj"]["kernel"] = rng.normal(
        scale=0.05, size=dparams["output_proj"]["kernel"].shape).astype(np.float32)
    # normalizers fitted on clouds inside the render volume
    coords_norm = fit_unit_gaussian(rng.uniform(-0.6, 0.6, (3, 16 * 32)))
    feats_norm = fit_minus_one_to_one(rng.normal(size=(8, 16 * 32)))
    weights = str(tmp_path / "npcd.npz")
    save_npz(weights, bridge(dparams, coords_norm, feats_norm, params["pointnerf"]))
    poses, intr = _cameras()
    np.save(tmp_path / "poses.npy", poses)
    np.save(tmp_path / "intrinsics.npy", intr)

    res = generate_main(["--config", CONFIG, "--weights", weights, "--out", str(tmp_path / "gen"),
                         "--num", "2", "--batch-size", "2", "--seed", "0", "--render", "2",
                         "--poses", str(tmp_path / "poses.npy"),
                         "--intrinsics", str(tmp_path / "intrinsics.npy"), "--render-poses", "2",
                         "--resolution", str(RES), "--device", "cpu"])
    assert res["model"].pointnerf.cfg.validity == "knn"
    coords = res["coords"].transpose(0, 2, 1).copy()  # [n, P, 3]
    feats = res["feats"].transpose(0, 2, 1).copy()
    extr = np.broadcast_to(poses, (2,) + poses.shape).copy()
    intrs = np.broadcast_to(intr, (2,) + intr.shape).copy()
    near = _near_radius(res["model"], coords, poses, intr)
    assert near.mean() < 0.05

    ref = jmodel.pointnerf.render(params["pointnerf"], jnp.asarray(coords), jnp.asarray(feats),
                                  jnp.asarray(extr), jnp.asarray(intrs), resolution=RES)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    valid = ref["ray_valid"]
    assert 0.05 < valid.mean() < 0.95
    got = res["channels"].numpy()
    np.testing.assert_allclose(got[~near], ref["channels"][~near], rtol=0, atol=1e-4)


def test_generate_requires_weights(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        generate_args(["--config", CONFIG, "--out", str(tmp_path)])
    assert exc.value.code == 2 and "--weights" in capsys.readouterr().err


def test_train_diffusion_refuses_platform(tmp_path):
    from npcd_tpu_torch.train_diffusion import parse_args, train

    args = parse_args(["--config", CONFIG, "--output", str(tmp_path), "--pointnerf_weights",
                       "x.npz", "--device", "cpu", "--platform", "cpu"])
    with pytest.raises(ValueError, match="--platform cpu"):
        train(args)
    assert not any(tmp_path.iterdir())  # refused before it wrote anything

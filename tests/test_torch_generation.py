"""The whole generation slice of the PyTorch port against npcd_tpu on
configs/npcd_synthetic_tiny.yaml with render_config.validity = 'voxel':
the same weights (carried over by utils/from_jax.py), the same sampler
draws (rebuilt from npcd_tpu's key splits in DiffusionModel._generate_batch
and GaussianDiffusion.p_sample), 1000 DDPM steps, then the render of the
generated clouds at 16x16.

Tolerances: samples 1e-4 abs/rel after 1000 f32 steps (eps differs by
~1e-6 per step, and the x0 clip keeps the chain bounded); render channels
and mask 1e-4 abs. Depth is compared on valid rays only: an invalid ray's
depth depends on how rays were chunked (npcd_tpu pointnerf.py:538-546)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npcd_tpu.models.diffusion.diffusion_model import DiffusionState as JaxState
from npcd_tpu.models.diffusion.normalizers import fit_minus_one_to_one, fit_unit_gaussian
from npcd_tpu.models.npcd import NPCD as JaxNPCD
from npcd_tpu.utils.config import load_config as jax_load_config
from npcd_tpu_torch.generate_samples import main as cli_main
from npcd_tpu_torch.models.npcd import NPCD
from npcd_tpu_torch.utils.config import load_config
from npcd_tpu_torch.utils.from_jax import bridge, load_flat, load_npz, save_npz

CONFIG = "configs/npcd_synthetic_tiny.yaml"
RES = 16
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny models: their small ops gain
    nothing from a thread pool, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(loader, **render):
    cfg = loader(CONFIG)
    cfg["render_config"] = {**cfg["render_config"], "validity": "voxel", **render}
    return cfg


def _cameras(n_obj, n_pose=3):
    poses = np.load("data/srncars_test_poses.npy")[:n_pose].astype(np.float32)
    intr = np.load("data/srncars_test_intrinsics.npy")[:n_pose].astype(np.float32)
    intr[:, :2] *= RES / 128.0  # the 128x128 intrinsics at 16x16
    return (np.broadcast_to(poses, (n_obj,) + poses.shape).copy(),
            np.broadcast_to(intr, (n_obj,) + intr.shape).copy())


def _jax_draws(rng, batch, cdim, fdim, p, steps=1000):
    """The normal draws npcd_tpu's generate makes for one batch of ``rng``, in order."""
    _, rng_batch = jax.random.split(rng)
    rng_c, rng_f, rng_loop = jax.random.split(rng_batch, 3)
    start = [jax.random.normal(rng_c, (batch, cdim, p)), jax.random.normal(rng_f, (batch, fdim, p))]

    def step(r, _):
        r, r_step = jax.random.split(r)
        r_c, r_f = jax.random.split(r_step)
        return r, (jax.random.normal(r_c, (batch, cdim, p)), jax.random.normal(r_f, (batch, fdim, p)))

    _, (nc, nf) = jax.lax.scan(step, rng_loop, None, length=steps)
    draws = [np.asarray(a) for a in start]
    for c, f in zip(np.asarray(nc), np.asarray(nf)):
        draws += [c, f]
    return draws


@pytest.fixture(scope="module")
def jax_run():
    """JAX weights (nonzero output_proj), fitted normalizers, generated clouds."""
    model = JaxNPCD.from_config(_config(jax_load_config))
    params = jax.tree_util.tree_map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    dparams = params["diffusion"].params
    rng = np.random.default_rng(0)
    dparams["output_proj"]["kernel"] = rng.normal(
        scale=0.05, size=dparams["output_proj"]["kernel"].shape).astype(np.float32)
    coords = rng.uniform(-0.6, 0.6, (3, 16 * 32))
    feats = rng.normal(size=(8, 16 * 32))
    state = JaxState(params=dparams, coords_norm=fit_unit_gaussian(coords),
                     feats_norm=fit_minus_one_to_one(feats))
    key = jax.random.PRNGKey(1)
    c, f = model.diffusion.generate(state, key, num=2, batch_size=2)
    flat = bridge(dparams, state.coords_norm, state.feats_norm, params["pointnerf"])
    return dict(model=model, params=params, coords=c, feats=f, flat=flat,
                draws=_jax_draws(key, 2, 3, 8, 32))


def _port(flat, **render):
    model = NPCD.from_config(_config(load_config, **render))
    return model, load_flat(model, flat)


def test_generate_matches_jax(jax_run):
    model, state = _port(jax_run["flat"])
    draws = list(jax_run["draws"])
    coords, feats = model.diffusion.generate(
        state, num=2, batch_size=2, noise=lambda shape: torch.tensor(draws.pop(0)))
    assert not draws  # every JAX draw consumed, in order
    np.testing.assert_allclose(coords, jax_run["coords"], **TOL)
    np.testing.assert_allclose(feats, jax_run["feats"], **TOL)
    assert np.abs(jax_run["coords"]).max() > 0.05


@pytest.mark.parametrize("slot_block", [None, 4])
def test_render_matches_jax(jax_run, slot_block):
    # slot_block 4 of max_shading_pts 8: the eval staircase skips slot blocks
    coords = jax_run["coords"].transpose(0, 2, 1).copy()
    feats = jax_run["feats"].transpose(0, 2, 1).copy()
    extr, intr = _cameras(2)
    jmodel = jax_run["model"]
    jmodel.pointnerf.cfg = dataclasses.replace(jmodel.pointnerf.cfg, eval_slot_block=slot_block)
    ref = jmodel.pointnerf.render(jax_run["params"]["pointnerf"], jnp.asarray(coords),
                                  jnp.asarray(feats), jnp.asarray(extr), jnp.asarray(intr),
                                  resolution=RES)
    model, _ = _port(jax_run["flat"], eval_slot_block=slot_block)
    got = model.pointnerf.render(*(torch.from_numpy(a) for a in (coords, feats, extr, intr)),
                                 resolution=RES)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    valid = ref["ray_valid"]
    assert 0.05 < valid.mean() < 0.95
    np.testing.assert_array_equal(got["ray_valid"].numpy(), valid)
    np.testing.assert_allclose(got["channels"].numpy(), ref["channels"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["mask"].numpy(), ref["mask"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["depth"].numpy()[valid], ref["depth"][valid], rtol=1e-4,
                               atol=1e-4)


def test_rays_match_jax_and_ignore_the_batch():
    """128x128 rays of 4 SRN test poses: within 1e-6 of npcd_tpu's, and each
    instance's rays bit-equal to those it gets alone (the render's discrete
    decisions must not depend on what else is in the batch)."""
    from npcd_tpu.models.pointnerf.ray_sampler import generate_rays as jax_rays
    from npcd_tpu_torch.models.pointnerf.ray_sampler import generate_rays

    extr = np.load("data/srncars_test_poses.npy")[:4].astype(np.float32)
    intr = np.load("data/srncars_test_intrinsics.npy")[:4].astype(np.float32)
    got = generate_rays(torch.from_numpy(extr), torch.from_numpy(intr), 128)
    for g, w in zip(got, jax_rays(jnp.asarray(extr), jnp.asarray(intr), 128)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    for i in range(4):
        alone = generate_rays(torch.from_numpy(extr[i:i + 1]), torch.from_numpy(intr[i:i + 1]), 128)
        for g, a in zip(got, alone):
            assert torch.equal(g[i:i + 1], a)


def test_knn_validity_is_not_ported(jax_run):
    """The render with validity 'knn' matches npcd_tpu's. (The name dates
    from before kernel K5, when the port refused 'knn'; the test keeps it.)
    npcd_tpu's radius test runs the dot form on the CPU,
    the port the direct sum: no sample or (shading point, point) pair lies
    within 1e-4 (relative) of the radius, asserted so that other clouds fail
    loudly instead of flakily."""
    from npcd_tpu_torch.models.pointnerf.math_utils import (fill_invalid_ray_limits,
                                                            get_ray_limits_box)
    from npcd_tpu_torch.models.pointnerf.ray_sampler import generate_rays
    from npcd_tpu_torch.models.pointnerf.renderer import sample_depths

    coords = jax_run["coords"].transpose(0, 2, 1).copy()
    feats = jax_run["feats"].transpose(0, 2, 1).copy()
    extr, intr = _cameras(2)
    jmodel = jax_run["model"]
    jmodel.pointnerf.cfg = dataclasses.replace(jmodel.pointnerf.cfg, validity="knn",
                                               eval_slot_block=4)
    ref = jmodel.pointnerf.render(jax_run["params"]["pointnerf"], jnp.asarray(coords),
                                  jnp.asarray(feats), jnp.asarray(extr), jnp.asarray(intr),
                                  resolution=RES)
    model, _ = _port(jax_run["flat"], validity="knn", eval_slot_block=4)
    got = model.pointnerf.render(*(torch.from_numpy(a) for a in (coords, feats, extr, intr)),
                                 resolution=RES)

    o = model.pointnerf.opts
    rays_o, rays_d = generate_rays(torch.from_numpy(extr).reshape(-1, 4, 4),
                                   torch.from_numpy(intr).reshape(-1, 3, 3), RES)
    start, end = fill_invalid_ray_limits(*get_ray_limits_box(rays_o, rays_d, 1.0))
    depths = sample_depths(start[..., 0], end[..., 0], o.renderer.depth_resolution)
    x = (rays_o[:, :, None] + depths[..., None] * rays_d[:, :, None]).numpy().astype(np.float64)
    kp = np.repeat(coords, 3, axis=0).astype(np.float64)
    d2 = ((x.reshape(6, -1, 1, 3) - kp[:, None]) ** 2).sum(-1)  # every sample to every point
    r2 = o.knn_radius ** 2
    assert (np.abs(d2 - r2) / r2).min() > 1e-4, "a sample lies at the radius"
    assert (d2 < r2).sum(-1).max() <= o.aggregator.k

    ref = {k: np.asarray(v) for k, v in ref.items()}
    valid = ref["ray_valid"]
    assert 0.05 < valid.mean() < 0.95
    np.testing.assert_array_equal(got["ray_valid"].numpy(), valid)
    np.testing.assert_allclose(got["channels"].numpy(), ref["channels"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["mask"].numpy(), ref["mask"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["depth"].numpy()[valid], ref["depth"][valid], rtol=1e-4,
                               atol=1e-4)


def test_cli_with_bridged_weights(jax_run, tmp_path):
    weights = str(tmp_path / "npcd.npz")
    save_npz(weights, jax_run["flat"])
    model = NPCD.from_config(_config(load_config), seed=5)
    state = load_npz(model, weights)
    for name, p in model.state_dict().items():  # strict load: every tensor bridged
        np.testing.assert_array_equal(p.numpy(), jax_run["flat"][name], name)
    np.testing.assert_array_equal(state.coords_norm.max.numpy(), jax_run["flat"]["coords_norm.max"])

    extr, intr = _cameras(1, 2)
    np.save(tmp_path / "poses.npy", extr[0])
    np.save(tmp_path / "intrinsics.npy", intr[0])
    out = tmp_path / "gen"
    res = cli_main(["--config", CONFIG, "--weights", weights, "--out", str(out),
                    "--num", "3", "--batch-size", "2", "--seed", "0", "--render", "2",
                    "--poses", str(tmp_path / "poses.npy"),
                    "--intrinsics", str(tmp_path / "intrinsics.npy"), "--render-poses", "2",
                    "--resolution", str(RES), "--device", "cpu", "--validity", "voxel"])
    data = np.load(out / "samples.npz")
    assert data["coords"].shape == (3, 3, 32) and data["feats"].shape == (3, 8, 32)
    assert np.isfinite(data["coords"]).all()
    assert tuple(res["channels"].shape) == (2, 2, RES * RES, 3)
    assert (out / "sample0001.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"

"""The sampler's trajectory and the generation CLI's --trajectory-stride
and --swap, the port against npcd_tpu on the CPU:

  * p_sample_loop(return_trajectory=True) at strides 1, 5 and 10 with the
    tiny denoiser of tests/diffusion_tiny.py at T 50, on npcd_tpu's replayed
    draws: every kept state and x0 prediction within 1e-5 of npcd_tpu's
    (f32 through 50 steps of a 2-layer denoiser, sums in another order),
    and the final state bitwise the plain loop's on the same draws;
  * a stride that does not divide T raises ValueError;
  * generate(num=3, batch_size=2, return_trajectory=True): the batches
    stacked on axis 1 as npcd_tpu's, the samples denormalized and the
    trajectory not;
  * render_swap against npcd_tpu's render of the same crossed instances on
    configs/npcd_synthetic_tiny.yaml with validity 'voxel' (channels within
    1e-4, tests/test_torch_generation.py's render tolerance), each diagonal
    cell bitwise its cloud's render alone, and the grid's layout;
  * the CLI with --trajectory-stride and --swap on the CPU: samples.npz's
    keys and shapes, swap_grid.png's size, and --swap without poses
    refused before anything is written."""
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_tiny import C, F, P, T, generate_draws, models, replay, sampler_draws
from npcd_tpu.models.npcd import NPCD as JaxNPCD
from npcd_tpu.utils.config import load_config as jax_load_config
from npcd_tpu_torch import generate_samples
from npcd_tpu_torch.models.npcd import NPCD
from npcd_tpu_torch.utils.config import load_config
from npcd_tpu_torch.utils.from_jax import pointnerf_state_dict
from npcd_tpu_torch.utils.vis import tile_images

CONFIG = "configs/npcd_synthetic_tiny.yaml"
RES = 16
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny models: their small ops gain
    nothing from a thread pool, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    return models(seed=1)


def _start(seed, batch=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, C, P)).astype(np.float32),
            rng.normal(size=(batch, F, P)).astype(np.float32))


@pytest.mark.parametrize("stride", [1, 5, 10])
def test_p_sample_loop_trajectory_matches_jax(tiny, stride):
    jmodel, jstate, pmodel, state = tiny
    coords, feats = _start(stride)
    clip = lambda norm: (norm.min[0], norm.max[0])
    rng = jax.random.PRNGKey(stride)
    jc, jf, jtraj = jax.jit(lambda r: jmodel.process.p_sample_loop(
        r, jmodel.denoise_fn(jstate.params), jnp.asarray(coords), jnp.asarray(feats),
        clip(jstate.coords_norm), clip(jstate.feats_norm), return_trajectory=True,
        trajectory_stride=stride))(rng)
    draws = sampler_draws(rng, 2)
    loop = lambda noise, **kw: pmodel.process.p_sample_loop(
        noise, pmodel.denoiser, torch.from_numpy(coords), torch.from_numpy(feats),
        clip(state.coords_norm), clip(state.feats_norm), **kw)
    noise = replay(draws)
    c, f, traj = loop(noise, return_trajectory=True, trajectory_stride=stride)
    assert not noise.left
    k = T // stride
    assert [x.shape for x in traj] == [(k + 1, 2, C, P), (k, 2, C, P), (k + 1, 2, F, P),
                                       (k, 2, F, P)]
    for name in traj._fields:
        got, want = getattr(traj, name).numpy(), np.asarray(getattr(jtraj, name))
        if name.endswith("recons"):
            # x0 = (x_t - sqrt(1 - a_t) eps) / sqrt(a_t): eps's last-bit
            # differences grow by sqrt(1 / a_t - 1), ~150 at t 49 of T 50
            a = pmodel.process.schedule.alphas_cumprod.numpy()[T - stride * np.arange(1, k + 1)]
            atol = 1e-5 * (1 + np.sqrt(1 / a - 1))[:, None, None, None]
            assert (np.abs(got - want) <= atol + 1e-5 * np.abs(want)).all(), name
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **TOL)
    assert torch.equal(traj.coords_ts[0], torch.from_numpy(coords))
    assert torch.equal(traj.coords_ts[-1], c) and torch.equal(traj.feats_ts[-1], f)
    # the same draws without the trajectory: the final state bitwise
    plain = loop(replay(draws))
    assert len(plain) == 2
    assert torch.equal(plain[0], c) and torch.equal(plain[1], f)


def test_trajectory_stride_must_divide_t(tiny):
    _, _, pmodel, _ = tiny
    coords, feats = _start(0)
    with pytest.raises(ValueError, match="trajectory_stride 7"):
        pmodel.process.p_sample_loop(lambda s: torch.zeros(s), pmodel.denoiser,
                                     torch.from_numpy(coords), torch.from_numpy(feats),
                                     return_trajectory=True, trajectory_stride=7)


def test_generate_trajectory_stacks_batches_as_jax(tiny):
    jmodel, jstate, pmodel, state = tiny
    rng = jax.random.PRNGKey(3)
    jc, jf, jtraj = jmodel.generate(jstate, rng, num=3, batch_size=2, return_trajectory=True,
                                    trajectory_stride=10)
    noise = replay(generate_draws(rng, [2, 1]))
    c, f, traj = pmodel.generate(state, num=3, batch_size=2, noise=noise,
                                 return_trajectory=True, trajectory_stride=10)
    assert not noise.left
    assert type(traj).__name__ == "Trajectory" and isinstance(traj.coords_ts, np.ndarray)
    assert traj.coords_ts.shape == np.asarray(jtraj.coords_ts).shape == (6, 3, C, P)
    assert traj.feats_recons.shape == (5, 3, F, P)
    for name in ("coords_ts", "feats_ts"):  # the recons: the test above
        np.testing.assert_allclose(getattr(traj, name), np.asarray(getattr(jtraj, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(c, jc, **TOL)
    np.testing.assert_allclose(f, jf, **TOL)
    # the samples are denormalized, the trajectory is not
    from npcd_tpu_torch.models.diffusion.normalizers import denormalize
    last = denormalize(state.coords_norm, torch.from_numpy(traj.coords_ts[-1])).numpy()
    np.testing.assert_array_equal(last, c)
    assert not np.allclose(traj.coords_ts[-1], c)


def _tiny_config(loader):
    cfg = loader(CONFIG)
    cfg["render_config"] = {**cfg["render_config"], "validity": "voxel"}
    return cfg


def test_render_swap_matches_jax_render_of_crossed_instances():
    jmodel = JaxNPCD.from_config(_tiny_config(jax_load_config), pointnerf_only=True)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.pointnerf.init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(2)
    n, p = 2, 32
    coords = rng.uniform(-0.6, 0.6, (n, 3, p)).astype(np.float32)
    feats = rng.normal(size=(n, 8, p)).astype(np.float32)
    pose = np.load("data/srncars_test_poses.npy")[:1].astype(np.float32)
    intr = np.load("data/srncars_test_intrinsics.npy")[:1].astype(np.float32)
    intr[:, :2] *= RES / 128.0

    ci = np.repeat(coords.transpose(0, 2, 1), n, axis=0)
    fj = np.tile(feats.transpose(0, 2, 1), (n, 1, 1))
    nn = n * n
    want = jax.jit(lambda *a: jmodel.pointnerf.render(*a, resolution=RES))(
        params, jnp.asarray(ci), jnp.asarray(fj),
        jnp.asarray(np.broadcast_to(pose[None], (nn,) + pose.shape)),
        jnp.asarray(np.broadcast_to(intr[None], (nn,) + intr.shape)))

    model = NPCD.from_config(_tiny_config(load_config))
    model.pointnerf.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                                     for k, v in pointnerf_state_dict(params).items()})
    got = generate_samples.render_swap(model, coords, feats, pose, intr, n, RES,
                                       torch.device("cpu"))
    assert got.shape == (nn, 1, RES * RES, 3)
    valid = np.asarray(want["ray_valid"])
    assert 0.05 < valid.mean() < 0.95
    np.testing.assert_allclose(got.numpy(), np.asarray(want["channels"]), rtol=0, atol=1e-4)
    # cell (i, j) is shape i with appearance j: the diagonal is each cloud alone
    for i in range(n):
        alone = generate_samples.render(model, coords[i:i + 1], feats[i:i + 1], pose, intr, RES,
                                        torch.device("cpu"))["channels"]
        assert torch.equal(got[i * n + i], alone[0])  # batch-independent on the CPU
    grid = tile_images(list(got.numpy().reshape(nn, RES, RES, 3)), cols=n)
    assert grid.shape == (n * RES, n * RES, 3)
    np.testing.assert_array_equal(grid[RES:, :RES], got[n].reshape(RES, RES, 3))  # cell (1, 0)


def _png_size(path):
    with open(path, "rb") as f:
        head = f.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    return struct.unpack(">II", head[16:24])


def test_cli_writes_trajectory_and_swap_grid(tmp_path):
    weights = generate_samples.write_seeded_weights(CONFIG, str(tmp_path / "seeded.npz"))
    out = tmp_path / "gen"
    generate_samples.main(["--config", CONFIG, "--weights", weights, "--out", str(out),
                           "--num", "2", "--batch-size", "2", "--trajectory-stride", "100",
                           "--swap", "2", "--poses", "data/srncars_test_poses.npy",
                           "--intrinsics", "data/srncars_test_intrinsics.npy",
                           "--resolution", str(RES), "--device", "cpu"])
    with np.load(out / "samples.npz") as z:
        assert set(z.files) == {"coords", "feats", "trajectory_coords", "trajectory_feats"}
        assert z["trajectory_coords"].shape == (11, 2, 3, 32)
        assert z["trajectory_feats"].shape == (11, 2, 8, 32)
        assert np.isfinite(z["trajectory_coords"]).all()
    assert _png_size(out / "swap_grid.png") == (2 * RES, 2 * RES)


def test_cli_refuses_swap_without_poses(tmp_path):
    out = tmp_path / "gen"
    with pytest.raises(SystemExit):
        generate_samples.main(["--config", CONFIG, "--weights", "x.npz", "--out", str(out),
                               "--swap", "2", "--device", "cpu"])
    assert not out.exists()

"""The port's evals (npcd_tpu_torch/eval/) against npcd_tpu's on
configs/npcd_synthetic_tiny.yaml's model (P 32, F 8, 16², width 32, 1
layer) with validity 'voxel', the weights bridged by utils/from_jax.py.

FID/KID (DiffusionEvaluation), in three stages:
  1. the eval's renders of the same clouds: channels within 1e-4, as
     tests/test_torch_generation.py's render test;
  2. quantize -> extract -> FID/KID on identical images: the quantized
     images bitwise equal, the random-projection features within the bound
     of f32 summation in another order (torch on the device vs numpy on the
     host: 2 * n * 2**-24 * sum |x_i p_i| over the n = 768 products), and
     FID/KID of identical features bitwise equal;
  3. end to end: the port's sampler on npcd_tpu's replayed draws (clouds
     within test_torch_generation.py's 1e-4), then both evals on the same
     clouds (npcd_tpu's generate stubbed with the port's): renders within
     1e-4 of each other can still round to another of the 255 levels when a
     value sits within 1e-4 of a level's boundary, so images are held to one
     level apart on at most 0.5% of the values, and FID to 1e-3 relative (a
     flip moves a projected feature by ~1/255 of a projection row, ~5e-4 of
     the features' spread).
Then the files, the idempotent skip, overlapped == serial bitwise, the host
feed, a failing extractor on the worker thread, and render_dtype bfloat16
above 40 dB cross-PSNR of the f32 render (npcd_tpu's
test_fid_eval_bf16_render), and the eval on two gloo ranks (mesh=) against
the eval in one process.

PSNR (PointNeRFEvaluation) on SyntheticNPCTrain (4 objects, 2 views, 16²),
validity 'knn' (npcd_tpu's default) with the radius margins asserted:
the same rows, each view's PSNR within the change in PSNR that renders
within 1e-4 can make (Minkowski: |rmse_a - rmse_b| <= 1e-4, so the PSNRs
differ by at most 20 log10(1 + 1e-4 / rmse)), the summary and the skip;
then the eval on two gloo ranks (mesh=) against the eval in one process."""
import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npcd_tpu.data import create_dataset as jax_create_dataset
from npcd_tpu.eval import DiffusionEvaluation as JaxDiffusionEvaluation
from npcd_tpu.eval import PointNeRFEvaluation as JaxPointNeRFEvaluation
from npcd_tpu.models.diffusion.diffusion_model import DiffusionState as JaxState
from npcd_tpu.models.diffusion.normalizers import fit_minus_one_to_one, fit_unit_gaussian
from npcd_tpu.models.npcd import NPCD as JaxNPCD
from npcd_tpu.models.pointnerf import PointNeRF as JaxPointNeRF
from npcd_tpu.models.pointnerf import PointNeRFRenderConfig as JaxRenderConfig
from npcd_tpu.utils.config import load_config as jax_load_config
from npcd_tpu.utils.config import pointnerf_default_options as jax_options
from npcd_tpu_torch.data import SyntheticNPCTrain
from npcd_tpu_torch.eval import DiffusionEvaluation, PointNeRFEvaluation
from npcd_tpu_torch.eval.diffusion_evaluation import quantize
from npcd_tpu_torch.models.npcd import NPCD
from npcd_tpu_torch.models.pointnerf.pointnerf import PointNeRF, PointNeRFRenderConfig
from npcd_tpu_torch.utils.config import load_config, pointnerf_default_options
from npcd_tpu_torch.utils.fidkid import FIDKID, ProjectionExtractor
from npcd_tpu_torch.utils.from_jax import bridge, load_flat, pointnerf_state_dict
from test_torch_generation import _jax_draws

CONFIG = "configs/npcd_synthetic_tiny.yaml"
RES, P, FD, N_POSE = 16, 32, 8, 3
G = torch.Generator()
PROJ = np.random.default_rng(0).normal(size=(RES * RES * 3, 8)).astype(np.float32)


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
    cfg["render_config"] = {**cfg["render_config"], "validity": "voxel"}
    return cfg


def _cameras():
    poses = np.load("data/srncars_test_poses.npy")[:N_POSE].astype(np.float32)
    intr = np.load("data/srncars_test_intrinsics.npy")[:N_POSE].astype(np.float32)
    intr[:, :2] *= RES / 128.0  # the 128x128 intrinsics at 16x16
    return poses, intr


class _Recorder:
    """A feature extractor that keeps every batch it is fed and its features;
    ``device_resident`` as the extractor it wraps."""

    def __init__(self, inner):
        self.inner = inner
        self.device_resident = getattr(inner, "device_resident", False)
        self.images, self.feats = [], []

    def __call__(self, images):
        self.images.append(images)
        self.feats.append(self.inner(images))
        return self.feats[-1]


def _stats_pickle(path):
    real = np.random.default_rng(2).uniform(0, 1, (20, RES * RES * 3)).astype(np.float32) @ PROJ
    with open(path, "wb") as f:
        pickle.dump({"mean": real.mean(0), "cov": np.cov(real, rowvar=False), "feats_np": real}, f)
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both models on the same weights (nonzero output_proj), fitted
    normalizers, the real-stats pickle and npcd_tpu's clouds and draws of
    PRNGKey(3)'s first generate group."""
    jmodel = JaxNPCD.from_config(_config(jax_load_config))
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    dparams = params["diffusion"].params
    rng = np.random.default_rng(0)
    dparams["output_proj"]["kernel"] = rng.normal(
        scale=0.05, size=dparams["output_proj"]["kernel"].shape).astype(np.float32)
    jstate = JaxState(params=dparams,
                      coords_norm=fit_unit_gaussian(rng.uniform(-0.6, 0.6, (3, 16 * 32))),
                      feats_norm=fit_minus_one_to_one(rng.normal(size=(8, 16 * 32))))
    model = NPCD.from_config(_config(load_config))
    state = load_flat(model, bridge(dparams, jstate.coords_norm, jstate.feats_norm,
                                    params["pointnerf"]))
    _, rng_gen = jax.random.split(jax.random.PRNGKey(3))  # npcd_tpu's eval, one group
    coords, feats = jmodel.diffusion.generate(jstate, rng_gen, num=2, batch_size=2)
    poses, intr = _cameras()
    return dict(jmodel=jmodel, params=params, jstate=jstate, model=model, state=state,
                coords=np.asarray(coords), feats=np.asarray(feats), poses=poses, intr=intr,
                draws=_jax_draws(rng_gen, 2, 3, FD, P),
                pkl=_stats_pickle(tmp_path_factory.mktemp("stats") / "stats.pkl"))


def _kw(s, **over):
    kw = dict(num_samples=2, poses=s["poses"], intrinsics=s["intr"], inception_pkl_path=s["pkl"],
              feature_extractor="random_projection:8", generate_batch_size=2,
              render_pose_batch=2, resolution=RES, verbose=False)
    kw.update(over)
    return kw


def _port_eval(s, **over):
    return DiffusionEvaluation(device="cpu", **_kw(s, **over))


def _stub_clouds(ev, s):
    """The eval's generate returns npcd_tpu's clouds (counted); call it
    with ``G`` as the generator, which it does not draw from."""
    ev.calls = 0

    def generate(model, state, num, noise):
        k = ev.calls * num
        ev.calls += 1
        return torch.from_numpy(s["coords"][k:k + num]), torch.from_numpy(s["feats"][k:k + num])

    ev.generate = generate
    return ev


def _jax_renders(s):
    """npcd_tpu's render of its clouds, pose batch by pose batch as its eval
    renders them (jitted) -> [n, V, H*W, 3]."""
    if "renders" not in s:
        render = jax.jit(lambda p, c, f, e, i: s["jmodel"].pointnerf.render(
            p, c, f, e, i, resolution=RES)["channels"])
        c = jnp.asarray(s["coords"].transpose(0, 2, 1))
        f = jnp.asarray(s["feats"].transpose(0, 2, 1))
        out = []
        for sl in (slice(0, 2), slice(2, 3)):
            bc = lambda a: jnp.asarray(np.broadcast_to(a[sl][None], (2,) + a[sl].shape))
            out.append(np.asarray(render(s["params"]["pointnerf"], c, f, bc(s["poses"]),
                                         bc(s["intr"]))))
        s["renders"] = np.concatenate(out, 1)
    return s["renders"]


def test_eval_renders_match_jax(setup):
    s = setup
    want = _jax_renders(s)
    got = _port_eval(s).render_objects(
        s["model"].pointnerf, torch.from_numpy(s["coords"].transpose(0, 2, 1).copy()),
        torch.from_numpy(s["feats"].transpose(0, 2, 1).copy()))
    assert tuple(got.shape) == (2, N_POSE, RES * RES, 3)
    assert 0.05 < (want != 1.0).any(-1).mean() < 0.95  # white background and object
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_quantize_extract_fidkid_match_jax(setup):
    s = setup
    raw = _jax_renders(s)
    want_q = np.round(np.clip(raw, 0.0, 1.0) * 255.0) / 255.0  # npcd_tpu's host quantization
    got_q = quantize(torch.from_numpy(raw))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    assert len(np.unique(want_q)) > 20

    images = want_q.reshape(-1, RES, RES, 3)
    ext = _port_eval(s).feature_extractor
    assert isinstance(ext, ProjectionExtractor) and ext.device_resident
    got_f = ext(got_q.reshape(-1, RES, RES, 3))
    want_f = images.reshape(len(images), -1) @ PROJ  # npcd_tpu's random_projection
    bound = 2 * PROJ.shape[0] * 2.0**-24 * (np.abs(images.reshape(len(images), -1)) @ np.abs(PROJ))
    assert (np.abs(got_f - want_f) <= bound).all()

    from npcd_tpu.utils.fidkid import FIDKID as JaxFIDKID

    sides = []
    for cls in (FIDKID, JaxFIDKID):
        acc = cls(num_images=len(images), feature_extractor=lambda x: x, inception_pkl=s["pkl"])
        acc.prepare()
        acc.feed(want_f, "fakes")
        sides.append(acc.summary(seed=0))
    assert sides[0] == sides[1]


def test_eval_end_to_end_matches_jax(setup, tmp_path):
    s = setup
    draws = list(s["draws"])
    ev = _port_eval(s, out_dir=str(tmp_path / "port"))
    ev.feature_extractor = rec = _Recorder(ev.feature_extractor)
    clouds = []
    generate = ev.generate
    ev.generate = lambda *a: clouds.append(generate(*a)) or clouds[-1]
    got = ev(s["model"], s["state"], noise=lambda shape: torch.tensor(draws.pop(0)),
             kid_seed=0)
    assert not draws  # every npcd_tpu draw consumed, in order
    np.testing.assert_allclose(clouds[0][0].numpy(), s["coords"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(clouds[0][1].numpy(), s["feats"], rtol=1e-4, atol=1e-4)

    # npcd_tpu's eval on the port's clouds
    jmodel = s["jmodel"]
    jax_rec = _Recorder(lambda imgs: imgs.reshape(len(imgs), -1) @ PROJ)
    jev = JaxDiffusionEvaluation(**_kw(s, feature_extractor=jax_rec))
    port_clouds = tuple(c.numpy() for c in clouds[0])
    orig = jmodel.diffusion.generate
    jmodel.diffusion.generate = lambda *a, **k: port_clouds
    try:
        want = jev(jmodel, s["params"]["pointnerf"], s["jstate"], rng=jax.random.PRNGKey(3))
    finally:
        jmodel.diffusion.generate = orig

    assert isinstance(rec.images[0], torch.Tensor)  # the device-resident feed
    got_img = torch.cat(rec.images).numpy()
    want_img = np.concatenate(jax_rec.images)
    assert got_img.shape == want_img.shape == (2 * N_POSE, RES, RES, 3)
    diff = np.abs(got_img - want_img)
    assert diff.max() <= 1 / 255 + 1e-6 and (diff > 0).mean() <= 5e-3
    assert set(got) == {"fid", "fid_mean", "fid_cov", "kid"}
    assert np.isfinite(list(got.values())).all()
    np.testing.assert_allclose(got["fid"], want["fid"], rtol=1e-3)


def test_eval_files_skip_and_overlap(setup, tmp_path):
    s = setup
    ev = _stub_clouds(_port_eval(s, out_dir=str(tmp_path / "ev"), generate_batch_size=1,
                                 render_object_batch=1), s)
    first = ev(s["model"], s["state"], G, kid_seed=5, num_qualitatives=1)
    assert ev.calls == 2  # two generate groups of one
    for name in ("results.json", "results.csv", "sample0000.png"):
        assert (tmp_path / "ev" / name).exists(), name
    assert json.loads((tmp_path / "ev" / "results.json").read_text()) == first
    assert (tmp_path / "ev" / "results.csv").read_text().splitlines()[:2] == [
        ",metric", f"fid,{first['fid']!r}"]
    assert ev(s["model"], s["state"], G, kid_seed=6) == first and ev.calls == 2  # skipped

    serial = _stub_clouds(_port_eval(s, overlap_extraction=False), s)
    assert serial(s["model"], s["state"], G, kid_seed=5) == first
    # a host extractor (a plain callable) is fed numpy
    host = _Recorder(lambda imgs: imgs.reshape(len(imgs), -1) @ PROJ)
    res = _stub_clouds(_port_eval(s, feature_extractor=host), s)(s["model"], s["state"], G,
                                                                 kid_seed=5)
    assert all(isinstance(x, np.ndarray) for x in host.images)
    np.testing.assert_allclose(res["fid"], first["fid"], rtol=1e-5)


def test_eval_raises_the_workers_error(setup):
    def broken(images):
        raise RuntimeError("extractor failed")

    ev = _stub_clouds(_port_eval(setup, feature_extractor=broken), setup)
    with pytest.raises(RuntimeError, match="extractor failed"):
        ev(setup["model"], setup["state"], G)


def test_eval_bf16_render(setup):
    """render_dtype bfloat16 against the f32 render: cross-PSNR of the
    quantized views above 40 dB and FID within 5% (npcd_tpu's
    test_fid_eval_bf16_render)."""
    s = setup
    runs = {}
    for dtype in (None, "bfloat16"):
        ev = _stub_clouds(_port_eval(s, render_dtype=dtype), s)
        ev.feature_extractor = rec = _Recorder(ev.feature_extractor)
        runs[dtype] = (ev(s["model"], s["state"], G, kid_seed=0), torch.cat(rec.images).numpy())
    assert s["model"].pointnerf.cfg.compute_dtype == torch.float32  # the model is untouched
    (r32, i32), (r16, i16) = runs[None], runs["bfloat16"]
    mse = float(np.mean((i32 - i16) ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 40
    assert abs(r16["fid"] - r32["fid"]) < 0.05 * max(abs(r32["fid"]), 1.0)


@pytest.mark.parametrize("kw,error", [
    (dict(feature_extractor="inception_jax"), ValueError),
    (dict(feature_extractor="mystery"), ValueError),
    (dict(feature_extractor=None, inception_path="missing.pt"), FileNotFoundError),
    (dict(feature_extractor="inception_jax:missing.h5"), OSError)])
def test_eval_refuses(setup, kw, error):
    """npcd_tpu's contract: 'inception_jax' without a weights file raises
    ValueError, one whose file is missing the h5 reader's OSError."""
    with pytest.raises(error):
        _port_eval(setup, **kw)


# -- PSNR ------------------------------------------------------------------------------


def _psnr_models():
    opts_j = jax_options(num_points=P, feat_dim=FD)
    opts_j = dataclasses.replace(
        opts_j, renderer=dataclasses.replace(opts_j.renderer, depth_resolution=16,
                                             ray_subsamples=24),
        aggregator=dataclasses.replace(opts_j.aggregator, max_shading_pts=6),
        default_resolution=RES)
    jpn = JaxPointNeRF(n_obj=4, feats_dim=FD, num_points=P, opts=opts_j,
                       render_config=JaxRenderConfig(eval_ray_chunk=256))
    ds = jax_create_dataset("SyntheticNPCTrain", n_obj=4, num_views=2, image_size=RES,
                            num_points=P)
    params = jpn.init_params(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, jpn.set_all_coords(params, ds.get_all_coords()))
    # a feats table whose mean and log-variance both matter if misused
    params["feats_table"] = np.random.default_rng(1).normal(
        size=params["feats_table"].shape).astype(np.float32)

    opts = pointnerf_default_options(num_points=P, feat_dim=FD)
    opts = dataclasses.replace(
        opts, renderer=dataclasses.replace(opts.renderer, depth_resolution=16, ray_subsamples=24),
        aggregator=dataclasses.replace(opts.aggregator, max_shading_pts=6),
        default_resolution=RES)
    pn = PointNeRF(opts, PointNeRFRenderConfig(eval_ray_chunk=256), n_obj=4)
    state = {k: torch.tensor(np.asarray(v)) for k, v in pointnerf_state_dict(params).items()}
    state["tables.coords_table"] = torch.from_numpy(np.asarray(params["coords_table"]))
    state["tables.feats_table"] = torch.from_numpy(params["feats_table"])
    pn.load_state_dict(state)
    return jpn, params, ds, pn


def _assert_radius_margins(pn, ds):
    """validity 'knn': npcd_tpu's radius test runs the dot form, the port's
    the direct sum, and the two sides' ray limits differ by an ulp. So no
    sample may lie within 1e-4 (relative) of the kNN radius of a point of
    its cloud, and none has more than k points within it (the kNN's cut
    never decides), or the views would differ by a discontinuity."""
    from npcd_tpu_torch.models.pointnerf.math_utils import (fill_invalid_ray_limits,
                                                            get_ray_limits_box)
    from npcd_tpu_torch.models.pointnerf.ray_sampler import generate_rays
    from npcd_tpu_torch.models.pointnerf.renderer import sample_depths

    o = pn.opts
    r2 = o.knn_radius ** 2
    for i in range(len(ds)):
        extr, intr = (torch.from_numpy(ds[i][k]) for k in ("extrinsics", "intrinsics"))
        rays_o, rays_d = generate_rays(extr, intr, RES)
        start, end = fill_invalid_ray_limits(*get_ray_limits_box(rays_o, rays_d, 1.0))
        depths = sample_depths(start[..., 0], end[..., 0], o.renderer.depth_resolution)
        x = (rays_o[:, :, None] + depths[..., None] * rays_d[:, :, None]).double()
        d2 = ((x[..., None, :] - pn.get_all_coords()[i].double()) ** 2).sum(-1)
        assert ((d2 - r2).abs() / r2).min() > 1e-4, "a sample lies at the radius"
        assert (d2 < r2).sum(-1).max() <= o.aggregator.k


def test_synthetic_sample_matches_jax():
    ds_j = jax_create_dataset("SyntheticNPCTrain", n_obj=3, num_views=2, image_size=RES,
                              num_points=P)
    ds = SyntheticNPCTrain(n_obj=3, num_views=2, image_size=RES, num_points=P)
    for i in range(3):
        got, want = ds[i], ds_j[i]
        assert set(got) == set(want)
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], k)


def test_psnr_eval_matches_jax(tmp_path):
    jpn, params, ds_j, pn = _psnr_models()
    ds = SyntheticNPCTrain(n_obj=4, num_views=2, image_size=RES, num_points=P)
    _assert_radius_margins(pn, ds)
    # the eval forward: the tables' clouds with the feats mean
    sample = ds[2]
    args = [sample["obj_idx"][None], sample["intrinsics"][None], sample["extrinsics"][None]]
    want, _ = jpn.forward(params, *(jnp.asarray(a) for a in args), train=False, resolution=RES)
    got = pn.eval_forward(*(torch.as_tensor(a) for a in args), RES)
    want = np.asarray(want["channels"])
    assert 0.05 < (want != 1.0).any(-1).mean() < 0.95
    np.testing.assert_allclose(got["channels"].numpy(), want, rtol=0, atol=1e-4)

    jrows = JaxPointNeRFEvaluation(eval_batch_size=1, verbose=False)(
        ds_j, jpn, params, resolution=RES)
    ev = PointNeRFEvaluation(str(tmp_path / "ev"), eval_batch_size=1, verbose=False)
    res = ev(ds, pn, qualitatives=1, resolution=RES)
    rows = res["rows"]
    assert [(r["obj_idx"], r["view"]) for r in rows] == list(
        zip(jrows["obj_idx"], jrows["view"]))
    for r, (_, jr) in zip(rows, jrows.iterrows()):
        # the view's rmse from npcd_tpu's PSNR; renders within 1e-4 move it by <= 1e-4
        rmse = 10 ** (-jr["psnr"] / 20)
        assert abs(r["psnr"] - jr["psnr"]) <= 20 * np.log10(1 + 1e-4 / rmse) + 1e-9
    summary = res["summary"]
    assert summary["psnr"] == np.mean([r["psnr"] for r in rows])
    assert set(summary) == {"psnr", "time_per_forward_s"}  # one object past the burn-in
    for name in ("results.json", "results.csv", "summary.csv", "qualitative_00000.png"):
        assert (tmp_path / "ev" / name).exists(), name
    assert (tmp_path / "ev" / "summary.csv").read_text().splitlines()[0] == (
        ",psnr,time_per_forward_s")
    assert ev(ds, pn, resolution=RES) == json.loads((tmp_path / "ev" / "results.json").read_text())

    # samples spread as npcd_tpu's linspace, eval_batch_size 2
    some = PointNeRFEvaluation(eval_batch_size=2, verbose=False)(ds, pn, samples=3,
                                                                 resolution=RES)
    assert [r["obj_idx"] for r in some["rows"]] == [0, 0, 1, 1, 3, 3]
    assert set(some["summary"]) == {"psnr"}


@pytest.fixture(scope="module")
def mesh_runs(setup, tmp_path_factory):
    """Both evals on 2 gloo ranks (tests/torch_parallel_worker.py): the FID
    eval of npcd_tpu's two clouds (fed by object id), the PSNR eval at
    eval_batch_size 2 (each call's two views sharded)."""
    from torch_parallel_worker import run_group

    s = setup
    tmp = tmp_path_factory.mktemp("mesh")
    _, _, _, pn = _psnr_models()
    ds = SyntheticNPCTrain(n_obj=4, num_views=2, image_size=RES, num_points=P)
    ranks = run_group({
        "fid": ("fid_eval", dict(model=s["model"], state=s["state"], kw=_kw(s),
                                 clouds=(s["coords"], s["feats"]), out_dir=str(tmp / "fid"),
                                 kid_seed=0)),
        "psnr": ("psnr_eval", dict(model=pn, dataset=ds, eval_batch_size=2, resolution=RES,
                                   out_dir=str(tmp / "psnr")))}, tmp)
    return {"ranks": ranks, "tmp": tmp, "pn": pn, "ds": ds}


def test_eval_mesh_on_two_ranks(setup, mesh_runs, tmp_path):
    """DiffusionEvaluation(mesh=) on 2 ranks: every rank's results equal the
    eval in one process on the same clouds within npcd_tpu's DP tolerance
    (rtol 1e-4, atol 1e-5), and rank 0 wrote the files once."""
    from torch_parallel_worker import ids_noise, stub_generate

    s = setup
    ev = _port_eval(s, out_dir=str(tmp_path / "one"))
    ev.generate = stub_generate((s["coords"], s["feats"]))
    want = ev(s["model"], s["state"], noise=ids_noise(), kid_seed=0)
    for r in mesh_runs["ranks"]:
        got = r["fid"]["results"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    out = mesh_runs["tmp"] / "fid"
    assert sorted(p.name for p in out.iterdir()) == sorted(
        p.name for p in (tmp_path / "one").iterdir())


def test_psnr_eval_mesh_on_two_ranks(mesh_runs, tmp_path):
    """PointNeRFEvaluation(mesh=) on 2 ranks: every rank's rows equal the eval
    in one process (PSNR within 1e-5), and rank 0 wrote the files once."""
    want = PointNeRFEvaluation(str(tmp_path / "one"), eval_batch_size=2, verbose=False)(
        mesh_runs["ds"], mesh_runs["pn"], qualitatives=1, resolution=RES)
    for r in mesh_runs["ranks"]:
        got = r["psnr"]
        assert [(x["obj_idx"], x["view"]) for x in got["rows"]] == [
            (x["obj_idx"], x["view"]) for x in want["rows"]]
        np.testing.assert_allclose([x["psnr"] for x in got["rows"]],
                                   [x["psnr"] for x in want["rows"]], rtol=1e-5)
    out = mesh_runs["tmp"] / "psnr"
    assert sorted(p.name for p in out.iterdir()) == sorted(
        p.name for p in (tmp_path / "one").iterdir())

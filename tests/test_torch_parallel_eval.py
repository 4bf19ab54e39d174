"""Data-parallel sampling and evals of the PyTorch port (generate(mesh=),
DiffusionEvaluation and PointNeRFEvaluation under a mesh) against
npcd_tpu's on a 2-device CPU mesh, on configs/npcd_synthetic_tiny.yaml's
model with validity 'voxel' (tests/test_torch_eval.py's models and
weights). One group of two gloo ranks (tests/torch_parallel_worker.py) runs
every case:

  * generate of 5 clouds in batches of 2 (2, 2 and an indivisible tail of
    1, which runs whole on every rank) on npcd_tpu's replayed draws, every
    draw consumed in order: the clouds within test_torch_generation.py's
    1e-4 of npcd_tpu's generate with data_sharding over the mesh, the same
    on both ranks;
  * the FID eval of 5 given clouds (npcd_tpu's generate stubbed with them,
    the port's fed them by object id) with generate_batch_size 3 and
    render_object_batch 1: both rounded up to multiples of the world, 4 and
    2, as npcd_tpu rounds them, so the batches are 4 (sharded) and a tail
    of 1; FID within 1e-3 of npcd_tpu's mesh eval (test_torch_eval.py's
    tolerance: renders 1e-4 apart can round to another of the 255 levels)
    and FID and KID within npcd_tpu's DP tolerance (rtol 1e-4, atol 1e-5)
    of the port's eval in one process on the same clouds and batch sizes;
    the results and the qualitatives written once, by rank 0;
  * the PSNR eval of 4 objects x 2 views at eval_batch_size 2 (each call's
    views sharded) and 1 (every call whole on rank 0): the rows in
    npcd_tpu's order, each PSNR within the change renders 1e-4 apart can
    make of npcd_tpu's mesh eval, and within 1e-5 of the port's eval in
    one process, on both ranks."""
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from npcd_tpu.eval import DiffusionEvaluation as JaxDiffusionEvaluation
from npcd_tpu.eval import PointNeRFEvaluation as JaxPointNeRFEvaluation
from npcd_tpu.parallel import make_mesh as jax_make_mesh
from npcd_tpu_torch.data import SyntheticNPCTrain
from npcd_tpu_torch.eval import DiffusionEvaluation, PointNeRFEvaluation
from npcd_tpu_torch.models.diffusion.diffusion_model import split_num
from npcd_tpu.models.diffusion.diffusion_model import DiffusionState as JaxState
from npcd_tpu.models.diffusion.normalizers import fit_minus_one_to_one, fit_unit_gaussian
from npcd_tpu.models.npcd import NPCD as JaxNPCD
from npcd_tpu.utils.config import load_config as jax_load_config
from npcd_tpu_torch.models.npcd import NPCD
from npcd_tpu_torch.utils.config import load_config
from npcd_tpu_torch.utils.from_jax import bridge, load_flat
from test_torch_eval import FD, P, RES, _cameras, _config, _kw, _psnr_models, _stats_pickle
from test_torch_generation import _jax_draws
from torch_parallel_worker import ids_noise, start_group, stub_generate

NUM, GEN_BATCH = 5, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds():
    rng = np.random.default_rng(9)
    return (rng.uniform(-0.5, 0.5, (NUM, 3, P)).astype(np.float32),
            rng.normal(size=(NUM, FD, P)).astype(np.float32))


def _fid_kw(s):
    return _kw(s, num_samples=NUM, generate_batch_size=3, render_object_batch=1)


def _models(tmp):
    """tests/test_torch_eval.py's setup without its generate: both models on
    the same weights, the normalizers, the cameras and the stats pickle."""
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
    poses, intr = _cameras()
    return dict(jmodel=jmodel, params=params, jstate=jstate, model=model, state=state,
                poses=poses, intr=intr, pkl=_stats_pickle(tmp / "stats.pkl"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dpe")
    s = _models(tmp)
    mesh = jax_make_mesh(n_devices=2)

    key = jax.random.PRNGKey(4)
    draws, rng = [], key  # npcd_tpu's generate's draws, batch by batch
    for bs in split_num(NUM, GEN_BATCH):
        draws += _jax_draws(rng, bs, 3, FD, P)
        rng, _ = jax.random.split(rng)
    clouds = _clouds()
    jpn, params, ds_j, pn = _psnr_models()
    ds = SyntheticNPCTrain(n_obj=4, num_views=2, image_size=RES, num_points=P)
    ranks = start_group({
        "generate": ("generate", dict(model=s["model"], state=s["state"], num=NUM,
                                      batch_size=GEN_BATCH, draws=draws)),
        "fid": ("fid_eval", dict(model=s["model"], state=s["state"], kw=_fid_kw(s),
                                 clouds=clouds, out_dir=str(tmp / "fid"), kid_seed=0)),
        **{f"psnr{b}": ("psnr_eval", dict(model=pn, dataset=ds, eval_batch_size=b,
                                          resolution=RES, out_dir=str(tmp / f"psnr{b}")))
           for b in (2, 1)}}, tmp)

    # npcd_tpu's generate over the mesh
    jstate = jax.device_put(s["jstate"], NamedSharding(mesh, PartitionSpec()))
    want_gen = s["jmodel"].diffusion.generate(jstate, key, num=NUM, batch_size=GEN_BATCH,
                                              data_sharding=NamedSharding(mesh,
                                                                          PartitionSpec("data")))
    # npcd_tpu's FID eval over the mesh on the given clouds
    jev = JaxDiffusionEvaluation(mesh=mesh, **_fid_kw(s))
    jmodel, calls = s["jmodel"], []

    def jax_generate(state, rng, num, **_):
        k = sum(calls)
        calls.append(num)
        return clouds[0][k:k + num], clouds[1][k:k + num]

    orig = jmodel.diffusion.generate
    jmodel.diffusion.generate = jax_generate
    try:
        want_fid = jev(jmodel, s["params"]["pointnerf"], s["jstate"], rng=jax.random.PRNGKey(3))
    finally:
        jmodel.diffusion.generate = orig

    want_psnr = JaxPointNeRFEvaluation(eval_batch_size=2, verbose=False, mesh=mesh)(
        ds_j, jpn, params, resolution=RES)


    single = DiffusionEvaluation(device="cpu", **_kw(s, num_samples=NUM, generate_batch_size=4,
                                                     render_object_batch=2))
    single.generate = stub_generate(clouds)
    single_fid = single(s["model"], s["state"], noise=ids_noise(), kid_seed=0)
    single_psnr = PointNeRFEvaluation(eval_batch_size=2, verbose=False)(ds, pn,
                                                                        resolution=RES)
    return {"ranks": ranks(), "want_gen": want_gen, "fid": want_fid, "jev": jev,
            "psnr": want_psnr, "single_fid": single_fid, "single_psnr": single_psnr,
            "tmp": tmp}


def test_generate_with_indivisible_tail_matches_jax_mesh(run):
    want_c, want_f = (np.asarray(a) for a in run["want_gen"])
    for r in run["ranks"]:
        got = r["generate"]
        assert got["left"] == 0  # every draw consumed, in order
        assert got["coords"].shape == want_c.shape == (NUM, 3, P)
        np.testing.assert_allclose(got["coords"], want_c, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got["feats"], want_f, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(run["ranks"][0]["generate"]["coords"],
                                  run["ranks"][1]["generate"]["coords"])


def test_fid_eval_batch_rounding_matches_jax(run):
    jev = run["jev"]
    assert (jev.generate_batch_size, jev.render_object_batch) == (4, 2)
    for r in run["ranks"]:
        assert r["fid"]["batches"] == (4, 2)


def test_fid_eval_matches_jax_mesh_and_one_process(run):
    want, single = run["fid"], run["single_fid"]
    for r in run["ranks"]:
        got = r["fid"]["results"]
        assert set(got) == {"fid", "fid_mean", "fid_cov", "kid"}
        np.testing.assert_allclose(got["fid"], want["fid"], rtol=1e-3)
        for k in got:
            np.testing.assert_allclose(got[k], single[k], rtol=1e-4, atol=1e-5, err_msg=k)
    out = run["tmp"] / "fid"
    assert json.loads((out / "results.json").read_text()) == run["ranks"][0]["fid"]["results"]
    assert sorted(os.listdir(out)) == ["results.csv", "results.json"] + [
        f"sample{i:04d}.png" for i in range(NUM)]


@pytest.mark.parametrize("batch", [2, 1])
def test_psnr_eval_matches_jax_mesh_and_one_process(run, batch):
    want = run["psnr"]
    single = run["single_psnr"]["rows"]
    for r in run["ranks"]:
        rows = r[f"psnr{batch}"]["rows"]
        assert [(x["obj_idx"], x["view"]) for x in rows] == list(zip(want["obj_idx"],
                                                                   want["view"]))
        for x, (_, jr), y in zip(rows, want.iterrows(), single):
            rmse = 10 ** (-jr["psnr"] / 20)
            assert abs(x["psnr"] - jr["psnr"]) <= 20 * np.log10(1 + 1e-4 / rmse) + 1e-9
            np.testing.assert_allclose(x["psnr"], y["psnr"], rtol=1e-5)
        assert r[f"psnr{batch}"]["summary"]["psnr"] == np.mean([x["psnr"] for x in rows])
    out = run["tmp"] / f"psnr{batch}"
    assert sorted(os.listdir(out)) == ["qualitative_00000.png", "results.csv", "results.json",
                                       "summary.csv"]

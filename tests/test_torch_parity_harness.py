"""The port's parity eval (npcd_tpu_torch/parity_eval.py) against
tools/parity_eval.py, on the CPU, on a synthetic checkpoint in the
reference's full state-dict layout (tests/reference_checkpoint.py, 16 heads
of D 4 so that npcd_tpu's converter, whose head count is fixed at 16,
permutes c_qkv as the model reads it), as tests/test_parity_harness.py
drives npcd_tpu's:

  * ``main`` with --stage both and --device cpu: the PSNR over a synthetic
    dataset and generate -> render -> FID/KID with the random projection,
    parity.json as printed;
  * the PSNR against tools/parity_eval.run_psnr's on the same checkpoint:
    the same rows, each view's PSNR within the change renders within 1e-4
    can make (tests/test_torch_eval.py's bound, 20 log10(1 + 1e-4 / rmse)),
    with validity 'knn' and test_torch_eval's radius margins asserted;
  * FID/KID from the same extractor on npcd_tpu's replayed draws against
    tools/parity_eval.run_fid's, as tests/test_torch_eval.py holds the eval:
    the port's clouds within 1e-4 of npcd_tpu's sampler's, then npcd_tpu's
    eval on the port's clouds with its KID subsets drawn from the same seed,
    the images at most one level apart on at most 0.5% of the values, FID
    and KID within 1e-3 relative (validity 'knn' with the clouds' radius
    margins asserted, as for the PSNR);
  * the --check-assets dry run with missing, bad and good assets, the same
    problem strings as npcd_tpu's check (its SRN root given the port's
    root's ``cars``);
  * the mismatches that raise."""
import functools
import json
import os.path as osp
import pickle
import types

import jax
import numpy as np
import pytest
import torch
import yaml

from npcd_tpu.models.diffusion import DiffusionModel as JaxDiffusionModel
from npcd_tpu.models.npcd import NPCD as JaxNPCD
from npcd_tpu.utils.fidkid import FIDKID as JaxFIDKID
from npcd_tpu_torch import parity_eval
from npcd_tpu_torch.data.synthetic import random_cameras
from npcd_tpu_torch.eval import DiffusionEvaluation
from npcd_tpu_torch.eval_pointnerf import stage1_state
from npcd_tpu_torch.utils.builders import build_dataset, build_pointnerf
from npcd_tpu_torch.utils.fidkid import ProjectionExtractor
from reference_checkpoint import reference_state
from test_torch_eval import _assert_radius_margins
from test_torch_generation import _jax_draws
from tools import parity_eval as jax_parity

N_OBJ, P, FD, RES, W, H = 3, 16, 8, 16, 64, 16
PROJ = np.random.default_rng(0).normal(size=(RES * RES * 3, 8)).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny models: their small ops gain
    nothing from a thread pool, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _checkpoint(path, diffusion=True):
    sd = reference_state(W, seed=0, n_obj=N_OBJ, points=P, feat_dim=FD, layers=1)
    # generated clouds inside the render volume
    sd["diffusion.coords_normalization.shift"] = torch.zeros(3)
    sd["diffusion.coords_normalization.scale"] = torch.full((1,), 0.3)
    if not diffusion:
        sd = {k: v for k, v in sd.items() if not k.startswith("diffusion.")}
    torch.save(sd, path)
    return str(path)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parity")
    extr, intr = random_cameras(3, RES, seed=0)
    np.save(tmp / "poses.npy", extr)
    np.save(tmp / "intrinsics.npy", intr)
    real = np.random.default_rng(2).uniform(0, 1, (20, RES * RES * 3)).astype(np.float32) @ PROJ
    with open(tmp / "stats.pkl", "wb") as f:
        pickle.dump({"mean": real.mean(0), "cov": np.cov(real, rowvar=False), "feats_np": real}, f)
    config = {
        "model": {"n_obj": N_OBJ, "coords_dim": 3, "feats_dim": FD, "num_points": P, "width": W,
                  "layers": 1, "heads": H},
        "train_dataset": "SyntheticNPCTrain",
        "dataset_kwargs": {"n_obj": N_OBJ, "num_views": 2, "image_size": RES, "num_points": P,
                           "seed": 0},
        "pointnerf_options": {"depth_resolution": 16, "ray_subsamples": 24,
                              "max_shading_pts": 6, "default_resolution": RES},
        "render_config": {"validity": "voxel"},
        "diffusion_evaluation": {"num_samples": 2, "poses_path": str(tmp / "poses.npy"),
                                 "intrinsics_path": str(tmp / "intrinsics.npy"),
                                 "resolution": RES},
    }
    return {"tmp": tmp, "config": config, "ckpt": _checkpoint(tmp / "ref.pt"),
            "pkl": str(tmp / "stats.pkl")}


def _write_config(path, config):
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path)


def test_main_runs_both_stages_on_the_cpu(setup, tmp_path, monkeypatch):
    monkeypatch.delenv("NPCD_TPU_SRN_ROOT", raising=False)
    config = json.loads(json.dumps(setup["config"]))
    config["diffusion_evaluation"]["feature_extractor"] = "random_projection:8"
    cfg = _write_config(tmp_path / "config.yaml", config)
    base = ["--weights", setup["ckpt"], "--config", cfg, "--out", str(tmp_path / "out"),
            "--device", "cpu"]
    summary = parity_eval.main(base + ["--stage", "both", "--psnr-samples", "2",
                                       "--generate-batch-size", "2",
                                       "--inception-pkl", setup["pkl"]])
    assert set(summary) == {"psnr_target", "fid_target", "psnr", "fid", "kid_x1000"}
    assert np.isfinite([summary["psnr"], summary["fid"], summary["kid_x1000"]]).all()
    assert summary["fid"] >= 0
    with open(tmp_path / "out" / "parity.json") as f:
        assert json.load(f) == summary
    for name in ("cmd.txt", "log.txt", "pointnerf/results.json", "diffusion/results.json"):
        assert (tmp_path / "out" / name).exists(), name

    # --matmul-precision tensorfloat32 reaches the render config; on the CPU
    # TF32 changes no bit, so the PSNR is the same
    tf32 = parity_eval.main(["--weights", setup["ckpt"], "--config", cfg, "--out",
                             str(tmp_path / "out_tf32"), "--device", "cpu", "--stage", "psnr",
                             "--psnr-samples", "2", "--matmul-precision", "tensorfloat32"])
    assert tf32["psnr"] == summary["psnr"]
    seen = []
    run_psnr = parity_eval.run_psnr
    monkeypatch.setattr(parity_eval, "run_psnr",
                        lambda config, *a, **k: seen.append(config["render_config"]) or 0.0)
    for precision, want in (("tensorfloat32", "tensorfloat32"), ("default", None)):
        parity_eval.main(["--weights", setup["ckpt"], "--config", cfg, "--out",
                          str(tmp_path / "out_rc"), "--device", "cpu", "--stage", "psnr",
                          "--matmul-precision", precision])
        assert seen.pop().get("matmul_precision") == want
    monkeypatch.setattr(parity_eval, "run_psnr", run_psnr)
    no_diffusion = _checkpoint(tmp_path / "pointnerf_only.pt", diffusion=False)
    with pytest.raises(ValueError, match="no diffusion weights"):
        parity_eval.main(["--weights", no_diffusion, "--config", cfg, "--out",
                          str(tmp_path / "out2"), "--device", "cpu", "--stage", "fid"])


def test_psnr_matches_tools_parity_eval(setup, tmp_path):
    # validity 'knn' with test_torch_eval's radius margins asserted: under
    # 'voxel' a sample an ulp from a voxel face takes the other side on one
    # of the two (0.024 on 2 pixels of object 2 here)
    config = dict(setup["config"], render_config={"validity": "knn"})
    flat, _ = parity_eval.convert_weights(setup["ckpt"], config)
    model = build_pointnerf(config, with_tables=True)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                           for k, v in stage1_state(flat).items()})
    _assert_radius_margins(model, build_dataset(config))
    got = parity_eval.run_psnr(config, flat, str(tmp_path / "port"), samples=2, device="cpu")
    converted = jax_parity.convert_weights(setup["ckpt"], config)
    want = jax_parity.run_psnr(config, converted["pointnerf"], str(tmp_path / "jax"), samples=2)
    with open(tmp_path / "port" / "pointnerf" / "results.json") as f:
        rows = json.load(f)["rows"]
    import pandas as pd

    jrows = pd.read_pickle(tmp_path / "jax" / "pointnerf" / "results.pickle")
    assert [(r["obj_idx"], r["view"]) for r in rows] == list(zip(jrows["obj_idx"], jrows["view"]))
    assert len(rows) == 4 and np.isfinite(got)
    for r, (_, jr) in zip(rows, jrows.iterrows()):
        rmse = 10 ** (-jr["psnr"] / 20)
        assert abs(r["psnr"] - jr["psnr"]) <= 20 * np.log10(1 + 1e-4 / rmse) + 1e-9
    assert got == np.mean([r["psnr"] for r in rows])
    assert abs(got - want) <= max(20 * np.log10(1 + 1e-4 / 10 ** (-jr["psnr"] / 20))
                                  for _, jr in jrows.iterrows()) + 1e-9


class _Recorder:
    def __init__(self, inner):
        self.inner = inner
        self.device_resident = getattr(inner, "device_resident", False)
        self.images = []

    def __call__(self, images):
        self.images.append(images)
        return self.inner(images)


def test_fid_matches_tools_parity_eval_on_replayed_draws(setup, monkeypatch):
    # validity 'knn', the generated clouds' radius margins asserted from the
    # eval's poses (under 'voxel' samples an ulp from a voxel face flip
    # pixels by up to 0.067 here)
    config = dict(setup["config"], render_config={"validity": "knn"})
    seed = 42
    _, rng_gen = jax.random.split(jax.random.PRNGKey(seed))  # npcd_tpu's eval, one group
    draws = _jax_draws(rng_gen, 2, 3, FD, P)
    flat, layout = parity_eval.convert_weights(setup["ckpt"], config)
    clouds = []
    generate = DiffusionEvaluation.generate
    monkeypatch.setattr(DiffusionEvaluation, "generate",
                        lambda self, *a: clouds.append(generate(self, *a)) or clouds[-1])
    rec = _Recorder(ProjectionExtractor(PROJ, "cpu"))
    got = parity_eval.run_fid(config, flat, layout, None, inception_pkl=setup["pkl"],
                              feature_extractor=rec, generate_batch_size=2, rng_seed=seed,
                              device="cpu", noise=lambda shape: torch.tensor(draws.pop(0)))
    assert not draws  # every npcd_tpu draw consumed, in order
    port_clouds = tuple(c.numpy() for c in clouds[0])

    # npcd_tpu's sampler on its own key: the port's clouds within 1e-4
    converted = jax_parity.convert_weights(setup["ckpt"], config)
    jmodel = JaxNPCD.from_config(config)
    want_clouds = jmodel.diffusion.generate(converted["diffusion"], rng_gen, num=2, batch_size=2)
    for g, w in zip(port_clouds, want_clouds):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4)
    views = {"extrinsics": np.load(config["diffusion_evaluation"]["poses_path"]),
             "intrinsics": np.load(config["diffusion_evaluation"]["intrinsics_path"])}
    table = torch.from_numpy(port_clouds[0].transpose(0, 2, 1).copy())
    _assert_radius_margins(types.SimpleNamespace(opts=build_pointnerf(config).opts,
                                                 get_all_coords=lambda: table), [views] * 2)

    # tools/parity_eval.run_fid on the port's clouds, its KID subsets seeded
    monkeypatch.setattr(JaxDiffusionModel, "generate", lambda self, *a, **k: port_clouds)
    monkeypatch.setattr(JaxFIDKID, "summary",
                        functools.partialmethod(JaxFIDKID.summary, seed=seed))
    jax_rec = _Recorder(lambda images: images.reshape(len(images), -1) @ PROJ)
    want = jax_parity.run_fid(config, converted, None, inception_pkl=setup["pkl"],
                              feature_extractor=jax_rec, generate_batch_size=2, rng_seed=seed)
    got_img = torch.cat(rec.images).numpy()
    want_img = np.concatenate(jax_rec.images)
    assert got_img.shape == want_img.shape == (2 * 3, RES, RES, 3)
    diff = np.abs(got_img - want_img)
    assert diff.max() <= 1 / 255 + 1e-6 and (diff > 0).mean() <= 5e-3
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)  # FID and KID


def _srn_fixture(root):
    with open(osp.join(parity_eval.SAMPLE_LISTS, "srn_cars_train.list")) as f:
        ids = [ln.strip() for ln in f if ln.strip()][:3]
    for oid in ids:
        obj = root / "cars" / oid
        (obj / "rgb").mkdir(parents=True)
        (obj / "pose").mkdir()
        (obj / "rgb" / "000000.png").write_bytes(b"\x89PNG fake")
        (obj / "pose" / "000000.txt").write_text("1 0 0 0\n0 1 0 0\n0 0 1 0\n0 0 0 1\n")
        (obj / "intrinsics.txt").write_text("16 0 8 8\n")
        np.savez(obj / "pointcloud3_512.npz", points=np.zeros((4, 3)))
    return ids


def test_check_assets_dry_run_reports_what_npcd_tpu_reports(setup, tmp_path, capsys):
    ckpt, config = setup["ckpt"], setup["config"]
    root = tmp_path / "srn"
    ids = _srn_fixture(root)

    class TinyGraph(torch.nn.Module):
        def forward(self, x):
            return x.mean(dim=(1, 2, 3))

    ts_path = str(tmp_path / "inception.pt")
    torch.jit.save(torch.jit.script(TinyGraph()), ts_path)
    feats = np.random.default_rng(0).normal(size=(16, 2048)).astype(np.float32)
    pkl = str(tmp_path / "stats.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"mean": feats.mean(0), "cov": np.cov(feats, rowvar=False), "feats_np": feats},
                    f)

    def both(**kw):
        port = parity_eval.check_assets(**kw)
        jkw = dict(kw, srn_root=str(root / "cars")) if kw.get("srn_root") == str(root) else kw
        assert port == jax_parity.check_assets(**jkw)
        return port

    good = dict(weights=ckpt, srn_root=str(root), inception=ts_path, inception_pkl=pkl,
                config=config)
    assert both(**good) == []
    cfg = _write_config(tmp_path / "config.yaml", config)
    args = ["--weights", ckpt, "--config", cfg, "--srn-root", str(root), "--inception", ts_path,
            "--inception-pkl", pkl, "--check-assets"]
    assert parity_eval.main(args) is None
    assert capsys.readouterr().out.strip().endswith("ASSET CHECK OK")

    missing = both(weights=str(tmp_path / "no.pt"), srn_root=str(tmp_path / "no_dir"),
                   inception=str(tmp_path / "no_inc.pt"), inception_pkl=str(tmp_path / "no.pkl"),
                   config=config)
    assert len(missing) == 4 and all(p.startswith("MISSING") for p in missing)
    with pytest.raises(SystemExit) as e:
        parity_eval.main(["--weights", str(tmp_path / "no.pt"), "--config", cfg,
                          "--check-assets"])
    assert e.value.code == 1

    (root / "cars" / ids[0] / "pose" / "000000.txt").unlink()  # one object's file
    problems = both(srn_root=str(root))
    assert problems == [f"MISSING SRN file ({ids[0]}): "
                        f"{root / 'cars' / ids[0] / 'pose' / '000000.txt'}"]

    with open(pkl, "wb") as f:  # a corrupt pickle schema
        pickle.dump({"mean": np.zeros(7)}, f)
    problems = both(inception_pkl=pkl)
    assert any("missing 'cov'" in p for p in problems)
    assert any("mean shape" in p for p in problems)
    assert any(p.startswith("WARN") and "feats_np" in p for p in problems)

    bad_cfg = dict(config, model=dict(config["model"], n_obj=N_OBJ + 5))  # wrong n_obj
    assert any("feats table" in p for p in both(weights=ckpt, config=bad_cfg))
    (tmp_path / "garbage.pt").write_bytes(b"not a checkpoint")
    problems = both(weights=str(tmp_path / "garbage.pt"))
    assert len(problems) == 1 and problems[0].startswith("BAD checkpoint")


def test_mismatches_raise(setup):
    config = setup["config"]
    flat, layout = parity_eval.convert_weights(setup["ckpt"], config)
    bad = dict(config, model=dict(config["model"], num_points=P * 2))
    with pytest.raises(ValueError, match="shape mismatch"):
        parity_eval.run_psnr(bad, flat, None, samples=1, device="cpu")
    with pytest.raises(ValueError, match="qkv_groups"):
        parity_eval.run_fid(config, flat, {"qkv_groups": 2}, None, device="cpu")
    with pytest.raises(ValueError, match="do not match the model"):
        parity_eval.run_psnr(config, {k: v for k, v in flat.items()
                                      if not k.startswith("pointnerf.shape_net")},
                             None, samples=1, device="cpu")

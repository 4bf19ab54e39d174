"""The port's eval CLIs on configs/npcd_synthetic_tiny.yaml with --device
cpu, from the weights the port's tiny trainers export:
``eval_pointnerf`` on the stage-1 export (per-view PSNR rows of every
object, summary.csv) and ``eval_diffusion`` on stage 2's EMA export
(finite fid, fid_mean, fid_cov, kid in results.json and results.csv); a
second run of each skips. The real-stats pickle is written under the test's
own tmp_path and a copy of the config points at it (npcd_tpu's tests use
the config's /tmp path). Both refuse --platform (ValueError) before they
write anything, as tests/test_torch_cli.py holds the other CLIs; both run
with --mesh on two gloo ranks, rank 0 writing the results of the run
without it; and both take every --matmul_precision: its value reaches the
render config (nothing for "default") and the renders run under it."""
import json
import pickle

import numpy as np
import pytest
import torch

from npcd_tpu_torch import eval_diffusion, eval_pointnerf, train_diffusion, train_pointnerf

CONFIG = "configs/npcd_synthetic_tiny.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny models: their small ops gain
    nothing from a thread pool, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """The tiny trainers' exports: (stage-1 trainer, its .npz, stage 2's EMA .npz)."""
    root = tmp_path_factory.mktemp("train")
    pn = train_pointnerf.train(train_pointnerf.parse_args(
        ["--config", CONFIG, "--output", str(root / "pn"), "--device", "cpu",
         "--no_tensorboard"]))
    pn_npz = pn.weights_only_path(pn.step)
    diff = train_diffusion.train(train_diffusion.parse_args(
        ["--config", CONFIG, "--output", str(root / "diff"), "--pointnerf_weights", pn_npz,
         "--device", "cpu", "--no_tensorboard", "--dtype", "float32"]))
    return pn, pn_npz, diff.weights_only_paths(diff.step)[1]


def test_eval_pointnerf_cli(exports, tmp_path):
    trainer, pn_npz, _ = exports
    out = tmp_path / "psnr"
    argv = ["--config", CONFIG, "--weights", pn_npz, "--output", str(out), "--device", "cpu",
            "--no_tensorboard", "--num_qualitatives", "2"]
    loaded = []
    load = eval_pointnerf.load_stage1_weights
    eval_pointnerf.load_stage1_weights = lambda m, p: loaded.append(m) or load(m, p)
    try:
        res = eval_pointnerf.evaluate(eval_pointnerf.parse_args(argv))
    finally:
        eval_pointnerf.load_stage1_weights = load
    # the export's tables and MLPs, loaded into the eval's model
    model = loaded[0]
    assert torch.equal(model.get_all_coords(), trainer.model.get_all_coords())
    assert torch.equal(model.get_all_feats(), trainer.model.get_all_feats().detach())
    assert all(torch.equal(v, trainer.model.mlp_state_dict()[k])
               for k, v in model.mlp_state_dict().items())

    rows = res["rows"]
    assert [(r["obj_idx"], r["view"]) for r in rows] == [(i, v) for i in range(8) for v in (0, 1)]
    assert np.isfinite([r["psnr"] for r in rows]).all()
    assert set(res["summary"]) == {"psnr", "time_per_forward_s"}
    for name in ("results.json", "results.csv", "summary.csv", "qualitative_00001.png",
                 "log.txt", "cmd.txt"):
        assert (out / name).exists(), name
    assert len((out / "results.csv").read_text().splitlines()) == 1 + len(rows)
    assert eval_pointnerf.evaluate(eval_pointnerf.parse_args(argv)) == res  # skipped


def _fid_config(tmp_path, res=16):
    """A copy of the tiny config whose inception_pkl_path names real
    statistics of a random projection, written under tmp_path."""
    proj = np.random.default_rng(0).normal(size=(res * res * 3, 8)).astype(np.float32)
    real = np.random.default_rng(2).uniform(0, 1, (20, res * res * 3)).astype(np.float32) @ proj
    pkl = tmp_path / "stats.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"mean": real.mean(0), "cov": np.cov(real, rowvar=False), "feats_np": real}, f)
    text = open(CONFIG).read()
    assert "/tmp/cli_run/fake_inception.pkl" in text
    config = tmp_path / "tiny.yaml"
    config.write_text(text.replace("/tmp/cli_run/fake_inception.pkl", str(pkl)))
    return str(config)


def test_eval_diffusion_cli(exports, tmp_path):
    _, _, ema_npz = exports
    config = _fid_config(tmp_path)
    out = tmp_path / "fid"
    argv = ["--config", config, "--weights", ema_npz, "--output", str(out),
            "--device", "cpu", "--no_tensorboard", "--seed", "3"]
    results = eval_diffusion.evaluate(eval_diffusion.parse_args(argv))
    assert set(results) == {"fid", "fid_mean", "fid_cov", "kid"}
    assert np.isfinite(list(results.values())).all()
    assert json.loads((out / "results.json").read_text()) == results
    assert (out / "results.csv").read_text().splitlines()[0] == ",metric"
    assert (out / "sample0000.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert eval_diffusion.evaluate(eval_diffusion.parse_args(argv)) == results  # skipped


@pytest.mark.parametrize("cli", [eval_diffusion, eval_pointnerf])
@pytest.mark.parametrize("flag,error", [(["--platform", "cpu"], ValueError)])
def test_eval_clis_refuse(tmp_path, cli, flag, error):
    out = tmp_path / "out"
    with pytest.raises(error, match=flag[0]):
        cli.evaluate(cli.parse_args(["--config", CONFIG, "--weights", "x.npz", "--output",
                                     str(out), "--device", "cpu", *flag]))
    assert not out.exists()  # refused before it wrote anything


@pytest.mark.parametrize("cli", [eval_diffusion, eval_pointnerf])
def test_eval_clis_mesh_on_two_ranks(exports, tmp_path, cli):
    """The CLI with --mesh on 2 gloo ranks (a launcher's environment): rank
    0 writes one results.json, equal to the run without --mesh within
    npcd_tpu's DP tolerances (FID/KID rtol 1e-4, atol 1e-5; PSNR 1e-5)."""
    from torch_parallel_worker import assert_one_writer, run_ranks

    _, pn_npz, ema_npz = exports
    if cli is eval_diffusion:
        argv = ["--config", _fid_config(tmp_path), "--weights", ema_npz, "--seed", "3"]
    else:
        argv = ["--config", CONFIG, "--weights", pn_npz, "--eval_batch_size", "2"]
    argv += ["--device", "cpu", "--no_tensorboard"]
    run_ranks(cli.__name__, argv + ["--output", tmp_path / "dp", "--mesh"])
    assert_one_writer(tmp_path / "dp")
    want = cli.evaluate(cli.parse_args(argv + ["--output", str(tmp_path / "one")]))
    got = json.loads((tmp_path / "dp" / "results.json").read_text())
    if cli is eval_diffusion:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    else:
        assert [(r["obj_idx"], r["view"]) for r in got["rows"]] == [
            (r["obj_idx"], r["view"]) for r in want["rows"]]
        np.testing.assert_allclose([r["psnr"] for r in got["rows"]],
                                   [r["psnr"] for r in want["rows"]], rtol=1e-5)


@pytest.mark.parametrize("cli", [eval_diffusion, eval_pointnerf])
@pytest.mark.parametrize("precision", ["highest", "float32", "tensorfloat32", "default"])
def test_eval_clis_take_matmul_precision(exports, tmp_path, monkeypatch, cli, precision):
    from npcd_tpu_torch.models.pointnerf.pointnerf import PointNeRF

    _, pn_npz, ema_npz = exports
    seen = []
    render = PointNeRF.render

    def record(self, *args, **kwargs):
        out = render(self, *args, **kwargs)
        seen.append(self.cfg.matmul_precision)
        return out

    monkeypatch.setattr(PointNeRF, "render", record)
    monkeypatch.setattr(PointNeRF, "_render", lambda self, *a, _r=PointNeRF._render: (
        seen.append(torch.backends.cuda.matmul.allow_tf32) or _r(self, *a)))
    before = torch.backends.cuda.matmul.allow_tf32
    if cli is eval_pointnerf:
        argv = ["--config", CONFIG, "--weights", pn_npz, "--num_samples", "2"]
    else:
        argv = ["--config", _fid_config(tmp_path), "--weights", ema_npz]
    res = cli.evaluate(cli.parse_args(argv + [
        "--output", str(tmp_path / "out"), "--device", "cpu", "--no_tensorboard",
        "--num_qualitatives", "0", "--matmul_precision", precision]))
    assert res
    # each render: (TF32 flag inside, the config's value); exact_f32 sets
    # the flag off for the process, which "default" leaves as it is
    pairs = set(zip(seen[::2], seen[1::2]))
    want = {"default": None}.get(precision, precision)
    assert pairs == {(precision == "tensorfloat32", want)}
    assert torch.backends.cuda.matmul.allow_tf32 == before

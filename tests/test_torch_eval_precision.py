"""DiffusionEvaluation with its extractor overlapped (a worker thread) and a
render whose matmul_precision flips PyTorch's process-wide TF32 flags: the
extractor never runs under the render's flags. The flags are global, so a
feed launched while a "tensorfloat32" render holds them would run its
GEMMs (and Inception's cuDNN convolutions) in TF32, as many of them as the
threads' timing lets through.

configs/npcd_synthetic_tiny.yaml's model (P 32, F 8, validity 'voxel') with
seeded weights renders four clouds, one a group, from 3 poses at 16². Each
render holds its flags a further 50 ms, and the extractor (the random
projection) records the flags while it feeds for 50 ms: without the wait
before each render, every feed but the last overlaps a render. On the CPU
the flags change no result but are set and read as on the card; the
``cuda`` case runs the render's kernels and the projection's cuBLAS GEMM
on the card (``python -m pytest --noconftest -m cuda
tests/test_torch_eval_precision.py``; this file imports no JAX)."""
import dataclasses
import pickle
import time

import numpy as np
import pytest
import torch

from npcd_tpu_torch.eval import DiffusionEvaluation
from npcd_tpu_torch.models.npcd import NPCD
from npcd_tpu_torch.models.pointnerf import pointnerf as pn
from npcd_tpu_torch.utils.config import load_config
from npcd_tpu_torch.utils.fidkid import ProjectionExtractor

CONFIG = "configs/npcd_synthetic_tiny.yaml"
RES, N_POSE, N_OBJ, HOLD = 16, 3, 4, 0.05
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.fixture(autouse=True)
def _restore_flags():
    saved = _flags()
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class _FlagProbe:
    """The projection extractor, fed again and again for HOLD seconds, with
    the flags it saw at each feed."""

    device_resident = True

    def __init__(self, inner):
        self.inner, self.seen = inner, []

    def __call__(self, images):
        end = time.perf_counter() + HOLD
        while True:
            self.seen.append(_flags())
            feats = self.inner(images)
            if time.perf_counter() > end:
                return feats
            time.sleep(0.002)


def _device(name):
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the render's kernels have no CPU mode)")
    return torch.device(name)


@pytest.mark.parametrize("device", DEVICES)
def test_overlapped_extractor_never_runs_under_the_render_flags(device, tmp_path, monkeypatch):
    dev = _device(device)
    config = load_config(CONFIG)
    config["render_config"] = {**config["render_config"], "validity": "voxel",
                               "matmul_precision": "tensorfloat32"}
    model = NPCD.from_config(config, seed=0).to(dev)
    state = model.seeded_state(0)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(N_OBJ, 32, 3))
    coords = d / np.linalg.norm(d, axis=-1, keepdims=True) * 0.5
    clouds = (torch.tensor(coords.transpose(0, 2, 1), dtype=torch.float32, device=dev),
              torch.tensor(rng.normal(size=(N_OBJ, 8, 32)), dtype=torch.float32, device=dev))

    inside, render = [], pn.PointNeRF._render

    def held_render(self, *a):
        out = render(self, *a)
        inside.append(_flags())
        time.sleep(HOLD)  # the flags stay set meanwhile, as a long render holds them
        return out

    monkeypatch.setattr(pn.PointNeRF, "_render", held_render)
    proj = np.random.default_rng(1).normal(size=(RES * RES * 3, 8)).astype(np.float32)
    real = rng.uniform(0, 1, (20, RES * RES * 3)).astype(np.float32) @ proj
    with open(tmp_path / "stats.pkl", "wb") as f:
        pickle.dump({"mean": real.mean(0), "cov": np.cov(real, rowvar=False), "feats_np": real}, f)
    poses = np.load("data/srncars_test_poses.npy")[:N_POSE].astype(np.float32)
    intr = np.load("data/srncars_test_intrinsics.npy")[:N_POSE].astype(np.float32)
    intr[:, :2] *= RES / 128.0
    probe = _FlagProbe(ProjectionExtractor(proj, dev))
    ev = DiffusionEvaluation(num_samples=N_OBJ, poses=poses, intrinsics=intr,
                             inception_pkl_path=str(tmp_path / "stats.pkl"),
                             feature_extractor=probe, generate_batch_size=N_OBJ,
                             render_pose_batch=N_POSE, render_object_batch=1, resolution=RES,
                             verbose=False, overlap_extraction=True, device=dev)
    ev.generate = lambda model, state, num, noise: clouds

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    assert pn.changes_tf32_flags("tensorfloat32") and not pn.changes_tf32_flags("highest")
    res = ev(model, state, noise=lambda shape: None, kid_seed=0)
    assert np.isfinite(list(res.values())).all()
    assert inside == [(True, True)] * N_OBJ  # every render ran in TF32
    assert len(probe.seen) >= N_OBJ and set(probe.seen) == {(False, False)}
    assert _flags() == (False, False)

    # a render at the flags' own values flips nothing: the feeds still overlap
    model.pointnerf.cfg = dataclasses.replace(model.pointnerf.cfg, matmul_precision="highest")
    inside.clear()
    ev(model, state, noise=lambda shape: None, kid_seed=0)
    assert inside == [(False, False)] * N_OBJ

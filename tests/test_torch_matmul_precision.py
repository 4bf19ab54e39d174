"""The render config's matmul_precision, on the CPU: every value npcd_tpu's
PointNeRFRenderConfig takes is accepted from a YAML render_config section
(None, "default", "float32", "highest", "tensorfloat32", "high") and any
other raises; PointNeRF.render (and so eval_forward) runs with PyTorch's
TF32 flags for cuBLAS and cuDNN set as the value says (off for highest /
float32, on for tensorfloat32 / high, untouched for None / default) and
restores both after, also when the render raises; and on the CPU, where the
flags change nothing, the "tensorfloat32" render is bitwise the "highest"
one and within 1e-4 of npcd_tpu's render at matmul_precision
"tensorfloat32" (tests/test_torch_generation.py's render tolerance,
validity 'voxel')."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npcd_tpu.models.npcd import NPCD as JaxNPCD
from npcd_tpu.utils.config import load_config as jax_load_config
from npcd_tpu_torch.models.pointnerf import pointnerf as pn
from npcd_tpu_torch.utils.builders import build_pointnerf
from npcd_tpu_torch.utils.config import load_config
from npcd_tpu_torch.utils.from_jax import pointnerf_state_dict

CONFIG = "configs/npcd_synthetic_tiny.yaml"
RES = 16
# value -> the two flags inside the render (None: as they were)
INSIDE = {None: None, "default": None, "float32": False, "highest": False,
          "tensorfloat32": True, "high": True}


@pytest.fixture(autouse=True)
def _flags():
    """Each test starts from the flags' defaults and leaves them so."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _config(loader, **render):
    cfg = loader(CONFIG)
    cfg["render_config"] = {**cfg["render_config"], "validity": "voxel", **render}
    return cfg


def _flag_state():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _clouds(n=2, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-0.6, 0.6, (n, 32, 3)).astype(np.float32)
    feats = rng.normal(size=(n, 32, 8)).astype(np.float32)
    pose = np.load("data/srncars_test_poses.npy")[:2].astype(np.float32)
    intr = np.load("data/srncars_test_intrinsics.npy")[:2].astype(np.float32)
    intr[:, :2] *= RES / 128.0
    return coords, feats, np.broadcast_to(pose, (n, 2, 4, 4)).copy(), \
        np.broadcast_to(intr, (n, 2, 3, 3)).copy()


@pytest.mark.parametrize("value", list(INSIDE))
def test_yaml_value_accepted_and_render_sets_then_restores_the_flags(value, monkeypatch):
    model = build_pointnerf(_config(load_config, matmul_precision=value))
    assert model.cfg.matmul_precision == value
    seen = []
    monkeypatch.setattr(pn.PointNeRF, "_render",
                        lambda self, *a: seen.append(_flag_state()) or {"channels": None})
    for before in ((False, True), (True, False)):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
        model.render(*map(torch.from_numpy, _clouds()), resolution=RES)
        want = before if INSIDE[value] is None else (INSIDE[value],) * 2
        assert seen.pop() == want
        assert _flag_state() == before


@pytest.mark.parametrize("value", ["tensorfloat32", "highest"])
def test_flags_restored_when_the_render_raises(value, monkeypatch):
    model = build_pointnerf(_config(load_config, matmul_precision=value))

    def fail(self, *a):
        raise RuntimeError("render failed")

    monkeypatch.setattr(pn.PointNeRF, "_render", fail)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    with pytest.raises(RuntimeError, match="render failed"):
        model.render(*map(torch.from_numpy, _clouds()), resolution=RES)
    assert _flag_state() == (False, True)


@pytest.mark.parametrize("value", ["tf32", "bfloat16", "HIGHEST", ""])
def test_other_values_raise(value):
    with pytest.raises(ValueError, match="matmul_precision"):
        build_pointnerf(_config(load_config, matmul_precision=value))


def test_tensorfloat32_render_on_the_cpu_matches_highest_and_jax():
    jmodel = JaxNPCD.from_config(_config(jax_load_config, matmul_precision="tensorfloat32"),
                                 pointnerf_only=True)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmodel.pointnerf.init_params(jax.random.PRNGKey(1)))
    coords, feats, extr, intr = _clouds()
    want = jax.jit(lambda *a: jmodel.pointnerf.render(*a, resolution=RES))(
        params, *map(jnp.asarray, (coords, feats, extr, intr)))
    state = {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in pointnerf_state_dict(params).items()}
    renders = {}
    for value in ("tensorfloat32", "highest"):
        model = build_pointnerf(_config(load_config, matmul_precision=value))
        model.load_state_dict(state)
        renders[value] = model.render(*map(torch.from_numpy, (coords, feats, extr, intr)),
                                      resolution=RES)
    for k, v in renders["highest"].items():
        assert torch.equal(renders["tensorfloat32"][k], v), k
    got = renders["tensorfloat32"]
    valid = np.asarray(want["ray_valid"])
    assert 0.05 < valid.mean() < 0.95
    np.testing.assert_array_equal(got["ray_valid"].numpy(), valid)
    np.testing.assert_allclose(got["channels"].numpy(), np.asarray(want["channels"]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["mask"].numpy(), np.asarray(want["mask"]), rtol=0, atol=1e-4)

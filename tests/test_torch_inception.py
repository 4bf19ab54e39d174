"""The port's keras-weights InceptionV3 (npcd_tpu_torch/utils/inception_keras.py)
against npcd_tpu's (npcd_tpu/utils/inception_jax.py) on the CPU, on the same
seeded random weights (``inception_keras.random_weights(0)``: kernels with
variance 2 / fan-in, var in [0.5, 1.5], so that the features stay O(1)
through the 94 blocks) and the same seeded images.

Tolerance: every output within 1e-5 of its scale (the largest |value| of
npcd_tpu's output). XLA's and PyTorch's CPU convolutions sum in other
orders and the port folds each BatchNorm into its convolution in float64,
so the two differ by f32 roundings, ~1e-6 of the scale through the whole
network. The resize within 3e-5 of its scale: each side computes its
triangle weights in f32 by its own formula, and PyTorch's own f32 and f64
antialiased resizes differ by 3.1e-5 at 320² -> 299² (its upsampling
agrees to ~1e-7); the max pool bitwise, the average pool within 2**-22.

The eval: both DiffusionEvaluations with ``feature_extractor=
"inception_jax:<an .h5 written with h5py>"`` on the same renders
(test_torch_eval's setup), FID and KID (npcd_tpu's subsets drawn from the
port's kid_seed) within 1e-4 relative."""
import pickle
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npcd_tpu.eval import DiffusionEvaluation as JaxDiffusionEvaluation
from npcd_tpu.utils import fidkid as jax_fidkid
from npcd_tpu.utils import inception_jax as J
from npcd_tpu_torch.utils import inception_keras as K
from test_torch_eval import RES, _jax_renders, _kw, _port_eval, _Recorder, setup  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return K.random_weights(0)


@pytest.fixture(scope="module")
def jax_params(weights):
    return [tuple(jnp.asarray(a) for a in p) for p in weights]


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0.1 and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= tol * scale, (err, scale)
    return err / scale


def _write_h5(path, weights, one_based: bool, nested: bool):
    """The weights as a keras file: layers conv2d[_i] and
    batch_normalization[_i] 0-based (tf-keras) or 1-based (the Keras 2.0
    release file), each weight at <layer>/<name>:0 or
    <layer>/<layer>/<name>:0."""
    with h5py.File(path, "w") as f:
        for i, (kernel, beta, mean, var) in enumerate(weights):
            j = i + one_based
            for base, leaves in (("conv2d", {"kernel:0": kernel}),
                                 ("batch_normalization", {"beta:0": beta, "moving_mean:0": mean,
                                                          "moving_variance:0": var})):
                name = base if j == 0 else f"{base}_{j}"
                g = f.create_group(name)
                if nested:
                    g = g.create_group(name)
                for k, v in leaves.items():
                    g.create_dataset(k, data=v)
    return str(path)


# 0: 3x3 stride 2 VALID, 2: 3x3 SAME, 26: mixed 3's 3x3 stride 2, 32/33: 1x7 and
# 7x1 SAME, 78/79: 1x3 and 3x1 SAME
@pytest.mark.parametrize("block", [0, 2, 26, 32, 33, 78, 79])
def test_conv_bn_matches_jax(weights, block):
    kh, kw, ci, co, stride, padding = K.CONVS[block]
    x = np.random.default_rng(block).uniform(-1, 2, (2, 13, 11, ci)).astype(np.float32)
    want = J.conv_bn(jnp.asarray(x), tuple(jnp.asarray(a) for a in weights[block]), stride,
                     padding)
    got = K.conv_bn(torch.from_numpy(x).permute(0, 3, 1, 2),
                    K.fold_conv_bn(*weights[block]), stride, padding)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("size", [8, 9])
def test_pools_match_jax(size):
    x = np.random.default_rng(size).normal(size=(2, size, size + 1, 5)).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    back = lambda y: y.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(back(K.max_pool(t)), np.asarray(J._max_pool(jnp.asarray(x))))
    want = np.asarray(J._avg_pool_same(jnp.asarray(x)))
    np.testing.assert_allclose(back(K.avg_pool_same(t)), want, rtol=0,
                               atol=2**-22 * np.abs(want).max())
    # padded cells are not counted: the corner is the mean of its 2 x 2 cells
    np.testing.assert_allclose(want[:, 0, 0], x[:, :2, :2].mean((1, 2)), rtol=1e-6)


def test_features_match_jax_at_75(weights, jax_params):
    """The whole network at 75², the smallest input its VALID stages take
    (mixed 8 leaves 1 x 1)."""
    x = np.random.default_rng(1).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    want = np.asarray(jax.jit(J.inception_v3_features)(jax_params, jnp.asarray(x)))
    got = K.inception_v3_features(K.torch_params(weights),
                                  torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, K.FEATURE_DIM)
    _close(got.numpy(), want)


@pytest.mark.parametrize("size", [128, 320])
def test_resize_matches_jax(size):
    """Bilinear with half-pixel centres up from 128², antialiased down from
    320² (jax.image.resize widens its kernel when it shrinks); without the
    antialias the 320² resize falls outside the tolerance."""
    x = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), method="bilinear"))
    got = K.resize(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    _close(got, want, tol=3e-5)
    if size > 299:
        plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                                size=(299, 299), mode="bilinear")
        assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 1e-3


@pytest.mark.parametrize("size,n,batch", [(128, 3, 2), (320, 2, 2)])
def test_extractor_matches_jax(weights, size, n, batch):
    """End to end at 299²: from 128² renders with N > batch (the last chunk
    padded to the batch with its first image), and from 320² images; numpy
    and tensor feeds give the same features bitwise."""
    x = np.random.default_rng(size).uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    want = J.JaxInceptionExtractor(weights, batch_size=batch)(x)
    ext = K.KerasInceptionExtractor(weights, batch_size=batch, device="cpu")
    assert ext.feature_dim == 2048 and ext.device_resident
    chunks, features = [], ext.features
    ext.features = lambda c: chunks.append(tuple(c.shape)) or features(c)
    got = ext(x)
    assert chunks == [(batch, size, size, 3)] * -(-n // batch)
    assert got.dtype == np.float32 and got.shape == (n, 2048)
    _close(got, want)
    np.testing.assert_array_equal(ext(torch.from_numpy(x)), got)


@pytest.mark.parametrize("one_based", [False, True], ids=["0-based", "1-based"])
@pytest.mark.parametrize("nested", [False, True], ids=["flat", "nested"])
def test_load_keras_h5(weights, tmp_path, one_based, nested):
    path = _write_h5(tmp_path / "w.h5", weights, one_based, nested)
    got, want = K.load_keras_h5(path), J.load_keras_h5(path)
    assert len(got) == len(want) == K.N_CONV
    for g, w, p in zip(got, want, weights):
        for a, b, c in zip(g, w, p):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_params_from_keras_model_matches_jax(weights):
    """A model's layers in topological order, named by creation index as
    tf-keras names them (the first without a suffix): both read them back
    in creation order."""

    def layer(cls, name, values):
        return type(cls, (), {"name": name, "get_weights": lambda self: list(values)})()

    layers = []
    for i, (kernel, beta, mean, var) in enumerate(weights):
        suffix = "" if i == 0 else f"_{i}"
        layers += [layer("Conv2D", "conv2d" + suffix, [kernel]),
                   layer("BatchNormalization", "batch_normalization" + suffix,
                         [beta, mean, var])]
    order = np.random.default_rng(0).permutation(len(layers))
    model = type("Model", (), {"layers": [layers[i] for i in order]})()
    got, want = K.params_from_keras_model(model), J.params_from_keras_model(model)
    for g, w, p in zip(got, want, weights):
        for a, b, c in zip(g, w, p):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    model.layers = model.layers[1:]
    with pytest.raises(ValueError, match="expected 94 conv/bn layers"):
        K.params_from_keras_model(model)


def test_load_keras_h5_refusals(tmp_path, monkeypatch):
    with h5py.File(tmp_path / "other.h5", "w") as f:
        f.create_group("dense")
    for load in (K.load_keras_h5, J.load_keras_h5):
        with pytest.raises(ValueError, match="neither 'conv2d' nor 'conv2d_1'"):
            load(str(tmp_path / "other.h5"))
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        K.load_keras_h5(str(tmp_path / "other.h5"))


@pytest.mark.parametrize("fault", ["extra", "missing", "shape"])
def test_wrong_weight_list(weights, fault):
    bad = {"extra": weights + weights[-1:], "missing": weights[:-1],
           "shape": weights[:3] + [(weights[3][0][:, :, :, :40],) + weights[3][1:]]
           + weights[4:]}[fault]
    with pytest.raises(ValueError, match="wrong weight list"):
        K.KerasInceptionExtractor(bad, device="cpu")
    with pytest.raises(ValueError, match="wrong weight list"):
        K.inception_v3_features(K.torch_params(weights)[:-1], torch.zeros(1, 3, 75, 75))
    if fault == "extra":  # npcd_tpu raises after its forward (here traced, not run)
        with pytest.raises(ValueError, match="1 unused inception params — wrong weight list"):
            jax.eval_shape(J.inception_v3_features, bad, jnp.zeros((1, 75, 75, 3)))


def test_conv_flops():
    """conv_flops (the network walked on the meta device) against the table
    summed by hand: 2 kh kw c_in c_out s² a block, s each block's output
    side at 299²; 5.71 G multiply-adds an image."""
    side = ([149, 147, 147, 73, 71] + [35] * 21 + [17, 35, 35, 17] + [17] * 40
            + [17, 8, 17, 17, 17, 8] + [8] * 18)
    assert len(side) == K.N_CONV
    want = sum(2 * kh * kw * ci * co * s * s for (kh, kw, ci, co, _, _), s in zip(K.CONVS, side))
    assert K.conv_flops(299) == want == 11_422_336_192


def test_eval_inception_matches_jax(setup, tmp_path, weights, monkeypatch):
    """Both evals with feature_extractor="inception_jax:<h5>" on the same
    clouds: the port's renders replaced by npcd_tpu's, so that both feed the
    same quantized images; features within the tolerance, FID and KID
    within 1e-4 relative."""
    s = setup
    path = _write_h5(tmp_path / "w.h5", weights, one_based=True, nested=False)
    real = K.KerasInceptionExtractor(weights, device="cpu")(
        np.random.default_rng(7).uniform(0, 1, (8, RES, RES, 3)).astype(np.float32))
    pkl = tmp_path / "real.pkl"
    with open(pkl, "wb") as f:
        pickle.dump({"mean": real.mean(0), "cov": np.cov(real, rowvar=False), "feats_np": real}, f)
    kw = dict(feature_extractor=f"inception_jax:{path}", inception_pkl_path=str(pkl))

    renders = _jax_renders(s)
    ev = _port_eval(s, **kw)
    assert isinstance(ev.feature_extractor, K.KerasInceptionExtractor)
    ev.feature_extractor = rec = _Recorder(ev.feature_extractor)
    ev.generate = lambda *a: (torch.from_numpy(s["coords"]), torch.from_numpy(s["feats"]))
    ev.render_objects = lambda *a: torch.from_numpy(renders)
    got = ev(s["model"], s["state"], noise=lambda shape: None, kid_seed=0)

    jev = JaxDiffusionEvaluation(**_kw(s, **kw))
    assert isinstance(jev.feature_extractor, J.JaxInceptionExtractor)
    jev.feature_extractor = jax_rec = _Recorder(jev.feature_extractor)
    jmodel = s["jmodel"]
    monkeypatch.setattr(jmodel.diffusion, "generate", lambda *a, **k: (s["coords"], s["feats"]))
    summary = jax_fidkid.FIDKID.summary
    monkeypatch.setattr(jax_fidkid.FIDKID, "summary", lambda self, seed=None: summary(self, 0))
    want = jev(jmodel, s["params"]["pointnerf"], s["jstate"], rng=jax.random.PRNGKey(3))

    # the same levels; npcd_tpu quantizes a device feed with jnp, an ulp off x / 255
    images = torch.cat(rec.images).numpy()
    np.testing.assert_allclose(images, np.concatenate(jax_rec.images), rtol=0, atol=2**-24)
    assert len(np.unique(np.round(images * 255))) > 20
    _close(np.concatenate(rec.feats), np.concatenate(jax_rec.feats))
    assert set(got) == {"fid", "fid_mean", "fid_cov", "kid"}
    for k in ("fid", "kid"):
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)

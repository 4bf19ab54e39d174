"""The port's FID/KID (npcd_tpu_torch/utils/fidkid.py) against npcd_tpu's on
the same features: the same numpy/scipy arithmetic, so every number is
bitwise equal. The Inception feed: the tensor handed to the TorchScript
graph (a fake module here) is NCHW uint8 round(img * 255) for 255-level
images, bitwise npcd_tpu's extractor's for any image, and a device-resident
extractor gives bitwise the same features fed a tensor or numpy."""
import pickle

import numpy as np
import pytest
import torch

from npcd_tpu.utils import fidkid as jax_fidkid
from npcd_tpu_torch.utils import fidkid


def _feats(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("n", [40, 5])  # 5 < D: singular covariances
def test_calc_fid_matches_jax(n):
    fake, real = _feats(n, 8, 0), _feats(n + 3, 8, 1) + 0.5
    args = (fake.mean(0), np.cov(fake, rowvar=False), real.mean(0), np.cov(real, rowvar=False))
    got, want = fidkid.calc_fid(*args), jax_fidkid.calc_fid(*args)
    assert got == want
    assert all(np.isfinite(got))


def test_calc_fid_eps_retry_matches_jax():
    """A covariance product without a square root (nilpotent: sqrtm gives
    inf) takes the retry with eps on the diagonals."""
    import scipy.linalg

    nilpotent = np.array([[0.0, 1.0], [0.0, 0.0]])
    assert not np.isfinite(scipy.linalg.sqrtm(nilpotent)).all()
    args = (np.zeros(2), nilpotent, np.ones(2), np.eye(2))
    got = fidkid.calc_fid(*args)
    assert got == jax_fidkid.calc_fid(*args) and all(np.isfinite(got))


@pytest.mark.parametrize("sizes", [(30, 50, 1000), (30, 50, 20)])
def test_calc_kid_matches_jax(sizes):
    n_fake, n_real, max_subset = sizes
    fake, real = _feats(n_fake, 8, 2), _feats(n_real, 8, 3)
    got = fidkid.calc_kid(real, fake, 10, max_subset, rng=np.random.default_rng(7))
    want = jax_fidkid.calc_kid(real, fake, 10, max_subset, rng=np.random.default_rng(7))
    assert got == want and np.isfinite(got)


@pytest.mark.parametrize("with_pickle", [True, False])
def test_fidkid_summary_matches_jax(tmp_path, with_pickle):
    """Streamed feeds in chunks, real statistics from the reference's pickle
    or from fed reals; summary(seed) bitwise npcd_tpu's."""
    real, fake = _feats(24, 6, 4), _feats(24, 6, 5) * 1.3
    pkl = None
    if with_pickle:
        pkl = str(tmp_path / "stats.pkl")
        with open(pkl, "wb") as f:
            pickle.dump({"mean": real.mean(0), "cov": np.cov(real, rowvar=False),
                         "feats_np": real}, f)
    sides = []
    for mod in (fidkid, jax_fidkid):
        acc = mod.FIDKID(num_images=20, feature_extractor=lambda x: x, inception_pkl=pkl,
                         num_subsets=5)
        acc.prepare()
        for part in np.array_split(fake, 3):
            acc.feed(part, "fakes")
        if not with_pickle:
            acc.feed(real[:10], "reals")
            acc.feed(real[10:], "reals")
        sides.append(acc.summary(seed=11))
    assert sides[0] == sides[1]
    assert set(sides[0]) == {"fid", "fid_mean", "fid_cov", "kid"}


class _FakeTS:
    """Records what the graph is fed; features from its values."""

    def __init__(self):
        self.inputs = []

    def __call__(self, x, return_features=False):
        assert return_features
        self.inputs.append(x)
        return x.float().reshape(len(x), 3, -1).mean(-1)


def test_inception_feed_contract():
    """NCHW uint8 with values exactly round(img * 255) for 255-level images,
    in batches of batch_size (npcd_tpu's tests/test_eval_pipelines.py)."""
    fake = _FakeTS()
    extractor = fidkid.TorchScriptInceptionExtractor(model=fake, batch_size=2, device="cpu")
    levels = np.random.default_rng(0).integers(0, 256, (3, 8, 8, 3))
    feats = extractor((levels / 255.0).astype(np.float32))
    assert feats.shape == (3, 3) and isinstance(feats, np.ndarray)
    assert [tuple(x.shape) for x in fake.inputs] == [(2, 3, 8, 8), (1, 3, 8, 8)]
    x = torch.cat(fake.inputs)
    assert x.dtype == torch.uint8
    np.testing.assert_array_equal(x.numpy(), levels.transpose(0, 3, 1, 2).astype(np.uint8))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_inception_feed_matches_jax(dtype):
    """Any image in [0, 1], f32 or f64: the port feeds the graph bitwise what
    npcd_tpu's extractor feeds it."""
    images = np.random.default_rng(1).uniform(0, 1, (5, 6, 6, 3)).astype(dtype)
    got, want = _FakeTS(), _FakeTS()
    fidkid.TorchScriptInceptionExtractor(model=got, device="cpu")(images)
    jax_fidkid.TorchScriptInceptionExtractor(model=want)(images)
    assert torch.equal(got.inputs[0], want.inputs[0])


@pytest.mark.parametrize("kind", ["torchscript", "projection"])
def test_extractor_tensor_feed_equals_numpy_feed(kind):
    images = np.round(np.random.default_rng(2).uniform(0, 1, (7, 8, 8, 3)) * 255) / 255
    images = images.astype(np.float32)
    if kind == "torchscript":
        ext = fidkid.TorchScriptInceptionExtractor(model=_FakeTS(), batch_size=4, device="cpu")
    else:
        ext = fidkid.ProjectionExtractor(_feats(8 * 8 * 3, 5, 3), device="cpu")
    assert ext.device_resident
    a, b = ext(torch.from_numpy(images)), ext(images)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("same", [False, True])
def test_psnr_matches_jax(same):
    """The float64 MSE, and inf where the two are equal."""
    from npcd_tpu.utils.util import psnr as jax_psnr
    from npcd_tpu_torch.utils.util import psnr

    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    b = a.copy() if same else rng.uniform(0, 1, (16, 3)).astype(np.float32)
    assert psnr(a, b) == jax_psnr(a, b)
    assert (psnr(a, b) == float("inf")) == same

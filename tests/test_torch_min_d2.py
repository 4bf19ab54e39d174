"""Kernel K5 (minimum squared distance) and the radius test of the PyTorch
port against npcd_tpu, on the same numpy inputs.

The port's plain version computes ((dx*dx + dy*dy) + dz*dz) in f32 with no
fused multiply-add, as the CUDA kernel does, so that the card and the CPU
give the same float: it must equal numpy's f32 evaluation of that form bit
for bit. The Pallas kernel computes the same direct form, but in interpret
mode XLA on the CPU contracts it into two FMAs, fma(dz, dz, fma(dx, dx,
dy*dy)): each contraction skips one rounding of a product, so the two sides
agree within 5e-7 relative (a few ulps). npcd_tpu's XLA path (what its
within_radius_t runs on the CPU) uses |x|^2 - 2x.p + |p|^2 instead, which
can flip a query within an ulp of the radius: the tests assert that no
query lies within 1e-4 (relative) of it, so that another seed fails loudly
instead of flakily."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops import knn as jax_knn
from npcd_tpu.ops.pallas.knn import pallas_min_d2, pallas_min_d2_t
from npcd_tpu_torch.ops.kernels.knn import min_d2, min_d2_plain
from npcd_tpu_torch.ops.knn import within_radius

MARGIN = 1e-4


def _queries(seed, b, n, p, scale=0.1):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (b, p, 3)).astype(np.float32)
    near = pts[:, rng.integers(0, p, n)] + rng.normal(scale=scale, size=(b, n, 3))
    return near.astype(np.float32), pts


def assert_radius_margin(x, pts, radius):
    """No query's min squared distance (float64) within MARGIN of radius^2."""
    d2 = ((x[:, :, None, :].astype(np.float64) - pts[:, None].astype(np.float64)) ** 2).sum(-1)
    rel = np.abs(d2.min(-1) - radius ** 2) / radius ** 2
    assert rel.min() > MARGIN, f"a query lies {rel.min():.1e} from the radius: pick another seed"


@pytest.mark.parametrize("b,n,p", [(2, 300, 130), (3, 77, 5), (1, 1000, 512)])
def test_min_d2_plain_matches_pallas_interpret(b, n, p):
    # ragged query counts, P not a multiple of 8, batched instances
    x, pts = _queries(b * n + p, b, n, p)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_min_d2_t(jnp.asarray(np.swapaxes(x, 1, 2)), jnp.asarray(pts)))
        ref_shim = np.asarray(pallas_min_d2(jnp.asarray(x), jnp.asarray(pts)))
    got = min_d2(torch.from_numpy(x), torch.from_numpy(pts)).numpy()
    assert got.shape == (b, n) and got.dtype == np.float32
    d = [pts[:, None, :, c] - x[:, :, None, c] for c in range(3)]
    np.testing.assert_array_equal(got, ((d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]).min(-1))
    np.testing.assert_allclose(got, ref, rtol=5e-7, atol=0)
    np.testing.assert_array_equal(ref_shim, ref)


def test_min_d2_plain_chunks_and_empty_clouds():
    # more instances than one chunk of the plain version holds
    x, pts = _queries(5, 40, 2000, 1024)
    want = ((pts[:, None].astype(np.float64) - x[:, :, None]) ** 2).sum(-1).min(-1)
    got = min_d2_plain(torch.from_numpy(x), torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.isinf(min_d2_plain(torch.zeros(2, 3, 3), torch.zeros(2, 0, 3)).numpy()).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_within_radius_matches_jax_xla(seed):
    radius = 0.16
    x, pts = _queries(seed, 3, 500, 64)
    assert_radius_margin(x, pts, radius)
    ref = np.asarray(jax_knn.within_radius_t(jnp.asarray(np.swapaxes(x, 1, 2)),
                                             jnp.asarray(pts), radius, impl="xla"))
    got = within_radius(torch.from_numpy(x), torch.from_numpy(pts), radius).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0.1 < got.mean() < 0.9


def test_min_d2_rejects_bad_shapes():
    with pytest.raises(ValueError, match="min_d2"):
        min_d2(torch.zeros(2, 5, 3), torch.zeros(3, 4, 3))
    with pytest.raises(ValueError, match="min_d2"):
        min_d2(torch.zeros(2, 5, 2), torch.zeros(2, 4, 3))

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
instead of flakily. The CUDA kernel finds the minimum with |p|^2 - 2x.p as
a filter and the exact form only where the filter cannot rule a point out;
test_k5_filter_contract holds its numpy transcription (tests/min_d2_filter.py)
bitwise to the plain version."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops import knn as jax_knn
from npcd_tpu.ops.pallas.knn import pallas_min_d2, pallas_min_d2_t
from npcd_tpu_torch.ops.kernels.knn import min_d2, min_d2_plain
from npcd_tpu_torch.ops.knn import within_radius

from min_d2_filter import hard_min_d2_inputs, k5_filter, k5_sweep

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


@pytest.mark.parametrize("p", [1, 3, 5, 130, 512, 600])
def test_k5_filter_contract(p):
    """K5's arithmetic so transcribed equals min_d2_plain bitwise on clouds
    with exact ties, duplicated points, two positions and points at the
    extent's corners, with queries at the render cube's corners, on grid
    nodes and on bisectors, where the two nearest exact d2 differ by 1-6
    ulps and the filter orders them the other way (such queries must
    exist); it agrees with npcd_tpu's Pallas kernel (interpret mode) as
    test_min_d2_plain_matches_pallas_interpret holds it; above 32 points
    some query takes two or more groups; the filter's value as the answer,
    or (past one point) the exact d2 of the filter's argmin alone, does not
    equal min_d2_plain."""
    xt, pt = hard_min_d2_inputs(8, 160, p, seed=p)
    x, pts = xt.numpy(), pt.numpy()
    want = min_d2_plain(xt, pt).numpy()
    got, taken, _ = k5_sweep(x, pts)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert taken.min() >= 1
    if p > 32:
        assert taken.max() >= 2
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_min_d2_t(jnp.asarray(np.swapaxes(x, 1, 2)), jnp.asarray(pts)))
    np.testing.assert_allclose(got, ref, rtol=5e-7, atol=0)
    if p >= 5:
        # the two nearest exact d2 1-6 ulps apart, the filter reversing them
        d = [x[:, :, None, c] - pts[:, None, :, c] for c in range(3)]
        exact = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        order = np.argsort(exact, -1, kind="stable")[..., :2]
        first, second = np.take_along_axis(exact, order, -1).transpose(2, 0, 1)
        s1, s2 = np.take_along_axis(k5_filter(x, pts, p)[1], order, -1).transpose(2, 0, 1)
        ulps = second.view(np.int32) - first.view(np.int32)
        assert ((ulps >= 1) & (ulps <= 6) & (s2 < s1)).sum() > 0
    for fault in ("filter", "argmin") if p > 1 else ("filter",):  # one point: its argmin
        assert (k5_sweep(x, pts, fault=fault)[0] != want).any()

"""Kernel K4 (kNN) and the voxel-occupancy validity test of the PyTorch
port against npcd_tpu, on the same numpy inputs.

kNN tolerance: the port's plain version and the Pallas kernel compute
sum((p - x)^2) directly, npcd_tpu's XLA path |x|^2 - 2x.p + |p|^2, and the
Pallas kernel truncates d2 by its index bits (~2^-14 relative): near-equal
neighbours may swap, so distances are compared within 1e-5 and indices may
differ on at most 0.1% of the slots. The occupancy grid and its query are
integer/boolean and must match exactly."""
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.models.pointnerf.aggregator import compact_valid_samples as jax_compact
from npcd_tpu.ops import knn as jax_knn
from npcd_tpu.ops.pallas.knn import pallas_knn_t
from npcd_tpu.utils.config import VoxelGridOptions
from npcd_tpu_torch.models.pointnerf.aggregator import compact_valid_samples
from npcd_tpu_torch.ops.knn import VoxelOccupancy, dense_knn_batched
from npcd_tpu_torch.ops.kernels.knn import knn

K, RADIUS = 8, 0.5


def _clouds(seed=0, b=2, n=400, p=130):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    pts = rng.uniform(-1, 1, (b, p, 3)).astype(np.float32)
    return x, pts


def _dist(x, pts, idx):
    nb = np.take_along_axis(pts[:, None], idx[..., None].astype(np.int64), axis=2)
    return np.linalg.norm(x[:, :, None] - nb, axis=-1)


def test_knn_matches_jax_xla():
    x, pts = _clouds()
    i_ref, m_ref = (np.asarray(a) for a in jax_knn.dense_knn_batched(
        jnp.asarray(x), jnp.asarray(pts), K, RADIUS, impl="xla"))
    i_got, m_got = (a.numpy() for a in dense_knn_batched(
        torch.from_numpy(x), torch.from_numpy(pts), K, RADIUS))
    assert i_got.dtype == np.int32 and i_got.shape == (2, 400, K)
    np.testing.assert_array_equal(m_got, m_ref)
    np.testing.assert_allclose(_dist(x, pts, i_got), _dist(x, pts, i_ref), rtol=1e-5, atol=1e-6)
    assert (i_got != i_ref).mean() < 1e-3


def test_knn_matches_pallas_interpret():
    x, pts = _clouds(seed=1)
    with pltpu.force_tpu_interpret_mode():
        i_ref, d_ref = (np.asarray(a) for a in pallas_knn_t(
            jnp.asarray(np.swapaxes(x, 1, 2)), jnp.asarray(pts), K))
    i_got, d_got = (a.numpy() for a in knn(torch.from_numpy(x), torch.from_numpy(pts), K))
    np.testing.assert_allclose(d_got, np.swapaxes(d_ref, 1, 2), rtol=2**-13, atol=1e-7)
    assert (i_got != np.swapaxes(i_ref, 1, 2)).mean() < 1e-3


def test_knn_ties_and_short_clouds_match_jax():
    # duplicated points tie exactly: the lower index comes first; with fewer
    # points than k the trailing slots are (index 0, invalid)
    pts = np.array([[[0.0, 0, 0]] * 4 + [[1.0, 0, 0]] * 3], np.float32)
    x = np.array([[[0.1, 0, 0], [0.9, 0, 0]]], np.float32)
    i_ref, m_ref = (np.asarray(a) for a in jax_knn.dense_knn_batched(
        jnp.asarray(x), jnp.asarray(pts), K, 2.0, impl="xla"))
    i_got, m_got = (a.numpy() for a in dense_knn_batched(
        torch.from_numpy(x), torch.from_numpy(pts), K, 2.0))
    np.testing.assert_array_equal(i_got, i_ref)
    np.testing.assert_array_equal(m_got, m_ref)


def test_voxel_occupancy_bit_exact():
    rng = np.random.default_rng(2)
    opts = VoxelGridOptions()
    pts = rng.uniform(-1.1, 1.1, (3, 64, 3)).astype(np.float32)  # some out of range
    q = rng.uniform(-1.2, 1.2, (3, 500, 3)).astype(np.float32)
    occ_j = jax_knn.VoxelOccupancy.build(jnp.asarray(pts), opts)
    occ_t = VoxelOccupancy.build(torch.from_numpy(pts), opts)
    assert occ_t.dims == occ_j.dims
    np.testing.assert_array_equal(occ_t.grid.numpy(), np.asarray(occ_j.grid))
    got = occ_t.query(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(occ_j.query(jnp.asarray(q))))
    assert 0 < got.mean() < 1


def test_compact_valid_samples_matches_jax():
    rng = np.random.default_rng(3)
    valid = rng.uniform(size=(2, 7, 24)) < 0.4
    depths = np.sort(rng.uniform(1, 3, (2, 7, 24)), axis=-1).astype(np.float32)
    d_ref, m_ref = (np.asarray(a) for a in jax_compact(jnp.asarray(valid), jnp.asarray(depths), 5))
    d_got, m_got = (a.numpy() for a in compact_valid_samples(
        torch.from_numpy(valid), torch.from_numpy(depths), 5))
    np.testing.assert_array_equal(m_got, m_ref)
    np.testing.assert_array_equal(d_got[m_got], d_ref[m_ref])

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
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.models.pointnerf.aggregator import compact_valid_samples as jax_compact
from npcd_tpu.ops import knn as jax_knn
from npcd_tpu.ops.pallas.knn import pallas_knn_t
from npcd_tpu.utils.config import VoxelGridOptions
from npcd_tpu_torch.models.pointnerf.aggregator import compact_valid_samples
from npcd_tpu_torch.ops.knn import VoxelOccupancy, dense_knn_batched
from npcd_tpu_torch.ops.kernels.knn import knn, knn_plain

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


def _k4_sweeps(x, pts, lanes, cap=48, ties_high=False, k=K):
    """K4's arithmetic (``knn_kernel`` of csrc/knn.cu) on x [I, N, 3] and
    pts [I, P, 3] (numpy f32): the points padded to a multiple of 4 with
    +inf; the exact d2 ((dx*dx + dy*dy) + dz*dz), rounded after each
    operation, and the approximate one with two FMAs (each an f64 product
    and sum rounded to f32); the four-point groups g to lane g mod
    ``lanes``; sweep 1: per lane the q-th smallest approximate d2 of each
    subset j mod 4 of its points, q = ceil(k / 4) (the two smallest at k
    8), t the largest of those four, and the least t of the query's lanes;
    sweep 2: a lane's candidates, approximate d2 <= t (1 + 2**-18) +
    2**-100; each lane's list of KC (8, 16 or 32, the least at or above
    k): its candidates below P by exact d2 in ascending index (the kernel's
    strict insertion: a stable sort), or, past ``cap`` candidates, all its
    points; the query's k: the lists merged by (d2, index), slots past P
    (0, inf). ``ties_high``: the higher index first on equal d2, in the
    lists and the merge (the planted fault) -> (idx [I, N, k] int32, d2
    [I, N, k] f32, lanes past the cap)."""
    f32, f64 = np.float32, np.float64
    inst, n, _ = x.shape
    p = pts.shape[1]
    p4 = -(-p // 4) * 4
    kc, q_th = next(c for c in (8, 16, 32) if k <= c), -(-k // 4)
    padded = np.concatenate([pts, np.full((inst, p4 - p, 3), np.inf, f32)], 1)
    dx, dy, dz = (padded[:, None, :, c] - x[:, :, None, c] for c in range(3))
    exact = dx * dx + dy * dy + dz * dz  # [I, N, P4] f32, left to right
    fma = lambda a, b, c: (a.astype(f64) * b + c).astype(f32)
    approx = fma(dz, dz, fma(dy, dy, dx * dx))
    j = np.arange(p4)
    lane_of = (j // 4) % lanes
    qth = lambda v: (np.sort(v, -1)[..., q_th - 1] if v.shape[-1] >= q_th
                     else np.full(v.shape[:-1], np.inf, f32))
    t = np.min([np.max([qth(approx[..., (lane_of == r) & (j % 4 == u)]) for u in range(4)],
                       0) for r in range(lanes)], 0)
    bound = (t.astype(f64) * (1 + 2**-18) + 2**-100).astype(f32)
    cand = approx <= bound[..., None]
    idx = np.zeros((inst, n, k), np.int32)
    d2 = np.full((inst, n, k), np.inf, f32)
    sign = -1 if ties_high else 1
    n_over = 0
    for i in range(inst):
        for q in range(n):
            merged = []
            for r in range(lanes):
                mine = lane_of == r
                over = (cand[i, q] & mine).sum() > cap
                n_over += int(over)
                js = np.nonzero(mine & (j < p) & (True if over else cand[i, q]))[0]
                merged += list(js[np.lexsort((sign * js, exact[i, q, js]))][:kc])
            merged = np.array(merged, np.int64)
            top = merged[np.lexsort((sign * merged, exact[i, q, merged]))][:k]
            idx[i, q, :len(top)], d2[i, q, :len(top)] = top, exact[i, q, top]
    return idx, d2, n_over


def _tied_clouds(seed, p, n=160):
    """Instance 0 uniform in [-1, 1]^3; instance 1 on a grid of step 1/4
    (many exact ties in d2, and duplicated points); instance 2 two positions
    only, each taken by about half the points (so many ties at the bound
    that a lane of K4 may hold more than its cap of candidates); point 1 a
    copy of point 0 in all three; queries near the points."""
    rng = np.random.default_rng(seed)
    two = rng.uniform(-1, 1, (2, 3))[rng.integers(0, 2, p)]
    pts = np.stack([rng.uniform(-1, 1, (p, 3)), rng.integers(-3, 4, (p, 3)) / 4,
                    two]).astype(np.float32)
    if p > 1:
        pts[:, 1] = pts[:, 0]
    x = np.stack([pts[0, rng.integers(0, p, n)] + rng.normal(0, 0.05, (n, 3)),
                  rng.integers(-4, 5, (n, 3)) / 4,
                  two[rng.integers(0, 2, n)] + rng.normal(0, 0.5, (n, 3))]).astype(np.float32)
    return x, pts


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
@pytest.mark.parametrize("p", [5, 130, 600])
def test_k4_lanes_contract(lanes, p):
    """K4's arithmetic so transcribed equals knn_plain bitwise, indices and
    distances (exact ties and duplicated points included; slots past P hold
    (0, inf)), at its cap of 48 candidates a lane, where the two-position
    instance's ~P / 2 ties at the bound overflow a lane above 96 points a
    lane, and with every lane past a cap of 1; it agrees with npcd_tpu's
    Pallas pallas_knn_t (interpret mode) as test_knn_matches_pallas_interpret
    holds it; with ties broken toward the higher index it does not equal
    knn_plain."""
    x, pts = _tied_clouds(p, p)
    i_p, d_p = (a.numpy() for a in knn_plain(torch.from_numpy(x), torch.from_numpy(pts), K))
    for cap in (48, 1):
        i_got, d_got, n_over = _k4_sweeps(x, pts, lanes, cap)
        assert (n_over > 0) == (p > 96 * lanes if cap == 48 else True)
        np.testing.assert_array_equal(i_got, i_p)
        np.testing.assert_array_equal(d_got.view(np.int32), d_p.view(np.int32))
    with pltpu.force_tpu_interpret_mode():
        i_ref, d_ref = (np.swapaxes(np.asarray(a), 1, 2) for a in pallas_knn_t(
            jnp.asarray(np.swapaxes(x, 1, 2)), jnp.asarray(pts), K))
    np.testing.assert_allclose(d_got, d_ref, rtol=2**-13, atol=1e-7)
    assert (i_got != i_ref).mean() < 1e-3
    for cap in (48, 1):
        assert (_k4_sweeps(x, pts, lanes, cap, ties_high=True)[0] != i_p).any()

"""Kernel K6 (posenc-fused aggregation MLP + k-weighted sum) and the
aggregation around it, PyTorch port against npcd_tpu on the same numpy
inputs: the port's plain version vs the Pallas kernel in interpret mode
('anchored' posenc), positional_encoding per method, and
aggregate_features vs npcd_tpu's XLA path. Tolerance: 1e-5 abs/rel on
O(1) outputs of five f32 layers (summation order differs). torch's and
XLA's sin/cos differ by up to one ulp (6e-8), and each double-angle step
about doubles that: 'direct' 1.2e-7, 'anchored' (at most 4 steps) 2e-5,
'recurrence' (9 steps) 2e-4."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.models.pointnerf import aggregator as jax_agg
from npcd_tpu.models.pointnerf import nn_core as jax_nn
from npcd_tpu.ops.pallas.fused_mlp import fused_mlp_posenc_wsum as pallas_wsum
from npcd_tpu.utils.config import AggregatorOptions
from npcd_tpu_torch.models.pointnerf import nn_core
from npcd_tpu_torch.models.pointnerf.aggregator import aggregate_features, knn_neighbors
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import fused_mlp_posenc_wsum

TOL = dict(rtol=1e-5, atol=1e-5)
N_FREQS, K = 10, 8


def _mlp(d_in, seed=0, dims=(256, 256, 256, 256), d_out=256):
    rng = np.random.default_rng(seed)
    layers, cur = [], d_in
    for dim in dims + (d_out,):
        bound = 1 / np.sqrt(cur)
        layers.append({"w": rng.uniform(-bound, bound, (cur, dim)).astype(np.float32),
                       "b": rng.uniform(-bound, bound, dim).astype(np.float32)})
        cur = dim
    return layers


def _posenc_inputs(seed=1, b=2, f=32, n_pts=12):
    rng = np.random.default_rng(seed)
    m = n_pts * K
    feat_t = rng.normal(size=(b, f, m)).astype(np.float32)
    w = rng.uniform(size=(b, n_pts, K))
    w = (w / w.sum(-1, keepdims=True)).reshape(b, 1, m)
    pos_t = np.concatenate([rng.uniform(-0.16, 0.16, (b, 3, m)), w, np.zeros((b, 4, m))],
                           axis=1).astype(np.float32)
    return feat_t, pos_t


def test_posenc_wsum_matches_pallas_interpret():
    feat_t, pos_t = _posenc_inputs()
    layers = _mlp(32 + 3 * (1 + 2 * N_FREQS))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(pallas_wsum(
            jnp.asarray(feat_t), jnp.asarray(pos_t),
            tuple((jnp.asarray(l["w"]), jnp.asarray(l["b"])) for l in layers),
            K, N_FREQS, 1.0, True, "anchored", need_dw=False, need_dp=False))
    got = fused_mlp_posenc_wsum(
        torch.from_numpy(feat_t), torch.from_numpy(pos_t),
        [(torch.from_numpy(l["w"]), torch.from_numpy(l["b"])) for l in layers],
        K, N_FREQS, 1.0, "anchored").numpy()
    assert got.shape == (2, 12, 256)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("method,atol", [("direct", 1.2e-7), ("anchored", 2e-5),
                                         ("recurrence", 2e-4)])
def test_positional_encoding_matches_jax(method, atol):
    x = np.random.default_rng(4).uniform(-2, 2, (50, 3)).astype(np.float32)
    ref = np.asarray(jax_nn.positional_encoding(jnp.asarray(x), N_FREQS, 1.0, method=method))
    got = nn_core.positional_encoding(torch.from_numpy(x), N_FREQS, 1.0, method=method).numpy()
    assert got.shape == (50, 63)
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_aggregate_features_matches_jax_xla():
    rng = np.random.default_rng(5)
    opts = AggregatorOptions()
    f = 8
    kp_pos = rng.uniform(-0.5, 0.5, (2, 64, 3)).astype(np.float32)
    kp_feat = rng.normal(size=(2, 64, f)).astype(np.float32)
    pts = (kp_pos[:, rng.integers(0, 64, 40)]
           + rng.normal(scale=0.08, size=(2, 40, 3))).astype(np.float32)
    mask = rng.uniform(size=(2, 40)) < 0.8
    layers = _mlp(f + 3 * (1 + 2 * opts.n_freqs), seed=6)
    radius = 0.16
    feat_ref, valid_ref = jax_agg.aggregate_features(
        {"local_field": [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]},
        opts, radius, jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(kp_pos),
        jnp.asarray(kp_feat), impl="xla")
    t_pts, t_mask, t_kpp = (torch.from_numpy(a) for a in (pts, mask, kp_pos))
    feat, valid = aggregate_features(
        [{k: torch.from_numpy(v) for k, v in l.items()} for l in layers], opts,
        t_pts, t_mask, t_kpp, torch.from_numpy(kp_feat),
        knn_neighbors(t_pts, t_mask, t_kpp, opts.k, radius))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_ref))
    assert 0 < valid.numpy().mean() < 1
    np.testing.assert_allclose(feat.numpy(), np.asarray(feat_ref), **TOL)


def test_posenc_wsum_rejects_wrong_first_layer():
    feat_t, pos_t = _posenc_inputs()
    layers = _mlp(94)  # one row short of [32 feat | 63 posenc]
    with pytest.raises(ValueError):
        fused_mlp_posenc_wsum(torch.from_numpy(feat_t), torch.from_numpy(pos_t),
                              [(torch.from_numpy(l["w"]), torch.from_numpy(l["b"]))
                               for l in layers], K, N_FREQS)

"""Kernel K6b (the backward of the posenc-fused aggregation MLP with the
k-weighted sum) and the aggregator's gradients, PyTorch port against
npcd_tpu on the same numpy inputs: the port's autograd through
fused_mlp_posenc_wsum (on the CPU its backward is the plain VJP) against
the VJP of npcd_tpu's fused_mlp_posenc_wsum with need_dw=False and
need_dp=False (Pallas interpret mode, 'anchored' posenc), and
aggregate_features' gradients against jax.grad of npcd_tpu's XLA path.

Tolerances: each gradient within 1e-5 of max(1, its largest magnitude):
five f32 layers in another summation order, and dW sums over every pair;
sin/cos of the encoding differ by an ulp between torch and XLA (see
test_torch_fused_mlp.py). A pair with a hidden pre-activation within 1e-5
of 0 sits on leaky_relu's kink, where the two sides may take slopes 1 and
0.01: such pairs get weight 0 (``leaky_kinks``), so they carry no
cotangent, and the test asserts that they are few."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.models.pointnerf import aggregator as jax_agg
from npcd_tpu.ops.pallas.fused_mlp import fused_mlp_posenc_wsum as pallas_wsum
from npcd_tpu.utils.config import AggregatorOptions
from npcd_tpu_torch.models.pointnerf.aggregator import aggregate_features, knn_neighbors
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import fused_mlp_posenc_wsum, leaky_kinks

N_FREQS, K = 10, 8
MARGIN = 1e-4


def _mlp(d_in, seed=0, dims=(256, 256, 256, 256), d_out=256):
    rng = np.random.default_rng(seed)
    layers, cur = [], d_in
    for dim in dims + (d_out,):
        bound = 1 / np.sqrt(cur)
        layers.append({"w": rng.uniform(-bound, bound, (cur, dim)).astype(np.float32),
                       "b": rng.uniform(-bound, bound, dim).astype(np.float32)})
        cur = dim
    return layers


def _close(got, want, what, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    tol = rel * max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.parametrize("f,n_pts", [(32, 12), (8, 33)])
def test_wsum_vjp_matches_pallas_interpret(f, n_pts):
    rng = np.random.default_rng(f + n_pts)
    b, m = 2, n_pts * K
    feat_t = rng.normal(size=(b, f, m)).astype(np.float32)
    w = rng.uniform(size=(b, n_pts, K))
    w = (w / w.sum(-1, keepdims=True)).reshape(b, 1, m)
    pos_t = np.concatenate([rng.uniform(-0.16, 0.16, (b, 3, m)), w, np.zeros((b, 4, m))],
                           axis=1).astype(np.float32)
    layers = _mlp(f + 3 * (1 + 2 * N_FREQS), seed=f)
    g = rng.normal(size=(b, n_pts, 256)).astype(np.float32)
    kinks = leaky_kinks(torch.from_numpy(feat_t), torch.from_numpy(pos_t),
                        [(torch.from_numpy(l["w"]), torch.from_numpy(l["b"])) for l in layers],
                        N_FREQS).numpy()
    assert kinks.mean() < 0.1
    pos_t[:, 3][kinks] = 0.0

    def fn(ft, ws):
        return pallas_wsum(ft, jnp.asarray(pos_t), ws, K, N_FREQS, 1.0, True, "anchored",
                           need_dw=False, need_dp=False)

    jws = tuple((jnp.asarray(l["w"]), jnp.asarray(l["b"])) for l in layers)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(fn, jnp.asarray(feat_t), jws)
        dfeat_ref, dws_ref = vjp(jnp.asarray(g))

    ft = torch.from_numpy(feat_t).requires_grad_(True)
    pt = torch.from_numpy(pos_t).requires_grad_(True)
    tws = [(torch.from_numpy(l["w"]).requires_grad_(True),
            torch.from_numpy(l["b"]).requires_grad_(True)) for l in layers]
    got = fused_mlp_posenc_wsum(ft, pt, tws, K, N_FREQS, 1.0, "anchored")
    _close(got.detach(), out, "out")
    got.backward(torch.from_numpy(g))
    assert pt.grad is None  # x_rel and w get no gradient (need_dp=False, need_dw=False)
    _close(ft.grad, dfeat_ref, "dfeat_t")
    for i, ((tw, tb), (rw, rb)) in enumerate(zip(tws, dws_ref)):
        assert float(tw.grad.abs().max()) > 0, f"layer {i} got no gradient"
        _close(tw.grad, rw, f"dW{i}")
        _close(tb.grad, rb, f"db{i}")


def _radius_margin(pts, kp_pos, radius, k):
    """No (shading point, point) pair within MARGIN of the radius, and at most
    k points within it, so that the in-radius neighbour sets cannot differ
    between npcd_tpu's dot-form kNN and the port's direct one."""
    d2 = ((pts[:, :, None].astype(np.float64) - kp_pos[:, None].astype(np.float64)) ** 2).sum(-1)
    rel = np.abs(d2 - radius ** 2) / radius ** 2
    assert rel.min() > MARGIN, f"a pair lies {rel.min():.1e} from the radius: pick another seed"
    assert (d2 < radius ** 2).sum(-1).max() <= k


def test_aggregate_gradients_match_jax_grad_of_xla_path():
    rng = np.random.default_rng(7)
    opts = AggregatorOptions()
    f, p, n = 8, 64, 40
    kp_pos = rng.uniform(-0.5, 0.5, (2, p, 3)).astype(np.float32)
    kp_feat = rng.normal(size=(2, p, f)).astype(np.float32)
    pts = (kp_pos[:, rng.integers(0, p, n)] + rng.normal(scale=0.08, size=(2, n, 3))
           ).astype(np.float32)
    mask = rng.uniform(size=(2, n)) < 0.8
    layers = _mlp(f + 3 * (1 + 2 * opts.n_freqs), seed=8)
    radius = 0.16
    _radius_margin(pts, kp_pos, radius, opts.k)
    g = rng.normal(size=(2, n, 256)).astype(np.float32)

    def loss(kpf, params):
        feat, _ = jax_agg.aggregate_features(params, opts, radius, jnp.asarray(pts),
                                             jnp.asarray(mask), jnp.asarray(kp_pos), kpf,
                                             impl="xla")
        return jnp.sum(feat * g)

    jparams = {"local_field": [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]}
    d_kpf, d_params = jax.grad(loss, argnums=(0, 1))(jnp.asarray(kp_feat), jparams)

    tkpf = torch.from_numpy(kp_feat).requires_grad_(True)
    tkpp = torch.from_numpy(kp_pos).requires_grad_(True)
    tl = [{k: torch.from_numpy(v).requires_grad_(True) for k, v in l.items()} for l in layers]
    t_pts, t_mask = torch.from_numpy(pts), torch.from_numpy(mask)
    feat, valid = aggregate_features(tl, opts, t_pts, t_mask, tkpp, tkpf,
                                     knn_neighbors(t_pts, t_mask, tkpp, opts.k, radius))
    assert 0 < valid.float().mean() < 1
    (feat * torch.from_numpy(g)).sum().backward()
    assert tkpp.grad is None  # kp_pos is detached (detach_points=True)
    assert float(tkpf.grad.abs().max()) > 0
    _close(tkpf.grad, d_kpf, "d kp_feat")
    for i, (tw, rw) in enumerate(zip(tl, d_params["local_field"])):
        _close(tw["w"].grad, rw["w"], f"dW{i}")
        _close(tw["b"].grad, rw["b"], f"db{i}")

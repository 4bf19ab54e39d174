"""The port's CUDA and Triton kernels against their plain PyTorch versions
on the card, at small shapes chosen for the ragged edges: partial query
and key tiles, widths that are not powers of two, fewer points than k,
exact distance ties, pair counts that do not fill a block, at the
configs' k = 8 and 'anchored' posenc, the only ones the kernels build;
the training kernels: the attention backward (pad keys get exactly zero
dk and dv), the LayerNorm backward in both forms, and the AdamW + EMA pass
over a length that does not fill its last block; and stage 1's: the
minimum squared distance (bitwise equal), the aggregation MLP's backward
(through autograd, ragged tiles, more tiles than blocks, k 8, 2 and 1) and one stage-1
training step on the card against the same step on the CPU; and the bf16
kernels of the fast stage-1 config: the field heads' MLP stack forward and
backward (K7f/K7b) and the bf16 aggregation MLP (K6f/K6b), with one fast
(bf16, shading budget) step against the CPU. Imports no JAX, so it runs
where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a GPU every test skips. Tolerances: 1e-5 on O(1) values (f32 in
another summation order; sums over rows scale it by their magnitude); kNN
distances 1e-6 with indices equal except at exact ties; AdamW + EMA 1e-6 of
each buffer's scale (elementwise f32, the kernel may contract into FMAs);
the MLP backward 1e-5 of max(1, each output's largest magnitude), with the
pairs on a leaky_relu kink (a pre-activation within 1e-5 of 0, where an
ulp decides the slope) given weight 0. The bf16 kernels against their
plain versions (f32 sums in cuBLAS's order there): forward at least 99% of
elements bitwise equal and each within one bf16 ulp of itself plus one of
a quarter of the output's scale (a flipped rounding of a hidden activation
reaches outputs that cancel); backward outputs within 1e-2 of max(1, their
largest magnitude) (a flipped rounding of gd moves a product by an ulp,
2**-8). The bf16 stage-2 kernels (K1f/K1b and K2a-d in bf16) and K8f/K8b
(flash attention over [B, S, H, D], f32 and bf16, head dims 64 and 128) are
held the same way: bf16 outputs as above, and so are the bf16 dq, dk and dv
of K1b and K8b, each at its own scale (a dropped delta term moves most of
dq and dk by several ulps), f32 statistics (lse, mean, rstd)
and K8's f32 outputs within 1e-5, the LayerNorm's f32 dgamma/dbeta within
1e-4 of their scale (sums of per-row terms that each side computes from its
own forward's statistics). The bf16 K1f/K1b (tensor cores) are also held at
sequences that cut their 64-row tiles raggedly on both sides, and two of
their launches must agree bitwise; so are the bf16 K8f/K8b (tensor cores,
P and dS as bf16 hi + lo pairs), which are also held at S 1 and 513, and
the f32 K1b, K8f and K8b (tensor cores, 3xTF32), of which the f32 K1b and
K8f are also held within 1e-5 of max(1, each output's scale) of a float64
evaluation of their plain versions; so are the f32 K6f and K6b (tensor
cores, 3xTF32), whose two launches must agree bitwise too. The LayerNorm forward kernel (one warp
per row) is held at 1, 37 and 16,640 rows, on its vector and its scalar
path, and a CUDA graph of it must replay to the eager launch's bits."""
import math

import pytest
import torch

from npcd_tpu_torch.models.pointnerf.nn_core import init_mlp
from npcd_tpu_torch.ops.kernels.fused_mlp import fused_mlp, fused_mlp_bwd, fused_mlp_bwd_plain, \
    fused_mlp_plain
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import (fused_mlp_posenc_wsum,
                                                        fused_mlp_posenc_wsum_bwd,
                                                        fused_mlp_posenc_wsum_bwd_plain,
                                                        fused_mlp_posenc_wsum_plain, leaky_kinks)
from npcd_tpu_torch.ops.kernels.fused_adamw import adamw_ema, adamw_ema_plain
from npcd_tpu_torch.ops.attention import multi_head_attention
from npcd_tpu_torch.ops.kernels.flash_attention import (flash_attention, flash_attention_bwd,
                                                        flash_attention_bwd_plain,
                                                        flash_attention_fwd,
                                                        flash_attention_plain)
from npcd_tpu_torch.ops.kernels.fused_qkv_attention import (
    LOG2_E, fused_qkv_attention, fused_qkv_attention_bf16_plain, fused_qkv_attention_bwd,
    fused_qkv_attention_bwd_bf16_plain, fused_qkv_attention_bwd_plain, fused_qkv_attention_fwd,
    fused_qkv_attention_plain, split_grouped_qkv)
from npcd_tpu_torch.ops.kernels.knn import knn, knn_plain, min_d2, min_d2_plain
from npcd_tpu_torch.ops.kernels.layer_norm import (layer_norm, layer_norm_bwd,
                                                  layer_norm_bwd_plain, layer_norm_fwd,
                                                  layer_norm_fwd_plain, layer_norm_plain,
                                                  layer_norm_residual, layer_norm_residual_bwd)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("width", [1024, 1000])
def test_layer_norm_kernels(dev, width):
    g = _gen(dev)
    x, d = (torch.randn(37, width, generator=g, device=dev) for _ in range(2))
    x[-2:], d[-2:] = 0, 0  # zero pad rows stay finite: y = beta
    gamma, beta = (torch.randn(width, generator=g, device=dev) for _ in range(2))
    torch.testing.assert_close(layer_norm(x, gamma, beta), layer_norm_plain(x, gamma, beta),
                               rtol=1e-5, atol=1e-5)
    for got, want in zip(layer_norm_residual(x, d, gamma, beta),
                         layer_norm_plain(x, gamma, beta, delta=d)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups,valid", [(1, None), (2, 70), (4, 33)])
def test_fused_qkv_attention_kernel(dev, groups, valid):
    b, s, h = 3, 72, 4  # two query tiles, the second partial
    qkv = torch.randn(b * s, 3 * h * 64, generator=_gen(dev), device=dev)
    args = (qkv, h, b, s, valid, groups)
    n = valid or s
    got = fused_qkv_attention(*args).reshape(b, s, -1)[:, :n]
    want = fused_qkv_attention_plain(*args).reshape(b, s, -1)[:, :n]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups,valid", [(1, None), (2, 70), (4, 33)])
def test_fused_qkv_attention_backward_kernel(dev, groups, valid):
    b, s, h = 3, 72, 4  # two query and two key tiles, the second partial
    g = _gen(dev, 1)
    qkv = torch.randn(b * s, 3 * h * 64, generator=g, device=dev)
    dout = torch.randn(b * s, h * 64, generator=g, device=dev)
    n = valid or s
    dout.reshape(b, s, -1)[:, n:] = 0  # pad-query rows are sliced off downstream
    out, lse = fused_qkv_attention_fwd(qkv, h, b, s, n, groups)
    want_out, want_lse = fused_qkv_attention_plain(qkv, h, b, s, n, groups, return_lse=True)
    # every row, pad queries included: they feed c_proj's weight gradient
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    # each side's backward from its own forward's out and lse
    got = fused_qkv_attention_bwd(qkv, out, lse, dout, h, b, s, n, groups)
    want = fused_qkv_attention_bwd_plain(qkv, want_out, want_lse, dout, h, b, s, n, groups)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dq, dk, dv = split_grouped_qkv(got.reshape(b, s, -1), h, groups)
    assert (dq[:, n:] == 0).all() and (dk[:, n:] == 0).all() and (dv[:, n:] == 0).all()
    # through autograd: the Function's backward is the kernel
    a = qkv.clone().requires_grad_(True)
    fused_qkv_attention(a, h, b, s, n, groups).backward(dout)
    torch.testing.assert_close(a.grad, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", [1024, 1000])
@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_backward_kernels(dev, width, residual):
    g = _gen(dev, 2)
    rows = 70  # two full blocks of 32 rows and a partial one
    x, d, gy, gr = (torch.randn(rows, width, generator=g, device=dev) for _ in range(4))
    for t in (x, d, gy, gr):
        t[-2:] = 0  # zero pad rows with zero cotangents: dx exactly 0
    gamma, beta = (torch.randn(width, generator=g, device=dev) for _ in range(2))
    delta = d if residual else None
    r, _, mean, rstd = layer_norm_fwd_plain(x, gamma, beta, delta=delta)
    # the forward kernel's saved statistics, then each side's backward from
    # its own forward's r, mean and rstd
    r_k, y_k, mean_k, rstd_k = layer_norm_fwd(x, gamma, beta, delta=delta)
    for a, w in zip((r_k, y_k, mean_k, rstd_k), layer_norm_fwd_plain(x, gamma, beta,
                                                                     delta=delta)):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    if residual:
        got = layer_norm_residual_bwd(r_k, gamma, mean_k, rstd_k, gr, gy)
        want = layer_norm_bwd_plain(r, gamma, mean, rstd, gy, gr)
    else:
        got = layer_norm_bwd(x, gamma, mean_k, rstd_k, gy)
        want = layer_norm_bwd_plain(x, gamma, mean, rstd, gy)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5 * max(1.0, float(w.abs().max())))
    if not residual:
        assert (got[0][-2:] == 0).all()
    # through autograd, forward stats from the kernel
    ts = [t.clone().requires_grad_(True) for t in (x, d, gamma, beta)]
    if residual:
        torch.autograd.backward(list(layer_norm_residual(*ts)), [gr, gy])
    else:
        layer_norm(ts[0], ts[2], ts[3]).backward(gy)
    for a, w in zip([ts[0].grad, ts[2].grad, ts[3].grad], want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5 * max(1.0, float(w.abs().max())))


@pytest.mark.parametrize("n_ema,use_clip", [(0, False), (1, False), (2, True)])
def test_adamw_ema_kernel(dev, n_ema, use_clip):
    g = _gen(dev, 3)
    n = 3 * 4096 + 77  # the last block is partial
    mk = lambda scale=1.0: torch.randn(n, generator=g, device=dev) * scale
    grads, p, mu, nu = mk(0.1), mk(), mk(1e-2), mk(1e-3).abs()
    emas = torch.stack([mk() for _ in range(n_ema)]) if n_ema else None
    scalars = torch.tensor([0.41, 0.0039, 0.6, 0.9, 0.99][:3 + n_ema], device=dev)
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-3, wd=0.01, use_clip=use_clip)
    ref = [t.clone() for t in (p, mu, nu)] + [emas.clone() if n_ema else None]
    sumsq = adamw_ema(grads, p, mu, nu, emas, scalars, **kw)
    want_sumsq = adamw_ema_plain(grads, *ref, scalars, **kw)
    torch.testing.assert_close(sumsq, want_sumsq, rtol=1e-5, atol=0)
    for got, want in zip((p, mu, nu, emas), ref):
        if want is not None:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("p", [5, 130, 600])
def test_knn_kernel(dev, p):
    k = 8
    g = _gen(dev)
    pts = torch.rand(3, p, 3, generator=g, device=dev) * 2 - 1
    pts[:, 1] = pts[:, 0]  # an exact tie: the lower index first
    x = torch.rand(3, 1000, 3, generator=g, device=dev) * 2 - 1
    i_k, d_k = knn(x, pts, k)
    i_p, d_p = knn_plain(x, pts, k)
    torch.testing.assert_close(d_k, d_p, rtol=0, atol=1e-6)
    assert ((i_k == i_p) | (d_p == d_p.roll(1, -1)) | (d_p == d_p.roll(-1, -1))).all()


def _posenc_args(dev, f, n_freqs, n_pts, inst=2, k=8, seed=0):
    """(feat_t, pos_t, weights, k, n_freqs, 1.0, 'anchored') of the configs'
    256-wide five-layer MLP, x_rel within the kNN radius, weights
    normalized per point."""
    g = _gen(dev, seed)
    layers = init_mlp((256,) * 4, f + 3 * (1 + 2 * n_freqs), 256,
                      torch.Generator().manual_seed(0), dev)
    weights = [(l["w"], l["b"]) for l in layers]
    w = torch.rand(inst, n_pts, k, generator=g, device=dev)
    pos_t = torch.cat([torch.rand(inst, 3, n_pts * k, generator=g, device=dev) * 0.3 - 0.15,
                       (w / w.sum(-1, keepdim=True)).reshape(inst, 1, -1),
                       torch.zeros(inst, 4, n_pts * k, device=dev)], dim=1)
    feat_t = torch.randn(inst, f, n_pts * k, generator=g, device=dev)
    return (feat_t, pos_t, weights, k, n_freqs, 1.0, "anchored")


# 13 points x k 8 = 104 pairs: a full and a partial block of 64 (the f32
# and bf16 forwards' and the backward's); 29 points: 232 pairs, three full
# blocks and a partial one
@pytest.mark.parametrize("n_pts", [13, 29])
@pytest.mark.parametrize("f,n_freqs", [(32, 10), (8, 4), (8, 12)])
def test_fused_mlp_posenc_kernel(dev, f, n_freqs, n_pts):
    args = _posenc_args(dev, f, n_freqs, n_pts)
    torch.testing.assert_close(fused_mlp_posenc_wsum(*args), fused_mlp_posenc_wsum_plain(*args),
                               rtol=1e-5, atol=1e-5)


# k 8: 29 and 13 points are ragged blocks of 64 pairs, 5120 the render's
# shape; k 2 (32 points a block, two m16 tiles of the folded last layer)
# and k 1 (64, four tiles), with a partial block each
@pytest.mark.parametrize("f,n_freqs,n_pts,inst,k", [(32, 10, 29, 2, 8), (8, 12, 13, 3, 8),
                                                    (32, 10, 5120, 8, 8), (32, 10, 53, 2, 2),
                                                    (8, 12, 101, 2, 1)])
def test_fused_mlp_posenc_f32_forward_is_repeatable_and_exact(dev, f, n_freqs, n_pts, inst, k):
    """The f32 K6f (tensor cores, 3xTF32): two launches give bitwise equal
    outputs, within 1e-5 of max(1, the output's scale) of the plain version
    evaluated in float64 (the card's f32 tolerance, inside phases 3 and 8's
    gate of 1e-4 against the f32 plain version), at ragged shapes, at the
    render's 8 x 40,960 pairs and at every count of the folded last layer's
    m16 tiles."""
    feat_t, pos_t, weights, k, n_freqs, freq_mult, method = _posenc_args(dev, f, n_freqs,
                                                                         n_pts, inst, k)
    out0, out1 = (fused_mlp_posenc_wsum(feat_t, pos_t, weights, k, n_freqs) for _ in range(2))
    assert torch.equal(out0, out1)
    exact = fused_mlp_posenc_wsum_plain(feat_t.double(), pos_t.double(),
                                        [(w.double(), b.double()) for w, b in weights], k,
                                        n_freqs, freq_mult, method)
    _close_rel(out0.double(), exact)


def test_unsupported_shapes_raise_on_cuda(dev):
    x = torch.zeros(1, 4, 3, device=dev)
    with pytest.raises(ValueError):
        knn(x, x, 4)  # the kernel is built for k = 8
    with pytest.raises(ValueError):
        fused_qkv_attention(torch.zeros(8, 3 * 64, device=dev), 2, 1, 8)  # head dim 32
    layers = init_mlp((256,) * 4, 8 + 3 * 9, 256, torch.Generator().manual_seed(0), dev)
    with pytest.raises(ValueError):  # the kernel computes the 'anchored' posenc only
        fused_mlp_posenc_wsum(torch.zeros(1, 8, 16, device=dev), torch.zeros(1, 8, 16, device=dev),
                              [(l["w"], l["b"]) for l in layers], 8, 4, 1.0, "direct")


@pytest.mark.parametrize("n,p", [(1000, 5), (77, 130), (14336, 512)])
def test_min_d2_kernel(dev, n, p):
    g = _gen(dev, 4)
    pts = torch.rand(3, p, 3, generator=g, device=dev) - 0.5
    x = torch.rand(3, n, 3, generator=g, device=dev) * 2 - 1
    assert torch.equal(min_d2(x, pts), min_d2_plain(x, pts))


def _close_rel(got, want, rel=1e-5):
    tol = rel * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


# k 8: 104 pairs, a full and a partial tile; 5600 pairs x 3 instances, more
# tiles than blocks, so every block accumulates over several tiles; k 2 (32
# points a tile, two m16 tiles of the last layer's per-point product) and k 1
# (64, four), each with a partial tile
@pytest.mark.parametrize("n_pts,inst,k", [(13, 2, 8), (700, 3, 8), (53, 2, 2), (101, 2, 1)])
def test_fused_mlp_posenc_backward_kernel(dev, n_pts, inst, k):
    """The f32 K6b (tensor cores, 3xTF32): every output within 1e-5 of
    max(1, its scale) of the plain version evaluated in float64, two launches
    bitwise equal, and autograd's backward the kernel."""
    g = _gen(dev, 5)
    f = 32
    layers = init_mlp((256,) * 4, f + 63, 256, torch.Generator().manual_seed(0), dev)
    weights = [(l["w"], l["b"]) for l in layers]
    m = n_pts * k
    w = torch.rand(inst, n_pts, k, generator=g, device=dev)
    pos_t = torch.cat([torch.rand(inst, 3, m, generator=g, device=dev) * 0.3 - 0.15,
                       (w / w.sum(-1, keepdim=True)).reshape(inst, 1, -1),
                       torch.zeros(inst, 4, m, device=dev)], dim=1)
    feat_t = torch.randn(inst, f, m, generator=g, device=dev)
    pos_t[:, 3][leaky_kinks(feat_t, pos_t, weights, 10)] = 0.0
    gout = torch.randn(inst, n_pts, 256, generator=g, device=dev)
    df, dws = fused_mlp_posenc_wsum_bwd(feat_t, pos_t, weights, gout, k, 10)
    df_p, dws_p = fused_mlp_posenc_wsum_bwd_plain(
        feat_t.double(), pos_t.double(), [(a.double(), b.double()) for a, b in weights],
        gout.double(), k, 10)
    _close_rel(df.double(), df_p)
    for (a, b), (c, d) in zip(dws, dws_p):
        _close_rel(a.double(), c)
        _close_rel(b.double(), d)
    df1, dws1 = fused_mlp_posenc_wsum_bwd(feat_t, pos_t, weights, gout, k, 10)
    assert torch.equal(df1, df)
    for (a, b), (c, d) in zip(dws1, dws):
        assert torch.equal(a, c) and torch.equal(b, d)
    # through autograd: the Function's backward is the kernel; pos_t gets none
    ft = feat_t.clone().requires_grad_(True)
    pt = pos_t.clone().requires_grad_(True)
    ws = [(a.clone().requires_grad_(True), b.clone().requires_grad_(True)) for a, b in weights]
    launches = fused_mlp_posenc_wsum_bwd.launches
    fused_mlp_posenc_wsum(ft, pt, ws, k, 10).backward(gout)
    assert fused_mlp_posenc_wsum_bwd.launches == launches + 1 and pt.grad is None
    assert torch.equal(ft.grad, df)
    for (a, b), (c, d) in zip(ws, dws):
        assert torch.equal(a.grad, c) and torch.equal(b.grad, d)


def test_stage1_step_matches_the_cpu(dev, tmp_path):
    """One stage-1 step of the tiny config (8 objects x 32 points x 8
    features, 256-wide MLPs, 2 views of 16x16) on the card and on the CPU
    from the same weights and draws: loss within 1e-5 relative, every
    gradient leaf within 1e-3 of its scale (a pre-activation at leaky_relu's
    kink can take the other slope on the other device), parameters within
    2 lr (Adam's first step is ~lr * sign(g))."""
    import numpy as np

    from npcd_tpu_torch.data import SyntheticNPCTrain
    from npcd_tpu_torch.train import PointNeRFTraining
    from npcd_tpu_torch.utils.builders import build_pointnerf
    from npcd_tpu_torch.utils.config import load_config

    config = load_config("configs/npcd_synthetic_tiny.yaml")
    ds = SyntheticNPCTrain(**config["dataset_kwargs"])
    src = build_pointnerf(config, torch.Generator().manual_seed(0), with_tables=True)
    src.set_all_coords(ds.get_all_coords())
    with torch.no_grad():
        src.tables.feats_table.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(1))
    state = {k: v.clone() for k, v in src.state_dict().items()}
    o = src.opts
    rng = np.random.default_rng(0)
    batch = ds.batch([0, 3, 5, 6])
    draws = {"pixel_idx": rng.choice(256, o.renderer.ray_subsamples, replace=False),
             "feats_eps": rng.standard_normal((4, o.num_points, o.feat_dim), dtype=np.float32),
             "depth_jitter": rng.uniform(size=(8, o.renderer.ray_subsamples,
                                               o.renderer.depth_resolution)).astype(np.float32)}
    out = {}
    for device in ("cuda", "cpu"):
        trainer = PointNeRFTraining(str(tmp_path / device),
                                    build_pointnerf(config, with_tables=True), ds,
                                    device=device, verbose=False,
                                    **config["pointnerf_training"])
        trainer.model.load_state_dict(state)
        loss = float(trainer.train_step(batch, draws=draws)["loss"])
        named = dict(trainer.model.named_parameters())
        out[device] = (loss, {k: p.grad.cpu() for k, p in named.items()},
                       {k: p.detach().cpu() for k, p in named.items()})
    (lg, gg, pg), (lc, gc, pc) = out["cuda"], out["cpu"]
    assert abs(lg / lc - 1) <= 1e-5
    for name in gc:
        assert float(gg[name].abs().max()) > 0, name
        scale = float(gc[name].abs().max())
        assert float((gg[name] - gc[name]).abs().max()) <= 1e-3 * scale, name
        assert float((pg[name] - pc[name]).abs().max()) <= 2 * 1e-3 + 1e-6, name


def test_stage1_kernels_refuse_what_they_do_not_build(dev):
    layers = init_mlp((), 8 + 63, 256, torch.Generator().manual_seed(0), dev)
    with pytest.raises(ValueError):  # the backward kernel needs two or more layers
        fused_mlp_posenc_wsum_bwd(torch.zeros(1, 8, 16, device=dev),
                                  torch.zeros(1, 8, 16, device=dev),
                                  [(l["w"], l["b"]) for l in layers],
                                  torch.zeros(1, 2, 256, device=dev), 8, 10)
    with pytest.raises(ValueError):
        min_d2(torch.zeros(1, 4, 3, device=dev), torch.zeros(1, 5000, 3, device=dev))



def _bf16_close(got, want):
    """At least 99% bitwise equal; each element within one bf16 ulp of itself
    plus one of a quarter of the output's scale."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    assert float((d == 0).float().mean()) >= 0.99
    assert bool((d <= 2 ** -7 * (want.abs() + 0.25 * float(want.abs().max()))).all())


def _bf16_weights(dims, d_in, seed, dev):
    layers = init_mlp(dims[:-1], d_in, dims[-1], torch.Generator().manual_seed(seed), dev)
    return [(l["w"].bfloat16(), l["b"].bfloat16()) for l in layers]


@pytest.mark.parametrize("dims", [(256, 1), (256, 256, 256, 256, 3), (256, 256)])
@pytest.mark.parametrize("rows", [1000, 132 * 64 * 2 + 37])
def test_fused_mlp_kernels(dev, dims, rows):
    # a partial last tile; more tiles than the backward's blocks
    g = _gen(dev, 6)
    weights = _bf16_weights(dims, 256, 0, dev)
    x = torch.randn(rows, 256, generator=g, device=dev).bfloat16()
    _bf16_close(fused_mlp(x, weights), fused_mlp_plain(x, weights))
    gy = torch.randn(rows, dims[-1], generator=g, device=dev).bfloat16()
    dx, dws = fused_mlp_bwd(x, weights, gy)
    dx_p, dws_p = fused_mlp_bwd_plain(x, weights, gy)
    _close_rel(dx.float(), dx_p.float(), 1e-2)
    for (a, b), (c, d) in zip(dws, dws_p):
        _close_rel(a.float(), c.float(), 1e-2)
        _close_rel(b.float(), d.float(), 1e-2)
    again = fused_mlp_bwd(x, weights, gy)
    assert torch.equal(again[0], dx) and all(torch.equal(a, c) for a, c in
                                             zip(sum(again[1], ()), sum(dws, ())))
    # through autograd: the Function's backward is the kernel
    xr = x.clone().requires_grad_(True)
    ws = [(a.clone().requires_grad_(True), b.clone().requires_grad_(True)) for a, b in weights]
    launches = fused_mlp_bwd.launches
    fused_mlp(xr, ws).backward(gy)
    assert fused_mlp_bwd.launches == launches + 1 and torch.equal(xr.grad, dx)
    for (a, b), (c, d) in zip(ws, dws):
        assert torch.equal(a.grad, c) and torch.equal(b.grad, d)


@pytest.mark.parametrize("n_pts,inst", [(13, 2), (700, 3)])
def test_fused_mlp_posenc_bf16_kernels(dev, n_pts, inst):
    g = _gen(dev, 7)
    k, f = 8, 32
    weights = _bf16_weights((256,) * 5, f + 63, 0, dev)
    m = n_pts * k
    w = torch.rand(inst, n_pts, k, generator=g, device=dev)
    pos_t = torch.cat([torch.rand(inst, 3, m, generator=g, device=dev) * 0.3 - 0.15,
                       (w / w.sum(-1, keepdim=True)).reshape(inst, 1, -1),
                       torch.zeros(inst, 4, m, device=dev)], dim=1)
    feat_t = torch.randn(inst, f, m, generator=g, device=dev).bfloat16()
    pos_t[:, 3][leaky_kinks(feat_t, pos_t, weights, 10)] = 0.0
    args = (feat_t, pos_t, weights, k, 10)
    launches = fused_mlp_posenc_wsum.launches
    out = fused_mlp_posenc_wsum(*args)
    assert out.dtype == torch.bfloat16 and fused_mlp_posenc_wsum.launches == launches
    _bf16_close(out, fused_mlp_posenc_wsum_plain(*args))
    gout = torch.randn(inst, n_pts, 256, generator=g, device=dev).bfloat16()
    df, dws = fused_mlp_posenc_wsum_bwd(*args[:3], gout, k, 10)
    df_p, dws_p = fused_mlp_posenc_wsum_bwd_plain(*args[:3], gout, k, 10)
    _close_rel(df.float(), df_p.float(), 1e-2)
    for (a, b), (c, d) in zip(dws, dws_p):
        assert a.dtype == torch.bfloat16
        _close_rel(a.float(), c.float(), 1e-2)
        _close_rel(b.float(), d.float(), 1e-2)


def test_fused_mlp_refuses_what_it_does_not_build(dev):
    x = torch.zeros(70, 256, device=dev).bfloat16()
    for dims in ((128, 3), (256, 2)):  # a hidden width other than 256; an output width of 2
        with pytest.raises(ValueError):
            fused_mlp(x, _bf16_weights(dims, 256, 0, dev))
    with pytest.raises(ValueError):  # f32 input
        fused_mlp(x.float(), _bf16_weights((256, 3), 256, 0, dev))


def test_fast_stage1_step_matches_the_cpu(dev, tmp_path):
    """One stage-1 step of the tiny config with the fast config's render
    settings (bf16 compute, a shading budget below the valid count, remat
    off) on the card and on the CPU from the same weights and draws: the
    loss within 1e-3 relative, every gradient leaf within 5e-2 of its scale
    (bf16 roundings that flip on f32 sums in another order; the feats
    table's sums of bf16 per-pair gradients landed at 2.7e-2 on an H100),
    parameters within 2 lr (Adam's first step is ~lr * sign(g))."""
    import numpy as np

    from npcd_tpu_torch.data import SyntheticNPCTrain
    from npcd_tpu_torch.train import PointNeRFTraining
    from npcd_tpu_torch.utils.builders import build_pointnerf
    from npcd_tpu_torch.utils.config import load_config

    config = load_config("configs/npcd_synthetic_tiny.yaml")
    config["render_config"] = {**config["render_config"], "compute_dtype": "bfloat16",
                               "shading_budget": 48, "train_instance_chunk": 8}
    ds = SyntheticNPCTrain(**config["dataset_kwargs"])
    src = build_pointnerf(config, torch.Generator().manual_seed(0), with_tables=True)
    assert not src.cfg.resolved_train_remat()
    src.set_all_coords(ds.get_all_coords())
    with torch.no_grad():
        src.tables.feats_table.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(1))
    state = {k: v.clone() for k, v in src.state_dict().items()}
    o = src.opts
    rng = np.random.default_rng(0)
    batch = ds.batch([0, 3, 5, 6])
    draws = {"pixel_idx": rng.choice(256, o.renderer.ray_subsamples, replace=False),
             "feats_eps": rng.standard_normal((4, o.num_points, o.feat_dim), dtype=np.float32),
             "depth_jitter": rng.uniform(size=(8, o.renderer.ray_subsamples,
                                               o.renderer.depth_resolution)).astype(np.float32),
             "ray_scores": rng.uniform(size=(8, o.renderer.ray_subsamples)).astype(np.float32)}
    out = {}
    for device in ("cuda", "cpu"):
        trainer = PointNeRFTraining(str(tmp_path / device),
                                    build_pointnerf(config, with_tables=True), ds,
                                    device=device, verbose=False,
                                    **config["pointnerf_training"])
        trainer.model.load_state_dict(state)
        bf16 = (fused_mlp.launches, fused_mlp_posenc_wsum_bwd.launches_bf16)
        loss = float(trainer.train_step(batch, draws=draws)["loss"])
        if device == "cuda":  # the step went through the bf16 kernels
            assert fused_mlp.launches == bf16[0] + 2
            assert fused_mlp_posenc_wsum_bwd.launches_bf16 == bf16[1] + 1
        named = dict(trainer.model.named_parameters())
        out[device] = (loss, {k: p.grad.cpu() for k, p in named.items()},
                       {k: p.detach().cpu() for k, p in named.items()})
    (lg, gg, pg), (lc, gc, pc) = out["cuda"], out["cpu"]
    assert abs(lg / lc - 1) <= 1e-3
    for name in gc:
        assert float(gg[name].abs().max()) > 0, name
        scale = float(gc[name].abs().max())
        assert float((gg[name] - gc[name]).abs().max()) <= 5e-2 * scale, name
        assert float((pg[name] - pc[name]).abs().max()) <= 2 * 1e-3 + 1e-6, name


def _lse_bf16_close(got, want):
    """The bf16 forward's base-2 lse = m + log2(l), l the f32 sum of bf16 e:
    at least 99% of the rows within 1e-5 of it, every row within 2**-8 /
    ln 2 (an e whose rounding flips moves l by one ulp of e <= 2**-8, l >= 1)."""
    d = (got - want).abs()
    assert float((d <= 1e-5 * want.abs().clamp(min=1)).float().mean()) >= 0.99
    assert float(d.max()) <= 2 ** -8 / math.log(2)


# S 72: two query and two key tiles of 64, the second partial; S 130: three,
# the third 2 rows deep, with the valid keys ending in the first tile's first
# row (1), at its end (64) and one row into the third (129); batch 1
@pytest.mark.parametrize("b,s,groups,valid", [(3, 72, 1, None), (3, 72, 2, 70), (3, 72, 4, 33),
                                              (2, 130, 2, 1), (2, 130, 4, 64),
                                              (2, 130, 1, 129), (1, 130, 2, 129)])
def test_fused_qkv_attention_bf16_kernels(dev, b, s, groups, valid):
    h = 4
    g = _gen(dev, 8)
    qkv = (0.5 * torch.randn(b * s, 3 * h * 64, generator=g, device=dev)).bfloat16()
    dout = torch.randn(b * s, h * 64, generator=g, device=dev).bfloat16()
    n = valid or s
    dout.reshape(b, s, -1)[:, n:] = 0
    launches = fused_qkv_attention.launches_bf16
    out, lse = fused_qkv_attention_fwd(qkv, h, b, s, n, groups)
    assert out.dtype == torch.bfloat16 and fused_qkv_attention.launches_bf16 == launches + 1
    want_out, want_lse = fused_qkv_attention_bf16_plain(qkv, h, b, s, n, groups, return_lse=True)
    _bf16_close(out, want_out)
    _lse_bf16_close(lse, want_lse)
    got = fused_qkv_attention_bwd(qkv, None, lse, dout, h, b, s, n, groups)
    want = fused_qkv_attention_bwd_bf16_plain(qkv, want_lse, dout, h, b, s, n, groups)
    assert got.dtype == torch.bfloat16
    dq, dk, dv = split_grouped_qkv(got.reshape(b, s, -1), h, groups)
    for a, w in zip((dq, dk, dv), split_grouped_qkv(want.reshape(b, s, -1), h, groups)):
        _bf16_close(a, w)  # each gradient at its own scale
    assert (dq[:, n:] == 0).all() and (dk[:, n:] == 0).all() and (dv[:, n:] == 0).all()
    # through autograd: the Function's backward is the bf16 kernel
    a = qkv.clone().requires_grad_(True)
    launches = fused_qkv_attention_bwd.launches_bf16
    fused_qkv_attention(a, h, b, s, n, groups).backward(dout)
    assert fused_qkv_attention_bwd.launches_bf16 == launches + 1 and torch.equal(a.grad, got)


@pytest.mark.parametrize("b,s,h,valid", [(2, 130, 4, 129), (32, 520, 16, 513)])
def test_fused_qkv_attention_bf16_kernels_are_repeatable(dev, b, s, h, valid):
    """Two launches give bitwise equal out, lse and dqkv (no atomics, fixed
    summation orders), at a ragged shape and at the bf16 stage-2 step's."""
    g = _gen(dev, 9)
    qkv = (0.5 * torch.randn(b * s, 3 * h * 64, generator=g, device=dev)).bfloat16()
    dout = torch.randn(b * s, h * 64, generator=g, device=dev).bfloat16()
    dout.reshape(b, s, -1)[:, valid:] = 0
    (out0, lse0), (out1, lse1) = (fused_qkv_attention_fwd(qkv, h, b, s, valid, 2)
                                  for _ in range(2))
    assert torch.equal(out0, out1) and torch.equal(lse0, lse1)
    grads = [fused_qkv_attention_bwd(qkv, None, lse0, dout, h, b, s, valid, 2) for _ in range(2)]
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_bf16_kernels(dev, residual):
    g = _gen(dev, 9)
    rows, width = 70, 1024
    x, d, gy, gr = (torch.randn(rows, width, generator=g, device=dev).bfloat16()
                    for _ in range(4))
    for t in (x, d, gy, gr):
        t[-2:] = 0
    gamma, beta = 1 + 0.1 * torch.randn(width, generator=g, device=dev), \
        0.1 * torch.randn(width, generator=g, device=dev)
    delta = d if residual else None
    r_k, y_k, mean_k, rstd_k = layer_norm_fwd(x, gamma, beta, delta=delta)
    r_p, y_p, mean_p, rstd_p = layer_norm_fwd_plain(x, gamma, beta, delta=delta)
    assert y_k.dtype == r_k.dtype == torch.bfloat16 and torch.equal(r_k, r_p)
    _bf16_close(y_k, y_p)
    for a, w in ((mean_k, mean_p), (rstd_k, rstd_p)):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    wrapper = layer_norm_residual_bwd if residual else layer_norm_bwd
    launches = wrapper.launches_bf16
    if residual:
        got = layer_norm_residual_bwd(r_k, gamma, mean_k, rstd_k, gr, gy)
        want = layer_norm_bwd_plain(r_p, gamma, mean_p, rstd_p, gy, gr)
    else:
        got = layer_norm_bwd(x, gamma, mean_k, rstd_k, gy)
        want = layer_norm_bwd_plain(x, gamma, mean_p, rstd_p, gy)
    assert wrapper.launches_bf16 == launches + 1 and got[0].dtype == torch.bfloat16
    _close_rel(got[0].float(), want[0].float(), 1e-2)
    assert (got[0][-2:] == 0).all()
    for a, w in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        _close_rel(a, w, 1e-4)


# The forward kernel (csrc/layer_norm.cu, one warp per row) at one row, a
# partial block of rows and the bf16 stage-2 step's 16,640, at widths 1000
# and 1024 (both on its 16-byte vector path), f32 and bf16, with and without
# the residual; with the saved statistics (layer_norm_fwd) and without them
# (layer_norm, layer_norm_residual)
@pytest.mark.parametrize("rows", [1, 37, 16640])
@pytest.mark.parametrize("width", [1000, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_forward_kernel(dev, rows, width, dtype, residual):
    g = _gen(dev, 12)
    x, d = (torch.randn(rows, width, generator=g, device=dev).to(dtype) for _ in range(2))
    gamma, beta = 1 + 0.1 * torch.randn(width, generator=g, device=dev), \
        0.1 * torch.randn(width, generator=g, device=dev)
    delta = d if residual else None
    wrapper = layer_norm_residual if residual else layer_norm
    counter = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    launches = getattr(wrapper, counter)
    got = layer_norm_fwd(x, gamma, beta, delta=delta)
    want = layer_norm_fwd_plain(x, gamma, beta, delta=delta)
    bare = layer_norm_residual(x, d, gamma, beta) if residual else (x, layer_norm(x, gamma, beta))
    assert getattr(wrapper, counter) == launches + 2 and bare[1].dtype == got[1].dtype == dtype
    for a, w in zip(got[2:], want[2:]):  # mean, rstd
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        for a, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(got[0], want[0])  # r = bf16(x + delta)
        _bf16_close(got[1], want[1])
    # without the statistics: the same kernel, the same bits
    assert torch.equal(bare[0], got[0]) and torch.equal(bare[1], got[1])


def test_layer_norm_forward_kernel_scalar_path_and_width_limit(dev):
    """A width that is no multiple of the 16-byte vector, and a misaligned
    (contiguous) view, take the masked scalar path; a row wider than the
    kernel holds raises."""
    g = _gen(dev, 13)
    for dtype in (torch.float32, torch.bfloat16):
        gamma, beta = (torch.randn(999, generator=g, device=dev) for _ in range(2))
        x, d = (torch.randn(37, 999, generator=g, device=dev).to(dtype) for _ in range(2))
        buf = torch.randn(37 * 1024 + 1, generator=g, device=dev).to(dtype)
        xm = buf[1:].view(37, 1024)  # 4 or 2 bytes past a 16-byte boundary
        g2, b2 = (torch.randn(1024, generator=g, device=dev) for _ in range(2))
        for args, delta in (((x, gamma, beta), d), ((xm, g2, b2), xm)):
            got = layer_norm_fwd(*args, delta=delta)
            want = layer_norm_fwd_plain(*args, delta=delta)
            if dtype == torch.float32:
                for a, w in zip(got, want):
                    torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
            else:
                assert torch.equal(got[0], want[0])
                _bf16_close(got[1], want[1])
    wide = torch.zeros(2, 2049, device=dev)
    with pytest.raises(ValueError):
        layer_norm(wide, torch.ones(2049, device=dev), torch.zeros(2049, device=dev))


def test_layer_norm_residual_graph_replay_is_bitwise_eager(dev):
    """The forward launches on the current stream and allocates nothing
    itself: a CUDA graph of it replays to the eager launch's bits."""
    g = _gen(dev, 14)
    x, d = (torch.randn(1040, 1024, generator=g, device=dev) for _ in range(2))
    gamma, beta = 1 + 0.1 * torch.randn(1024, generator=g, device=dev), \
        0.1 * torch.randn(1024, generator=g, device=dev)
    r0, y0 = layer_norm_residual(x, d, gamma, beta)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        layer_norm_residual(x, d, gamma, beta)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        r1, y1 = layer_norm_residual(x, d, gamma, beta)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(r1, r0) and torch.equal(y1, y0)


# S 77: partial query and key tiles; bf16 (the tensor-core kernels, 64-row
# tiles, 32-key steps) also at S 1, 64 (one full tile), 65 (a second tile
# one row deep), 130 (three, the third 2 rows deep; batch 1 too) and 513
@pytest.mark.parametrize("dtype,b,s", [(torch.float32, 2, 77), (torch.bfloat16, 2, 77),
                                       (torch.bfloat16, 2, 1), (torch.bfloat16, 2, 64),
                                       (torch.bfloat16, 2, 65), (torch.bfloat16, 2, 130),
                                       (torch.bfloat16, 1, 130), (torch.bfloat16, 2, 513)])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_kernels(dev, dtype, b, s, d):
    g = _gen(dev, 10)
    shape = (b, s, 3, d)
    q, k, v, dout = (torch.randn(shape, generator=g, device=dev).to(dtype) for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v)
    want_out, want_lse = flash_attention_plain(q, k, v, return_lse=True)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    got = flash_attention_bwd(q, k, v, lse, dout)
    want = flash_attention_bwd_plain(q, k, v, dout)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
        for a, w in zip(got, want):
            _close_rel(a, w, 1e-5)
    else:
        _bf16_close(out, want_out)
        for a, w in zip(got, want):  # dq, dk, dv, each at its own scale
            assert a.dtype == torch.bfloat16
            _bf16_close(a, w)
    # through multi_head_attention(impl="auto") and autograd: the kernels
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    counts = (flash_attention.launches + flash_attention.launches_bf16,
              flash_attention_bwd.launches + flash_attention_bwd.launches_bf16)
    multi_head_attention(*ts, impl="auto").backward(dout)
    assert (flash_attention.launches + flash_attention.launches_bf16,
            flash_attention_bwd.launches + flash_attention_bwd.launches_bf16) == (
        counts[0] + 1, counts[1] + 1)
    for t, w in zip(ts, got):
        assert torch.equal(t.grad, w)


@pytest.mark.parametrize("b,s,h,d", [(2, 130, 3, 64), (2, 130, 3, 128), (32, 513, 16, 64),
                                     (32, 513, 8, 128)])
def test_flash_attention_bf16_kernels_are_repeatable(dev, b, s, h, d):
    """Two launches of the bf16 K8f and K8b give bitwise equal out, lse,
    dq, dk and dv (no atomics, fixed summation orders), at a ragged shape
    and at phase 15's."""
    g = _gen(dev, 11)
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
                     for _ in range(4))
    (out0, lse0), (out1, lse1) = (flash_attention_fwd(q, k, v) for _ in range(2))
    assert torch.equal(out0, out1) and torch.equal(lse0, lse1)
    grads = [flash_attention_bwd(q, k, v, lse0, dout) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*grads))


@pytest.mark.parametrize("b,s,h,d", [(2, 130, 3, 64), (2, 130, 3, 128), (32, 513, 16, 64)])
def test_flash_attention_f32_backward_is_repeatable(dev, b, s, h, d):
    """Two launches of the f32 K8b (tensor cores, 3xTF32) give bitwise
    equal dq, dk and dv (no atomics, fixed summation orders)."""
    g = _gen(dev, 15)
    q, k, v, dout = (torch.randn(b, s, h, d, generator=g, device=dev) for _ in range(4))
    _, lse = flash_attention_fwd(q, k, v)
    grads = [flash_attention_bwd(q, k, v, lse, dout) for _ in range(2)]
    assert all(torch.equal(x, y) for x, y in zip(*grads))


def test_flash_attention_refuses_other_head_dims(dev):
    x = torch.zeros(1, 8, 2, 32, device=dev)
    with pytest.raises(ValueError):
        flash_attention(x, x, x)
    with pytest.raises(NotImplementedError):  # valid_len: einsum only
        multi_head_attention(x, x, x, impl="pallas", valid_len=4)
    torch.testing.assert_close(multi_head_attention(x, x, x, impl="auto"),
                               multi_head_attention(x, x, x, impl="einsum"))


def _fqa_f64(qkv, dout, h, b, s, valid, groups):
    """dqkv in float64: the plain forward's arithmetic (base-2 scores, keys
    >= valid masked) and fused_qkv_attention_bwd_plain on float64 inputs."""
    qkv64 = qkv.double()
    q, k, v = split_grouped_qkv(qkv64.reshape(b, s, -1), h, groups)
    s2 = torch.einsum("bthc,bshc->bhts", q * (LOG2_E / 8.0), k)
    s2[..., valid:] = -torch.inf
    m = s2.amax(-1, keepdim=True)
    lse = m + torch.log2(torch.exp2(s2 - m).sum(-1, keepdim=True))
    out = torch.einsum("bhts,bshc->bthc", torch.exp2(s2 - lse), v).reshape(b * s, -1)
    return fused_qkv_attention_bwd_plain(qkv64, out, lse[..., 0], dout.double(), h, b, s, valid,
                                         groups)


@pytest.mark.parametrize("b,s,h,valid", [(2, 130, 4, 129), (32, 520, 16, 513)])
def test_fused_qkv_attention_f32_backward_is_repeatable(dev, b, s, h, valid):
    """Two launches of the f32 K1b (tensor cores, 3xTF32) give bitwise equal
    dqkv (no atomics, fixed summation orders), at a ragged shape and at the
    f32 stage-2 step's."""
    g = _gen(dev, 16)
    qkv = 0.5 * torch.randn(b * s, 3 * h * 64, generator=g, device=dev)
    dout = torch.randn(b * s, h * 64, generator=g, device=dev)
    dout.reshape(b, s, -1)[:, valid:] = 0
    out, lse = fused_qkv_attention_fwd(qkv, h, b, s, valid, 2)
    grads = [fused_qkv_attention_bwd(qkv, out, lse, dout, h, b, s, valid, 2) for _ in range(2)]
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("groups,valid", [(1, 130), (2, 129), (4, 64)])
def test_fused_qkv_attention_f32_backward_against_float64(dev, groups, valid):
    """The f32 K1b (3xTF32) from the f32 forward's out and lse: dq, dk and
    dv each within 1e-5 of max(1, its largest magnitude) of a float64
    evaluation of the plain version (the card's f32 tolerance, inside
    phase 4's gate of 1e-4)."""
    b, s, h = 2, 130, 4
    g = _gen(dev, 17)
    qkv = torch.randn(b * s, 3 * h * 64, generator=g, device=dev)
    dout = torch.randn(b * s, h * 64, generator=g, device=dev)
    dout.reshape(b, s, -1)[:, valid:] = 0
    out, lse = fused_qkv_attention_fwd(qkv, h, b, s, valid, groups)
    got = fused_qkv_attention_bwd(qkv, out, lse, dout, h, b, s, valid, groups)
    exact = _fqa_f64(qkv, dout, h, b, s, valid, groups)
    for a, e in zip(*(split_grouped_qkv(x.reshape(b, s, -1), h, groups) for x in (got, exact))):
        _close_rel(a.double(), e)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,s,h", [(2, 130, 3), (32, 513, 16)])
def test_flash_attention_f32_forward_is_repeatable_and_exact(dev, b, s, h, d):
    """Two launches of the f32 K8f (tensor cores, 3xTF32) give bitwise equal
    out and lse, each within 1e-5 of max(1, its largest magnitude) of a
    float64 evaluation of the plain version (the card's f32 tolerance,
    inside phase 15's gates of 1e-4 and 1e-5)."""
    g = _gen(dev, 18)
    q, k, v = (torch.randn(b, s, h // (d // 64), d, generator=g, device=dev) for _ in range(3))
    (out0, lse0), (out1, lse1) = (flash_attention_fwd(q, k, v) for _ in range(2))
    assert torch.equal(out0, out1) and torch.equal(lse0, lse1)
    logits = torch.einsum("bthc,bshc->bhts", q.double(), k.double()) / math.sqrt(d)
    _close_rel(out0.double(), torch.einsum("bhts,bshc->bthc", torch.softmax(logits, -1),
                                           v.double()))
    _close_rel(lse0.double(), torch.logsumexp(logits, -1))

"""The port's CUDA and Triton kernels against their plain PyTorch versions
on the card, at small shapes chosen for the ragged edges: partial query
and key tiles, widths that are not powers of two, fewer points than k,
exact distance ties, pair counts that do not fill a block, at the
configs' k = 8 and 'anchored' posenc, the only ones the kernels build;
and the training kernels: the attention backward (pad keys get exactly zero
dk and dv), the LayerNorm backward in both forms, and the AdamW + EMA pass
over a length that does not fill its last block. Imports no JAX, so it runs
where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a GPU every test skips. Tolerances: 1e-5 on O(1) values (f32 in
another summation order; sums over rows scale it by their magnitude); kNN
distances 1e-6 with indices equal except at exact ties; AdamW + EMA 1e-6 of
each buffer's scale (elementwise f32, the kernel may contract into FMAs)."""
import pytest
import torch

from npcd_tpu_torch.models.pointnerf.nn_core import init_mlp
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import (fused_mlp_posenc_wsum,
                                                        fused_mlp_posenc_wsum_plain)
from npcd_tpu_torch.ops.kernels.fused_adamw import adamw_ema, adamw_ema_plain
from npcd_tpu_torch.ops.kernels.fused_qkv_attention import (
    fused_qkv_attention, fused_qkv_attention_bwd, fused_qkv_attention_bwd_plain,
    fused_qkv_attention_fwd, fused_qkv_attention_plain, split_grouped_qkv)
from npcd_tpu_torch.ops.kernels.knn import knn, knn_plain
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


@pytest.mark.parametrize("f,n_freqs", [(32, 10), (8, 4), (8, 12)])
def test_fused_mlp_posenc_kernel(dev, f, n_freqs):
    g = _gen(dev)
    n_pts, k = 13, 8  # 104 pairs: a full and a partial block of 64
    layers = init_mlp((256,) * 4, f + 3 * (1 + 2 * n_freqs), 256,
                      torch.Generator().manual_seed(0), dev)
    weights = [(l["w"], l["b"]) for l in layers]
    w = torch.rand(2, n_pts, k, generator=g, device=dev)
    pos_t = torch.cat([torch.rand(2, 3, n_pts * k, generator=g, device=dev) * 0.3 - 0.15,
                       (w / w.sum(-1, keepdim=True)).reshape(2, 1, -1),
                       torch.zeros(2, 4, n_pts * k, device=dev)], dim=1)
    feat_t = torch.randn(2, f, n_pts * k, generator=g, device=dev)
    args = (feat_t, pos_t, weights, k, n_freqs, 1.0, "anchored")
    torch.testing.assert_close(fused_mlp_posenc_wsum(*args), fused_mlp_posenc_wsum_plain(*args),
                               rtol=1e-5, atol=1e-5)


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

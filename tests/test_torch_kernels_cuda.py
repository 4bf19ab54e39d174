"""The port's CUDA and Triton kernels against their plain PyTorch versions
on the card, at small shapes chosen for the ragged edges: partial query
and key tiles, widths that are not powers of two, fewer points than k,
exact distance ties, pair counts that do not fill a block, at the
configs' k = 8 and 'anchored' posenc, the only ones the kernels build. Imports no JAX,
so it runs where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Without a GPU every test skips. Tolerances: 1e-5 on O(1) values (f32 in
another summation order); kNN distances 1e-6 with indices equal except at
exact ties."""
import pytest
import torch

from npcd_tpu_torch.models.pointnerf.nn_core import init_mlp
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import (fused_mlp_posenc_wsum,
                                                        fused_mlp_posenc_wsum_plain)
from npcd_tpu_torch.ops.kernels.fused_qkv_attention import (fused_qkv_attention,
                                                           fused_qkv_attention_plain)
from npcd_tpu_torch.ops.kernels.knn import knn, knn_plain
from npcd_tpu_torch.ops.kernels.layer_norm import (layer_norm, layer_norm_plain,
                                                  layer_norm_residual)

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

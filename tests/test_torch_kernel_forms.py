"""The kernel forms that PointNeRF's options reach, PyTorch port against
npcd_tpu on the same numpy inputs (npcd_tpu's Pallas kernels in interpret
mode, the port's plain versions, which its CUDA wrappers take on the CPU):

  * K4 at k other than 8: the transcription of ``knn_kernel``'s sweeps at
    the list ceilings 8, 16 and 32 (``test_torch_knn._k4_sweeps``) bitwise
    ``knn_plain``'s, and both against the Pallas ``pallas_knn_t`` within
    test_torch_knn's tie tolerance (distances within 2**-13 relative,
    indices on at most 0.1% of the slots);
  * K6f/K6b with the 'direct' and 'recurrence' posenc at k 16 and 6, f32
    and bf16, against the Pallas ``fused_mlp_posenc_wsum`` and its VJP; its
    no-reduction form against the Pallas ``fused_mlp_posenc``; and the
    wrappers' run of a k that does not divide the CUDA tiles as the next
    power of 2 with zero-weight pairs;
  * K7f/K7b at an input 307 wide against the Pallas ``fused_mlp``, and the
    wrappers' zero padding of the input to a multiple of 64.

Tolerances: f32 outputs within 1e-5 of max(1, scale) for 'direct' (torch's
and XLA's sin/cos differ by an ulp) and 1e-3 for 'recurrence' (each of its
9 double-angle steps doubles that ulp: ~2e-4 in the encoding, test_torch_
fused_mlp's module doc); the bf16 forms by test_torch_fused_mlp_bf16's
rules (99% bitwise and one ulp forward, 1e-2 of max(1, scale) backward, the
pairs and rows on a leaky_relu kink, and K7's rows where the two sides' forwards
take another slope, zeroed), the JAX side compiled with
``xla_allow_excess_precision`` off."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_fused_mlp_bf16 import (_bf16, _close, _exact, _f32, _forward_close,  # noqa: E402
                                       _j, _mlp, _t)
from test_torch_knn import _k4_sweeps, _tied_clouds  # noqa: E402

from npcd_tpu.models.pointnerf import nn_core as jax_nn  # noqa: E402
from npcd_tpu.ops.pallas.fused_mlp import fused_mlp as pallas_mlp  # noqa: E402
from npcd_tpu.ops.pallas.fused_mlp import fused_mlp_posenc as pallas_posenc  # noqa: E402
from npcd_tpu.ops.pallas.fused_mlp import fused_mlp_posenc_wsum as pallas_wsum  # noqa: E402
from npcd_tpu.ops.pallas.knn import pallas_knn_t  # noqa: E402
from npcd_tpu_torch.ops.kernels import fused_mlp as k7  # noqa: E402
from npcd_tpu_torch.ops.kernels import fused_mlp_posenc as k6  # noqa: E402
from npcd_tpu_torch.ops.kernels.knn import knn, knn_plain  # noqa: E402

N_FREQS, F = 10, 32
D1 = F + 3 * (1 + 2 * N_FREQS)
REL = {"direct": 1e-5, "recurrence": 1e-3}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- K4 --------------------------------------------------------------------

@pytest.mark.parametrize("k", [6, 12, 16, 32])
@pytest.mark.parametrize("lanes", [1, 4])
def test_k4_any_k_contract(k, lanes):
    """The kernel's sweeps at k (the list of 8, 16 or 32 that holds it, the
    subsets' ceil(k/4)-th smallest as the bound) give knn_plain's indices
    and distances bitwise, exact ties and duplicated points included, at the
    kernel's cap of candidates a lane and with every lane past a cap of 1;
    with ties broken toward the higher index they do not."""
    x, pts = _tied_clouds(k, 130)
    i_p, d_p = (a.numpy() for a in knn_plain(torch.from_numpy(x), torch.from_numpy(pts), k))
    kc = next(c for c in (8, 16, 32) if k <= c)
    for cap in ({8: 48, 16: 80, 32: 144}[kc], 1):
        i_got, d_got, _ = _k4_sweeps(x, pts, lanes, cap, k=k)
        np.testing.assert_array_equal(i_got, i_p)
        np.testing.assert_array_equal(d_got.view(np.int32), d_p.view(np.int32))
    assert (_k4_sweeps(x, pts, lanes, 1, ties_high=True, k=k)[0] != i_p).any()


@pytest.mark.parametrize("k,p", [(6, 130), (16, 130), (32, 600), (16, 5)])
def test_k4_any_k_matches_pallas_interpret(k, p):
    """knn (its plain version on the CPU) against npcd_tpu's Pallas kernel
    at k; at P 5 < k the slots past P hold (0, inf)."""
    x, pts = _tied_clouds(k + p, p)
    with pltpu.force_tpu_interpret_mode():
        i_ref, d_ref = (np.swapaxes(np.asarray(a), 1, 2) for a in pallas_knn_t(
            jnp.asarray(np.swapaxes(x, 1, 2)), jnp.asarray(pts), k))
    i_got, d_got = (a.numpy() for a in knn(torch.from_numpy(x), torch.from_numpy(pts), k))
    assert i_got.shape == (3, x.shape[1], k)
    np.testing.assert_allclose(d_got, d_ref, rtol=2**-13, atol=1e-7)
    assert (i_got != i_ref).mean() < 1e-3
    if p < k:
        assert (i_got[..., p:] == 0).all() and np.isinf(d_got[..., p:]).all()


# ---- K6 --------------------------------------------------------------------

def _posenc_inputs(seed, n_pts, k, b=1, bf16=False):
    rng = np.random.default_rng(seed)
    m = n_pts * k
    feat_t = rng.normal(size=(b, F, m))
    feat_t = _bf16(feat_t) if bf16 else feat_t.astype(np.float32)
    w = rng.uniform(size=(b, n_pts, k))
    w = (w / w.sum(-1, keepdims=True)).reshape(b, 1, m)
    pos_t = np.concatenate([rng.uniform(-0.16, 0.16, (b, 3, m)), w, np.zeros((b, 4, m))],
                           axis=1).astype(np.float32)
    return feat_t, pos_t


def _f32_layers(seed):
    rng = np.random.default_rng(seed)
    layers, cur = [], D1
    for dim in (256,) * 5:
        bound = 1 / np.sqrt(cur)
        layers.append((rng.uniform(-bound, bound, (cur, dim)).astype(np.float32),
                       rng.uniform(-bound, bound, dim).astype(np.float32)))
        cur = dim
    return layers


def _rel_close(got, want, rel, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= rel * max(1.0, float(np.abs(want).max())), f"{what}: {err}"


def _vjp_pallas(kernel, feat_t, pos_t, layers, g, cast):
    def fn(ft, ws, g_):
        with pltpu.force_tpu_interpret_mode():
            out, vjp = jax.vjp(lambda a, w_: kernel(a, jnp.asarray(pos_t), w_), ft, ws)
            return out, vjp(g_)
    return _exact(fn, cast(feat_t), tuple((cast(a), cast(c)) for a, c in layers), cast(g))


@pytest.mark.parametrize("method", ["direct", "recurrence"])
@pytest.mark.parametrize("k", [16, 6])
def test_k6_methods_match_pallas_interpret(method, k):
    """f32 K6f and K6b (need_dw=False, need_dp=False) at k 16 and 6 with
    each of the two posenc methods the kernel now takes: forward and every
    gradient within REL[method] of max(1, scale); pos_t gets none."""
    n_pts = 24 if k == 6 else 8  # the w-sum kernel wants >= 8 k pairs
    feat_t, pos_t = _posenc_inputs(k, n_pts, k)
    layers = _f32_layers(k + len(method))
    tws = [(torch.from_numpy(a), torch.from_numpy(c)) for a, c in layers]
    pos_t[:, 3][k6.leaky_kinks(torch.from_numpy(feat_t), torch.from_numpy(pos_t), tws,
                               N_FREQS, method=method).numpy()] = 0.0
    g = np.random.default_rng(3).normal(size=(1, n_pts, 256)).astype(np.float32)
    kernel = lambda a, p, w: pallas_wsum(a, p, w, k, N_FREQS, 1.0, True, method,
                                         need_dw=False, need_dp=False)
    out, (dfeat, dws) = _vjp_pallas(kernel, feat_t, pos_t, layers, g, jnp.asarray)
    ft = torch.from_numpy(feat_t).requires_grad_(True)
    tws = [(a.requires_grad_(True), c.requires_grad_(True)) for a, c in tws]
    got = k6.fused_mlp_posenc_wsum(ft, torch.from_numpy(pos_t), tws, k, N_FREQS, 1.0, method)
    rel = REL[method]
    _rel_close(got.detach(), out, rel, "out")
    got.backward(torch.from_numpy(g))
    _rel_close(ft.grad, dfeat, rel, "dfeat")
    for i, ((tw, tb), (rw, rb)) in enumerate(zip(tws, dws)):
        _rel_close(tw.grad, rw, rel, f"dW{i}")
        _rel_close(tb.grad, rb, rel, f"db{i}")


@pytest.mark.parametrize("method,n_freqs", [("direct", N_FREQS), ("recurrence", 4)])
def test_k6_bf16_methods_match_pallas_interpret(method, n_freqs):
    """The bf16 K6f/K6b at k 8 with each method: forward 99% bitwise and
    within an ulp, gradients within 1e-2 of max(1, scale). 'recurrence'
    over 4 octaves: at 10 its 9 double-angle steps carry the ulp by which
    torch's and XLA's sin/cos differ to ~2e-4, which crosses a bf16
    rounding on ~9% of the outputs, so the two sides would be given other
    inputs (measured: dW1 5e-2 of its scale apart)."""
    feat_t, pos_t = _posenc_inputs(5, 16, 8, bf16=True)
    layers = _mlp((256,) * 5, F + 3 * (1 + 2 * n_freqs), seed=7)
    tws = [(_t(a), _t(c)) for a, c in layers]
    pos_t[:, 3][k6.leaky_kinks(_t(feat_t), torch.from_numpy(pos_t), tws, n_freqs,
                               method=method).numpy()] = 0.0
    g = _bf16(np.random.default_rng(4).normal(size=(1, 16, 256)))
    kernel = lambda a, p, w: pallas_wsum(a, p, w, 8, n_freqs, 1.0, True, method,
                                         need_dw=False, need_dp=False)
    out, (dfeat, dws) = _vjp_pallas(kernel, feat_t, pos_t, layers, g, _j)
    ft = _t(feat_t).requires_grad_(True)
    tws = [(a.requires_grad_(True), c.requires_grad_(True)) for a, c in tws]
    got = k6.fused_mlp_posenc_wsum(ft, torch.from_numpy(pos_t), tws, 8, n_freqs, 1.0, method)
    _forward_close(got.detach(), out, bitwise=0.99)
    got.backward(_t(g))
    _close(ft.grad, dfeat, "dfeat")
    for i, ((tw, tb), (rw, rb)) in enumerate(zip(tws, dws)):
        _close(tw.grad, rw, f"dW{i}")
        _close(tb.grad, rb, f"db{i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_no_reduction_matches_pallas_interpret(dtype):
    """The no-reduction form (npcd_tpu's fused_mlp_posenc, which the
    aggregator takes below 8 points) and its VJP, per pair; its plain
    backward is the w-sum's at k 1 with unit pair weights."""
    bf16 = dtype == "bfloat16"
    feat_t, pos_t = _posenc_inputs(6, 5, 8, bf16=bf16)
    pos_t[:, 3] = 0.0
    layers = _mlp((256,) * 5, D1, seed=8) if bf16 else _f32_layers(8)
    cast_t = _t if bf16 else torch.from_numpy
    tws = [(cast_t(a), cast_t(c)) for a, c in layers]
    kinks = k6.leaky_kinks(cast_t(feat_t), torch.from_numpy(pos_t), tws, N_FREQS,
                           method="direct").numpy()
    g = np.random.default_rng(5).normal(size=(1, 40, 256)).astype(np.float32)
    g[kinks] = 0.0
    g = _bf16(g) if bf16 else g
    kernel = lambda a, p, w: pallas_posenc(a, p, w, N_FREQS, 1.0, True, "direct")
    out, (dfeat, dws) = _vjp_pallas(kernel, feat_t, pos_t, layers, g,
                                    _j if bf16 else jnp.asarray)
    ft = cast_t(feat_t).requires_grad_(True)
    tws = [(a.requires_grad_(True), c.requires_grad_(True)) for a, c in tws]
    got = k6.fused_mlp_posenc(ft, torch.from_numpy(pos_t), tws, N_FREQS, 1.0, "direct")
    assert got.shape == (1, 40, 256) and got.dtype == ft.dtype
    got.backward(cast_t(g))
    grads = [(ft.grad, dfeat)] + [(t.grad, r) for tw, rw in zip(tws, dws)
                                  for t, r in zip(tw, rw)]
    if bf16:
        _forward_close(got.detach(), out, bitwise=0.99)
        for i, (a, b) in enumerate(grads):
            _close(a, b, f"grad {i}")
    else:
        _rel_close(got.detach(), out, 1e-5, "out")
        for i, (a, b) in enumerate(grads):
            _rel_close(a, b, 1e-5, f"grad {i}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_padded_k_is_k(dtype):
    """The CUDA wrappers run k 6 as k 8, each point's two extra pairs zero
    in feat_t and pos_t (weight 0): the w-sum and its VJP over the padded
    pairs equal those over the k pairs (the pad adds exact zeros; f32 sums
    in another association, within 1e-6 of the scale), dfeat's pad columns
    are dropped."""
    feat_t, pos_t = _posenc_inputs(9, 10, 6, b=2, bf16=dtype == torch.bfloat16)
    feat_t, pos_t = torch.from_numpy(feat_t).to(dtype), torch.from_numpy(pos_t)
    ws = [(torch.from_numpy(a).to(dtype), torch.from_numpy(c).to(dtype))
          for a, c in _f32_layers(9)]
    assert k6._kernel_k(6) == 8 and k6._kernel_k(16) == 16
    fp, pp = k6._pad_pairs(feat_t, 6, 8), k6._pad_pairs(pos_t, 6, 8)
    assert fp.shape[2] == 80 and (pp[:, 3].reshape(2, 10, 8)[..., 6:] == 0).all()
    want = k6.fused_mlp_posenc_wsum_plain(feat_t, pos_t, ws, 6, N_FREQS)
    got = k6.fused_mlp_posenc_wsum_plain(fp, pp, ws, 8, N_FREQS)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(0)).to(dtype)
    bwant = k6.fused_mlp_posenc_wsum_bwd_plain(feat_t, pos_t, ws, g, 6, N_FREQS)
    df, dws = k6.fused_mlp_posenc_wsum_bwd_plain(fp, pp, ws, g, 8, N_FREQS)
    df = df.reshape(2, F, 10, 8)[..., :6].reshape(2, F, 60)
    pairs = [(got, want), (df, bwant[0])] + [
        (a, b) for (wa, ba), (wb, bb) in zip(dws, bwant[1]) for a, b in ((wa, wb), (ba, bb))]
    for i, (a, b) in enumerate(pairs):
        rel = 1e-6 if dtype == torch.float32 else 2 ** -8
        _rel_close(a.float(), b.float(), rel, f"output {i}")


# ---- K7 --------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(256, 256, 256, 256, 3), (256, 1)])
def test_k7_wide_input_matches_pallas_interpret(dims):
    """K7f/K7b at an input 307 wide (the channel net with 8 octaves of view
    directions; npcd_tpu's kernel takes any width up to 512): forward and
    VJP against the Pallas fused_mlp; and the wrappers' zero padding to 320
    columns (x) and rows (W_0) gives the plain version's output and
    gradients, dx and dW_0 cut back to 307."""
    rng = np.random.default_rng(len(dims) + 307)
    rows, d_in = 1500, 307  # a full and a ragged block of the TPU kernel
    x = _bf16(rng.normal(size=(rows, d_in)))
    layers = _mlp(dims, d_in, seed=len(dims))
    tws = [(_t(w), _t(b)) for w, b in layers]
    g = _bf16(rng.normal(size=(rows, dims[-1])))
    # rows on a kink, and rows where the two sides' forwards take another
    # slope at a hidden unit (the stack cut after each hidden layer, npcd_tpu
    # through its XLA layers, which round as its kernel does), get no
    # cotangent: a whole row's product apart
    flips = k7.leaky_kinks_bf16(_t(x), tws).numpy()
    for cut in range(1, len(layers)):
        jz = _exact(lambda a, ls: jax_nn.apply_mlp(ls, a, compute_dtype=jnp.bfloat16,
                                                   impl="xla"),
                    _j(x), [{"w": _j(w), "b": _j(b)} for w, b in layers[:cut]])
        flips |= ((_f32(jz) > 0) != (_f32(k7.fused_mlp_plain(_t(x), tws[:cut])) > 0)).any(-1)
    assert flips.mean() < 0.05
    g[flips] = 0.0

    def fn(x_, ws, g_):
        with pltpu.force_tpu_interpret_mode():
            out, vjp = jax.vjp(lambda a, w: pallas_mlp(a, w, True), x_, ws)
            return out, vjp(g_)

    out, (dx, dws) = _exact(fn, _j(x[None]), tuple((_j(w), _j(b)) for w, b in layers),
                            _j(g[None]))
    xt = _t(x).requires_grad_(True)
    tws = [(a.requires_grad_(True), c.requires_grad_(True)) for a, c in tws]
    got = k7.fused_mlp(xt, tws)
    _forward_close(got.detach(), out[0], bitwise=0.99)
    got.backward(_t(g))
    _close(xt.grad, dx[0], "dx")
    for i, ((tw, tb), (rw, rb)) in enumerate(zip(tws, dws)):
        _close(tw.grad, rw, f"dW{i}")
        _close(tb.grad, rb, f"db{i}")

    xp, wp, d_pad = k7._padded_in(_t(x), [(a.detach(), c.detach()) for a, c in tws])
    assert d_pad == 320 and xp.shape == (rows, 320) and wp[0][0].shape == (320, 256)
    assert (xp[:, d_in:] == 0).all() and (wp[0][0][d_in:] == 0).all()
    plain = k7.fused_mlp_plain(_t(x), [(a.detach(), c.detach()) for a, c in tws])
    torch.testing.assert_close(k7.fused_mlp_plain(xp, wp), plain, rtol=0, atol=0)
    pdx, pdws = k7.fused_mlp_bwd_plain(xp, wp, _t(g))
    wdx, wdws = k7.fused_mlp_bwd_plain(_t(x), [(a.detach(), c.detach()) for a, c in tws],
                                       _t(g))
    torch.testing.assert_close(pdx[:, :d_in], wdx, rtol=0, atol=0)
    assert (pdx[:, d_in:] == 0).all()
    torch.testing.assert_close(pdws[0][0][:d_in], wdws[0][0], rtol=0, atol=0)

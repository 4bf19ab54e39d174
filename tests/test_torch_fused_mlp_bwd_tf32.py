"""Why the port's f32 aggregation-MLP backward on the tensor cores (K6b,
``tf::mlp_posenc_wsum_bwd`` in ``csrc/fused_mlp_posenc.cu``) splits every
operand of its dX, dW and dfeat products into tf32 hi + lo (3xTF32): a
transcription of its arithmetic on the CPU, held against the VJP of
npcd_tpu's Pallas ``fused_mlp_posenc_wsum`` (need_dw=False, need_dp=False)
in interpret mode (exact f32). With the lo products every output (dfeat,
each dW and db) lands within the card's f32 tolerance, 1e-5 of max(1, the
output's largest magnitude); with one tf32 product (hi only) the worst
output does not. The kernel's recompute of the hidden layers is exact f32
(here torch's f32 product). The tf32 rounding and the stepped 3xTF32
product are ``tests/test_torch_flash_attention.py``'s."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops.pallas.fused_mlp import fused_mlp_posenc_wsum as pallas_wsum
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import _layer1_input, leaky_kinks
from test_torch_flash_attention import _stepped
from test_torch_fused_mlp import _mlp, _posenc_inputs
from test_torch_fused_mlp_tf32 import STEP, _fma

TOL = 1e-5  # of max(1, each output's largest magnitude)
TILE = 64  # the kernel's pairs a block


def _leaky_grad(a):
    """leaky_relu's derivative from its output: 1 where act(z) > 0 (exactly
    where z > 0), else 0.01."""
    return torch.where(a > 0, 1.0, 0.01)


def _k6b_f32_arithmetic(feat_t, pos_t, layers, g_out, n_freqs, k, lo):
    """The f32 K6b's arithmetic on numpy feat_t [I, F, M], pos_t [I, 8, M],
    g_out [I, M // k, 256], per tile of 64 pairs: layers 0 .. L-2
    recomputed in f32; the last layer once per point,
    hw_n = sum_j w_j act_{L-2}[n k + j] (fmaf in j order), dW_L = hw^T g_out
    over the points (the kernel's batch of up to 64 points of a block's
    tiles: here, with a block for every tile, the tile's points), db_L =
    sum_n (sum_j w_j) g_out[n] (fmaf in point order),
    dh_{L-2}[r] = (w_r (g_out[r / k] W_L^T)) leaky'; layers L-2 .. 1: db_l the
    column sum of g in pair order, dW_l = act_{l-1}^T g over the pairs, dh =
    g W_l^T, g = dh leaky'; layer 0: dW_0 = h0^T g, dfeat = g W_0[:F]^T. Every
    dX, dW and dfeat product over 8-deep k-steps of three tf32 products (lo
    False: one, hi only), each step a fresh f32 sum added to the running one
    in f32; each
    tile's dW and db added to the sum of the earlier tiles in f32 (one block
    a tile, summed in block order) -> (dfeat_t [I, F, M], [(dW, db), ...])
    as numpy."""
    feat_t, pos_t, g_out = (torch.from_numpy(a) for a in (feat_t, pos_t, g_out))
    inst, f_dim, m = feat_t.shape
    ws = [(torch.from_numpy(l["w"]), torch.from_numpy(l["b"])) for l in layers]
    n = len(ws)
    h0_all = _layer1_input(feat_t, pos_t, n_freqs, 1.0, "anchored")  # [I, M, d1]
    dfeat_t = torch.zeros_like(feat_t)
    sums = [(torch.zeros_like(w), torch.zeros_like(b)) for w, b in ws]
    for i in range(inst):
        for r0 in range(0, m, TILE):
            rows = slice(r0, min(r0 + TILE, m))
            h0, w_pair = h0_all[i, rows], pos_t[i, 3, rows]
            g_pts = g_out[i, r0 // k:rows.stop // k]  # [pts, 256]
            acts = [h0]
            for w, b in ws[:-1]:
                z = acts[-1] @ w + b
                acts.append(torch.maximum(z, 0.01 * z))
            tile = []
            # the last layer once per point
            a = acts[-1].reshape(-1, k, acts[-1].shape[-1])
            wk = w_pair.reshape(-1, k, 1)
            hw = torch.zeros_like(a[:, 0])
            w_sum = torch.zeros_like(wk[:, 0])
            for j in range(k):
                hw = _fma(hw, wk[:, j], a[:, j])
                w_sum = w_sum + wk[:, j]
            db = torch.zeros_like(ws[-1][1])
            for q in range(g_pts.shape[0]):
                db = _fma(db, w_sum[q], g_pts[q])
            tile.append((_stepped(hw.T, g_pts, STEP, lo), db))
            dh = _stepped(g_pts, ws[-1][0].T, STEP, lo).repeat_interleave(k, dim=0)
            g = w_pair[:, None] * dh * _leaky_grad(acts[-1])
            for layer in range(n - 2, -1, -1):
                db = torch.zeros_like(ws[layer][1])
                for r in range(g.shape[0]):
                    db = db + g[r]
                tile.append((_stepped(acts[layer].T, g, STEP, lo), db))
                if layer:
                    g = _stepped(g, ws[layer][0].T, STEP, lo) * _leaky_grad(acts[layer])
            dfeat_t[i, :, rows] = _stepped(g, ws[0][0][:f_dim].T, STEP, lo).T
            sums = [(sw + tw, sb + tb) for (sw, sb), (tw, tb) in zip(sums, tile[::-1])]
    return dfeat_t.numpy(), [(w.numpy(), b.numpy()) for w, b in sums]


@functools.lru_cache(maxsize=None)
def _case(f, n_freqs, k):
    """Inputs (2 instances x 96 pairs, kinked pairs weighted 0, a seeded
    cotangent) and the Pallas VJP in interpret mode."""
    feat_t, pos_t = _posenc_inputs(f=f)
    layers = _mlp(f + 3 * (1 + 2 * n_freqs))
    kinks = leaky_kinks(torch.from_numpy(feat_t), torch.from_numpy(pos_t),
                        [(torch.from_numpy(l["w"]), torch.from_numpy(l["b"])) for l in layers],
                        n_freqs).numpy()
    assert kinks.mean() < 0.1
    pos_t[:, 3][kinks] = 0.0
    g_out = np.random.default_rng(f + k).normal(
        size=(feat_t.shape[0], feat_t.shape[2] // k, 256)).astype(np.float32)

    def fn(ft, ws):
        return pallas_wsum(ft, jnp.asarray(pos_t), ws, k, n_freqs, 1.0, True, "anchored",
                           need_dw=False, need_dp=False)

    jws = tuple((jnp.asarray(l["w"]), jnp.asarray(l["b"])) for l in layers)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(fn, jnp.asarray(feat_t), jws)
        dfeat, dws = vjp(jnp.asarray(g_out))
    want = [np.asarray(dfeat)] + [np.asarray(t) for wb in dws for t in wb]
    return feat_t, pos_t, layers, g_out, want


@pytest.mark.parametrize("k", [8, 2])
@pytest.mark.parametrize("f,n_freqs", [(32, 10), (8, 12)])
@pytest.mark.parametrize("lo", [True, False])
def test_k6b_f32_tf32_split_contract(f, n_freqs, lo, k):
    """At 2 instances x 96 pairs (12 points x k 8, or 48 points x k 2), the
    configs' 256-wide five-layer MLP: the f32 K6b's arithmetic so
    transcribed agrees with the VJP of npcd_tpu's Pallas
    fused_mlp_posenc_wsum (interpret mode, 'anchored') within 1e-5 of
    max(1, each output's largest magnitude) (worst output at (F, n_freqs) =
    (32, 10) and (8, 12): 4.4e-7 and 4.9e-7 at k 8, 6.2e-7 and 6.3e-7 at k
    2, measured on the CPU); with one tf32 product (hi only) the worst
    output does not (4.8e-4 and 4.5e-4; 3.1e-4 and 4.8e-4)."""
    feat_t, pos_t, layers, g_out, want = _case(f, n_freqs, k)
    dfeat, dws = _k6b_f32_arithmetic(feat_t, pos_t, layers, g_out, n_freqs, k, lo)
    got = [dfeat] + [t for wb in dws for t in wb]
    rel = max(float(np.abs(a - b).max() / max(1.0, np.abs(b).max())) for a, b in zip(got, want))
    if lo:
        assert rel <= TOL, rel
    else:
        assert rel > TOL, rel

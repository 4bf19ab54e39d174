"""The port's bf16 aggregation-MLP backward on the tensor cores (K6b bf16,
``tc::mlp_posenc_wsum_bwd`` in ``csrc/fused_mlp_posenc.cu``): a
transcription of its arithmetic on the CPU, held against ``jax.vjp`` of
npcd_tpu's Pallas ``fused_mlp_posenc_wsum`` in interpret mode (bf16 weights
and features, need_dw=False, need_dp=False, 'anchored', compiled with XLA's
excess precision off so that its bf16 casts round as the TPU kernel's do).

The transcription follows the kernel: tiles of 256 pairs taken by a grid of
3 blocks (block b takes tiles b, b + 3, ...), each product over 16-deep
k-steps (one mma.sync.m16n8k16: exact bf16 products summed into the f32
accumulator, here in float64 and rounded once a step), npcd_tpu's rounding
points (h0 in bf16; z = bf16(bf16(acc) + b), act = max(z, bf16(z
bf16(0.01))); gd = bf16(g); hw = bf16(sum_j w_j act) in j order), the dW
products over the tile's 256 pairs (the last layer's over batches of up to
256 points of a block's tiles) added into each block's f32 partial, db in
the kernel's order, and the partials summed in block order and rounded to
bf16 once. What is left against npcd_tpu is f32 sums in another order, which
flip a rare bf16 rounding (pairs on a leaky_relu kink are given weight 0,
``leaky_kinks``).

Tolerance: every output (dfeat, each dW and db) within 2**-7 of its own
largest magnitude (one bf16 ulp at the top of its range; worst measured on
the CPU: 3.1e-3 at k 8 and 5.4e-3 at k 2), dfeat at least 98% bitwise equal
[99.0%, 99.2%]. A control with one rounding point removed (z = bf16(acc +
b), the f32 sum not rounded before the bias) falls outside both (dfeat
55.4% and 53.5% bitwise, the worst output 1.2e-1 and 1.8e-1 of its scale).

The partials' layout (part_off's chunks of 64 rows, each float4 of a chunk
the accumulators of one thread, ``tc::Acc``) is copied here and held to be a
bijection onto params' layout."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops.pallas.fused_mlp import fused_mlp_posenc_wsum as pallas_wsum
from npcd_tpu_torch.ops.kernels.fused_mlp import LEAKY_BF16
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import _layer1_input, leaky_kinks
from test_torch_fused_mlp_bf16 import _bf16, _exact, _j, _mlp

F, N_FREQS, M = 32, 10, 96  # features, octaves, pairs an instance
TILE, SUB, BATCH, STEP = 256, 128, 256, 16  # the kernel's tile, sub-tile, batch, k-step
BLOCKS = 3  # the simulated grid
NT, CHUNK_ROWS, HID = 512, 64, 256  # threads; dW rows a chunk; layer width
REL, DFEAT_SHARE = 2 ** -7, 0.98


def _rnd(x):
    """f32 rounded to bf16 values."""
    return x.to(torch.bfloat16).float()


def _stepped(a, b):
    """a [M, K] . b [K, N] (bf16 values) over 16-deep k-steps (K padded with
    zeros): each step's products summed exactly, then added to the f32
    accumulator with one rounding."""
    pad = -a.shape[1] % STEP
    a = torch.nn.functional.pad(a, (0, pad)).double()
    b = torch.nn.functional.pad(b, (0, 0, 0, pad)).double()
    acc = torch.zeros(a.shape[0], b.shape[1])
    for t in range(0, a.shape[1], STEP):
        acc = (acc.double() + a[:, t:t + STEP] @ b[t:t + STEP]).float()
    return acc


def _seq_sum(rows):
    """Sum of rows [R, N] in f32, in row order."""
    s = torch.zeros(rows.shape[1])
    for r in rows:
        s = s + r
    return s


def _dx_col_sums(g):
    """A sub-tile's column sums of g [128, 256] in dx_epilogue's order: per
    warp row group of 32 rows, each lane's four rows g, g + 8, g + 16, g + 24
    in that order, then a butterfly over the 8 lanes; the 4 groups in
    order."""
    red = []
    for r0 in range(0, SUB, 32):
        x = g[r0:r0 + 32]
        s = ((x[0:8] + x[8:16]) + x[16:24]) + x[24:32]  # [8 lanes, 256]
        for step in (1, 2, 4):
            s = s + s[torch.arange(8) ^ step]
        red.append(s[0])
    return ((red[0] + red[1]) + red[2]) + red[3]


def _k6b_bf16_arithmetic(feat_t, pos_t, layers, g_out, k, exact_rounding=True):
    """The bf16 K6b's arithmetic on numpy feat_t [I, F, M] (bf16 values),
    pos_t [I, 8, M], bf16 layers [(W, b)], g_out [I, M // k, 256] (bf16
    values) -> (dfeat_t [I, F, M], [(dW, db), ...]) as numpy bf16 values.
    exact_rounding False: the control, z = bf16(acc + b)."""
    feat_t, pos_t, g_out = (torch.from_numpy(a) for a in (feat_t, pos_t, g_out))
    inst, f_dim, m = feat_t.shape
    ws = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]
    n = len(ws)
    n_pts, pts = m // k, TILE // k
    h0_all = _layer1_input(feat_t.bfloat16(), pos_t, N_FREQS, 1.0, "anchored").float()
    dfeat_t = torch.zeros(inst, f_dim, m)
    tiles = [(i, r0) for i in range(inst) for r0 in range(0, m, TILE)]
    partials = []
    for blk in range(min(BLOCKS, len(tiles))):
        dw = [torch.zeros_like(w) for w, _ in ws]
        db = [torch.zeros_like(b) for _, b in ws]
        batch_hw, batch_g = [], []

        def flush():
            hw, go = torch.cat(batch_hw), torch.cat(batch_g)
            dw[n - 1] = dw[n - 1] + _stepped(hw.T, go)
            batch_hw.clear()
            batch_g.clear()

        for i, r0 in tiles[blk::BLOCKS]:
            if sum(len(h) for h in batch_hw) + pts > BATCH:
                flush()
            r = torch.arange(r0, r0 + TILE)
            ok = r < m
            h0 = torch.where(ok[:, None], h0_all[i, r.clamp(max=m - 1)], 0.0)
            w_pair = torch.where(ok, pos_t[i, 3, r.clamp(max=m - 1)], 0.0)
            q = torch.arange(r0 // k, r0 // k + pts)
            g_pts = torch.where((q < n_pts)[:, None], g_out[i, q.clamp(max=n_pts - 1)], 0.0)
            # recompute, per sub-tile (the same in both: row-wise)
            acts = [h0]
            for w, b in ws[:-1]:
                acc = _stepped(acts[-1], w)
                z = _rnd(_rnd(acc) + b) if exact_rounding else _rnd(acc + b)
                acts.append(torch.maximum(z, _rnd(z * LEAKY_BF16)))
            # the last layer: hw and g_out to the batch; gd, db per half
            a = acts[-1].reshape(pts, k, -1)
            hw = torch.zeros(pts, a.shape[-1])
            for j in range(k):
                hw = hw + a[:, j] * w_pair.reshape(pts, k)[:, j, None]
            batch_hw.append(_rnd(hw))
            batch_g.append(g_pts)
            g = w_pair[:, None] * g_pts.repeat_interleave(k, dim=0)  # f32
            db[n - 1] = db[n - 1] + (_seq_sum(g[:SUB]) + _seq_sum(g[SUB:]))
            gd = _rnd(g)
            for l in range(n - 1, 0, -1):
                if l < n - 1:
                    dw[l] = dw[l] + _stepped(acts[l].T, gd)
                dh = _stepped(gd, ws[l][0].T)
                g = dh * torch.where(acts[l] > 0, 1.0, 0.01)
                for s in range(2):
                    db[l - 1] = db[l - 1] + _dx_col_sums(g[s * SUB:(s + 1) * SUB])
                gd = _rnd(g)
            d1 = ws[0][0].shape[0]
            dw[0] = dw[0] + _stepped(acts[0][:, :d1].T, gd)
            df = _rnd(_stepped(gd, ws[0][0][:f_dim].T))  # [TILE, F]
            dfeat_t[i, :, r0:min(r0 + TILE, m)] = df[ok].T
        if batch_hw:
            flush()
        partials.append((dw, db))
    sums = []
    for l in range(n):
        dw, db = partials[0][0][l], partials[0][1][l]
        for p in partials[1:]:
            dw, db = dw + p[0][l], db + p[1][l]
        sums.append((_rnd(dw).numpy(), _rnd(db).numpy()))
    return dfeat_t.numpy(), sums


@functools.lru_cache(maxsize=None)
def _case(k):
    """2 instances x 96 pairs (ragged tiles of 256), bf16 weights and
    features, kinked pairs weighted 0, a seeded bf16 cotangent, and the
    Pallas VJP in interpret mode."""
    rng = np.random.default_rng(k)
    n_pts = M // k
    feat_t = _bf16(rng.normal(size=(2, F, M)))
    w = rng.uniform(size=(2, n_pts, k))
    w = (w / w.sum(-1, keepdims=True)).reshape(2, 1, M)
    pos_t = np.concatenate([rng.uniform(-0.16, 0.16, (2, 3, M)), w, np.zeros((2, 4, M))],
                           axis=1).astype(np.float32)
    layers = _mlp((256,) * 5, F + 3 * (1 + 2 * N_FREQS), seed=F + k)
    kinks = leaky_kinks(torch.from_numpy(feat_t).bfloat16(), torch.from_numpy(pos_t),
                        [(torch.from_numpy(a).bfloat16(), torch.from_numpy(c).bfloat16())
                         for a, c in layers], N_FREQS).numpy()
    assert kinks.mean() < 0.2, kinks.mean()
    pos_t[:, 3][kinks] = 0.0
    g_out = _bf16(rng.normal(size=(2, n_pts, 256)))

    def fn(ft, ws, g):
        with pltpu.force_tpu_interpret_mode():
            _, vjp = jax.vjp(lambda a, w_: pallas_wsum(
                a, jnp.asarray(pos_t), w_, k, N_FREQS, 1.0, True, "anchored",
                need_dw=False, need_dp=False), ft, ws)
            return vjp(g)

    dfeat, dws = _exact(fn, _j(feat_t), tuple((_j(a), _j(c)) for a, c in layers), _j(g_out))
    want = [np.asarray(jnp.asarray(t).astype(jnp.float32))
            for t in [dfeat] + [t for wb in dws for t in wb]]
    return feat_t, pos_t, layers, g_out, want


@pytest.mark.parametrize("exact_rounding", [True, False])
@pytest.mark.parametrize("k", [8, 2])
def test_k6b_bf16_tensor_core_contract(k, exact_rounding):
    """At 2 instances x 96 pairs (12 points x k 8, or 48 x k 2), F 32, the
    configs' 95 -> 256 x 4 -> 256 MLP: the transcription of the bf16 K6b
    agrees with npcd_tpu's Pallas VJP within 2**-7 of each output's own scale
    and dfeat 98% bitwise; without the rounding of the f32 sum before the
    bias it does not."""
    feat_t, pos_t, layers, g_out, want = _case(k)
    dfeat, dws = _k6b_bf16_arithmetic(feat_t, pos_t, layers, g_out, k, exact_rounding)
    got = [dfeat] + [t for wb in dws for t in wb]
    rel = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(got, want))
    share = float((got[0] == want[0]).mean())
    if exact_rounding:
        assert rel <= REL and share >= DFEAT_SHARE, (rel, share)
    else:
        assert rel > REL and share < DFEAT_SHARE, (rel, share)


def _part_index(d1, n_layers):
    """dst[j]: where float j of a block's partial goes in params' layout (W_l
    row-major, then b_l), -1 for a chunk's rows past k_in: part_off's chunks
    of 64 rows and tc::Acc's order (float4 q = 4 i + j of thread t holds the
    accumulators acc[i][j][0..3] of warp t / 32's 32 x 32 tile)."""
    y = np.arange(CHUNK_ROWS * HID)
    q, t, e = y // (4 * NT), y // 4 % NT, y % 4
    warp, g, u = t >> 5, (t & 31) >> 2, t & 3
    row = (warp >> 3) * 32 + 16 * (q >> 2) + g + 8 * (e >> 1)
    col = (warp & 7) * 32 + 8 * (q & 3) + 2 * u + (e & 1)
    dst, w0 = [], 0
    for l in range(n_layers):
        rows = d1 if l == 0 else HID
        for c in range(-(-rows // CHUNK_ROWS)):
            r = row + CHUNK_ROWS * c
            dst.append(np.where(r < rows, w0 + r * HID + col, -1))
        dst.append(w0 + rows * HID + np.arange(HID))
        w0 += rows * HID + HID
    return np.concatenate(dst)


@pytest.mark.parametrize("d1,n_layers", [(95, 5), (71, 5), (95, 2), (256, 8)])
def test_k6b_bf16_partial_layout_is_a_bijection(d1, n_layers):
    """Every float of params' layout has exactly one place in a partial,
    whose length is part_off's: (d1 + 63) // 64 chunks of 64 x 256 and db,
    then 4 chunks and db a layer."""
    dst = _part_index(d1, n_layers)
    n_params = d1 * HID + HID + (n_layers - 1) * (HID * HID + HID)
    assert len(dst) == -(-d1 // 64) * 64 * HID + HID + (n_layers - 1) * (4 * 64 * HID + HID)
    assert np.array_equal(np.sort(dst[dst >= 0]), np.arange(n_params))

"""The port's bf16 aggregation-MLP forward on the tensor cores (K6f bf16,
``tc::mlp_posenc_wsum`` in ``csrc/fused_mlp_posenc.cu``): a transcription of
its arithmetic on the CPU, held against npcd_tpu's Pallas
``fused_mlp_posenc_wsum`` in interpret mode (bf16 weights and features,
'anchored', compiled with XLA's excess precision off so that its bf16 casts
round as the TPU kernel's do).

The transcription follows the kernel: tiles of 128 pairs (the last one
ragged: its rows past the instance's pairs are built from zero inputs with
weight 0 and never written), each layer product over 16-deep k-steps
(``_stepped`` of ``tests/test_torch_fused_mlp_bwd_bf16_tc.py``: one
mma.sync.m16n8k16 a step, its exact bf16 products summed into the f32
accumulator with one rounding), npcd_tpu's rounding points (h0 in bf16; each
hidden layer z = bf16(bf16(acc) + b), act = max(z, bf16(z bf16(0.01))); the
last layer per pair, z = bf16(bf16(acc) + b)), and the w-sum in f32 in j
order (each product, then each sum, rounded to f32), its result rounded to
bf16. What is left against npcd_tpu is f32 sums in another order, which flip
a rare bf16 rounding of a hidden activation.

Tolerance (chip_smoke.py's ``_bf16_err``, the forward's of
``tests/test_torch_fused_mlp_bf16.py``): every element within one bf16 ulp of
itself plus one of the output's largest magnitude, and at least 99% of the
elements bitwise equal. Read on the CPU at k 8 and k 2: 99.44% and 99.30%
bitwise, the worst element at 0.21 and 0.36 of its bound. Two controls fall
outside it, by their bitwise share: the first rounding point dropped in
every layer (z = bf16(acc + b)), 67.6% and 56.1% bitwise (the worst element
at 0.35 and 0.54 of its bound); and the last layer folded after the w-sum
as the f32 forward folds it (out = bf16(bf16(sum_j w_j act_j) W + b sum_j
w_j), which skips the per-pair rounding of z), 70.8% and 63.7% bitwise
(0.35 and 0.41)."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops.pallas.fused_mlp import fused_mlp_posenc_wsum as pallas_wsum
from npcd_tpu_torch.ops.kernels.fused_mlp import LEAKY_BF16
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import _layer1_input
from test_torch_fused_mlp_bf16 import _bf16, _exact, _j, _mlp
from test_torch_fused_mlp_bwd_bf16_tc import _rnd, _stepped

F, N_FREQS, M = 32, 10, 192  # features, octaves, pairs an instance: a full tile and a ragged one
SUB = 128  # the kernel's tile of pairs
SHARE = 0.99


def _k6f_bf16_arithmetic(feat_t, pos_t, layers, k, variant="kernel"):
    """The bf16 K6f's arithmetic on numpy feat_t [I, F, M] (bf16 values),
    pos_t [I, 8, M], bf16 layers [(W, b)] -> [I, M // k, 256] as numpy bf16
    values. variant 'unrounded': z = bf16(acc + b) in every layer; 'folded':
    the last layer after the w-sum."""
    feat_t, pos_t = torch.from_numpy(feat_t), torch.from_numpy(pos_t)
    inst, _, m = feat_t.shape
    ws = [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in layers]
    pad = -m % SUB  # the ragged tile's rows past m: zero inputs, weight 0
    feat_p = torch.nn.functional.pad(feat_t, (0, pad))
    pos_p = torch.nn.functional.pad(pos_t, (0, pad))
    h0 = _layer1_input(feat_p.bfloat16(), pos_p, N_FREQS, 1.0, "anchored").float()

    def layer(h, w, b):
        acc = _stepped(h, w)
        return _rnd(acc + b) if variant == "unrounded" else _rnd(_rnd(acc) + b)

    n_pts, pts = m // k, SUB // k
    out = torch.zeros(inst, n_pts, ws[-1][0].shape[1])
    for i in range(inst):
        for r0 in range(0, m, SUB):
            h = h0[i, r0:r0 + SUB]
            for w, b in ws[:-1]:
                z = layer(h, w, b)
                h = torch.maximum(z, _rnd(z * LEAKY_BF16))
            w_pair = pos_p[i, 3, r0:r0 + SUB].reshape(pts, k)
            w_last, b_last = ws[-1]
            if variant == "folded":
                hw, w_sum = torch.zeros(pts, h.shape[1]), torch.zeros(pts)
                for j in range(k):
                    hw = hw + h.reshape(pts, k, -1)[:, j] * w_pair[:, j, None]
                    w_sum = w_sum + w_pair[:, j]
                o = _rnd(_stepped(_rnd(hw), w_last) + b_last * w_sum[:, None])
            else:
                z = layer(h, w_last, b_last).reshape(pts, k, -1)
                s = torch.zeros(pts, z.shape[-1])
                for j in range(k):
                    s = s + z[:, j] * w_pair[:, j, None]
                o = _rnd(s)
            q0 = r0 // k
            out[i, q0:min(q0 + pts, n_pts)] = o[:n_pts - q0]
    return out.numpy()


@functools.lru_cache(maxsize=None)
def _case(k):
    """2 instances x 192 pairs (a full tile and a ragged one), bf16 weights
    and features, and npcd_tpu's Pallas forward in interpret mode."""
    rng = np.random.default_rng(100 + k)
    n_pts = M // k
    feat_t = _bf16(rng.normal(size=(2, F, M)))
    w = rng.uniform(size=(2, n_pts, k))
    w = (w / w.sum(-1, keepdims=True)).reshape(2, 1, M)
    pos_t = np.concatenate([rng.uniform(-0.16, 0.16, (2, 3, M)), w, np.zeros((2, 4, M))],
                           axis=1).astype(np.float32)
    layers = _mlp((256,) * 5, F + 3 * (1 + 2 * N_FREQS), seed=F + k)

    def fn(ft, ws):
        with pltpu.force_tpu_interpret_mode():
            return pallas_wsum(ft, jnp.asarray(pos_t), ws, k, N_FREQS, 1.0, True, "anchored",
                               need_dw=False, need_dp=False)

    want = _exact(fn, _j(feat_t), tuple((_j(a), _j(c)) for a, c in layers))
    return feat_t, pos_t, layers, np.asarray(jnp.asarray(want).astype(jnp.float32))


@pytest.mark.parametrize("variant", ["kernel", "unrounded", "folded"])
@pytest.mark.parametrize("k", [8, 2])
def test_k6f_bf16_tensor_core_contract(k, variant):
    """At 2 instances x 192 pairs (24 points x k 8, or 96 x k 2), F 32, the
    configs' 95 -> 256 x 4 -> 256 MLP: the transcription of the bf16 K6f
    agrees with npcd_tpu's Pallas forward within one bf16 ulp of each element
    plus one of the output's scale and 99% bitwise; without the rounding of
    the f32 sum before the bias, or with the last layer folded after the
    w-sum, it does not."""
    feat_t, pos_t, layers, want = _case(k)
    got = _k6f_bf16_arithmetic(feat_t, pos_t, layers, k, variant)
    assert got.shape == want.shape == (2, M // k, 256)
    d = np.abs(got - want)
    share = float((d == 0).mean())
    over = float((d / (2 ** -7 * (np.abs(want) + np.abs(want).max()))).max())
    if variant == "kernel":
        assert share >= SHARE and over <= 1, (share, over)
    else:
        assert share < SHARE or over > 1, (share, over)

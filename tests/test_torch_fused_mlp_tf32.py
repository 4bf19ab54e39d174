"""Why the port's f32 aggregation-MLP forward on the tensor cores (K6f,
``tf::mlp_posenc_wsum`` in ``csrc/fused_mlp_posenc.cu``) splits every
operand into tf32 hi + lo (3xTF32): a transcription of its arithmetic on
the CPU, held against npcd_tpu's Pallas ``fused_mlp_posenc_wsum`` in
interpret mode (exact f32). With the lo products it lands within the card's
f32 tolerance, 1e-5 of max(1, the output's largest magnitude); with one
tf32 product (hi only) it does not. The tf32 rounding and the stepped
3xTF32 product are ``tests/test_torch_flash_attention.py``'s."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops.pallas.fused_mlp import fused_mlp_posenc_wsum as pallas_wsum
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import _layer1_input
from test_torch_flash_attention import _stepped
from test_torch_fused_mlp import _mlp, _posenc_inputs

TOL = 1e-5  # of max(1, the output's largest magnitude)
STEP = 8  # the k-step of mma.sync.m16n8k8: one fresh f32 fragment each


def _fma(s, w, h):
    """fmaf(w, h, s) in f32: the product is exact in float64, one rounding."""
    return (s.double() + w.double() * h.double()).float()


def _k6f_f32_arithmetic(feat_t, pos_t, layers, n_freqs, k, lo):
    """The f32 K6f's arithmetic on numpy feat_t [I, F, M], pos_t [I, 8, M]:
    layer 1's input [feat | x | anchored posenc] in f32; each hidden layer
    z = h W + b over 8-deep k-steps, each step's three tf32 products (lo
    False: one, hi only) a fresh f32 sum added to the running one in f32,
    then leaky_relu(0.01) in f32; the last layer folded after the w-sum:
    s_n = sum_j w_j h_j (fmaf in j order), out_n = s_n W + b sum_j w_j ->
    [I, M // k, 256] as numpy."""
    feat_t, pos_t = torch.from_numpy(feat_t), torch.from_numpy(pos_t)
    inst, _, m = feat_t.shape
    h = _layer1_input(feat_t, pos_t, n_freqs, 1.0, "anchored")  # [I, M, d1]
    ws = [(torch.from_numpy(l["w"]), torch.from_numpy(l["b"])) for l in layers]
    for w, b in ws[:-1]:
        z = _stepped(h, w, STEP, lo) + b
        h = torch.maximum(z, 0.01 * z)
    h = h.reshape(inst, m // k, k, -1)
    w_pair = pos_t[:, 3].reshape(inst, m // k, k, 1)
    s = torch.zeros_like(h[:, :, 0])
    w_sum = torch.zeros_like(w_pair[:, :, 0])
    for j in range(k):
        s = _fma(s, w_pair[:, :, j], h[:, :, j])
        w_sum = w_sum + w_pair[:, :, j]
    w_last, b_last = ws[-1]
    return (_stepped(s, w_last, STEP, lo) + b_last * w_sum).numpy()


@pytest.mark.parametrize("k", [8, 2])
@pytest.mark.parametrize("f,n_freqs", [(32, 10), (8, 12)])
@pytest.mark.parametrize("lo", [True, False])
def test_k6f_f32_tf32_split_contract(f, n_freqs, lo, k):
    """At 2 instances x 96 pairs (12 points x k 8, or 48 points x k 2), the
    configs' 256-wide five-layer MLP: the f32 K6f's arithmetic so
    transcribed agrees with npcd_tpu's Pallas fused_mlp_posenc_wsum
    (interpret mode, 'anchored') within 1e-5 of max(1, the output's largest
    magnitude) (at (F, n_freqs) = (32, 10) and (8, 12), 2.8e-8 and 3.7e-8
    at k 8, 2.8e-8 and 2.2e-8 at k 2, measured on the CPU); with one tf32 product
    (hi only) it does not (2.6e-5 and 2.3e-5; 1.1e-5 and 1.4e-5)."""
    feat_t, pos_t = _posenc_inputs(f=f)
    layers = _mlp(f + 3 * (1 + 2 * n_freqs))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_wsum(
            jnp.asarray(feat_t), jnp.asarray(pos_t),
            tuple((jnp.asarray(l["w"]), jnp.asarray(l["b"])) for l in layers),
            k, n_freqs, 1.0, True, "anchored", need_dw=False, need_dp=False))
    got = _k6f_f32_arithmetic(feat_t, pos_t, layers, n_freqs, k, lo)
    rel = float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))
    if lo:
        assert rel <= TOL, rel
    else:
        assert rel > TOL, rel

"""Kernel K1b (fused-qkv attention backward) of the PyTorch port against
npcd_tpu: dqkv of the port's autograd path on the CPU (its plain forward
with the base-2 LSE, then its plain backward) vs jax.vjp of the Pallas
fused_qkv_attention_2d in interpret mode, on the same numpy qkv and
cotangent, with G in {1, 2}, pad keys (valid_len < seq) and a cotangent
that is zero on pad-query rows, as in the denoiser. The pad-key rows of dk
and dv must be exactly 0. Tolerance: 1e-5 abs/rel (f32 softmax
recomputed from the LSE; the two sides sum in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops.pallas.fused_qkv_attention import fused_qkv_attention_2d
from npcd_tpu_torch.ops.attention import split_grouped_qkv
from npcd_tpu_torch.ops.kernels.fused_qkv_attention import (fused_qkv_attention,
                                                           fused_qkv_attention_bwd,
                                                           fused_qkv_attention_plain,
                                                           merge_grouped_qkv)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, H, D, VALID = 2, 24, 4, 64, 21


def _inputs(seed):
    rng = np.random.default_rng(seed)
    qkv = (0.5 * rng.normal(size=(B * S, 3 * H * D))).astype(np.float32)
    ct = rng.normal(size=(B, S, H * D)).astype(np.float32)
    ct[:, VALID:] = 0.0  # pad-query rows are sliced off downstream
    return qkv, ct.reshape(B * S, H * D)


@pytest.mark.parametrize("groups", [1, 2])
def test_attention_backward_matches_pallas_interpret(groups):
    qkv, ct = _inputs(seed=groups)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a: fused_qkv_attention_2d(a, H, B, S, VALID, groups),
                         jnp.asarray(qkv))
        ref = np.asarray(vjp(jnp.asarray(ct))[0])
    t = torch.tensor(qkv, requires_grad=True)
    out = fused_qkv_attention(t, H, B, S, VALID, groups)
    out.backward(torch.from_numpy(ct))
    got = t.grad.numpy()
    assert np.abs(ref).max() > 1e-2  # the comparison is not of zeros
    np.testing.assert_allclose(got, ref, **TOL)
    _, dk, dv = split_grouped_qkv(t.grad.reshape(B, S, -1), H, groups)
    assert (dk[:, VALID:] == 0).all() and (dv[:, VALID:] == 0).all()
    dq, _, _ = split_grouped_qkv(t.grad.reshape(B, S, -1), H, groups)
    assert (dq[:, VALID:] == 0).all()  # zero cotangent rows


def test_attention_backward_full_sequence():
    """valid_len = seq: no masked keys."""
    qkv, ct = _inputs(seed=5)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a: fused_qkv_attention_2d(a, H, B, S, None, 2),
                         jnp.asarray(qkv))
        ref = np.asarray(vjp(jnp.asarray(ct))[0])
    t = torch.tensor(qkv, requires_grad=True)
    fused_qkv_attention(t, H, B, S, None, 2).backward(torch.from_numpy(ct))
    np.testing.assert_allclose(t.grad.numpy(), ref, **TOL)


def test_attention_bwd_plain_matches_autograd_of_forward():
    """The plain backward (recompute from the LSE, delta = rowsum(dO * O))
    equals autograd through the plain forward, pad-query cotangents nonzero."""
    rng = np.random.default_rng(9)
    qkv = torch.tensor(0.5 * rng.normal(size=(B * S, 3 * H * D)), dtype=torch.float32)
    ct = torch.tensor(rng.normal(size=(B * S, H * D)), dtype=torch.float32)
    out, lse = fused_qkv_attention_plain(qkv, H, B, S, VALID, 2, return_lse=True)
    got = fused_qkv_attention_bwd(qkv, out, lse, ct, H, B, S, VALID, 2)
    a = qkv.clone().requires_grad_(True)
    fused_qkv_attention_plain(a, H, B, S, VALID, 2).backward(ct)
    np.testing.assert_allclose(got.numpy(), a.grad.numpy(), **TOL)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_merge_grouped_qkv_inverts_split(groups):
    x = torch.arange(3 * 2 * 3 * H * 8, dtype=torch.float32).reshape(3, 2, 3 * H * 8)
    assert torch.equal(merge_grouped_qkv(*split_grouped_qkv(x, H, groups), groups), x)

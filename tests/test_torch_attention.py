"""Kernel K1 (fused-qkv attention) of the PyTorch port against npcd_tpu:
the port's CPU path (its plain version) vs fused_qkv_attention_tokens'
einsum path and vs the Pallas kernel in interpret mode, with the grouped
[Q|K|V] layout at G = 2 (4 heads x D 64) and pad keys (valid_len < seq).
Pad-query rows are unspecified and not compared. Tolerance: 1e-5 abs/rel
(f32 softmax; the Pallas kernel works in base 2)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops import attention as jax_attention
from npcd_tpu.ops.pallas.fused_qkv_attention import fused_qkv_attention_2d
from npcd_tpu_torch.ops.attention import default_qkv_groups, split_grouped_qkv
from npcd_tpu_torch.ops.kernels.fused_qkv_attention import fused_qkv_attention

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, H, D, G, VALID = 2, 24, 4, 64, 2, 21


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.normal(size=(B * S, 3 * H * D))).astype(np.float32)


def _port(qkv):
    return fused_qkv_attention(torch.from_numpy(qkv), H, B, S, VALID, G).numpy()


def _valid_rows(a):
    return a.reshape(B, S, -1)[:, :VALID]


def test_attention_matches_jax_einsum():
    qkv = _qkv()
    ref = jax_attention.fused_qkv_attention_tokens(
        jnp.asarray(qkv), H, batch=B, seq=S, impl="einsum", valid_len=VALID, groups=G)
    np.testing.assert_allclose(_valid_rows(_port(qkv)), _valid_rows(np.asarray(ref)), **TOL)


def test_attention_matches_pallas_interpret():
    qkv = _qkv(seed=1)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fused_qkv_attention_2d(jnp.asarray(qkv), H, B, S, VALID, G))
    np.testing.assert_allclose(_valid_rows(_port(qkv)), _valid_rows(ref), **TOL)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_split_grouped_qkv_matches_jax(groups):
    x = np.arange(3 * 2 * 3 * H * 8, dtype=np.float32).reshape(3, 2, 3 * H * 8)
    ref = jax_attention.split_grouped_qkv(jnp.asarray(x), H, groups)
    got = split_grouped_qkv(torch.from_numpy(x), H, groups)
    for r, o in zip(ref, got):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


@pytest.mark.parametrize("heads,d", [(16, 64), (4, 64), (2, 16), (8, 128), (12, 64)])
def test_default_qkv_groups_matches_jax(heads, d):
    # the bridged c_qkv columns are in npcd_tpu's order for this G
    assert default_qkv_groups(heads, d) == jax_attention.default_qkv_groups(heads, d)

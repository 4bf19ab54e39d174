"""Kernel K1 (fused-qkv attention) in bf16, PyTorch port against npcd_tpu:
the port's autograd path on the CPU (its bf16 plain forward with the base-2
LSE, then its bf16 plain backward) vs jax.vjp of the Pallas
fused_qkv_attention_2d in interpret mode on bf16 inputs, on the same numpy
qkv and cotangent, with the grouped layout at G = 2 (4 heads x D 64), pad
keys (valid_len < seq) and a cotangent that is zero on pad-query rows, as
in the denoiser. The JAX side is compiled with ``xla_allow_excess_precision``
off, so that its bf16 casts round as the TPU kernel's do.

Tolerances (the worst values measured on this CPU are in brackets); the two
sides sum in another f32 order, so a bf16 rounding may flip:
  * output (valid rows): at least 99% of the elements bitwise equal [100%],
    each within one bf16 ulp of itself [0];
  * lse: 1e-5 relative [1.2e-7];
  * dqkv: at least 99% bitwise equal [100%], every element within 1e-2 of
    the largest magnitude [0]; the pad-key rows of dk and dv and the
    pad-query rows of dq exactly 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops.pallas.fused_qkv_attention import _fwd_impl, fused_qkv_attention_2d
from npcd_tpu_torch.ops.attention import split_grouped_qkv
from npcd_tpu_torch.ops.kernels.fused_qkv_attention import (
    _c2, fused_qkv_attention, fused_qkv_attention_bf16_plain, fused_qkv_attention_bwd)

B, S, H, D, G, VALID = 2, 24, 4, 64, 2, 21


def _exact(fn, *args):
    """fn(*args) jitted with XLA's excess precision off, Pallas in interpret
    mode."""
    with pltpu.force_tpu_interpret_mode():
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)


def _bf16(a):
    return np.array(jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    qkv = _bf16(rng.normal(size=(B * S, 3 * H * D)))
    ct = rng.normal(size=(B, S, H * D))
    ct[:, VALID:] = 0.0
    return qkv, _bf16(ct.reshape(B * S, H * D))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if isinstance(a, jax.Array) \
        else a.float().numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_attention_matches_pallas_interpret(seed):
    qkv, ct = _inputs(seed)

    def fn(a, g):
        out, vjp = jax.vjp(lambda x: fused_qkv_attention_2d(x, H, B, S, VALID, G), a)
        return out, vjp(g)[0], _fwd_impl(a, H, B, S, VALID, G)[1]

    out, dqkv, lse = _exact(fn, jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(ct, jnp.bfloat16))
    t = torch.from_numpy(qkv).to(torch.bfloat16).requires_grad_(True)
    got = fused_qkv_attention(t, H, B, S, VALID, G)
    assert got.dtype == torch.bfloat16
    got.backward(torch.from_numpy(ct).to(torch.bfloat16))

    o_got, o_want = (_f32(a).reshape(B, S, -1)[:, :VALID] for a in (got.detach(), out))
    d = np.abs(o_got - o_want)
    assert (d == 0).mean() >= 0.99, (d == 0).mean()
    assert (d <= 2 ** -8 * np.abs(o_want)).all(), d.max()

    # lse [B, programs, S, heads per program] -> [B, H, S]
    want_lse = np.asarray(lse).transpose(0, 1, 3, 2).reshape(B, H, S)
    _, got_lse = fused_qkv_attention_bf16_plain(t.detach(), H, B, S, VALID, G, return_lse=True)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-5)

    g_got, g_want = _f32(t.grad), _f32(dqkv)
    d = np.abs(g_got - g_want)
    assert np.abs(g_want).max() > 1e-2
    assert (d == 0).mean() >= 0.99, (d == 0).mean()
    assert d.max() <= 1e-2 * np.abs(g_want).max(), d.max() / np.abs(g_want).max()
    dq, dk, dv = split_grouped_qkv(t.grad.reshape(B, S, -1), H, G)
    assert (dq[:, VALID:] == 0).all() and (dk[:, VALID:] == 0).all() \
        and (dv[:, VALID:] == 0).all()


def test_bf16_query_scale_is_the_bf16_constant():
    """c2 = bf16(log2(e) / 8), as the TPU kernel's jnp.asarray(..., bf16)."""
    want = float(np.asarray(jnp.asarray(1.4426950408889634 / 8, jnp.bfloat16)
                            .astype(jnp.float32)))
    assert _c2(64) == want and _c2(64) != 1.4426950408889634 / 8


def test_bf16_backward_reads_no_output():
    """The bf16 backward takes delta = rowsum(p * dp): out may be None, and
    the f32 backward still needs it."""
    qkv, ct = _inputs(3)
    t = torch.from_numpy(qkv).to(torch.bfloat16)
    _, lse = fused_qkv_attention_bf16_plain(t, H, B, S, VALID, G, return_lse=True)
    g = torch.from_numpy(ct).to(torch.bfloat16)
    assert fused_qkv_attention_bwd(t, None, lse, g, H, B, S, VALID, G).dtype == torch.bfloat16
    with pytest.raises(ValueError):
        fused_qkv_attention_bwd(t.float(), None, lse, g.float(), H, B, S, VALID, G)

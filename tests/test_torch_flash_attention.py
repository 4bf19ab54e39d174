"""ops.attention of the PyTorch port against npcd_tpu/ops/attention.py:
``multi_head_attention`` over [B, S, H, D] with impl "pallas" (the port's
kernel K8 on its plain version here, npcd_tpu's Pallas flash_attention in
interpret mode), "einsum", "auto" (einsum on the CPU on both sides) and
"xla" (the library path on both sides), forward and dq/dk/dv, at S = 9, so
that the TPU kernel's padding to 128 keys and its masks are exercised, and
D 64; the einsum path with valid_len; and the port's one attention over
the fused qkv, kernel K1 (re-exported as ``ops.attention.
fused_qkv_attention``), against each impl of npcd_tpu's 3D dispatch. Same
numpy inputs and cotangents on both sides.

Tolerances: f32 at 1e-5 abs/rel (another summation order; K8's softmax in
f32). bf16 (the JAX side compiled with ``xla_allow_excess_precision`` off;
the worst values measured on this CPU in brackets): outputs at least 95% of
the elements bitwise equal [pallas 100%, einsum 100%] and each within one
bf16 ulp of itself plus 2**-8 of the output's largest magnitude [pallas 0,
einsum 0]; gradients within 1e-2 of their largest magnitude [pallas 8.2e-5
(dk, 99.96% bitwise), einsum 0]."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops import attention as jax_attention
from npcd_tpu_torch.ops.attention import fused_qkv_attention, multi_head_attention
from npcd_tpu_torch.ops.kernels.flash_attention import flash_attention

B, S, H, D = 2, 9, 2, 64
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(B, S, H, D)).astype(np.float32) for _ in range(4))
    if dtype == "bf16":
        q, k, v, g = (np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                      for a in (q, k, v, g))
    return q, k, v, g


def _jax(impl, q, k, v, g, dtype, valid_len=None):
    """npcd_tpu's forward and (dq, dk, dv), Pallas in interpret mode."""
    def fn(q, k, v, g):
        out, vjp = jax.vjp(lambda a, b, c: jax_attention.multi_head_attention(
            a, b, c, impl=impl, valid_len=valid_len), q, k, v)
        return out, vjp(g)

    args = [jnp.asarray(a, dtype) for a in (q, k, v, g)]
    with pltpu.force_tpu_interpret_mode():
        out, grads = jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    return f32(out), [f32(x) for x in grads]


def _port(impl, q, k, v, g, dtype, valid_len=None):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    out = multi_head_attention(*ts, impl=impl, valid_len=valid_len)
    assert out.dtype == dtype
    out.backward(torch.from_numpy(g).to(dtype))
    return out.detach().float().numpy(), [t.grad.float().numpy() for t in ts]


@pytest.mark.parametrize("impl", ["pallas", "einsum", "auto", "xla"])
def test_multi_head_attention_f32_matches_jax(impl):
    q, k, v, g = _inputs(0)
    want, want_grads = _jax(impl, q, k, v, g, jnp.float32)
    got, got_grads = _port(impl, q, k, v, g, torch.float32)
    np.testing.assert_allclose(got, want, **TOL)
    for name, a, w in zip("qkv", got_grads, want_grads):
        assert np.abs(w).max() > 1e-3
        np.testing.assert_allclose(a, w, **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("impl", ["pallas", "einsum"])
def test_multi_head_attention_bf16_matches_jax(impl):
    q, k, v, g = _inputs(1, "bf16")
    want, want_grads = _jax(impl, q, k, v, g, jnp.bfloat16)
    got, got_grads = _port(impl, q, k, v, g, torch.bfloat16)
    d = np.abs(got - want)
    assert (d == 0).mean() >= 0.95, (d == 0).mean()
    assert (d <= 2 ** -8 * (np.abs(want) + np.abs(want).max())).all(), d.max()
    for name, a, w in zip("qkv", got_grads, want_grads):
        err = np.abs(a - w).max()
        assert err <= 1e-2 * np.abs(w).max(), (f"d{name}", err / np.abs(w).max())


def test_einsum_valid_len_matches_jax_and_other_impls_raise():
    q, k, v, g = _inputs(2)
    want, want_grads = _jax("einsum", q, k, v, g, jnp.float32, valid_len=6)
    got, got_grads = _port("einsum", q, k, v, g, torch.float32, valid_len=6)
    np.testing.assert_allclose(got, want, **TOL)
    for a, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(a, w, **TOL)
    t = torch.from_numpy(q)
    for impl in ("pallas", "xla", "auto"):
        if impl == "auto":  # auto takes einsum with valid_len
            np.testing.assert_allclose(
                multi_head_attention(t, t, t, impl=impl, valid_len=6).numpy(),
                multi_head_attention(t, t, t, impl="einsum", valid_len=6).numpy())
            continue
        with pytest.raises(NotImplementedError):
            multi_head_attention(t, t, t, impl=impl, valid_len=6)
    with pytest.raises(ValueError):
        multi_head_attention(t, t, t, impl="other")


@pytest.mark.parametrize("impl", ["pallas", "einsum", "auto"])
def test_fused_qkv_attention_3d_matches_jax(impl):
    """[B, S, 3W] grouped qkv (G 2) with pad keys through the port's K1 on
    its [B*S, 3W] view against npcd_tpu's 3D fused_qkv_attention with each
    impl ("pallas": its K1 in interpret mode; einsum and auto: its einsum
    path); pad-query rows are unspecified and not compared."""
    rng = np.random.default_rng(3)
    b, s, h, valid = 2, 16, 4, 13
    qkv = (0.5 * rng.normal(size=(b, s, 3 * h * D))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_attention.fused_qkv_attention(
            jnp.asarray(qkv), h, impl=impl, valid_len=valid, groups=2))
    got = fused_qkv_attention(torch.from_numpy(qkv).reshape(b * s, -1), h, b, s, valid,
                              2).reshape(b, s, -1).numpy()
    np.testing.assert_allclose(got[:, :valid], want[:, :valid], **TOL)


def test_flash_attention_without_grad_is_the_plain_forward():
    q, k, v, _ = _inputs(4)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with torch.no_grad():
        np.testing.assert_allclose(flash_attention(*t).numpy(),
                                   multi_head_attention(*t, impl="einsum").numpy(), **TOL)

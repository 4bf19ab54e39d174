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
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops import attention as jax_attention
from npcd_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from npcd_tpu_torch.ops.attention import fused_qkv_attention, multi_head_attention
from npcd_tpu_torch.ops.kernels.flash_attention import flash_attention, flash_attention_plain

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


def _bf16_pair(x, lo):
    """f32 x as bf16 hi = bf16(x) and lo = bf16(x - hi), or as its one bf16
    and 0 (lo False), both back in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float() if lo else torch.zeros_like(x)


def _k8_bf16_arithmetic(q, k, v, g, lo):
    """The bf16 K8f/K8b's arithmetic (csrc/flash_attention.cu, namespace tc)
    on f32 copies of bf16 inputs [B, S, H, D]: s = (q k^T) scale, p = exp(s
    - m) / l, delta = rowsum(p dp), ds = p (dp - delta) scale, all in f32;
    every product with P or dS as its left operand takes it as a bf16 pair
    (hi + lo, or one bf16) against exact bf16 values, summed in f32 ->
    out, dq, dk, dv rounded to bf16, as f32 numpy."""
    q, k, v, g = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, g))
    scale = torch.tensor(1 / math.sqrt(q.shape[-1]), dtype=torch.float32)
    product = lambda a, b: sum(part @ b for part in _bf16_pair(a, lo))
    t = lambda x: x.transpose(-1, -2)
    s = q @ t(k) * scale
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    p = torch.exp(s - (m + torch.log(l)))
    dp = g @ t(v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    outs = (product(e, v) / l, product(ds, k), product(t(ds), q), product(t(p), g))
    return [x.transpose(1, 2).to(torch.bfloat16).float().numpy() for x in outs]


def test_k8_bf16_operand_contract():
    """Why the bf16 K8 on the tensor cores feeds P and dS as bf16 hi + lo
    pairs: at [1, 513, 2, 64], with bf16 inputs, the kernels' arithmetic so
    transcribed agrees with npcd_tpu's Pallas flash_attention (interpret
    mode; f32 math on the upcast inputs) on >= 99% of out, dq, dk and dv
    bitwise (99.79 / 99.74 / 99.76 / 99.76% measured here), every element
    within chip_smoke.py's _bf16_err bound (one bf16 ulp of itself plus one
    of the output's largest magnitude); with P and dS each rounded to one
    bf16, as the library's attention does, it does not (59.5 / 57.9 / 58.2 /
    57.9%). npcd_tpu's forward writes query rows in blocks of 512 over S
    padded to 640 (its grid is 640 // 512 = 1 block), so row 512 of its out
    is never written; that row is held against the port's plain version."""
    rng = np.random.default_rng(7)
    shape = (1, 513, 2, 64)
    q, k, v, g = (np.array(jnp.asarray(rng.normal(size=shape).astype(np.float32))
                           .astype(jnp.bfloat16).astype(jnp.float32)) for _ in range(4))
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, g)]
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(jax_flash_attention, *args[:3])
        grads = vjp(args[3])
    f32 = lambda a: np.array(jnp.asarray(a).astype(jnp.float32))
    want = [f32(out)] + [f32(x) for x in grads]
    row_512 = flash_attention_plain(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    want[0][:, 512:] = row_512[:, 512:].float().numpy()

    def shares(got):
        res = []
        for a, w in zip(got, want):
            d = np.abs(a - w)
            assert (d <= 2 ** -7 * (np.abs(w) + np.abs(w).max())).all()
            res.append(float((d == 0).mean()))
        return res

    split, single = shares(_k8_bf16_arithmetic(q, k, v, g, True)), \
        shares(_k8_bf16_arithmetic(q, k, v, g, False))
    assert min(split) >= 0.99, split
    assert max(single) < 0.9, single


def _tf32(x):
    """f32 x rounded to tf32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32: the low 13 bits of the f32 pattern."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_product(a, b, lo):
    """a @ b on the tensor cores as the f32 K8b feeds them: both operands
    split into tf32 hi = tf32(x) and lo = tf32(x - hi), the three products
    a_lo b_hi + a_hi b_lo + a_hi b_hi summed in f32 (lo False: a_hi b_hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if not lo:
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _stepped(a, b, step, lo):
    """sum over the summed dimension in steps of ``step`` rows, each step's
    product a fresh f32 sum added to the running one in f32."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for i in range(0, a.shape[-1], step):
        acc = acc + _tf32_product(a[..., i:i + step], b[..., i:i + step, :], lo)
    return acc


def _k8_f32_bwd_arithmetic(q, k, v, g, lo):
    """The f32 K8b's arithmetic (csrc/flash_attention.cu, namespace tf) on f32
    [B, S, H, D] inputs: the dQ pass forms s = q k^T and dp = dO v^T with the
    3xTF32 product (lo False: one tf32 product), p = exp(s scale - lse) from
    the forward's f32 lse, delta = rowsum(p dp) and ds = p (dp - delta)
    scale in f32, and dq = ds k over 32-key steps; the dK/dV pass forms s^T
    = k q^T and dp^T = v dO^T, and dv = p^T dO and dk = ds^T q over 16-query
    steps -> dq, dk, dv as numpy."""
    q, k, v, g = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v, g))
    scale = torch.tensor(1 / math.sqrt(q.shape[-1]), dtype=torch.float32)
    t = lambda x: x.transpose(-1, -2)
    lse = torch.logsumexp(q @ t(k) * scale, dim=-1, keepdim=True)
    p = torch.exp(_tf32_product(q, t(k), lo) * scale - lse)
    dp = _tf32_product(g, t(v), lo)
    delta = (p * dp).sum(-1, keepdim=True)
    dq = _stepped(p * (dp - delta) * scale, k, 32, lo)
    pt = torch.exp(_tf32_product(k, t(q), lo) * scale - t(lse))
    dst = pt * (_tf32_product(v, t(g), lo) - t(delta)) * scale
    dk, dv = _stepped(dst, q, 16, lo), _stepped(pt, g, 16, lo)
    return [x.transpose(1, 2).numpy() for x in (dq, dk, dv)]


@pytest.mark.parametrize("lo", [True, False])
def test_k8_f32_tf32_split_contract(lo):
    """Why the f32 K8b on the tensor cores splits every operand into tf32
    hi + lo: at [1, 130, 2, 64], the kernels' arithmetic so transcribed
    agrees with npcd_tpu's Pallas flash_attention backward (interpret mode,
    exact f32) within the card test's f32 tolerance, 1e-5 of max(1, each
    gradient's largest magnitude) (6.6e-7 / 8.9e-7 / 6.0e-7 of it for dq /
    dk / dv measured here); with one tf32 product (hi only) it does not
    (3.9e-4 / 5.4e-4 / 5.3e-4)."""
    rng = np.random.default_rng(8)
    q, k, v, g = (rng.normal(size=(1, 130, 2, 64)).astype(np.float32) for _ in range(4))
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_flash_attention, *(jnp.asarray(a) for a in (q, k, v)))
        want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    got = _k8_f32_bwd_arithmetic(q, k, v, g, lo)
    rel = [np.abs(a - w).max() / max(1.0, np.abs(w).max()) for a, w in zip(got, want)]
    if lo:
        assert max(rel) <= 1e-5, rel
    else:
        assert max(rel) > 1e-5, rel

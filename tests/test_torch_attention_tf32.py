"""Why the port's f32 attention kernels on the tensor cores split every
operand into tf32 hi + lo (3xTF32, ``csrc/tf32_mma.cuh``): transcriptions
of the arithmetic of the f32 K1f and K1b (``csrc/fused_qkv_attention.cu``,
``tf::fwd``, ``tf::bwd_dq`` and ``tf::bwd_dkdv``) and of the f32 K8f
(``csrc/flash_attention.cu``, ``tf::fwd``) on the CPU, held against
npcd_tpu's Pallas kernels in interpret mode (exact f32). With the lo
products each lands within the card's f32 tolerance, 1e-5 of max(1, each
output's largest magnitude); with one tf32 product (hi only) it does not.
The tf32 rounding and the stepped 3xTF32 product are
``tests/test_torch_flash_attention.py``'s, which holds the f32 K8b the
same way."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from npcd_tpu.ops.pallas.fused_qkv_attention import _fwd_impl as _pallas_fwd
from npcd_tpu.ops.pallas.fused_qkv_attention import fused_qkv_attention_2d
from npcd_tpu_torch.ops.kernels.fused_qkv_attention import (LOG2_E, fused_qkv_attention_plain,
                                                           merge_grouped_qkv, split_grouped_qkv)
from test_torch_flash_attention import _stepped, _tf32_product

TOL = 1e-5  # of max(1, each output's largest magnitude)
TILE = 16  # keys (dQ pass, forward) or queries (dK/dV pass) a step at D 64


def _rel(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def _k1_f32_bwd_arithmetic(qkv, dout, heads, b, s, valid, groups, lo):
    """The f32 K1b's arithmetic on qkv [B*S, 3W] and dout [B*S, W] (numpy),
    from the f32 forward's out and base-2 lse (the plain version's): the dQ
    pass forms delta = rowsum(dO * O) in f32, s = (q c2) k^T and dp = dO v^T
    with the 3xTF32 product (lo False: one tf32 product), p = exp2(s - lse)
    (0 at keys >= valid), ds = p (dp - delta), and dq = ds k over 16-key
    steps, times scale; the dK/dV pass forms s^T = (k c2) q^T and dp^T = v
    dO^T over every query, dv = p^T dO and dk = ds^T q over 16-query steps,
    dk times scale, and the rows of keys >= valid 0 -> dqkv as numpy."""
    qkv_t, g = torch.from_numpy(qkv), torch.from_numpy(dout)
    out, lse = fused_qkv_attention_plain(qkv_t, heads, b, s, valid, groups, return_lse=True)
    bhsd = lambda x: x.reshape(b, s, heads, -1).transpose(1, 2)
    q, k, v = (x.transpose(1, 2) for x in split_grouped_qkv(qkv_t.reshape(b, s, -1), heads,
                                                             groups))
    g, o = bhsd(g), bhsd(out)
    d = q.shape[-1]
    c2 = torch.tensor(LOG2_E / math.sqrt(d), dtype=torch.float32)
    scale = torch.tensor(1 / math.sqrt(d), dtype=torch.float32)
    t = lambda x: x.transpose(-1, -2)
    keys = torch.arange(s) < valid
    delta = (g * o).sum(-1, keepdim=True)  # [B, H, S, 1]
    lse = lse[..., None]
    p = torch.where(keys, torch.exp2(_tf32_product(q * c2, t(k), lo) - lse), 0.0)
    dq = _stepped(p * (_tf32_product(g, t(v), lo) - delta), k, TILE, lo) * scale
    pt = torch.exp2(_tf32_product(k * c2, t(q), lo) - t(lse))
    dst = pt * (_tf32_product(v, t(g), lo) - t(delta))
    real = keys[:, None]
    dk = torch.where(real, _stepped(dst, q, TILE, lo) * scale, 0.0)
    dv = torch.where(real, _stepped(pt, g, TILE, lo), 0.0)
    return merge_grouped_qkv(*(x.transpose(1, 2) for x in (dq, dk, dv)), groups).reshape(
        b * s, -1).numpy()


@pytest.mark.parametrize("lo", [True, False])
def test_k1_f32_tf32_split_contract(lo):
    """At [B 2, S 72, H 4, D 64], G 2, valid 70, with a cotangent zero on
    pad-query rows: the f32 K1b's arithmetic so transcribed agrees with
    jax.vjp of npcd_tpu's Pallas fused_qkv_attention_2d (interpret mode)
    within 1e-5 of max(1, each of dq, dk, dv's largest magnitude) (8.4e-7 /
    1.2e-6 / 6.1e-7 of it measured here), and pad-query dq and pad-key dk,
    dv are exactly 0; with one tf32 product (hi only) it does not (6.1e-4
    / 2.0e-3 / 5.8e-4)."""
    b, s, heads, groups, valid = 2, 72, 4, 2, 70
    rng = np.random.default_rng(9)
    qkv = rng.normal(size=(b * s, 3 * heads * 64)).astype(np.float32)
    dout = rng.normal(size=(b, s, heads * 64)).astype(np.float32)
    dout[:, valid:] = 0.0
    dout = dout.reshape(b * s, -1)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda a: fused_qkv_attention_2d(a, heads, b, s, valid, groups),
                         jnp.asarray(qkv))
        want = np.array(vjp(jnp.asarray(dout))[0])
    got = _k1_f32_bwd_arithmetic(qkv, dout, heads, b, s, valid, groups, lo)
    split = lambda x: split_grouped_qkv(torch.from_numpy(x).reshape(b, s, -1), heads, groups)
    parts = list(zip(split(got), split(want)))
    rel = [_rel(a[:, :valid].numpy(), w[:, :valid].numpy()) for a, w in parts]
    (dq, _), (dk, _), (dv, _) = parts
    assert all((x[:, valid:] == 0).all() for x in (dq, dk, dv))
    if lo:
        assert max(rel) <= TOL, rel
    else:
        assert max(rel) > TOL, rel


def _k8_f32_fwd_arithmetic(q, k, v, lo):
    """The f32 K8f's arithmetic on f32 [B, S, H, D] inputs (numpy): s = q
    k^T with the 3xTF32 product (lo False: one tf32 product), times scale,
    one 16-key step at a time with an online softmax (running max m and sum
    l, o = o alpha + p v with alpha = exp(m_old - m_new)), p v as a 3xTF32
    product; out = o / l, lse = m + ln l -> out [B, S, H, D], lse [B, H, S]
    as numpy."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    scale = torch.tensor(1 / math.sqrt(q.shape[-1]), dtype=torch.float32)
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    lsum = torch.zeros_like(m)
    o = torch.zeros_like(q)
    for k0 in range(0, k.shape[-2], TILE):
        kt, vt = k[..., k0:k0 + TILE, :], v[..., k0:k0 + TILE, :]
        s = _tf32_product(q, kt.transpose(-1, -2), lo) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _tf32_product(p, vt, lo)
        m = m_new
    return (o / lsum).transpose(1, 2).numpy(), (m + torch.log(lsum))[..., 0].numpy()


@pytest.mark.parametrize("lo", [True, False])
def test_k8_f32_forward_tf32_split_contract(lo):
    """At [1, 130, 2, 64] (S 130: npcd_tpu's forward writes every query
    row): the f32 K8f's arithmetic so transcribed agrees with npcd_tpu's
    Pallas flash_attention forward (interpret mode) within 1e-5 of max(1,
    the output's largest magnitude) (7.2e-7 of it measured here), and its
    base-e lse agrees with a float64 log-sum-exp of the scores within 1e-5
    of max(1, its largest magnitude) (7.3e-8; the Pallas forward keeps no
    lse); with one tf32 product (hi only) neither does (6.0e-4, 2.8e-5)."""
    rng = np.random.default_rng(10)
    q, k, v = (rng.normal(size=(1, 130, 2, 64)).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.array(jax_flash_attention(*(jnp.asarray(a) for a in (q, k, v))))
    s64 = np.einsum("bthc,bshc->bhts", q.astype(np.float64), k.astype(np.float64)) / 8.0
    want_lse = np.log(np.exp(s64 - s64.max(-1, keepdims=True)).sum(-1)) + s64.max(-1)
    out, lse = _k8_f32_fwd_arithmetic(q, k, v, lo)
    rel = [_rel(out, want), _rel(lse, want_lse)]
    if lo:
        assert max(rel) <= TOL, rel
    else:
        assert min(rel) > TOL, rel


def _k1_f32_fwd_arithmetic(qkv, heads, b, s, valid, groups, lo):
    """The f32 K1f's arithmetic (``tf::fwd`` of csrc/fused_qkv_attention.cu)
    on qkv [B*S, 3W] (numpy): q times c2 = log2(e) / sqrt(D) before the
    split, the keys [0, valid) in 16-key steps (rows past valid zero,
    their scores -inf), s = (q c2) k^T with the 3xTF32 product (lo False:
    one tf32 product), an online softmax in base 2 (running max m and sum
    l, o = o alpha + p v with alpha = exp2(m_old - m_new)), p v as a 3xTF32
    product; out = o / l, lse = m + log2 l -> out [B*S, W], lse [B, H, S]
    as numpy."""
    qkv_t = torch.from_numpy(qkv)
    q, k, v = (x.transpose(1, 2) for x in split_grouped_qkv(qkv_t.reshape(b, s, -1), heads,
                                                             groups))
    c2 = torch.tensor(LOG2_E / math.sqrt(q.shape[-1]), dtype=torch.float32)
    q = q * c2
    m = torch.full(q.shape[:-1] + (1,), -torch.inf)
    lsum = torch.zeros_like(m)
    o = torch.zeros_like(q)
    for k0 in range(0, valid, TILE):
        keys = torch.arange(k0, min(k0 + TILE, s)) < valid
        kt, vt = (torch.where(keys[:, None], x[..., k0:k0 + TILE, :], 0.0) for x in (k, v))
        sc = torch.where(keys, _tf32_product(q, kt.transpose(-1, -2), lo), -torch.inf)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new)
        lsum = lsum * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _tf32_product(p, vt, lo)
        m = m_new
    out = (o / lsum).transpose(1, 2).reshape(b * s, -1)
    return out.numpy(), (m + torch.log2(lsum))[..., 0].numpy()


@pytest.mark.parametrize("lo", [True, False])
def test_k1_f32_forward_tf32_split_contract(lo):
    """At [B 2, S 72, H 4, D 64], G 2, valid 70: the f32 K1f's arithmetic so
    transcribed agrees with npcd_tpu's Pallas forward (``_fwd_impl`` of
    fused_qkv_attention_2d, interpret mode) within 1e-5 of max(1, each
    output's largest magnitude), the output of every query row (pad
    queries attend to the valid keys) and the base-2 lse (6.5e-7 / 1.3e-7
    of it measured here); with one tf32 product (hi only) neither does
    (6.0e-4 / 6.3e-5)."""
    b, s, heads, groups, valid = 2, 72, 4, 2, 70
    rng = np.random.default_rng(11)
    qkv = rng.normal(size=(b * s, 3 * heads * 64)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse = (np.array(a) for a in _pallas_fwd(jnp.asarray(qkv), heads, b, s, valid,
                                                            groups))
    # [B, programs, S, heads a program] -> [B, H, S]
    want_lse = want_lse.transpose(0, 1, 3, 2).reshape(b, heads, s)
    out, lse = _k1_f32_fwd_arithmetic(qkv, heads, b, s, valid, groups, lo)
    rel = [_rel(out, want), _rel(lse, want_lse)]
    if lo:
        assert max(rel) <= TOL, rel
    else:
        assert min(rel) > TOL, rel

"""The bf16 MLP kernels of the fast stage-1 config, PyTorch port against
npcd_tpu on the same numpy inputs: K7 (the field heads' fused MLP stack,
ops/kernels/fused_mlp.py) against npcd_tpu's Pallas fused_mlp in interpret
mode, the bf16 K6 (posenc-fused aggregation MLP + k-weighted sum) against
npcd_tpu's Pallas fused_mlp_posenc_wsum in interpret mode (forward and VJP,
need_dw=False, need_dp=False, 'anchored'), and nn_core.apply_mlp in bf16
against npcd_tpu's XLA apply_mlp. On the CPU the port runs its plain
versions, which follow the TPU kernels' rounding points.

XLA on the CPU may skip a bf16 rounding between two f32 operations (its
excess-precision default), which the TPU kernels do not: the JAX side is
compiled with ``xla_allow_excess_precision`` off, so that it rounds where
the kernels round. What is left are f32 sums in another order: a hidden
activation whose bf16 rounding flips moves later layers by an ulp.

Tolerances (the worst values measured on this CPU are in brackets):
  * forward: at least 99% of the elements bitwise equal (K7 [99.58%], K6
    [99.15%]; apply_mlp 99.9% [99.94%]), and each element within one bf16
    ulp of itself plus one of the output's largest magnitude, where a
    flipped hidden rounding reaches an output that cancels [0.52 of that];
  * backward (dx, dfeat, dW, db): rows and pairs on a leaky_relu kink get
    a zero cotangent or weight (``leaky_kinks_bf16``, ``leaky_kinks``: a
    bf16 pre-activation whose sign an f32 sum in another order can flip, or
    within 1e-5 of 0), then each output within 1e-2 of max(1,
    its largest magnitude) [9.0e-3]."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.models.pointnerf import nn_core as jax_nn
from npcd_tpu.ops.pallas.fused_mlp import fused_mlp as pallas_mlp
from npcd_tpu.ops.pallas.fused_mlp import fused_mlp_posenc_wsum as pallas_wsum
from npcd_tpu_torch.models.pointnerf import nn_core
from npcd_tpu_torch.ops.kernels.fused_mlp import LEAKY_BF16, fused_mlp, leaky_bf16, leaky_kinks_bf16
from npcd_tpu_torch.ops.kernels.fused_mlp_posenc import fused_mlp_posenc_wsum, leaky_kinks

N_FREQS, K = 10, 8
SHAPE_NET, CHANNEL_NET = (256, 1), (256, 256, 256, 256, 3)


def _exact(fn, *args):
    """fn(*args) jitted with XLA's excess precision off: every bf16 cast
    rounds, as in the TPU kernels."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _mlp(dims, d_in, seed):
    """bf16 weights (w [in, out], b [out]) as numpy f32 of bf16 values."""
    rng = np.random.default_rng(seed)
    layers, cur = [], d_in
    for dim in dims:
        bound = 1 / np.sqrt(cur)
        layers.append(tuple(_bf16(rng.uniform(-bound, bound, shape))
                            for shape in ((cur, dim), (dim,))))
        cur = dim
    return layers


def _bf16(a):
    """numpy f32 rounded to bf16 values."""
    return np.array(jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _j(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if isinstance(a, jax.Array) \
        else a.float().numpy()


def _forward_close(got, want, bitwise):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    d = np.abs(got - want)
    assert (d == 0).mean() >= bitwise, (d == 0).mean()
    assert (d <= 2 ** -7 * (np.abs(want) + np.abs(want).max())).all(), d.max()


def _close(got, want, what, rel=1e-2):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    tol = rel * max(1.0, float(np.abs(want).max()))
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


@pytest.mark.parametrize("dims", [SHAPE_NET, CHANNEL_NET])
def test_fused_mlp_matches_pallas_interpret(dims):
    rng = np.random.default_rng(len(dims))
    rows = 1500  # a full and a ragged block of the TPU kernel's 1024 rows
    x = _bf16(rng.normal(size=(rows, 256)))
    layers = _mlp(dims, 256, seed=len(dims) + 1)
    g = _bf16(rng.normal(size=(rows, dims[-1])))
    kinks = leaky_kinks_bf16(torch.from_numpy(x), [(torch.from_numpy(w), torch.from_numpy(b))
                                                   for w, b in layers]).numpy()
    assert kinks.mean() < 0.1
    g[kinks] = 0.0

    def fn(x, ws, g):
        with pltpu.force_tpu_interpret_mode():
            out, vjp = jax.vjp(lambda a, w: pallas_mlp(a, w, True), x, ws)
            return out, vjp(g)

    jws = tuple((_j(w), _j(b)) for w, b in layers)
    out, (dx, dws) = _exact(fn, _j(x[None]), jws, _j(g[None]))
    xt = _t(x).requires_grad_(True)
    tws = [(_t(w).requires_grad_(True), _t(b).requires_grad_(True)) for w, b in layers]
    got = fused_mlp(xt, tws)
    assert got.dtype == torch.bfloat16 and got.shape == (rows, dims[-1])
    _forward_close(got.detach(), out[0], bitwise=0.99)
    got.backward(_t(g))
    _close(xt.grad, dx[0], "dx")
    for i, ((tw, tb), (rw, rb)) in enumerate(zip(tws, dws)):
        assert tw.grad.dtype == torch.bfloat16 and float(tw.grad.abs().max()) > 0
        _close(tw.grad, rw, f"dW{i}")
        _close(tb.grad, rb, f"db{i}")


@pytest.mark.parametrize("n_pts", [64, 33])
def test_posenc_wsum_bf16_matches_pallas_interpret(n_pts):
    """F 32, the configs' srncars feat_dim; 33 points make a ragged block.
    (At F 8 the interpret-mode backward moved dW2 by 2.6e-2 of its scale
    from a jnp transcription of its own formulas, which the port matched
    within an ulp; the whole-step tests cover F 8 through npcd_tpu's XLA
    path.)"""
    f = 32
    rng = np.random.default_rng(f + n_pts)
    b, m = 2, n_pts * K
    feat_t = _bf16(rng.normal(size=(b, f, m)))
    w = rng.uniform(size=(b, n_pts, K))
    w = (w / w.sum(-1, keepdims=True)).reshape(b, 1, m)
    pos_t = np.concatenate([rng.uniform(-0.16, 0.16, (b, 3, m)), w, np.zeros((b, 4, m))],
                           axis=1).astype(np.float32)
    layers = _mlp((256,) * 5, f + 3 * (1 + 2 * N_FREQS), seed=f)
    tws = [(_t(a), _t(c)) for a, c in layers]
    kinks = leaky_kinks(_t(feat_t), torch.from_numpy(pos_t), tws, N_FREQS).numpy()
    assert kinks.mean() < 0.2, kinks.mean()
    pos_t[:, 3][kinks] = 0.0
    g = _bf16(rng.normal(size=(b, n_pts, 256)))

    def fn(ft, ws, g):
        with pltpu.force_tpu_interpret_mode():
            out, vjp = jax.vjp(lambda a, w_: pallas_wsum(
                a, jnp.asarray(pos_t), w_, K, N_FREQS, 1.0, True, "anchored",
                need_dw=False, need_dp=False), ft, ws)
            return out, vjp(g)

    out, (dfeat, dws) = _exact(fn, _j(feat_t), tuple((_j(a), _j(c)) for a, c in layers), _j(g))
    ft = _t(feat_t).requires_grad_(True)
    pt = torch.from_numpy(pos_t).requires_grad_(True)
    tws = [(a.requires_grad_(True), c.requires_grad_(True)) for a, c in tws]
    got = fused_mlp_posenc_wsum(ft, pt, tws, K, N_FREQS, 1.0, "anchored")
    assert got.dtype == torch.bfloat16 and got.shape == (b, n_pts, 256)
    _forward_close(got.detach(), out, bitwise=0.99)
    got.backward(_t(g))
    assert pt.grad is None
    _close(ft.grad, dfeat, "dfeat_t")
    for i, ((tw, tb), (rw, rb)) in enumerate(zip(tws, dws)):
        assert float(tw.grad.abs().max()) > 0, f"layer {i} got no gradient"
        _close(tw.grad, rw, f"dW{i}")
        _close(tb.grad, rb, f"db{i}")


@pytest.mark.parametrize("dims", [SHAPE_NET, (256, 256)])
def test_apply_mlp_bf16_matches_jax_xla(dims):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 700, 256)).astype(np.float32)  # f32 input, cast inside
    layers = _mlp(dims, 256, seed=4)
    want = _exact(lambda a, ls: jax_nn.apply_mlp(ls, a, compute_dtype=jnp.bfloat16, impl="xla"),
                  jnp.asarray(x), [{"w": jnp.asarray(w), "b": jnp.asarray(b)} for w, b in layers])
    got = nn_core.apply_mlp([{"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
                             for w, b in layers], torch.from_numpy(x),
                            compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (4, 700, dims[-1])
    _forward_close(got, want, bitwise=0.999)
    # f32 compute keeps the f32 layers
    f32 = nn_core.apply_mlp([{"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
                             for w, b in layers], torch.from_numpy(x))
    assert f32.dtype == torch.float32


def test_leaky_relu_slope_is_bf16_of_0_01():
    """npcd_tpu's bf16 activation multiplies by bf16(0.01) = 0.010009765625:
    the port's leaky_bf16 equals it bitwise, where torch's 0.01 * h (the f32
    constant) differs on about a fifth of negative inputs."""
    h = np.linspace(-3.0, -0.1, 2000).astype(np.float32)
    want = _f32(_exact(lambda a: jnp.maximum(a, 0.01 * a), _j(h)))
    ht = torch.from_numpy(h).to(torch.bfloat16)
    np.testing.assert_array_equal(_f32(leaky_bf16(ht)), want)
    assert LEAKY_BF16 == float(np.asarray(jnp.asarray(0.01, jnp.bfloat16).astype(jnp.float32)))
    naive = _f32(torch.maximum(ht, 0.01 * ht))
    assert (naive != want).mean() > 0.1

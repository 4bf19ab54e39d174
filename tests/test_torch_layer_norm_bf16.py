"""Kernels K2a-d (LayerNorm and residual-add + LayerNorm, forward and
backward) in bf16, PyTorch port against npcd_tpu: the port's autograd path
on the CPU (its plain versions) vs npcd_tpu's Pallas layer_norm /
layer_norm_residual and their VJPs in interpret mode, on the same numpy
inputs: x, delta and the cotangents bf16, gamma and beta f32, widths 128
and 1024 (the denoiser's), all-zero pad rows with zero cotangents. The JAX
side is compiled with ``xla_allow_excess_precision`` off. Both sides keep
the statistics in f32, write r = bf16(x + delta), recompute rhat from that
bf16 r with the f32 mean/rstd of the unrounded sum, and round dx once.

Tolerances (the worst values measured on this CPU are in brackets):
  * r: bitwise equal [equal];
  * y and dx (dr): at least 99% of the elements bitwise equal [99.99%],
    each within one bf16 ulp of itself plus 2**-8 of the output's largest
    magnitude [one flipped rounding, 8.9e-4 of the scale] (the f32 row
    sums run in another order, so a rounding may flip);
  * dgamma, dbeta (f32 sums over the rows): 1e-5 of their largest
    magnitude [2.5e-7]; pad rows' dx exactly 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops.pallas import layer_norm as pallas_ln
from npcd_tpu_torch.ops.kernels.layer_norm import layer_norm, layer_norm_residual


def _exact(fn, *args):
    with pltpu.force_tpu_interpret_mode():
        return jax.jit(fn).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})(*args)


def _bf16(a):
    return np.array(jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)
                    .astype(jnp.float32))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _inputs(w, seed, n=2, s=24):
    rng = np.random.default_rng(seed)
    f = lambda scale=1.0: _bf16(rng.normal(size=(n, s, w)) * scale)
    x, d, gr, gy = f(2.0), f(), f(), f()
    for a in (x, d, gr, gy):
        a[:, -3:] = 0.0
    g = (1 + 0.1 * rng.normal(size=w)).astype(np.float32)
    b = (0.1 * rng.normal(size=w)).astype(np.float32)
    return x, d, g, b, gr, gy


def _bf16_close(got, want, what):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    d = np.abs(got - want)
    assert (d == 0).mean() >= 0.99, (what, (d == 0).mean())
    assert (d <= 2 ** -8 * (np.abs(want) + np.abs(want).max())).all(), (what, d.max())


@pytest.mark.parametrize("w", [128, 1024])
@pytest.mark.parametrize("residual", [False, True])
def test_bf16_layer_norm_matches_pallas_interpret(w, residual):
    x, d, g, b, gr, gy = _inputs(w, seed=w + residual)
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    if residual:
        def fn(x, d, g, b, gr, gy):
            out, vjp = jax.vjp(pallas_ln.layer_norm_residual, x, d, g, b)
            return out, vjp((gr, gy))
        (r, y), grads = _exact(fn, bf(x), bf(d), jnp.asarray(g), jnp.asarray(b), bf(gr), bf(gy))
    else:
        def fn(x, g, b, gy):
            out, vjp = jax.vjp(pallas_ln.layer_norm, x, g, b)
            return out, vjp(gy)
        y, grads = _exact(fn, bf(x), jnp.asarray(g), jnp.asarray(b), bf(gy))

    t = lambda a: torch.from_numpy(a.reshape(-1, w)).to(torch.bfloat16).requires_grad_(True)
    xt, dt = t(x), t(d)
    gt, bt = (torch.tensor(a, requires_grad=True) for a in (g, b))
    if residual:
        r_got, y_got = layer_norm_residual(xt, dt, gt, bt)
        torch.autograd.backward([r_got, y_got], [t(gr).detach(), t(gy).detach()])
        np.testing.assert_array_equal(_f32(r_got), _f32(r).reshape(-1, w))
        got = [xt.grad, dt.grad, gt.grad, bt.grad]
    else:
        y_got = layer_norm(xt, gt, bt)
        y_got.backward(t(gy).detach())
        got = [xt.grad, gt.grad, bt.grad]
    assert y_got.dtype == torch.bfloat16
    _bf16_close(y_got, np.asarray(_f32(y)).reshape(-1, w), "y")
    names = ["dx", "ddelta", "dgamma", "dbeta"] if residual else ["dx", "dgamma", "dbeta"]
    for name, o, r_ in zip(names, got, grads):
        r_ = _f32(r_)
        if name in ("dx", "ddelta"):
            assert o.dtype == torch.bfloat16
            _bf16_close(o, r_.reshape(-1, w), name)
        else:
            assert o.dtype == torch.float32
            err = np.abs(_f32(o) - r_).max()
            assert err <= 1e-5 * np.abs(r_).max(), (name, err / np.abs(r_).max())
    dx = _f32(got[0]).reshape(x.shape)
    assert (dx[:, -3:] == 0).all()

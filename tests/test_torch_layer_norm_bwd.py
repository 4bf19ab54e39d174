"""Kernels K2c/K2d (LayerNorm backward, plain and residual) of the PyTorch
port against npcd_tpu: the port's autograd path on the CPU (its plain
backward) vs jax.vjp of the Pallas layer_norm / layer_norm_residual in
interpret mode, on the same numpy inputs and cotangents, at widths 128 and
256 with all-zero pad rows. Tolerance: 1e-5 abs/rel (f32 statistics,
reductions in another order; dgamma/dbeta sum ~50 rows of O(1) terms)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops.pallas import layer_norm as pallas_ln
from npcd_tpu_torch.ops.kernels.layer_norm import (layer_norm, layer_norm_bwd_plain,
                                                  layer_norm_residual)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(w, seed=0, n=2, s=24):
    rng = np.random.default_rng(seed)
    f = lambda scale=1.0: (rng.normal(size=(n, s, w)) * scale).astype(np.float32)
    x, d, gr, gy = f(2.0), f(), f(), f()
    for a in (x, d, gr, gy):
        a[:, -3:] = 0.0  # zero pad rows with zero cotangents, as in the denoiser
    g = (1 + 0.1 * rng.normal(size=w)).astype(np.float32)
    b = (0.1 * rng.normal(size=w)).astype(np.float32)
    return x, d, g, b, gr, gy


def _jax_grads(x, d, g, b, gr, gy, residual):
    with pltpu.force_tpu_interpret_mode():
        if residual:
            _, vjp = jax.vjp(pallas_ln.layer_norm_residual, *map(jnp.asarray, (x, d, g, b)))
            out = vjp((jnp.asarray(gr), jnp.asarray(gy)))
        else:
            _, vjp = jax.vjp(pallas_ln.layer_norm, *map(jnp.asarray, (x, g, b)))
            out = vjp(jnp.asarray(gy))
        return [np.asarray(o) for o in out]


def _port_grads(x, d, g, b, gr, gy, residual):
    w = x.shape[-1]
    t = [torch.tensor(a.reshape(-1, w) if a.ndim == 3 else a, requires_grad=True)
         for a in (x, d, g, b)]
    if residual:
        r, y = layer_norm_residual(*t)
        torch.autograd.backward([r, y], [torch.from_numpy(gr.reshape(-1, w)),
                                         torch.from_numpy(gy.reshape(-1, w))])
        return [t[0].grad, t[1].grad, t[2].grad, t[3].grad]
    y = layer_norm(t[0], t[2], t[3])
    y.backward(torch.from_numpy(gy.reshape(-1, w)))
    return [t[0].grad, t[2].grad, t[3].grad]


@pytest.mark.parametrize("w", [128, 256])
@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_backward_matches_pallas_interpret(w, residual):
    x, d, g, b, gr, gy = _inputs(w, seed=w + residual)
    ref = _jax_grads(x, d, g, b, gr, gy, residual)
    got = _port_grads(x, d, g, b, gr, gy, residual)
    names = ["dx", "ddelta", "dgamma", "dbeta"] if residual else ["dx", "dgamma", "dbeta"]
    for name, r, o in zip(names, ref, got):
        assert o is not None, name
        np.testing.assert_allclose(o.numpy().reshape(r.shape), r, **TOL, err_msg=name)
    # pad rows with zero cotangents: dx exactly 0 (not NaN) without the
    # residual; with it, dr = gr = 0 there too
    dx = got[0].numpy().reshape(x.shape)
    assert np.isfinite(dx).all() and (dx[:, -3:] == 0).all()


def test_layer_norm_residual_unused_r_cotangent():
    """ln_post's r is discarded: gr arrives as None and dr = dx of y alone."""
    x, d, g, b, _, gy = _inputs(128, seed=7)
    t = [torch.tensor(a.reshape(-1, 128) if a.ndim == 3 else a, requires_grad=True)
         for a in (x, d, g, b)]
    _, y = layer_norm_residual(*t)
    y.backward(torch.from_numpy(gy.reshape(-1, 128)))
    ref = _jax_grads(x, d, g, b, np.zeros_like(gy), gy, residual=True)
    for r, o in zip(ref, [a.grad for a in t]):
        np.testing.assert_allclose(o.numpy().reshape(r.shape), r, **TOL)


def test_layer_norm_bwd_plain_matches_autograd_of_forward():
    """The plain backward formula equals autograd through the plain forward."""
    x, _, g, b, _, gy = _inputs(128, seed=3)
    xt = torch.tensor(x.reshape(-1, 128), dtype=torch.float64, requires_grad=True)
    gt = torch.tensor(g, dtype=torch.float64, requires_grad=True)
    bt = torch.tensor(b, dtype=torch.float64, requires_grad=True)
    mean = xt.mean(-1, keepdim=True)
    var = ((xt - mean) ** 2).mean(-1, keepdim=True)
    y = (xt - mean) * torch.rsqrt(var + 1e-5) * gt + bt
    y.backward(torch.tensor(gy.reshape(-1, 128), dtype=torch.float64))
    x32 = torch.from_numpy(x.reshape(-1, 128))
    mean32 = x32.mean(-1)
    rstd32 = torch.rsqrt(((x32 - mean32[:, None]) ** 2).mean(-1) + 1e-5)
    dx, dg, db = layer_norm_bwd_plain(x32, torch.from_numpy(g), mean32, rstd32,
                                      torch.from_numpy(gy.reshape(-1, 128)))
    for got, want in ((dx, xt.grad), (dg, gt.grad), (db, bt.grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)

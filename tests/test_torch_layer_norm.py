"""Kernel K2 (LayerNorm, plain and residual) of the PyTorch port against
npcd_tpu: the port's CPU path (its plain version) vs FusedLayerNorm's XLA
path and vs the Pallas kernels in interpret mode, on the same numpy inputs.
Tolerance: 1e-5 abs/rel (f32 statistics, reductions in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.models.diffusion.transformer import FusedLayerNorm
from npcd_tpu.ops.pallas import layer_norm as pallas_ln
from npcd_tpu_torch.ops.kernels.layer_norm import layer_norm, layer_norm_residual

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed=0, n=2, s=24, w=128):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(n, s, w)) * 2 + 0.5).astype(np.float32)
    d = rng.normal(size=(n, s, w)).astype(np.float32)
    x[:, -3:] = 0.0  # zero pad rows, like the denoiser's sequence padding
    d[:, -3:] = 0.0
    g = (1 + 0.1 * rng.normal(size=w)).astype(np.float32)
    b = (0.1 * rng.normal(size=w)).astype(np.float32)
    return x, d, g, b


def _port(x, d, g, b, residual):
    t = [torch.from_numpy(a) for a in (x, d, g, b)]
    if residual:
        return tuple(o.numpy() for o in layer_norm_residual(*t))
    return (layer_norm(t[0], t[2], t[3]).numpy(),)


@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_matches_jax_xla(residual):
    x, d, g, b = _inputs()
    params = {"params": {"scale": jnp.asarray(g), "bias": jnp.asarray(b)}}
    mod = FusedLayerNorm(impl="xla")
    args = (jnp.asarray(x.reshape(-1, x.shape[-1])),)
    if residual:
        args += (jnp.asarray(d.reshape(-1, d.shape[-1])),)
    ref = mod.apply(params, *args)
    ref = ref if residual else (ref,)
    got = _port(x.reshape(-1, x.shape[-1]), d.reshape(-1, d.shape[-1]), g, b, residual)
    for r, o in zip(ref, got):
        np.testing.assert_allclose(o, np.asarray(r), **TOL)
    assert np.isfinite(got[-1]).all()
    # zero pad rows: variance 0, output = beta
    np.testing.assert_allclose(got[-1].reshape(x.shape)[:, -1], np.broadcast_to(b, (2, 128)),
                               **TOL)


@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_matches_pallas_interpret(residual):
    x, d, g, b = _inputs(seed=1)
    with pltpu.force_tpu_interpret_mode():
        if residual:
            ref = pallas_ln.layer_norm_residual(jnp.asarray(x), jnp.asarray(d),
                                                jnp.asarray(g), jnp.asarray(b))
        else:
            ref = (pallas_ln.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)),)
        ref = [np.asarray(r) for r in ref]
    for r, o in zip(ref, _port(x, d, g, b, residual)):
        np.testing.assert_allclose(o, r, **TOL)


def test_layer_norm_rejects_mismatched_params():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        layer_norm(x, torch.ones(7), torch.zeros(8))

"""Kernels K2c/K2d (LayerNorm backward, plain and residual) of the PyTorch
port against npcd_tpu: the port's autograd path on the CPU (its plain
backward) vs jax.vjp of the Pallas layer_norm / layer_norm_residual in
interpret mode, on the same numpy inputs and cotangents, at widths 128,
256, the denoiser's 1024, 1000 and 1001 (not a multiple of the TPU's 128
lanes, nor 1001 of the CUDA kernel's 16-byte vectors) with all-zero pad
rows. Tolerance: 1e-5 abs/rel (f32 statistics, reductions in another order;
dgamma/dbeta sum ~50 rows of O(1) terms). Also: the CUDA backward's C
signature against the wrapper's ctypes argtypes, and no Triton import in
the module."""
import ast
import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.ops.pallas import layer_norm as pallas_ln
from npcd_tpu_torch.ops.kernels import layer_norm as ln_module
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


@pytest.mark.parametrize("w", [128, 256, 1024, 1000, 1001])
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


def _c_params(source: str, name: str) -> list:
    """The parameter types of ``extern "C" int name(...)`` in a CUDA source,
    comments and line breaks aside."""
    source = re.sub(r"//[^\n]*|/\*.*?\*/", " ", source, flags=re.S)
    sig = re.search(r'extern\s+"C"\s+int\s+' + name + r"\s*\(([^)]*)\)", source)
    assert sig, name
    return [" ".join(p.replace("*", " * ").split()[:-1]) for p in sig.group(1).split(",")]


@pytest.mark.parametrize("name", ["layer_norm_fwd", "layer_norm_bwd", "layer_norm_bwd_blocks"])
def test_layer_norm_c_signature_matches_ctypes(name):
    """The wrapper's ctypes argtypes follow csrc/layer_norm.cu's C entry
    point parameter by parameter: a pointer as c_void_p, an int as c_int, a
    float as c_float (ctypes would cut a pointer passed as an int). The card
    tests would catch a wrong list too, but they do not run without a card;
    this holds the two files together on every run."""
    source = (Path(ln_module.__file__).resolve().parents[2] / "csrc" / "layer_norm.cu").read_text()
    params = _c_params(source, name)
    kind = lambda t: (ctypes.c_void_p if "*" in t else
                      {"int": ctypes.c_int, "float": ctypes.c_float}[t.replace("const ", "")])
    assert [kind(t) for t in params] == ln_module.ARGTYPES[name]


def test_layer_norm_module_imports_no_triton():
    """K2 is CUDA C++ in both directions: the module imports no Triton,
    at its top or inside a function."""
    tree = ast.parse(Path(ln_module.__file__).read_text())
    names = [alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for alias in node.names]
    names += [node.module or "" for node in ast.walk(tree) if isinstance(node, ast.ImportFrom)]
    assert names and not [n for n in names if n.split(".")[0] == "triton"]

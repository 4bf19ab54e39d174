"""Kernel K3 (AdamW + EMA + sum of g^2) and the port's FusedAdamWEma
against npcd_tpu's FusedAdamWEma.update, on both of its paths: the per-leaf
XLA closure and the Pallas kernel in interpret mode. Three steps from a
state at count 4 (so Adam's bias correction and the EMA decay are past
their first step), with and without clipping, with 0, 1 and 2 EMAs; the
port runs its plain version over flat buffers of the same leaves.
Tolerance: 2e-6 of each leaf's largest magnitude (f32 elementwise math in
the same op order, but XLA may contract a multiply-add into an FMA and
sqrt, pow and division may round differently by an ulp, compounded over
three steps: a few ulps of the leaf's scale). Also ema_decay and
param_string."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental import pallas as pl

from npcd_tpu.ops.pallas import fused_adamw as jax_fused_adamw
from npcd_tpu.train import fused_update as jax_fu
from npcd_tpu.utils import ema as jax_ema
from npcd_tpu_torch.ops.kernels.fused_adamw import adamw_ema, adamw_ema_plain
from npcd_tpu_torch.train.fused_update import AdamState, FusedAdamWEma
from npcd_tpu_torch.utils.ema import EmaConfig, ema_decay

REL = 2e-6


def _close(got, want, what):
    want = np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), f"{what}: max abs err {err}"


# (1024, 128) takes the Pallas kernel on that path; the bias and the
# 35-column leaf stay on its closure
SHAPES = {"a": (1024, 128), "b": (128,), "c": (35, 64)}
EMA_CFGS = ((1.0, 0.9, 0.999, False), (0.75, 0.0, 0.9999, False))


def _leaves(rng, scale=1.0, positive=False):
    out = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}
    return {k: np.abs(v) if positive else v for k, v in out.items()}


def _flat(tree):
    return torch.from_numpy(np.concatenate([tree[k].reshape(-1) for k in SHAPES]))


def _unflat(flat):
    out, o = {}, 0
    for k, s in SHAPES.items():
        n = int(np.prod(s))
        out[k] = flat[o:o + n].reshape(s).numpy()
        o += n
    return out


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("n_ema", [0, 1, 2])
def test_update_matches_jax(monkeypatch, pallas, clip, n_ema):
    if pallas:  # route pallas_call through the interpreter (no TPU here)
        monkeypatch.setattr(jax_fused_adamw.pl, "pallas_call",
                            functools.partial(pl.pallas_call, interpret=True))
    rng = np.random.default_rng(n_ema + (clip is not None) * 3)
    lr, wd = 1e-3, 0.01
    cfgs = EMA_CFGS[:n_ema]
    jfused = jax_fu.FusedAdamWEma(lr, wd, clip_max_norm=clip,
                                  ema_cfgs=tuple(jax_ema.EmaConfig.from_tuple(c) for c in cfgs))
    pfused = FusedAdamWEma(lr, wd, clip_max_norm=clip,
                           ema_cfgs=tuple(EmaConfig.from_tuple(c) for c in cfgs))
    params = _leaves(rng)
    mu, nu = _leaves(rng, 1e-2), _leaves(rng, 1e-3, positive=True)
    emas = [_leaves(rng) for _ in range(n_ema)]
    count, step = 4, 4

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = jfused.make_tx().init(jp)
    opt_state = jax_fu._replace_adam_state(opt_state, optax.ScaleByAdamState(
        count=jnp.asarray(count, jnp.int32), mu=jax.tree_util.tree_map(jnp.asarray, mu),
        nu=jax.tree_util.tree_map(jnp.asarray, nu)))
    jemas = tuple(jax.tree_util.tree_map(jnp.asarray, e) for e in emas)

    p_flat = _flat(params)
    adam = AdamState(count, _flat(mu), _flat(nu))
    e_flat = torch.stack([_flat(e) for e in emas]) if n_ema else None
    for i in range(3):
        grads = _leaves(rng, 0.1)
        jp, opt_state, jemas, jnorm = jfused.update(
            jax.tree_util.tree_map(jnp.asarray, grads), opt_state, jp, jemas,
            jnp.asarray(step + i, jnp.int32), pallas=pallas)
        adam, norm = pfused.update(_flat(grads), p_flat, adam, e_flat, step + i)
        # a sum of ~1.4e5 squares in f32, in another order: 1e-5 relative
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-5)
    jadam = jax_fu._get_adam_state(opt_state)
    assert adam.count == int(jadam.count) == count + 3
    for name, got, want in [("p", p_flat, jp), ("mu", adam.mu, jadam.mu),
                            ("nu", adam.nu, jadam.nu)] + [
            (f"ema{k}", e_flat[k], jemas[k]) for k in range(n_ema)]:
        got = _unflat(got)
        for k in SHAPES:
            _close(got[k], want[k], f"{name}.{k}")


def test_adamw_ema_wrapper_runs_plain_on_cpu():
    """The K3 wrapper on CPU tensors is its plain version, in place."""
    rng = np.random.default_rng(0)
    mk = lambda: torch.tensor(rng.normal(size=1000), dtype=torch.float32)
    g, p, mu, nu = mk(), mk(), mk(), mk().abs()
    emas = torch.stack([mk(), mk()])
    scalars = torch.tensor([0.3, 0.01, 0.7, 0.9, 0.5])
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, lr=1e-3, wd=0.01, use_clip=True)
    copies = [t.clone() for t in (p, mu, nu, emas)]
    s1 = adamw_ema(g, p, mu, nu, emas, scalars, **kw)
    s2 = adamw_ema_plain(g, *copies, scalars, **kw)
    assert float(s1) == float(s2) == float((g * g).sum())
    for a, b in zip((p, mu, nu, emas), copies):
        assert torch.equal(a, b)
    assert adamw_ema.launches == 0


def test_adamw_ema_rejects_bad_scalars():
    z = torch.zeros(8)
    with pytest.raises(ValueError):
        adamw_ema(z, z.clone(), z.clone(), z.clone(), None, torch.zeros(4), b1=0.9, b2=0.999,
                  eps=1e-8, lr=1e-3, wd=0.0, use_clip=False)


@pytest.mark.parametrize("cfg", [(1, 0.9999, 0.9999, False), (1.0, 0.9, 0.999, True),
                                 (0.75, 0.0, 1.0, False)])
def test_ema_decay_and_param_string_match_jax(cfg):
    jcfg, pcfg = jax_ema.EmaConfig.from_tuple(cfg), EmaConfig.from_tuple(cfg)
    assert pcfg.param_string() == jcfg.param_string()
    for step in (0, 1, 2, 7, 100, 12345, 1_800_000):
        want = np.float32(jax_ema.ema_decay(jcfg, jnp.asarray(step, jnp.int32)))
        got = ema_decay(pcfg, step)
        assert got.dtype == np.float32
        # f32 pow may differ by an ulp between XLA and numpy
        np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)

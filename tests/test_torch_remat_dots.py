"""The port's denoiser under remat (npcd_tpu's remat_policy "full", whole
blocks recomputed by a non-reentrant checkpoint) and its refusal of
remat_policy "dots" on the CPU, with the tiny denoiser of
tests/diffusion_tiny.py:

  * the loss and every gradient leaf with and without remat bitwise equal,
    in f32 and bf16;
  * the gradients against npcd_tpu's DiffusionModel(remat=True,
    remat_policy="full") on the same weights and draws (its attention on
    the einsum path, which JAX can differentiate under a checkpoint; bf16
    compiled with xla_allow_excess_precision off): f32 within 1e-5 of each
    leaf's largest magnitude; bf16 within 3e-2, the bound of
    tests/test_torch_training_bf16.py (an activation whose bf16 rounding
    flips between the two moves a product by an ulp, 2**-8);
  * the GEMMs (aten.mm, aten.addmm) the backward runs, counted by a
    TorchDispatchMode: under remat 3 a block more than without: c_qkv, the
    attention's c_proj and c_fc run again, and the MLP's c_proj does not,
    since the non-reentrant checkpoint stops its recompute once the tensors
    the backward needs are back;
  * "dots" raises NotImplementedError (measured slower than "full" on the
    card, PERF.md) in the transformer and in DiffusionModel, and an unknown
    policy raises ValueError."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from diffusion_tiny import C, F, MODEL, P, T, models
from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel
from npcd_tpu_torch.models.diffusion.transformer import NPCDTransformer
from npcd_tpu_torch.utils.from_jax import denoiser_state_dict

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
GEMMS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny models: their small ops gain
    nothing from a thread pool, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class GemmCount(TorchDispatchMode):
    """Counts the 2-D GEMMs dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in GEMMS
        return func(*args, **(kwargs or {}))


def _batch(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.4, size=(n, C, P)).astype(np.float32),
            rng.normal(size=(n, F, P)).astype(np.float32))


def _jax_draws(rng, n):
    """npcd_tpu compute_loss's per-example draws at T 50."""
    keys = jax.vmap(lambda i: jax.random.fold_in(rng, i))(jnp.arange(n))
    t = jax.vmap(lambda k: jax.random.randint(k, (), 0, T))(
        jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys))
    cn = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 1), (C, P)))(keys)
    fn = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 2), (F, P)))(keys)
    return (torch.from_numpy(np.asarray(t).astype(np.int64)), torch.from_numpy(np.array(cn)),
            torch.from_numpy(np.array(fn)))


def _port_step(pmodel, state, batch, draws):
    """(loss, {leaf: grad}, GEMMs dispatched in the backward)."""
    pmodel.zero_grad(set_to_none=True)
    loss, _ = pmodel.compute_loss(state, *map(torch.from_numpy, batch), draws=draws)
    with GemmCount() as count:
        loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in pmodel.denoiser.named_parameters()}, \
        count.n


def _remat(pmodel, remat):
    pmodel.denoiser.remat = remat
    return pmodel


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_and_none_give_bitwise_the_same_gradients(dtype):
    _, _, pmodel, state = models(seed=2, port_kw={"dtype": DTYPES[dtype][0]})
    draws = _jax_draws(jax.random.PRNGKey(1), 4)
    (loss, grads, _), (rloss, rgrads, _) = (
        _port_step(_remat(pmodel, remat), state, _batch(1), draws) for remat in (False, True))
    assert all(float(g.abs().max()) > 0 for g in grads.values())
    assert torch.equal(rloss, loss)
    for leaf, g in rgrads.items():
        assert torch.equal(g, grads[leaf]), leaf


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_remat_gradients_match_jax_full_remat(dtype):
    tdt, jdt = DTYPES[dtype]
    jmodel, jstate, pmodel, state = models(
        seed=3, jax_kw={"dtype": jdt, "remat": True, "remat_policy": "full"},
        port_kw={"dtype": tdt, "remat": True, "remat_policy": "full"})
    coords, feats = _batch(2)
    rng = jax.random.PRNGKey(5)

    def loss_fn(params):
        loss, _, _ = jmodel.compute_loss(jstate.replace(params=params), rng,
                                         jnp.asarray(coords), jnp.asarray(feats))
        return loss

    step = jax.jit(jax.value_and_grad(loss_fn)).lower(jstate.params).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want_loss, want = step(jstate.params)
    want = denoiser_state_dict(jax.tree_util.tree_map(np.asarray, want))
    loss, grads, _ = _port_step(pmodel, state, (coords, feats), _jax_draws(rng, 4))
    rel = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=rel)
    assert set(grads) == set(want)
    for leaf, g in grads.items():
        err = float(np.abs(g.numpy() - want[leaf]).max())
        assert err <= rel * float(np.abs(want[leaf]).max()), f"{leaf}: {err}"


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_remat_reruns_three_gemms_a_block(dtype):
    _, _, pmodel, state = models(seed=4, port_kw={"dtype": DTYPES[dtype][0]})
    draws = _jax_draws(jax.random.PRNGKey(2), 4)
    none, full = (_port_step(_remat(pmodel, remat), state, _batch(3), draws)[2]
                  for remat in (False, True))
    assert full - none == 3 * MODEL["layers"]


def test_dots_policy_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="dots"):
        NPCDTransformer(3, 4, 16, 64, 2, 4, remat=True, remat_policy="dots")
    with pytest.raises(NotImplementedError, match="dots"):
        DiffusionModel(**MODEL, remat=True, remat_policy="dots")
    assert DiffusionModel(**MODEL, remat=True, remat_policy="full").denoiser.remat


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        NPCDTransformer(3, 4, 16, 64, 2, 4, remat=True, remat_policy="offload")

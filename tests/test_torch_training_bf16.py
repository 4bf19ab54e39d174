"""Stage-2 training at the CLI's default ``--dtype float16`` (bf16 compute,
f32 master weights, every block recomputed in the backward, tanh GELU), the
PyTorch port against npcd_tpu's DiffusionModel(dtype=bfloat16,
attn_impl="pallas") on the CPU: the denoiser's forward (remat on both
sides); three whole train steps from one bridged train state at step 5
against make_diffusion_train_step(model, FusedAdamWEma) (losses, every
gradient leaf, the state after the steps); that the port's remat recomputes
each block's attention and changes no bit of the gradients; and the CLI
chain train_diffusion (default ``--dtype``) -> generate_samples from the
EMA export, in f32.

The JAX train step runs with remat off: JAX cannot differentiate its
remat'ed blocks when the Pallas kernel runs in interpret mode (the
interpreter's io_callback effects are refused inside checkpoint), and its
remat recomputes a pure function, so it changes no number; the port's step
runs with remat on, and its own remat-off gradients are bitwise the same.

The tiny denoiser: width 128, 2 layers, 2 heads of D 64 in the grouped
[Q|K|V] layout with G = 2, 16 points (17 valid tokens of a 24-token
sequence), 3 coords + 4 feats, output_proj drawn nonzero. The JAX side runs
K1 as its Pallas kernel in interpret mode, compiled with
``xla_allow_excess_precision`` off (so that every bf16 cast rounds), and
its LayerNorms through their XLA path (the Pallas LayerNorm is taken on a
TPU only), whose backward recomputes rhat from the unrounded f32 sum where
the TPU kernel and the port read the bf16 r. The port runs its plain
versions: K1's and K2's bf16 flavours. Other differences: f32 sums in
another order, and torch's GELU rounds once where XLA rounds each of its
operations.

Tolerances (the worst values measured on this CPU in brackets):
  * forward eps (f32 out of output_proj on a bf16 stream): within 2e-2 of
    the output's largest magnitude [5.0e-3], at least 90% of the elements
    within 1e-3 of it [99.4%];
  * loss 1e-3 relative [1.5e-5], grad_norm 1e-2 relative [2.6e-4];
  * every gradient leaf nonzero and within 3e-2 of its largest magnitude
    [1.9e-2: an activation whose bf16 rounding flips moves a product by an
    ulp, 2**-8, and the sums over 64 rows carry it];
  * after the steps, every parameter and EMA within 2 lr x 3 steps (Adam
    moves a parameter by ~lr sign(g), and a near-zero gradient may take
    the other sign) [3.5e-4 of 6e-3], and all but 1% of each leaf's
    elements within lr / 10 [0.3%]; Adam's moments within 3e-2 of their
    scale [5.8e-3]."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from jax.experimental.pallas import tpu as pltpu

from npcd_tpu.models.diffusion import DiffusionModel as JaxDiffusionModel
from npcd_tpu.train.diffusion_training import DiffusionTrainState, make_diffusion_train_step
from npcd_tpu.train.fused_update import FusedAdamWEma as JaxFused
from npcd_tpu.train.fused_update import _replace_adam_state
from npcd_tpu.utils.ema import EmaConfig as JaxEmaConfig
from npcd_tpu_torch.data import PointNeRFDataset
from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel
from npcd_tpu_torch.models.npcd import NPCD
from npcd_tpu_torch.ops.kernels.fused_qkv_attention import fused_qkv_attention
from npcd_tpu_torch.ops.kernels.layer_norm import layer_norm_residual_bwd
from npcd_tpu_torch.train import DiffusionTraining
from npcd_tpu_torch.utils.config import load_config
from npcd_tpu_torch.utils.from_jax import denoiser_state_dict, save_npz, train_state_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, F, P = 3, 4, 16
MODEL = dict(coords_dim=C, feats_dim=F, num_points=P, width=128, layers=2, heads=2,
             qkv_groups=2)
LR, WD = 1e-3, 0.01
EMA = (1.0, 0.9, 0.999, False)
START = 5


def _exact(fn, *args):
    """fn(*args) jitted with XLA's excess precision off, Pallas in interpret
    mode (fn may already be jitted)."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    with pltpu.force_tpu_interpret_mode():
        return jitted.lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})


def _jax_model(remat=True):
    return JaxDiffusionModel(**MODEL, dtype=jnp.bfloat16, remat=remat, attn_impl="pallas")


def _port_model(remat=True):
    return DiffusionModel(**MODEL, dtype=torch.bfloat16, remat=remat)


def _data(n_obj=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_obj, P, C)).astype(np.float32) * 0.4,
            rng.normal(size=(n_obj, P, F)).astype(np.float32))


def _jax_draws(rng, n):
    """npcd_tpu compute_loss's per-example draws (diffusion_model.py:124-140)."""
    keys = jax.vmap(lambda i: jax.random.fold_in(rng, i))(jnp.arange(n))
    t = jax.vmap(lambda k: jax.random.randint(k, (), 0, 1000))(
        jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys))
    cn = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 1), (C, P)))(keys)
    fn = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 2), (F, P)))(keys)
    return (torch.from_numpy(np.asarray(t).astype(np.int64)), torch.from_numpy(np.array(cn)),
            torch.from_numpy(np.array(fn)))


def _jax_state(seed=0, remat=True):
    """npcd_tpu's bf16 train state at step START: random output_proj, Adam
    moments and EMA, normalizers fitted on the data."""
    model = _jax_model(remat)
    fused = JaxFused(LR, WD, ema_cfgs=(JaxEmaConfig.from_tuple(EMA),))
    with pltpu.force_tpu_interpret_mode():  # init runs the forward once
        dstate = model.init(jax.random.PRNGKey(seed))
    coords, feats = _data()
    dstate = model.fit_normalizers(dstate, coords.transpose(2, 0, 1).reshape(C, -1),
                                   feats.transpose(2, 0, 1).reshape(F, -1))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(np.asarray, dstate.params)
    params["output_proj"]["kernel"] = rng.normal(
        scale=0.02, size=params["output_proj"]["kernel"].shape).astype(np.float32)
    like = lambda scale, f=lambda a: a: jax.tree_util.tree_map(
        lambda a: jnp.asarray(f(rng.normal(size=a.shape) * scale).astype(np.float32)), params)
    opt_state = fused.make_tx().init(params)
    opt_state = _replace_adam_state(opt_state, optax.ScaleByAdamState(
        count=jnp.asarray(START, jnp.int32), mu=like(1e-3), nu=like(1e-6, np.abs)))
    ema = jax.tree_util.tree_map(lambda a, d: a + d, jax.tree_util.tree_map(jnp.asarray, params),
                                 like(1e-3))
    state = DiffusionTrainState(
        params=jax.tree_util.tree_map(jnp.asarray, params), opt_state=opt_state,
        ema_params=(ema,), step=jnp.asarray(START, jnp.int32),
        coords_norm=dstate.coords_norm, feats_norm=dstate.feats_norm)
    return model, fused, state


def _bridged(state):
    get = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return train_state_from_jax(get(state.params), get(state.opt_state),
                                [get(e) for e in state.ema_params], state.step,
                                state.coords_norm, state.feats_norm)


def _batch(i):
    rng = np.random.default_rng(100 + i)
    return {"coords": rng.normal(size=(4, C, P)).astype(np.float32) * 0.4,
            "feats": rng.normal(size=(4, F, P)).astype(np.float32)}


def _scaled_err(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / float(np.abs(want).max())


def test_bf16_denoiser_forward_matches_jax():
    model, _, state = _jax_state(seed=2)
    rng = np.random.default_rng(7)
    coords = rng.normal(size=(2, C, P)).astype(np.float32)
    feats = rng.normal(size=(2, F, P)).astype(np.float32)
    t = np.array([999, 17], np.int32)
    apply = lambda p, c, f, tt: model.denoiser.apply({"params": p}, c, f, tt)
    args = (state.params, jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(t))
    want = _exact(apply, *args)(*args)
    port = _port_model().denoiser
    port.load_state_dict({k: torch.tensor(v) for k, v in
                          denoiser_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                     state.params)).items()})
    launches = fused_qkv_attention.launches_bf16
    with torch.no_grad():
        got = port(torch.from_numpy(coords), torch.from_numpy(feats), torch.from_numpy(t).long())
    assert fused_qkv_attention.launches_bf16 == launches  # the CPU runs the plain version
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        w = np.asarray(w)
        d = np.abs(g.numpy() - w)
        assert d.max() <= 2e-2 * np.abs(w).max(), d.max() / np.abs(w).max()
        assert (d <= 1e-3 * np.abs(w).max()).mean() >= 0.9


def test_three_bf16_train_steps_match_jax(tmp_path):
    model, fused, state = _jax_state(remat=False)
    step_fn = make_diffusion_train_step(model, fused, fused.ema_cfgs, donate=False)
    coords, feats = _data()
    trainer = DiffusionTraining(str(tmp_path), _port_model(), PointNeRFDataset(coords, feats),
                                batch_size=4, base_learning_rate=LR, weight_decay=WD,
                                max_iterations=3, use_ema=True, ema_params=[EMA], seed=3,
                                device="cpu", save_checkpoint_interval_min=1e9,
                                weights_only_interval=10**9, verbose=False)
    trainer.load_bridged_state(_bridged(state))

    def loss_fn(params, batch, rng):
        return model.compute_loss(state.diffusion_state(params), rng, batch["coords"],
                                  batch["feats"])[0]

    base = jax.random.PRNGKey(11)
    jbatch = lambda b: {k: jnp.asarray(v) for k, v in b.items()}
    rng0 = jax.random.fold_in(base, START)
    compiled_step = _exact(step_fn, state, jbatch(_batch(0)), rng0)
    compiled_grad = _exact(jax.grad(loss_fn), state.params, jbatch(_batch(0)), rng0)
    launches = layer_norm_residual_bwd.launches_bf16
    for i in range(3):
        rng = jax.random.fold_in(base, START + i)
        batch = _batch(i)
        want_grads = denoiser_state_dict(jax.tree_util.tree_map(
            np.asarray, compiled_grad(state.params, jbatch(batch), rng)))
        state, metrics = compiled_step(state, jbatch(batch), rng)
        got = trainer.train_step(batch, draws=_jax_draws(rng, 4))
        np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-3)
        np.testing.assert_allclose(float(got["grad_norm"]), float(metrics["grad_norm"]),
                                   rtol=1e-2)
        grads = trainer.flat.as_dict(trainer.flat.grads)
        assert set(grads) == set(want_grads)
        for name, g in grads.items():
            assert float(g.abs().max()) > 0, f"{name} got no gradient"
            err = _scaled_err(g.numpy(), want_grads[name])
            assert err <= 3e-2, f"step {i} grad {name}: {err}"
    assert layer_norm_residual_bwd.launches_bf16 == launches  # plain versions on the CPU
    assert trainer.step == int(state.step) == START + 3
    want = _bridged(state)
    assert trainer.adam.count == want["count"]
    for name, buf, tree in [("params", trainer.flat.params, want["params"]),
                            ("ema", trainer.emas[0], want["emas"][0])]:
        for leaf, v in trainer.flat.as_dict(buf).items():
            err = np.abs(v.numpy() - tree[leaf])
            assert err.max() <= 6 * LR, f"{name} {leaf}: {err.max()}"
            assert (err > LR / 10).mean() <= 1e-2, f"{name} {leaf}"
    for name, buf, tree in [("mu", trainer.adam.mu, want["mu"]),
                            ("nu", trainer.adam.nu, want["nu"])]:
        for leaf, v in trainer.flat.as_dict(buf).items():
            assert _scaled_err(v.numpy(), tree[leaf]) <= 3e-2, f"{name} {leaf}"


def test_remat_recomputes_attention_and_changes_no_gradient(monkeypatch):
    """remat=True runs each block's forward again in the backward (K1f twice
    per layer) and gives bitwise the same gradients as remat=False."""
    from npcd_tpu_torch.ops.kernels import fused_qkv_attention as k1

    calls = []
    fwd = k1.fused_qkv_attention_fwd
    monkeypatch.setattr(k1, "fused_qkv_attention_fwd",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    rng = np.random.default_rng(4)
    coords = torch.from_numpy(rng.normal(size=(2, C, P)).astype(np.float32))
    feats = torch.from_numpy(rng.normal(size=(2, F, P)).astype(np.float32))
    t = torch.tensor([3, 600])
    grads, counts = [], []
    for remat in (True, False):
        model = _port_model(remat).denoiser
        model.init_seeded(torch.Generator().manual_seed(0))
        calls.clear()
        eps_c, eps_f = model(coords, feats, t)
        (eps_c.square().sum() + eps_f.square().sum()).backward()
        counts.append(len(calls))
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert counts == [2 * MODEL["layers"], MODEL["layers"]]
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n


def _run(args, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def test_cli_default_dtype_trains_then_generates_from_the_ema_export(tmp_path):
    cfg = os.path.join(ROOT, "configs/npcd_synthetic_tiny.yaml")
    config = load_config(cfg)
    m = config["model"]
    npcd = NPCD.from_config(config)
    rng = np.random.default_rng(0)
    flat = {f"pointnerf.{k}": v.numpy() for k, v in npcd.pointnerf.state_dict().items()}
    flat["latents.coords_table"] = rng.uniform(-0.5, 0.5, (m["n_obj"], m["num_points"], 3))
    flat["latents.feats_table"] = rng.normal(size=(m["n_obj"], m["num_points"], m["feats_dim"]))
    save_npz(str(tmp_path / "pointnerf.npz"), flat)
    out = tmp_path / "diffusion"
    _run(["npcd_tpu_torch.train_diffusion", "--config", cfg, "--output", str(out),
          "--pointnerf_weights", str(tmp_path / "pointnerf.npz"), "--device", "cpu",
          "--no_tensorboard"], tmp_path)
    steps = config["diffusion_training"]["max_iterations"]
    export = out / "weights_only_checkpoints_dir" / (
        f"npcd-ema_power1_0min0_9999max0_9999buffers0-iter-{steps:09d}.npz")
    assert export.exists()
    with np.load(export) as z:  # the f32 master weights
        assert all(z[k].dtype == np.float32 for k in z.files if k.startswith("diffusion."))
    _run(["npcd_tpu_torch.generate_samples", "--config", cfg, "--out", str(tmp_path / "gen"),
          "--weights", str(export), "--num", "2", "--batch-size", "2", "--device", "cpu"],
         tmp_path)
    with np.load(tmp_path / "gen" / "samples.npz") as z:
        assert z["coords"].shape == (2, 3, m["num_points"])
        assert np.isfinite(z["coords"]).all() and np.isfinite(z["feats"]).all()

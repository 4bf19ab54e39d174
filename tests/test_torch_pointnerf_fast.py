"""Stage-1 training with the fast config's render settings (bf16 compute,
a shading budget, remat off: configs/npcd_srncars_fast.yaml) in the
PyTorch port against npcd_tpu, on the CPU, on configs/npcd_synthetic_tiny.yaml
(8 objects x 32 points x 8 features, 2 views of 16x16, 32 rays x 24 depth
samples, 8 shading slots, k 8) with train_rays = ray_subsamples = 32.

The budget packs an instance's valid slots ordered by sample index and then
by ray, so the dropped slots of an overflowing budget depend on the ray
order: the port is given npcd_tpu's selection order through the
``ray_scores`` draw (scores that sort into the order of npcd_tpu's
pred["ray_sel"] for the same key), and pred is compared in that order. The
other draws are injected into both sides as in test_torch_pointnerf_training.
Budgets: 32 slots, below the valid count of most instances (16-75 here), so
the overflow path runs, and 96, above every count.

npcd_tpu runs its XLA path on the CPU (one-hot gathers, the aggregation
MLP through apply_mlp, autodiff with bf16 cotangents and the bf16 slope),
compiled with ``xla_allow_excess_precision`` off so that its bf16 casts
round; the port runs its plain versions, which follow the TPU kernels'
rounding points (the w-sum in f32, the backward's cotangents in f32).
Tolerances, with the worst values measured on this CPU in brackets: pred
channels/mask/depth within 2e-2 [1.9e-5]; each loss within 1e-2 relative
[1.2e-5]; each gradient leaf within 5e-2 of its norm in the L2 sense
[2.9e-2] and, element by element, within 1e-1 of its largest magnitude
[7.0e-2: channel_net's hidden biases, whose gradients sum a few hundred
bf16 cotangents of both signs on npcd_tpu's side]; after 3 steps, the
parameters and the Adam moments as test_fast_three_train_steps_match_jax
states."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_pointnerf_training import (BATCHES, LR, WEIGHTS, _assert_margins,  # noqa: E402
                                           _draws, _jax_batch, _leaf_close)

from npcd_tpu.losses import PointNeRFLossWeights as JaxWeights  # noqa: E402
from npcd_tpu.losses import pointnerf_loss as jax_loss  # noqa: E402
from npcd_tpu.models.pointnerf import aggregator as jax_agg  # noqa: E402
from npcd_tpu.train.pointnerf_training import (PointNeRFTrainState,  # noqa: E402
                                               make_pointnerf_optimizer,
                                               make_pointnerf_train_step)
from npcd_tpu.utils.builders import build_pointnerf as jax_build_pointnerf  # noqa: E402
from npcd_tpu.utils.config import load_config as jax_load_config  # noqa: E402
from npcd_tpu_torch.data import SyntheticNPCTrain  # noqa: E402
from npcd_tpu_torch.losses import PointNeRFLossWeights, pointnerf_loss  # noqa: E402
from npcd_tpu_torch.models.pointnerf.aggregator import gather_rows, pack_rows  # noqa: E402
from npcd_tpu_torch.models.pointnerf.pointnerf import budget_ranks  # noqa: E402
from npcd_tpu_torch.train import PointNeRFTraining  # noqa: E402
from npcd_tpu_torch.utils.builders import build_pointnerf  # noqa: E402
from npcd_tpu_torch.utils.config import load_config  # noqa: E402
from npcd_tpu_torch.utils.from_jax import pointnerf_train_state_from_jax  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs/npcd_synthetic_tiny.yaml")
FAST = os.path.join(ROOT, "configs/npcd_srncars_fast.yaml")
BUDGETS = (32, 96)
EXACT = {"xla_allow_excess_precision": False}


def _config(loader, budget):
    cfg = loader(CONFIG)
    cfg["render_config"] = {**cfg["render_config"], "train_rays": 32,
                            "compute_dtype": "bfloat16", "shading_budget": budget}
    return cfg


def _exact(fn, *args):
    """fn(*args) jitted with XLA's excess precision off."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


@pytest.fixture(scope="module")
def setup():
    """npcd_tpu's tiny PointNeRF (random feats table, the dataset's coords)
    with the fast render settings per budget, and its bridged state."""
    ds = SyntheticNPCTrain(**load_config(CONFIG)["dataset_kwargs"])
    jmodels = {b: jax_build_pointnerf(_config(jax_load_config, b)) for b in BUDGETS}
    jm = jmodels[BUDGETS[0]]
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(np.asarray, jm.set_all_coords(params, ds.get_all_coords()))
    rng = np.random.default_rng(1)
    f = jm.opts.feat_dim
    table = params["feats_table"].copy()
    table[..., :f] = rng.normal(scale=0.5, size=table[..., :f].shape)
    table[..., f:] = rng.normal(scale=0.2, size=table[..., f:].shape)
    params["feats_table"] = table
    tx = make_pointnerf_optimizer(LR)
    bridged = pointnerf_train_state_from_jax(params, tx.init(params), 0)
    return {"jmodels": jmodels, "params": params, "ds": ds, "tx": tx, "bridged": bridged}


def _port_model(setup, budget):
    model = build_pointnerf(_config(load_config, budget), with_tables=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in setup["bridged"]["params"].items()})
    return model


def _batch(setup, i, seed):
    o = setup["jmodels"][BUDGETS[0]].opts
    batch = setup["ds"].batch(BATCHES[i])
    draws = _draws(seed, len(BATCHES[i]), batch["extrinsics"].shape[1], o)
    _assert_margins(o, setup["ds"].get_all_coords()[BATCHES[i]], batch, draws)
    return batch, draws


def _jax_loss_fn(jmodel, jbatch, key):
    def loss_fn(params):
        pred, aux = jmodel.forward(params, jbatch["obj_idx"], jbatch["intrinsics"],
                                   jbatch["extrinsics"], rng=key, train=True,
                                   draws=jbatch["draws"])
        loss, sub = jax_loss(jbatch, pred, aux, jmodel.opts, JaxWeights(*WEIGHTS),
                             presampled_images=True)
        return loss, (pred, sub)
    return loss_fn


def _grad_close(got, want, what):
    """A gradient leaf against npcd_tpu's (see the module doc)."""
    want = np.asarray(want)
    assert np.linalg.norm(got - want) <= 5e-2 * np.linalg.norm(want), what
    _leaf_close(got, want, 1e-1, what)


def _ray_scores(sel):
    """Scores [I, R] whose descending order is npcd_tpu's selection sel
    [B, V, R] (its valid rays come first, in its order)."""
    sel = np.asarray(sel).reshape(-1, sel.shape[-1])
    scores = np.zeros(sel.shape, np.float32)
    np.put_along_axis(scores, sel, 1 - np.arange(sel.shape[1]) / (sel.shape[1] + 1), axis=1)
    return scores


def _jax_sel(jmodel, params, jbatch, key):
    """npcd_tpu's ray selection for the key (it depends only on the key and
    the valid rays, not on the MLPs)."""
    pred, _ = jmodel.forward(params, jbatch["obj_idx"], jbatch["intrinsics"],
                             jbatch["extrinsics"], rng=key, train=True, draws=jbatch["draws"])
    return np.asarray(pred["ray_sel"])


def _forward(model, batch, draws, scores):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return model(t(batch["obj_idx"]).long(), t(batch["intrinsics"]), t(batch["extrinsics"]),
                 t(draws["pixel_idx"]),
                 draws={"feats_eps": t(draws["feats_eps"]),
                        "depth_jitter": t(draws["depth_jitter"]), "ray_scores": t(scores)})


def test_budget_ranks_match_jax():
    """The counting-sort ranks equal npcd_tpu's formula (pointnerf.py:415-427,
    evaluated in jnp) and its stable-argsort reference bitwise."""
    rng = np.random.default_rng(0)
    i_dim, r_dim, m = 4, 13, 17
    for trial in range(5):
        mask = rng.random((i_dim, r_dim, m)) < rng.uniform(0.05, 0.9)
        mask_i = jnp.asarray(mask.astype(np.int32))
        cnt_j = jnp.sum(mask_i, axis=1)
        offset_j = jnp.cumsum(cnt_j, axis=1) - cnt_j
        prefix_r = jnp.cumsum(mask_i, axis=1) - mask_i
        n_valid = jnp.sum(cnt_j, axis=1)
        inv = 1 - mask_i.reshape(i_dim, -1)
        want = jnp.where(jnp.asarray(mask).reshape(i_dim, -1),
                         (offset_j[:, None, :] + prefix_r).reshape(i_dim, -1),
                         n_valid[:, None] + jnp.cumsum(inv, axis=1) - inv)
        key = np.where(mask.reshape(i_dim, -1), np.tile(np.arange(m), r_dim)[None], m)
        order = np.argsort(key, axis=1, kind="stable")
        rank, got_valid = budget_ranks(torch.from_numpy(mask))
        np.testing.assert_array_equal(rank.numpy(), np.asarray(want), err_msg=f"trial {trial}")
        np.testing.assert_array_equal(rank.numpy(), np.argsort(order, axis=1, kind="stable"))
        np.testing.assert_array_equal(got_valid.numpy(), mask.sum((1, 2)))


def test_pack_and_gather_rows_match_jax():
    """pack_rows and the masked gather_rows against npcd_tpu's one-hot
    matmul forms, values and gradients within 1e-6 (f32; the one-hot sums
    add exact zeros); rows past the budget send exactly 0 to the row they
    are clamped to."""
    rng = np.random.default_rng(1)
    i_dim, r_dim, m, cap, c = 3, 11, 9, 40, 5
    mask = rng.random((i_dim, r_dim, m)) < 0.4
    rank, _ = budget_ranks(torch.from_numpy(mask))
    assert int(rank.max()) >= cap  # some slots overflow the budget
    table = rng.standard_normal((i_dim, r_dim * m, 4)).astype(np.float32)
    packed = rng.standard_normal((i_dim, cap, c)).astype(np.float32)
    gp = rng.standard_normal((i_dim, cap, 4)).astype(np.float32)
    gf = rng.standard_normal((i_dim, r_dim * m, c)).astype(np.float32)
    rank_j = jnp.asarray(rank.numpy())

    def jax_fns(tab, pk):
        return (jax_agg.pack_rows(tab, rank_j, cap),
                jnp.where((rank_j < cap)[..., None],
                          jax_agg.gather_rows(pk, jnp.minimum(rank_j, cap - 1)), 0.0))

    (want_p, want_f), vjp = jax.vjp(jax_fns, jnp.asarray(table), jnp.asarray(packed))
    want_dt, want_dp = vjp((jnp.asarray(gp), jnp.asarray(gf)))
    tab = torch.from_numpy(table).requires_grad_(True)
    pk = torch.from_numpy(packed).requires_grad_(True)
    got_p, got_f = pack_rows(tab, rank, cap), gather_rows(pk, rank)
    torch.autograd.backward([got_p, got_f], [torch.from_numpy(gp), torch.from_numpy(gf)])
    for got, want in ((got_p, want_p), (got_f, want_f), (tab.grad, want_dt), (pk.grad, want_dp)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # the clamped rows: packed row cap-1's gradient is its own slot's only
    own = (rank == cap - 1).numpy()
    np.testing.assert_array_equal(
        pk.grad[:, cap - 1].numpy(),
        np.stack([gf[i][own[i]].sum(0) for i in range(i_dim)]))


def test_budget_covering_every_slot_matches_dense(setup):
    """bf16 with a budget above every instance's valid count reproduces the
    dense bf16 path (npcd_tpu's test_shading_budget_matches_dense): the
    same points get the same neighbours and the same per-pair arithmetic,
    so pred is bitwise equal; the gradients sum the same terms in another
    order of points: within 1e-2 of each leaf's scale (an ulp of bf16 at
    the final rounding of dW) [9.3e-4]."""
    batch, draws = _batch(setup, 0, seed=10)
    scores = np.random.default_rng(2).uniform(size=(8, 32)).astype(np.float32)
    outs = []
    for budget in (96, None):
        model = _port_model(setup, 96)
        model.cfg = dataclasses.replace(model.cfg, shading_budget=budget)
        pred, aux = _forward(model, batch, draws, scores)
        (pred["channels"] ** 2).sum().backward()
        outs.append((pred, {k: p.grad.clone() for k, p in model.named_parameters()}))
    (pb, gb), (pd, gd) = outs
    for key in ("channels", "mask", "depth"):
        torch.testing.assert_close(pb[key], pd[key], rtol=0, atol=0, msg=key)
    for name, g in gd.items():
        assert float(g.abs().max()) > 0, name
        _leaf_close(gb[name].numpy(), g.numpy(), 1e-2, name)


@pytest.mark.parametrize("budget", BUDGETS)
def test_fast_step_matches_jax(setup, budget):
    """Forward, the three losses and every gradient leaf of one step."""
    jmodel = setup["jmodels"][budget]
    batch, draws = _batch(setup, 1, seed=11)
    jbatch = _jax_batch(batch, draws)
    key = jax.random.PRNGKey(3)
    (_, (jpred, jsub)), jgrad = _exact(
        jax.value_and_grad(_jax_loss_fn(jmodel, jbatch, key), has_aux=True), setup["params"])
    model = _port_model(setup, budget)
    assert not model.cfg.resolved_train_remat()
    pred, aux = _forward(model, batch, draws, _ray_scores(jpred["ray_sel"]))
    np.testing.assert_array_equal(pred["ray_sel"].numpy(), np.asarray(jpred["ray_sel"]))
    for key_ in ("channels", "mask", "depth"):
        np.testing.assert_allclose(pred[key_].detach().numpy(), np.asarray(jpred[key_]), rtol=0,
                                   atol=2e-2, err_msg=key_)
    loss, sub = pointnerf_loss({"images": torch.from_numpy(np.asarray(jbatch["images"]))}, pred,
                               aux, model.opts, PointNeRFLossWeights(*WEIGHTS))
    for k in jsub:
        assert float(jsub[k]) > 0, k
        np.testing.assert_allclose(float(sub[k].detach()), float(jsub[k]), rtol=1e-2, err_msg=k)
    loss.backward()
    want = pointnerf_train_state_from_jax(jax.tree_util.tree_map(np.asarray, jgrad),
                                          setup["tx"].init(setup["params"]), 0)["params"]
    for name, p in model.named_parameters():
        assert float(p.grad.abs().max()) > 0, f"{name} got no gradient"
        _grad_close(p.grad.numpy(), want[name], name)


@pytest.mark.parametrize("budget", BUDGETS)
def test_fast_three_train_steps_match_jax(tmp_path, setup, budget):
    jmodel, tx = setup["jmodels"][budget], setup["tx"]
    params = jax.tree_util.tree_map(jnp.asarray, setup["params"])
    state = PointNeRFTrainState(params=params, opt_state=tx.init(params),
                                step=jnp.zeros((), jnp.int32))
    step_fn = make_pointnerf_train_step(jmodel, tx, JaxWeights(*WEIGHTS), donate=False,
                                        presampled_images=True)
    data = [_batch(setup, i, seed=20 + i) for i in range(3)]
    trainer = PointNeRFTraining(str(tmp_path), build_pointnerf(_config(load_config, budget),
                                                               with_tables=True),
                                setup["ds"], batch_size=4, base_learning_rate=LR, max_epochs=1,
                                loss_weights=PointNeRFLossWeights(*WEIGHTS), seed=0,
                                device="cpu", save_checkpoint_interval_min=1e9, verbose=False)
    trainer.load_bridged_state(setup["bridged"])
    compiled = None
    for i, (batch, draws) in enumerate(data):
        jbatch, key = _jax_batch(batch, draws), jax.random.PRNGKey(i)
        sel = _jax_sel(jmodel, state.params, jbatch, key)
        if compiled is None:
            compiled = step_fn.lower(state, jbatch, key).compile(compiler_options=EXACT)
        state, metrics = compiled(state, jbatch, key)
        got = trainer.train_step(batch, {**draws, "ray_scores": _ray_scores(sel)})
        for k in metrics:
            np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-2, err_msg=k)
    get = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    want = pointnerf_train_state_from_jax(get(state.params), get(state.opt_state), state.step)
    assert trainer.step == want["step"] == 3
    for name, p in trainer.model.named_parameters():
        # Adam moves each parameter by ~lr per step whatever its gradient's
        # size, so a near-zero gradient of the other sign moves it up to 2 lr
        # apart per step: every parameter within 6 lr [3.2e-3], all but 2% of
        # each leaf within 1e-3 [1.2%: 3 of local_field.7's 256 biases]; the
        # moments within 5e-2 of their scale [4.4e-2]
        err = np.abs(p.detach().numpy() - want["params"][name])
        assert err.max() <= 6 * LR, f"{name}: {err.max()}"
        assert (err > 1e-3).mean() <= 2e-2, f"{name}: {(err > 1e-3).mean()}"
        st = trainer.optimizer.state[p]
        _leaf_close(st["exp_avg"].numpy(), want["mu"][name], 5e-2, f"mu {name}")
        _leaf_close(st["exp_avg_sq"].numpy(), want["nu"][name], 5e-2, f"nu {name}")
    np.testing.assert_array_equal(trainer.model.tables.coords_table.numpy(),
                                  setup["params"]["coords_table"])


def test_render_bf16_matches_jax(setup):
    """render() honours compute_dtype: the bf16 eval render of two clouds
    against npcd_tpu's bf16 render (its XLA path), channels within 2e-2."""
    jmodel = setup["jmodels"][BUDGETS[0]]
    ds = setup["ds"]
    batch = ds.batch([0, 1])
    coords = ds.get_all_coords()[[0, 1]].astype(np.float32)
    feats = setup["params"]["feats_table"][[0, 1], :, :8].astype(np.float32)
    want = _exact(lambda p, c, f, e, i: jmodel.render(p, c, f, e, i, resolution=16),
                  setup["params"], jnp.asarray(coords), jnp.asarray(feats),
                  jnp.asarray(batch["extrinsics"]), jnp.asarray(batch["intrinsics"]))
    model = _port_model(setup, BUDGETS[0])
    assert model.cfg.compute_dtype == torch.bfloat16
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got = model.render(t(coords), t(feats), t(batch["extrinsics"]), t(batch["intrinsics"]),
                       resolution=16)
    valid = np.asarray(want["ray_valid"])
    np.testing.assert_array_equal(got["ray_valid"].numpy(), valid)
    assert 0.05 < valid.mean() < 0.95
    np.testing.assert_allclose(got["channels"].numpy(), np.asarray(want["channels"]), rtol=0,
                               atol=2e-2)


def test_fast_config_builds_and_bridges():
    """configs/npcd_srncars_fast.yaml builds in the port (bf16, budget 1792,
    one chunk of 400 instances, remat off), and npcd_tpu's train state for
    that config (2 objects instead of 2347) carries over: same parameter
    names and shapes, Adam's moments attached."""
    model = build_pointnerf(load_config(FAST), with_tables=True)
    cfg = model.cfg
    assert (cfg.compute_dtype, cfg.shading_budget, cfg.train_instance_chunk) == (
        torch.bfloat16, 1792, 400)
    assert not cfg.resolved_train_remat() and model.tables.feats_table.shape == (2347, 512, 64)
    jcfg = jax_load_config(FAST)
    jcfg["model"]["n_obj"] = 2
    jmodel = jax_build_pointnerf(jcfg)
    assert jmodel.cfg.compute_dtype == jnp.bfloat16 and not jmodel.cfg.resolved_train_remat()
    params = jax.tree_util.tree_map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0)))
    tx = make_pointnerf_optimizer(LR)
    bridged = pointnerf_train_state_from_jax(params, tx.init(params), 7)
    cfg = load_config(FAST)
    cfg["model"]["n_obj"] = 2
    trainer_model = build_pointnerf(cfg, with_tables=True)
    trainer_model.load_state_dict({k: torch.from_numpy(v) for k, v in bridged["params"].items()})
    for name, v in trainer_model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), bridged["params"][name], err_msg=name)
    assert set(bridged["mu"]) == {k for k, _ in trainer_model.named_parameters()}
    with pytest.raises(ValueError, match="compute_dtype"):
        cfg["render_config"]["compute_dtype"] = "float16"
        build_pointnerf(cfg)


def test_fast_cli_trains_and_resumes(tmp_path):
    """python -m npcd_tpu_torch.train_pointnerf's code path with the fast
    render settings on the tiny config (CPU): 2 steps, the checkpoint and
    the bridged export; a resumed run equals an uninterrupted one bitwise."""
    from npcd_tpu_torch.train_diffusion import load_pointnerf_weights
    from npcd_tpu_torch.train_pointnerf import parse_args, train

    def run(out, epochs):
        cfg = _config(load_config, BUDGETS[0])
        cfg["pointnerf_training"]["max_epochs"] = epochs
        return train(parse_args(["--config", CONFIG, "--output", str(out), "--device", "cpu",
                                 "--no_tensorboard"]), cfg)

    full = run(tmp_path / "full", 2)
    assert full.model.cfg.compute_dtype == torch.bfloat16 and full.step == 4
    run(tmp_path / "cut", 1)
    resumed = run(tmp_path / "cut", 2)
    a, b = full.state_dict(), resumed.state_dict()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    latents, pointnerf = load_pointnerf_weights(full.weights_only_path(4), 32, 8)
    assert len(latents) == 8 and set(pointnerf) == {
        f"pointnerf.{k}" for k in full.model.mlp_state_dict()}

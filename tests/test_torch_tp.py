"""Tensor parallelism of the PyTorch port (npcd_tpu_torch/parallel/tp.py,
tp_step.py, the denoiser built with tp, DiffusionTraining(tp=)) against
npcd_tpu's shard_map TP step on its fake CPU devices.

  * shards: the port's shard_denoiser_state on each (data, model) rank of
    a (2, 2) mesh, at width 256, 4 heads, qkv_groups 2, tp 2, bitwise the
    addressable shard that npcd_tpu's shard_train_state puts on that device,
    for the parameters, Adam's moments and the EMA;
  * steps: three DiffusionTraining(tp=2).train_steps from
    tests/test_torch_training's bridged train state (width 128, 2 heads of
    D 64 in 2 groups: one head a model rank; output_proj nonzero), with
    JAX's draws replayed and a clip that is active, at world 2 (dp 1 x tp 2,
    also with block remat on both sides) and world 4 (dp 2 x tp 2), against
    npcd_tpu's step on the global batch
    (make_diffusion_train_step with FusedAdamWEma(clip_max_norm=)) in f32,
    with its einsum attention and (world 2) with its Pallas kernel in
    interpret mode (the port runs K1's plain version on the CPU), at
    npcd_tpu's TP tolerances (tests/test_tp.py): loss rel 1e-5, grad_norm rel
    1e-4, the parameters and EMAs after unsharding rtol 1e-4 / atol 1e-6;
    the same against the port's own tp=1 step in one process; the ranks'
    replicated leaves bitwise equal;
  * npcd_tpu's own TP step (make_tp_diffusion_train_step): its shard_map
    runs with check_vma=False, where the transpose of the row-parallel psum
    is a psum, so every gradient upstream of a row-parallel projection
    comes out about tp times too large (ln_1, c_qkv, c_fc: x2 at tp 2;
    time_embed x4). Its own test does not see it: it starts output_proj at
    zero, so only output_proj has a gradient, and Adam is nearly scale
    free. Here its grad_norm misses its single-device step's by ~2%, and it
    equals the port's step with the planted fault (b) within the
    tolerances above;
  * bf16 with block remat (train_diffusion's default) at tp 2 against one
    process with tp 2's split products (tests/tp_split_control.py) at those
    tolerances, which the plain one-process bf16 step misses;
  * planted faults, each outside those tolerances: (a) grad_norm from the
    local buffer, (b) torch.distributed.nn's all_reduce as the "g" operator
    (its backward sums again), (c) the data mean over the world;
  * the loop: a 2-rank DiffusionTraining(tp=2) run of 3 steps writes one
    checkpoint and one set of exports at full shapes, bitwise the shards it
    gathered; a tp=1 trainer restores it and a tp=2 trainer a tp=1 run's,
    both at step 3;
  * npcd_tpu's ValueErrors (tp not dividing qkv_groups, heads or the world)
    and train_diffusion --tp 2 on two gloo ranks, whose export equals the
    port's one-process run within the DP tolerance.

The ranks are tests/torch_parallel_worker.py's gloo groups (subprocesses,
one torch thread each)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec

from npcd_tpu.models.diffusion import DiffusionModel as JaxDiffusionModel
from npcd_tpu.parallel.tp_step import make_tp_diffusion_train_step, shard_train_state
from npcd_tpu.train.diffusion_training import DiffusionTrainState, make_diffusion_train_step
from npcd_tpu.train.diffusion_training import DiffusionTraining as JaxDiffusionTraining
from npcd_tpu.train.fused_update import FusedAdamWEma as JaxFused
from npcd_tpu.train.fused_update import _get_adam_state, _replace_adam_state
from npcd_tpu_torch.data import PointNeRFDataset
from npcd_tpu_torch.models.diffusion.diffusion_model import DiffusionModel
from npcd_tpu_torch.models.diffusion.transformer import NPCDTransformer
from npcd_tpu_torch.parallel import (Mesh, TPLayout, denoiser_param_specs, shard_denoiser_state,
                                     unshard_denoiser_state)
from npcd_tpu_torch.train import DiffusionTraining
from npcd_tpu_torch.utils.from_jax import denoiser_state_dict, save_npz
from test_torch_training import (EMA, LR, MODEL, START, WD, C, F, _bridged, _data, _jax_draws,
                                 _jax_state)
from test_torch_training import P as POINTS
from torch_parallel_worker import assert_one_writer, run_ranks, start_group
from tp_split_control import split_products

B = 8  # the global batch
STEPS = 3
CLIP = 0.5  # below every step's grad_norm: the clip scales every update
# (world of the port's ranks, npcd_tpu's attention, the ranks' job) of each
# comparison; "remat": both sides with block remat (the CLI's bf16 default),
# whose backward runs each block's forward reduces again
CASES = [(2, "einsum", "steps"), (2, "pallas", "steps"), (4, "einsum", "steps"),
         (2, "einsum-remat", "remat")]
FAULTS = ("norm", "g", "mean")
BF16 = {**MODEL, "dtype": torch.bfloat16, "remat": True}  # train_diffusion's default --dtype


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _global_batch(i):
    rng = np.random.default_rng(300 + i)
    return {"coords": rng.normal(size=(B, C, POINTS)).astype(np.float32) * 0.4,
            "feats": rng.normal(size=(B, F, POINTS)).astype(np.float32)}


def _clip_state():
    """test_torch_training's JAX state under FusedAdamWEma(clip_max_norm=
    CLIP) (its optax chain, clip first)."""
    _, fused, state = _jax_state()
    fused = JaxFused(LR, WD, clip_max_norm=CLIP, ema_cfgs=fused.ema_cfgs)
    opt = _replace_adam_state(fused.make_tx().init(state.params),
                              _get_adam_state(state.opt_state))
    return fused, state.replace(opt_state=opt)


def _jax_mesh(dp, tp=2):
    return JaxMesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp), ("data", "model"))


def _jax_steps(impl, batches, rngs, tp_world=None):
    """npcd_tpu's step on the global batch (its shard_map TP step over a
    (tp_world // 2, 2) mesh with ``tp_world``), STEPS times -> each step's
    metrics and the bridged (full) state after them. ``impl`` "einsum-remat":
    the einsum attention with block remat."""
    from jax.experimental.pallas import tpu as pltpu

    remat = impl.endswith("-remat")
    impl = impl.removesuffix("-remat")
    model = JaxDiffusionModel(**MODEL, attn_impl=impl, remat=remat)
    fused, state = _clip_state()
    put = jnp.asarray
    if tp_world is None:
        step = make_diffusion_train_step(model, fused, fused.ema_cfgs, donate=False)
    else:
        mesh = _jax_mesh(tp_world // 2)
        step = make_tp_diffusion_train_step(model, fused, fused.ema_cfgs, mesh, donate=False)
        state = shard_train_state(state, fused.make_tx(), mesh)
        put = lambda v: jax.device_put(jnp.asarray(v), NamedSharding(mesh, PartitionSpec("data")))
    metrics = []
    with pltpu.force_tpu_interpret_mode() if impl == "pallas" else _nothing():
        for batch, rng in zip(batches, rngs):
            state, m = step(state, {k: put(v) for k, v in batch.items()}, rng)
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _bridged(state)


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    _, state = _clip_state()
    bridged = _bridged(state)
    batches = [_global_batch(i) for i in range(STEPS)]
    base = jax.random.PRNGKey(13)
    rngs = [jax.random.fold_in(base, START + i) for i in range(STEPS)]
    draws = [tuple(d.numpy() for d in _jax_draws(r, B)) for r in rngs]
    coords, feats = _data()
    kw = dict(model_kw=MODEL, bridged=bridged, coords=coords, feats=feats, batches=batches,
              draws=draws, lr=LR, wd=WD, ema=EMA, clip=CLIP)

    # a tp=1 run of 3 steps, whose checkpoint the 2-rank group restores at tp 2
    tp1 = _trainer(tmp / "tp1", 3)()
    (tmp / "g2").mkdir()
    (tmp / "g4").mkdir()
    groups = {
        2: start_group({
            "steps": ("tp_steps", dict(kw, out_dir=str(tmp / "w2"))),
            "remat": ("tp_steps", dict(kw, model_kw={**MODEL, "remat": True},
                                       out_dir=str(tmp / "w2-remat"))),
            "bf16": ("tp_steps", dict(kw, model_kw=BF16, out_dir=str(tmp / "w2-bf16"))),
            **{f"fault_{f}": ("tp_steps", dict(kw, out_dir=str(tmp / f"f_{f}"), fault=f))
               for f in FAULTS},
            "run": ("tp_run", dict(model_kw=MODEL, coords=coords, feats=feats, lr=LR, wd=WD,
                                   ema=EMA, out_dir=str(tmp / "run"), tp1_dir=str(tmp / "tp1"),
                                   max_iterations=3))}, tmp / "g2", world=2),
        4: start_group({"steps": ("tp_steps", dict(kw, out_dir=str(tmp / "w4")))}, tmp / "g4",
                       world=4)}

    want = {impl: _jax_steps(impl, batches, rngs)
            for impl in ("einsum", "pallas", "einsum-remat")}
    jax_tp = _jax_steps("einsum", batches, rngs, tp_world=2)
    single = _trainer(tmp / "single", 100, clip=CLIP)
    single.load_bridged_state(bridged)
    single_steps = _one_process_steps(single, batches, draws)
    # bf16 with remat in one process: plain, and with tp 2's split products
    bf16 = {}
    for name, split in (("plain", False), ("control", True)):
        trainer = _trainer(tmp / f"bf16-{name}", 100, clip=CLIP, model_kw=BF16)
        if split:
            split_products(trainer.model.denoiser, 2)
        trainer.load_bridged_state(bridged)
        bf16[name] = (_one_process_steps(trainer, batches, draws), trainer.flat.params.numpy())
    ranks = {w: g() for w, g in groups.items()}
    return {"want": want, "jax_tp": jax_tp, "ranks": ranks, "single": single,
            "single_steps": single_steps, "tp1": tp1, "tmp": tmp, "bf16": bf16}


def _one_process_steps(trainer, batches, draws):
    return [{k: float(v) for k, v in trainer.train_step(b, draws=tuple(
        map(torch.from_numpy, d))).items()} for b, d in zip(batches, draws)]


def _trainer(out, max_iterations, clip=None, tp=1, model_kw=MODEL):
    coords, feats = _data()
    return DiffusionTraining(str(out), DiffusionModel(**model_kw), PointNeRFDataset(coords, feats),
                             batch_size=4, base_learning_rate=LR, weight_decay=WD,
                             max_iterations=max_iterations, use_ema=True, ema_params=[EMA],
                             grad_clip_max_norm=clip, device="cpu",
                             save_checkpoint_interval_min=1e9, weights_only_interval=10**9,
                             verbose=False, print_interval=1, tp=tp)


def _as_dict(trainer, flat):
    return trainer.flat.as_dict(torch.from_numpy(np.ascontiguousarray(flat)))


def _state_close(got, want_tree, trainer, what):
    """A full flat buffer against a bridged {name: array} at npcd_tpu's
    TP tolerance (rtol 1e-4, atol 1e-6)."""
    for name, v in _as_dict(trainer, got).items():
        np.testing.assert_allclose(v.numpy(), want_tree[name], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what} {name}")


# -- shards -------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sharded_jax():
    """npcd_tpu's train state at width 256, 4 heads, qkv_groups 2 with random
    moments and EMA, sharded by shard_train_state over a (2, 2) mesh."""
    from npcd_tpu.utils.ema import EmaConfig

    model = JaxDiffusionModel(coords_dim=3, feats_dim=4, num_points=16, width=256, layers=2,
                              heads=4, qkv_groups=2)
    fused = JaxFused(LR, WD, clip_max_norm=CLIP, ema_cfgs=(EmaConfig.from_tuple(EMA),))
    d = model.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    like = lambda: jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(size=a.shape).astype(np.float32)), d.params)
    params = like()
    import optax

    opt = _replace_adam_state(fused.make_tx().init(params), optax.ScaleByAdamState(
        count=jnp.asarray(3, jnp.int32), mu=like(), nu=like()))
    state = DiffusionTrainState(params=params, opt_state=opt, ema_params=(like(),),
                                step=jnp.asarray(3, jnp.int32), coords_norm=d.coords_norm,
                                feats_norm=d.feats_norm)
    mesh = _jax_mesh(2)
    return state, shard_train_state(state, fused.make_tx(), mesh), mesh


@pytest.mark.parametrize("device", range(4))
def test_shards_match_jax_shard_train_state(sharded_jax, device):
    full, sharded, mesh = sharded_jax
    dev = mesh.devices.reshape(-1)[device]
    data_index, model_index = np.argwhere(mesh.devices == dev)[0]
    local = lambda tree: jax.tree_util.tree_map(
        lambda a: np.asarray(next(s.data for s in a.addressable_shards if s.device == dev)), tree)
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    adam_full, adam_sh = _get_adam_state(full.opt_state), _get_adam_state(sharded.opt_state)
    pairs = {"params": (full.params, sharded.params), "mu": (adam_full.mu, adam_sh.mu),
             "nu": (adam_full.nu, adam_sh.nu), "ema": (full.ema_params[0], sharded.ema_params[0])}
    n_sharded = 0
    for what, (f, s) in pairs.items():
        want = denoiser_state_dict(local(s))
        got = shard_denoiser_state(denoiser_state_dict(host(f)), 2, int(model_index))
        assert set(got) == set(want)
        specs = denoiser_param_specs(list(want))
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=f"{what} {name}")
            n_sharded += specs[name] is not None
        # the flat layout's slicing gives the same shards
        full_d = denoiser_state_dict(host(f))
        names = list(full_d)
        layout = TPLayout(names, [full_d[n].shape for n in names], 2, int(model_index))
        flat = torch.cat([torch.from_numpy(full_d[n]).reshape(-1) for n in names])
        loc = layout.local(flat)
        for i, n in enumerate(names):
            np.testing.assert_array_equal(layout.local_view(loc, i).numpy(), want[n])
    # every block's c_qkv and c_fc (weight, bias) and its two c_proj
    # weights, and time_embed's c_fc (weight, bias) and c_proj weight:
    # 2 x 6 + 3 leaves of each of the four trees
    assert n_sharded == 4 * (2 * 6 + 3)
    # the inverse: both model ranks' shards -> the full state
    full_d = denoiser_state_dict(host(full.params))
    shards = [shard_denoiser_state(full_d, 2, m) for m in range(2)]
    for n, v in unshard_denoiser_state(shards).items():
        np.testing.assert_array_equal(v.numpy(), full_d[n], err_msg=n)


# -- steps ----------------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"world{c[0]}-{c[1]}")
@pytest.mark.parametrize("step", range(STEPS))
def test_tp_steps_match_jax(run, case, step):
    world, impl, job = case
    want = run["want"][impl][0][step]
    assert want["grad_norm"] > CLIP  # the clip is active
    for r, rank in enumerate(run["ranks"][world]):
        got = rank[job]["steps"][step]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5, err_msg=f"rank {r}")
        for k in ("00_coords_loss", "01_feats_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=f"rank {r} {k}")
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"world{c[0]}-{c[1]}")
def test_tp_state_matches_jax(run, case):
    world, impl, job = case
    ranks = [r[job] for r in run["ranks"][world]]
    want = run["want"][impl][1]
    single = run["single"]
    for rank in ranks:
        assert rank["step"] == START + STEPS
        _state_close(rank["params"], want["params"], single, "params")
        _state_close(rank["emas"][0], want["emas"][0], single, "ema")
        _state_close(rank["mu"], want["mu"], single, "mu")
    # every rank gathered the same full state; each rank's buffer is its
    # model index's shards of it, the replicated leaves bitwise equal
    names = single.flat.names
    layout = lambda m: TPLayout(names, single.flat.shapes, 2, m)
    for rank in ranks:
        for k in ("params", "mu", "nu", "emas"):
            np.testing.assert_array_equal(rank[k], ranks[0][k], err_msg=k)
        np.testing.assert_array_equal(
            rank["local"], layout(rank["index"][1]).local(torch.from_numpy(rank["params"])))
    assert sorted(r["index"] for r in ranks) == [(d, m) for d in range(world // 2)
                                                 for m in range(2)]


@pytest.mark.parametrize("world", [2, 4])
def test_tp_matches_port_tp1(run, world):
    """Against the port's own tp=1 step on the whole batch in one process,
    at the same tolerance."""
    single = run["single"]
    for rank in run["ranks"][world]:
        got = rank["steps"]
        for s, w in zip(got["steps"], run["single_steps"]):
            np.testing.assert_allclose(s["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(s["grad_norm"], w["grad_norm"], rtol=1e-4)
        for k, buf in (("params", single.flat.params), ("mu", single.adam.mu),
                       ("nu", single.adam.nu), ("emas", single.emas)):
            np.testing.assert_allclose(got[k], buf.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


def test_bf16_remat_tp_matches_split_control(run):
    """bf16 with block remat (train_diffusion's default) at tp 2 against one
    process with tp 2's split products and their roundings
    (tests/tp_split_control.py), at the TP tolerances; the plain one-process
    bf16 step misses them: the split products' roundings are all that sets
    the two apart."""
    control_steps, control = run["bf16"]["control"]
    plain_steps, plain = run["bf16"]["plain"]
    for rank in run["ranks"][2]:
        got = rank["bf16"]
        for s, w in zip(got["steps"], control_steps):
            np.testing.assert_allclose(s["loss"], w["loss"], rtol=1e-5)
            np.testing.assert_allclose(s["grad_norm"], w["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(got["params"], control, rtol=1e-4, atol=1e-6)
        assert not np.allclose(got["params"], plain, rtol=1e-4, atol=1e-6)
    assert not np.allclose(control, plain, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails(run, fault):
    """Each fault misses npcd_tpu's reference by more than the tolerances:
    its grad_norm, or its loss, or its parameters."""
    want_steps, want = run["want"]["einsum"]
    got = run["ranks"][2][0][f"fault_{fault}"]
    misses = []
    for s, w in zip(got["steps"], want_steps):
        misses.append(abs(s["grad_norm"] / w["grad_norm"] - 1) > 1e-4
                      or abs(s["loss"] / w["loss"] - 1) > 1e-5)
    try:
        _state_close(got["params"], want["params"], run["single"], "params")
    except AssertionError:
        misses.append(True)
    assert any(misses), f"planted fault {fault!r} passes the tolerances"


def test_jax_tp_step_sums_the_g_twice(run):
    """npcd_tpu's make_tp_diffusion_train_step misses its own single-device
    step (grad_norm ~2% high here, every step), and the port's step with
    planted fault (b) reproduces it at the TP tolerances."""
    tp_steps, tp_state = run["jax_tp"]
    want = run["want"]["einsum"][0]
    np.testing.assert_allclose(tp_steps[0]["loss"], want[0]["loss"], rtol=1e-5)  # same forward
    for got, w in zip(tp_steps, want):
        assert abs(got["grad_norm"] / w["grad_norm"] - 1) > 1e-2
    fault = run["ranks"][2][0]["fault_g"]
    for got, want in zip(fault["steps"], tp_steps):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-4)
    _state_close(fault["params"], tp_state["params"], run["single"], "params")
    _state_close(fault["emas"][0], tp_state["emas"][0], run["single"], "ema")


# -- loop, checkpoints, exports -------------------------------------------------------------


def test_tp_loop_checkpoint_and_restore(run):
    tmp = run["tmp"]
    r0, r1 = (r["run"] for r in run["ranks"][2])
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 3
    assert np.isfinite(r0["losses"]).all()
    np.testing.assert_array_equal(r0["params"], r1["params"])
    out = tmp / "run"
    assert_one_writer_dirs(out)
    # a tp=1 trainer restores the tp=2 checkpoint: step 3, the gathered state
    again = _trainer(out, 3)
    assert again.step == 3
    np.testing.assert_array_equal(again.flat.params.numpy(), r0["params"])
    np.testing.assert_array_equal(again.emas.numpy(), r0["emas"])
    full_shapes = dict(zip(again.flat.names, again.flat.shapes))
    with np.load(out / "weights_only_checkpoints_dir" / "npcd-iter-000000003.npz") as z:
        dn = {k[len("diffusion.denoiser."):]: z[k] for k in z.files
              if k.startswith("diffusion.denoiser.")}
        assert {k: v.shape for k, v in dn.items()} == full_shapes
        for name, v in _as_dict(again, r0["params"]).items():
            np.testing.assert_array_equal(dn[name], v.numpy(), err_msg=name)
    # each rank's shards are its model index's part of the export
    layout = TPLayout(again.flat.names, again.flat.shapes, 2, 1)
    np.testing.assert_array_equal(r1["local"], layout.local(torch.from_numpy(r0["params"])))
    # a tp=2 trainer restored the tp=1 run's checkpoint on both ranks
    for r in (r0, r1):
        assert r["restored_step"] == 3
        np.testing.assert_array_equal(r["restored_params"], run["tp1"].flat.params.numpy())


def assert_one_writer_dirs(out):
    ckpts = sorted(n for n in os.listdir(out / "checkpoints") if not n.endswith(".json"))
    assert ckpts == ["diffusion_training-iter-000000003"]
    exports = sorted(n for n in os.listdir(out / "weights_only_checkpoints_dir")
                     if n.endswith(".npz"))
    assert exports == ["npcd-ema_power1_0min0_9max0_999buffers0-iter-000000003.npz",
                       "npcd-iter-000000003.npz"]


# -- errors and the CLI ---------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(heads=4, qkv_groups=2, tp=4), dict(heads=3, qkv_groups=2,
                                                                          tp=2)],
                         ids=["tp-not-dividing-groups", "tp-not-dividing-heads"])
def test_tp_value_errors(kw):
    """npcd_tpu's ValueError for tp not dividing qkv_groups or heads, from the
    port's constructor and from npcd_tpu's init."""
    tp = kw.pop("tp")
    geom = dict(coords_dim=3, feats_dim=4, num_points=16, width=64 * kw["heads"], layers=1)
    match = "tensor parallelism needs tp \\| qkv_groups and tp \\| heads"
    with pytest.raises(ValueError, match=match):
        NPCDTransformer(**geom, **kw, tp=tp)
    jmodel = JaxDiffusionModel(**geom, **kw, attn_impl="einsum")
    with pytest.raises(ValueError, match=match):
        jmodel.denoiser.clone(tp=tp).init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16)),
                                          jnp.zeros((1, 4, 16)), jnp.zeros((1,), jnp.int32))


def test_tp_not_dividing_the_world(tmp_path):
    """DiffusionTraining(tp=) on a group of one, and npcd_tpu's on its 8
    devices at tp 3: 'tp=N does not divide device count W'."""
    one = Mesh(1, 0, 0, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="tp=2 does not divide device count 1"):
        DiffusionTraining(str(tmp_path / "port"), DiffusionModel(**MODEL), None, batch_size=4,
                          base_learning_rate=LR, weight_decay=WD, max_iterations=1, mesh=one,
                          tp=2)
    with pytest.raises(ValueError, match=f"tp=3 does not divide device count "
                                         f"{jax.device_count()}"):
        JaxDiffusionTraining(str(tmp_path / "jax"), JaxDiffusionModel(**MODEL), None, batch_size=4,
                             base_learning_rate=LR, weight_decay=WD, max_iterations=1, tp=3)


def test_cli_tp_on_two_ranks(tmp_path):
    """train_diffusion --tp 2 on 2 gloo ranks (a launcher's environment): rank
    0 writes one run of full arrays, whose export equals the port's
    one-process run (the same batches: dp 1) within the DP tolerance (rtol
    1e-4, atol 1e-6)."""
    from npcd_tpu_torch.models.npcd import NPCD
    from npcd_tpu_torch.train_diffusion import load_pointnerf_weights
    from npcd_tpu_torch.utils.builders import build_diffusion_model
    from npcd_tpu_torch.utils.config import load_config

    tiny = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs/npcd_synthetic_tiny.yaml")
    with open(tiny) as f:  # its 2 heads in 2 layout groups, one a model rank
        text = f.read()
    assert text.count("    heads: 2\n") == 1
    cfg = str(tmp_path / "tiny_tp.yaml")
    with open(cfg, "w") as f:
        f.write(text.replace("    heads: 2\n", "    heads: 2\n    qkv_groups: 2\n"))
    config = load_config(cfg)
    m = config["model"]
    npcd = NPCD.from_config(config)
    rng = np.random.default_rng(0)
    flat = {f"pointnerf.{k}": v.numpy() for k, v in npcd.pointnerf.state_dict().items()}
    flat["latents.coords_table"] = rng.uniform(-0.5, 0.5, (m["n_obj"], m["num_points"], 3))
    flat["latents.feats_table"] = rng.normal(size=(m["n_obj"], m["num_points"], m["feats_dim"]))
    save_npz(str(tmp_path / "pointnerf.npz"), flat)
    out = tmp_path / "tp"
    run_ranks("npcd_tpu_torch.train_diffusion",
              ["--config", cfg, "--output", out, "--pointnerf_weights", tmp_path / "pointnerf.npz",
               "--dtype", "float32", "--device", "cpu", "--no_tensorboard", "--tp", "2"],
              cwd=tmp_path)
    assert_one_writer(out)
    steps = config["diffusion_training"]["max_iterations"]
    dataset, _ = load_pointnerf_weights(str(tmp_path / "pointnerf.npz"), m["num_points"],
                                        m["feats_dim"])
    single = DiffusionTraining(str(tmp_path / "single"), build_diffusion_model(config),
                               dataset, seed=42, device="cpu", verbose=False,
                               **config["diffusion_training"])()
    with np.load(out / "weights_only_checkpoints_dir" / f"npcd-iter-{steps:09d}.npz") as z:
        for name, v in single.flat.as_dict(single.flat.params).items():
            np.testing.assert_allclose(z[f"diffusion.denoiser.{name}"], v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)

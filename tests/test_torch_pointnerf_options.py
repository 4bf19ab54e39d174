"""PointNeRF at its configurable options, the PyTorch port against
npcd_tpu on the CPU, on the same numpy inputs and bridged weights: the
field heads with view directions (dir_freqs 0, 4 and 8) and a feature
encoding (feat_freqs 1), disparity-space depth sampling, the aggregation
at k 6 and 16 with every posenc method through its w-sum, no-reduction
and (relu) XLA branches with return_weights, the kp_weights compositing,
apply_mlp in bf16 at 307 and 768 columns, the two option sets of
chip_smoke.py's phases 23 (V: view-dependent, 'direct', bf16 with a
shading budget) and 24 (O: k 16, 'recurrence', dir_freqs 4, feat_freqs 1,
disparity, dense) end to end (render with kp_weights and one stage-1 step,
forward and every gradient, f32 and bf16, at narrow widths: 32-wide MLPs of
2 layers, on configs/npcd_synthetic_tiny.yaml), and weights with a wider
channel net from a JAX checkpoint and from a reference-layout .pt.

npcd_tpu's init_params sizes the heads by the aggregator's out_dim alone,
so its own init cannot run feat_freqs > 0 (field_heads feeds the encoded
feature, 3x wider); the port sizes them by the width they read, and the
tests hand npcd_tpu heads of that width. npcd_tpu's disparity branch
draws its jitter from its key (renderer.py:41-47) and ignores an injected
one, so the tests replay that draw by hand and give it to the port.

npcd_tpu runs its XLA paths on the CPU (compiled with
``xla_allow_excess_precision`` off, so that its bf16 casts round), the
port its plain versions. Tolerances, stated where used, follow
test_torch_pointnerf_training and test_torch_pointnerf_fast; 'recurrence'
adds the ~2e-4 its 9 double-angle steps make of the ulp by which torch's
and XLA's sin/cos differ. Discrete decisions (validity, kNN, TV pairs) are
held off the radius by test_torch_pointnerf_training's margins."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from reference_checkpoint import reference_state  # noqa: E402
from test_torch_fused_mlp_bf16 import _forward_close  # noqa: E402
from test_torch_pointnerf_fast import _ray_scores  # noqa: E402
from test_torch_pointnerf_training import (LR, WEIGHTS, _assert_margins, _draws,  # noqa: E402
                                           _jax_batch, _leaf_close)

from npcd_tpu.losses import PointNeRFLossWeights as JaxWeights  # noqa: E402
from npcd_tpu.losses import pointnerf_loss as jax_loss  # noqa: E402
from npcd_tpu.models.pointnerf import aggregator as jax_agg  # noqa: E402
from npcd_tpu.models.pointnerf import field as jax_field  # noqa: E402
from npcd_tpu.models.pointnerf import nn_core as jax_nn  # noqa: E402
from npcd_tpu.models.pointnerf import renderer as jax_renderer  # noqa: E402
from npcd_tpu.train.pointnerf_training import make_pointnerf_optimizer  # noqa: E402
from npcd_tpu.utils import config as jax_config  # noqa: E402
from npcd_tpu.utils.builders import build_pointnerf as jax_build_pointnerf  # noqa: E402
from npcd_tpu.utils.config import load_config as jax_load_config  # noqa: E402
from npcd_tpu_torch.data import SyntheticNPCTrain  # noqa: E402
from npcd_tpu_torch.losses import PointNeRFLossWeights, pointnerf_loss  # noqa: E402
from npcd_tpu_torch.models.pointnerf import aggregator, field, nn_core, renderer  # noqa: E402
from npcd_tpu_torch.models.pointnerf.pointnerf import PointNeRF  # noqa: E402
from npcd_tpu_torch.utils import config as port_config  # noqa: E402
from npcd_tpu_torch.utils.builders import build_pointnerf  # noqa: E402
from npcd_tpu_torch.utils.config import load_config  # noqa: E402
from npcd_tpu_torch.utils.convert_reference import (convert_pointnerf_params,  # noqa: E402
                                                    load_torch_state_dict)
from npcd_tpu_torch.utils.from_jax import (pointnerf_state_dict,  # noqa: E402
                                           pointnerf_train_state_from_jax)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs/npcd_synthetic_tiny.yaml")
EXACT = {"xla_allow_excess_precision": False}
NARROW = {"layers": (32,), "out_dim": 32, "shape_layers": (32,), "channel_layers": (32,)}
# phase 23's and phase 24's option sets (chip_smoke.py), on the tiny config
PATHS = {"V": ({"posenc_method": "direct"}, 32),
         "O": ({"k": 16, "posenc_method": "recurrence", "dir_freqs": 4, "feat_freqs": 1,
                "disparity_space_sampling": True}, None)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _exact(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT)(*args)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32))).to(dtype)


def _layers_np(rng, dims, d_in, d_out):
    out, cur = [], d_in
    for dim in tuple(dims) + (d_out,):
        bound = 1 / np.sqrt(cur)
        out.append({"w": rng.uniform(-bound, bound, (cur, dim)).astype(np.float32),
                    "b": rng.uniform(-bound, bound, dim).astype(np.float32)})
        cur = dim
    return out


def _close(got, want, rel, what):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= rel * max(1.0, float(np.abs(want).max())), f"{what}: max abs err {err}"


# ---- modules ----------------------------------------------------------------

@pytest.mark.parametrize("dir_freqs,feat_freqs,dtype", [
    (0, 0, "float32"), (4, 0, "float32"), (4, 1, "float32"), (8, 0, "bfloat16"),
    (4, 1, "bfloat16")])
def test_field_heads_options_match_jax(dir_freqs, feat_freqs, dtype):
    """sigma and rgb with view directions (one per ray, broadcast over its
    samples) and the feature encoding: f32 within 1e-5 (the recurrence over
    4 octaves of |feat| < 4 stays within a few ulps); bf16 (heads 307 wide
    run K7's plain version, 768 and 795 the plain bf16 layers, as
    npcd_tpu's XLA branch) within 2**-8, half a bf16 ulp at 1: softplus and
    sigmoid take the bf16 outputs in f32, where torch's and XLA's differ in
    their last bits, and an output whose bf16 rounding flips moves them by
    at most sigmoid' <= 1/4 of an ulp."""
    rng = np.random.default_rng(dir_freqs + 10 * feat_freqs)
    opts = port_config.FieldOptions(use_dir=True, dir_freqs=dir_freqs, feat_freqs=feat_freqs)
    jopts = jax_config.FieldOptions(use_dir=True, dir_freqs=dir_freqs, feat_freqs=feat_freqs)
    head_in = nn_core.posenc_dim(256, feat_freqs)
    ch_in = head_in + (nn_core.posenc_dim(3, dir_freqs) if dir_freqs else 3)
    params = {"shape_net": _layers_np(rng, (256,), head_in, 1),
              "channel_net": _layers_np(rng, (256,) * 4, ch_in, 3)}
    feat = rng.normal(size=(2, 24, 5, 256)).astype(np.float32)
    valid = rng.uniform(size=(2, 24, 5)) < 0.7
    dirs = rng.normal(size=(2, 24, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    jdt = jnp.dtype(dtype).type
    want = _exact(lambda p, f, v, d: jax_field.field_heads(p, jopts, f, v, d, jdt),
                  jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(feat).astype(jdt),
                  jnp.asarray(valid), jnp.asarray(dirs))
    tdt = getattr(torch, dtype)
    got = field.field_heads({k: [{n: _t(a) for n, a in l.items()} for l in v]
                             for k, v in params.items()}, opts, _t(feat, tdt),
                            torch.from_numpy(valid), _t(dirs), tdt)
    for g, w, name in zip(got, want, ("sigma", "rgb")):
        assert g.dtype == torch.float32
        _close(g, w, 1e-5 if dtype == "float32" else 2 ** -8, name)


@pytest.mark.parametrize("draw", [False, True])
def test_disparity_sampling_matches_jax(draw):
    """Depths uniform in disparity, with and without the training draw (npcd_tpu
    draws it from its key; the port is given that draw as jitter): 1e-6
    relative, f32 in the same order."""
    rng = np.random.default_rng(2)
    start = rng.uniform(0.5, 1.0, (3, 40)).astype(np.float32)
    end = start + rng.uniform(0.5, 2.0, (3, 40)).astype(np.float32)
    key = jax.random.PRNGKey(7) if draw else None
    want = np.asarray(jax_renderer.sample_depths(jnp.asarray(start), jnp.asarray(end), 24,
                                                 key, disparity=True))
    jitter = _t(jax.random.uniform(key, (3, 40, 24))) if draw else None
    got = renderer.sample_depths(_t(start), _t(end), 24, jitter, disparity=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert (np.diff(got, axis=-1) > 0).all() and (got >= start[..., None] * (1 - 1e-6)).all()


def _agg_inputs(seed, n, k, f=8, p=64):
    """Shading points near a cloud of p points (kNN from the port's knn,
    handed to both sides, as the training step does), the features and a
    narrow MLP."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, (2, p, 3)).astype(np.float32)
    feats = rng.normal(size=(2, p, f)).astype(np.float32)
    x = (pts[:, rng.integers(0, p, n)] + rng.normal(0, 0.08, (2, n, 3))).astype(np.float32)
    mask = rng.uniform(size=(2, n)) < 0.8
    idx, nb = aggregator.knn_neighbors(_t(x), torch.from_numpy(mask), _t(pts), k, 0.16)
    assert 0 < nb.float().mean() < 1
    return x, mask, pts, feats, idx, nb


@pytest.mark.parametrize("k,method,n,act,dtype", [
    (16, "direct", 12, "leaky_relu", "float32"),
    (16, "recurrence", 12, "leaky_relu", "float32"),
    (16, "anchored", 12, "leaky_relu", "float32"),
    (6, "direct", 12, "leaky_relu", "float32"),
    (6, "recurrence", 12, "leaky_relu", "bfloat16"),
    (6, "anchored", 12, "leaky_relu", "float32"),
    (16, "direct", 5, "leaky_relu", "float32"),
    (6, "anchored", 5, "leaky_relu", "bfloat16"),
    (16, "anchored", 12, "relu", "float32"),
    (6, "direct", 5, "relu", "bfloat16")])
def test_aggregate_features_options_match_jax(k, method, n, act, dtype):
    """aggregate_features with return_weights at k 6 and 16, each posenc
    method: 12 points take the w-sum branch, 5 (fewer than 8) the
    no-reduction form and the w-sum outside, relu npcd_tpu's XLA branch in
    plain torch. feat and the gradients of kp_feat and every weight: f32
    within 1e-5 ('recurrence' 1e-3), bf16 within 2e-2 of max(1, scale)
    (a flipped hidden rounding over a few pairs); w and idx equal."""
    x, mask, pts, feats, idx, nb = _agg_inputs(k + n, n, k)
    opts = port_config.AggregatorOptions(k=k, posenc_method=method, activation=act,
                                         layers=(32,), out_dim=32)
    jopts = jax_config.AggregatorOptions(k=k, posenc_method=method, activation=act,
                                         layers=(32,), out_dim=32)
    assert aggregator.wsum_supported(n * k, k) == (n >= 8)
    rng = np.random.default_rng(k)
    layers = _layers_np(rng, (32,), 8 + nn_core.posenc_dim(3, 10), 32)
    g = rng.normal(size=(2, n, 32)).astype(np.float32)
    jdt = jnp.dtype(dtype).type

    def jfn(ls, kpf):
        feat, valid, w, i = jax_agg.aggregate_features(
            {"local_field": ls}, jopts, 0.16, jnp.asarray(x), jnp.asarray(mask),
            jnp.asarray(pts), kpf, compute_dtype=jdt,
            neighbors=(jnp.asarray(idx.numpy()), jnp.asarray(nb.numpy())),
            return_weights=True)
        return feat.astype(jnp.float32), (valid, w, i)

    jls = jax.tree_util.tree_map(jnp.asarray, layers)
    want, (jvalid, jw, jidx) = _exact(jfn, jls, jnp.asarray(feats))
    jgrads = _exact(lambda ls, kpf, g_: jax.vjp(jfn, ls, kpf, has_aux=True)[1](g_), jls,
                    jnp.asarray(feats), jnp.asarray(g))
    tl = [{n_: _t(a).requires_grad_(True) for n_, a in l.items()} for l in layers]
    kpf = _t(feats).requires_grad_(True)
    tdt = getattr(torch, dtype)
    feat, valid, w, i = aggregator.aggregate_features(
        tl, opts, _t(x), torch.from_numpy(mask), _t(pts), kpf, (idx, nb), tdt,
        return_weights=True)
    assert feat.dtype == tdt
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(i.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)
    rel = 2e-2 if dtype == "bfloat16" else 1e-3 if method == "recurrence" else 1e-5
    _close(feat, want, rel, "feat")
    feat.float().backward(_t(g))
    _close(kpf.grad, jgrads[1], rel, "dkp_feat")
    for li, (tlay, jlay) in enumerate(zip(tl, jgrads[0])):
        for name in ("w", "b"):
            _close(tlay[name].grad, jlay[name], rel, f"d{name}{li}")


def test_composite_kp_weights_matches_jax():
    """Per-point compositing of the pair weights along each ray (npcd_tpu's
    scatter-add), repeated indices included: 1e-6."""
    rng = np.random.default_rng(3)
    sw = rng.uniform(size=(2, 6, 9)).astype(np.float32)
    aw = rng.uniform(size=(2, 6, 9, 4)).astype(np.float32)
    idx = rng.integers(0, 10, (2, 6, 9, 4)).astype(np.int32)
    want = np.asarray(jax_renderer.composite_kp_weights(jnp.asarray(sw), jnp.asarray(aw),
                                                        jnp.asarray(idx), 10))
    got = renderer.composite_kp_weights(_t(sw), _t(aw), torch.from_numpy(idx), 10).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got.sum(-1), (sw[..., None] * aw).sum((-2, -1)), rtol=1e-5)


@pytest.mark.parametrize("d_in,dims", [(307, (256, 256, 3)), (768, (256, 1))])
def test_apply_mlp_bf16_widths_match_jax(d_in, dims):
    """apply_mlp in bf16 at the heads' widths with view directions (307:
    K7, on the CPU its plain version) and a feature encoding (768: beyond
    npcd_tpu's 512 gate, the plain bf16 layers) against npcd_tpu's XLA
    apply_mlp: 99% bitwise, each element within an ulp."""
    rng = np.random.default_rng(d_in)
    x = rng.normal(size=(300, d_in)).astype(np.float32)
    layers = _layers_np(rng, dims[:-1], d_in, dims[-1])
    want = _exact(lambda ls, a: jax_nn.apply_mlp(ls, a, compute_dtype=jnp.bfloat16, impl="xla"),
                  jax.tree_util.tree_map(jnp.asarray, layers), jnp.asarray(x))
    got = nn_core.apply_mlp([{n: _t(a) for n, a in l.items()} for l in layers], _t(x),
                            compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _forward_close(got, want, bitwise=0.99)


# ---- whole paths --------------------------------------------------------------

def _path_config(loader, path, dtype):
    options, budget = PATHS[path]
    cfg = loader(CONFIG)
    cfg["model"]["use_view_dir"] = True
    cfg["pointnerf_options"] = {**cfg["pointnerf_options"], **NARROW, **options}
    cfg["render_config"] = {**cfg["render_config"], "train_rays": 32, "compute_dtype": dtype,
                            "shading_budget": budget}
    return cfg


def _jax_params(jm, coords, seed):
    """npcd_tpu's params with heads sized for what they read (see the module
    doc), the dataset's coords and a random feats table (both halves)."""
    o = jm.opts
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(seed)))
    head_in = jax_nn.posenc_dim(o.aggregator.out_dim, o.field.feat_freqs)
    ch_in = head_in + (jax_nn.posenc_dim(3, o.field.dir_freqs) if o.field.dir_freqs else 3)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 1))
    params["field"] = jax.tree_util.tree_map(np.asarray, {
        "shape_net": jax_nn.init_mlp(k1, o.field.shape_layers, head_in, 1),
        "channel_net": jax_nn.init_mlp(k2, o.field.channel_layers, ch_in, 3)})
    params = jax.tree_util.tree_map(np.asarray, jm.set_all_coords(params, coords))
    rng = np.random.default_rng(seed)
    f = o.feat_dim
    table = params["feats_table"].copy()
    table[..., :f] = rng.normal(scale=0.5, size=table[..., :f].shape)
    table[..., f:] = rng.normal(scale=0.2, size=table[..., f:].shape)
    params["feats_table"] = table
    return params


@pytest.mark.parametrize("path,dtype", [("V", "bfloat16"), ("V", "float32"),
                                        ("O", "float32"), ("O", "bfloat16")])
def test_path_render_and_step_match_jax(path, dtype):
    """The render of 2 objects x 2 views at 16^2 with kp_weights, then one
    stage-1 step (4 objects x 2 views, 32 rays) forward, losses and every
    gradient leaf. npcd_tpu's ray order is injected through ray_scores (the
    budget drops slots by it); O's disparity draw is replayed. f32 ('direct',
    V): render and pred within 1e-4, losses 1e-5 relative, each gradient
    leaf within 5e-3 of its scale (test_torch_pointnerf_training's bound for
    pairs on a leaky_relu kink); 'recurrence' (O) 1e-3, 1e-4 and 1e-2; bf16
    as test_torch_pointnerf_fast: 2e-2, 1e-2 and each leaf within 5e-2 of its
    norm (L2) and 1e-1 of its scale element by element."""
    jm = jax_build_pointnerf(_path_config(jax_load_config, path, dtype))
    ds = SyntheticNPCTrain(**load_config(CONFIG)["dataset_kwargs"])
    params = _jax_params(jm, ds.get_all_coords(), seed=3)
    tx = make_pointnerf_optimizer(LR)
    bridged = pointnerf_train_state_from_jax(params, tx.init(params), 0)
    model = build_pointnerf(_path_config(load_config, path, dtype), with_tables=True)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in bridged["params"].items()})
    o = model.opts
    assert o.field.use_dir and all(  # the YAML's options reached the model
        getattr(o.aggregator, n, None) == v or getattr(o.field, n, None) == v
        or getattr(o.renderer, n, None) == v for n, v in PATHS[path][0].items())
    bf16 = dtype == "bfloat16"
    tol = (2e-2, 1e-2) if bf16 else (1e-3, 1e-4) if path == "O" else (1e-4, 1e-5)

    # the render, with the kp_weights attribution
    obj = np.array([1, 6])
    batch = ds.batch(obj)
    coords, feats = params["coords_table"][obj], params["feats_table"][obj, :, :o.feat_dim]
    want = _exact(lambda p, c, f, e, i: jm.render(p, c, f, e, i, resolution=16, kp_weights=True),
                  jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(coords),
                  jnp.asarray(feats), jnp.asarray(batch["extrinsics"]),
                  jnp.asarray(batch["intrinsics"]))
    got = model.render(_t(coords), _t(feats), _t(batch["extrinsics"]), _t(batch["intrinsics"]),
                       resolution=16, kp_weights=True)
    assert got["kp_weights"].shape == (2, 2, 256, o.num_points)
    np.testing.assert_array_equal(got["ray_valid"].numpy(), np.asarray(want["ray_valid"]))
    for key in ("channels", "mask", "depth", "kp_weights"):
        _close(got[key], want[key], tol[0], f"render {key}")

    # one stage-1 step
    objs = np.array([0, 3, 5, 6])
    batch = ds.batch(objs)
    b, v = batch["extrinsics"].shape[:2]
    key = jax.random.PRNGKey(11)
    draws = _draws(21, b, v, o)
    if o.renderer.disparity_space_sampling:  # npcd_tpu's own draw (forward, _render_core_body)
        draws["depth_jitter"] = np.asarray(jax.random.uniform(
            jax.random.split(jax.random.split(key, 3)[2])[0],
            draws["depth_jitter"].shape))
    _assert_margins(o, ds.get_all_coords()[objs], batch, draws)
    jbatch = _jax_batch(batch, draws)

    def loss_fn(p):
        pred, aux = jm.forward(p, jbatch["obj_idx"], jbatch["intrinsics"], jbatch["extrinsics"],
                               rng=key, train=True, draws=jbatch["draws"])
        loss, sub = jax_loss(jbatch, pred, aux, jm.opts, JaxWeights(*WEIGHTS),
                             presampled_images=True)
        return loss, (pred, sub)

    (_, (jpred, jsub)), jgrad = _exact(jax.value_and_grad(loss_fn, has_aux=True),
                                       jax.tree_util.tree_map(jnp.asarray, params))
    tb = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    pred, aux = model(tb(batch["obj_idx"]).long(), tb(batch["intrinsics"]),
                      tb(batch["extrinsics"]), tb(draws["pixel_idx"]),
                      draws={"feats_eps": tb(draws["feats_eps"]),
                             "depth_jitter": tb(draws["depth_jitter"]),
                             "ray_scores": tb(_ray_scores(jpred["ray_sel"]))})
    np.testing.assert_array_equal(pred["ray_sel"].numpy(), np.asarray(jpred["ray_sel"]))
    assert 0.05 < pred["ray_valid"].float().mean() < 0.95
    for k in ("channels", "mask", "depth"):
        _close(pred[k], jpred[k], tol[0], k)
    loss, sub = pointnerf_loss({"images": tb(np.asarray(jbatch["images"]))}, pred, aux, o,
                               PointNeRFLossWeights(*WEIGHTS))
    for k in jsub:
        assert float(jsub[k]) > 0, k
        np.testing.assert_allclose(float(sub[k].detach()), float(jsub[k]), rtol=tol[1], err_msg=k)
    loss.backward()
    want = pointnerf_train_state_from_jax(jax.tree_util.tree_map(np.asarray, jgrad),
                                          tx.init(params), 0)["params"]
    for name, p in model.named_parameters():
        assert float(p.grad.abs().max()) > 0, f"{name} got no gradient"
        if bf16:
            assert np.linalg.norm(p.grad.numpy() - want[name]) <= 5e-2 * np.linalg.norm(
                want[name]), name
            _leaf_close(p.grad.numpy(), want[name], 1e-1, name)
        else:
            _leaf_close(p.grad.numpy(), want[name], 1e-2 if path == "O" else 5e-3, name)


# ---- weights ------------------------------------------------------------------

def test_jax_checkpoint_with_wide_channel_net_loads():
    """npcd_tpu params whose channel net reads 256 + 51 columns (view
    directions at dir_freqs 8) load into the port's model strictly, and
    its heads give npcd_tpu's sigma and rgb on those weights (1e-5)."""
    opts = jax_config.pointnerf_default_options(num_points=32, feat_dim=8, use_view_dir=True)
    jm = jax_build_pointnerf({"model": {"n_obj": 2, "feats_dim": 8, "num_points": 32,
                                        "use_view_dir": True}})
    params = jax.tree_util.tree_map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    assert params["field"]["channel_net"][0]["w"].shape == (307, 256)
    model = PointNeRF(port_config.pointnerf_default_options(num_points=32, feat_dim=8,
                                                            use_view_dir=True))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in pointnerf_state_dict(params).items()})
    rng = np.random.default_rng(0)
    feat = rng.normal(size=(40, 4, 256)).astype(np.float32)
    valid = rng.uniform(size=(40, 4)) < 0.8
    dirs = rng.normal(size=(40, 3)).astype(np.float32)
    want = jax_field.field_heads(params["field"], opts.field, jnp.asarray(feat),
                                 jnp.asarray(valid), jnp.asarray(dirs), jnp.float32)
    layers = lambda pl: [{"w": pl[i], "b": pl[i + 1]} for i in range(0, len(pl), 2)]
    got = field.field_heads({"shape_net": layers(model.shape_net),
                             "channel_net": layers(model.channel_net)}, model.opts.field,
                            _t(feat), torch.from_numpy(valid), _t(dirs))
    for g, w, name in zip(got, want, ("sigma", "rgb")):
        _close(g, w, 1e-5, name)


def test_reference_pt_with_wide_channel_net_loads(tmp_path):
    """A reference-layout .pt (tests/reference_checkpoint.py) whose channel
    net's first Linear reads 256 + 27 columns (view directions at dir_freqs
    4) and whose heads read the feature encoding (feat_freqs 1: 768 and
    795), saved and read back, converts and loads into the port's model
    built from the same options, and the model renders."""
    sd = reference_state(32, n_obj=3, points=8, feat_dim=4)
    g = torch.Generator().manual_seed(1)
    for name, d_in in (("shape_net.0", 768), ("channel_net.0", 795)):
        sd[f"pointnerf.field.{name}.weight"] = torch.randn(256, d_in, generator=g) / d_in ** 0.5
    path = str(tmp_path / "ref.pt")
    torch.save({"model": sd}, path)
    flat = convert_pointnerf_params(load_torch_state_dict(path), n_obj=3, num_points=8,
                                    feat_dim=4)
    assert flat["channel_net.0"].shape == (795, 256)
    opts = port_config.pointnerf_default_options(num_points=8, feat_dim=4, use_view_dir=True)
    opts = dataclasses.replace(opts, field=dataclasses.replace(opts.field, dir_freqs=4,
                                                               feat_freqs=1))
    model = PointNeRF(opts, n_obj=3)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    np.testing.assert_array_equal(model.channel_net[0].detach().numpy(),
                                  sd["pointnerf.field.channel_net.0.weight"].numpy().T)
    batch = SyntheticNPCTrain(**load_config(CONFIG)["dataset_kwargs"]).batch(np.array([0]))
    out = model.render(model.get_all_coords()[:1], model.get_all_feats()[:1],
                       _t(batch["extrinsics"]), _t(batch["intrinsics"]), resolution=16)
    assert torch.isfinite(out["channels"]).all() and out["channels"].shape == (1, 2, 256, 3)

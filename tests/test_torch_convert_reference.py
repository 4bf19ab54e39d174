"""The port's reference-checkpoint converter (npcd_tpu_torch/utils/
convert_reference.py) against npcd_tpu's, on synthetic state dicts in the
reference's layout (per-head [q|k|v] c_qkv, FlexEmbedding extra state with
the feats table's mean half first, normalizer buffers):

  * every key of the port's convert_checkpoint bitwise equal to
    utils/from_jax.bridge of npcd_tpu's conversion, the latent tables
    (pointnerf_latents) and the normalizer stats too, at three head
    geometries: 16 heads of D 4 (the default G = 1) and of D 16 (the
    default G = 2), both through npcd_tpu's own convert_checkpoint, whose
    head count is fixed at the flagship's 16, and 4 heads of D 8 with
    qkv_groups 2 (npcd_tpu's convert_denoiser_params given the heads);
  * the port's denoiser on the converted weights against npcd_tpu's
    NPCDTransformer on its converted weights and against a per-head torch
    oracle of the reference's math that reads the unpermuted weights, each
    within 1e-5 (f32 through two blocks in other summation orders);
  * relayout_qkv round-trips and agrees with npcd_tpu's;
  * the saved .npz loads through load_npz, and under another qkv_groups
    the layout sidecar makes the load raise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from npcd_tpu.models.diffusion.transformer import NPCDTransformer as JaxTransformer
from npcd_tpu.utils import convert_reference as jax_conv
from npcd_tpu_torch.models.npcd import NPCD
from npcd_tpu_torch.utils.convert_reference import (convert_checkpoint, main,
                                                    _permute_qkv_grouped, relayout_qkv,
                                                    save_converted)
from npcd_tpu_torch.utils.from_jax import bridge, load_npz, pointnerf_latents
from reference_checkpoint import reference_forward, reference_state

CD, FD, P, N_OBJ, LAYERS = 3, 4, 8, 3, 2
# (width, heads, qkv_groups in the config, the group count the model uses)
GEOMETRIES = {"16heads-G1": (64, 16, None, 1), "16heads-G2": (256, 16, None, 2),
              "4heads-G2": (32, 4, 2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny models: their small ops gain
    nothing from a thread pool, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(width, heads, qkv_groups):
    model = {"n_obj": N_OBJ, "coords_dim": CD, "feats_dim": FD, "num_points": P, "width": width,
             "layers": LAYERS, "heads": heads}
    if qkv_groups is not None:
        model["qkv_groups"] = qkv_groups
    return {"model": model}


def _jax_side(sd, path, heads, groups):
    """npcd_tpu's conversion -> (its params, bridge + pointnerf_latents of it)."""
    state = {k: (v.numpy() if hasattr(v, "numpy") else v) for k, v in sd.items()}
    if heads == 16:  # its convert_checkpoint fixes the flagship's head count
        out = jax_conv.convert_checkpoint(path, N_OBJ, P, FD, LAYERS)
        dstate = out["diffusion"]
        params, coords_norm, feats_norm = dstate.params, dstate.coords_norm, dstate.feats_norm
        pn = out["pointnerf"]
    else:
        params = jax_conv.convert_denoiser_params(state, LAYERS, heads, qkv_groups=groups)
        coords_norm = jax_conv.convert_normalizer_stats(state, "diffusion.coords_normalization")
        feats_norm = jax_conv.convert_normalizer_stats(state, "diffusion.feats_normalization")
        pn = jax_conv.convert_pointnerf_params(state, N_OBJ, P, FD)
    params = jax.tree_util.tree_map(np.asarray, params)
    flat = bridge(params, coords_norm, feats_norm, jax.tree_util.tree_map(np.asarray, pn))
    flat.update(pointnerf_latents(pn, FD))
    return params, flat


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_convert_checkpoint_is_bitwise_bridge_of_jax(geometry, tmp_path):
    width, heads, qkv_groups, groups = GEOMETRIES[geometry]
    sd = reference_state(width)
    path = str(tmp_path / "ref.pt")
    torch.save({"model": sd}, path)  # the "model" wrapper is unwrapped
    flat, layout = convert_checkpoint(path, _config(width, heads, qkv_groups))
    assert layout == {"qkv_groups": groups}
    _, want = _jax_side(sd, path, heads, groups)
    assert set(flat) == set(want)
    assert flat["latents.feats_table"].shape == (N_OBJ, P, FD)
    for k, v in want.items():
        assert flat[k].dtype == np.float32, k
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    # the permutation is not the identity: the grouped order moves channels
    qkv = sd["diffusion.denoiser.backbone.resblocks.0.attn.c_qkv.weight"].numpy()
    assert not np.array_equal(flat["diffusion.denoiser.resblocks.0.attn.c_qkv.weight"], qkv)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_converted_denoiser_matches_jax_and_reference_math(geometry, tmp_path):
    width, heads, qkv_groups, groups = GEOMETRIES[geometry]
    sd = reference_state(width, seed=3)
    path = str(tmp_path / "ref.pt")
    torch.save(sd, path)
    config = _config(width, heads, qkv_groups)
    flat, _ = convert_checkpoint(path, config)
    model = NPCD.from_config({**config, "train_dataset": "SyntheticNPCTrain"}).diffusion.denoiser
    assert model.qkv_groups == groups
    model.load_state_dict({k[len("diffusion.denoiser."):]: torch.from_numpy(v)
                           for k, v in flat.items() if k.startswith("diffusion.denoiser.")})
    jparams, _ = _jax_side(sd, path, heads, groups)
    jmodel = JaxTransformer(coords_dim=CD, feats_dim=FD, width=width, layers=LAYERS, heads=heads,
                            attn_impl="einsum", qkv_groups=groups)

    rng = np.random.default_rng(4)
    coords = rng.normal(size=(2, CD, P)).astype(np.float32)
    feats = rng.normal(size=(2, FD, P)).astype(np.float32)
    t = np.array([3, 700])
    with torch.no_grad():
        got = model(torch.from_numpy(coords), torch.from_numpy(feats), torch.from_numpy(t))
        oracle = reference_forward(sd, torch.from_numpy(coords), torch.from_numpy(feats),
                                   torch.from_numpy(t), heads, LAYERS)
    want = jmodel.apply({"params": jparams}, jnp.asarray(coords), jnp.asarray(feats),
                        jnp.asarray(t))
    for g, w, o in zip(got, want, oracle):
        assert float(o.abs().max()) > 0.1  # the output depends on the weights
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), o.numpy(), rtol=1e-5, atol=1e-5)
    # control: the unpermuted c_qkv in the grouped model is another function
    for i in range(LAYERS):
        src = sd[f"diffusion.denoiser.backbone.resblocks.{i}.attn.c_qkv.weight"]
        model.resblocks[i].attn.c_qkv.weight.data.copy_(src)
    with torch.no_grad():
        wrong = model(torch.from_numpy(coords), torch.from_numpy(feats), torch.from_numpy(t))
    assert float((wrong[1] - oracle[1]).abs().max()) > 1e-3


def test_relayout_qkv_roundtrip_and_matches_jax():
    rng = np.random.default_rng(8)
    heads, d, d_in = 4, 8, 16
    w3 = 3 * heads * d
    weight = rng.normal(size=(w3, d_in)).astype(np.float32)  # per-head [q|k|v], [out, in]
    bias = rng.normal(size=(w3,)).astype(np.float32)
    for a, b in [(1, 2), (2, 4), (4, 1), (2, 2)]:
        wa, ba = _permute_qkv_grouped(weight, bias, heads, a)
        wb, bb = _permute_qkv_grouped(weight, bias, heads, b)
        wab, bab = relayout_qkv(wa, ba, heads, a, b)
        np.testing.assert_array_equal(wab, wb)
        np.testing.assert_array_equal(bab, bb)
        waba, baba = relayout_qkv(wab, bab, heads, b, a)
        np.testing.assert_array_equal(waba, wa)
        np.testing.assert_array_equal(baba, ba)
        # npcd_tpu's on the [in, out] kernel: the same permutation
        jk, jb = jax_conv.relayout_qkv(np.ascontiguousarray(wa.T), ba, heads, a, b)
        np.testing.assert_array_equal(jk.T, wab)
        np.testing.assert_array_equal(jb, bab)


def test_saved_npz_loads_and_another_layout_raises(tmp_path):
    width, heads, qkv_groups, groups = GEOMETRIES["16heads-G2"]
    sd = reference_state(width, seed=5)
    path = str(tmp_path / "ref.pt")
    torch.save(sd, path)
    config = {**_config(width, heads, qkv_groups), "train_dataset": "SyntheticNPCTrain"}
    out = str(tmp_path / "ref.npz")
    main(["--weights", path, "--config", str(_write_config(tmp_path, config)), "--out", out])
    with open(out + ".layout.json") as f:
        assert f.read() == '{"qkv_groups": 2}'
    flat, _ = convert_checkpoint(path, config)
    model = NPCD.from_config(config, seed=1)
    state = load_npz(model, out)
    for name, p in model.diffusion.denoiser.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), flat[f"diffusion.denoiser.{name}"])
    for name, p in model.pointnerf.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), flat[f"pointnerf.{name}"])
    np.testing.assert_array_equal(state.feats_norm.max.numpy(), flat["feats_norm.max"])
    # the same shapes under the global layout: the sidecar refuses the load
    other = NPCD.from_config({**config, "model": {**config["model"], "qkv_groups": 1}})
    with pytest.raises(ValueError, match="qkv_groups"):
        load_npz(other, out)
    save_converted(str(tmp_path / "g1.npz"), flat, {"qkv_groups": 1})
    with pytest.raises(ValueError, match="qkv_groups"):
        load_npz(NPCD.from_config(config), str(tmp_path / "g1.npz"))


def _write_config(tmp_path, config):
    import yaml

    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(config))
    return path

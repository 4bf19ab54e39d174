"""The port's SRN data path against npcd_tpu's, on the CPU, on fixture trees
written by tests/srn_fixture.py (2-3 objects x 50 views at 16^2).

Bitwise unless a test says otherwise: the PNG reader against PIL's
``convert("RGB")`` (npcd_tpu's decoder), the split lists, the FPS indices
against ``npcd_tpu.ops.fps`` and the samples of ``SRNCarsTrain`` (images,
cameras, view order, ``get_all_coords``) against npcd_tpu's. npcd_tpu's
side always reads a cached ``pointcloud3_<P>.npz`` (written here with
``npcd_tpu.ops.fps``): without one it would build its native runtime."""
import ctypes
import json
import os
import random
import re
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from npcd_tpu.data import create_dataset as jax_create_dataset
from npcd_tpu.data import dataset as jax_dataset
from npcd_tpu.data import srn as jax_srn
from npcd_tpu.ops.fps import farthest_point_sampling as jax_fps
from npcd_tpu_torch.data import create_dataset, dataset, png, srn
from npcd_tpu_torch.ops.fps import farthest_point_sampling
from npcd_tpu_torch.ops.kernels import build
from npcd_tpu_torch.utils.builders import build_dataset
from npcd_tpu_torch.utils.config import load_config
from srn_fixture import FILTERS, encode_png, write_srn_tree

ROOT = Path(__file__).resolve().parents[1]
SIZE, POINTS, CLOUD = 16, 64, 2000
COLOURS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's small ops: the test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pixels(colour: int, size: int = 24, seed: int = 0) -> np.ndarray:
    """A ramp with noise and a flat patch: every filter meets runs, ramps
    and Paeth's ties."""
    rng = np.random.default_rng([seed, colour])
    c = COLOURS[colour]
    yy, xx = np.mgrid[:size, :size]
    img = (xx[..., None] * rng.integers(1, 5, c) + yy[..., None] * 3
           + rng.integers(0, 8, (size, size, c)))
    img[4:12, 6:14] = rng.integers(0, 256, c)
    return (img % (7 if colour == 3 else 256)).astype(np.uint8)


def _png(tmp_path, colour: int, filters, name="x.png", **kw) -> Path:
    palette = np.random.default_rng(1).integers(0, 256, (7, 3)) if colour == 3 else None
    path = tmp_path / name
    path.write_bytes(encode_png(_pixels(colour, **kw), colour, filters, palette))
    return path


def _pil(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


@pytest.mark.parametrize("filt", FILTERS)
@pytest.mark.parametrize("colour", sorted(COLOURS))
def test_png_reader_matches_pil(tmp_path, colour, filt):
    path = _png(tmp_path, colour, [filt])
    got = png.read_png(str(path))
    assert got.dtype == np.uint8 and got.shape == (24, 24, 3)
    np.testing.assert_array_equal(got, _pil(path))


def test_png_reader_mixed_filters_and_chunks(tmp_path):
    """Rows under all five filters, the IDAT split in three chunks and an
    ancillary chunk before it."""
    data = encode_png(_pixels(2, size=40), 2, FILTERS)
    i = data.index(b"IDAT") - 4
    n = int.from_bytes(data[i:i + 4], "big")
    body = data[i + 8:i + 8 + n]
    parts = [body[:7], body[7:n // 2], body[n // 2:]]
    chunk = lambda k, b: len(b).to_bytes(4, "big") + k + b + zlib.crc32(k + b).to_bytes(4, "big")
    split = data[:i] + chunk(b"tEXt", b"k\x00v") + b"".join(chunk(b"IDAT", p) for p in parts) \
        + data[i + 12 + n:]
    path = tmp_path / "split.png"
    path.write_bytes(split)
    np.testing.assert_array_equal(png.read_png(str(path)), _pil(path))


def _faulty_paeth_lib(tmp_path):
    """csrc/png_unfilter.cpp with Paeth's ties taken in the wrong order (b
    before a, then c before b), built apart."""
    src = (build.CSRC / "png_unfilter.cpp").read_text()
    right = ("    if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);\n"
             "    if (pb <= pc) return static_cast<uint8_t>(b);\n")
    wrong = ("    if (pb <= pa && pb <= pc) return static_cast<uint8_t>(b);\n"
             "    if (pc <= pa) return static_cast<uint8_t>(c);\n"
             "    if (pa < pc) return static_cast<uint8_t>(a);\n")
    assert right in src
    faulty = tmp_path / "png_unfilter_faulty.cpp"
    faulty.write_text(src.replace(right, wrong))
    lib_path = tmp_path / "png_unfilter_faulty.so"
    build.compile_host(faulty, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.png_unfilter.argtypes = png._ARGTYPES
    lib.png_unfilter.restype = ctypes.c_int64
    return lib


def test_png_reader_planted_paeth_fault_fails(tmp_path, monkeypatch):
    """The same Paeth file through an unfilter whose tie order is wrong
    differs from PIL: the comparisons above can see that fault."""
    path = _png(tmp_path, 2, [4], size=48)
    np.testing.assert_array_equal(png.read_png(str(path)), _pil(path))
    monkeypatch.setattr(png, "_unfilter_lib", lambda: _faulty_paeth_lib(tmp_path))
    assert not np.array_equal(png.read_png(str(path)), _pil(path))


@pytest.mark.parametrize("what", ["interlaced", "16-bit", "crc", "palette", "truncated"])
def test_png_reader_refuses(tmp_path, what):
    data = encode_png(_pixels(2), 2)
    if what in ("interlaced", "16-bit"):
        ihdr = bytearray(data[12:29])  # the IHDR chunk's type and body
        ihdr[4 + 12 if what == "interlaced" else 4 + 8] = 1 if what == "interlaced" else 16
        data = data[:12] + bytes(ihdr) + zlib.crc32(bytes(ihdr)).to_bytes(4, "big") + data[33:]
        message = "interlace 1" if what == "interlaced" else "bit depth 16"
    elif what == "crc":
        data = data[:45] + bytes([data[45] ^ 1]) + data[46:]  # a byte of IDAT's body
        message = "bad CRC"
    elif what == "palette":
        palette = np.zeros((3, 3), np.uint8)
        data = encode_png(np.full((4, 4, 1), 5, np.uint8), 3, [0], palette)
        message = "palette index 5"
    else:
        data = data[:-20]
        message = "truncated"
    path = tmp_path / f"{what}.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=re.escape(str(path)) + ".*" + message):
        png.read_png(str(path))


@pytest.mark.parametrize("blacklist", [None, "srn_cars_blacklist.list"])
def test_read_split_matches_npcd_tpu(blacklist):
    got = srn._read_split("cars_train", blacklist)
    assert got == jax_srn._read_split("cars_train", blacklist)
    # 2347: the SRN configs' n_obj
    assert len(got) == (2347 if blacklist else 2458) and got[0][0] == "cars"
    for mod in (srn, jax_srn):
        with pytest.raises(FileNotFoundError, match="srn_chairs_train.list"):
            mod._read_split("chairs_train", None)


def test_get_path_env_override(monkeypatch):
    monkeypatch.delenv("NPCD_TPU_SRN_ROOT", raising=False)
    assert dataset.get_path("srn", "root") == jax_dataset.get_path("srn", "root") == "data"
    assert dataset.get_path("srn", "nothing") is None
    monkeypatch.setenv("NPCD_TPU_SRN_ROOT", "/some/srn")
    assert dataset.get_path("srn", "root") == jax_dataset.get_path("srn", "root") == "/some/srn"


@pytest.mark.parametrize("n,start", [(2000, 0), (3500, 7), (5000, 0)])
def test_fps_matches_npcd_tpu(n, start):
    rng = np.random.default_rng(n)
    points = rng.normal(size=(n, 3)).astype(np.float32) * np.float32([1.0, 0.5, 0.25])
    _, want = jax_fps(points, 512, start)
    sampled, idx = farthest_point_sampling(torch.from_numpy(points), 512, start)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sampled.numpy(), points[np.asarray(want)])
    assert len(set(idx.tolist())) == 512


def _jax_cache(tree: Path, sample_list) -> None:
    """npcd_tpu's own FPS cache of every object of the tree."""
    for c, m, _ in sample_list:
        with np.load(tree / c / m / "pointcloud3.npz") as z:
            points, normals = z["points"], z["normals"]
        _, idx = jax_fps(points, POINTS)
        idx = np.asarray(idx)
        np.savez(tree / c / m / f"pointcloud3_{POINTS}.npz", points=points[idx],
                 normals=normals[idx])


@pytest.mark.parametrize("cache", [True, False], ids=["cached", "fps"])
def test_srn_cars_matches_npcd_tpu(tmp_path, cache):
    ids = ["1a2b", "3c4d", "5e6f"]
    jax_tree, port_tree = tmp_path / "jax", tmp_path / "port"
    sample_list = write_srn_tree(jax_tree, "cars", ids, SIZE, CLOUD, seed=4)
    _jax_cache(jax_tree, sample_list)
    if cache:
        port_tree = jax_tree
    else:
        write_srn_tree(port_tree, "cars", ids, SIZE, CLOUD, seed=4)
    kw = dict(sample_list=sample_list, image_size=SIZE, num_points=POINTS, verbose=False)
    state = random.getstate()
    port = create_dataset("SRNCarsTrain", root=str(port_tree), view_rng=random.Random(11), **kw)
    assert random.getstate() == state  # the global random is never touched
    random.seed(11)
    want = jax_create_dataset("SRNCarsTrain", root=str(jax_tree), **kw)
    assert len(port) == len(want) == 3
    for a, b in zip(port.samples, want.samples):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert type(a[k]) is type(b[k]) and a[k] == b[k], k
    np.testing.assert_array_equal(port.get_all_coords(), want.get_all_coords())
    for c, m, _ in sample_list:  # the port's cache is npcd_tpu's
        with np.load(port_tree / c / m / f"pointcloud3_{POINTS}.npz") as a, \
                np.load(jax_tree / c / m / f"pointcloud3_{POINTS}.npz") as b:
            for k in ("points", "normals"):
                np.testing.assert_array_equal(a[k], b[k])
    # views split into samples of 10, as npcd_tpu splits them
    random.seed(12)
    want10 = jax_create_dataset("SRNCarsTrain", root=str(jax_tree), views_per_sample=10, **kw)
    port10 = create_dataset("SRNCarsTrain", root=str(port_tree), views_per_sample=10,
                            view_rng=random.Random(12), **kw)
    assert len(port10) == len(want10) == 15
    for a, b in zip(port10.samples, want10.samples):
        np.testing.assert_array_equal(a["view_indices"], b["view_indices"])
        np.testing.assert_array_equal(a["images"], b["images"])


def test_srn_default_view_rng_is_seed_0(tmp_path):
    sample_list = write_srn_tree(tmp_path, "cars", ["a"], SIZE, CLOUD)
    kw = dict(root=str(tmp_path), sample_list=sample_list, image_size=SIZE, num_points=POINTS,
              verbose=False)
    a = create_dataset("SRNCarsTrain", **kw)
    b = create_dataset("SRNCarsTrain", view_rng=random.Random(0), **kw)
    np.testing.assert_array_equal(a[0]["view_indices"], b[0]["view_indices"])


def test_srn_errors_name_what_is_missing(tmp_path, monkeypatch):
    sample_list = write_srn_tree(tmp_path / "tree", "cars", ["a"], SIZE, CLOUD)
    kw = dict(sample_list=sample_list, num_points=POINTS, verbose=False)
    with pytest.raises(FileNotFoundError, match="SRN root .*nowhere.* does not exist"):
        create_dataset("SRNCarsTrain", root=str(tmp_path / "nowhere"), image_size=SIZE, **kw)
    with pytest.raises(NotImplementedError, match="000000.png is 16 x 16, image_size 32.*resize"):
        create_dataset("SRNCarsTrain", root=str(tmp_path / "tree"), image_size=32, **kw)
    os.remove(tmp_path / "tree" / "cars" / "a" / "pose" / "000007.txt")
    with pytest.raises(FileNotFoundError, match="cars/a under root .*000007.txt"):
        create_dataset("SRNCarsTrain", root=str(tmp_path / "tree"), image_size=SIZE, **kw)


@pytest.mark.parametrize("config,name", [("npcd_srncars.yaml", "SRNCarsTrain"),
                                         ("npcd_srncars_fast.yaml", "SRNCarsTrain"),
                                         ("npcd_srnchairs.yaml", "SRNChairsTrain")])
def test_srn_configs_build_through_the_registry(tmp_path, monkeypatch, config, name):
    """The SRN configs reach their dataset class; without data the error
    names the missing root, and with an empty root the missing file."""
    cfg = load_config(str(ROOT / "configs" / config))
    assert cfg["train_dataset"] == name
    missing = tmp_path / "no_srn"
    monkeypatch.setenv("NPCD_TPU_SRN_ROOT", str(missing))
    with pytest.raises(FileNotFoundError) as e:
        build_dataset(cfg, view_rng=random.Random(0))
    want = "srn_chairs_train.list" if name == "SRNChairsTrain" else str(missing)
    assert want in str(e.value)
    if name == "SRNCarsTrain":
        missing.mkdir()
        with pytest.raises(FileNotFoundError,
                           match=r"SRN object cars/\w+ under root .*pointcloud3.npz is missing"):
            build_dataset(cfg)


def test_cli_trains_on_srn_then_eval_reads_it(tmp_path):
    """python -m npcd_tpu_torch.train_pointnerf on the tiny config with
    SRNCarsTrain over a fixture tree (2 objects x 50 views at 16^2, batch 1:
    2 steps), then eval_pointnerf on its export over the same tree."""
    sample_list = write_srn_tree(tmp_path / "srn", "cars", ["a", "b"], SIZE, CLOUD)
    text = (ROOT / "configs/npcd_synthetic_tiny.yaml").read_text()
    text = text.replace("train_dataset: SyntheticNPCTrain", "train_dataset: SRNCarsTrain")
    text = re.sub(r"dataset_kwargs:\n(    .*\n)+",
                  f"dataset_kwargs:\n    root: {tmp_path / 'srn'}\n    image_size: {SIZE}\n"
                  f"    num_points: 32\n    sample_list:\n"
                  + "".join(f"        - [{c}, {m}, {i}]\n" for c, m, i in sample_list), text)
    text = text.replace("    n_obj: 8\n", "    n_obj: 2\n", 1)
    text = text.replace("    batch_size: 4\n    max_epochs: 2\n", "    batch_size: 1\n    max_epochs: 1\n")
    config = tmp_path / "srn_tiny.yaml"
    config.write_text(text)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    run = lambda *args: subprocess.run([sys.executable, "-m", *args], cwd=tmp_path, env=env,
                                       capture_output=True, text=True, timeout=600)
    proc = run("npcd_tpu_torch.train_pointnerf", "--config", str(config), "--output",
               str(tmp_path / "pn"), "--device", "cpu", "--no_tensorboard", "--seed", "3")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Initializing dataset SRNCarsTrain" in proc.stdout
    export = tmp_path / "pn" / "weights_only_checkpoints_dir" / "pointnerf-iter-000000002.npz"
    with np.load(export) as z:
        for c, m, i in sample_list:
            with np.load(tmp_path / "srn" / c / m / "pointcloud3_32.npz") as cache:
                np.testing.assert_array_equal(z["latents.coords_table"][i], cache["points"])
    proc = run("npcd_tpu_torch.eval_pointnerf", "--config", str(config), "--weights", str(export),
               "--output", str(tmp_path / "ep"), "--device", "cpu", "--seed", "3")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    rows = json.loads((tmp_path / "ep" / "results.json").read_text())["rows"]
    views = create_dataset("SRNCarsTrain", root=str(tmp_path / "srn"), sample_list=sample_list,
                           image_size=SIZE, num_points=32, view_rng=random.Random(3),
                           verbose=False)
    assert [(r["obj_idx"], r["view"]) for r in rows] == [
        (int(s["obj_idx"]), int(v)) for s in views.samples for v in s["view_indices"]]
    assert all(np.isfinite(r["psnr"]) for r in rows)


def test_batch_loader_collates_srn_samples_as_npcd_tpu(tmp_path):
    """BatchLoader over a dataset with only __getitem__ (SRNCarsTrain, 2
    samples an object) collates npcd_tpu's batches in npcd_tpu's order for
    the same seed (its arrays stay under the 1 MiB of npcd_tpu's native
    collate)."""
    from npcd_tpu_torch.data import BatchLoader

    sample_list = write_srn_tree(tmp_path, "cars", ["a", "b", "c"], SIZE, CLOUD)
    _jax_cache(tmp_path, sample_list)
    kw = dict(root=str(tmp_path), sample_list=sample_list, image_size=SIZE, num_points=POINTS,
              views_per_sample=25, verbose=False)
    port = create_dataset("SRNCarsTrain", view_rng=random.Random(1), **kw)
    random.seed(1)
    want = jax_create_dataset("SRNCarsTrain", **kw)
    loader = BatchLoader(port, 4, seed=9)
    jax_loader = want.get_loader(batch_size=4, shuffle=True, drop_last=True, seed=9)
    for _ in range(2):  # two epochs
        got, expect = list(loader), list(jax_loader)
        assert len(got) == len(expect) == 1
        for a, b in zip(got, expect):
            assert a.keys() == b.keys() and a["obj_name"] == b["obj_name"]
            for k in ("obj_idx", "images", "extrinsics", "intrinsics", "view_indices"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)

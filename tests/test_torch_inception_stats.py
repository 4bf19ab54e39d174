"""The port's Inception-statistics writer (npcd_tpu_torch/
compute_inception_stats.py) against tools/compute_inception_stats.py on an
SRN-format fixture tree (tests/srn_fixture.py): the image batches bitwise
the tool's (the port's PNG reader against PIL), and the pickle main writes
with a scripted stand-in for the Inception graph (a fixed projection of the
pooled uint8 feed, with the graph's ``model(x, return_features=True)``
signature) bitwise the tool's compute_stats with npcd_tpu's extractor of
the same graph; a size that needs a resize raises."""
import pickle

import numpy as np
import pytest
import torch

from npcd_tpu.utils.fidkid import TorchScriptInceptionExtractor as JaxExtractor
from npcd_tpu_torch import compute_inception_stats as port
from srn_fixture import write_srn_tree
from tools import compute_inception_stats as tool

SIZE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class StandInInception(torch.nn.Module):
    """uint8 NCHW images -> a fixed projection of their 4x4-pooled pixels."""

    def __init__(self, dims: int = 24):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.proj = torch.nn.Parameter(torch.randn(3 * (SIZE // 4) ** 2, dims, generator=g))

    def forward(self, x: torch.Tensor, return_features: bool = False) -> torch.Tensor:
        return torch.nn.functional.avg_pool2d(x.float(), 4).flatten(1) @ self.proj


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("srn_test")
    write_srn_tree(root, "cars", ["obj_b", "obj_a", "obj_c"], SIZE, 64)
    return root / "cars"


def test_batches_match_the_tool(tree):
    got = list(port.iter_image_batches(str(tree), SIZE, 32, max_objects=2))
    want = list(tool.iter_image_batches(str(tree), SIZE, 32, max_objects=2))
    assert [b.shape for b in got] == [b.shape for b in want] == [(32, SIZE, SIZE, 3)] * 3 + [
        (4, SIZE, SIZE, 3)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_main_writes_the_tools_pickle(tree, tmp_path):
    graph = str(tmp_path / "inception.pt")
    torch.jit.save(torch.jit.script(StandInInception()), graph)
    out = str(tmp_path / "stats.pkl")
    port.main(["--srn-test-root", str(tree), "--inception", graph, "--out", out,
               "--image-size", str(SIZE), "--batch-size", "40", "--device", "cpu"])
    with open(out, "rb") as f:
        got = pickle.load(f)
    want = tool.compute_stats(tool.iter_image_batches(str(tree), SIZE, 40), JaxExtractor(graph))
    assert set(got) == set(want) == {"mean", "cov", "feats_np"}
    assert got["feats_np"].shape == (150, 24) and got["cov"].shape == (24, 24)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_a_resize_or_no_objects_raises(tree, tmp_path):
    with pytest.raises(NotImplementedError, match="resize"):
        next(port.iter_image_batches(str(tree), 2 * SIZE, 8))
    with pytest.raises(FileNotFoundError, match="rgb"):
        next(port.iter_image_batches(str(tmp_path), SIZE, 8))

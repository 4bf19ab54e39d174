"""``npcd_tpu_torch/ops/kernels/build.py`` names each built library by a
hash of what goes into it, so that an edited source rebuilds: the
``.cu`` file, every ``csrc/*.cuh`` header (one may be included by any
source, so each is hashed into every name), and the flags. Runs on the
CPU: nothing is compiled."""
import shutil

import pytest

from npcd_tpu_torch.ops.kernels import build

NAMES = ("flash_attention", "fused_qkv_attention", "knn")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc that ``build`` reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("edited,renamed", [("tf32_mma.cuh", NAMES),
                                            ("flash_attention.cu", ("flash_attention",)),
                                            ("flags", NAMES)])
def test_an_edit_renames_the_libraries_it_reaches(csrc, monkeypatch, edited, renamed):
    before = {n: build.so_path(n) for n in NAMES}
    assert before == {n: build.so_path(n) for n in NAMES}  # stable while nothing changes
    assert (csrc / "tf32_mma.cuh").exists()
    if edited == "flags":
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    else:
        path = csrc / edited
        path.write_text(path.read_text() + "\n// edited\n")
    after = {n: build.so_path(n) for n in NAMES}
    assert {n for n in NAMES if after[n] != before[n]} == set(renamed)

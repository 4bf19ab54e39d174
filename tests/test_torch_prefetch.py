"""The port's prefetch_to_device against npcd_tpu's, and the stage-1
trainer's loop through it, on the CPU.

prefetch_to_device: the same items in the same order, the producer's
exception raised in the consumer, at most ``size`` items transferred ahead
of the one the consumer holds (npcd_tpu's runs one more: its producer holds
an item while it waits on the full queue), and the producer stopped and
joined when the consumer stops early. The loop: a prefetched run equals
the same trainer stepped inline over ``batches(0)`` bitwise (parameters,
Adam's state, the presample generator), on the synthetic dataset (a batch
is ``dataset.batch``) and on an SRN fixture tree (a batch is a collate of
samples whose pixels are gathered first); a run stopped at an epoch
boundary with the queue full, then resumed, equals an uninterrupted run
bitwise; ``log_interval`` logs the re-render's PSNR, both images and the
feature statistics."""
import contextlib
import itertools
import random
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from npcd_tpu.data.dataset import prefetch_to_device as jax_prefetch
from npcd_tpu_torch.data import SyntheticNPCTrain, create_dataset, prefetch_to_device
from npcd_tpu_torch.train import PointNeRFTraining
from npcd_tpu_torch.train import pointnerf_training
from npcd_tpu_torch.utils import writer
from npcd_tpu_torch.utils.builders import build_pointnerf
from npcd_tpu_torch.utils.config import load_config
from npcd_tpu_torch.utils.util import psnr
from srn_fixture import write_srn_tree

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "configs/npcd_synthetic_tiny.yaml"
WAIT = 10.0  # seconds a test waits for the producer before it fails


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread for this file's tiny models: the test workers share
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Source:
    """An iterable of 0..n-1 that counts what was pulled and transferred,
    and raises at ``fail_at``."""

    def __init__(self, n: int, fail_at=None):
        self.n, self.fail_at = n, fail_at
        self.pulled = self.transferred = 0

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail_at:
                raise ValueError(f"no item {i}")
            self.pulled += 1
            yield i

    def transfer(self, i):
        self.transferred += 1
        return ("on device", i)


def _wait_for(cond) -> bool:
    deadline = time.monotonic() + WAIT
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.002)
    return True


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device"]


@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_order_and_look_ahead(size):
    n = 7
    for impl, bound in ((prefetch_to_device, size), (jax_prefetch, size + 1)):
        src = _Source(n)
        got, ahead = [], []
        with contextlib.closing(impl(src, src.transfer, size)) as items:
            for k, item in enumerate(items):
                got.append(item)
                # the producer fills up to its bound while the consumer holds item k
                assert _wait_for(lambda: src.transferred >= min(n, k + 1 + bound))
                time.sleep(0.02)
                ahead.append(src.transferred - (k + 1))
        assert got == [("on device", i) for i in range(n)]
        assert max(ahead) == bound, (impl.__module__, ahead)
    assert not _prefetch_threads()


@pytest.mark.parametrize("where", ["iterable", "transfer"])
def test_prefetch_raises_the_producers_exception(where):
    for impl in (prefetch_to_device, jax_prefetch):
        src = _Source(6, fail_at=3 if where == "iterable" else None)
        transfer = src.transfer
        if where == "transfer":
            transfer = lambda i: src.transfer(i) if i != 3 else 1 / 0
        got = []
        with pytest.raises(ValueError if where == "iterable" else ZeroDivisionError):
            for item in impl(src, transfer, 2):
                got.append(item[1])
        assert got == [0, 1, 2]
    assert _wait_for(lambda: not _prefetch_threads())


@pytest.mark.parametrize("stop", ["break", "exception"])
def test_prefetch_stops_and_joins_the_producer(stop):
    """The consumer stops with the queue full; closing stops the producer,
    joins it and drops what it staged, and nothing more is pulled."""
    src = _Source(1000)
    items = prefetch_to_device(src, src.transfer, 2)
    with pytest.raises(KeyError) if stop == "exception" else contextlib.nullcontext():
        with contextlib.closing(items):
            for k, item in enumerate(items):
                if k == 1:
                    assert _wait_for(lambda: src.transferred == 4)  # 2 consumed, 2 ahead
                    if stop == "break":
                        break
                    raise KeyError("the step failed")
    assert not _prefetch_threads()
    pulled = src.pulled
    time.sleep(0.05)
    assert src.pulled == pulled == 4


def _trainer(out, dataset=None, n_obj: int = 8, **kw) -> PointNeRFTraining:
    cfg = load_config(str(CONFIG))
    cfg["model"]["n_obj"] = n_obj
    model = build_pointnerf(cfg, torch.Generator().manual_seed(0), with_tables=True)
    dataset = dataset if dataset is not None else SyntheticNPCTrain(**cfg["dataset_kwargs"])
    return PointNeRFTraining(str(out), model, dataset, seed=5, device="cpu", verbose=False,
                             **{**cfg["pointnerf_training"], **kw})


def _assert_same_state(a: PointNeRFTraining, b: PointNeRFTraining) -> None:
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["step"] == sb["step"] and sa["presample_rng"] == sb["presample_rng"]
    assert a._presample_rng.bit_generator.state == b._presample_rng.bit_generator.state
    for k, v in sa["model"].items():
        assert torch.equal(v, sb["model"][k]), k
    opt_a, opt_b = sa["optimizer"]["state"], sb["optimizer"]["state"]
    assert opt_a.keys() == opt_b.keys()
    for i, st in opt_a.items():
        for k, v in st.items():
            assert torch.equal(v, opt_b[i][k]), (i, k)


def _srn_dataset(root):
    """One object's 50 views in 10 samples of 5."""
    sample_list = write_srn_tree(root, "cars", ["a"], 16, 1000)
    return create_dataset("SRNCarsTrain", root=str(root), sample_list=sample_list,
                          views_per_sample=5, image_size=16, num_points=32,
                          view_rng=random.Random(2), verbose=False)


@pytest.mark.parametrize("data", ["synthetic", "srn"])
def test_prefetched_stage1_equals_inline(tmp_path, data):
    """Two steps through the loop (prefetched feeds, pixels gathered per
    sample before stacking) and two inline train_step calls on the full
    batches of batches(0): bitwise the same."""
    ds, n_obj = (None, 8) if data == "synthetic" else (_srn_dataset(tmp_path / "srn"), 1)
    looped = _trainer(tmp_path / "loop", ds, n_obj, max_epochs=1)()
    inline = _trainer(tmp_path / "inline", looped.dataset, n_obj, max_epochs=1)
    assert looped.step == 2
    for batch in itertools.islice(inline.batches(0), 2):
        assert batch["images"].shape[2] == 16 * 16  # the full frames
        inline.train_step(batch)
    _assert_same_state(looped, inline)
    assert not _prefetch_threads()


def test_resume_after_a_stop_with_the_queue_full(tmp_path, monkeypatch):
    """A run checkpoints at the epoch boundary (step 2 of 4) while its
    prefetch thread has drawn two more steps' pixels, then fails; a
    trainer resumed from that checkpoint equals an uninterrupted run
    bitwise. A checkpoint of the producer's generator state (two draws
    ahead) would resume on other pixels."""
    full = _trainer(tmp_path / "full", max_epochs=2)()
    cut = _trainer(tmp_path / "cut", max_epochs=2)
    made = []
    feed = cut._feed
    cut._feed = lambda indices: made.append(indices) or feed(indices)

    def save_due(last_save_time, interval_min, iteration=None):
        if iteration != 2:
            return False
        assert _wait_for(lambda: len(made) == 4)  # 2 consumed, 2 staged ahead
        return True

    monkeypatch.setattr(pointnerf_training, "timed_save_due", save_due)
    train_feed = cut.train_feed

    def fail_after_the_save(feed, draws=None):
        if cut.step == 2:
            raise RuntimeError("stopped")
        return train_feed(feed, draws)

    cut.train_feed = fail_after_the_save
    with pytest.raises(RuntimeError, match="stopped"):
        cut()
    cut.saver.finish()
    assert not _prefetch_threads()
    monkeypatch.undo()
    resumed = _trainer(tmp_path / "cut", max_epochs=2)
    assert resumed.step == 2
    resumed()
    _assert_same_state(full, resumed)


class _Recorder(writer.Writer):
    def __init__(self):
        self.scalars, self.images = {}, {}

    def write_scalar(self, name, value, step):
        self.scalars[name, step] = value

    def write_image(self, name, image, step):
        self.images[name, step] = image


@pytest.fixture
def recorder():
    rec = _Recorder()
    writer._WRITERS.append(rec)
    yield rec
    writer._WRITERS.remove(rec)


def test_log_interval_logs_the_rerender(tmp_path, recorder):
    tr = _trainer(tmp_path, max_epochs=1, log_interval=1)()
    assert tr.step == 2
    for it in (1, 2):
        for name in ("full_render_psnr", "feats_mean_abs", "feats_std_mean"):
            assert np.isfinite(recorder.scalars[f"pointnerf_train/{name}", it])
        for name in ("render", "gt"):
            image = recorder.images[f"pointnerf_train/{name}", it]
            assert image.shape == (16, 16, 3) and 0 <= image.min() and image.max() <= 1
    # step 2's re-render is of its batch's first object and view, on the final weights
    obj = int(next(tr.index_batches(1))[0])
    batch = tr.dataset.batch([obj])
    out = tr.model.eval_forward(torch.tensor([obj]), torch.tensor(batch["intrinsics"][:, :1]),
                                torch.tensor(batch["extrinsics"][:, :1]))
    img = np.clip(out["channels"][0, 0].numpy().reshape(16, 16, 3), 0, 1)
    gt = batch["images"][0, 0].reshape(16, 16, 3)
    assert recorder.scalars["pointnerf_train/full_render_psnr", 2] == psnr(img, gt)
    np.testing.assert_array_equal(recorder.images["pointnerf_train/render", 2], img)
    np.testing.assert_array_equal(recorder.images["pointnerf_train/gt", 2], gt)
    table = tr.model.tables.feats_table.detach()[obj]
    f = table.shape[-1] // 2
    assert recorder.scalars["pointnerf_train/feats_mean_abs", 2] == float(table[:, :f].abs().mean())
    assert recorder.scalars["pointnerf_train/feats_std_mean", 2] == float(
        torch.exp(0.5 * table[:, f:]).mean())


def test_log_interval_failure_never_stops_training(tmp_path, recorder, capsys):
    tr = _trainer(tmp_path, max_epochs=1, log_interval=1)

    def broken(*args, **kw):
        raise RuntimeError("no render")

    tr.model.eval_forward = broken
    tr()
    assert tr.step == 2 and not recorder.images
    assert capsys.readouterr().out.count("qualitative logging failed") == 2

"""The port's utils/profiling.py, utils/writer.py and utils/util.py against
npcd_tpu's on the CPU: the same calls on both sides give the same events,
JSONL lines, histograms and ETAs (the clocks patched), the same splits,
parameter counts, seeded draws and host copies, and the profiling helpers'
CPU behaviour (no memory stats, a trace file, the step timer's burn-in)."""
import json
import random
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import npcd_tpu.utils as jax_utils
from npcd_tpu.utils import profiling as jax_profiling
from npcd_tpu.utils import util as jax_util
from npcd_tpu.utils import writer as jax_writer
import npcd_tpu_torch.utils as utils
from npcd_tpu_torch.utils import profiling, util, writer


def _clock(monkeypatch, name="time", step=0.25):
    """time.<name> as a clock that advances ``step`` a call from 1000."""
    ticks = iter(1000.0 + step * i for i in range(10_000))
    monkeypatch.setattr(time, name, lambda: next(ticks))


class _Record(writer.Writer):
    """A backend that keeps every call."""

    def __init__(self):
        self.calls = []

    def write_scalar(self, name, value, step):
        self.calls.append(("scalar", name, value, step))

    def write_image(self, name, image, step):
        self.calls.append(("image", name, np.asarray(image).tolist(), step))

    def write_histogram(self, name, values, step):
        self.calls.append(("histogram", name, np.asarray(values).tolist(), step))


def _drive(module, out_dir, values, monkeypatch):
    """The same puts, timed blocks and flush through ``module`` -> (the
    events before the flush, the record backend's calls, metrics.jsonl)."""
    monkeypatch.setattr(module, "_max_iterations", None)
    monkeypatch.setattr(module, "_TIME_BUFFERS", {})
    module.EVENT_STORAGE.clear()
    _clock(monkeypatch)
    module.setup_writers(str(out_dir), tensorboard=False)
    rec = _Record()
    module._WRITERS.append(rec)
    module.put_scalar("loss", 0.5, 1)
    module.put_scalar_dict("eval", {"psnr": 20.0, "fid": 3.5}, 2)
    module.put_image("render", np.full((2, 2, 3), 0.25, np.float32), 3)
    module.put_histogram("w", values["w"], 4)
    module.put_histogram_dict("grads", {"a": values["a"], "b": values["b"]}, 5)
    with module.TimeWriter("no_eta", step=5) as t:
        pass
    assert t.duration == 0.25
    module.set_max_iterations(30)
    for step in range(6, 30):  # more than the 20 durations the ETA averages
        with module.TimeWriter("step", step=step):
            time.time()  # durations of 0.5
    with module.TimeWriter("unwritten", step=None):
        pass
    with module.TimeWriter("off", step=1, write=False):
        pass
    events = [(e["kind"], e["name"], np.asarray(e["value"]).tolist(), e["step"])
              for e in module.EVENT_STORAGE]
    module.close_writers()
    assert not module.EVENT_STORAGE and not module._WRITERS
    return events, rec.calls, (out_dir / "metrics.jsonl").read_text().splitlines()


def test_writer_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    values = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "a": rng.normal(size=5).astype(np.float32), "b": np.arange(6.0).reshape(2, 3)}
    want = _drive(jax_writer, tmp_path / "jax", {k: jnp.asarray(v) for k, v in values.items()},
                  monkeypatch)
    got = _drive(writer, tmp_path / "port",
                 {k: torch.from_numpy(v).requires_grad_(k == "w") for k, v in values.items()},
                 monkeypatch)
    assert got == want
    events, calls, lines = got
    kinds = [e[0] for e in events]
    assert kinds.count("histogram") == 3 and kinds.count("image") == 1
    assert [c[0] for c in calls] == kinds  # histograms flushed to the backends
    etas = [json.loads(x) for x in lines if json.loads(x)["name"] == "time/step_eta_hours"]
    assert etas[-1] == {"step": 29, "name": "time/step_eta_hours", "value": 0.5 / 3600,
                        "t": etas[-1]["t"]}
    assert len(lines) == sum(k == "scalar" for k in kinds)


def test_split_num_and_exports():
    for num, size in [(0, 4), (-3, 2), (10, 4), (12, 4), (3, 8), (1000, 16)]:
        assert util.split_num(num, size) == jax_util.split_num(num, size)
    from npcd_tpu_torch.models.diffusion import diffusion_model

    assert diffusion_model.split_num is util.split_num
    names = ("load_config", "print_config", "pointnerf_default_options", "chunks", "split_num",
             "to_numpy", "count_parameters", "psnr", "logging")
    assert all(hasattr(jax_utils, n) and hasattr(utils, n) for n in names)


def test_count_parameters_matches_jax():
    shapes = {"dense": {"kernel": (7, 3), "bias": (3,)}, "table": (11, 4, 2),
              "list": [(5,), (2, 2)], "scalar": (), "none": None}
    make = lambda tree, f: (None if tree is None else {k: make(v, f) for k, v in tree.items()}
                            if isinstance(tree, dict) else [f(s) for s in tree]
                            if isinstance(tree, list) else f(tree))
    want = jax_util.count_parameters(make(shapes, jnp.zeros))
    assert want == 21 + 3 + 88 + 5 + 4 + 1
    assert util.count_parameters(make(shapes, torch.zeros)) == want
    assert util.count_parameters(make(shapes, np.zeros)) == want
    module = torch.nn.Sequential(torch.nn.Linear(7, 3), torch.nn.Linear(3, 2, bias=False))
    assert util.count_parameters(module) == 21 + 3 + 6
    assert util.count_parameters(dict(module.state_dict())) == 30


def test_to_numpy_matches_jax():
    tree = {"a": torch.arange(6.0).reshape(2, 3).requires_grad_(),
            "b": [torch.tensor(1.5), (torch.ones(2, dtype=torch.int32), 3.0)], "c": None}
    got = util.to_numpy(tree)
    want = jax_util.to_numpy({"a": jnp.arange(6.0).reshape(2, 3),
                              "b": [jnp.asarray(1.5), (jnp.ones(2, jnp.int32), 3.0)], "c": None})
    assert isinstance(got["b"], list) and isinstance(got["b"][1], tuple) and got["c"] is None
    flat = lambda t: [t["a"], t["b"][0], t["b"][1][0], t["b"][1][1]]
    for g, w in zip(flat(got), flat(want)):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_set_seed_matches_jax():
    draws = []
    for seed_fn in (jax_util.set_seed, util.set_seed):
        seed_fn(123)
        draws.append((random.random(), np.random.rand(3).tolist()))
    assert draws[0] == draws[1]


def test_backend_initializes():
    """CUDA's initialization probed in a subprocess: False on a CPU-only
    build, True where a card is; a probe past its timeout is False."""
    assert util.backend_initializes(timeout_s=120) == torch.cuda.is_available()
    assert util.backend_initializes(timeout_s=1e-3) is False


def test_device_memory_stats_cpu():
    assert profiling.device_memory_stats() == {} == jax_profiling.device_memory_stats()
    assert profiling.device_memory_stats("cpu") == {}


def test_step_timer_matches_jax(monkeypatch):
    means = []
    for mod, result in ((jax_profiling, jnp.ones(3)), (profiling, torch.ones(3))):
        _clock(monkeypatch, "perf_counter", step=0.5)
        timer = mod.StepTimer(burn_in=2)
        assert timer.mean is None
        for i in range(5):
            with timer.measure(result if i % 2 else None):
                time.perf_counter()  # steps of 1.0
        means.append((timer.mean, len(timer._times)))
    assert means[0] == means[1] == (1.0, 3)


def test_trace_writes_a_file(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("the_block"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert "the_block" in files[0].read_text()

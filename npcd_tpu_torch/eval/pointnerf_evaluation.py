"""Stage-1 evaluation: render every view of each object, report PSNR. Port
of npcd_tpu/eval/pointnerf_evaluation.py: the autodecoder is evaluated on
its own training scenes, each object's views rendered in ``eval_batch_size``
groups at full resolution by ``PointNeRF.eval_forward`` (the feats mean, no
jitter, every ray), one PSNR a view. The time of a forward is measured
between ``torch.cuda.synchronize`` calls after 3 burn-in objects when
``eval_batch_size`` is 1, beside the peak of allocated device memory
(utils/profiling.py's ``device_memory_stats``).
Rows go to ``results.json`` and ``results.csv``, their summary to
``summary.csv`` (and ``results.json``); a run whose ``results.json`` exists
is skipped. Qualitatives: pred | gt of the first view, without labels.

With ``mesh`` (parallel.Mesh) each render call's views shard over the
ranks, as npcd_tpu's mesh shards them: a call whose view count divides by
the world renders each rank's share of its views, any other runs whole on
rank 0 (with ``eval_batch_size`` 1, every call: the time of a forward stays
a one-card measurement). Each rank computes the PSNR of the views it
rendered, the rows are gathered in the object and view order, and rank 0
writes the files; every rank returns the result.
"""
from __future__ import annotations

import json
import os
import os.path as osp
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..generate_samples import write_png
from ..parallel import is_main, mesh_world, shard_batch
from ..utils import logging
from ..utils.profiling import device_memory_stats
from ..utils.util import psnr, write_csv


def _write_frame(path: str, rows: List[Dict]) -> None:
    """Rows under their keys, as pandas writes a DataFrame."""
    write_csv(path, [""] + list(rows[0]), ([i] + list(r.values()) for i, r in enumerate(rows)))


class PointNeRFEvaluation:
    def __init__(self, out_dir: Optional[str] = None, eval_batch_size: int = 1,
                 verbose: bool = True, mesh=None):
        self.mesh = mesh
        self.out_dir = out_dir
        self.eval_batch_size = eval_batch_size
        self.verbose = verbose
        self.burn_in_samples = 3

    @torch.no_grad()
    def __call__(self, dataset, model, samples: Optional[int] = None,
                 sample_indices: Optional[list] = None, qualitatives: int = 10,
                 resolution: int = 128) -> Dict:
        """PSNR of ``model`` (a PointNeRF with its tables) on the objects
        ``sample_indices`` of ``dataset``, or ``samples`` of them spread
        evenly, or all -> {"rows": [{obj_idx, view, psnr}, ...], "summary":
        {psnr, and with eval_batch_size 1 past the burn-in
        time_per_forward_s and, on a GPU, peak_device_mem_mib}}."""
        mesh = self.mesh
        main = is_main(mesh)
        world = mesh_world(mesh)
        results_path = None
        if self.out_dir is not None:
            results_path = osp.join(self.out_dir, "results.json")
            if osp.exists(results_path):
                logging.info(f"Evaluation results exist at {results_path}; skipping.")
                with open(results_path) as f:
                    return json.load(f)
            if main:
                os.makedirs(self.out_dir, exist_ok=True)

        if sample_indices is not None:
            indices = list(sample_indices)
        else:
            indices = list(range(len(dataset)))
            if samples is not None and samples < len(indices):
                indices = list(np.linspace(0, len(indices) - 1, samples).astype(int))

        device = next(model.parameters()).device
        sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
        rows, times = [], []
        for n, idx in enumerate(indices):
            sample = dataset[idx]
            obj_idx = torch.tensor([int(sample["obj_idx"])], device=device)
            extr = torch.as_tensor(sample["extrinsics"], device=device)[None]  # [1, V, 4, 4]
            intr = torch.as_tensor(sample["intrinsics"], device=device)[None]
            gt = np.asarray(sample["images"])  # [V, H*W, 3]
            num_views = extr.shape[1]

            channels, views = [], []  # the views this rank renders
            for start in range(0, num_views, self.eval_batch_size):
                count = min(self.eval_batch_size, num_views - start)
                if count % world == 0:  # this rank's share of the call's views
                    part = shard_batch(range(start, start + count), mesh)
                    sl = slice(part.start, part.stop)
                elif main:  # the whole call on rank 0
                    sl = slice(start, start + count)
                else:
                    continue
                sync()
                t0 = time.perf_counter()
                out = model.eval_forward(obj_idx, intr[:, sl], extr[:, sl], resolution)
                sync()
                if n >= self.burn_in_samples and self.eval_batch_size == 1:
                    times.append(time.perf_counter() - t0)
                channels.append(out["channels"][0].float().cpu().numpy())
                views.extend(range(sl.start, sl.stop))
            channels = np.concatenate(channels, 0) if channels else None  # [v, H*W, 3]

            for i, v in enumerate(views):
                rows.append(((n, v), {
                    "obj_idx": int(sample["obj_idx"]),
                    "view": int(sample["view_indices"][v]) if "view_indices" in sample else v,
                    "psnr": psnr(channels[i], gt[v])}))
            if self.verbose and main and (n % 50 == 0 or n == len(indices) - 1):
                logging.info(f"eval {n + 1}/{len(indices)}: running PSNR "
                             f"{np.mean([r['psnr'] for _, r in rows]):.3f}")
            if main and self.out_dir is not None and n < qualitatives:
                img = lambda a: a[0].reshape(resolution, resolution, 3)  # rank 0 has view 0
                write_png(osp.join(self.out_dir, f"qualitative_{idx:05d}.png"),
                          np.concatenate([img(channels), img(gt)], axis=1))

        if mesh is not None:  # every rank's rows, in the object and view order
            rows = sorted((r for part in mesh.gather_objects(rows) for r in part),
                          key=lambda r: r[0])
        rows = [r for _, r in rows]
        summary = {"psnr": float(np.mean([r["psnr"] for r in rows]))}
        if times:
            summary["time_per_forward_s"] = float(np.mean(times))
            mem = device_memory_stats(device)
            if "peak_bytes_in_use" in mem:
                summary["peak_device_mem_mib"] = mem["peak_bytes_in_use"] / 2**20
        if mesh is not None:  # rank 0's times
            summary = mesh.gather_objects(summary)[0]
        logging.info(f"PointNeRF evaluation: {summary}")

        result = {"rows": rows, "summary": summary}
        if main and results_path is not None:
            with open(results_path, "w") as f:
                json.dump(result, f, indent=1)
            _write_frame(osp.join(self.out_dir, "results.csv"), rows)
            _write_frame(osp.join(self.out_dir, "summary.csv"), [summary])
        return result

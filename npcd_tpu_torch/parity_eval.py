"""PSNR/FID parity against the reference's published numbers, with the
PyTorch port (PSNR 30.2, FID 28.6 on SRN Cars).

Port of tools/parity_eval.py (same flags, the same ``parity.json``), plus
``--device`` (default cuda): convert the reference PyTorch checkpoint to the
port's weights (utils/convert_reference.py), run the stage-1 PSNR
evaluation and the stage-2 generate -> render -> FID evaluation with the
reference protocol (2347 train objects x 50 views at 128²; 1000 generated
objects x 251 test poses, the StyleGAN TorchScript Inception), and print
both numbers beside the targets:

    python -m npcd_tpu_torch.parity_eval \\
        --weights weights/npcd_srncars.pt --srn-root data \\
        --inception data/inception-2015-12-05.pt \\
        --inception-pkl data/cars_test_inception_stylegan.pkl --out runs/parity

``--srn-root`` is the SRN dataset's root as the port's loader reads it
(``<root>/cars/<id>/rgb/...``, the ``[srn] root`` of data/paths.toml), for
``--check-assets`` too. The stats pickle can be written from the raw test
split with ``python -m npcd_tpu_torch.compute_inception_stats``.
``--check-assets`` checks the staged files (ASSETS.md) in seconds and runs
nothing. ``--matmul-precision`` (default ``highest``: exact f32 renders)
is set into the config's ``render_config`` as the eval CLIs set it
(``tensorfloat32``: the render's GEMMs in TF32; ``default``: nothing set).
Every stage takes injectable pieces (dataset,
feature extractor, draws), so tests drive it on synthetic data.
"""
from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle
import random
import sys
from typing import Any, Dict, List, Optional

import numpy as np

PSNR_TARGET = 30.2  # the reference's README, published weights
FID_TARGET = 28.6
SAMPLE_LISTS = osp.join(osp.dirname(osp.realpath(__file__)), "data", "sample_lists")


def convert_weights(weights_path: str, config) -> tuple:
    """Reference npcd_srncars.pt -> (the bridged flat dict, its layout meta),
    utils/convert_reference.convert_checkpoint for the model of ``config``."""
    from .utils.convert_reference import convert_checkpoint

    return convert_checkpoint(weights_path, config)


def check_pointnerf(model, state) -> None:
    """The converted stage-1 weights (eval_pointnerf.stage1_state of the
    flat dict) must drop into ``model`` (a PointNeRF with tables): the same
    names and shapes."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(np.shape(v)) for k, v in state.items()}
    if set(got) != set(want):
        raise ValueError("converted pointnerf params do not match the model: missing "
                         f"{sorted(set(want) - set(got))}, unexpected "
                         f"{sorted(set(got) - set(want))} (config/model mismatch?)")
    for k, shape in want.items():
        if got[k] != shape:
            raise ValueError(f"converted param shape mismatch at {k}: model {shape} vs "
                             f"checkpoint {got[k]}")


def run_psnr(config, flat, out_dir, dataset=None, samples=None, eval_batch_size=1,
             qualitatives=0, device="cuda", seed=42) -> float:
    """Stage-1 parity: PSNR of the converted autodecoder on its training
    scenes (the reference eval_pointnerf protocol) -> the mean over views."""
    import torch

    from .eval import PointNeRFEvaluation
    from .eval_pointnerf import stage1_state
    from .utils.builders import build_dataset, build_pointnerf

    model = build_pointnerf(config, with_tables=True)
    state = stage1_state(flat)
    check_pointnerf(model, state)
    if dataset is None:
        dataset = build_dataset(config, view_rng=random.Random(seed))
    model.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                           for k, v in state.items()})
    model = model.to(device).eval()
    evaluation = PointNeRFEvaluation(out_dir=osp.join(out_dir, "pointnerf") if out_dir else None,
                                     eval_batch_size=eval_batch_size)
    results = evaluation(dataset, model, samples=samples, qualitatives=qualitatives,
                         resolution=model.opts.default_resolution)
    return float(results["summary"]["psnr"])


def run_fid(config, flat, layout, out_dir, inception_path=None, inception_pkl=None,
            feature_extractor=None, num_samples=None, max_poses=None, generate_batch_size=16,
            rng_seed=42, device="cuda", noise=None) -> tuple:
    """Stage-2 parity: FID/KID of generated objects rendered from the fixed
    test poses (the reference eval_diffusion protocol) -> (fid, kid). The
    draws come from ``noise`` (a function of the shape) or else from a
    generator seeded with ``rng_seed``, KID's subsets from ``rng_seed``."""
    import torch

    from .eval import DiffusionEvaluation
    from .models.npcd import NPCD
    from .utils.from_jax import load_flat

    model = NPCD.from_config(config)
    groups = model.diffusion.denoiser.qkv_groups
    if layout.get("qkv_groups") != groups:
        raise ValueError(f"converted c_qkv columns are in the layout {layout}, the model's "
                         f"qkv_groups is {groups}")
    state = load_flat(model, flat)
    model = model.to(device).eval()
    eval_cfg = dict(config.get("diffusion_evaluation", {}))
    if num_samples is not None:
        eval_cfg["num_samples"] = num_samples
    if inception_pkl is not None:
        eval_cfg["inception_pkl_path"] = inception_pkl
    if inception_path is not None:
        eval_cfg["inception_path"] = inception_path
    if feature_extractor is not None:
        eval_cfg["feature_extractor"] = feature_extractor
    evaluation = DiffusionEvaluation(
        out_dir=osp.join(out_dir, "diffusion") if out_dir else None,
        generate_batch_size=generate_batch_size, max_poses=max_poses, device=device, **eval_cfg)
    generator = None if noise is not None else torch.Generator(device=device).manual_seed(rng_seed)
    results = evaluation(model, state, generator=generator, noise=noise, num_qualitatives=0,
                         kid_seed=rng_seed)
    return float(results["fid"]), float(results["kid"])


def _check_weights(weights: str, config, problems: List[str]) -> None:
    import torch

    try:
        sd = torch.load(weights, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "model" in sd and not any(
                k.startswith("pointnerf.") for k in sd):
            sd = sd["model"]
        pn_keys = [k for k in sd if k.startswith("pointnerf.")]
        if not pn_keys:
            problems.append(f"BAD checkpoint {weights}: no 'pointnerf.*' keys "
                            f"(got {sorted(sd)[:5]}...)")
        else:
            # the FlexEmbedding tables ride in extra-state dicts {'emb':
            # {'weight': tensor}}; the feats table's rows are the objects
            n_obj = (config or {}).get("model", {}).get("n_obj")
            feats_keys = [k for k in pn_keys
                          if "feats" in k and "extra_state" in k.replace("-", "_")]
            if n_obj and feats_keys:
                emb = sd[feats_keys[0]]
                while isinstance(emb, dict):
                    emb = next(iter(emb.values())) if emb else None
                rows = np.shape(emb)[0] if emb is not None and np.ndim(emb) else None
                if rows is not None and rows != n_obj:
                    problems.append(f"BAD checkpoint {weights}: feats table has {rows} "
                                    f"objects, config expects {n_obj}")
        if not any(k.startswith("diffusion.") for k in sd):
            problems.append(f"WARN checkpoint {weights}: no 'diffusion.*' keys "
                            "(stage-2 parity will be impossible)")
    except Exception as e:  # noqa: BLE001 - reported, not raised
        problems.append(f"BAD checkpoint {weights}: torch.load failed: {e}")


def _check_srn(srn_root: str, n_sample_ids: int, problems: List[str]) -> None:
    try:
        with open(osp.join(SAMPLE_LISTS, "srn_cars_train.list")) as f:
            ids = [ln.strip() for ln in f if ln.strip()]
    except OSError as e:
        problems.append(f"BAD sample list: {e}")
        ids = []
    missing = lambda what, path: problems.append(f"MISSING {what}: {path}")
    found_any = False
    for oid in ids[:n_sample_ids]:
        obj = osp.join(srn_root, "cars", oid)
        if not osp.isdir(obj):
            missing(f"SRN object dir ({oid})", obj)
            continue
        found_any = True
        for sub in ("rgb/000000.png", "pose/000000.txt", "intrinsics.txt"):
            if not osp.isfile(osp.join(obj, sub)):
                missing(f"SRN file ({oid})", osp.join(obj, sub))
        if not any(osp.isfile(osp.join(obj, n)) for n in ("pointcloud3_512.npz",
                                                          "pointcloud3.npz")):
            missing(f"SRN point cloud ({oid}, pointcloud3_512.npz or pointcloud3.npz for FPS "
                    "fallback)", osp.join(obj, "pointcloud3*.npz"))
    if ids and not found_any:
        problems.append(f"BAD SRN root {srn_root}: none of the first {n_sample_ids} train-list "
                        f"object dirs exist — wrong root? (expected e.g. cars/{ids[0]}/rgb/...)")


def _check_pkl(inception_pkl: str, problems: List[str]) -> None:
    try:
        with open(inception_pkl, "rb") as f:
            d = pickle.load(f)
        for key in ("mean", "cov"):
            if key not in d:
                problems.append(f"BAD inception pkl {inception_pkl}: missing '{key}' "
                                "(reference fidkid.py:47-55 schema)")
        if "mean" in d and np.shape(d["mean"]) != (2048,):
            problems.append(f"BAD inception pkl {inception_pkl}: mean shape "
                            f"{np.shape(d['mean'])}, expected (2048,)")
        if "cov" in d and np.shape(d["cov"]) != (2048, 2048):
            problems.append(f"BAD inception pkl {inception_pkl}: cov shape "
                            f"{np.shape(d['cov'])}, expected (2048, 2048)")
        if "feats_np" not in d:
            problems.append(f"WARN inception pkl {inception_pkl}: no 'feats_np' (KID needs "
                            "per-image features; FID still works)")
    except Exception as e:  # noqa: BLE001 - reported, not raised
        problems.append(f"BAD inception pkl {inception_pkl}: unpickle failed: {e}")


def _check_graph(inception: str, problems: List[str]) -> None:
    import torch

    try:
        torch.jit.load(inception, map_location="cpu")
    except Exception as e:  # noqa: BLE001 - reported, not raised
        problems.append(f"BAD inception graph {inception}: torch.jit.load failed: {e}")


def check_assets(weights=None, srn_root=None, inception=None, inception_pkl=None, config=None,
                 n_sample_ids=3) -> List[str]:
    """Check the ASSETS.md staging without running anything expensive:
    paths, the checkpoint's keys and table size, the SRN layout of the first
    train-list objects under ``<srn_root>/cars``, the TorchScript graph's
    load, the statistics pickle's schema -> problem strings (empty:
    everything is in place; those starting with WARN are not fatal)."""
    problems: List[str] = []
    assets = (
        ("reference checkpoint (npcd_srncars.pt)", weights, osp.isfile,
         lambda: _check_weights(weights, config, problems)),
        ("SRN root dir", srn_root, osp.isdir,
         lambda: _check_srn(srn_root, n_sample_ids, problems)),
        ("StyleGAN Inception TorchScript graph", inception, osp.isfile,
         lambda: _check_graph(inception, problems)),
        ("Inception statistics pickle", inception_pkl, osp.isfile,
         lambda: _check_pkl(inception_pkl, problems)))
    for what, path, exists, check in assets:
        if path is None:
            continue
        if exists(path):
            check()
        else:
            problems.append(f"MISSING {what}: {path}")
    return problems


def parse_args(argv=None):
    from .models.pointnerf.pointnerf import CLI_MATMUL_PRECISIONS

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights", required=True, help="reference npcd_srncars.pt")
    p.add_argument("--config", default="configs/npcd_srncars.yaml")
    p.add_argument("--srn-root", default=None,
                   help="SRN dataset root (<root>/cars/<id>); overrides paths.toml [srn] root")
    p.add_argument("--inception", default=None, help="inception-2015-12-05.pt TorchScript graph")
    p.add_argument("--inception-pkl", default=None, help="cars_test Inception statistics pickle")
    p.add_argument("--out", default="runs/parity")
    p.add_argument("--stage", choices=["both", "psnr", "fid"], default="both")
    p.add_argument("--psnr-samples", type=int, default=None,
                   help="evaluate a subset of objects (default: all 2347)")
    p.add_argument("--num-samples", type=int, default=None,
                   help="generated objects for FID (default: config, 1000)")
    p.add_argument("--max-poses", type=int, default=None,
                   help="pose subset for FID smoke runs (default: all 251)")
    p.add_argument("--generate-batch-size", type=int, default=16)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--validity", choices=["knn", "voxel"], default="voxel",
                   help="the renders' sample-validity test. Default 'voxel': the voxel-grid "
                        "occupancy window the published weights were trained and evaluated "
                        "under; 'knn' is the reference's pure-tensor fallback and the port's "
                        "default for models it trains.")
    p.add_argument("--matmul-precision", default="highest",
                   choices=CLI_MATMUL_PRECISIONS,
                   help="the renders' f32 matmul precision (render_config.matmul_precision): "
                        "highest / float32 exact, tensorfloat32 TF32, default the config's")
    p.add_argument("--check-assets", action="store_true",
                   help="check the staged assets (paths, checkpoint keys, SRN layout, "
                        "TorchScript graph, stats pkl) and exit; nothing is evaluated")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> Optional[Dict[str, Any]]:
    args = parse_args(argv)

    from .generate_samples import _device, exact_f32
    from .models.pointnerf.pointnerf import set_render_precision
    from .utils import logging
    from .utils.config import load_config

    if args.check_assets:
        config = load_config(args.config)
        problems = check_assets(weights=args.weights, srn_root=args.srn_root,
                                inception=args.inception, inception_pkl=args.inception_pkl,
                                config=config)
        hard = [q for q in problems if not q.startswith("WARN")]
        for q in problems:
            print(q)
        if hard:
            print(f"ASSET CHECK FAILED: {len(hard)} problem(s)")
            sys.exit(1)
        print("ASSET CHECK OK" + (f" ({len(problems)} warning(s))" if problems else ""))
        return None

    exact_f32()
    device = _device(args.device)
    if args.srn_root:
        os.environ["NPCD_TPU_SRN_ROOT"] = args.srn_root  # the dataset root's top override
    os.makedirs(args.out, exist_ok=True)
    log_file = osp.join(args.out, "log.txt")
    logging.add_log_file(log_file)
    try:
        with open(osp.join(args.out, "cmd.txt"), "a") as f:
            f.write(" ".join(sys.argv) + "\n")
        config = load_config(args.config)
        config["render_config"] = {**config.get("render_config", {}), "validity": args.validity}
        set_render_precision(config, args.matmul_precision)
        logging.info(f"Converting reference checkpoint {args.weights} ...")
        flat, layout = convert_weights(args.weights, config)

        summary: Dict[str, Any] = {"psnr_target": PSNR_TARGET, "fid_target": FID_TARGET}
        if args.stage in ("both", "psnr"):
            psnr = run_psnr(config, flat, args.out, samples=args.psnr_samples, device=device,
                            seed=args.seed)
            summary["psnr"] = round(psnr, 3)
            logging.info(f"PSNR {psnr:.2f} vs target {PSNR_TARGET} "
                         f"({'PASS' if psnr >= PSNR_TARGET else 'below target'})")
        if args.stage in ("both", "fid"):
            if not layout:
                raise ValueError("checkpoint has no diffusion weights")
            fid, kid = run_fid(config, flat, layout, args.out, inception_path=args.inception,
                               inception_pkl=args.inception_pkl, num_samples=args.num_samples,
                               max_poses=args.max_poses,
                               generate_batch_size=args.generate_batch_size,
                               rng_seed=args.seed, device=device)
            summary["fid"] = round(fid, 3)
            summary["kid_x1000"] = round(kid, 4)
            logging.info(f"FID {fid:.2f} vs target {FID_TARGET} "
                         f"({'PASS' if fid <= FID_TARGET else 'above target'})")
    finally:
        logging.remove_log_file(log_file)

    with open(osp.join(args.out, "parity.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

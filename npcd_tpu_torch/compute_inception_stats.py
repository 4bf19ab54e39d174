"""Compute the real-image Inception statistics pickle for FID/KID, with the
PyTorch port.

Port of tools/compute_inception_stats.py (same flags and the same pickle
{mean, cov, feats_np}, the format the reference's FID reads), plus
``--device`` (default cuda): every view of every SRN test object at
128x128, in [0, 1], fed through the StyleGAN TorchScript Inception graph
with the feed the FID eval gives its fakes
(utils/fidkid.TorchScriptInceptionExtractor) on the card. Images are
decoded by the port's own PNG reader (data/png.py); an image whose size is
not ``--image-size`` raises NotImplementedError, as the SRN loader does
(the reference resizes with PIL, which is not ported).

    python -m npcd_tpu_torch.compute_inception_stats --srn-test-root data/cars_test \\
        --inception data/inception-2015-12-05.pt --out data/cars_test_inception_stylegan.pkl

``--srn-test-root`` holds one ``<obj_id>/rgb/*.png`` directory per object.
"""
from __future__ import annotations

import argparse
import glob
import os.path as osp
import pickle
import sys
from typing import Iterable, Iterator, Optional

import numpy as np


def iter_image_batches(root: str, image_size: int, batch_size: int,
                       max_objects: Optional[int] = None) -> Iterator[np.ndarray]:
    """[B, H, W, 3] f32 batches in [0, 1] over every view of every object,
    objects and views in sorted order."""
    from .data.png import read_png

    obj_dirs = sorted(d for d in glob.glob(osp.join(root, "*")) if osp.isdir(osp.join(d, "rgb")))
    if max_objects is not None:
        obj_dirs = obj_dirs[:max_objects]
    if not obj_dirs:
        raise FileNotFoundError(f"no <obj>/rgb directories under {root}")
    buf = []
    n_views = 0
    for d in obj_dirs:
        for fname in sorted(glob.glob(osp.join(d, "rgb", "*.png"))):
            img = read_png(fname)
            if img.shape[:2] != (image_size, image_size):
                raise NotImplementedError(
                    f"{fname} is {img.shape[1]} x {img.shape[0]}, image size {image_size}: the "
                    "reference resizes with PIL's resize, which the port has not ported (only "
                    "the identity)")
            buf.append(img.astype(np.float32) / 255.0)
            n_views += 1
            if len(buf) == batch_size:
                yield np.stack(buf)
                buf = []
    if buf:
        yield np.stack(buf)
    print(f"{len(obj_dirs)} objects, {n_views} images", file=sys.stderr)


def compute_stats(batches: Iterable[np.ndarray], extractor) -> dict:
    """The extractor over the image batches -> the reference pickle's dict
    {mean, cov, feats_np}."""
    feats_np = np.concatenate([extractor(b) for b in batches], 0)
    return {"mean": feats_np.mean(0), "cov": np.cov(feats_np, rowvar=False),
            "feats_np": feats_np}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--srn-test-root", required=True,
                   help="SRN test split root (one <obj>/rgb/*.png dir per object)")
    p.add_argument("--inception", required=True, help="inception-2015-12-05.pt TorchScript graph")
    p.add_argument("--out", required=True, help="output pickle path")
    p.add_argument("--image-size", type=int, default=128)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--max-objects", type=int, default=None, help="cap object count (smoke runs)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from .generate_samples import _device
    from .utils.fidkid import TorchScriptInceptionExtractor

    extractor = TorchScriptInceptionExtractor(args.inception, device=_device(args.device))
    stats = compute_stats(iter_image_batches(args.srn_test_root, args.image_size,
                                             args.batch_size, args.max_objects), extractor)
    with open(args.out, "wb") as f:
        pickle.dump(stats, f)
    print(f"wrote {args.out}: {stats['feats_np'].shape[0]} features of dim "
          f"{stats['feats_np'].shape[1]}")
    return stats


if __name__ == "__main__":
    main()

"""SRN-format fixture trees and the PNG encoder that writes them (no JAX, no
PIL): the CPU tests and chip_smoke.py's SRN phase read these trees with the
port's loader, the tests also with npcd_tpu's.

A tree holds ``{root}/{category}/{id}/rgb/%06d.png`` (``VIEWS`` views),
``pose/%06d.txt`` (cam2world, one row of 16 numbers), ``intrinsics.txt`` in
SRN's format and ``pointcloud3.npz`` (points and normals). Every image,
pose and cloud is a function of (seed, object, view), so a check can make
again what was written."""
from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

VIEWS = 50
FILTERS = (0, 1, 2, 3, 4)  # None, Sub, Up, Average, Paeth
SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _predictions(rows: np.ndarray, bpp: int) -> List[np.ndarray]:
    """Each filter type's prediction of every byte of rows [H, stride]
    (int32), from the unfiltered bytes left, above and above-left."""
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    upleft = np.zeros_like(rows)
    upleft[1:, bpp:] = rows[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return [np.zeros_like(rows), left, up, (left + up) // 2, paeth]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(pixels: np.ndarray, colour: int = 2, filters: Sequence[int] = FILTERS,
               palette: np.ndarray = None) -> bytes:
    """uint8 pixels [H, W, C] (C 1 grey, 3 RGB, 1 palette index, 2 grey +
    alpha, 4 RGBA for colour types 0, 2, 3, 4, 6) as a PNG at bit depth 8,
    row r filtered with filter type filters[r % len(filters)]."""
    h, w, bpp = pixels.shape
    rows = pixels.reshape(h, w * bpp).astype(np.int32)
    kinds = np.resize(np.asarray(filters, np.uint8), h)  # row r: filters[r % len(filters)]
    filtered = (rows - np.stack(_predictions(rows, bpp))[kinds, np.arange(h)]) % 256
    lines = np.concatenate([kinds[:, None], filtered.astype(np.uint8)], 1)
    out = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    return out + _chunk(b"IDAT", zlib.compress(lines.tobytes())) + _chunk(b"IEND", b"")


def fixture_image(seed: int, obj: int, view: int, size: int) -> np.ndarray:
    """uint8 [size, size, 3]: a gradient with noise and a flat square, so
    that every filter meets flat runs, ramps and ties."""
    rng = np.random.default_rng([seed, obj, view])
    ramp = np.arange(size, dtype=np.uint8)[:, None]
    slope = rng.integers(1, 6, 3, dtype=np.uint8)
    img = ramp[None] * slope + ramp[:, None] * slope[::-1] + rng.integers(0, 256, 3, np.uint8)
    img += rng.integers(0, 8, img.shape, np.uint8)  # uint8: all of it modulo 256
    a, b = sorted(rng.integers(0, size, 2))
    img[a:b + 1, a:b + 1] = rng.integers(0, 256, 3, np.uint8)
    return img


def _cam2world(rng) -> np.ndarray:
    """A camera on a sphere of radius 1.3 looking at the origin (y up), as
    SRN's cars are rendered: cam2world [4, 4]."""
    theta, phi = rng.uniform(0, 2 * np.pi), rng.uniform(0.3, np.pi - 0.3)
    eye = 1.3 * np.array([np.sin(phi) * np.cos(theta), np.cos(phi), np.sin(phi) * np.sin(theta)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross([0.0, 1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    pose = np.eye(4)
    pose[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)
    pose[:3, 3] = eye
    return pose


def fixture_cloud(seed: int, obj: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(points, normals) [n, 3] f32 on the surface of a box in [-0.5, 0.5]^3."""
    rng = np.random.default_rng([seed, obj, 1 << 20])
    points = rng.uniform(-0.5, 0.5, (n, 3))
    axis = rng.integers(0, 3, n)
    side = np.where(rng.uniform(size=n) < 0.5, -0.5, 0.5)
    points[np.arange(n), axis] = side * rng.uniform(0.6, 1.0, 3)[axis]
    normals = np.zeros((n, 3))
    normals[np.arange(n), axis] = np.sign(side)
    return points.astype(np.float32), normals.astype(np.float32)


def write_srn_tree(root: Path, category: str, ids: Sequence[str], size: int,
                   cloud_points: int, seed: int = 0) -> List[Tuple[str, str, int]]:
    """Write the objects ``ids`` of ``category`` under ``root``, on 8
    threads -> their sample list [(category, id, index)]."""

    def write_object(o: int, name: str) -> None:
        path = Path(root) / category / name
        (path / "rgb").mkdir(parents=True, exist_ok=True)
        (path / "pose").mkdir(exist_ok=True)
        rng = np.random.default_rng([seed, o, 1 << 21])
        for v in range(VIEWS):
            (path / "rgb" / f"{v:06d}.png").write_bytes(
                encode_png(fixture_image(seed, o, v, size)))
            np.savetxt(path / "pose" / f"{v:06d}.txt", _cam2world(rng).reshape(1, 16),
                       fmt="%.9f")
        focal = 131.25 * size / 128
        (path / "intrinsics.txt").write_text(
            f"{focal} {size / 2} {size / 2} 0.\n0. 0. 0.\n1.\n{size} {size}\n")
        points, normals = fixture_cloud(seed, o, cloud_points)
        np.savez(path / "pointcloud3.npz", points=points, normals=normals)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write_object, range(len(ids)), ids))
    return [(category, name, o) for o, name in enumerate(ids)]

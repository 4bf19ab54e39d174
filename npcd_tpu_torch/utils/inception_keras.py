"""InceptionV3 pool features from keras weights, for FID/KID on the card.

Port of npcd_tpu/utils/inception_jax.py. The module is named for the
weights it reads, not for JAX: the tf-keras InceptionV3 (the TF-slim 2016
architecture, which pytorch-fid ports too) over an explicit weight list of
(kernel HWIO, bn beta, bn mean, bn var) per conv2d_bn call, as the release
file inception_v3_weights_tf_dim_ordering_tf_kernels_notop.h5 or any
tf-keras InceptionV3 holds them. A config names it as npcd_tpu's schema
does, ``feature_extractor: inception_jax:<weights.h5>``.

The network is plain PyTorch (``F.conv2d``, ``F.max_pool2d``,
``F.avg_pool2d``, ``F.interpolate``): npcd_tpu computes it with XLA's
convolutions and reduce_window, outside any Pallas kernel. Each block's
BatchNorm (scale=False, eps 1e-3) is folded into its convolution's weight
and bias. ``KerasInceptionExtractor`` keeps the eval's generate -> render ->
score loop on the card: a CUDA tensor of renders is resized and scored
there, and only the [N, 2048] features come back to the host.

FID values depend on the Inception weights and the resize: numbers from
this extractor match any keras-weights pipeline with a bilinear resize, not
the StyleGAN TorchScript graph's (utils/fidkid.py) behind the published FID.
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-3
SIZE = 299  # the network's input, SIZE x SIZE


def _mixed_35(c_in: int, pool: int) -> list:
    """Mixed 0-2: 1x1 | 1x1, 5x5 | 1x1, 3x3, 3x3 | avg pool, 1x1."""
    return [(1, 1, c_in, 64), (1, 1, c_in, 48), (5, 5, 48, 64), (1, 1, c_in, 64),
            (3, 3, 64, 96), (3, 3, 96, 96), (1, 1, c_in, pool)]


def _mixed_17(c: int) -> list:
    """Mixed 4-7 on 768 channels: 1x1 | 1x1, 1x7, 7x1 | 1x1, 7x1, 1x7, 7x1,
    1x7 | avg pool, 1x1."""
    return [(1, 1, 768, 192), (1, 1, 768, c), (1, 7, c, c), (7, 1, c, 192), (1, 1, 768, c),
            (7, 1, c, c), (1, 7, c, c), (7, 1, c, c), (1, 7, c, 192), (1, 1, 768, 192)]


def _mixed_8(c_in: int) -> list:
    """Mixed 9-10: 1x1 | 1x1, (1x3 | 3x1) | 1x1, 3x3, (1x3 | 3x1) | avg pool,
    1x1."""
    return [(1, 1, c_in, 320), (1, 1, c_in, 384), (1, 3, 384, 384), (3, 1, 384, 384),
            (1, 1, c_in, 448), (3, 3, 448, 384), (1, 3, 384, 384), (3, 1, 384, 384),
            (1, 1, c_in, 192)]


def _same(rows: list) -> list:
    return [r + (1, "SAME") for r in rows]


# (kh, kw, c_in, c_out, stride, padding) of each conv2d_bn call, in keras
# call order (npcd_tpu's inception_v3_features); every SAME one has stride 1
CONVS: Tuple[Tuple[int, int, int, int, int, str], ...] = tuple(
    [(3, 3, 3, 32, 2, "VALID"), (3, 3, 32, 32, 1, "VALID"), (3, 3, 32, 64, 1, "SAME"),
     (1, 1, 64, 80, 1, "VALID"), (3, 3, 80, 192, 1, "VALID")]
    + _same(_mixed_35(192, 32)) + _same(_mixed_35(256, 64)) + _same(_mixed_35(288, 64))
    + [(3, 3, 288, 384, 2, "VALID"), (1, 1, 288, 64, 1, "SAME"), (3, 3, 64, 96, 1, "SAME"),
       (3, 3, 96, 96, 2, "VALID")]
    + _same(_mixed_17(128)) + _same(_mixed_17(160)) + _same(_mixed_17(160))
    + _same(_mixed_17(192))
    + [(1, 1, 768, 192, 1, "SAME"), (3, 3, 192, 320, 2, "VALID"), (1, 1, 768, 192, 1, "SAME"),
       (1, 7, 192, 192, 1, "SAME"), (7, 1, 192, 192, 1, "SAME"), (3, 3, 192, 192, 2, "VALID")]
    + _same(_mixed_8(1280)) + _same(_mixed_8(2048)))
N_CONV = len(CONVS)  # 94
FEATURE_DIM = 2048

Block = Tuple[torch.Tensor, torch.Tensor]  # folded weight [c_out, c_in, kh, kw], bias [c_out]


def fold_conv_bn(kernel: np.ndarray, beta: np.ndarray, mean: np.ndarray, var: np.ndarray,
                 device="cpu") -> Block:
    """One keras conv2d_bn block's weights, kernel [kh, kw, c_in, c_out]
    (HWIO) and its BatchNorm's beta, moving mean and moving variance, as
    one convolution: weight kernel * r in OIHW and bias beta - mean * r,
    r = 1 / sqrt(var + 1e-3), folded in float64 and rounded to f32."""
    r = 1.0 / np.sqrt(np.asarray(var, np.float64) + _EPS)
    w = np.asarray(kernel, np.float64).transpose(3, 2, 0, 1) * r[:, None, None, None]
    b = np.asarray(beta, np.float64) - np.asarray(mean, np.float64) * r
    return (torch.as_tensor(w.astype(np.float32), device=device).contiguous(),
            torch.as_tensor(b.astype(np.float32), device=device))


def torch_params(weights: Sequence[Sequence[np.ndarray]], device="cpu") -> List[Block]:
    """npcd_tpu's weight list, 94 (kernel HWIO, beta, mean, var) tuples in
    keras call order, as the port's folded blocks on ``device``. Raises
    ValueError where the list does not fit CONVS (npcd_tpu's "wrong weight
    list")."""
    weights = list(weights)
    if len(weights) > N_CONV:
        raise ValueError(f"{len(weights) - N_CONV} unused inception params — wrong weight list")
    if len(weights) < N_CONV:
        raise ValueError(f"{N_CONV - len(weights)} inception params missing — wrong weight list")
    out = []
    for i, (p, (kh, kw, ci, co, _, _)) in enumerate(zip(weights, CONVS)):
        kernel, beta, mean, var = p
        if tuple(np.shape(kernel)) != (kh, kw, ci, co) or any(
                np.shape(v) != (co,) for v in (beta, mean, var)):
            raise ValueError(f"inception block {i}: kernel {np.shape(kernel)}, bn "
                             f"{[np.shape(v) for v in (beta, mean, var)]}; want {(kh, kw, ci, co)} "
                             f"and ({co},) — wrong weight list")
        out.append(fold_conv_bn(kernel, beta, mean, var, device))
    return out


def random_weights(seed: int = 0) -> List[Tuple[np.ndarray, ...]]:
    """Seeded random weights in npcd_tpu's layout that keep the features
    O(1) through the 94 blocks: kernels normal with variance 2 / fan-in,
    beta and mean normal with scale 0.1, var uniform in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    out = []
    for kh, kw, ci, co, _, _ in CONVS:
        kernel = rng.normal(scale=np.sqrt(2.0 / (kh * kw * ci)), size=(kh, kw, ci, co))
        beta, mean = rng.normal(scale=0.1, size=(2, co))
        var = rng.uniform(0.5, 1.5, co)
        out.append(tuple(a.astype(np.float32) for a in (kernel, beta, mean, var)))
    return out


# -- the network (NCHW) ---------------------------------------------------------------


def conv_bn(x: torch.Tensor, p: Block, stride: int, padding: str) -> torch.Tensor:
    """Conv (no bias) + BatchNorm (scale=False) + relu, the keras conv2d_bn
    block, with the BatchNorm folded into ``p`` (fold_conv_bn). SAME at
    stride 1 pads each axis by (k - 1) / 2 (every kernel here is odd)."""
    w, b = p
    pad = (w.shape[2] // 2, w.shape[3] // 2) if padding == "SAME" else 0
    return F.relu(F.conv2d(x, w, b, stride, pad))


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3, stride 2, VALID."""
    return F.max_pool2d(x, 3, 2)


def avg_pool_same(x: torch.Tensor) -> torch.Tensor:
    """3x3, stride 1, SAME, with TF's divisor: padded cells are not counted."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


def inception_v3_features(params: Sequence[Block], x: torch.Tensor) -> torch.Tensor:
    """x [N, 3, H, W] in [-1, 1] (NCHW; npcd_tpu's takes NHWC) -> pool
    features [N, 2048]; walks CONVS in keras call order, the branches
    concatenated in npcd_tpu's order."""
    if len(params) != N_CONV:
        raise ValueError(f"{len(params)} inception params, {N_CONV} expected — wrong weight list")
    blocks: Iterator = zip(params, CONVS)

    def cb(x):
        p, (_, _, _, _, stride, padding) = next(blocks)
        return conv_bn(x, p, stride, padding)

    cat = lambda ts: torch.cat(ts, dim=1)
    x = cb(cb(cb(x)))                      # 149², 147², 147² x 64
    x = cb(cb(max_pool(x)))                # 73² x 80, 71² x 192
    x = max_pool(x)                        # 35² x 192
    for _ in range(3):                     # mixed 0-2: 35²
        b1 = cb(x)
        b5 = cb(cb(x))
        b3 = cb(cb(cb(x)))
        x = cat([b1, b5, b3, cb(avg_pool_same(x))])
    b3 = cb(x)                             # mixed 3: 17² x 768
    x = cat([b3, cb(cb(cb(x))), max_pool(x)])
    for _ in range(4):                     # mixed 4-7: 17² x 768
        b1 = cb(x)
        b7 = cb(cb(cb(x)))
        b7d = cb(cb(cb(cb(cb(x)))))
        x = cat([b1, b7, b7d, cb(avg_pool_same(x))])
    b3 = cb(cb(x))                         # mixed 8: 8² x 1280
    x = cat([b3, cb(cb(cb(cb(x)))), max_pool(x)])
    for _ in range(2):                     # mixed 9-10: 8² x 2048
        b1 = cb(x)
        b3 = cb(x)
        b3 = cat([cb(b3), cb(b3)])
        b3d = cb(cb(x))
        b3d = cat([cb(b3d), cb(b3d)])
        x = cat([b1, b3, b3d, cb(avg_pool_same(x))])
    return x.mean(dim=(2, 3))


def conv_flops(size: int = SIZE) -> int:
    """The floating-point operations (2 per multiply-add) of the 94
    convolutions for one size x size image, counted by walking the network
    over CONVS on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    params = [(torch.empty(co, ci, kh, kw, device="meta"), torch.empty(co, device="meta"))
              for kh, kw, ci, co, _, _ in CONVS]
    with FlopCounterMode(display=False) as counter:
        inception_v3_features(params, torch.empty(1, 3, size, size, device="meta"))
    return counter.get_total_flops()


# -- weight loading -----------------------------------------------------------------


def params_from_keras_model(model) -> List[Tuple[np.ndarray, ...]]:
    """(kernel, beta, mean, var) tuples of a live tf-keras InceptionV3
    (include_top=False), ordered by layer creation index (the _N suffix of
    the generated names; model.layers is sorted topologically, which orders
    parallel branches otherwise). The Nth Conv2D pairs with the Nth
    BatchNormalization."""

    def idx(name: str, base: str) -> int:
        rest = name[len(base):]
        return 0 if rest == "" else int(rest.lstrip("_"))

    convs, bns = {}, {}
    for layer in model.layers:
        cls = type(layer).__name__
        if cls == "Conv2D":
            convs[idx(layer.name, "conv2d")] = layer.get_weights()[0]
        elif cls == "BatchNormalization":
            bns[idx(layer.name, "batch_normalization")] = layer.get_weights()
    if len(convs) != N_CONV or len(bns) != N_CONV:
        raise ValueError(f"expected {N_CONV} conv/bn layers, got {len(convs)}/{len(bns)}")
    return [(convs[i].astype(np.float32),) + tuple(w.astype(np.float32) for w in bns[i])
            for i in range(N_CONV)]


def load_keras_h5(path: str) -> List[Tuple[np.ndarray, ...]]:
    """A keras InceptionV3 weight file, read with h5py -> the 94 (kernel,
    beta, mean, var) tuples. Takes both layer namings: tf-keras saves
    creation indices 0-based ('conv2d', 'conv2d_1', ...), the Keras-2.0-era
    release file 1-based ('conv2d_1' .. 'conv2d_94'); and both leaf layouts,
    <layer>/<weight>:0 and <layer>/<layer>/<weight>:0."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"reading the keras weights {path!r} needs h5py, which is not "
                          "installed") from e

    params = []
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        offset = 0 if "conv2d" in root else 1
        if offset and "conv2d_1" not in root:
            raise ValueError(f"{path!r} has neither 'conv2d' nor 'conv2d_1' layer groups; "
                             f"found: {sorted(root.keys())[:8]}...")

        def name(base, i):
            j = i + offset
            return base if j == 0 else f"{base}_{j}"

        def leaf(g, wname):
            if wname in g:
                return np.asarray(g[wname])
            return np.asarray(g[list(g.keys())[0]][wname])

        for i in range(N_CONV):
            cg = root[name("conv2d", i)]
            bg = root[name("batch_normalization", i)]
            params.append(tuple(a.astype(np.float32) for a in (
                leaf(cg, "kernel:0"), leaf(bg, "beta:0"), leaf(bg, "moving_mean:0"),
                leaf(bg, "moving_variance:0"))))
    return params


# -- the extractor --------------------------------------------------------------------


def resize(images: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 3] -> [N, 3, 299, 299] f32, bilinear with half-pixel
    centres (jax.image.resize's "bilinear"): antialiased where H or W is
    above 299, as jax.image.resize widens its triangle kernel along an axis
    it shrinks (F.interpolate's antialias widens it there only too)."""
    x = images.permute(0, 3, 1, 2).float()
    h, w = x.shape[2:]
    if (h, w) == (SIZE, SIZE):
        return x
    return F.interpolate(x, size=(SIZE, SIZE), mode="bilinear", align_corners=False,
                         antialias=h > SIZE or w > SIZE)


@contextlib.contextmanager
def _exact_f32_convolutions() -> Iterator[None]:
    """cuDNN's TF32 off for the body, then restored. The flag is
    process-wide; of the eval's work only this network runs convolutions,
    and the eval finishes the extractor before a render that sets the flags
    itself."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


class KerasInceptionExtractor:
    """InceptionV3 pool features on ``device`` (a fidkid.FIDKID plug-in),
    npcd_tpu's JaxInceptionExtractor.

    images [N, H, W, 3] in [0, 1], numpy or a tensor (moved to ``device``
    where it lies elsewhere; a CUDA tensor never visits the host) ->
    features [N, 2048] numpy. Resizes to 299² bilinear with half-pixel
    centres, antialiased along an axis it shrinks (as jax.image.resize),
    maps to [-1, 1] by x * 2 - 1 and runs ``batch_size`` images at a time;
    when N > batch_size the last chunk is padded to the batch with copies
    of its first image, as npcd_tpu's. ``weights``: a .h5 path
    (load_keras_h5) or npcd_tpu's list of (kernel, beta, mean, var). The
    convolutions run in exact f32: cuDNN's TF32 is off for the call."""

    feature_dim = FEATURE_DIM
    device_resident = True

    def __init__(self, weights: Any, batch_size: int = 64, device="cuda"):
        if isinstance(weights, str):
            weights = load_keras_h5(weights)
        self.device = torch.device(device)
        self.params = torch_params(weights, self.device)
        self.batch_size = batch_size

    @torch.no_grad()
    def features(self, images: torch.Tensor) -> torch.Tensor:
        """One batch [n, H, W, 3] in [0, 1] on ``device`` -> [n, 2048] there."""
        with _exact_f32_convolutions():
            return inception_v3_features(self.params, resize(images) * 2.0 - 1.0)

    @torch.no_grad()
    def __call__(self, images) -> np.ndarray:
        if isinstance(images, torch.Tensor):
            images = images.to(self.device)
        else:
            images = torch.as_tensor(np.asarray(images, np.float32), device=self.device)
        n, bs = len(images), self.batch_size
        out = []
        for i in range(0, n, bs):
            chunk = images[i:i + bs]
            m = len(chunk)
            if m < bs and n > bs:  # one batch shape, as npcd_tpu's compiled one
                chunk = torch.cat([chunk, chunk[:1].expand(bs - m, -1, -1, -1)])
            out.append(self.features(chunk)[:m])
        return torch.cat(out).cpu().numpy()

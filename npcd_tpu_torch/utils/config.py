"""Config loading for the PyTorch port.

A copy of npcd_tpu/utils/config.py: importing anything from ``npcd_tpu``
loads JAX (npcd_tpu/__init__.py -> utils/util.py), and the port runs where
JAX is absent, so it carries its own YAML loader (with the
``!!python/tuple`` tag of the EMA params) and the typed PointNeRF option
dataclasses. Keep the two files in step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import yaml


class _AttrDict(dict):
    """dict with attribute access, recursively applied on load."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value


def _to_attrdict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return _AttrDict({k: _to_attrdict(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_attrdict(v) for v in obj)
    return obj


class _ConfigLoader(yaml.SafeLoader):
    """SafeLoader that additionally understands !!python/tuple.

    The reference configs use ``!!python/tuple`` for EMA parameter tuples;
    we support the tag without the arbitrary-code-execution surface of
    yaml.FullLoader.
    """


_ConfigLoader.add_constructor(
    "tag:yaml.org,2002:python/tuple",
    lambda loader, node: tuple(loader.construct_sequence(node)),
)


def load_config(path: str) -> _AttrDict:
    with open(path, "r") as f:
        cfg = yaml.load(f, Loader=_ConfigLoader)
    return _to_attrdict(cfg)


def print_config(config: Dict[str, Any], indent: int = 0) -> None:
    for key, val in config.items():
        if isinstance(val, dict):
            print("  " * indent + f"{key}:")
            print_config(val, indent + 1)
        else:
            print("  " * indent + f"{key}: {val}")


# ---------------------------------------------------------------------------
# PointNeRF defaults — typed equivalent of the reference's hardcoded options
# (reference npcd/models/pointnerf/pointnerf.py:134-194).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VoxelGridOptions:
    voxel_size: Tuple[float, float, float] = (0.04, 0.04, 0.04)
    voxel_scale: Tuple[float, float, float] = (2.0, 2.0, 2.0)
    kernel_size: Tuple[int, int, int] = (3, 3, 3)
    max_points_per_voxel: int = 4
    max_occ_voxels_per_example: int = 5000
    ranges: Tuple[float, float, float, float, float, float] = (
        -1.0, -1.0, -1.0, 1.0, 1.0, 1.0)

    @property
    def scaled_voxel_size(self) -> Tuple[float, float, float]:
        return tuple(s * c for s, c in zip(self.voxel_size, self.voxel_scale))


@dataclasses.dataclass(frozen=True)
class AggregatorOptions:
    k: int = 8
    r: float = 2.0  # in units of the scaled voxel size
    max_shading_pts: int = 50
    ray_subsamples: int = 128
    n_freqs: int = 10
    freq_mult: float = 1.0
    out_dim: int = 256
    layers: Tuple[int, ...] = (256, 256, 256, 256)
    activation: str = "leaky_relu"
    layer_norm: bool = False
    # 'direct' matches the reference op-for-op; 'anchored' (default)
    # re-anchors the double-angle recurrence with direct sin/cos every 5
    # octaves (4 transcendentals/element instead of 20, max deviation from
    # 'direct' ~1.2e-5); 'recurrence' is the 2-transcendental variant
    # (~7e-3 max deviation) - see nn_core.positional_encoding
    posenc_method: str = "anchored"


@dataclasses.dataclass(frozen=True)
class FieldOptions:
    nerf: bool = True
    feat_freqs: int = 0
    dir_freqs: int = 8
    channel_layers: Tuple[int, ...] = (256, 256, 256, 256)
    shape_layers: Tuple[int, ...] = (256,)
    activation: str = "leaky_relu"
    layer_norm: bool = False
    use_dir: bool = False


@dataclasses.dataclass(frozen=True)
class RendererOptions:
    depth_resolution: int = 128
    disparity_space_sampling: bool = False
    white_back: bool = True
    cube_scale: float = 1.0
    ray_subsamples: int = 112
    ray_limits: Optional[Tuple[float, float]] = None


@dataclasses.dataclass(frozen=True)
class PointNeRFOptions:
    num_points: int = 512
    feat_dim: int = 32
    voxel_grid: VoxelGridOptions = dataclasses.field(default_factory=VoxelGridOptions)
    aggregator: AggregatorOptions = dataclasses.field(default_factory=AggregatorOptions)
    field: FieldOptions = dataclasses.field(default_factory=FieldOptions)
    renderer: RendererOptions = dataclasses.field(default_factory=RendererOptions)
    default_resolution: int = 128

    @property
    def knn_radius(self) -> float:
        """Absolute-space neighbor radius: r voxels * scaled voxel size."""
        return self.aggregator.r * max(self.voxel_grid.scaled_voxel_size)


def pointnerf_default_options(
    num_points: int = 512,
    feat_dim: int = 32,
    use_view_dir: bool = False,
    **overrides: Any,
) -> PointNeRFOptions:
    """Build PointNeRF options, mirroring the yaml-overridable subset of the
    reference (`use_dir`, `feat_dim`, `num`; pointnerf.py:15-17)."""
    field = FieldOptions(use_dir=use_view_dir)
    opts = PointNeRFOptions(num_points=num_points, feat_dim=feat_dim, field=field)
    if overrides:
        opts = dataclasses.replace(opts, **overrides)
    return opts

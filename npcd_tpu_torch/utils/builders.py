"""Model and dataset construction from the YAML config. Port of the
PointNeRF, denoiser and dataset builders of npcd_tpu/utils/builders.py,
with the same optional ``pointnerf_options`` (flat option overrides),
``render_config`` and ``dataset_kwargs`` sections."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from .config import PointNeRFOptions, pointnerf_default_options


def _apply_flat_overrides(opts: PointNeRFOptions, overrides: Dict[str, Any]) -> PointNeRFOptions:
    """Route flat override keys to the sub-dataclass(es) that have them."""
    consumed = set()
    for field in ("voxel_grid", "aggregator", "field", "renderer"):
        sub = getattr(opts, field)
        names = {f.name for f in dataclasses.fields(sub)}
        sub_overrides = {k: v for k, v in overrides.items() if k in names}
        if sub_overrides:
            consumed |= set(sub_overrides)
            opts = dataclasses.replace(opts, **{field: dataclasses.replace(sub, **sub_overrides)})
    scalar_fields = {f.name for f in dataclasses.fields(opts)
                     if not dataclasses.is_dataclass(getattr(opts, f.name))}
    top = {k: v for k, v in overrides.items() if k in scalar_fields}
    unknown = set(overrides) - consumed - set(top)
    if unknown:
        raise KeyError(f"unknown pointnerf_options overrides: {sorted(unknown)}")
    return dataclasses.replace(opts, **top) if top else opts


def build_pointnerf_options(config: Dict[str, Any]) -> PointNeRFOptions:
    model_cfg = config["model"]
    opts = pointnerf_default_options(
        num_points=model_cfg["num_points"], feat_dim=model_cfg["feats_dim"],
        use_view_dir=model_cfg.get("use_view_dir", False))
    if "pointnerf_options" in config:
        opts = _apply_flat_overrides(opts, config["pointnerf_options"])
    return opts


def build_pointnerf(config: Dict[str, Any], generator=None, with_tables: bool = False):
    """The PointNeRF decoder; ``with_tables`` adds the stage-1 latent tables
    of ``model.n_obj`` objects."""
    from ..models.pointnerf.pointnerf import PointNeRF, PointNeRFRenderConfig

    render_config = None
    if "render_config" in config:
        render_config = PointNeRFRenderConfig(**dict(config["render_config"]))
    n_obj = config["model"]["n_obj"] if with_tables else None
    return PointNeRF(build_pointnerf_options(config), render_config, generator, n_obj)


def build_dataset(config: Dict[str, Any]):
    from ..data.synthetic import DATASETS

    name = config["train_dataset"]
    if name not in DATASETS:
        raise KeyError(f"unknown train_dataset {name!r}; the port has {sorted(DATASETS)}")
    return DATASETS[name](**dict(config.get("dataset_kwargs", {})))


def build_diffusion_model(config: Dict[str, Any]):
    from ..models.diffusion.diffusion_model import DiffusionModel

    m = config["model"]
    return DiffusionModel(
        coords_dim=m["coords_dim"], feats_dim=m["feats_dim"], num_points=m["num_points"],
        width=m["width"], layers=m["layers"], heads=m["heads"],
        qkv_groups=m.get("qkv_groups"))

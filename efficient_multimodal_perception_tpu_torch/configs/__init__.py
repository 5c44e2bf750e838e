"""Python-module configs: each exposes ``get_config() -> dict``."""

from __future__ import annotations

import ast
import copy
import importlib

# name -> (module, function returning the config)
_CONFIGS = {
    "triplane_occ": ("triplane_occ", "get_config"),
    "triplane_range_cam": ("triplane_range_cam", "get_config"),
    "point_triplane_occ": ("point_triplane_occ", "get_config"),
    "triplane_elev": ("triplane_elev", "get_config"),
    "triplane_surf_sam": ("triplane_surf_sam", "get_config"),
    "point_triplane": ("point_triplane", "get_config"),
    "nuscenes_range": ("nuscenes_range", "get_config"),
    "tiny_occ": ("tiny", "get_config"),
    "tiny_occ_run": ("tiny_occ_run", "get_config"),
    "tiny_point_occ": ("tiny", "get_point_occ_config"),
    "tiny_range_cam": ("tiny", "get_range_cam_config"),
    "tiny_elev": ("tiny", "get_elev_config"),
    "tiny_surf_sam": ("tiny", "get_surf_sam_config"),
    "tiny_point": ("tiny", "get_point_config"),
}
CONFIG_NAMES = tuple(_CONFIGS)


def get_config(name: str) -> dict:
    """Load a named config (one of ``CONFIG_NAMES``)."""
    name = name.replace(".py", "").split("/")[-1]
    if name not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; known: {CONFIG_NAMES}")
    mod, fn = _CONFIGS[name]
    mod = importlib.import_module(f"{__name__}.{mod}")
    return copy.deepcopy(getattr(mod, fn)())


def apply_overrides(cfg: dict, options) -> dict:
    """Apply ``key.sub=value`` overrides (``--cfg-options``); a value is
    read as a Python literal where it parses as one, else kept as text."""
    for opt in options or []:
        key, _, raw = opt.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg

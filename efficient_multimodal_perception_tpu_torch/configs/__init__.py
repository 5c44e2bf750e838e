"""Python-module configs: each exposes ``get_config() -> dict``."""

from __future__ import annotations

import copy
import importlib

# name -> (module, function returning the config)
_CONFIGS = {
    "triplane_occ": ("triplane_occ", "get_config"),
    "triplane_range_cam": ("triplane_range_cam", "get_config"),
    "tiny_occ": ("tiny", "get_config"),
    "tiny_range_cam": ("tiny", "get_range_cam_config"),
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

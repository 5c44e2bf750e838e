"""ctypes bindings for the repository's host-side C++ prep functions
(copy of the JAX package's ``data/native.py``).

Loads ``native/libprep_kernels.so`` at the repository's root (built by
``native/Makefile`` when missing and a compiler is there); every entry
point falls back to numpy when the library cannot be loaded, so the
package works without the build step.  These run on the host, not on
the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from ..core.geometry import range_projection_np
from .nuscenes import OCC_REMAP

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib_path() -> str:
    root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(root, "native", "libprep_kernels.so")


def load_library(build_if_missing: bool = True) -> Optional[ctypes.CDLL]:
    """Load (building on first use) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path) and build_if_missing:
        try:
            subprocess.run(
                ["make", "-C", os.path.dirname(path)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    if not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.range_projection.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        f32p, f32p,
    ]
    lib.occ_densify.argtypes = [
        i32p, ctypes.c_int64, i32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, i32p,
    ]
    lib.elevation_raster.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int32, ctypes.c_int32, f32p, f32p,
    ]
    lib.pack_points.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f32p, u8p,
    ]
    lib.pack_points.restype = ctypes.c_int64
    _LIB = lib
    return _LIB


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def range_projection_native(
    points: np.ndarray,
    proj_h: int = 32,
    proj_w: int = 1024,
    fov_up: float = 10.0,
    fov_down: float = -30.0,
    remove_self_radius: float = 2.0,
):
    """Native (or numpy-fallback) spherical range projection."""
    lib = load_library()
    if lib is None:
        return range_projection_np(
            points, proj_h, proj_w, fov_up, fov_down, remove_self_radius
        )
    pts = np.ascontiguousarray(points, np.float32)
    img = np.zeros((proj_h, proj_w), np.float32)
    rpts = np.zeros((proj_h, proj_w, 3), np.float32)
    lib.range_projection(
        _fp(pts), pts.shape[0], pts.shape[1], proj_h, proj_w,
        fov_up, fov_down, remove_self_radius, _fp(img), _fp(rpts),
    )
    return img, rpts


_REMAP_LUT = np.zeros(17, np.int32)
for _new, _olds in OCC_REMAP.items():
    for _o in _olds:
        _REMAP_LUT[_o] = _new


def occ_densify_native(sparse: np.ndarray) -> np.ndarray:
    """Native (or numpy) sparse occ -> dense remapped (200, 200, 16)."""
    lib = load_library()
    sp = np.ascontiguousarray(sparse[:, :4], np.int32)
    if lib is None:
        labels = _REMAP_LUT[np.clip(sp[:, 3], 0, 16)]
        dense = np.zeros((200, 200, 16), np.int32)
        dense[sp[:, 0], sp[:, 1], sp[:, 2]] = labels
        return dense
    out = np.zeros((200, 200, 16), np.int32)
    lut = np.ascontiguousarray(_REMAP_LUT)
    lib.occ_densify(_ip(sp), sp.shape[0], _ip(lut), 200, 200, 16, _ip(out))
    return out


def elevation_raster_native(
    points: np.ndarray,
    voxel: float = 0.4,
    pc_range=(-20, -20, -5, 20, 20, 3),
    remove_self_radius: float = 2.0,
    eps: float = 0.5,
):
    """Native (or numpy) BEV max-height rasterization."""
    lib = load_library()
    if lib is None:
        from .prep import make_elevation

        d = make_elevation(points, voxel, pc_range, remove_self_radius, eps)
        return (
            d["elevation"].astype(np.float32),
            d["mask"].astype(np.float32),
        )
    pts = np.ascontiguousarray(points, np.float32)
    nx = int((pc_range[3] - pc_range[0]) / voxel)
    ny = int((pc_range[4] - pc_range[1]) / voxel)
    elev = np.zeros((nx, ny), np.float32)
    mask = np.zeros((nx, ny), np.float32)
    lib.elevation_raster(
        _fp(pts), pts.shape[0], pts.shape[1],
        pc_range[0], pc_range[1], pc_range[2],
        pc_range[3], pc_range[4], pc_range[5],
        voxel, remove_self_radius, eps, nx, ny, _fp(elev), _fp(mask),
    )
    return elev, mask

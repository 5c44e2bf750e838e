"""Bilinear grid sampling, per-point triplane sampling and the
separable triplane readout over an axis-aligned voxel-center grid.

Counterpart of the JAX package's ``ops/sampling.py``.  Every sample is
``F.grid_sample`` with zero padding and ``align_corners=False``, written
out as a 4-corner gather (the JAX package's ``grid_sample_2d``) or, for
a separable grid, as two small products with fixed 1-D interpolation
matrices per plane.
"""

from __future__ import annotations

import numpy as np
import torch


def grid_sample_2d(image, grid):
    """Bilinear sample of NHWC ``image (B, H, W, C)`` at normalized
    ``grid (B, ..., 2)`` (``grid[..., 0]`` indexes W, ``[..., 1]`` H);
    out-of-range corners contribute zero.  Returns ``(B, ..., C)`` in
    ``image``'s dtype, corners summed in the JAX package's order."""
    B, H, W, C = image.shape
    batch_shape = grid.shape[:-1]
    grid = grid.reshape(B, -1, 2)
    ix = ((grid[..., 0] + 1.0) * W - 1.0) * 0.5
    iy = ((grid[..., 1] + 1.0) * H - 1.0) * 0.5
    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    ix1, iy1 = ix0 + 1.0, iy0 + 1.0
    wx1, wy1 = ix - ix0, iy - iy0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    flat_img = image.reshape(B, H * W, C)

    def corner(iy_c, ix_c, w):
        inb = (ix_c >= 0) & (ix_c <= W - 1) & (iy_c >= 0) & (iy_c <= H - 1)
        xi = ix_c.clamp(0, W - 1).long()
        yi = iy_c.clamp(0, H - 1).long()
        idx = (yi * W + xi)[..., None].expand(-1, -1, C)
        got = torch.gather(flat_img, 1, idx)
        return got * (w * inb.to(w.dtype)).to(image.dtype)[..., None]

    out = (corner(iy0, ix0, wy0 * wx0) + corner(iy0, ix1, wy0 * wx1)
           + corner(iy1, ix0, wy1 * wx0) + corner(iy1, ix1, wy1 * wx1))
    return out.reshape(*batch_shape, C)


def normalize_triplane_coords(points, pc_range, voxel_size, plane_size):
    """World points ``(..., 3)`` -> per-axis normalized triplane coords:
    ``(p - range_min) / voxel_size / (plane_size / 2) - 1``."""
    lo = torch.tensor(pc_range[:3], dtype=points.dtype, device=points.device)
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    return (points - lo) / vs / (plane_size / 2.0) - 1.0


def sample_triplane(triplane, points, pc_range, voxel_size):
    """Sum of the xy, yz and xz planes of ``triplane (B, 3, S, S, C)``
    sampled at world ``points (B, ..., 3)``: ``(B, ..., C)`` in the
    triplane's dtype, math in float32 (the sampler kernel's plain twin)."""
    from .kernels import triplane_sample_plain

    S = triplane.shape[-2]
    coords = normalize_triplane_coords(points, pc_range, voxel_size, S)
    B = points.shape[0]
    out = triplane_sample_plain(triplane, coords.reshape(B, -1, 3))
    return out.reshape(*points.shape[:-1], triplane.shape[-1])


def sample_triplane_auto(triplane, points, pc_range, voxel_size,
                         kernels: bool = True):
    """:func:`sample_triplane` with kernel dispatch, as the JAX package's
    ``sample_triplane_auto``: a bf16 triplane on CUDA (and ``kernels``)
    goes to the B7 sampler kernel and its backward, anything else to the
    plain gather."""
    from .kernels import triplane_sample_op

    if not (kernels and triplane.is_cuda
            and triplane.dtype == torch.bfloat16):
        return sample_triplane(triplane, points, pc_range, voxel_size)
    S = triplane.shape[-2]
    B = points.shape[0]
    coords = normalize_triplane_coords(points.float(), pc_range, voxel_size,
                                       S).reshape(B, -1, 3).contiguous()
    out = triplane_sample_op(triplane.contiguous(), coords)
    return out.reshape(*points.shape[:-1], triplane.shape[-1])


def interp_matrix_1d(coords, size: int) -> np.ndarray:
    """``(n, size)`` float32 matrix W with ``W @ f`` = f bilinearly
    sampled at normalized ``coords`` (built in float64; out-of-range
    corners get weight 0)."""
    c = np.asarray(coords, np.float64)
    ix = ((c + 1.0) * size - 1.0) * 0.5
    i0 = np.floor(ix)
    w1 = ix - i0
    W = np.zeros((len(c), size), np.float32)
    for corner, w in ((i0, 1.0 - w1), (i0 + 1.0, w1)):
        inb = (corner >= 0) & (corner <= size - 1)
        idx = np.clip(corner, 0, size - 1).astype(int)
        np.add.at(W, (np.arange(len(c)), idx), w * inb)
    return W


def grid_interp_matrices(xs, ys, zs, pc_range, voxel_size, S: int):
    """The x, y and z interpolation matrices of a voxel-center grid."""

    def norm(v, axis):
        v = np.asarray(v, np.float64)
        return (v - pc_range[axis]) / voxel_size[axis] / (S / 2.0) - 1.0

    return tuple(
        interp_matrix_1d(norm(v, a), S) for a, v in enumerate((xs, ys, zs))
    )


def sample_triplane_grid_mm(triplane, xs, ys, zs, pc_range, voxel_size):
    """Sum of the three planes sampled at every (x, y, z) grid point.

    Args:
        triplane: ``(B, 3, S, S, C)``; plane 0 is indexed (y, x), plane 1
            (z, y), plane 2 (z, x).
        xs, ys, zs: 1-D numpy world coordinates of the grid axes.

    Returns:
        ``(B, X, Y, Z, C)`` in the triplane's dtype (math in float32).
    """
    S = triplane.shape[-2]
    Wx, Wy, Wz = (
        torch.from_numpy(m).to(triplane.device)
        for m in grid_interp_matrices(xs, ys, zs, pc_range, voxel_size, S)
    )
    p0, p1, p2 = (triplane[:, i].float() for i in range(3))
    xy = torch.einsum("xw,bywc->bxyc", Wx,
                      torch.einsum("yh,bhwc->bywc", Wy, p0))
    yz = torch.einsum("yw,bzwc->byzc", Wy,
                      torch.einsum("zh,bhwc->bzwc", Wz, p1))
    xz = torch.einsum("xw,bzwc->bxzc", Wx,
                      torch.einsum("zh,bhwc->bzwc", Wz, p2))
    out = xy[:, :, :, None, :] + yz[:, None, :, :, :] + xz[:, :, None, :, :]
    return out.to(triplane.dtype)

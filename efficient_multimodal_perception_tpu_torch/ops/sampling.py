"""Bilinear grid sampling, per-point triplane sampling and the
separable triplane readout over an axis-aligned voxel-center grid.

Counterpart of the JAX package's ``ops/sampling.py``.  Every sample is
``F.grid_sample`` with zero padding and ``align_corners=False``, written
out as a 4-corner gather (the JAX package's ``grid_sample_2d``), called
as ``F.grid_sample`` itself where the gather's corner tensors would not
fit (``grid_sample_2d_f32``), or, for a separable grid, as two small
products with fixed 1-D interpolation matrices per plane.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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


def grid_sample_2d_adjoint(grid, g, H: int, W: int):
    """The gradient of :func:`grid_sample_2d` with respect to its image,
    in float32, written out (no autograd, so it also runs inside an
    operator's implementation): each corner's ``g * weight`` added into
    its texel.  ``grid (B, ..., 2)``, ``g (B, ..., C)``; returns
    ``(B, H, W, C)``."""
    B, C = g.shape[0], g.shape[-1]
    grid = grid.reshape(B, -1, 2)
    g = g.reshape(B, -1, C).float()
    ix = ((grid[..., 0] + 1.0) * W - 1.0) * 0.5
    iy = ((grid[..., 1] + 1.0) * H - 1.0) * 0.5
    ix0, iy0 = torch.floor(ix), torch.floor(iy)
    wx1, wy1 = ix - ix0, iy - iy0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1
    out = torch.zeros((B, H * W, C), dtype=torch.float32, device=g.device)
    for iy_c, ix_c, w in ((iy0, ix0, wy0 * wx0), (iy0, ix0 + 1.0, wy0 * wx1),
                          (iy0 + 1.0, ix0, wy1 * wx0),
                          (iy0 + 1.0, ix0 + 1.0, wy1 * wx1)):
        inb = (ix_c >= 0) & (ix_c <= W - 1) & (iy_c >= 0) & (iy_c <= H - 1)
        idx = (iy_c.clamp(0, H - 1).long() * W
               + ix_c.clamp(0, W - 1).long())[..., None].expand(-1, -1, C)
        out.scatter_add_(1, idx, g * (w * inb.float())[..., None])
    return out.reshape(B, H, W, C)


def grid_sample_2d_f32(image, grid):
    """:func:`grid_sample_2d` computed by ``F.grid_sample`` in float32,
    returned in float32: the same function without the four
    ``(B, N, C)`` corner tensors of the gather (at the point family's
    camera sampling, 1.4 GB each in bf16)."""
    B, H, W, C = image.shape
    batch_shape = grid.shape[:-1]
    out = F.grid_sample(image.float().permute(0, 3, 1, 2),
                        grid.reshape(B, 1, -1, 2).float(), mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out[:, :, 0].transpose(1, 2).reshape(*batch_shape, C)


def normalize_triplane_coords(points, pc_range, voxel_size, plane_size):
    """World points ``(..., 3)`` -> per-axis normalized triplane coords:
    ``(p - range_min) / voxel_size / (plane_size / 2) - 1``;
    ``plane_size`` is a scalar or a per-axis 3-tuple."""
    kw = dict(dtype=points.dtype, device=points.device)
    lo = torch.tensor(pc_range[:3], **kw)
    vs = torch.tensor(voxel_size, **kw)
    ps = torch.tensor(plane_size, **kw).expand(3)
    return (points - lo) / vs / (ps / 2.0) - 1.0


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


def sample_triplane_list_grid(planes, xs, ys, zs, pc_range, grid_size,
                              voxel_size):
    """The point family's list-of-planes latent read out at every
    ``(x, y, z)`` of a separable voxel-center grid.

    Counterpart of the JAX package's ``sample_triplane_list_grid_packed``
    (the same math, un-packed): per-axis normalization by
    ``grid_size / 2`` and its plane-axis pairing, x -> W and y -> H on
    xy, y -> W and z -> H on yz, x -> W and z -> H on xz.

    Args:
        planes: xy ``(B, H0, W0, C)``, yz ``(B, H1, W1, C)``,
            xz ``(B, H2, W2, C)``.
        xs, ys, zs: 1-D numpy world coordinates of the grid axes.

    Returns:
        ``(B, X, Y, Z, C)`` in the planes' dtype (math in float32).
    """

    def mat(v, axis, size):
        n = ((np.asarray(v, np.float64) - pc_range[axis])
             / voxel_size[axis] / (grid_size[axis] / 2.0) - 1.0)
        return torch.from_numpy(interp_matrix_1d(n, size)).to(
            planes[0].device)

    p0, p1, p2 = (p.float() for p in planes)
    xy = torch.einsum("xw,bywc->bxyc", mat(xs, 0, p0.shape[2]),
                      torch.einsum("yh,bhwc->bywc", mat(ys, 1, p0.shape[1]),
                                   p0))
    yz = torch.einsum("yw,bzwc->byzc", mat(ys, 1, p1.shape[2]),
                      torch.einsum("zh,bhwc->bzwc", mat(zs, 2, p1.shape[1]),
                                   p1))
    xz = torch.einsum("xw,bzwc->bxzc", mat(xs, 0, p2.shape[2]),
                      torch.einsum("zh,bhwc->bzwc", mat(zs, 2, p2.shape[1]),
                                   p2))
    out = xy[:, :, :, None, :] + yz[:, None, :, :, :] + xz[:, :, None, :, :]
    return out.to(planes[0].dtype)


def sample_triplane_list(planes, points, pc_range, grid_size, voxel_size):
    """The list-of-planes latent sampled at world ``points (B, ..., 3)``
    (the JAX package's ``sample_triplane_list``): per-axis ``grid_size``
    normalization and the same pairing as
    :func:`sample_triplane_list_grid`.  Returns ``(B, ..., C)``."""
    c = normalize_triplane_coords(points, pc_range, voxel_size, grid_size)
    return (grid_sample_2d(planes[0], c[..., [0, 1]])
            + grid_sample_2d(planes[1], c[..., [1, 2]])
            + grid_sample_2d(planes[2], c[..., [0, 2]]))

"""Evaluation-time visualization dumps.

Rebuild of the reference's test artifacts (SURVEY.md §4 "visual
inspection"): MAE reconstruction grids (``triplane.py:616-771``),
PCA-colored triplanes (``triplane_occ.py:418-465``), re-projected point
clouds (``triplane.py:773-807``), and pred/gt occupancy npz volumes
(``triplane_occ.py:199-201``).  All functions take numpy arrays
(channels-last) and write into ``out_dir``.

Copy of the JAX package's ``utils/visualization.py``.  matplotlib (the
grids and PCA figures) and cv2 (the overlays) are imported inside the
writers; without cv2 the overlays draw nearest pixels and dense line
samples and write PNGs through Pillow.  ``save_reprojected_points``,
``save_points_obj``, ``save_boxes_obj`` and ``save_occupancy_npz`` need
numpy only.
"""

from __future__ import annotations

import os

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406])
IMAGENET_STD = np.array([0.229, 0.224, 0.225])


def _ensure(out_dir, sub):
    d = os.path.join(out_dir, sub)
    os.makedirs(d, exist_ok=True)
    return d


def save_image_grid(
    originals: np.ndarray,
    recons: np.ndarray,
    mask: np.ndarray,
    out_dir: str,
    count: int,
):
    """Per-camera original/masked/reconstruction/composite grid.

    Port of ``vis_image`` (``triplane.py:616-674``).

    Args:
        originals/recons: ``(N, H, W, 3)`` normalized images.
        mask: ``(N, H, W, 1)`` 1 = supervised/reconstructed region.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = _ensure(out_dir, "cam")
    raw = _ensure(out_dir, "raw")
    n = originals.shape[0]
    fig, axes = plt.subplots(n, 4, figsize=(24, 3 * n))
    axes = np.atleast_2d(axes)
    inv_mask = 1.0 - mask
    for i in range(n):
        x = originals[i] * IMAGENET_STD + IMAGENET_MEAN
        y = recons[i] * IMAGENET_STD + IMAGENET_MEAN
        m = inv_mask[i]
        panels = [
            ("original", x),
            ("masked", x * (1 - m)),
            ("reconstruction", y),
            ("recon + visible", x * (1 - m) + y * m),
        ]
        for j, (title, img) in enumerate(panels):
            axes[i, j].imshow(np.clip(img, 0, 1))
            axes[i, j].set_title(title)
            axes[i, j].axis("off")
        plt.imsave(
            os.path.join(raw, f"scene{count}_cam{i}_reconstruction.png"),
            np.clip(y, 0, 1),
        )
    fig.savefig(os.path.join(d, f"{count}.png"))
    plt.close(fig)


def save_range_grid(
    original: np.ndarray, recon: np.ndarray, mask: np.ndarray,
    out_dir: str, count: int, vmax: float = 50.0,
):
    """Range-image reconstruction strip (``vis_range_image``,
    ``triplane.py:676-771``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = _ensure(out_dir, "range")
    x, y, m = original[..., 0], recon[..., 0], 1.0 - mask[..., 0]
    fig, axes = plt.subplots(4, 1, figsize=(24, 12))
    for ax, (title, img) in zip(
        axes,
        [
            ("original", x),
            ("masked", x * (1 - m)),
            ("reconstruction", y),
            ("reconstruction + visible", x * (1 - m) + y * m),
        ],
    ):
        ax.imshow(img, vmin=0, vmax=vmax)
        ax.set_title(title)
        ax.axis("off")
    fig.savefig(os.path.join(d, f"{count}.png"))
    plt.close(fig)


def save_reprojected_points(
    range_points: np.ndarray, range_pred: np.ndarray, mask: np.ndarray,
    out_dir: str, count: int,
    fov_up_deg: float = 10.0, fov_down_deg: float = -30.0,
):
    """Back-project predicted ranges to 3-D and dump pred/gt clouds
    (``save_points``, ``triplane.py:773-807``)."""
    d = _ensure(out_dir, "points")
    H, W = range_pred.shape[:2]
    fov_up = np.deg2rad(fov_up_deg)
    fov_down = np.deg2rad(fov_down_deg)
    fov = abs(fov_up) + abs(fov_down)

    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pitch = (1.0 - i / H) * fov - abs(fov_down)
    yaw = (2.0 * j / W - 1.0) * np.pi
    r = range_pred[..., 0] if range_pred.ndim == 3 else range_pred
    x = r * np.sin(yaw) * np.cos(pitch)
    y = r * np.cos(yaw) * np.cos(pitch)
    z = r * np.sin(pitch)
    m = mask[..., 0] if mask.ndim == 3 else mask
    pred = np.stack([x, y, z, 1 - m], -1)[r > 1e-3].reshape(-1, 4)
    gt = np.concatenate(
        [range_points, 1 - m[..., None]], axis=-1
    ).reshape(-1, 4)
    np.save(os.path.join(d, f"pred_points_{count}.npy"), pred)
    np.save(os.path.join(d, f"gt_points_{count}.npy"), gt)


def save_triplane_pca(triplane: np.ndarray, out_dir: str, count: int):
    """PCA-colored triplane figure (``vis_triplane``,
    ``triplane_occ.py:418-465``); dependency-light PCA via SVD.

    Args:
        triplane: ``(3, S, S, C)`` planes.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = _ensure(out_dir, "triplane")
    fig, axes = plt.subplots(3, 1, figsize=(24, 12))
    names = ["xy", "yz", "xz"]
    for i in range(3):
        flat = triplane[i].reshape(-1, triplane.shape[-1]).astype(np.float64)
        flat = flat - flat.mean(0)
        _, _, vt = np.linalg.svd(flat, full_matrices=False)
        pca = (flat @ vt[:3].T).reshape(*triplane.shape[1:3], 3)
        lo, hi = pca.min(), pca.max()
        axes[i].imshow((pca - lo) / max(hi - lo, 1e-9))
        axes[i].set_title(names[i])
        axes[i].axis("off")
    fig.savefig(os.path.join(d, f"{count}.png"))
    plt.close(fig)


def save_points_obj(points: np.ndarray, path: str):
    """Dump a point cloud as a wavefront .obj (vertex cloud).

    Dependency-light stand-in for the reference's trimesh dumps
    (``core/visualizer/show_result.py:74-126``).
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for p in np.asarray(points).reshape(-1, points.shape[-1]):
            f.write(f"v {p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def save_boxes_obj(corners: np.ndarray, path: str):
    """Dump (N, 8, 3) box corners as .obj wireframes."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    edges = [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ]
    with open(path, "w") as f:
        for b in corners:
            for v in b:
                f.write(f"v {v[0]:.4f} {v[1]:.4f} {v[2]:.4f}\n")
        for i in range(len(corners)):
            base = i * 8 + 1
            for a, b_ in edges:
                f.write(f"l {base + a} {base + b_}\n")


def save_occupancy_npz(
    pred_occ: np.ndarray, gt_occ: np.ndarray, points: np.ndarray,
    out_dir: str, count: int,
):
    """pred/gt/points npz dump (``triplane_occ.py:199-201``)."""
    os.makedirs(out_dir, exist_ok=True)
    np.savez(
        os.path.join(out_dir, str(count)),
        pred_occ=pred_occ, gt_occ=gt_occ, points=points.reshape(-1, 3),
    )


# ---------------------------------------------------------------------------
# Camera-image overlays.
#
# Rebuild of ``core/visualizer/image_vis.py``: ``project_pts_on_img``
# (:8-57), ``plot_rect3d_on_img`` (:59-83) and the three
# ``draw_*_bbox3d_on_img`` projectors (:86-197).  Headless by design:
# every function RETURNS the uint8 image (and optionally writes it)
# instead of calling ``cv2.imshow``.  Boxes are plain ``(N, 7)`` arrays
# in this repo (no Instance3DBoxes classes); corner/frame conversions
# reuse the oracle-tested ``core.boxes`` helpers.
# ---------------------------------------------------------------------------

_BOX_EDGES = (
    (0, 1), (1, 2), (2, 3), (3, 0),   # bottom ring
    (4, 5), (5, 6), (6, 7), (7, 4),   # top ring
    (0, 4), (1, 5), (2, 6), (3, 7),   # verticals
)


def _hsv256():
    """256-entry HSV colormap, 0-255 RGB (``image_vis.py:42-43``)."""
    h = np.arange(256, dtype=np.float64) / 256.0  # hue in [0, 1)
    i = np.floor(h * 6).astype(int)
    f = h * 6 - i
    one = np.ones_like(h)
    comps = [  # value=1, saturation=1 wheel
        (one, f, 0 * one), (1 - f, one, 0 * one), (0 * one, one, f),
        (0 * one, 1 - f, one), (f, 0 * one, one), (one, 0 * one, 1 - f),
    ]
    rgb = np.stack(
        [np.choose(i % 6, [c[k] for c in comps]) for k in range(3)], -1
    )
    return (rgb * 255.0).astype(np.float64)


def _maybe_write(img: np.ndarray, out_path):
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        try:
            import cv2

            cv2.imwrite(out_path, img[..., ::-1])  # RGB -> BGR on disk
        except ImportError:
            from PIL import Image

            Image.fromarray(img).save(out_path)
    return img


def project_pts_on_img(
    points: np.ndarray,
    raw_img: np.ndarray,
    lidar2img_rt: np.ndarray,
    max_distance: float = 70.0,
    thickness: int = -1,
    out_path: str | None = None,
) -> np.ndarray:
    """Overlay a depth-colored point cloud on a camera image.

    Same law as ``image_vis.py:8-57``: homogeneous ``pts @ rt.T``,
    z clamped to ``[1e-5, 99999]``, in-image FOV filter, HSV color
    indexed by ``clip(int(max_distance * 10 / depth), 0, 255)``.
    """
    img = np.ascontiguousarray(raw_img, dtype=np.uint8).copy()
    pts = np.asarray(points, np.float64)
    hom = np.concatenate([pts[:, :3], np.ones_like(pts[:, :1])], axis=1)
    uvd = hom @ np.asarray(lidar2img_rt, np.float64).reshape(4, 4).T
    d = np.clip(uvd[:, 2], 1e-5, 99999.0)
    u, v = uvd[:, 0] / d, uvd[:, 1] / d
    fov = (u >= 0) & (u < img.shape[1]) & (v >= 0) & (v < img.shape[0])
    u, v, d = u[fov], v[fov], d[fov]
    cmap = _hsv256()
    idx = np.clip((max_distance * 10.0 / d).astype(int), 0, 255)
    colors = cmap[idx]
    try:
        import cv2

        for ui, vi, ci in zip(u, v, colors):
            cv2.circle(
                img, (int(round(ui)), int(round(vi))), 1,
                tuple(float(c) for c in ci), thickness,
            )
    except ImportError:  # nearest-pixel fallback
        img[np.round(v).astype(int), np.round(u).astype(int)] = colors
    return _maybe_write(img, out_path)


def plot_rect3d_on_img(
    img: np.ndarray,
    rect_corners: np.ndarray,
    color=(0, 255, 0),
    thickness: int = 1,
) -> np.ndarray:
    """Draw ``(N, 8, 2)`` projected cuboid corners as wireframes.

    ``image_vis.py:59-83`` with the edge list permuted for this repo's
    ``core.boxes.corners_3d`` order (bottom ring 0-3 CCW, top 4-7).
    """
    img = np.ascontiguousarray(img, dtype=np.uint8)
    corners = np.asarray(rect_corners)
    try:
        import cv2

        for box in corners:
            c = box.astype(int)
            for a, b in _BOX_EDGES:
                cv2.line(
                    img, (c[a, 0], c[a, 1]), (c[b, 0], c[b, 1]),
                    color, thickness, cv2.LINE_AA,
                )
    except ImportError:  # dense-sample fallback rasterizer
        H, W = img.shape[:2]
        for box in corners:
            for a, b in _BOX_EDGES:
                n = int(max(abs(box[b] - box[a]).max(), 1)) * 2
                t = np.linspace(0.0, 1.0, n)
                xy = np.round(box[a] + t[:, None] * (box[b] - box[a]))
                xy = xy[
                    (xy[:, 0] >= 0) & (xy[:, 0] < W)
                    & (xy[:, 1] >= 0) & (xy[:, 1] < H)
                ].astype(int)
                img[xy[:, 1], xy[:, 0]] = color
    return img


def draw_lidar_bbox3d_on_img(
    bboxes3d: np.ndarray,
    raw_img: np.ndarray,
    lidar2img_rt: np.ndarray,
    color=(0, 255, 0),
    thickness: int = 1,
    out_path: str | None = None,
) -> np.ndarray:
    """Project LiDAR-frame ``(N, 7)`` boxes through a 4x4 lidar2img.

    ``image_vis.py:86-120`` (same 1e-5..1e5 z clamp, no FOV culling —
    the reference draws clipped lines for out-of-view corners too).
    """
    from ..core import boxes as box_ops

    img = np.ascontiguousarray(raw_img, dtype=np.uint8).copy()
    b = np.asarray(bboxes3d, np.float64).reshape(-1, bboxes3d.shape[-1])
    if b.shape[0] == 0:
        return _maybe_write(img, out_path)
    corners = box_ops.corners_3d(b[:, :7]).reshape(-1, 3)
    hom = np.concatenate([corners, np.ones_like(corners[:, :1])], 1)
    uvd = hom @ np.asarray(lidar2img_rt, np.float64).reshape(4, 4).T
    d = np.clip(uvd[:, 2], 1e-5, 1e5)
    uv = (uvd[:, :2] / d[:, None]).reshape(-1, 8, 2)
    return _maybe_write(
        plot_rect3d_on_img(img, uv, color, thickness), out_path
    )


def _cam_frame_corners(bboxes3d: np.ndarray, mode: int) -> np.ndarray:
    """(N, 7) boxes in ``mode`` frame -> (N*8, 3) CAM-frame corners.

    The reference takes ``.corners`` of the frame-specific box class;
    here corners are generated once in the z-up LiDAR parametrization
    and the frame change is the oracle-tested ``point_mode_convert``.
    """
    from ..core import boxes as box_ops

    b = np.asarray(bboxes3d, np.float64).reshape(-1, bboxes3d.shape[-1])
    lidar = box_ops.box_mode_convert(b[:, :7], mode, box_ops.LIDAR)
    corners = box_ops.corners_3d(lidar).reshape(-1, 3)
    return box_ops.point_mode_convert(corners, box_ops.LIDAR, mode)


def draw_camera_bbox3d_on_img(
    bboxes3d: np.ndarray,
    raw_img: np.ndarray,
    cam_intrinsic: np.ndarray,
    color=(0, 255, 0),
    thickness: int = 1,
    out_path: str | None = None,
) -> np.ndarray:
    """CAM-frame boxes through a 3x3 intrinsic (``image_vis.py:163-197``).

    Keeps the reference's ``(uv - 1).round()`` quirk (its
    ``points_cam2img`` is 1-indexed).
    """
    from ..core import boxes as box_ops

    img = np.ascontiguousarray(raw_img, dtype=np.uint8).copy()
    if np.asarray(bboxes3d).size == 0:
        return _maybe_write(img, out_path)
    pts = _cam_frame_corners(bboxes3d, box_ops.CAM)
    K = np.asarray(cam_intrinsic, np.float64).reshape(3, 3)
    uvd = pts @ K.T
    uv = uvd[:, :2] / np.clip(uvd[:, 2:3], 1e-5, None)
    uv = np.round(uv - 1.0).reshape(-1, 8, 2)
    return _maybe_write(
        plot_rect3d_on_img(img, uv, color, thickness), out_path
    )


def draw_depth_bbox3d_on_img(
    bboxes3d: np.ndarray,
    raw_img: np.ndarray,
    depth2img: np.ndarray,
    color=(0, 255, 0),
    thickness: int = 1,
    out_path: str | None = None,
) -> np.ndarray:
    """DEPTH-frame boxes through a 4x4 depth2img (``image_vis.py:124-160``).

    The reference additionally un-applies training-time augmentations
    via ``apply_3d_transformation(img_metas)``; this repo's eval path
    keeps boxes in raw sensor frames, so the input is the un-augmented
    box directly.  Keeps the ``(uv - 1).round()`` quirk.
    """
    from ..core import boxes as box_ops

    img = np.ascontiguousarray(raw_img, dtype=np.uint8).copy()
    if np.asarray(bboxes3d).size == 0:
        return _maybe_write(img, out_path)
    pts = _cam_frame_corners(bboxes3d, box_ops.DEPTH)
    hom = np.concatenate([pts, np.ones_like(pts[:, :1])], 1)
    uvd = hom @ np.asarray(depth2img, np.float64).reshape(4, 4).T
    uv = uvd[:, :2] / np.clip(uvd[:, 2:3], 1e-5, None)
    uv = np.round(uv - 1.0).reshape(-1, 8, 2)
    return _maybe_write(
        plot_rect3d_on_img(img, uv, color, thickness), out_path
    )

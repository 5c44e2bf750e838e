"""The port's visualisations and ``--show-dir`` against the JAX package,
on the CPU.

- every writer of ``utils/visualization.py``, fed the same arrays as
  JAX's, writes the same files (npz / npy / obj equal, PNGs decoding to
  equal pixels), the overlays also with cv2 hidden (Pillow writes them, as
  on the card's machine); ``core/boxes.py`` equal to JAX's;
- ``--show-dir`` on tiny occ (through ``eval_cli``) and tiny MAE
  (through ``eval_cli.dump_visualizations``, the function the flag calls,
  as the JAX side calls ``_dump_visualizations``) writes the file names
  of JAX's ``_dump_visualizations`` (``tools/test.py``) on the same
  weights and samples, the occupancy class maps agreeing on >= 99.9% of
  voxels, and the writers get the same arrays: the triplane and
  ``TriplaneMAE.reconstructions``' images within 1e-4.
"""

import contextlib
import importlib.util
import io
import os
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax import traverse_util
from PIL import Image

from efficient_multimodal_perception_tpu.configs.tiny import tiny_mae, tiny_occ
from efficient_multimodal_perception_tpu.core import boxes as jax_boxes
from efficient_multimodal_perception_tpu.data.synthetic import (
    synthetic_batch as jax_synthetic_batch,
)
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu.utils import (
    visualization as jax_viz,
)
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    synthetic_batch,
)
from efficient_multimodal_perception_tpu_torch.core import boxes
from efficient_multimodal_perception_tpu_torch.models.builder import (
    build_model,
)
from efficient_multimodal_perception_tpu_torch.train import eval_cli
from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
    save_checkpoint,
)
from efficient_multimodal_perception_tpu_torch.utils import visualization
from efficient_multimodal_perception_tpu_torch.weights import load_jax_params
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401
from test_torch_port_point_train import _draw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv):
    """``main(argv)``'s standard output; it must return 0."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_files(a, b):
    names = _files(a)
    assert names and names == _files(b)
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if n.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            assert sorted(za) == sorted(zb)
            for k in za:
                assert np.array_equal(za[k], zb[k]), (n, k)
        elif n.endswith(".npy"):
            assert np.array_equal(np.load(pa), np.load(pb)), n
        elif n.endswith(".png"):
            assert np.array_equal(np.asarray(Image.open(pa)),
                                  np.asarray(Image.open(pb))), n
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), n
    return names


def _writers(rng):
    """``name -> (function name, positional args, keyword args)``; the
    output directory or path is filled in per package."""
    N, H, W = 2, 32, 48
    img = rng.standard_normal((N, H, W, 3)).astype(np.float32)
    mask = (rng.random((N, H, W, 1)) < 0.5).astype(np.float32)
    rimg = rng.uniform(0, 40, (8, 64, 1)).astype(np.float32)
    rmask = (rng.random((8, 64, 1)) < 0.7).astype(np.float32)
    rpts = rng.standard_normal((8, 64, 3)).astype(np.float32) * 10
    raw = (rng.random((H, W, 3)) * 255).astype(np.uint8)
    rt = np.array([[30, 24, 0, 0], [0, 20, 16, 0], [0, 1, 0, 0],
                   [0, 0, 0, 1]], np.float64)
    bx = np.array([[0.5, 6, 0.2, 2, 4, 1.5, 0.3],
                   [-1, 9, -0.5, 1, 2, 1, -0.8]])
    ahead = bx[:, [1, 0, 2, 3, 4, 5, 6]]  # x forward: in front of a camera
    cam_bx = boxes.box_mode_convert(ahead, boxes.LIDAR, boxes.CAM)
    K3 = np.array([[20, 0, 24], [0, 20, 16], [0, 0, 1]], np.float64)
    return {
        "image_grid": ("save_image_grid", (img, img[::-1] * 0.9, mask), {}),
        "range_grid": ("save_range_grid", (rimg, rimg * 1.1, rmask), {}),
        "reprojected_points": ("save_reprojected_points",
                               (rpts, rimg * 0.9, rmask), {}),
        "triplane_pca": ("save_triplane_pca",
                         (rng.standard_normal((3, 16, 16, 8)),), {}),
        "occupancy_npz": ("save_occupancy_npz",
                          (rng.integers(0, 5, (9, 9, 4)),
                           rng.integers(0, 5, (9, 9, 4)), rpts), {}),
        "points_obj": ("save_points_obj", (rpts.reshape(-1, 3),), {}),
        "boxes_obj": ("save_boxes_obj", (boxes.corners_3d(bx),), {}),
        "project_pts": ("project_pts_on_img", (rpts.reshape(-1, 3), raw, rt),
                        {}),
        "lidar_boxes": ("draw_lidar_bbox3d_on_img", (bx, raw, rt), {}),
        "camera_boxes": ("draw_camera_bbox3d_on_img", (cam_bx, raw, K3), {}),
        "depth_boxes": ("draw_depth_bbox3d_on_img",
                        (boxes.box_mode_convert(ahead, boxes.LIDAR,
                                                boxes.DEPTH), raw, rt), {}),
    }


_OUT_DIR = {"save_image_grid", "save_range_grid", "save_reprojected_points",
            "save_triplane_pca", "save_occupancy_npz"}


def _write(module, fn, args, kw, root):
    os.makedirs(root, exist_ok=True)
    f = getattr(module, fn)
    if fn in _OUT_DIR:
        return f(*args, root, 3, **kw)
    if fn in ("save_points_obj", "save_boxes_obj"):
        return f(*args, os.path.join(root, "out.obj"), **kw)
    return f(*args, out_path=os.path.join(root, "out.png"), **kw)


_OVERLAYS = ("project_pts", "lidar_boxes", "camera_boxes", "depth_boxes")


@pytest.mark.parametrize(
    "name,cv2",
    [(n, True) for n in sorted(_writers(np.random.default_rng(0)))]
    + [(n, False) for n in _OVERLAYS])  # cv2 draws the overlays only
def test_writer_matches_jax(name, cv2, tmp_path, monkeypatch):
    overlay = name in _OVERLAYS
    if not cv2:
        monkeypatch.setitem(sys.modules, "cv2", None)  # import raises
    fn, args, kw = _writers(np.random.default_rng(0))[name]
    got = _write(visualization, fn, args, kw, str(tmp_path / "port"))
    want = _write(jax_viz, fn, args, kw, str(tmp_path / "jax"))
    if overlay:
        assert np.array_equal(got, want)
    _same_files(str(tmp_path / "port"), str(tmp_path / "jax"))


def test_boxes_match_jax():
    rng = np.random.default_rng(3)
    b = np.concatenate([rng.uniform(-10, 10, (12, 3)),
                        rng.uniform(0.5, 4, (12, 3)),
                        rng.uniform(-3, 3, (12, 1))], 1)
    pts = rng.uniform(-12, 12, (200, 3))
    scores = rng.random(12)
    for fn, args in (("corners_bev", (b,)), ("corners_3d", (b,)),
                     ("points_in_boxes", (pts, b)),
                     ("rotated_iou_bev", (b[:6], b[6:])),
                     ("nms_bev", (b, scores, 0.1)),
                     ("circle_nms", (np.c_[b[:, :2], scores], 4.0)),
                     ("box_mode_convert", (b, boxes.LIDAR, boxes.CAM)),
                     ("point_mode_convert", (pts, boxes.CAM, boxes.DEPTH))):
        got, want = getattr(boxes, fn)(*args), getattr(jax_boxes, fn)(*args)
        assert np.array_equal(np.asarray(got), np.asarray(want)), fn


# --------------------------------------------------------------------------
# eval_cli --show-dir against tools/test.py's _dump_visualizations
# --------------------------------------------------------------------------

def _jax_test_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_test_tool", os.path.join(ROOT, "tools", "test.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(monkeypatch, module, calls):
    """Wrap ``module``'s figure and array writers to keep the arrays each
    call is given (``calls[name]``), then write as before."""
    for name in ("save_image_grid", "save_range_grid", "save_triplane_pca",
                 "save_reprojected_points", "save_occupancy_npz"):
        def wrap(*args, _f=getattr(module, name), _n=name):
            calls.setdefault(_n, []).append(
                [np.asarray(a) for a in args[:-2]])
            return _f(*args)
        monkeypatch.setattr(module, name, wrap)


@pytest.mark.parametrize("port_cfg,jax_cfg", [
    ("tiny_occ", tiny_occ),
    ("tiny_range_cam", lambda: tiny_mae(contrastive=False, surface=False)),
])
def test_show_dir_matches_jax(port_cfg, jax_cfg, tmp_path, monkeypatch):
    """One sample of each; the arrays handed to the writers agree too:
    the triplane (and for the MAE ``reconstructions``' ``cam_recon`` and
    ``range_recon``) within 1e-4 of JAX's.  The occupancy model goes
    through the CLI (its flags, checkpoint and evaluation pass); the MAE
    goes straight to the dump, which skips the CLI's loss forward."""
    budget = 2048
    model = jax_build_model(jax_cfg())
    is_occ = port_cfg == "tiny_occ"

    def single(i):
        return jax_synthetic_batch(1, point_budget=budget, seed=i,
                                   with_occ=is_occ)

    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0)}, b, deterministic=True), single(0))
    flat = _draw(shapes, 14)
    variables = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    jax_dir, jax_calls = str(tmp_path / "jax"), {}
    _record(monkeypatch, jax_viz, jax_calls)
    with jax.default_matmul_precision("highest"):
        _jax_test_tool()._dump_visualizations(
            types.SimpleNamespace(show_dir=jax_dir), None, model, variables,
            single, 1, jax_cfg()["type"])

    port = build_model(get_config(port_cfg)["model"], device="cpu")
    port.load_state_dict(load_jax_params(flat, port))
    port_dir, port_calls = str(tmp_path / "port"), {}
    _record(monkeypatch, visualization, port_calls)
    if is_occ:
        ckpt = save_checkpoint(str(tmp_path / "ck"), 0,
                               {"step": 0, "params": port.state_dict()})
        out = _run(eval_cli.main, [
            port_cfg, "--checkpoint", ckpt, "--synthetic", "--device", "cpu",
            "--val-batches", "1", "--num-samples", "1", "--show-dir",
            port_dir, "--cfg-options", f"data.point_budget={budget}"])
        assert f"show-dir: 1 samples in {port_dir}" in out
    else:
        assert eval_cli.dump_visualizations(
            port.eval(), lambda i: synthetic_batch(
                1, point_budget=budget, seed=i, device="cpu"), 1,
            "TriplaneMAE", port_dir) == 1
    names = _files(port_dir)
    assert names == _files(jax_dir)
    assert sorted(port_calls) == sorted(jax_calls)
    for name, [got] in port_calls.items():
        [want] = jax_calls[name]
        for i, (a, b) in enumerate(zip(got, want)):
            if name == "save_occupancy_npz" and i == 0:  # class maps
                assert a.dtype == b.dtype
                assert np.mean(a == b) >= 0.999
            else:
                assert a.shape == b.shape and _rel(a, b) <= 1e-4, (name, i)
    if is_occ:
        assert names == ["0.npz", "triplane/0.png"]
    else:
        assert names == sorted(
            ["cam/0.png", "points/gt_points_0.npy", "points/pred_points_0.npy",
             "range/0.png", "triplane/0.png"]
            + [f"raw/scene0_cam{c}_reconstruction.png" for c in range(6)])

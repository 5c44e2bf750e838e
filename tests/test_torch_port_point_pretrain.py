"""The port's point-family pretraining (``PointTriplane``), its configs
and the pretraining CLI runs, on the CPU.

- ``point_family.cam_rec_feat`` against JAX's: the same canvases and
  gradient with many points colliding on each pixel;
- tiny ``PointTriplane`` (camera, contrastive and surface losses;
  BatchNorm on batch statistics) against JAX, whose losses are assembled
  from its own parts with explicit ``sample`` keys as
  ``PointTriplane.__call__`` derives them, and whose draws the port's
  ``draw`` returns: losses within 1e-4 relative, every gradient within
  1e-3 relative Frobenius error (a gradient JAX gives as 0 up to
  rounding, the port must too), the running statistics after the step
  within 1e-6;
- ``PointTriplaneOcc``'s logits (and, training, its running statistics)
  bit for bit those of its path before ``encode_planes`` was shared;
- the port's ``triplane_surf_sam``, ``point_triplane``,
  ``nuscenes_range``, ``tiny_surf_sam`` and ``tiny_point`` configs equal
  to the JAX package's (tuples and lists normalised; the port keeps a
  subset of the data and runtime keys);
- ``train/cli.py`` trains ``tiny_surf_sam`` and ``tiny_point`` two
  steps on ``--device cpu`` and writes a checkpoint that loads whole.

The weights and BatchNorm statistics are drawn with numpy for the
shapes ``jax.eval_shape`` gives; JAX runs jitted under full matmul
precision.
"""

import contextlib
import io
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from efficient_multimodal_perception_tpu.configs import (
    get_config as jax_get_config,
)
from efficient_multimodal_perception_tpu.configs.tiny import (
    tiny_mae as jax_tiny_mae,
    tiny_point as jax_tiny_point,
)
from efficient_multimodal_perception_tpu.core.geometry import CameraAug as JAug
from efficient_multimodal_perception_tpu.data.batch import Batch as JBatch
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu.models.point_family import (
    cam_rec_feat as j_cam_rec_feat,
)
from efficient_multimodal_perception_tpu.ops.sampling import (
    sample_triplane_list as j_sample_list,
)
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.core.geometry import (
    CameraAug,
    project_points_to_cameras,
)
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.models.point_family import (
    cam_rec_feat,
    point_to_cam,
    voxelize_points,
)
from efficient_multimodal_perception_tpu_torch.ops.sampling import (
    sample_triplane_list_grid,
)
from efficient_multimodal_perception_tpu_torch.train import cli
from efficient_multimodal_perception_tpu_torch.train.checkpoint import (
    restore_params_only,
)
from efficient_multimodal_perception_tpu_torch.train.trainer import (
    freeze,
    loss_and_grads,
)
from efficient_multimodal_perception_tpu_torch.weights import (
    load_jax_params,
    port_key,
)
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401
from test_torch_port_point_train import _draw
from test_torch_port_surface import (
    interpnet_draws,
    jax_contrastive,
    quick_compile,
)

LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3
STATS_TOL = 1e-6
# a gradient whose every path meets a training BatchNorm is exactly 0;
# both packages give rounding noise below this share of the largest norm
ZERO_GRAD = 1e-6
IMAGE_HW = (64, 128)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jax_batch(a):
    return JBatch(
        img=jnp.asarray(a["img"]), range_image=jnp.asarray(a["range_image"]),
        range_points=jnp.asarray(a["range_points"]),
        lidar2img=jnp.asarray(a["lidar2img"]),
        cam_aug=JAug(jnp.asarray(a["cam_resize"]), jnp.asarray(a["cam_crop"]),
                     jnp.asarray(a["cam_flip"])),
        points=jnp.asarray(a["points"]),
        points_valid=jnp.asarray(a["points_valid"]))


def test_cam_rec_feat_matches_jax_with_collisions():
    """The 256 x 512 rig's projections resized to 8 x 16 canvases under
    8000 points a sample (one camera flipped): the written pixels take
    several writes on average, the last one wins in both packages; the
    gradient goes to the winners only."""
    P = 8000
    a = synthetic_arrays(2, point_budget=P, seed=8)
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((2, P, 5)).astype(np.float32)
    valid = a["points_valid"] & (rng.random((2, P)) < 0.9)
    a["cam_resize"][:] = 1 / 32
    a["cam_flip"][0, 1] = True
    aug = JAug(jnp.asarray(a["cam_resize"]), jnp.asarray(a["cam_crop"]),
               jnp.asarray(a["cam_flip"]))
    cot = rng.standard_normal((2, 6, 8, 16, 5)).astype(np.float32)

    def f(x):
        return j_cam_rec_feat(x, jnp.asarray(a["points"]), jnp.asarray(valid),
                              jnp.asarray(a["lidar2img"]), aug, (8, 16))

    want, wgrad = jax.device_get(jax.jit(lambda x: (
        f(x), jax.vjp(f, x)[1](jnp.asarray(cot))[0]))(jnp.asarray(feats)))
    ft = _t(feats).requires_grad_(True)
    got = cam_rec_feat(ft, _t(a["points"]), _t(valid), _t(a["lidar2img"]),
                       CameraAug(_t(a["cam_resize"]), _t(a["cam_crop"]),
                                 _t(a["cam_flip"])), (8, 16))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.backward(_t(cot))
    np.testing.assert_allclose(ft.grad.numpy(), wgrad, rtol=1e-6, atol=1e-6)
    # collisions: many more valid writes than pixels written
    _, in_img = project_points_to_cameras(
        _t(a["points"][..., :3]), _t(a["lidar2img"]),
        CameraAug(_t(a["cam_resize"]), _t(a["cam_crop"]),
                  _t(a["cam_flip"])), (8, 16))
    writes = int((in_img.numpy() & valid[:, None]).sum())
    written = int(want.any(-1).sum())
    assert written > 500 and writes > 2 * written
    assert int((wgrad != 0).any(-1).sum()) <= written


def jax_point_losses(m, batch, rng_c, rng_s):
    """``PointTriplane.__call__`` (training BatchNorm), its
    ``make_rng("sample")`` keys given: ``rng_c`` for the contrastive loss
    (``fold_in(rng_c, cam)`` split over the batch), ``rng_s`` for the
    surface loss."""
    planes, valid = m.encode_planes(batch, deterministic=False)
    grid_size = tuple(m.point_triplane_projector["grid_size"])
    B, N, H, W, _ = batch.img.shape
    pts = batch.points[..., :3]
    feats = j_sample_list(planes, pts, m.pc_range, grid_size, m.voxel_size)
    canvases = j_cam_rec_feat(feats * valid[..., None].astype(feats.dtype),
                              batch.points, valid, batch.lidar2img,
                              batch.cam_aug, (H, W))
    pred = m.camera_dec(canvases.reshape(B * N, H, W, -1))
    img = batch.img.reshape(B * N, H, W, 3)
    losses = {"camera_loss": m.camera_dec.forward_loss(img, pred,
                                                       jnp.ones_like(img))}
    losses["contrastive_loss"] = jax_contrastive(
        feats, batch.points, valid, rng_c, m.max_sam_clusters)
    losses["surface_loss"] = m.surface_dec(pts, feats, valid, rng_s)
    return losses


@pytest.fixture(scope="module")
def point_case():
    arrs = synthetic_arrays(2, image_hw=IMAGE_HW, point_budget=1024, seed=6)
    jb = _jax_batch(arrs)
    model = jax_build_model(jax_tiny_point())
    rng_c, rng_s = jax.random.key(41), jax.random.key(42)
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, b,
        deterministic=True), jb)
    flat = _draw(shapes, 19)
    variables = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")

    def loss_fn(params):
        losses, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jb,
            rng_c, rng_s, method=jax_point_losses, mutable=["batch_stats"],
            rngs={"droppath": jax.random.key(2)})  # rate 0: never drawn
        return sum(v for k, v in losses.items() if "loss" in k), (
            losses, upd["batch_stats"])

    with jax.default_matmul_precision("highest"):
        (_, (losses, stats)), grads = jax.device_get(quick_compile(
            jax.value_and_grad(loss_fn, has_aux=True), variables["params"])(
            variables["params"]))
    P = arrs["points"].shape[1]
    scores = np.stack([np.stack([
        np.asarray(jax.random.uniform(k, (P,))) for k in jax.random.split(
            jax.random.fold_in(rng_c, cam), 2)]) for cam in range(6)], 1)
    stats = {f"batch_stats/{k}": np.asarray(v) for k, v in
             traverse_util.flatten_dict(stats, sep="/").items()}
    return dict(arrs=arrs, flat=flat, stats=stats,
                draws=dict(contrastive=_t(scores),
                           surface=interpnet_draws(rng_s, 2, P, 256)),
                losses={k: float(v) for k, v in losses.items()},
                grads={k: np.asarray(v) for k, v in traverse_util.flatten_dict(
                    grads, sep="/").items()})


def test_tiny_point_triplane_matches_jax(point_case):
    model = build_model(get_config("tiny_point")["model"], device="cpu")
    model.load_state_dict(load_jax_params(point_case["flat"], model))
    model.draw = lambda batch, generator: point_case["draws"]
    named = freeze(model, ())
    losses, _, grads = loss_and_grads(
        model, [p for _, p in named], arrays_to_batch(point_case["arrs"]),
        None, deterministic=False)
    want = point_case["losses"]
    assert set(losses) == set(want) == {"camera_loss", "contrastive_loss",
                                        "surface_loss"}
    for k, v in want.items():
        assert abs(float(losses[k].detach()) - v) <= LOSS_RTOL * abs(v), (
            k, float(losses[k]), v)
    want_g = {}
    for k, g in point_case["grads"].items():
        name, g = port_key(f"params/{k}", g)
        want_g[name.replace("/", ".")] = g
    assert set(want_g) == {n for n, _ in named}
    floor = ZERO_GRAD * max(np.linalg.norm(g) for g in want_g.values())
    zero = 0
    for (n, _), g in zip(named, grads):
        if np.linalg.norm(want_g[n]) <= floor:
            zero += 1
            assert np.linalg.norm(g.numpy()) <= floor, n
        else:
            assert _rel(g, want_g[n]) <= GRAD_RTOL, (n, _rel(g, want_g[n]))
    assert zero <= 8
    want_sd = load_jax_params({**point_case["flat"], **point_case["stats"]},
                              model)
    moved = 0
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       rtol=STATS_TOL, atol=STATS_TOL)
            moved += 1
    assert moved == 20


def _occ_path_before_sharing(m, batch, deterministic, generator):
    """``PointTriplaneOcc.forward``'s logits as its body computed them
    before ``point_family.encode_planes`` was factored out of it."""
    B, N, H, W, _ = batch.img.shape
    train = not deterministic
    grid_idx, valid = voxelize_points(batch.points, batch.points_valid,
                                      m.triplane_range,
                                      m.triplane_voxel_size)
    feats = m.camera_encoder(batch.img.reshape(B * N, H, W, 3),
                             deterministic, generator)
    feats = feats.reshape(B, N, *feats.shape[1:])
    cam_pt = point_to_cam(batch.points, valid, feats, batch.lidar2img,
                          batch.cam_aug, (H, W))
    tpv = m.point_triplane_projector(batch.points, grid_idx, valid, cam_pt,
                                     train=train)
    planes = [m.fpn(m.triplane_encoder(tp, deterministic, generator),
                    train=train) for tp in tpv]
    ref = m.ref_3d
    feats = sample_triplane_list_grid(
        planes, ref[:, 0, 0, 0], ref[0, :, 0, 1], ref[0, 0, :, 2],
        m.triplane_range, m.point_triplane_projector.grid_size,
        m.triplane_voxel_size)
    return m.decoder(feats)


@pytest.mark.parametrize("deterministic", [True, False])
def test_point_occ_unchanged_by_shared_encode_planes(deterministic):
    """Bit for bit, in eval and in a training forward (drop-path drawn
    from the same generator seed, BatchNorm statistics updated alike)."""
    cfg = get_config("tiny_point_occ")["model"]
    for k in ("camera_encoder", "triplane_encoder"):
        cfg[k]["drop_path_rate"] = 0.3
    model = build_model(cfg, device="cpu", seed=3)
    batch = arrays_to_batch(synthetic_arrays(2, image_hw=IMAGE_HW,
                                             point_budget=1024, seed=2))
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    with torch.no_grad():
        got = model(batch, deterministic, torch.Generator().manual_seed(5))[0]
        stats = {k: v.clone() for k, v in model.state_dict().items()
                 if "running" in k}
        model.load_state_dict(stats0, strict=False)
        want = _occ_path_before_sharing(model, batch, deterministic,
                                        torch.Generator().manual_seed(5))
    assert torch.equal(got, want)
    for k, v in model.state_dict().items():
        if "running" in k:
            assert torch.equal(v, stats[k]), k
            assert deterministic == torch.equal(v, stats0[k]), k


def _norm(x):
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


RUNTIME_KEYS = ("checkpoint", "log_interval", "compute_dtype", "seed")
SCHEDULE_KEYS = ("optimizer", "grad_clip", "lr_config", "epochs")


@pytest.mark.parametrize("name", ["triplane_surf_sam", "point_triplane",
                                  "nuscenes_range"])
def test_pretraining_configs_match_jax(name):
    """The model, its init and the schedule whole; the data and runtime
    keys the port keeps, each equal to JAX's."""
    port, want = _norm(get_config(name)), _norm(jax_get_config(name))
    for k in ("name", "model", "model_init") + SCHEDULE_KEYS:
        assert port[k] == want[k], k
    for k, v in port["data"].items():
        assert v == want["data"][k], k
    for k in RUNTIME_KEYS:
        assert port[k] == want[k], k


@pytest.mark.parametrize("name,want", [
    ("tiny_surf_sam", lambda: jax_tiny_mae(recon=False)),
    ("tiny_point", jax_tiny_point),
])
def test_tiny_pretraining_configs_match_jax(name, want):
    assert _norm(get_config(name)["model"]) == _norm(want())


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("name,keys", [
    ("tiny_surf_sam", {"contrastive_loss", "surface_loss"}),
    ("tiny_point", {"camera_loss", "contrastive_loss", "surface_loss"}),
])
def test_pretraining_cli_trains_and_saves(tmp_path, name, keys):
    out = _run(cli.main, [name, "--work-dir", str(tmp_path), "--synthetic",
                          "--max-steps", "2", "--device", "cpu"])
    steps = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    assert [s["step"] for s in steps] == [1, 2]
    for s in steps:
        assert keys <= set(s) and all(math.isfinite(s[k]) for k in keys)
    ckpt = tmp_path / "checkpoints" / "step_2.pt"
    state = torch.load(ckpt, weights_only=True)
    assert state["step"] == 2 and state["opt"]["count"] == 2
    model = build_model(get_config(name)["model"], device="cpu")
    model.load_state_dict(restore_params_only(ckpt))  # strict: whole

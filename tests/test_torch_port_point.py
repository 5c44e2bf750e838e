"""The port's ``point_triplane_occ`` path against the JAX package, on the
CPU.

Inputs, weights and BatchNorm statistics are made with numpy seeds and
handed to both packages; JAX runs under full matmul precision.  The
BatchNorm running statistics are drawn away from their (0, 1) init, so
the ``batch_stats`` bridge of ``weights.load_jax_params`` carries
weight.  The B9 kernel's twin is held to the Pallas kernel in interpret
mode; the CUDA kernel itself runs only on the card
(``tests/test_torch_port_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from efficient_multimodal_perception_tpu.configs.tiny import tiny_point
from efficient_multimodal_perception_tpu.core.geometry import CameraAug as JAug
from efficient_multimodal_perception_tpu.data.batch import Batch as JBatch
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu.models.fpn import (
    GeneralizedLSSFPN as JFPN,
)
from efficient_multimodal_perception_tpu.models.fpn import _resize_bilinear
from efficient_multimodal_perception_tpu.models.point_family import (
    voxelize_points as j_voxelize_points,
)
from efficient_multimodal_perception_tpu.models.point_projector import (
    PointTriplaneProjector as JProjector,
)
from efficient_multimodal_perception_tpu.ops.pallas_kernels import (
    _finite_mlp_impl,
    _xla_finite_mlp,
)
from efficient_multimodal_perception_tpu.ops.sampling import (
    grid_sample_2d as j_grid_sample_2d,
)
from efficient_multimodal_perception_tpu.ops.sampling import (
    sample_triplane_list as j_sample_triplane_list,
)
from efficient_multimodal_perception_tpu.ops.sampling import (
    sample_triplane_list_grid_packed,
)
from efficient_multimodal_perception_tpu.ops.scatter import (
    point_plane_pools_batch as j_pools,
)
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.models.fpn import (
    GeneralizedLSSFPN,
    resize_bilinear,
)
from efficient_multimodal_perception_tpu_torch.models.point_family import (
    voxelize_points,
)
from efficient_multimodal_perception_tpu_torch.models.point_projector import (
    PointTriplaneProjector,
)
from efficient_multimodal_perception_tpu_torch.ops import kernels as K
from efficient_multimodal_perception_tpu_torch.ops.sampling import (
    grid_sample_2d,
    grid_sample_2d_f32,
    sample_triplane_list,
    sample_triplane_list_grid,
)
from efficient_multimodal_perception_tpu_torch.ops.scatter import (
    point_plane_pools_batch,
)
from efficient_multimodal_perception_tpu_torch.serve import (
    InferenceWorker,
    batch_keys,
    build_infer_fn,
)
from efficient_multimodal_perception_tpu_torch.weights import load_jax_params
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

TOL = 1e-5          # modules and kernel twins
ATOL = RTOL = 1e-4  # whole-model logits (tests/test_full_parity.py's)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def randomized(variables, seed):
    """Flat ``{collection/path: array}`` of a flax variable tree: params
    perturbed from ``seed`` (so layer-scale gamma is far from its 1e-6
    init), BatchNorm means from N(0, 0.5) and variances from U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.device_get(variables), sep="/")
    out = {}
    for k, v in flat.items():
        v = np.asarray(v, np.float32)
        if k.startswith("batch_stats/") and k.endswith("/mean"):
            v = rng.normal(0.0, 0.5, v.shape)
        elif k.startswith("batch_stats/"):
            v = rng.uniform(0.5, 2.0, v.shape)
        else:
            v = (v * (1 + 0.1 * rng.standard_normal(v.shape))
                 + 0.1 * rng.standard_normal(v.shape))
        out[k] = v.astype(np.float32)
    return out


def unflatten(flat):
    return traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def load_as(module, name, flat):
    """Load the flat variables of a JAX module into ``module`` placed as
    the model's sub-module ``name`` (the bridge's rules are anchored at
    the model's module names)."""
    holder = torch.nn.Module()
    holder.add_module(name, module)
    nested = {}
    for k, v in flat.items():
        collection, rest = k.split("/", 1)
        nested[f"{collection}/{name}/{rest}"] = v
    holder.load_state_dict(load_jax_params(nested, holder))


def _cloud(rng, B, P, grid, C):
    """Features and voxel indices with many points per cell (duplicate
    cells), invalid rows, and most cells empty."""
    cells = rng.integers(0, 12, (B, P, 3)) * (np.asarray(grid) // 12)
    idx = np.minimum(cells + rng.integers(0, 2, (B, P, 3)),
                     np.asarray(grid) - 1).astype(np.int32)
    feats = rng.standard_normal((B, P, C)).astype(np.float32)
    valid = rng.random((B, P)) < 0.8
    return feats, idx, valid


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("grid,split", [((32, 32, 16), (8, 8, 4)),
                                        ((26, 24, 20), (5, 6, 4))])
def test_pools_bit_identical_to_jax(grid, split, raw):
    """The three plane pools, cleaned and raw, in float32.  The second
    grid has ``X // sx * sx < X``, so the last voxels' ``gx // kx``
    reaches ``sx`` and spills into the next cell, as in the JAX ids."""
    feats, idx, valid = _cloud(np.random.default_rng(0), 2, 600, grid, 8)
    want = j_pools(jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(valid),
                   grid, split, raw=raw)
    got = point_plane_pools_batch(_t(feats), _t(idx), _t(valid), grid, split,
                                  raw=raw)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    assert np.isinf(got[0].numpy()).any() == raw  # empty cells exist


def test_voxelize_points_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-27, 27, (2, 500, 5)).astype(np.float32)
    pts[..., 2] = rng.uniform(-6, 4, (2, 500))
    pts[0, :8, :3] = [[-25, 0, 0], [25, 0, 0], [0, 24.999998, 2.9999998],
                      [-24.999998, -24.999998, -4.9999995], [0.4, 0.8, 0.1],
                      [1.2, -0.4, -0.3], [0, 0, 3], [12.4, 3.6, 0.7]]
    pv = rng.random((2, 500)) < 0.9
    pc_range, vs = (-25, -25, -5, 25, 25, 3), (0.4, 0.4, 0.1)
    ji, jv = j_voxelize_points(jnp.asarray(pts), jnp.asarray(pv), pc_range, vs)
    gi, gv = voxelize_points(_t(pts), _t(pv), pc_range, vs)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ji))


def test_finite_mlp_twin_matches_pallas():
    """The B9 twin against the XLA replay and the Pallas kernel
    (interpret mode), with whole -inf rows and scattered -inf values."""
    rng = np.random.default_rng(2)
    M, Kd, N = 96, 64, 32
    x = rng.standard_normal((M, Kd)).astype(np.float32)
    x[rng.random(M) < 0.3] = -np.inf
    x[rng.random((M, Kd)) < 0.1] = -np.inf
    w1 = (rng.standard_normal((Kd, N)) / 8).astype(np.float32)
    w2 = (rng.standard_normal((N, N)) / 6).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(N)).astype(np.float32)
    b2 = (0.1 * rng.standard_normal(N)).astype(np.float32)
    args = tuple(jnp.asarray(a) for a in (x, w1, b1, w2, b2))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(_xla_finite_mlp(*args))
        pallas = np.asarray(_finite_mlp_impl(*args, interpret=True))
    got = K.finite_mlp_plain(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2))
    assert np.isfinite(got.numpy()).all()
    _close(got.numpy(), ref)
    _close(got.numpy(), pallas)
    # the wrapper takes the twin for CPU tensors
    np.testing.assert_array_equal(
        K.finite_mlp_fused(_t(x), _t(w1.T), _t(b1), _t(w2.T), _t(b2)).numpy(),
        got.numpy())


def test_grid_sample_f32_matches_gather():
    """``F.grid_sample`` (the point-to-camera sampler) against the
    4-corner gather, with coordinates beyond the edges."""
    rng = np.random.default_rng(3)
    img = rng.standard_normal((3, 5, 9, 7)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (3, 40, 2)).astype(np.float32)
    want = grid_sample_2d(_t(img), _t(grid))
    _close(grid_sample_2d_f32(_t(img), _t(grid)), want)
    _close(want, j_grid_sample_2d(jnp.asarray(img), jnp.asarray(grid)))


def test_triplane_list_readouts_match_jax():
    rng = np.random.default_rng(4)
    planes = [rng.standard_normal((2, h, w, 6)).astype(np.float32)
              for h, w in ((16, 16), (16, 8), (16, 8))]
    pc, gs, vs = (-25, -25, -5, 25, 25, 3), (16, 16, 8), (50 / 16, 50 / 16, 1.0)
    xs, ys, zs = (np.linspace(-26, 26, n).astype(np.float32)
                  for n in (7, 5, 4))
    with jax.default_matmul_precision("highest"):
        packed = np.asarray(sample_triplane_list_grid_packed(
            [jnp.asarray(p) for p in planes], xs, ys, zs, pc, gs, vs))
    got = sample_triplane_list_grid([_t(p) for p in planes], xs, ys, zs, pc,
                                    gs, vs)
    assert got.shape == (2, 7, 5, 4, 6)
    _close(got.numpy(), packed.reshape(2, 7, 5, 4, 6))
    pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1)[None]
    pts = np.repeat(pts, 2, 0).astype(np.float32)
    want = j_sample_triplane_list([jnp.asarray(p) for p in planes],
                                  jnp.asarray(pts), pc, gs, vs)
    per_point = sample_triplane_list([_t(p) for p in planes], _t(pts), pc, gs,
                                     vs)
    _close(per_point.numpy(), np.asarray(want))
    _close(per_point.numpy(), got.numpy())


def test_resize_bilinear_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 5, 10, 3)).astype(
        np.float32)
    for hw in ((10, 20), (13, 7), (5, 10)):
        _close(resize_bilinear(_t(x), hw).numpy(),
               np.asarray(_resize_bilinear(jnp.asarray(x), hw, False)))


def test_projector_eval_matches_jax():
    """MaskedBatchNorm, the point MLP, the camera reduction, the pools
    and the plane MLPs in eval, BatchNorm statistics randomized."""
    rng = np.random.default_rng(6)
    B, P, grid, split, Cc = 2, 300, (16, 16, 8), (4, 4, 2), 12
    pts = rng.standard_normal((B, P, 11)).astype(np.float32) * 3
    _, idx, valid = _cloud(rng, B, P, grid, 1)
    cam = rng.standard_normal((B, P, Cc)).astype(np.float32)
    jm = JProjector(grid_size=grid, split=split, out_channels=16,
                    base_channels=16)
    jargs = (jnp.asarray(pts), jnp.asarray(idx), jnp.asarray(valid),
             jnp.asarray(cam))
    flat = randomized(jax.jit(lambda *a: jm.init(jax.random.key(0), *a))(
        *jargs), 7)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, *a: jm.apply(v, *a))(unflatten(flat), *jargs)
    pm = PointTriplaneProjector(grid_size=grid, split=split, out_channels=16,
                                base_channels=16, cam_channels=Cc)
    load_as(pm, "point_triplane_projector", flat)
    with torch.no_grad():
        got = pm(_t(pts), _t(idx), _t(valid), _t(cam))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), np.asarray(w))


def test_fpn_eval_matches_jax():
    rng = np.random.default_rng(8)
    chans = (8, 16, 32, 64)
    xs = [rng.standard_normal((2, 16 >> i, 10 >> i, c)).astype(np.float32)
          for i, c in enumerate(chans)]
    jm = JFPN(in_channels=chans, out_channels=24)
    jx = [jnp.asarray(x) for x in xs]
    flat = randomized(jax.jit(lambda a: jm.init(jax.random.key(0), a))(jx), 9)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, a: jm.apply(v, a))(unflatten(flat), jx)
    pm = GeneralizedLSSFPN(in_channels=chans, out_channels=24)
    load_as(pm, "fpn", flat)
    with torch.no_grad():
        got = pm([_t(x) for x in xs])
    assert got.shape == (2, 16, 10, 24)
    _close(got.numpy(), np.asarray(want))


def jax_batch(arrs):
    return JBatch(
        img=jnp.asarray(arrs["img"]),
        range_image=jnp.asarray(arrs["range_image"]),
        range_points=jnp.asarray(arrs["range_points"]),
        lidar2img=jnp.asarray(arrs["lidar2img"]),
        cam_aug=JAug(jnp.asarray(arrs["cam_resize"]),
                     jnp.asarray(arrs["cam_crop"]),
                     jnp.asarray(arrs["cam_flip"])),
        points=jnp.asarray(arrs["points"]),
        points_valid=jnp.asarray(arrs["points_valid"]),
        occupancy=jnp.asarray(arrs["occupancy"]),
    )


@pytest.fixture(scope="module")
def point_case():
    """tiny point_triplane_occ at B=1, f32: the JAX logits and the
    randomized variables."""
    arrs = synthetic_arrays(1, point_budget=2048, with_occ=True, seed=3)
    jb = jax_batch(arrs)
    model = jax_build_model(tiny_point(occ=True))
    variables = jax.jit(lambda b: model.init(
        {"params": jax.random.key(0)}, b, deterministic=True))(jb)
    flat = randomized(variables, seed=0)
    with jax.default_matmul_precision("highest"):
        logits, _, losses = jax.jit(lambda v, b: model.apply(
            v, b, deterministic=True))(unflatten(flat), jb)
    return dict(arrs=arrs, flat=flat, logits=np.asarray(logits),
                loss=float(losses["loss"]))


@pytest.fixture(scope="module")
def port_point(point_case):
    model = build_model(get_config("tiny_point_occ")["model"], device="cpu")
    model.load_state_dict(load_jax_params(point_case["flat"], model))
    return model


def test_tiny_point_occ_logits_match_jax(point_case, port_point):
    with torch.no_grad():
        logits, occ, losses = port_point(arrays_to_batch(point_case["arrs"]))
    assert logits.shape == (1, 99, 99, 16, 5)
    assert occ.shape == (1, 99, 99, 16)
    np.testing.assert_allclose(logits.numpy(), point_case["logits"],
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(losses["loss"]), point_case["loss"],
                               rtol=1e-5)


def test_batch_stats_bridge_carries_weight(point_case, port_point):
    """The randomized running statistics reach the logits (set back to
    their init they move the logits past the tolerance), and a missing
    ``batch_stats`` leaf fails the load."""
    saved = {k: v.clone() for k, v in port_point.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    try:
        with torch.no_grad():
            for m in port_point.modules():
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.reset_running_stats()
            logits, _, _ = port_point(arrays_to_batch(point_case["arrs"]))
    finally:
        port_point.load_state_dict(saved, strict=False)
    assert not np.allclose(logits.numpy(), point_case["logits"],
                           atol=ATOL, rtol=RTOL)
    flat = dict(point_case["flat"])
    flat.pop("batch_stats/fpn/lateral1/bn/var")
    with pytest.raises(KeyError, match="fpn.lateral_convs.1.bn.running_var"):
        load_jax_params(flat, port_point)


def test_worker_coalesces_two_point_requests(port_point):
    keys = batch_keys(port_point)
    assert keys[-2:] == ("points", "points_valid")
    infer = build_infer_fn(port_point)
    template = synthetic_arrays(2, point_budget=2048, seed=0)
    worker = InferenceWorker(infer, template, batch_size=2, coalesce_s=30.0,
                             device="cpu", keys=keys)
    reqs = [{k: a[k] for k in keys} for a in (
        synthetic_arrays(1, point_budget=2048, seed=s) for s in (1, 2))]
    slots = [worker.submit(r) for r in reqs]  # queued before the worker runs
    worker.start()
    try:
        for s in slots:
            assert s["done"].wait(120)
    finally:
        worker.stop()
    assert worker.n_batches == 1 and worker.n_requests == 2
    assert all("error" not in s for s in slots)
    packed = {k: np.concatenate([r[k] for r in reqs]) for k in keys}
    with torch.no_grad():
        logits, _, _ = port_point(arrays_to_batch(packed))
    want = torch.argmax(logits, -1).to(torch.int8).numpy()
    for i, s in enumerate(slots):
        assert s["pred"].shape == (1, 99, 99, 16) and s["pred"].dtype == np.int8
        np.testing.assert_array_equal(s["pred"], want[i:i + 1])

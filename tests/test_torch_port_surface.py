"""The port's surface and contrastive pretraining pieces against the JAX
package, on the CPU, in float32.

- ``ops.radius.radius_neighbors``: ``idx`` and ``mask`` identical to
  JAX's (first ``k`` supports within the radius, in index order) on
  clouds with invalid supports, queries with more than ``k`` neighbours
  and queries with none;
- ``losses.sup_con.sup_con_loss`` with the scores JAX drew
  (``jax.random.uniform(key, (P,))``): loss within 1e-5 relative, also
  batched over samples and label channels; a channel with no valid point
  and one with no cluster of ``MIN_CLUSTER_SIZE`` give loss 0, no anchor
  and a finite zero gradient;
- ``models.interpnet.InterpNet`` with the queries JAX drew (its pick
  scores and radii recomputed from the key): loss within 1e-5 relative;
  its own ``create_targets`` geometry from torch draws;
- tiny ``TriplaneMAE`` with the surface decoder and SupCon
  (``tiny_surf_sam``) through ``weights.load_jax_params``: losses within
  1e-4 relative and every trainable gradient within 1e-3 relative
  Frobenius error of JAX's, whose losses are assembled from its own parts
  with explicit keys (``encode_triplane``, ``sup_con_loss`` with
  ``fold_in(key, cam)`` split over the batch, ``InterpNet`` with the key
  split over the batch, as ``TriplaneMAE.__call__`` derives them) and
  whose draws the port's ``draw`` returns.

JAX runs jitted under full matmul precision.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from efficient_multimodal_perception_tpu.configs.tiny import tiny_mae
from efficient_multimodal_perception_tpu.core.geometry import (
    CameraAug as JAug,
    crop_to_range as j_crop,
)
from efficient_multimodal_perception_tpu.data.batch import Batch as JBatch
from efficient_multimodal_perception_tpu.losses.sup_con import (
    sup_con_loss as j_sup_con,
)
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu.models.interpnet import (
    InterpNet as JInterpNet,
)
from efficient_multimodal_perception_tpu.ops.pallas_kernels import (
    sample_triplane_auto as j_sample_auto,
)
from efficient_multimodal_perception_tpu.ops.radius import (
    radius_neighbors as j_radius,
)
from efficient_multimodal_perception_tpu.train.trainer import (
    freeze_mask,
    total_loss as jax_total_loss,
)
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.losses.sup_con import (
    MIN_CLUSTER_SIZE,
    sup_con_loss,
)
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.models.interpnet import InterpNet
from efficient_multimodal_perception_tpu_torch.ops.radius import (
    radius_neighbors,
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
from test_torch_port_mae import JAX_FREEZE, PORT_FREEZE
from test_torch_port_point_train import _draw

TOL = 1e-5        # the losses alone
LOSS_RTOL = 1e-4  # the whole model
GRAD_RTOL = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def quick_compile(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` with XLA:CPU's backend
    optimisation off: a whole tiny model's gradient compiles in about
    two thirds of the time, and the arithmetic is float32 all the same."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True})


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _holder(name, module, flat):
    """``module`` as the sub-module ``name`` of a holder, loaded from the
    flat JAX params of that sub-module (the bridge's rules are anchored at
    the model's module names)."""
    h = torch.nn.Module()
    h.add_module(name, module)
    h.load_state_dict(load_jax_params(
        {f"params/{name}/{k}": v for k, v in flat.items()}, h))
    return h


def _cloud(rng, S, n_invalid):
    """Supports in a 4 m cube with a dense 0.5 m ball at the origin (its
    queries have more than k neighbours), ``n_invalid`` of them invalid."""
    s = rng.uniform(-4, 4, (S, 3)).astype(np.float32)
    s[: S // 4] = rng.normal(0, 0.25, (S // 4, 3))
    valid = np.ones(S, bool)
    valid[rng.choice(S, n_invalid, replace=False)] = False
    return s, valid


@functools.partial(jax.jit, static_argnums=3)
def _j_radius(q, s, v, k):
    return j_radius(q, s, v, 1.0, k)


@pytest.mark.parametrize("B", [1, 2])
def test_radius_neighbors_match_jax(B):
    """Identical ``idx`` and ``mask``, each sample against JAX's search
    on it: queries at the dense ball (more than k), spread over the cube,
    and far outside it (none); 64 queries a chunk."""
    rng = np.random.default_rng(20 + B)
    S, Q, k = 700, 300, 8
    sup, val, qs = [], [], []
    for _ in range(B):
        s, v = _cloud(rng, S, 90)
        q = rng.uniform(-4, 4, (Q, 3)).astype(np.float32)
        q[:60] = rng.normal(0, 0.1, (60, 3))
        q[-40:] += 50.0
        sup.append(s), val.append(v), qs.append(q)
    want = [jax.device_get(_j_radius(q, s, v, k))
            for q, s, v in zip(qs, sup, val)]
    idx, mask = radius_neighbors(_t(np.stack(qs)), _t(np.stack(sup)),
                                 _t(np.stack(val)), 1.0, k, chunk=64)
    for b, (wi, wm) in enumerate(want):
        np.testing.assert_array_equal(mask[b].numpy(), np.asarray(wm))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(wi))
        m = np.asarray(wm)
        assert m[:60].all(axis=1).mean() > 0.9  # more than k at the ball
        assert not m[-40:].any()  # none far away
        assert 0 < m[60:-40].sum() < m[60:-40].size
        assert val[b][np.asarray(wi)[m]].all()


def _sup_con_inputs(rng, P=220, C=16):
    """Clusters 1..5 of 50, 50, 50, 50 and 12 members (eligible), label 6
    with 8 (not), a few invalid rows."""
    feats = rng.standard_normal((P, C)).astype(np.float32)
    labels = np.concatenate([np.repeat(np.arange(1, 6), [50, 50, 50, 50, 12]),
                             np.full(8, 6)]).astype(np.int32)
    perm = rng.permutation(P)
    valid = rng.random(P) > 0.05
    return feats, labels[perm], valid


@functools.partial(jax.jit, static_argnums=4)
def _j_sup_con_grad(f, labels, valid, key, M):
    (loss, ok), g = jax.value_and_grad(
        lambda ff: j_sup_con(ff, labels, valid, key, M), has_aux=True)(f)
    return loss, g, ok


def _jax_sup_con(feats, labels, valid, key, M):
    """JAX's loss and features' gradient, and its ``has_anchor``."""
    with jax.default_matmul_precision("highest"):
        loss, g, ok = jax.device_get(_j_sup_con_grad(feats, labels, valid,
                                                     key, M))
    return (loss, g), bool(ok)


def test_sup_con_matches_jax_with_replayed_scores():
    """One channel, then every (sample, channel) of a (2, 3) batch at once
    against JAX channel by channel: loss, ``has_anchor`` and the
    features' gradient."""
    rng = np.random.default_rng(7)
    M = 16
    feats, labels, valid = _sup_con_inputs(rng)
    key = jax.random.key(17)
    (want, wgrad), ok = _jax_sup_con(feats, labels, valid, key, M)
    scores = np.asarray(jax.random.uniform(key, (labels.shape[0],)))
    ft = _t(feats[None]).requires_grad_(True)
    got, has = sup_con_loss(ft, _t(labels[None, None]),
                            _t(valid[None, None]), _t(scores[None, None]), M)
    got.backward()
    assert got.shape == has.shape == (1, 1)
    assert ok and bool(has)
    assert abs(float(got.detach()) - float(want)) <= TOL * abs(float(want))
    assert _rel(ft.grad[0], wgrad) <= TOL

    B, N, P = 2, 3, labels.shape[0]
    fb = rng.standard_normal((B, P, 16)).astype(np.float32)
    lb = np.stack([np.stack([rng.permutation(labels) for _ in range(N)])
                   for _ in range(B)])
    vb = rng.random((B, N, P)) > 0.1
    keys = jax.random.split(jax.random.key(3), B * N)
    sb = np.stack([np.asarray(jax.random.uniform(k, (P,))) for k in keys])
    ft = _t(fb).requires_grad_(True)
    got, has = sup_con_loss(ft, _t(lb), _t(vb), _t(sb.reshape(B, N, P)), M)
    got.sum().backward()
    wgrad = np.zeros_like(fb)
    for i in range(B * N):
        b, n = divmod(i, N)
        (w, g), _ = _jax_sup_con(fb[b], lb[b, n], vb[b, n], keys[i], M)
        assert abs(float(got[b, n]) - float(w)) <= TOL * abs(float(w))
        wgrad[b] += g
    assert bool(has.all())
    assert _rel(ft.grad, wgrad) <= TOL


@pytest.mark.parametrize("case", ["no_valid_point", "no_cluster_of_10"])
def test_sup_con_degenerate_channel_is_zero_with_finite_grad(case):
    """A channel with no valid point, or whose clusters all have fewer
    than ``MIN_CLUSTER_SIZE`` members: loss 0 and no anchor, as in JAX,
    and a gradient that is finite and zero (the masked softmax's -inf
    logits do not leak NaN into it), beside a normal channel."""
    rng = np.random.default_rng(11)
    P, M = 120, 16
    feats = rng.standard_normal((P, 8)).astype(np.float32)
    if case == "no_valid_point":
        labels = rng.integers(1, 4, P).astype(np.int32)
        valid = np.zeros(P, bool)
    else:
        labels = np.arange(P, dtype=np.int32) % 15 + 1  # 8 members each
        valid = np.ones(P, bool)
    assert np.bincount(labels[valid], minlength=1).max(
        initial=0) < MIN_CLUSTER_SIZE
    key = jax.random.key(5)
    (want, wgrad), ok = _jax_sup_con(feats, labels, valid, key, M)
    assert float(want) == 0.0 and not ok and np.isfinite(wgrad).all()
    scores = np.asarray(jax.random.uniform(key, (P,)))
    normal = (np.arange(P) % 3 + 1).astype(np.int32)  # 40 members each
    ft = _t(np.stack([feats, feats])).requires_grad_(True)
    got, has = sup_con_loss(
        ft, _t(np.stack([labels, normal])[:, None]),
        _t(np.stack([valid, np.ones(P, bool)])[:, None]),
        _t(np.stack([scores, scores])[:, None]), M)
    got.sum().backward()
    assert float(got[0, 0]) == 0.0 and not bool(has[0, 0])
    assert bool(has[1, 0]) and float(got[1, 0]) > 0
    assert bool(torch.isfinite(ft.grad).all())
    assert float(ft.grad[0].abs().max()) == 0.0
    assert float(ft.grad[1].abs().max()) > 0.0


def _interp_case():
    """The setting of ``test_stochastic_loss_parity``: two samples, the
    second with fewer valid points than a third of the queries."""
    B, P, C = 2, 400, 16
    rng = np.random.default_rng(3)
    pts = rng.uniform(-4, 4, (B, P, 3)).astype(np.float32)
    lat = rng.standard_normal((B, P, C)).astype(np.float32)
    valid = np.ones((B, P), bool)
    valid[0, 350:] = False
    valid[1, 25:] = False
    kw = dict(latent_size=C, radius=1.5, n_non_manifold_pts=90,
              non_manifold_dist=0.1, k_neighbors=8)
    return pts, lat, valid, kw


def interpnet_draws(key, B, P, n):
    """The draws ``InterpNet.__call__`` makes from ``key``, in the port's
    ``InterpNet.draw`` layout: per sample (``split(key, B)``), the pick
    scores of each third (``uniform(fold_in(k_sel, i), (P,))``) and the
    radii of the in, out and far thirds."""
    n_out = n_far = n // 3
    n_in = n - 2 * (n // 3)
    picks, radii = [], []
    for kb in jax.random.split(key, B):
        k_sel, k_in, k_out, k_far = jax.random.split(kb, 4)
        picks.append([np.asarray(jax.random.uniform(
            jax.random.fold_in(k_sel, i), (P,))) for i in range(3)])
        radii.append(np.concatenate([
            np.asarray(jax.random.uniform(k, (c, 1)))
            for k, c in ((k_in, n_in), (k_out, n_out), (k_far, n_far))]))
    return dict(pick=_t(np.asarray(picks, np.float32)),
                radii=_t(np.asarray(radii, np.float32)))


def test_interpnet_matches_jax_with_replayed_queries():
    """``InterpNet.__call__`` against the port's forward on the same
    weights and JAX's draws: the loss, and the gradients of the latents
    and the weights; the queries ``create_targets`` makes agree where
    they are valid."""
    pts, lat, valid, kw = _interp_case()
    jm = JInterpNet(**kw)
    key = jax.random.key(11)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), pts, lat,
                                            valid, key))
    flat = {k.split("/", 1)[1]: v for k, v in _draw(shapes, 12).items()}
    params = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    with jax.default_matmul_precision("highest"):
        want, (gp, gl) = jax.device_get(jax.jit(jax.value_and_grad(
            lambda p, la: jm.apply({"params": p}, pts, la, valid, key),
            argnums=(0, 1)))(params, lat))
    port = InterpNet(**kw)
    holder = _holder("surface_decoder", port, flat)
    draws = interpnet_draws(key, *pts.shape[:2], kw["n_non_manifold_pts"])
    lt = _t(lat).requires_grad_(True)
    got = port(_t(pts), lt, _t(valid), draws)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= TOL * abs(float(want))
    assert _rel(lt.grad, gl) <= 1e-4
    for k, g in traverse_util.flatten_dict(gp, sep="/").items():
        name, g = port_key(f"params/surface_decoder/{k}", np.asarray(g))
        p = holder.get_parameter(name.replace("/", "."))
        assert _rel(p.grad, g) <= 1e-4, name
    keys = jax.random.split(key, pts.shape[0])
    q, occ, qv = port.create_targets(_t(pts), _t(valid), draws)
    for b in range(pts.shape[0]):
        wq, wocc, wqv = jax.device_get(jm.create_targets(
            pts[b], valid[b], keys[b]))
        np.testing.assert_array_equal(qv[b].numpy(), wqv)
        np.testing.assert_array_equal(occ[b].numpy(), wocc)
        np.testing.assert_allclose(q[b].numpy()[wqv], wq[wqv], atol=1e-6,
                                   rtol=1e-6)


def test_create_targets_geometry():
    """The port's own draws: ``in`` queries sit +d r beyond a valid
    support along its ray (label 1), ``out`` queries -d r before one
    (0), ``far`` queries are a valid support scaled toward the origin by
    r in [0, 1) (0); picks beyond the valid count are flagged invalid."""
    P = 120
    rng = np.random.default_rng(9)
    pts = rng.uniform(1.0, 6.0, (1, P, 3)).astype(np.float32)
    valid = np.zeros((1, P), bool)
    valid[0, :12] = True  # 12 valid points < the 30-query thirds
    net = InterpNet(n_non_manifold_pts=90, non_manifold_dist=0.1)
    draws = net.draw(1, P, torch.Generator().manual_seed(0), "cpu")
    q, occ, q_valid = (t[0].numpy() for t in net.create_targets(
        _t(pts), _t(valid), draws))
    n_in = 30
    assert (occ[:n_in] == 1).all() and (occ[n_in:] == 0).all()
    vp = pts[0, :12]
    norms = np.linalg.norm(vp, axis=-1)
    units = vp / norms[:, None]
    for j in np.nonzero(q_valid)[0]:
        third = 0 if j < n_in else (1 if j < 60 else 2)
        if third < 2:
            delta = q[j][None] - vp
            along = (delta * units).sum(-1)
            perp = np.linalg.norm(delta - along[:, None] * units, axis=-1)
            sign = along >= -1e-6 if third == 0 else along <= 1e-6
            assert ((perp < 1e-4) & (np.abs(along) <= 0.1 + 1e-5)
                    & sign).any(), (j, third)
        else:
            ratios = q[j][None] / vp
            assert ((np.abs(ratios - ratios[:, :1]).max(-1) < 1e-4)
                    & (ratios[:, 0] >= 0) & (ratios[:, 0] < 1)).any(), j
    assert (~q_valid).sum() == 3 * (30 - 12)


def _jax_batch(a):
    return JBatch(
        img=jnp.asarray(a["img"]), range_image=jnp.asarray(a["range_image"]),
        range_points=jnp.asarray(a["range_points"]),
        lidar2img=jnp.asarray(a["lidar2img"]),
        cam_aug=JAug(jnp.asarray(a["cam_resize"]), jnp.asarray(a["cam_crop"]),
                     jnp.asarray(a["cam_flip"])),
        points=jnp.asarray(a["points"]),
        points_valid=jnp.asarray(a["points_valid"]))


def jax_contrastive(feats, points, base_valid, rng_c, max_clusters):
    """The models' ``_contrastive_loss`` with its key ``rng_c`` given:
    JAX's ``sup_con_loss`` on each (sample, camera) with the key
    ``split(fold_in(rng_c, cam), B)[b]``, the mean over those with an
    anchor (vmapped over the cameras where the models loop)."""
    B = feats.shape[0]
    labels = jnp.moveaxis(points[..., 5:11].astype(jnp.int32), -1, 0)
    keys = jnp.stack([jax.random.split(jax.random.fold_in(rng_c, cam), B)
                      for cam in range(6)])
    loss, ok = jax.vmap(jax.vmap(lambda f, l, v, k: j_sup_con(
        f, l, v, k, max_clusters)), in_axes=(None, 0, 0, 0))(
        feats, labels, base_valid[None] & (labels > 0), keys)
    ok = ok.astype(jnp.float32)
    return (loss * ok).sum() / jnp.maximum(ok.sum(), 1.0)


def jax_pretrain_losses(m, batch, rng_c, rng_s):
    """``TriplaneMAE.__call__`` of the surface + contrastive config, its
    ``make_rng("sample")`` keys given: ``rng_c`` for the contrastive loss
    (``fold_in(rng_c, cam)`` split over the batch) and ``rng_s`` for the
    surface loss (``InterpNet`` splits it over the batch)."""
    triplane, aux = m.encode_triplane(batch, True)
    B, _, _, _, C = triplane.shape
    RH, RW = aux["range_image"].shape[1:3]
    range_proj = j_sample_auto(triplane, aux["range_points"], m.pc_range,
                               m.voxel_size)
    pts = batch.points[..., :3]
    in_range = j_crop(pts, m.pc_range) & batch.points_valid
    feats = j_sample_auto(triplane, pts, m.pc_range, m.voxel_size)
    sp = aux["range_points"].reshape(B, RH * RW, 3)
    return {"contrastive_loss": jax_contrastive(feats, batch.points,
                                                in_range, rng_c,
                                                m.max_sam_clusters),
            "surface_loss": m.surface_dec(
                sp, range_proj.reshape(B, RH * RW, C),
                jnp.any(sp != 0, axis=-1), rng_s)}


@pytest.fixture(scope="module")
def surf_case():
    """JAX's losses and gradients of the tiny surface + contrastive MAE at
    B=1 (f32, deterministic, stage 0 frozen by stop_gradient; weights
    drawn with numpy for the shapes ``jax.eval_shape`` gives) and the
    draws its keys make."""
    arrs = synthetic_arrays(1, point_budget=2048, seed=4)
    jb = _jax_batch(arrs)
    model = jax_build_model(tiny_mae(recon=False))
    rng_c, rng_s = jax.random.key(31), jax.random.key(32)
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0), "sample": jax.random.key(1)}, b,
        deterministic=True), jb)
    flat = {k.split("/", 1)[1]: v for k, v in _draw(shapes, 2).items()}

    def loss_fn(params):
        keep = freeze_mask(params, JAX_FREEZE)
        params = jax.tree.map(
            lambda p, t: p if t else jax.lax.stop_gradient(p), params, keep)
        losses = model.apply({"params": params}, jb, rng_c, rng_s,
                             method=jax_pretrain_losses)
        return jax_total_loss(losses), losses

    tree = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    with jax.default_matmul_precision("highest"):
        (_, losses), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(tree)
    gflat = traverse_util.flatten_dict(jax.device_get(grads), sep="/")
    P = arrs["points"].shape[1]
    scores = np.stack([np.stack([
        np.asarray(jax.random.uniform(k, (P,))) for k in jax.random.split(
            jax.random.fold_in(rng_c, cam), 1)]) for cam in range(6)], 1)
    draws = dict(contrastive=_t(scores),
                 surface=interpnet_draws(rng_s, 1, 32 * 1024, 256))
    return dict(arrs=arrs, flat=flat, draws=draws,
                losses={k: float(v) for k, v in losses.items()},
                grads={port_key(k, np.asarray(v))[0].replace("/", "."):
                       port_key(k, np.asarray(v))[1]
                       for k, v in gflat.items()})


def test_tiny_surf_sam_matches_jax(surf_case):
    """The port's full forward, its ``draw`` returning JAX's draws."""
    model = build_model(get_config("tiny_surf_sam")["model"], device="cpu")
    model.load_state_dict(load_jax_params(surf_case["flat"], model))
    model.draw = lambda batch, generator: surf_case["draws"]
    named = freeze(model, PORT_FREEZE)
    losses, _, grads = loss_and_grads(
        model, [p for _, p in named], arrays_to_batch(surf_case["arrs"]),
        None, deterministic=True)
    want = surf_case["losses"]
    assert set(losses) == set(want) == {"contrastive_loss", "surface_loss"}
    for k, v in want.items():
        assert abs(float(losses[k].detach()) - v) <= LOSS_RTOL * abs(v), (
            k, float(losses[k]), v)
    errs = {n: _rel(g, surf_case["grads"][n]) for (n, _), g in
            zip(named, grads)}
    assert len(errs) > 40
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_RTOL, (worst, errs[worst])
    assert "surface_decoder.mlp_layers.1.weight" in errs


def test_colour_head_still_refused():
    """The surface and contrastive heads build, and so does the colour
    head (``PointMlp``, which no shipped config uses); a head of a type
    the registry does not know is refused."""
    cfg = get_config("tiny_surf_sam")["model"]
    model = build_model(cfg, device="cpu")
    assert model.contrastive and model.surface_decoder is not None
    colour = build_model(dict(cfg, color_decoder=dict(
        type="PointMlp", input_dim=32, num_classes=3)), device="cpu")
    assert colour.color_decoder.fc_out.weight.shape == (3, 32)
    with pytest.raises(KeyError, match="ColourHead"):
        build_model(dict(cfg, color_decoder=dict(type="ColourHead")),
                    device="cpu")

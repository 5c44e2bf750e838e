"""The port's int8 serving path against the JAX package, on the CPU.

Inputs and weights are made with numpy seeds and handed to both
packages; whole models carry the JAX weights through
``weights.load_jax_params``.  Every JAX apply is jitted and runs under
full matmul precision.  The B10 and probe kernels themselves run only on
the card (``tests/test_torch_port_cuda.py``); here their twins are held
to the Pallas kernel in interpret mode and to the JAX package's XLA
math.  The neck and whole models are compared site by site at their
quantizers (``_Forced``), each with a control that must miss.
"""

import functools
import io
import urllib.request
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from efficient_multimodal_perception_tpu.configs.tiny import tiny_occ, tiny_point
from efficient_multimodal_perception_tpu.models.builder import (
    build_model as jax_build_model,
)
from efficient_multimodal_perception_tpu.models.heads import (
    OccMlpHead as JOccMlpHead,
)
from efficient_multimodal_perception_tpu.models.mit import (
    MixVisionTransformer as JMixVisionTransformer,
)
from efficient_multimodal_perception_tpu.ops import quant as JQ
from efficient_multimodal_perception_tpu.ops.pallas_kernels import (
    _block_int8_impl,
    _quantize_cols,
    _xla_block_int8_math,
)
from efficient_multimodal_perception_tpu_torch.configs import get_config
from efficient_multimodal_perception_tpu_torch.data.synthetic import (
    arrays_to_batch,
    synthetic_arrays,
)
from efficient_multimodal_perception_tpu_torch.models.builder import build_model
from efficient_multimodal_perception_tpu_torch.models.heads import OccMlpHead
from efficient_multimodal_perception_tpu_torch.models.mit import (
    MixVisionTransformer,
)
from efficient_multimodal_perception_tpu_torch.ops import kernels as K
from efficient_multimodal_perception_tpu_torch.ops import quant as Q
from efficient_multimodal_perception_tpu_torch.serve import (
    BATCH_KEYS,
    make_model,
    make_server,
)
from efficient_multimodal_perception_tpu_torch.weights import (
    load_jax_params,
    port_key,
)
from test_torch_port_point import jax_batch, load_as, randomized, unflatten
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

HIGHEST = "highest"
AMAX_TOL = 1e-5  # calibrated amaxes, relative


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _dist(a, b):
    """``_rel`` that stays finite where ``b`` is all zeros."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _quant_rows():
    """Random rows, rows whose amax is 127 (scale exactly 1) holding exact
    .5 ties, and an all-zero row."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 40)).astype(np.float32) * 3
    ties = np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5,
                     3.5, 4.5, -3.5], np.float32)
    x[1, :12] = ties
    x[1, 12:] = 0.25
    x[2] = -x[1]
    x[3] = 0.0
    return x


def test_sym_quant_bit_identical_to_jax():
    x = _quant_rows()
    q, s = Q.sym_quant(_t(x), -1)
    jq, js = JQ._sym_quant(jnp.asarray(x), axis=-1)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, 126.5 -> 126; zeros stay 0
    assert q[1, :12].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4, 4,
                                  -4]
    assert not q[3].any() and float(s[3]) == np.float32(1e-12) / np.float32(127)
    # per output channel: rows of the (out, in) weight, JAX's columns
    wq, ws = Q.quantize_weight(_t(x))
    jwq, jws = _quantize_cols(jnp.asarray(x.T))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq).T)
    np.testing.assert_array_equal(ws.numpy(), np.asarray(jws))


def test_int8_matmul_and_quant_dense_match_jax():
    """f32 activations (a leading batch axis, rows below the 17 the card's
    product needs, N off a multiple of 8) through both packages."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 50)) / 10).astype(np.float32)
    b = rng.standard_normal(50).astype(np.float32)
    got = Q.int8_matmul(_t(x), _t(w.T))
    want = JQ.int8_matmul(jnp.asarray(x), jnp.asarray(w))
    assert got.shape == (2, 9, 50) and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6
    got = Q.quant_dense(_t(x), _t(w.T), _t(b))
    want = JQ.quant_dense(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert _rel(got, want) <= 1e-6
    # the straight-through backward: dx and dw of (int8_matmul(x, w) ** 2)
    # .sum() against jax.grad of the JAX package's (test_quant.py:57-76)
    gx, gw = jax.jit(jax.grad(lambda a, k: (JQ.int8_matmul(a, k) ** 2).sum(),
                              argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(True), _t(w.T).requires_grad_(True)
    (Q.int8_matmul(tx, tw) ** 2).sum().backward()
    assert tx.grad.dtype == torch.float32 and tw.grad.shape == (50, 96)
    assert _rel(tx.grad, gx) <= 1e-6 and _rel(tw.grad.T, gw) <= 1e-6
    assert float(tx.grad.abs().max()) > 0  # not round()'s zero derivative


@pytest.mark.parametrize("amax", [3.7, 127.0, 0.0],
                         ids=["calibrated", "ties", "zero"])
def test_static_quant_matmul_bit_identical_to_jax(amax):
    """``static_quant_matmul`` against the JAX package's, bit for bit in
    float32: a calibrated amax that clips the tail, amax 127 (scale
    exactly 1) on inputs holding .5 ties (half to even), and amax 0
    (scale 1e-12 / 127: every nonzero input clips to +-127).  JAX runs
    op by op, as written (``acc * scale * w_scale``): under ``jax.jit``
    XLA's fusion moves a few of these outputs by an ulp."""
    x = _quant_rows()
    x[4] = np.linspace(-5, 5, 40, dtype=np.float32)
    w = (np.random.default_rng(7).standard_normal((40, 24)) / 6).astype(
        np.float32)
    a = np.float32(amax)
    got = Q.static_quant_matmul(_t(x), _t(w.T), torch.tensor(a))
    want = JQ.static_quant_matmul(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(a))
    assert got.dtype == torch.float32 and got.shape == (6, 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["probe", "ragged"])
def test_int8_dot_plain_is_exact(case):
    """``int8_dot``'s twin, and the wrapper given CPU tensors, give the
    exact integer product: on the JAX tool's probe operands
    (``tools/measure_int8.py:43-45``, x (256, 128) and w (128, 256) as
    (K, N)) and at a ragged shape (M = 17, K = 48, N = 24) over the whole
    int8 range, against numpy's int64 product."""
    if case == "probe":
        x = (np.arange(256 * 128).reshape(256, 128) % 13 - 6).astype(np.int8)
        w = (np.arange(128 * 256).reshape(128, 256) % 7 - 3).astype(np.int8)
        wt = np.ascontiguousarray(w.T)
    else:
        rng = np.random.default_rng(4)
        x = rng.integers(-128, 128, (17, 48)).astype(np.int8)
        wt = rng.integers(-128, 128, (24, 48)).astype(np.int8)
    want = x.astype(np.int64) @ wt.astype(np.int64).T
    tx, tw = torch.from_numpy(x), torch.from_numpy(wt)
    before = dict(K.LAUNCHES)
    for got in (K.int8_dot_plain(tx, tw), K.int8_dot(tx, tw)):
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy().astype(np.int64), want)
    assert K.LAUNCHES == before  # CPU tensors run the twin


@pytest.mark.parametrize("M,N,bn", [
    (256, 256, 96),        # the probe: six tiles rather than two
    (4096, 4096, 256),     # measure_int8.py section 1: big
    (393216, 768, 256),    # epi1
    (32768, 2048, 256),    # neck
    (786432, 384, 192),    # B10 camera stage 0, fc1: whole 192-wide tiles
    (786432, 96, 96),      # fc2
])
def test_int8_gemm_tile_width_plan(M, N, bn):
    """The int8 GEMM's column-tile width on a 132-SM card, at the shapes
    ``chip_smoke.py`` times it."""
    assert K.plan_tile_width(M, N, 132, K.INT8_WIDTHS) == bn


def _block_params(rng, C):
    """JAX-layout block parameters (gamma = 1, so the int8 MLP carries
    the signal) and their port layouts."""
    j = dict(
        dw_k=rng.normal(0, 1 / 7, (7, 7, 1, C)),
        dw_b=rng.normal(0, 0.1, C),
        ln_s=1 + rng.normal(0, 0.1, C),
        ln_b=rng.normal(0, 0.1, C),
        w1=rng.normal(0, C**-0.5, (C, 4 * C)),
        b1=rng.normal(0, 0.1, 4 * C),
        w2=rng.normal(0, (4 * C)**-0.5, (4 * C, C)),
        b2=rng.normal(0, 0.1, C),
        gamma=np.ones(C),
    )
    j = {k: v.astype(np.float32) for k, v in j.items()}
    p = dict(j, dw_k=j["dw_k"].transpose(3, 2, 0, 1), w1=j["w1"].T,
             w2=j["w2"].T)
    order = ("dw_k", "dw_b", "ln_s", "ln_b", "w1", "b1", "w2", "b2", "gamma")
    return [jnp.asarray(j[k]) for k in order], [_t(p[k]) for k in order]


def test_block_int8_twin_matches_pallas_and_xla():
    """The B10 twin (exact erf) against the Pallas kernel in interpret mode
    (A&S erf: a code can flip) and against the XLA int8 math, on the
    residual-free delta at ``tests/test_quant.py``'s shape."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 32, 8)).astype(np.float32)
    jargs, pargs = _block_params(rng, 8)
    d_pallas = np.asarray(_block_int8_impl(jnp.asarray(x), *jargs,
                                           interpret=True)) - x
    with jax.default_matmul_precision(HIGHEST):
        d_xla = np.asarray(jax.jit(_xla_block_int8_math)(jnp.asarray(x),
                                                         *jargs)) - x
    with torch.no_grad():
        d_port = K.convnext_block_int8_fused(_t(x), *pargs).numpy() - x
    err_pallas, err_xla = _rel(d_port, d_pallas), _rel(d_port, d_xla)
    print(f"B10 twin vs Pallas {err_pallas:.3g}, vs XLA {err_xla:.3g}")
    assert err_pallas <= 2e-3
    assert err_xla <= 1e-3


def test_int8_head_matches_jax_packed_head():
    """The port's per-voxel head with z-column scales against the JAX
    head on the z-packed rows; per-voxel scales (the JAX head unpacked)
    miss by far more, so the comparison sees where the scale is taken."""
    rng = np.random.default_rng(3)
    C, Z, NC = 32, 16, 5
    x = rng.standard_normal((2, 9, 9, Z, C)).astype(np.float32)
    ks = [rng.normal(0, s ** -0.5, shape).astype(np.float32)
          for s, shape in ((C, (C, 2 * C)), (2 * C, (2 * C, C)),
                           (C, (C, NC)))]
    params = {"params": {f"conv{i + 1}": {"kernel": jnp.asarray(k)}
                         for i, k in enumerate(ks)}}
    jh = JOccMlpHead(input_dim=C, num_classes=NC, int8=True)
    with jax.default_matmul_precision(HIGHEST):
        packed = np.asarray(jax.jit(lambda p, a: jh.apply(p, a, packed_z=Z))(
            params, jnp.asarray(x.reshape(2, 9, 9, Z * C))))
        per_voxel = np.asarray(jax.jit(jh.apply)(params, jnp.asarray(x)))
    head = OccMlpHead(C, NC, int8=True)
    with torch.no_grad():
        for i, k in enumerate(ks):
            getattr(head, f"conv{i + 1}")[0].weight.copy_(_t(k.T))
        got = head(_t(x)).numpy()
    assert got.shape == (2, 9, 9, Z, NC)
    err, miss = _rel(got, packed), _rel(per_voxel, packed)
    print(f"int8 head vs JAX packed {err:.3g}; per-voxel scales {miss:.3g}")
    assert err <= 1e-5
    assert miss > 100 * 1e-5


# Quantizer inputs.  Left free, the port and the JAX package differ by
# f32 rounding before each quantizer; a code at a rounding tie then flips,
# a flip moves its row's product by ~1/127 of the row's amax, and the
# flips cascade through the following int8 products: JAX's own int8
# logits move by ~2e-2 when its weights move by 1e-6 (ROADMAP section C).
# So the whole-model and neck comparisons hold each port quantizer's
# input to JAX's input at the same site (SITE_TOL), then quantize JAX's
# input there, and compare what the rest of the model makes of it.
SITE_TOL = 1e-4
FORCED_TOL = 1e-5
SYM_QUANT = Q.sym_quant


def _record_jax_quant(m, records):
    """Patch the JAX package's ``_sym_quant`` (through ``m``, a
    ``monkeypatch`` context) so that a jitted apply appends every f32
    activation it quantizes to ``records``."""
    orig = JQ._sym_quant

    def rec(x, axis):
        if axis != 0:  # axis 0 is a (K, N) weight's columns
            jax.debug.callback(lambda v: records.append(np.array(v)),
                               x.astype(jnp.float32))
        return orig(x, axis)

    m.setattr(JQ, "_sym_quant", rec)


class _Forced:
    """The port's ``sym_quant`` with each activation quantization fed the
    JAX input of its site: the recorded input of the same size and row
    length that lies closest.  ``errs`` holds each site's relative
    distance, ``unmatched`` counts port sites with no JAX counterpart,
    ``free`` the JAX sites the port never reached."""

    def __init__(self, records):
        self.free, self.errs, self.unmatched = list(records), [], 0

    def take(self, x, row):
        """The free record closest to ``x`` among those of its size (and
        of row length ``row``, unless None), removed from the pool, or
        None.  Candidates are ranked on 4096 evenly spaced elements (a
        site's own input lies ~1e-6 away, any other ~1), the distance
        kept is the whole input's (relative Frobenius, float32 sums)."""
        xf = x.detach().float().reshape(-1)
        step = max(1, xf.numel() // 4096)
        cands = [i for i, r in enumerate(self.free) if r.size == xf.numel()
                 and (row is None or r.shape[-1] == row)]
        if not cands:
            self.unmatched += 1
            return None
        i = min(cands, key=lambda i: _dist(
            xf[::step].numpy(), self.free[i].reshape(-1)[::step]))
        r = _t(self.free.pop(i).reshape(x.shape))
        rf = r.reshape(-1)
        self.errs.append(float(torch.linalg.vector_norm(xf - rf)
                               / torch.linalg.vector_norm(rf)))
        return r

    def __call__(self, x, axis):
        if axis == 1:  # the rows of an (out, in) weight
            return SYM_QUANT(x, axis)
        dims = axis if isinstance(axis, tuple) else (axis,)
        row = int(np.prod([x.shape[d] for d in dims]))
        got = self.take(x, row)
        return SYM_QUANT(x if got is None else got, axis)

    def check(self, n_sites):
        print(f"{len(self.errs)} quantizer sites, max input distance "
              f"{max(self.errs):.3g}")
        assert len(self.errs) == n_sites and not self.unmatched
        assert not self.free
        assert max(self.errs) <= SITE_TOL


def _run_forced(m, fn, records):
    """``fn()`` under no_grad with the port's quantizers forced."""
    forced = _Forced(records)
    with m.context() as mm:
        mm.setattr(Q, "sym_quant", forced)
        mm.setattr(K, "sym_quant", forced)
        with torch.no_grad():
            return fn(), forced


def _set_int8(module, on):
    for sub in module.modules():
        if hasattr(sub, "int8"):
            sub.int8 = on


def test_int8_neck_matches_jax(monkeypatch):
    """The MiT neck with int8 q, kv, proj, fc1 and fc2 against the JAX
    package's int8 neck on one f32 input: ten quantizer sites, each within
    SITE_TOL of JAX's, and the output within FORCED_TOL with the sites
    forced.  The same neck in float misses by far more."""
    x = np.random.default_rng(4).standard_normal((1, 128, 32, 64)).astype(
        np.float32)
    kw = dict(img_size=(128, 32), patch_size=1, in_chans=64, embed_dim=64)
    jm = JMixVisionTransformer(**kw, int8=True)
    flat = randomized(jax.jit(lambda a: jm.init(jax.random.key(0), a))(
        jnp.asarray(x)), 2)
    records = []
    with monkeypatch.context() as m:
        _record_jax_quant(m, records)
        with jax.default_matmul_precision(HIGHEST):
            want = np.asarray(jax.jit(jm.apply)(unflatten(flat),
                                                jnp.asarray(x)))
    neck = MixVisionTransformer(**kw, int8=True)
    load_as(neck, "neck", flat)
    got, forced = _run_forced(monkeypatch, lambda: neck(_t(x)).numpy(),
                              records)
    with torch.no_grad():
        free = neck(_t(x)).numpy()
    _set_int8(neck, False)
    ctl, _ = _run_forced(monkeypatch, lambda: neck(_t(x)).numpy(), records)
    assert got.shape == want.shape == (1, 128, 128, 96)
    err, ctl_err = _rel(got, want), _rel(ctl, want)
    print(f"int8 neck vs JAX: forced {err:.3g}, free {_rel(free, want):.3g}"
          f"; the neck in float {ctl_err:.3g}")
    forced.check(10)
    assert err <= FORCED_TOL
    assert ctl_err > 100 * FORCED_TOL


JAX_CFGS = {"tiny_occ": tiny_occ,
            "tiny_point_occ": lambda: tiny_point(occ=True)}


@functools.lru_cache(maxsize=None)
def _static_init(port_name):
    """The JAX package's static int8 tiny model of ``port_name``, its init
    variables (flax's ``init`` makes every collection mutable, so the
    ``quant`` leaves hold the init batch's amaxes) and that batch's
    arrays: one jitted init a model, shared by this module's dynamic and
    static whole-model tests (the params trees are the same)."""
    arrs = synthetic_arrays(1, point_budget=2048, with_occ=True, seed=3)
    jm = jax_build_model(JQ.enable_int8(JAX_CFGS[port_name](), mode="static"))
    variables = jax.jit(lambda b: jm.init({"params": jax.random.key(0)}, b,
                                          deterministic=True))(
        jax_batch(arrs))
    return jm, variables, arrs


def _int8_case(jax_cfg, port_name, seed):
    """A tiny model with int8 in both packages at B=1, f32, on randomized
    weights: the JAX logits and the JAX inputs of its quantizers, the port
    model (its parameter names those of the float model) and the batch."""
    _, static_vars, arrs = _static_init(port_name)
    jb = jax_batch(arrs)
    jm = jax_build_model(JQ.enable_int8(jax_cfg()))
    plain = jax_build_model(jax_cfg())
    shapes = [jax.eval_shape(lambda b, m=m: m.init(
        {"params": jax.random.key(0)}, b, deterministic=True), jb)
        for m in (jm, plain)]
    assert jax.tree_util.tree_structure(shapes[0]) == \
        jax.tree_util.tree_structure(shapes[1])
    flat = randomized({k: v for k, v in static_vars.items()
                       if k != "quant"}, seed)
    assert jax.tree_util.tree_structure(unflatten(flat)) == \
        jax.tree_util.tree_structure(shapes[0])
    records = []
    with pytest.MonkeyPatch.context() as m:
        _record_jax_quant(m, records)
        with jax.default_matmul_precision(HIGHEST):
            want = np.asarray(jax.jit(
                lambda v, b: jm.apply(v, b, deterministic=True)[0])(
                    unflatten(flat), jb))
    cfg = get_config(port_name)["model"]
    model = build_model(Q.enable_int8(cfg), device="cpu")
    assert set(model.state_dict()) == set(build_model(
        get_config(port_name)["model"], device="cpu").state_dict())
    model.load_state_dict(load_jax_params(flat, model))
    return model, arrays_to_batch(arrs), want, records


@pytest.mark.parametrize("jax_cfg,port_name,sites,late", [
    (tiny_occ, "tiny_occ", 29, ("neck", "decoder")),
    (lambda: tiny_point(occ=True), "tiny_point_occ", 35, ("decoder",)),
], ids=["triplane_occ", "point_triplane_occ"])
def test_tiny_int8_model_matches_jax(jax_cfg, port_name, sites, late,
                                     monkeypatch):
    """Whole int8 models: every quantizer site of the JAX model reached
    once, each input within SITE_TOL, and the logits within FORCED_TOL
    (under the 1e-3 and 0.999 argmax agreement asked of a port) with the
    sites forced.  A control with int8 off in ``late`` misses them."""
    model, batch, want, records = _int8_case(jax_cfg, port_name, seed=0)
    got, forced = _run_forced(monkeypatch,
                              lambda: model(batch)[0].numpy(), records)
    for part in late:
        _set_int8(getattr(model, part), False)
    ctl, _ = _run_forced(monkeypatch, lambda: model(batch)[0].numpy(),
                         records)
    assert got.shape == want.shape == (1, 99, 99, 16, 5)
    err, ctl_err = _rel(got, want), _rel(ctl, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    print(f"{port_name} int8 logits vs JAX: rel err {err:.3g}, max abs "
          f"{np.abs(got - want).max():.3g}, argmax agreement {agree:.6f}; "
          f"int8 off in {late}: {ctl_err:.3g}")
    forced.check(sites)
    assert err <= FORCED_TOL and agree >= 0.999
    assert ctl_err > 100 * FORCED_TOL


def _record_jax_static(m, records):
    """Patch the JAX package's ``static_quant_matmul`` so that a jitted
    apply appends every activation it quantizes to ``records``."""
    orig = JQ.static_quant_matmul

    def rec(x, w, amax):
        jax.debug.callback(lambda v: records.append(np.array(v)),
                           x.astype(jnp.float32))
        return orig(x, w, amax)

    m.setattr(JQ, "static_quant_matmul", rec)


class _ForcedStatic(_Forced):
    """The port's ``static_quant_matmul`` fed the JAX input of its site:
    the recorded input of the same size that lies closest (the head's is
    z-packed in JAX, ``(..., Z * C)`` where the port has ``(..., Z, C)``,
    in the same order)."""

    def __call__(self, x, w, amax):
        got = self.take(x, None)
        return STATIC_QUANT(x if got is None else got, w, amax)


STATIC_QUANT = Q.static_quant_matmul


def _quant_flat(tree):
    return {f"quant/{k}": np.asarray(v, np.float32) for k, v in
            traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


@pytest.mark.parametrize("port_name,sites,late", [
    ("tiny_occ", 29, ("neck", "decoder")),
    ("tiny_point_occ", 35, ("decoder",)),
], ids=["triplane_occ", "point_triplane_occ"])
def test_calibrate_then_serve_matches_jax(port_name, sites, late,
                                          monkeypatch):
    """Static int8 ``tiny_occ`` / ``tiny_point_occ``: the bridge places
    JAX's ``quant`` leaves one for one onto the amax buffers; from those
    amaxes both packages calibrate on the batches of seeds 0 and 1 (the
    dynamic product at every site, compared site by site) and the
    amaxes agree within AMAX_TOL; the state dict carries them; then the
    served logits, with JAX's amaxes and each static site fed JAX's
    input, within FORCED_TOL and argmax agreement 0.999 of JAX's, while
    a control with int8 off in the late parts misses."""
    jm, variables, arrs = _static_init(port_name)
    flat = randomized({k: v for k, v in variables.items() if k != "quant"},
                      0)
    quant0 = _quant_flat(variables["quant"])
    flat.update(quant0)
    model = build_model(Q.enable_int8(get_config(port_name)["model"],
                                      mode="static"), device="cpu")
    sd = load_jax_params(flat, model)
    assert len(quant0) == len(Q.static_sites(model))
    assert {k for k in sd if k in Q.static_sites(model)} == set(
        Q.static_sites(model))
    model.load_state_dict(sd)
    calib = [synthetic_arrays(1, point_budget=2048, with_occ=True, seed=s)
             for s in (0, 1)]

    # calibration: both passes record into one pool (a jitted apply keeps
    # the callback of its first trace), each port site takes its closest
    variables = unflatten(flat)
    calib_fn = jax.jit(lambda v, b: jm.apply(
        v, b, deterministic=True, mutable=["quant"])[1]["quant"])
    records = []
    with monkeypatch.context() as m:
        _record_jax_quant(m, records)
        with jax.default_matmul_precision(HIGHEST):
            for a in calib:
                variables = {**variables, "quant": calib_fn(
                    variables, jax_batch(a))}
    batches = [arrays_to_batch(a) for a in calib]
    _, forced = _run_forced(monkeypatch,
                            lambda: Q.calibrate(model, batches), records)
    forced.check(2 * sites)

    def port_amaxes(flat):
        return {port_key(k, v)[0].replace("/", "."): float(v)
                for k, v in flat.items()}

    want = port_amaxes(_quant_flat(variables["quant"]))
    init = port_amaxes(quant0)
    got = {k: float(v) for k, v in Q.static_sites(model).items()}
    assert set(want) == set(got)
    amax_err = max(abs(got[k] - v) / v for k, v in want.items())
    moved = sum(want[k] != init[k] for k in want)
    print(f"{len(got)} amaxes, max relative distance {amax_err:.3g}; "
          f"{moved} raised by the calibration")
    assert amax_err <= AMAX_TOL and moved > 0

    fresh = build_model(Q.enable_int8(get_config(port_name)["model"],
                                      mode="static"), device="cpu")
    fresh.load_state_dict(model.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(
        Q.static_sites(fresh).values(), Q.static_sites(model).values()))

    # serving: JAX's amaxes on both sides, each site fed JAX's input
    model.load_state_dict(load_jax_params(_quant_flat(variables["quant"])),
                          strict=False)
    records = []
    with monkeypatch.context() as m:
        _record_jax_static(m, records)
        with jax.default_matmul_precision(HIGHEST):
            want_logits = np.asarray(jax.jit(
                lambda v, b: jm.apply(v, b, deterministic=True)[0])(
                    variables, jax_batch(arrs)))
    batch = arrays_to_batch(arrs)

    def serve():
        forced = _ForcedStatic(records)
        with monkeypatch.context() as m:
            m.setattr(Q, "static_quant_matmul", forced)
            with torch.no_grad():
                return model(batch)[0].numpy(), forced

    got_logits, forced = serve()
    for part in late:
        _set_int8(getattr(model, part), False)
    ctl, _ = serve()
    for part in late:
        _set_int8(getattr(model, part), "static")
    err, ctl_err = _rel(got_logits, want_logits), _rel(ctl, want_logits)
    agree = float((got_logits.argmax(-1) == want_logits.argmax(-1)).mean())
    print(f"static int8 logits vs JAX: rel err {err:.3g}, argmax agreement "
          f"{agree:.6f}; int8 off in {late}: {ctl_err:.3g}")
    forced.check(sites)
    assert err <= FORCED_TOL and agree >= 0.999
    assert ctl_err > 100 * FORCED_TOL


def test_enable_int8_flags_and_rejects():
    for name, jcfg in (("tiny_occ", tiny_occ()),
                       ("tiny_point_occ", tiny_point(occ=True))):
        cfg = Q.enable_int8(get_config(name)["model"])
        JQ.enable_int8(jcfg)
        flags = {k: v.get("int8") for k, v in cfg.items()
                 if isinstance(v, dict)}
        assert flags == {k: v.get("int8") for k, v in jcfg.items()
                         if isinstance(v, dict) and k in flags}
        assert sum(bool(v) for v in flags.values()) == 3
    sub = Q.enable_int8(get_config("tiny_occ")["model"],
                        parts=(" neck ", "decoder"))
    assert sub["neck"]["int8"] and sub["decoder"]["int8"]
    assert "int8" not in sub["encoder"]
    with pytest.raises(ValueError, match="unknown int8 parts"):
        Q.enable_int8(get_config("tiny_occ")["model"], parts=("nek",))
    for name, jcfg in (("tiny_occ", tiny_occ()),
                       ("tiny_point_occ", tiny_point(occ=True))):
        cfg = Q.enable_int8(get_config(name)["model"], mode="static")
        JQ.enable_int8(jcfg, mode="static")
        flags = {k: v.get("int8") for k, v in cfg.items()
                 if isinstance(v, dict) and "int8" in v}
        assert flags == {k: v.get("int8") for k, v in jcfg.items()
                         if isinstance(v, dict) and "int8" in v}
        assert set(flags.values()) == {"static"} and len(flags) == 3
    sub = Q.enable_int8(get_config("tiny_occ")["model"], parts=("neck",),
                        mode="static")
    assert sub["neck"]["int8"] == "static" and "int8" not in sub["decoder"]
    with pytest.raises(ValueError, match="dynamic|static"):
        Q.enable_int8(get_config("tiny_occ")["model"], mode="fp8")


def test_int8_server_answers_with_int8_argmax():
    model, _ = make_model("tiny_occ", device="cpu", seed=0, int8=True)
    assert model.decoder.int8 and model.neck.transformer_block[0].int8
    server, worker = make_server("tiny_occ", port=0, batch_size=1,
                                 coalesce_ms=1.0, device="cpu", int8=True)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        a = synthetic_arrays(1, point_budget=512, seed=5)
        req = {k: a[k] for k in BATCH_KEYS}
        buf = io.BytesIO()
        np.savez(buf, **req)
        r = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict",
            data=buf.getvalue(), method="POST"), timeout=120)
        with np.load(io.BytesIO(r.read())) as z:
            pred = z["pred"]
    finally:
        server.shutdown()
        server.server_close()
        worker.stop()
    with torch.no_grad():
        logits = model(arrays_to_batch(req))[0]
    assert pred.shape == (1, 99, 99, 16) and pred.dtype == np.int8
    np.testing.assert_array_equal(pred, logits.argmax(-1).to(torch.int8))

"""The port's kernels as ``torch.library`` operators (``emp::``), on the CPU.

- ``torch.library.opcheck`` on every ``emp::`` op at small shapes: its
  schema (no input mutated or aliased), its fake implementation (shape,
  dtype and strides of the real output) and its autograd registration;
- each differentiable op's gradients against autograd of its plain
  twin on the same float32 inputs, at the 1e-5 of
  ``tests/test_torch_port_train_kernels.py`` (B9's ReLU ties aside, where
  the op takes ``nn.relu``'s slope: no ties here);
- a small module that calls the ops directly exports with
  ``torch.export``, holds ``emp::`` nodes in its graph and, saved and
  loaded, equals eager bit for bit.

On CPU tensors an op's implementation is the twin; the kernels run on
the card (``tests/test_torch_port_cuda.py`` runs the same checks there).
"""

import pytest
import torch

from efficient_multimodal_perception_tpu_torch.ops import kernels as K
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

TOL = 1e-5
OPCHECK = ("test_schema", "test_autograd_registration", "test_faketensor")


def _mlp(g, C, gamma=True):
    """LN, fc1, fc2 and gamma parameters of width C (``nn.Linear``
    layout)."""
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return [1 + 0.1 * r(C), 0.1 * r(C), r(4 * C, C) / C**0.5, 0.1 * r(4 * C),
            r(C, 4 * C) / (2 * C**0.5), 0.1 * r(C),
            (torch.rand(C, generator=g) * 0.9 + 0.1) if gamma else None]


def op_cases():
    """``{op name: (inputs, twin or None)}``: inputs at small shapes and,
    for the differentiable ops, the plain function autograd is held to."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    C = 96
    x = r(1, 4, 4, C)
    dw = [r(C, 1, 7, 7) / 7, 0.1 * r(C)]
    q, k, v = r(2, 64, 24), r(2, 128, 24), r(2, 128, 24)
    out, lse = K.attention_plain(q, k, v, 24**-0.5)
    tri = r(2, 3, 8, 8, 16)
    coords = torch.rand(2, 50, 3, generator=g) * 2.4 - 1.2
    pools = r(64, 24)
    pools[::3] = float("-inf")
    pools[1, 5] = float("-inf")
    fm = [r(128, 24) / 5, 0.1 * r(128), r(128, 128) / 12, 0.1 * r(128)]
    feats = r(2, 3, 40, 16)
    idx = torch.randint(-2, 42, (2, 3, 30), generator=g, dtype=torch.int32)
    valid = (torch.rand(2, 3, 30, generator=g) < 0.7).to(torch.uint8)
    return {
        "convnext_block_fused": ([x] + dw + _mlp(g, C),
                                 K.convnext_block_plain),
        "convnext_block_fused_no_gamma": (
            [r(1, 4, 4, 16), r(16, 1, 7, 7) / 7, 0.1 * r(16)]
            + _mlp(g, 16, gamma=False), K.convnext_block_plain),
        "epilogue_fused": ([r(2, 4, 4, C)] + _mlp(g, C), K.epilogue_plain),
        "post_epilogue_bwd": ([r(32, C), r(32, C)] + _mlp(g, C), None),
        "post_epilogue_bwd_wide": ([r(16, 768), r(16, 768)] + _mlp(g, 768),
                                   None),
        "attention": ([q, k, v, 24**-0.5],
                      lambda *a: K.attention_plain(*a)[0]),
        "attention_bwd": ([q, k, v, out, lse, r(2, 64, 24), 24**-0.5], None),
        "ln_dense_fused": ([r(64, 32), 1 + 0.1 * r(32), 0.1 * r(32),
                            r(48, 32) / 6, 0.1 * r(48), 1e-6],
                           K.ln_dense_xla),
        "ln_dense_fused_no_bias": ([r(64, 32), 1 + 0.1 * r(32), 0.1 * r(32),
                                    r(48, 32) / 6, None, 1e-6],
                                   K.ln_dense_xla),
        "gelu_dense_fused": ([r(64, 32), r(48, 32) / 6, 0.1 * r(48)],
                             K.gelu_dense_xla),
        "triplane_sample": ([tri, coords], K.triplane_sample_plain),
        "triplane_sample_bwd": ([coords, r(2, 50, 16), 8], None),
        "finite_mlp_fused": ([pools] + fm, K.finite_mlp_plain),
        "convnext_block_int8_fused": ([r(1, 4, 4, 16), r(16, 1, 7, 7) / 7,
                                      0.1 * r(16)] + _mlp(g, 16), None),
        "cam_gather_sum": ([feats, idx, valid], K.cam_gather_sum_plain),
        "cam_gather_sum_bwd": ([r(2, 30, 16), idx, valid, 40,
                                torch.float32], None),
    }


CASES = op_cases()
DIFFERENTIABLE = [n for n, (_, twin) in CASES.items() if twin is not None]
# inputs an op gives no gradient, as the JAX package's VJP gives none:
# B7's coordinates (pallas_kernels.py:204)
NO_GRAD = {"triplane_sample": {1}}


def _op(case: str):
    name = case.replace("_no_gamma", "").replace("_no_bias", "")
    return getattr(torch.ops.emp, name).default


def test_every_kernel_on_a_model_path_is_an_op():
    """One ``emp::`` op per launch counter except the int8 probe's, which
    is on no model path."""
    ops = {n for n in dir(torch.ops.emp) if n in K.LAUNCHES}
    assert ops == set(K.LAUNCHES) - {"int8_dot"}
    assert {_op(c).__name__.split(".")[0] for c in CASES} == ops


@pytest.mark.parametrize("case", list(CASES))
def test_opcheck(case):
    args, _ = CASES[case]
    args = [a.clone().requires_grad_(a.is_floating_point())
            if isinstance(a, torch.Tensor) else a for a in args]
    torch.library.opcheck(_op(case), tuple(args), test_utils=OPCHECK)


@pytest.mark.parametrize("case", DIFFERENTIABLE)
def test_op_grads_match_autograd_of_the_twin(case):
    args, twin = CASES[case]
    g = torch.Generator().manual_seed(1)

    def leaves():
        return [a.clone().requires_grad_(True)
                if isinstance(a, torch.Tensor) and a.is_floating_point()
                else a for a in args]

    got_in, want_in = leaves(), leaves()
    got = _op(case)(*got_in)
    got = got[0] if isinstance(got, tuple) else got
    want = twin(*want_in)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    dout = torch.randn(want.shape, generator=g)
    wrt = [i for i, a in enumerate(got_in)
           if isinstance(a, torch.Tensor) and a.requires_grad
           and i not in NO_GRAD.get(case, ())]
    ga = torch.autograd.grad(got, [got_in[i] for i in wrt], dout,
                             allow_unused=True)
    gb = torch.autograd.grad(want, [want_in[i] for i in wrt], dout,
                             allow_unused=True)
    for i, a, b in zip(wrt, ga, gb):
        if b is None:
            assert a is None or not a.any(), i
        else:
            torch.testing.assert_close(a, b, atol=TOL, rtol=TOL,
                                       msg=f"input {i}")


class _Direct(torch.nn.Module):
    """Calls the ops directly: K1, then K3 and K2 on its tokens."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(2)
        C = 16
        self.block = torch.nn.ParameterList(
            [torch.randn(C, 1, 7, 7, generator=g) / 7,
             torch.randn(C, generator=g) * 0.1]
            + [torch.nn.Parameter(t) for t in _mlp(g, C)])
        self.ln = torch.nn.ParameterList(
            [torch.ones(C), torch.zeros(C),
             torch.randn(3 * C, C, generator=g) / 4])

    def forward(self, x):
        y = K.convnext_block(x, *self.block)
        B, H, W, C = y.shape
        qkv = K.ln_dense(y.reshape(-1, C), *self.ln, None)
        qkv = qkv.reshape(B, -1, 3 * C)
        q, k, v = (t.contiguous() for t in qkv.split(C, -1))
        return K.attention_op(q, k, v, C**-0.5)


def test_direct_ops_export_save_and_load(tmp_path):
    from efficient_multimodal_perception_tpu_torch.tools.export import (
        load_artifact)

    mod = _Direct()
    x = torch.randn(2, 8, 8, 16, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ep = torch.export.export(mod, (x,), strict=False)
        want = mod(x)
    ops = [str(n.target) for n in ep.graph.nodes
           if str(n.target).startswith("emp.")]
    assert ops == ["emp.convnext_block_fused.default",
                   "emp.ln_dense_fused.default", "emp.attention.default"]
    path = str(tmp_path / "direct.pt2")
    torch.export.save(ep, path)
    with torch.no_grad():
        got = load_artifact(path).module()(x)
    assert torch.equal(got, want)


# the wrappers that launch a kernel directly (each op's implementation,
# and the probe's): no model module names them
RAW_LAUNCHES = {"convnext_block_fused", "epilogue_fused", "attention",
                "attention_bwd", "ln_dense_fused", "gelu_dense_fused",
                "triplane_sample", "triplane_sample_bwd",
                "finite_mlp_launch", "convnext_block_int8_fused",
                "cam_gather_sum", "cam_gather_sum_bwd", "int8_dot",
                "_post_epilogue_bwd_kernel"}


def test_model_paths_reach_kernels_only_through_ops():
    """The models (and ``ops/sampling.py``, ``ops/quant.py``) name no raw
    launching wrapper of ``ops/kernels.py``, whether imported from it or
    read off the module, and ``ops/kernels.py`` holds no
    ``torch.autograd.Function``."""
    import ast
    from pathlib import Path

    pkg = Path(K.__file__).resolve().parent.parent
    files = sorted((pkg / "models").glob("*.py")) + [
        pkg / "ops" / "sampling.py", pkg / "ops" / "quant.py"]
    bad = []
    for f in files:
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.ImportFrom)
                    and (node.module or "").endswith("kernels")):
                bad += [(f.name, a.name) for a in node.names
                        if a.name in RAW_LAUNCHES]
            elif (isinstance(node, ast.Attribute)
                  and isinstance(node.value, ast.Name)
                  and node.value.id == "K" and node.attr in RAW_LAUNCHES):
                bad.append((f.name, node.attr))
    assert not bad, bad
    assert "autograd.Function" not in Path(K.__file__).read_text()

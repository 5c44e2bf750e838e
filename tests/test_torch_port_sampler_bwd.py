"""B7's backward (``triplane_sample_pallas``'s VJP) in the port, on the CPU.

The CUDA backward gathers each texel's terms in a fixed order and writes
its bf16 value once; ``ops.kernels.triplane_sample_bwd_reference`` is
that order in float32 numpy, and the card tests
(``tests/test_torch_port_cuda.py``) and ``chip_smoke.py`` hold the kernel
to it bit for bit.  Here the reference itself is held:

- on an ordinary case (no order-sensitive values) within 1e-5 of
  ``jax.vjp`` of the Pallas kernel in interpret mode and of the plain
  twin;
- its order pinned where a sum depends on it: 1, 1e8 and -1e8 on one
  texel of a light cell (0 in list order, 1 in reverse), and heavy cells
  whose chunks (counted from the cell's list's start) keep a 1 that one
  running sum would lose;
- on a cell of thousands of points, and on many heavy cells of tens to
  hundreds of points next to each other, within 1e-5 of the twin;
- points with no corner on a plane (far away or NaN) add nothing;
- the constants of that order are the ones the kernel is compiled with.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from efficient_multimodal_perception_tpu.ops.pallas_kernels import (
    triplane_sample_pallas,
)
from efficient_multimodal_perception_tpu_torch.ops import kernels as K
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

TOL = 1e-5


def _at_texel(S, y, x):
    """Normalized coordinate of texel (y, x)'s centre on every plane."""
    return (2 * x + 1) / S - 1, (2 * y + 1) / S - 1


def test_reference_matches_pallas_and_twin():
    rng = np.random.default_rng(21)
    B, S, C, P = 2, 16, 32, 300
    coords = rng.uniform(-1.0, 1.0, (B, P, 3)).astype(np.float32)
    coords[:, ::5] *= 1.4
    coords[:, 1::7] = coords[:, 2::7][:, : coords[:, 1::7].shape[1]]
    g = rng.standard_normal((B, P, C)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(
            lambda t: triplane_sample_pallas(t, jnp.asarray(coords),
                                             interpret=True),
            jnp.zeros((B, 3, S, S, C), jnp.float32))
        (want,) = vjp(jnp.asarray(g))
    ref = K.triplane_sample_bwd_reference(coords, g, S)
    assert ref.shape == (B, 3, S, S, C) and ref.dtype == np.float32
    np.testing.assert_allclose(ref, np.asarray(want), atol=TOL, rtol=TOL)
    twin = K.triplane_sample_bwd_plain(torch.from_numpy(coords),
                                       torch.from_numpy(g), S)
    np.testing.assert_allclose(ref, twin.numpy(), atol=TOL, rtol=TOL)


def _one_cell(P, S, C, values):
    """P points at (x, y, z) = the centres of texel column 5, row 3, row 3
    (all weight on one texel of each plane: (3, 5) of plane xy), g zero
    but ``values`` {p: v} in channel 0."""
    u, v = _at_texel(S, 3, 5)
    coords = np.tile(np.float32([u, v, v]), (1, P, 1))
    g = np.zeros((1, P, C), np.float32)
    for p, val in values.items():
        g[0, p, 0] = val
    return coords, g


def test_reference_sums_a_light_cell_in_list_order():
    S, C = 8, 8
    coords, g = _one_cell(3, S, C, {0: 1.0, 1: 1e8, 2: -1e8})
    ref = K.triplane_sample_bwd_reference(coords, g, S)
    assert ref[0, 0, 3, 5, 0] == 0.0  # (1 + 1e8) - 1e8, in ascending p
    rev = K.triplane_sample_bwd_reference(coords, g[:, ::-1].copy(), S)
    assert rev[0, 0, 3, 5, 0] == 1.0  # (-1e8 + 1e8) + 1
    assert np.count_nonzero(ref) == 0 and np.count_nonzero(rev) == 3


def test_reference_sums_a_heavy_cell_in_chunks():
    """3000 points in one cell: 1 in the first chunk of TRI_BWD_CHUNK
    entries, 1e8 and -1e8 in the second.  Summed by chunks the 1 stays;
    a single running sum in list order loses it."""
    S, C = 8, 8
    win = K.TRI_BWD_CHUNK
    coords, g = _one_cell(3000, S, C, {5: 1.0, win + 3: 1e8, win + 9: -1e8})
    ref = K.triplane_sample_bwd_reference(coords, g, S)
    assert ref[0, 0, 3, 5, 0] == 1.0
    running = np.float32(0)
    for v in g[0, :, 0]:
        running = np.float32(running + v)
    assert running == 0.0


def test_reference_chunks_start_at_each_cells_list():
    """A heavy cell whose list starts 100 entries into its plane's (after
    a cell of 100 points): its chunks count from its own first entry, so
    its entries 1023 (a 1) and 1024, 1025 (1e8, -1e8) fall in two chunks
    and the 1 stays.  Chunks cut at multiples of TRI_BWD_CHUNK of the
    plane's entries would put all three in one and lose it."""
    S, C, n = 8, 8, 1500
    ua, va = _at_texel(S, 3, 4)
    ub, vb = _at_texel(S, 3, 5)
    coords = np.concatenate([np.tile(np.float32([ua, va, va]), (1, 100, 1)),
                             np.tile(np.float32([ub, vb, vb]), (1, n, 1))],
                            1)
    g = np.zeros((1, 100 + n, C), np.float32)
    g[0, 100 + K.TRI_BWD_CHUNK - 1, 0] = 1.0
    g[0, 100 + K.TRI_BWD_CHUNK, 0] = 1e8
    g[0, 100 + K.TRI_BWD_CHUNK + 1, 0] = -1e8
    ref = K.triplane_sample_bwd_reference(coords, g, S)
    assert ref[0, 0, 3, 5, 0] == 1.0 and ref[0, 0, 3, 4, 0] == 0.0


def _heavy_row_coords(rng, B, P, S):
    """Ground-like points: x and y uniform, z in one texel row, so the yz
    and xz planes hold a row of heavy cells side by side (tens to hundreds
    of points each) and the xy plane light ones."""
    c = rng.uniform(-1.0, 1.0, (B, P, 3)).astype(np.float32)
    c[..., 2] = (2 * (S // 3) + 1 + rng.uniform(-0.9, 0.9, (B, P))) / S - 1
    return c


@pytest.mark.parametrize("case", ["uniform S=8", "ground"])
def test_reference_on_many_heavy_cells_matches_twin(case):
    """Many heavy cells, most of them neither first nor last among a
    chunk's worth of their plane's entries: each cell's chunks are its
    own, and every one is summed."""
    rng = np.random.default_rng(25)
    if case == "ground":
        B, S, C, P = 2, 32, 16, 4000
        coords = _heavy_row_coords(rng, B, P, S)
    else:
        B, S, C, P = 1, 8, 16, 6000
        coords = rng.uniform(-1.0, 1.0, (B, P, 3)).astype(np.float32)
    cells, _ = K.triplane_footprints(coords, S)
    sizes = np.bincount(cells[0, 1][cells[0, 1] >= 0])
    heavy = sizes[sizes > K.TRI_BWD_LIGHT]
    assert heavy.size >= 20 and heavy.max() < K.TRI_BWD_CHUNK
    g = rng.standard_normal((B, P, C)).astype(np.float32)
    ref = K.triplane_sample_bwd_reference(coords, g, S)
    twin = K.triplane_sample_bwd_plain(torch.from_numpy(coords),
                                       torch.from_numpy(g), S).numpy()
    scale = np.abs(twin).max()
    np.testing.assert_allclose(ref, twin, atol=TOL * scale, rtol=TOL)


def test_reference_on_a_cell_of_thousands_matches_twin():
    rng = np.random.default_rng(22)
    B, S, C, P = 1, 32, 16, 5000
    coords = rng.uniform(-1.0, 1.0, (B, P, 3)).astype(np.float32)
    busy = rng.random(P) < 0.6  # about 3000 points in one cell a plane
    coords[:, busy] = (-0.0234375, -0.0234375, -0.21875)
    g = rng.standard_normal((B, P, C)).astype(np.float32)
    ref = K.triplane_sample_bwd_reference(coords, g, S)
    twin = K.triplane_sample_bwd_plain(torch.from_numpy(coords),
                                       torch.from_numpy(g), S).numpy()
    scale = np.abs(twin).max()
    assert scale > 100  # the busy cell's texels sum thousands of terms
    np.testing.assert_allclose(ref, twin, atol=TOL * scale, rtol=TOL)


def test_reference_drops_points_off_the_planes():
    rng = np.random.default_rng(23)
    B, S, C, P = 1, 8, 8, 64
    coords = rng.uniform(-1.0, 1.0, (B, P, 3)).astype(np.float32)
    g = rng.standard_normal((B, P, C)).astype(np.float32)
    kept = K.triplane_sample_bwd_reference(coords, g, S)
    far = np.concatenate([coords, np.full((B, 5, 3), 7.0, np.float32),
                          np.full((B, 5, 3), np.nan, np.float32)], 1)
    gfar = np.concatenate([g, rng.standard_normal((B, 10, C)).astype(
        np.float32)], 1)
    got = K.triplane_sample_bwd_reference(far, gfar, S)
    assert np.array_equal(got, kept)


def test_sampler_backward_returns_the_planes_dtype_on_cpu():
    """On CPU tensors the autograd function's backward is the twin in g's
    dtype (the triplane's, as JAX returns it), and launches nothing."""
    rng = np.random.default_rng(24)
    tri = torch.from_numpy(rng.standard_normal((1, 3, 8, 8, 16)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_()
    coords = torch.from_numpy(rng.uniform(-1, 1, (1, 40, 3)).astype(
        np.float32))
    K.reset_launches()
    out = K.triplane_sample_op(tri, coords)
    g = torch.from_numpy(rng.standard_normal((1, 40, 16)).astype(
        np.float32)).to(torch.bfloat16)
    (grad,) = torch.autograd.grad(out, tri, g)
    assert grad.dtype == torch.bfloat16
    assert torch.equal(grad, K.triplane_sample_bwd_plain(coords, g, 8).to(
        torch.bfloat16))
    assert all(n == 0 for n in K.LAUNCHES.values())


def test_sum_order_constants_are_the_kernels():
    """The host reference's order constants are the -D flags the build
    compiles ``csrc/triplane_sample.cu`` with, and the source defines
    them from those flags only (it refuses to build without them)."""
    from efficient_multimodal_perception_tpu_torch.ops import _build

    src = _build.CSRC / "triplane_sample.cu"
    flags = _build._defines(src)
    assert flags == [f"-DEMP_TB_LIGHT={K.TRI_BWD_LIGHT}",
                     f"-DEMP_TB_LANES={K.TRI_BWD_LANES}",
                     f"-DEMP_TB_CHUNK={K.TRI_BWD_CHUNK}"]
    text = src.read_text()
    for name, macro in (("TB_LIGHT", "EMP_TB_LIGHT"),
                        ("TB_LANES", "EMP_TB_LANES"),
                        ("TB_CHUNK", "EMP_TB_CHUNK")):
        defs = [ln for ln in text.splitlines()
                if ln.startswith(f"constexpr int {name} =")]
        assert defs and all(f"= {macro};" in ln for ln in defs), defs
        assert f"!defined({macro})" in text

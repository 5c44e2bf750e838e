"""B10's host-side plans and the int8 weight codes it caches, on the CPU.

``ops.kernels.plan_b10_chunks`` cuts B10's rows into chunks whose int8
scratch (zq and hq, 5 C bytes a row) stays under a budget, reused chunk
after chunk, as K1's scratch does.  The chunk plan is checked at the 16
ConvNeXt shapes of the two int8 serve paths at batch 4.  ``ops.quant.cached_quantize_weight`` computes a weight's
codes once per state of the weight; they must equal
``quantize_weight``'s bit for bit and follow every in-place update.
"""

import gc

import numpy as np
import pytest
import torch

from efficient_multimodal_perception_tpu_torch.ops import kernels as K
from efficient_multimodal_perception_tpu_torch.ops import quant as Q
from test_torch_port_kernels import torch_cpu_threads  # noqa: F401

# (images, H, W, C) of every ConvNeXt stage B10 runs on the int8 serve
# paths at batch 4: the camera encoder (6 images a sample), the lidar
# encoder, and the point family's xy and yz / xz triplane encoders
B10_SERVE_SHAPES = (
    [(24, 128 >> i, 256 >> i, 96 << i) for i in range(4)]
    + [(4, 32, 256 >> i, 96 << i) for i in range(4)]
    + [(4, 128 >> i, 128 >> i, 96 << i) for i in range(4)]
    + [(4, 128 >> i, 80 >> i, 96 << i) for i in range(4)]
)


@pytest.mark.parametrize("n,h,w,C", B10_SERVE_SHAPES)
def test_b10_chunk_plan_at_the_serve_shapes(n, h, w, C):
    """The chunks cover the rows exactly, in order; each chunk's zq and hq
    (and so hq alone) fit the scratch budget, which is no more than K1's;
    every chunk but the last is a whole number of 128-row tiles; one
    chunk fewer could not keep to the budget."""
    M = n * h * w
    chunks = K.plan_b10_chunks(M, C)
    assert K.B10_CHUNK_BYTES <= K.K1_CHUNK_BYTES
    assert chunks[0][0] == 0
    assert all(a + r == b for (a, r), (b, _) in zip(chunks, chunks[1:]))
    assert chunks[-1][0] + chunks[-1][1] == M
    rows = chunks[0][1]
    assert all(r == rows for _, r in chunks[:-1]) and 0 < chunks[-1][1] <= rows
    assert rows % K.GEMM_BM == 0 or len(chunks) == 1
    assert rows * 4 * C <= rows * 5 * C <= K.B10_CHUNK_BYTES
    if len(chunks) > 1:
        assert -(-M // (len(chunks) - 1)) * 5 * C > K.B10_CHUNK_BYTES


def test_b10_chunk_plan_at_camera_stage0():
    """Camera stage 0 at batch 4 (786432 rows of C = 96): three chunks of
    262144 rows, 100.7 MB of hq each; camera stage 1 (196608 rows of
    C = 192) in two."""
    assert K.plan_b10_chunks(786432, 96) == [(r, 262144)
                                             for r in range(0, 786432, 262144)]
    assert K.plan_b10_chunks(196608, 192) == [(0, 98304), (98304, 98304)]


def _codes_equal(got, w):
    want = Q.quantize_weight(w)
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _entries(*ts):
    return sum(1 for t in ts if id(t) in Q._WEIGHT_CODES)


def test_weight_codes_cache():
    """Codes and scales equal ``quantize_weight``'s bit for bit; a second
    call returns the cached pair; an in-place ``mul_``, a ``copy_`` and a
    ``load_state_dict`` each give new codes equal to ``quantize_weight``'s
    of the updated weight; each weight holds one entry however often it
    changes, and the entry goes with the weight."""
    rng = np.random.default_rng(11)
    mods = [torch.nn.Linear(24, 96), torch.nn.Linear(96, 24)]
    with torch.no_grad():
        for m in mods:
            m.weight.copy_(torch.from_numpy(
                rng.standard_normal(tuple(m.weight.shape)).astype(np.float32)))
    w1, w2 = mods[0].weight, mods[1].weight
    first = Q.cached_quantize_weight(w1)
    assert _codes_equal(first, w1)
    assert Q.cached_quantize_weight(w1) is first
    assert _codes_equal(Q.cached_quantize_weight(w2), w2)
    assert _entries(w1, w2) == 2

    with torch.no_grad():
        w1.mul_(-3.0)
    after_mul = Q.cached_quantize_weight(w1)
    assert after_mul is not first and _codes_equal(after_mul, w1)
    assert not torch.equal(after_mul[1], first[1])

    with torch.no_grad():
        w1.copy_(torch.from_numpy(
            rng.standard_normal((96, 24)).astype(np.float32)))
    after_copy = Q.cached_quantize_weight(w1)
    assert after_copy is not after_mul and _codes_equal(after_copy, w1)

    state = {k: v * 0.5 for k, v in mods[0].state_dict().items()}
    mods[0].load_state_dict(state)
    after_load = Q.cached_quantize_weight(w1)
    assert after_load is not after_copy and _codes_equal(after_load, w1)
    assert Q.cached_quantize_weight(w1) is after_load
    assert _entries(w1, w2) == 2

    key = id(w1)
    del mods, w1, w2, first, after_mul, after_copy, after_load
    gc.collect()
    assert key not in Q._WEIGHT_CODES

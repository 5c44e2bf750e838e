"""The attention kernels' tile plan (``ops.kernels.attention_plan``),
which mirrors ``csrc/attention.cu``'s ``FwdPlan`` / ``DqPlan`` /
``DkvPlan``: each head dim routed to its padded instantiation, and each
instantiation's shared memory within a block's limit.  No compiler or
card needed; the card test ``test_attention_plan_matches_library_on_card``
holds the mirror to the library."""

import pytest

from efficient_multimodal_perception_tpu_torch.ops import kernels as K

HEAD_DIMS = range(8, 257, 8)
SMEM_LIMIT = 232448  # bytes of shared memory a block may use on sm_90


def test_attention_plan_routes_each_head_dim():
    """Forward and backward pad hd to the least of 64 / 128 / 256 that
    holds it (whole 64-column swizzle boxes)."""
    for hd in HEAD_DIMS:
        p = K.attention_plan(hd)
        want = min(h for h in (64, 128, 256) if h >= hd)
        assert p["fwd_hdp"] == p["bwd_hdp"] == want, hd
    assert K.attention_plan(24)["bwd_hdp"] == 64   # the MAE decoders
    assert K.attention_plan(256)["bwd_hdp"] == 256  # the neck


@pytest.mark.parametrize("hd", [64, 128, 256])
def test_attention_plan_fits_shared_memory(hd):
    """Every kernel of each instantiation fits one block's 227 KB of
    shared memory, and its key tile divides the multiples of 64 that
    ``_check_attention`` admits (the forward's 128-key tiles mask a
    ragged last tile instead)."""
    p = K.attention_plan(hd)
    for key in ("fwd_smem", "dq_smem", "dkv_smem"):
        assert 0 < p[key] <= SMEM_LIMIT, (key, p[key])
    assert 64 % p["dq_bn"] == 0
    assert p["fwd_bn"] in (64, 128)
    # the forward's resident Q and ring: 128 rows and two or three
    # stages of K and V
    f = p["fwd_hdp"]
    assert p["fwd_smem"] >= 128 * f * 2 + p["fwd_stages"] * 2 * p[
        "fwd_bn"] * f * 2


@pytest.mark.parametrize("hd", [0, 12, 264])
def test_attention_plan_refuses_what_the_kernels_refuse(hd):
    with pytest.raises(ValueError):
        K.attention_plan(hd)

"""Rack-limited routing (DeepSeek-V3's node-limited routing) of the port
against the JAX package, on the CPU.

* ``gate`` with ``rack_limit`` M of ``num_racks`` G against
  ``repro.moe.gating.gate``: ids and counts equal, weights within 1e-6
  relative, over both score functions, with and without the selection
  bias, on rows with ties (all-zero tokens, duplicated router columns);
  M == G is free routing, bit for bit; every token's experts lie in at
  most M racks.
* The selection bias gets no gradient; x and the router do.
* ``rack_copy_volumes`` and the two-level ``update_router_bias`` against
  JAX, and ``effective_rack_limit``'s degradation.
* The gate kernel's rack mode, mirrored on the CPU (:func:`_lane_mirror`:
  the 16-byte chunks on their lanes, each lane's sorted top 4, the xor
  merges over a rack's W lanes, the racks' packed words counted by every
  lane), equals the plain selection on the same keys, ties included.  The
  kernel itself is held against the plain version on the card
  (``test_torch_gating_topk.py``, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.gating_topk import ops
from repro_torch.moe import gating as tg

# (E, k, G, M, gk): DeepSeek-V3's routing (256 experts, top-8, 8 groups,
# 4 kept, group score of 2), a two-rack limit of one, and small shapes.
CASES = [(256, 8, 8, 4, 2), (256, 8, 2, 1, 2), (64, 4, 4, 2, 2),
         (32, 8, 8, 3, 3), (16, 2, 2, 1, 2), (128, 6, 4, 2, 4)]


def _inputs(T, E, seed, ties=True):
    rng = np.random.default_rng(seed)
    D = 24
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    if ties:
        x[::7] = 0.0                   # every expert ties
        w[:, 9] = w[:, 2]              # duplicated router columns
        w[:, 5] = w[:, 11]
    bias = (rng.standard_normal(E) * 1e-2).astype(np.float32)
    return x, w, bias


@pytest.mark.parametrize("bias", [False, True], ids=["free", "bias"])
@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
@pytest.mark.parametrize("E,k,G,M,gk", CASES)
def test_rack_limited_gate_matches_jax(E, k, G, M, gk, score_fn, bias):
    import jax.numpy as jnp

    from repro.moe import gating as jg

    x, w, b = _inputs(96, E, seed=E + G + M)
    kw = dict(num_experts=E, top_k=k, score_fn=score_fn, use_bias=bias,
              rack_limit=M, num_racks=G, rack_group_topk=gk)
    jo = jg.gate(jnp.asarray(x), jnp.asarray(w), jg.GatingConfig(**kw),
                 bias=jnp.asarray(b) if bias else None)
    to = tg.gate(torch.from_numpy(x), torch.from_numpy(w),
                 tg.GatingConfig(**kw),
                 bias=torch.from_numpy(b) if bias else None)
    np.testing.assert_array_equal(to.expert_ids.numpy(),
                                  np.asarray(jo.expert_ids))
    np.testing.assert_array_equal(to.counts.numpy(), np.asarray(jo.counts))
    np.testing.assert_allclose(to.weights.numpy(), np.asarray(jo.weights),
                               rtol=1e-6, atol=1e-7)
    racks = to.expert_ids // (E // G)
    assert max(torch.unique(r).numel() for r in racks) <= M


@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
def test_limit_of_all_racks_is_free_routing_bitwise(score_fn):
    x, w, b = _inputs(128, 64, seed=4)
    free = tg.GatingConfig(num_experts=64, top_k=6, score_fn=score_fn,
                           use_bias=True)
    full = tg.GatingConfig(num_experts=64, top_k=6, score_fn=score_fn,
                           use_bias=True, rack_limit=4, num_racks=4)
    assert full.rack_limited and not full.rack_binding
    a = tg.gate(torch.from_numpy(x), torch.from_numpy(w), free,
                bias=torch.from_numpy(b))
    c = tg.gate(torch.from_numpy(x), torch.from_numpy(w), full,
                bias=torch.from_numpy(b))
    for f in ("expert_ids", "weights", "counts", "scores"):
        assert torch.equal(getattr(a, f), getattr(c, f)), f


def test_bias_gets_no_gradient_under_rack_limit():
    x, w, b = _inputs(64, 32, seed=5, ties=False)
    cfg = tg.GatingConfig(num_experts=32, top_k=4, score_fn="sigmoid",
                          use_bias=True, rack_limit=2, num_racks=4)
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out = tg.gate(xt, wt, cfg, bias=bt)
    (out.weights.square().sum() + out.scores.sum()).backward()
    assert bt.grad is None
    assert xt.grad is not None and wt.grad.abs().max() > 0


def test_gating_config_validation():
    with pytest.raises(ValueError, match="num_racks"):
        tg.GatingConfig(num_experts=16, top_k=2, num_racks=0)
    with pytest.raises(ValueError, match="rack_limit"):
        tg.GatingConfig(num_experts=16, top_k=2, num_racks=2, rack_limit=3)
    with pytest.raises(ValueError, match="multiple"):
        tg.GatingConfig(num_experts=16, top_k=2, num_racks=3, rack_limit=1)
    with pytest.raises(ValueError, match="expose only"):
        tg.GatingConfig(num_experts=16, top_k=8, num_racks=4, rack_limit=1)
    with pytest.raises(ValueError, match="rack_group_topk"):
        tg.GatingConfig(num_experts=16, top_k=2, rack_group_topk=0)


@pytest.mark.parametrize("src", [0, 3, 5])
def test_rack_copy_volumes_match_jax(src):
    import jax.numpy as jnp

    from repro.moe import gating as jg

    rng = np.random.default_rng(src)
    E, R, L = 32, 8, 4
    ids = np.stack([rng.choice(E, 6, replace=False) for _ in range(200)])
    home = np.repeat(np.arange(R), E // R)
    j = jg.rack_copy_volumes(jnp.asarray(ids, jnp.int32), jnp.asarray(home),
                             num_ranks=R, rack_size=L, src_rank=src)
    t = tg.rack_copy_volumes(torch.from_numpy(ids), torch.from_numpy(home),
                             num_ranks=R, rack_size=L, src_rank=src)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("racks", [1, 2, 8])
def test_two_level_bias_update_matches_jax(racks):
    import jax.numpy as jnp

    from repro.moe import gating as jg

    rng = np.random.default_rng(racks)
    counts = rng.integers(0, 400, 64)
    bias = (rng.standard_normal(64) * 1e-2).astype(np.float32)
    j = jg.update_router_bias(jnp.asarray(bias), jnp.asarray(counts), 1e-3,
                              num_racks=racks)
    t = tg.update_router_bias(torch.from_numpy(bias),
                              torch.from_numpy(counts), 1e-3,
                              num_racks=racks)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # One row per layer, as the trainer keeps the biases.
    t2 = tg.update_router_bias(torch.from_numpy(np.stack([bias, bias])),
                               torch.from_numpy(np.stack([counts, counts])),
                               1e-3, num_racks=racks)
    np.testing.assert_array_equal(t2.numpy()[1], np.asarray(j))


def test_effective_rack_limit_matches_jax():
    from repro.models import transformer as jt

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt

    m = get_config("deepseek-v3-671b").moe
    for limit, racks in ((0, 2), (1, 1), (1, 2), (4, 8), (9, 8), (1, 64),
                         (1, 3)):
        got = tt.effective_rack_limit(m, tt.RuntimeConfig(rack_limit=limit),
                                      racks)
        want = jt.effective_rack_limit(m, jt.RuntimeConfig(rack_limit=limit),
                                       racks)
        assert got == want, (limit, racks)


def _lane_mirror(keys: torch.Tensor, k: int, G: int, M: int,
                 gk: int) -> torch.Tensor:
    """The gate kernel's rack-mode selection, step by step on the CPU: the
    row's 16-byte chunks on the group's lanes (chunk c on lane c % lanes,
    column c // lanes), each lane's chunk sorted (top 4), the W lanes of a
    rack merged by xor rounds (max against the partner's list reversed,
    then a 4-wide bitonic cleanup), the first gk summed in order, the
    racks' words (order bits of the score above the complement of the
    rack) counted by each lane, dead racks' keys at -inf, then the free
    kernel's selection (``ops.packed_topk``)."""
    T, E = keys.shape
    lanes, per, _, _ = ops.launch_geometry(T, E, k)
    W = ops.rack_chunks(E, k, G, M, gk)
    assert W > 0
    gk = min(gk, 4 * W)
    chunks = keys.reshape(T, E // 4, 4)
    t = chunks.sort(dim=-1, descending=True).values           # (T, C, 4)
    o = 1
    while o < W:
        c = torch.arange(E // 4)
        u = t[:, c ^ o]                                       # the partner
        t = torch.maximum(t, u.flip(-1))                      # bitonic top 4
        t = t.sort(dim=-1, descending=True).values            # the cleanup
        o *= 2
    score = t[..., 0]
    for q in range(1, gk):
        score = score + t[..., q]
    rack_of_chunk = torch.arange(E // 4) // W
    words = ops.packed_keys(score[:, ::W].contiguous())       # (T, G)
    above = (words[:, None, :] > words[:, :, None]).sum(-1)   # (T, G)
    live = (above < M)[:, rack_of_chunk].repeat_interleave(4, dim=1)
    masked = torch.where(live, keys, torch.full_like(keys, float("-inf")))
    assert lanes * per >= E
    return ops.packed_topk(masked, k)


@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
@pytest.mark.parametrize("E,k,G,M,gk", CASES)
def test_kernel_rack_mode_mirror_equals_plain_selection(E, k, G, M, gk,
                                                        score_fn):
    x, w, b = _inputs(200, E, seed=E * G + M)
    keys = ops.scores_of(torch.from_numpy(x @ w), score_fn) + torch.from_numpy(b)
    keys[::5, : E // 2] = 0.25                                 # tied racks
    want = ops.rack_limited_ids(keys, k, G, M, gk)
    assert torch.equal(_lane_mirror(keys, k, G, M, gk), want)


def test_rack_chunks_geometry():
    assert ops.rack_chunks(256, 8, 8, 4, 2) == 8
    assert ops.rack_chunks(256, 8, 2, 1, 2) == 32
    assert ops.rack_chunks(16, 2, 4, 1, 2) == 1
    assert ops.rack_chunks(256, 8, 8, 8, 2) == 0           # M == G: free
    assert ops.rack_chunks(256, 8, 1, 0, 2) == 0
    assert ops.rack_chunks(96, 4, 2, 1, 2) == -1           # 12 chunks a rack
    assert ops.rack_chunks(32, 2, 16, 1, 2) == -1          # 2 experts a rack
    assert ops.rack_chunks(256, 8, 8, 1, 8) == -1          # group top-8

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
  PER contiguous experts a lane; on the lanes path each lane's sorted top
  gk, the xor merges over a rack's L lanes and the racks' words counted by
  every lane; on the shared path each key's rank in its rack, the slots
  summed in order and the racks ranked), equals the plain selection on the
  same keys, ties included, at every geometry of ``CASES``; every geometry
  the port's ``GatingConfig`` accepts within the kernel's E and k takes one
  of the two paths.  The kernel itself is held against the plain version
  on the card (``test_torch_gating_topk.py``, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.gating_topk import ops
from repro_torch.moe import gating as tg

# (E, k, G, M, gk): DeepSeek-V3's routing (256 experts, top-8, 8 groups,
# 4 kept, group score of 2), a two-rack limit of one, and small shapes;
# then geometries on the kernel's shared path: Jamba-v0.1's 16 experts
# over 8 racks, DBRX's routing (16 experts, top-4) at 8 racks,
# DeepSeek-V2's device-limited routing (160 experts, top-6, 8 devices, 3
# kept, group top-1), E not a multiple of 4, and one expert a rack; and a
# group top-8 on the lanes path.
CASES = [(256, 8, 8, 4, 2), (256, 8, 2, 1, 2), (64, 4, 4, 2, 2),
         (32, 8, 8, 3, 3), (16, 2, 2, 1, 2), (128, 6, 4, 2, 4),
         (16, 2, 8, 2, 2), (16, 4, 8, 2, 2), (160, 6, 8, 3, 1),
         (60, 4, 6, 2, 2), (256, 8, 2, 1, 8), (16, 2, 16, 8, 1)]


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


def _zero(x: torch.Tensor) -> torch.Tensor:
    """-0.0 as +0.0, as the kernel's order bits read a key back."""
    return torch.where(x == 0, torch.zeros_like(x), x)


def _lane_mirror(keys: torch.Tensor, k: int, G: int, M: int,
                 gk: int) -> torch.Tensor:
    """The gate kernel's rack-mode selection, step by step on the CPU: the
    row's experts on the group's lanes, PER contiguous experts a lane
    (-inf past E); the racks scored on the kernel's path, the live racks
    found by counting the rack words above each rack's (the larger score,
    or the same score and the lower rack), a dead rack's keys out of the
    rounds; then the free kernel's selection (``ops.packed_topk``).

    Lanes path: each lane's top gk in order (its sorted words), padded with
    -inf to the power of two >= gk, merged over the rack's L aligned lanes
    by xor rounds (the max against the partner's list reversed, then the
    bitonic cleanup, a descending sort) and summed in order.  Shared path:
    each key's rank in its rack (the packed words above it), the key in
    slot (rack, rank) when the rank is below gk, the slots summed in
    order."""
    T, E = keys.shape
    lanes, per, _, _ = ops.launch_geometry(T, E, k)
    mode, L = ops.rack_mode(E, k, G, M, gk)
    assert mode > 0 and lanes * per >= E
    epg = E // G
    gk = min(gk, epg)
    keys = keys.to(torch.float32)
    if mode == 1:
        padded = torch.full((T, lanes * per), float("-inf"))
        padded[:, :E] = keys
        gkp = 1 << (gk - 1).bit_length()
        t = _zero(padded.view(T, lanes, per).sort(
            dim=-1, descending=True).values[..., :gk])
        t = torch.cat([t, torch.full((T, lanes, gkp - gk), float("-inf"))],
                      dim=-1)                                  # (T, lanes, gkp)
        o = 1
        while o < L:
            u = t[:, torch.arange(lanes) ^ o]                  # the partner
            t = torch.maximum(t, u.flip(-1))                   # bitonic top gkp
            t = t.sort(dim=-1, descending=True).values         # the cleanup
            o *= 2
        lane_score = t[..., 0]
        for q in range(1, gk):
            lane_score = lane_score + t[..., q]
        score = lane_score[:, ::L][:, :G]                      # racks' first lanes
    else:
        words = ops.packed_keys(keys).view(T, G, epg)
        rank = (words[..., None, :] > words[..., :, None]).sum(-1)  # (T, G, epg)
        slots = torch.zeros((T, G, gk))
        for q in range(gk):
            at = rank == q
            assert bool((at.sum(-1) == 1).all())
            slots[..., q] = torch.where(at, keys.view(T, G, epg), 0.0).sum(-1)
        score = slots[..., 0]
        for q in range(1, gk):
            score = score + slots[..., q]
    rw = ops.packed_keys(_zero(score).contiguous())            # (T, G)
    above = (rw[:, None, :] > rw[:, :, None]).sum(-1)
    live = (above < M).repeat_interleave(epg, dim=1)
    masked = torch.where(live, keys, torch.full_like(keys, float("-inf")))
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
    """The kernel's rack paths: (1, lanes a rack) where a rack is a power of
    two of whole lanes and the group top-k fits a lane, (2, 0) for every
    other geometry the reference routes, (0, 0) for free routing, -1 only
    where ``GatingConfig`` refuses the geometry too."""
    assert ops.rack_mode(256, 8, 8, 4, 2) == (1, 4)
    assert ops.rack_mode(256, 8, 2, 1, 2) == (1, 16)
    assert ops.rack_mode(16, 2, 4, 1, 2) == (1, 1)
    assert ops.rack_mode(256, 8, 8, 8, 2) == (0, 0)        # M == G: free
    assert ops.rack_mode(256, 8, 1, 0, 2) == (0, 0)
    assert ops.rack_mode(96, 4, 2, 1, 2) == (2, 0)         # 12 lanes a rack
    assert ops.rack_mode(32, 2, 16, 1, 2) == (2, 0)        # 2 experts a rack
    assert ops.rack_mode(256, 8, 8, 1, 8) == (1, 4)        # group top-8
    assert ops.rack_mode(160, 6, 8, 3, 1) == (2, 0)        # 20 experts a rack
    assert ops.rack_mode(256, 8, 2, 1, 16) == (2, 0)       # gk above PER
    assert ops.rack_mode(96, 4, 5, 1, 2) == (-1, 0)        # G not dividing E
    assert ops.rack_mode(16, 8, 4, 1, 2) == (-1, 0)        # k > M E / G
    assert ops.rack_mode(16, 2, 4, 1, 0) == (-1, 0)        # group top-0


def test_every_accepted_rack_geometry_takes_a_kernel_path():
    """Within the kernel's limits (E <= 256, k <= 8), every (E, k, G, M,
    gk) the port's ``GatingConfig`` accepts with a binding limit takes path
    1 or 2: none is refused on the card."""
    n = 0
    for E in (1, 2, 3, 6, 16, 24, 60, 64, 96, 128, 160, 192, 250, 255, 256):
        for G in (g for g in range(2, E + 1) if E % g == 0):
            for M in sorted({1, G // 2, G - 1} - {0}):
                for k in sorted({1, min(8, E), min(8, M * (E // G))}):
                    for gk in sorted({1, 2, E // G, E // G + 1}):
                        try:
                            tg.GatingConfig(num_experts=E, top_k=k,
                                            num_racks=G, rack_limit=M,
                                            rack_group_topk=gk)
                        except ValueError:
                            continue
                        assert ops.rack_mode(E, k, G, M, gk)[0] in (1, 2), (
                            E, k, G, M, gk)
                        n += 1
    assert n > 500

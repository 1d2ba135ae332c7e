"""Fused router top-k: the port's plain version vs the Pallas kernel
(interpret mode) and the JAX oracle, the tie rule, and the CUDA kernel vs
the plain version on a card.

CPU: ids and counts must be equal, weights within rtol 1e-5 (the two
frameworks' softmaxes may differ in the last bit); with a selection bias,
the same against ``lax.top_k`` of the biased scores, weights gathered from
the unbiased ones, as ``repro.moe.gating.gate`` selects.  Card: ids equal on
every row whose k-th and (k+1)-th plain scores differ by more than 1e-6
relative (the kernel's expf and sum order may move a near-tie), and on
every row of the tie case; counts equal the histogram of the kernel's own
ids; weights and scores within 1e-6 * max|ref|.  With a bias the gap is
taken on the biased keys.

The kernel's selection (a max over 64-bit words: the key's order bits
above the complement of the expert index, over groups of G lanes)
is mirrored on the CPU by ``ops.packed_topk``, whose ids must equal the
plain stable sort's exactly, signed zeros and ragged E included.  On the
card: counts stay right over back-to-back launches (the cross-block ticket
resets), under CUDA-graph capture and replay, and are bitwise the same
across runs; the CPU mirror of the launch geometry equals the kernel's.

The JAX side is imported inside the tests that use it, so the card test
also runs where JAX is not installed:
  PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
      tests/test_torch_gating_topk.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.gating_topk import ops

SHAPES = [(256, 32, 2), (512, 128, 8), (96, 16, 4), (4096, 16, 2)]


def _logits(T, E, seed=0):
    return np.random.default_rng(seed).standard_normal((T, E)).astype(
        np.float32)


def _tie_logits(T=128, D=32, E=16):
    """The tie case of test_torch_gating: duplicated router columns give
    bitwise-equal scores, all-zero tokens tie every expert."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, D)).astype(np.float32)
    x[::7] = 0.0
    w = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    w[:, 9] = w[:, 2]
    w[:, 5] = w[:, 11]
    return x @ w


def _check_against_jax(logits, k, score_fn):
    import jax.numpy as jnp

    from repro.kernels.gating_topk.ops import gating_topk as jax_gating_topk
    from repro.kernels.gating_topk.ref import gating_topk_ref as jax_ref

    ids, w, cnt = ops.gating_topk_ref(torch.from_numpy(logits), k,
                                      score_fn=score_fn)
    for j_ids, j_w, j_cnt in (jax_gating_topk(jnp.asarray(logits), k,
                                              score_fn=score_fn),
                              jax_ref(jnp.asarray(logits), k,
                                      score_fn=score_fn)):
        np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(j_cnt))
        np.testing.assert_allclose(w.numpy(), np.asarray(j_w), rtol=1e-5,
                                   atol=1e-7)
    return ids


@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
@pytest.mark.parametrize("T,E,k", SHAPES)
def test_plain_version_matches_pallas_interpret_and_oracle(score_fn, T, E, k):
    _check_against_jax(_logits(T, E), k, score_fn)


@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
def test_ties_take_lower_index_first(score_fn):
    logits = _tie_logits()
    ids = _check_against_jax(logits, 4, score_fn)
    assert ids[0].tolist() == [0, 1, 2, 3]               # an all-zero row
    both = ids[1:7].numpy()                              # 2 before 9, 5 before 11
    for lo, hi in ((2, 9), (5, 11)):
        for row in both:
            if hi in row:
                assert lo in row and list(row).index(lo) < list(row).index(hi)


def _bias(E, seed=7, scale=1e-2):
    return (np.random.default_rng(seed).standard_normal(E) * scale).astype(
        np.float32)


@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
@pytest.mark.parametrize("T,E,k", [(256, 32, 2), (512, 128, 8)])
def test_bias_steers_selection_only(score_fn, T, E, k):
    import jax
    import jax.numpy as jnp

    logits, bias = _logits(T, E, seed=6), _bias(E)
    ids, w, cnt = ops.gating_topk_ref(torch.from_numpy(logits), k,
                                      score_fn=score_fn,
                                      bias=torch.from_numpy(bias))
    scores = (jax.nn.softmax if score_fn == "softmax" else jax.nn.sigmoid)(
        jnp.asarray(logits))
    _, j_ids = jax.lax.top_k(scores + jnp.asarray(bias)[None, :], k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(
        w.numpy(), np.asarray(jnp.take_along_axis(scores, j_ids, axis=1)),
        rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(
        cnt.numpy(), np.bincount(np.asarray(j_ids).ravel(), minlength=E))
    plain = ops.gating_topk_ref(torch.from_numpy(logits), k,
                                score_fn=score_fn)[0]
    assert not torch.equal(ids, plain)          # the bias moved selections


@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
def test_wrapper_on_cpu_is_the_plain_version(score_fn):
    x = torch.from_numpy(_logits(64, 24, seed=3))
    before = ops.gating_topk.launches
    ids, w, cnt, scores = ops.gating_topk(x, 3, score_fn=score_fn,
                                          want_scores=True)
    assert ops.gating_topk.launches == before
    assert ids.dtype == torch.int64 and cnt.dtype == torch.int64
    assert torch.equal(scores, ops.scores_of(x, score_fn))
    assert torch.equal(w, torch.gather(scores, 1, ids))
    assert torch.equal(cnt, torch.bincount(ids.reshape(-1), minlength=24))
    assert len(ops.gating_topk(x, 3, score_fn=score_fn)) == 3


def test_gate_routes_free_routing_through_gating_topk(monkeypatch):
    """Free routing takes ids, weights and counts from ``gating_topk``,
    with the selection bias when one is in play; the ideal router does
    not."""
    from repro_torch.moe import gating

    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        return ops.gating_topk(*args, **kw)

    monkeypatch.setattr(gating, "gating_topk", spy)
    x = torch.from_numpy(_logits(32, 8, seed=4))
    w = torch.from_numpy(_logits(8, 16, seed=5))
    cfg = gating.GatingConfig(num_experts=16, top_k=4)
    gating.gate(x, w, cfg)
    assert calls == [{"score_fn": "softmax", "bias": None,
                      "want_scores": True}]
    gating.gate(x, w, gating.GatingConfig(num_experts=16, top_k=4,
                                          ideal=True))
    assert len(calls) == 1
    bias = torch.from_numpy(_bias(16))
    gating.gate(x, w, gating.GatingConfig(num_experts=16, top_k=4,
                                          use_bias=True), bias=bias)
    assert len(calls) == 2 and torch.equal(calls[1]["bias"], bias)


def _stable_topk(keys, k):
    return torch.sort(keys, dim=-1, descending=True, stable=True).indices[:, :k]


def _mirror_keys(case):
    """Selection keys (T, E) and k for the mirror's cases."""
    rng = np.random.default_rng(11)
    if case.startswith("random_e"):
        E = int(case[len("random_e"):])
        k = 2 if E == 16 else 8
        return ops.scores_of(torch.from_numpy(_logits(512, E, seed=E)),
                             "softmax"), k
    if case == "ties":                   # duplicated columns, all-zero rows
        return ops.scores_of(torch.from_numpy(_tie_logits()), "softmax"), 4
    if case == "ties_sigmoid":
        return ops.scores_of(torch.from_numpy(_tie_logits()), "sigmoid"), 4
    if case == "negative_by_bias":       # sigmoid + a bias below -1
        s = ops.scores_of(torch.from_numpy(_logits(256, 32, seed=12)),
                          "sigmoid")
        bias = torch.from_numpy(rng.uniform(-2.0, -1.0, 32).astype(
            np.float32))
        keys = s + bias[None, :]
        assert (keys < 0).all()
        return keys, 6
    if case == "mixed_sign_bias":
        s = ops.scores_of(torch.from_numpy(_logits(256, 128, seed=13)),
                          "sigmoid")
        return s + torch.from_numpy(_bias(128, scale=0.5)), 8
    if case == "signed_zero":            # -0.0 and +0.0 tie, lower index first
        keys = torch.from_numpy(rng.choice(
            np.array([-0.0, 0.0, -1.0, 1.0, -np.inf], np.float32),
            size=(256, 24)))
        assert (torch.signbit(keys) & (keys == 0)).any()
        return keys, 8
    if case in ("ragged_e60", "ragged_e37", "ragged_e100"):
        E = int(case[len("ragged_e"):])
        x = _logits(300, E, seed=E)
        x[::3, E // 2:] = x[::3, :E - E // 2]      # cross-lane duplicates
        return ops.scores_of(torch.from_numpy(x), "softmax"), min(8, E // 6)
    raise ValueError(case)


MIRROR_CASES = ["random_e16", "random_e60", "random_e128", "random_e256",
                "ties", "ties_sigmoid", "negative_by_bias", "mixed_sign_bias",
                "signed_zero", "ragged_e60", "ragged_e37", "ragged_e100"]


@pytest.mark.parametrize("case", MIRROR_CASES)
def test_packed_topk_mirror_equals_stable_sort(case):
    """The kernel's packed-word argmax over its lane groups, k rounds,
    picks what the plain version's stable sort picks."""
    keys, k = _mirror_keys(case)
    got = ops.packed_topk(keys, k)
    assert got.dtype == torch.int64
    assert torch.equal(got, _stable_topk(keys, k))


def test_packed_keys_follow_float_order_then_lower_index():
    vals = np.array([-np.inf, -3.0e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0,
                     3.0e38, np.inf], np.float32)
    words = ops.packed_keys(torch.from_numpy(vals)[None, :])[0]
    # strictly increasing float order, except -0.0 / +0.0, which tie on the
    # key and are ordered by the index's complement (lower index larger)
    assert bool((words[1:] > words[:-1])[[0, 1, 2, 3, 5, 6, 7, 8]].all())
    assert words[4] > words[5] and (words[4] >> 32) == (words[5] >> 32)


@pytest.mark.parametrize("E,k,group,per", [(16, 2, 4, 4), (60, 6, 16, 4),
                                           (128, 8, 32, 4), (256, 8, 32, 8),
                                           (16, 8, 8, 4), (1, 1, 1, 4)])
def test_launch_geometry_and_scratch_size(E, k, group, per):
    assert ops.launch_geometry(4096, E, k) == (group, per, 32, 128)
    assert group >= k and group * per >= E and per in (4, 8)
    assert group * per < 2 * max(E, 4 * group)    # no lane wholly idle twice
    for T, blocks in ((0, 1), (4, 1), (33, 2), (4096, 128), (8192, 256),
                      (9000, 256)):
        _, _, rows, got = ops.launch_geometry(T, E, k)
        assert got == blocks
        # whole warps; a grid of several blocks has 32 rows in each
        assert (rows * group) % 32 == 0 and rows <= ops.MAX_ROWS
        assert blocks == 1 or rows == ops.MAX_ROWS
        assert (blocks - 1) * rows < max(T, 1) <= blocks * rows or T > (
            ops.MAX_BLOCKS * rows)
    # The scratch: a 16-byte head, then one accumulator of E words that
    # every block adds its histogram into (the last block reads E words
    # with its 32 G threads, whatever the grid).
    assert ops.SCRATCH_HEAD * 4 == 16
    assert ops.SCRATCH_INTS == ops.SCRATCH_HEAD + ops.MAX_EXPERTS >= (
        ops.SCRATCH_HEAD + E)
    assert E <= 32 * group * per


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        ops.gating_topk(torch.empty((4, 8), device="meta"), 2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel builds with nvcc for "
                    "sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rows_with_a_gap(scores, k, rel=1e-6):
    """Rows whose k-th and (k+1)-th largest plain scores differ by more
    than ``rel`` relative: the kernel's selection there is decided."""
    top = torch.sort(scores, dim=-1, descending=True).values
    if k == scores.shape[1]:
        return torch.ones(scores.shape[0], dtype=torch.bool,
                          device=scores.device)
    kth, nxt = top[:, k - 1], top[:, k]
    return (kth - nxt) > rel * kth.abs()


@pytest.mark.cuda
@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
@pytest.mark.parametrize("T,E,k", SHAPES + [(4, 128, 8), (1000, 60, 6),
                                            (300, 256, 8), (33, 1, 1),
                                            (9000, 128, 8), (4096, 256, 8)])
def test_kernel_matches_plain_on_card(cuda_device, score_fn, T, E, k):
    x = torch.from_numpy(_logits(T, E, seed=2)).to(cuda_device)
    before = ops.gating_topk.launches
    ids, w, cnt, scores = ops.gating_topk(x, k, score_fn=score_fn,
                                          want_scores=True)
    torch.cuda.synchronize()
    assert ops.gating_topk.launches == before + 1
    r_ids, r_w, _, r_scores = ops.gating_topk_ref(x, k, score_fn=score_fn,
                                                  want_scores=True)
    decided = _rows_with_a_gap(r_scores, k)
    assert torch.equal(ids[decided], r_ids[decided])
    assert torch.equal(cnt, torch.bincount(ids.reshape(-1), minlength=E))
    for out, ref in ((w, r_w), (scores, r_scores)):
        assert (out - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
@pytest.mark.parametrize("T,E,k", [(512, 128, 8), (300, 256, 8)])
def test_kernel_with_bias_matches_plain_on_card(cuda_device, score_fn, T, E,
                                                k):
    x = torch.from_numpy(_logits(T, E, seed=2)).to(cuda_device)
    bias = torch.from_numpy(_bias(E)).to(cuda_device)
    ids, w, cnt, scores = ops.gating_topk(x, k, score_fn=score_fn, bias=bias,
                                          want_scores=True)
    torch.cuda.synchronize()
    r_ids, r_w, _, r_scores = ops.gating_topk_ref(
        x, k, score_fn=score_fn, bias=bias, want_scores=True)
    decided = _rows_with_a_gap(r_scores + bias[None, :], k)
    assert torch.equal(ids[decided], r_ids[decided])
    assert torch.equal(cnt, torch.bincount(ids.reshape(-1), minlength=E))
    for out, ref in ((w, r_w), (scores, r_scores)):
        assert (out - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
def test_kernel_ties_on_card(cuda_device, score_fn):
    x = torch.from_numpy(_tie_logits()).to(cuda_device)
    ids, _, cnt = ops.gating_topk(x, 4, score_fn=score_fn)
    r_ids, _, r_cnt = ops.gating_topk_ref(x, 4, score_fn=score_fn)
    torch.cuda.synchronize()
    assert torch.equal(ids, r_ids) and torch.equal(cnt, r_cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,k", [(4096, 128, 8), (9000, 256, 8),
                                   (4096, 16, 2), (4, 128, 8)])
def test_counts_over_back_to_back_launches_on_card(cuda_device, T, E, k):
    """Five launches with nothing zeroed in between: each one's counts are
    the histogram of its own ids, so the ticket went back to 0 each time."""
    outs = []
    for seed in range(5):
        x = torch.from_numpy(_logits(T, E, seed=20 + seed)).to(cuda_device)
        outs.append(ops.gating_topk(x, k))
    torch.cuda.synchronize()
    for ids, _, cnt in outs:
        assert torch.equal(cnt, torch.bincount(ids.reshape(-1), minlength=E))
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    assert ops._SCRATCH[(cuda_device.index or 0, stream)][0].item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
def test_cuda_graph_capture_and_replay_on_card(cuda_device, score_fn):
    """The call is captured in a CUDA graph and replayed on two logits
    copied into the static input: ids and counts are right after each."""
    T, E, k = 4096, 128, 8
    static = torch.from_numpy(_logits(T, E, seed=30)).to(cuda_device)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ops.gating_topk(static, k, score_fn=score_fn)     # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        ids, w, cnt, scores = ops.gating_topk(static, k, score_fn=score_fn,
                                              want_scores=True)
    for seed in (31, 32):
        x = torch.from_numpy(_logits(T, E, seed=seed)).to(cuda_device)
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        r_ids, r_w, r_cnt, r_scores = ops.gating_topk_ref(
            x, k, score_fn=score_fn, want_scores=True)
        decided = _rows_with_a_gap(r_scores, k)
        assert decided.float().mean().item() > 0.99
        assert torch.equal(ids[decided], r_ids[decided])
        assert torch.equal(cnt, torch.bincount(ids.reshape(-1), minlength=E))
        assert (w - r_w).abs().max().item() <= 1e-6 * r_w.abs().max().item()
        assert (scores - r_scores).abs().max().item() <= (
            1e-6 * r_scores.abs().max().item())


@pytest.mark.cuda
def test_first_call_inside_a_capture_raises_on_card(cuda_device):
    """A stream's scratch is made (ticket zeroed) outside any capture."""
    x = torch.from_numpy(_logits(64, 16, seed=33)).to(cuda_device)
    stream = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph, stream=stream):
            ops.gating_topk(x, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,k", [(4096, 128, 8), (9000, 256, 8)])
def test_counts_bitwise_equal_across_runs_on_card(cuda_device, T, E, k):
    x = torch.from_numpy(_logits(T, E, seed=34)).to(cuda_device)
    a = ops.gating_topk(x, k)
    b = ops.gating_topk(x, k)
    torch.cuda.synchronize()
    assert torch.equal(a[2], b[2]) and torch.equal(a[0], b[0])
    assert torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_empty_input_writes_zero_counts_on_card(cuda_device):
    x = torch.empty((0, 128), device=cuda_device)
    ids, w, cnt = ops.gating_topk(x, 8)
    torch.cuda.synchronize()
    assert ids.shape == (0, 8) and w.shape == (0, 8)
    assert torch.equal(cnt, torch.zeros(128, dtype=torch.int64,
                                        device=cuda_device))


@pytest.mark.cuda
def test_launch_geometry_mirrors_the_kernel_on_card(cuda_device):
    """The kernel's entry point decides its geometry; the CPU mirror that
    ``packed_topk`` and the tests use gives the same, scratch size too."""
    for E in (1, 16, 37, 60, 100, 128, 129, 200, 256):
        for k in sorted({1, 2, min(6, E), min(8, E)}):
            for T in (0, 1, 4, 7, 31, 32, 33, 1000, 4096, 8192, 9000):
                assert ops.kernel_plan(T, E, k) == (
                    *ops.launch_geometry(T, E, k), ops.SCRATCH_INTS)


@pytest.mark.cuda
def test_prepare_stream_lets_the_first_call_be_captured_on_card(cuda_device):
    """After ``prepare_stream(s)``, a stream's first call can be inside a
    capture on s; ``release_scratch`` drops the scratches."""
    T, E, k = 300, 256, 8
    static = torch.from_numpy(_logits(T, E, seed=36)).to(cuda_device)
    stream = torch.cuda.Stream()
    scratch = ops.prepare_stream(stream)
    assert scratch.dtype == torch.int32 and scratch.numel() == ops.SCRATCH_INTS
    assert ops.prepare_stream(stream) is scratch
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        ids, _, cnt = ops.gating_topk(static, k)
    graph.replay()
    torch.cuda.synchronize()
    r_ids, _, _, r_scores = ops.gating_topk_ref(static, k, score_fn="softmax",
                                                want_scores=True)
    decided = _rows_with_a_gap(r_scores, k)
    assert torch.equal(ids[decided], r_ids[decided])
    assert torch.equal(cnt, torch.bincount(ids.reshape(-1), minlength=E))
    assert scratch[0].item() == 0
    del graph
    ops.release_scratch()
    assert not ops._SCRATCH


# (T, E, k, num_racks, rack_limit, group_topk): DeepSeek-V3's prefill shape
# with its published node-limited routing (8 groups, 4 kept, group top-2),
# two racks of which one, decode, and small geometries (1 and 2 lanes a
# rack); then the shared path: Jamba-v0.1's 16 experts over 8 racks,
# DBRX's routing at 8 racks, DeepSeek-V2's device-limited routing (160
# experts, top-6, 8 of 3, group top-1), E not a multiple of 4, one expert
# a rack, a group top-k above a lane's experts, more rows than one pass of
# the grid; a group top-8 on the lanes path.
RACK_SHAPES = [(4096, 256, 8, 8, 4, 2), (4096, 256, 8, 2, 1, 2),
               (4, 256, 8, 8, 4, 2), (1000, 128, 8, 4, 2, 3),
               (512, 16, 2, 4, 1, 2), (300, 32, 4, 2, 1, 4),
               (9000, 256, 8, 8, 2, 2), (4096, 16, 2, 8, 2, 2),
               (4096, 16, 4, 8, 2, 2), (4096, 160, 6, 8, 3, 1),
               (4, 160, 6, 8, 3, 1), (1000, 60, 4, 6, 2, 2),
               (4096, 256, 8, 2, 1, 8), (512, 16, 2, 16, 8, 1),
               (300, 256, 8, 2, 1, 16), (77, 255, 8, 5, 2, 3),
               (9000, 160, 6, 8, 3, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("bias", [False, True], ids=["free", "bias"])
@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
@pytest.mark.parametrize("T,E,k,G,M,gk", RACK_SHAPES)
def test_kernel_rack_mode_matches_plain_on_card(cuda_device, score_fn, bias,
                                                T, E, k, G, M, gk):
    """The rack mode's ids equal the plain rack selection on the kernel's
    own scores (plus the bias) on every row, ties included, so the rack
    scores, the kept racks and the rounds are the plain version's; the
    scores and weights are within 1e-6 max|ref| of the plain version's;
    the counts are the histogram of the ids; one launch, counted as rack
    mode."""
    x = torch.from_numpy(_logits(T, E, seed=3)).to(cuda_device)
    x[::9] = 0.0                                  # rows where every key ties
    b = (torch.from_numpy(_bias(E)).to(cuda_device) if bias else None)
    kw = dict(score_fn=score_fn, bias=b, want_scores=True, num_racks=G,
              rack_limit=M, group_topk=gk)
    before = dict(ops.gating_topk.launches_by_kernel)
    ids, w, cnt, scores = ops.gating_topk(x, k, **kw)
    torch.cuda.synchronize()
    assert ops.gating_topk.launches_by_kernel["rack"] == before["rack"] + 1
    keys = scores if b is None else scores + b[None, :]
    assert torch.equal(ids, ops.rack_limited_ids(keys, k, G, M, gk))
    assert torch.equal(cnt, torch.bincount(ids.reshape(-1), minlength=E))
    r_ids, r_w, _, r_scores = ops.gating_topk_ref(x, k, **kw)
    assert (scores - r_scores).abs().max() <= 1e-6 * r_scores.abs().max()
    assert torch.equal(w, torch.gather(scores, 1, ids))
    racks = ids // (E // G)
    assert max(torch.unique(r).numel() for r in racks.cpu()) <= M


@pytest.mark.cuda
@pytest.mark.parametrize("score_fn", ["softmax", "sigmoid"])
def test_kernel_rack_limit_of_all_racks_is_free_routing(cuda_device,
                                                        score_fn):
    x = torch.from_numpy(_logits(2048, 256, seed=4)).to(cuda_device)
    free = ops.gating_topk(x, 8, score_fn=score_fn, want_scores=True)
    full = ops.gating_topk(x, 8, score_fn=score_fn, want_scores=True,
                           num_racks=8, rack_limit=8, group_topk=2)
    for a, c in zip(free, full):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_kernel_rack_mode_refuses_other_geometries(cuda_device):
    """Only geometries the reference refuses too: racks that do not divide
    E, k above the kept racks' experts, a group top-k below 1.  The
    kernel's entry point picks the path its CPU mirror picks."""
    x = torch.zeros((8, 96), device=cuda_device)
    with pytest.raises(ValueError, match="rack mode"):
        ops.gating_topk(x, 4, num_racks=5, rack_limit=1)
    with pytest.raises(ValueError, match="rack mode"):
        ops.gating_topk(x[:, :16], 8, num_racks=4, rack_limit=1)
    with pytest.raises(ValueError, match="rack mode"):
        ops.gating_topk(x, 4, num_racks=2, rack_limit=1, group_topk=0)
    for E in (16, 60, 96, 128, 160, 255, 256):
        for G in (g for g in range(2, E + 1) if E % g == 0):
            for k, M, gk in ((1, 1, 1), (min(8, E // G), 1, 2),
                             (2, G - 1, E // G), (8, G - 1, 9)):
                assert ops.kernel_rack_mode(E, k, G, M, gk) == \
                    ops.rack_mode(E, k, G, M, gk), (E, k, G, M, gk)

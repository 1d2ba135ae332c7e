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
                                            (300, 256, 8), (33, 1, 1)])
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

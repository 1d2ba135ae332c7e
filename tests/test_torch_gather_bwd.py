"""The fixed-order sums of the MoE layer's backward, on the CPU.

``gather_rows``'s backward (``ordered_row_sum``) adds each row's gradient
copies in position order, so a train step gives the same bits on every
run where an ``index_add_`` on a CUDA tensor would add them with atomics
in no fixed order (a token's top-k copies, k > 2).  Held here bitwise
against a Python loop that adds each destination row's contributions in
position order, and within 1e-6 of autograd through ``x[idx]``; the
replica stream's transpose against the same loop in (rank, slot) order;
and the tile orders of the grouped backward kernels (B1, B2, B3) against
a brute-force enumeration.

The train step's grouped backward leaves the slot rows past each count
(rounded up to 64) unwritten on the card (``zero_padded=False``): dact,
dh, dg and the slot buffers' gradient dx.  Every reader of those rows must
select the valid rows, never multiply a padded one into a valid result:
held here bitwise with NaN against zeros in the padded rows for the
dispatch gathers' backward (top-k 8 copies and one), the reference
engine's ``bucket_by_slot``, the masked call's ``torch.where``, the
SwiGLU backward's dact, and the whole layer's gradients with the grouped
backward's padded rows poisoned with NaN as the card leaves them
undefined (fused and reference engines, ``a2a``, ``replicated``, overlap
chunks, the payload screen).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.balancer import BalancerConfig
from repro_torch.kernels.grouped_gemm import ops as gg
from repro_torch.moe import distribute, stages
from repro_torch.moe.dispatch import bucket_by_slot
from repro_torch.moe.expert import grouped_ffn
from repro_torch.moe.gating import GatingConfig
from repro_torch.moe.layer import MoEConfig, init_moe_params, moe_layer_local
from repro_torch.moe.stages import Resilience
from repro_torch.moe.permute import (
    fused_bucket,
    fused_replicated_bucket,
    gather_rows,
    ordered_row_sum,
)


def _indices(seed: int, n: int, shape: tuple[int, ...], copies: int):
    """idx of ``shape`` into n rows where every row is read by at most
    ``copies`` valid positions (some by exactly that many, some by none),
    and invalid positions pointing anywhere."""
    rng = np.random.default_rng(seed)
    P = int(np.prod(shape))
    per_row = rng.integers(0, copies + 1, size=n)
    per_row[rng.integers(0, n)] = copies
    valid_idx = np.repeat(np.arange(n), per_row)[:P]
    rng.shuffle(valid_idx)
    idx = rng.integers(0, n, size=P)
    valid = np.zeros(P, dtype=bool)
    where = rng.choice(P, size=valid_idx.size, replace=False)
    idx[where] = valid_idx
    valid[where] = True
    return (torch.from_numpy(idx.reshape(shape)),
            torch.from_numpy(valid.reshape(shape)))


def _loop_sum(g, idx, valid, n, dtype):
    """Zeros plus each valid position's row, one position after another."""
    out = torch.zeros((n,) + tuple(g.shape[idx.dim():]), dtype=dtype)
    gf = g.reshape((-1,) + tuple(g.shape[idx.dim():])).to(dtype)
    for p, (i, ok) in enumerate(zip(idx.reshape(-1).tolist(),
                                    valid.reshape(-1).tolist())):
        if ok:
            out[i] = out[i] + gf[p]
    return out


CASES = [(0, 40, (6, 24), 8, 16), (1, 7, (3, 11), 8, 5), (2, 64, (200,), 1, 8),
         (3, 33, (5, 9), 3, 12), (4, 16, (4, 4, 4), 8, 3)]


@pytest.mark.parametrize("seed,n,shape,copies,D", CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_backward_is_the_position_order_sum(seed, n, shape,
                                                        copies, D, dtype):
    idx, valid = _indices(seed, n, shape, copies)
    rng = np.random.default_rng(100 + seed)
    x = torch.from_numpy(rng.standard_normal((n, D))).to(dtype)
    g = torch.from_numpy(rng.standard_normal(shape + (D,))).to(dtype)
    x.requires_grad_(True)
    y = gather_rows(x, idx, valid, copies=copies)
    (got,) = torch.autograd.grad(y, x, g)
    want = _loop_sum(g, idx, valid, n, dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    # Same bits on another call.
    (again,) = torch.autograd.grad(
        gather_rows(x, idx, valid, copies=copies), x, g)
    assert torch.equal(again, got)


@pytest.mark.parametrize("seed,n,shape,copies,D", CASES)
def test_gather_rows_backward_matches_autograd_of_indexing(seed, n, shape,
                                                           copies, D):
    idx, valid = _indices(seed, n, shape, copies)
    rng = np.random.default_rng(200 + seed)
    x0 = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape + (D,)).astype(np.float32))
    x = x0.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(gather_rows(x, idx, valid, copies=copies),
                                 x, g)
    xr = x0.clone().requires_grad_(True)
    ref = torch.where(valid[..., None], xr[idx], 0.0)
    (want,) = torch.autograd.grad(ref, xr, g)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    y = gather_rows(x0, idx, valid, copies=copies)
    assert torch.equal(y, torch.where(valid[..., None], x0[idx], 0.0))


def test_ordered_row_sum_handles_empty_and_invalid_only():
    vals = torch.ones((5, 3))
    idx = torch.tensor([0, 1, 2, 3, 4])
    none = torch.zeros(5, dtype=torch.bool)
    assert torch.equal(ordered_row_sum(vals, idx, none, 6, 4),
                       torch.zeros((6, 3)))
    assert ordered_row_sum(vals[:0], idx[:0], none[:0], 4, 2).shape == (4, 3)


@pytest.mark.parametrize("n_slot,n_main", [(3, 4), (6, 2), (5, 3)])
def test_replica_grads_add_in_slot_order(n_slot, n_main):
    """The replica stream's transpose at R = 1 (no group; at R > 1
    tests/test_torch_ep.py runs it over gloo), with several replicas of
    one main: bitwise the loop over the slots in order."""
    rng = np.random.default_rng(10 + n_slot)
    x_slots = torch.from_numpy(rng.integers(-1, n_main, size=(1, n_slot)))
    d_rep = torch.from_numpy(
        rng.standard_normal((n_slot, 2, 3)).astype(np.float32))
    base = torch.from_numpy(
        rng.standard_normal((n_main, 2, 3)).astype(np.float32))
    got = distribute.replica_grads_to_mains(d_rep, x_slots, 0, None,
                                            base.clone())
    want = base.clone()
    for s, e in enumerate(x_slots.reshape(-1).tolist()):
        if e >= 0:
            want[e] = want[e] + d_rep[s]
    assert torch.equal(got, want)


def test_replica_grads_many_copies_bitwise():
    """Eight replicas of one main, at R = 1: the same bits as the loop."""
    rng = np.random.default_rng(7)
    x_slots = torch.zeros((1, 8), dtype=torch.int64)
    d_rep = torch.from_numpy(
        (rng.standard_normal((8, 16)) * 10.0 ** rng.integers(-3, 3, (8, 1)))
        .astype(np.float32))
    base = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    got = distribute.replica_grads_to_mains(d_rep, x_slots, 0, None,
                                            base.clone())
    want = base.clone()
    for s in range(8):
        want[0] = want[0] + d_rep[s]
    assert torch.equal(got, want)


def _brute_b1(rows, M, N):
    items = []
    for g, r in enumerate(rows):
        mt = -(-min(max(r, 0), M) // 128)
        for nt in range(-(-N // 128)):
            for m in range(mt):
                items.append((g, 128 * m, 128 * nt))
    return items


@pytest.mark.parametrize("rows,M,N", [
    ([0, 37, 129, 300, 250], 300, 72),
    ([0, 0, 0], 64, 128),
    ([2017, 0, 5, 1024, 2017, 128], 2017, 1408),     # full, empty, edges
    ([256, 255, 0, 1, 257], 255, 2048),              # counts past M clamp
])
def test_swiglu_bwd_tiles_enumerate_the_valid_row_tiles(rows, M, N):
    got = gg.swiglu_bwd_tiles(torch.tensor(rows), M, N)
    want = _brute_b1(rows, M, N)
    assert got.shape == (len(want), 3)
    assert [tuple(t) for t in got.tolist()] == want


@pytest.mark.parametrize("G,K,N", [(3, 4096, 1408), (2, 1408, 4096),
                                   (1, 64, 72), (4, 7168, 2048)])
def test_wgrad_tiles_enumerate_every_output_tile(G, K, N):
    got = gg.wgrad_tiles(G, K, N)
    want = [(g, 128 * k, 256 * n) for g in range(G)
            for k in range(-(-K // 128)) for n in range(-(-N // 256))]
    assert [tuple(t) for t in got.tolist()] == want


def _brute_rows(rows, M, N, cols):
    items = []
    for g, r in enumerate(rows):
        mt = -(-min(max(r, 0), M) // 128)
        for nt in range(-(-N // cols)):
            for m in range(mt):
                items.append((g, 128 * m, cols * nt))
    return items


@pytest.mark.parametrize("rows,M,N", [
    ([0, 37, 129, 300, 250], 300, 72),
    ([0, 0, 0], 64, 128),
    ([2017, 0, 5, 1024, 2017, 128], 2017, 1408),     # full, empty, N 5.5 x 256
    ([2017, 0, 600], 2017, 4096),                    # dx's N
    ([256, 255, 0, 1, 257], 255, 2048),              # counts past M clamp
    ([511, 129, 0, 384], 511, 256),                  # a short last tile
])
def test_matmul_nt_tiles_enumerate_the_valid_row_tiles(rows, M, N):
    got = gg.matmul_nt_tiles(torch.tensor(rows), M, N)
    want = _brute_rows(rows, M, N, 256)
    assert got.shape == (len(want), 3)
    assert [tuple(t) for t in got.tolist()] == want


def _poisoned(g, valid, fill):
    """``g`` with the rows where ``valid`` is False set to ``fill``."""
    pad = (...,) + (None,) * (g.dim() - valid.dim())
    return torch.where(valid[pad], g, torch.full((), fill, dtype=g.dtype))


@pytest.mark.parametrize("seed,copies", [(0, 8), (1, 8), (2, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_backward_ignores_invalid_positions(seed, copies, dtype):
    """The dispatch gathers' backward (top-k 8 copies of a token; one copy
    a receive row): NaN in the invalid positions' gradient gives the same
    bits as zeros there."""
    n, shape, D = 48, (12, 40), 24
    idx, valid = _indices(seed, n, shape, copies)
    rng = np.random.default_rng(300 + seed)
    x = torch.from_numpy(rng.standard_normal((n, D))).to(dtype)
    g = torch.from_numpy(rng.standard_normal(shape + (D,))).to(dtype)
    grads = []
    for fill in (0.0, float("nan")):
        xg = x.clone().requires_grad_(True)
        y = gather_rows(xg, idx, valid, copies=copies)
        (d,) = torch.autograd.grad(y, xg, _poisoned(g, valid, fill))
        grads.append(d)
    assert torch.isfinite(grads[1]).all()
    assert torch.equal(grads[0], grads[1])


def _slot_grads(make_xs, src, fill, rows):
    """Gradient in ``src`` of the slot buffers made by ``make_xs(src)``
    for a slot gradient whose rows past ``rows`` hold ``fill``."""
    s = src.clone().requires_grad_(True)
    xs = make_xs(s)
    G, C, _ = xs.shape
    keep = torch.arange(C)[None, :] < rows[:, None]
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(xs.shape)).astype(np.float32))
    (d,) = torch.autograd.grad(xs, s, _poisoned(g, keep, fill))
    return d


def _bucket_case(seed=3):
    rng = np.random.default_rng(seed)
    R, cap_pair, D, S, cap = 3, 20, 8, 5, 16
    counts = rng.integers(0, 5, size=(R, S + 1))
    counts[:, S] = 0
    recv_x = torch.from_numpy(rng.standard_normal((R, cap_pair, D)).astype(
        np.float32))
    return recv_x, torch.from_numpy(counts), S, cap


def test_fused_bucket_backward_ignores_padded_slot_rows():
    recv_x, counts, S, cap = _bucket_case()
    rows = fused_bucket(recv_x, counts, num_slots=S, cap_slot=cap)[4]
    make = lambda s: fused_bucket(s, counts, num_slots=S, cap_slot=cap)[0]
    a, b = (_slot_grads(make, recv_x, f, rows) for f in (0.0, float("nan")))
    assert torch.isfinite(b).all() and torch.equal(a, b)


def test_fused_replicated_bucket_backward_ignores_padded_slot_rows():
    rng = np.random.default_rng(4)
    T, k, E, S, cap = 24, 8, 16, 6, 40
    x = torch.from_numpy(rng.standard_normal((T, 8)).astype(np.float32))
    ids = torch.from_numpy(np.stack([rng.permutation(E)[:k]
                                     for _ in range(T)]))
    cum_u = torch.cumsum(torch.full((E, 1), T * k), dim=0)
    slot_of = torch.where(torch.arange(E) < S, torch.arange(E), -1)

    def make(s):
        return fused_replicated_bucket(s, ids, cum_u, 0, slot_of,
                                       num_slots=S, cap_slot=cap).xs

    rows = fused_replicated_bucket(x, ids, cum_u, 0, slot_of, num_slots=S,
                                   cap_slot=cap).rows
    a, b = (_slot_grads(make, x, f, rows) for f in (0.0, float("nan")))
    assert torch.isfinite(b).all() and torch.equal(a, b)


def test_reference_bucket_backward_ignores_padded_slot_rows():
    """The reference engine's ``bucket_by_slot`` (a scatter whose
    backward gathers the kept items' slot rows)."""
    rng = np.random.default_rng(6)
    R, cap_pair, D, E, S, cap = 2, 24, 8, 8, 6, 16
    recv_x = torch.from_numpy(rng.standard_normal((R, cap_pair, D)).astype(
        np.float32))
    recv_e = torch.from_numpy(rng.integers(-1, E, size=(R, cap_pair)))
    slot_of = torch.tensor([0, 1, 2, -1, 3, 4, 5, -1])
    valid = bucket_by_slot(recv_x, recv_e, slot_of, num_slots=S,
                           cap_slot=cap)[1]
    make = lambda s: bucket_by_slot(s, recv_e, slot_of, num_slots=S,
                                    cap_slot=cap)[0]
    a, b = (_slot_grads(make, recv_x, f, valid.sum(dim=1))
            for f in (0.0, float("nan")))
    assert torch.isfinite(b).all() and torch.equal(a, b)


def test_masked_call_ignores_unwritten_padded_rows(monkeypatch):
    """A grouped FFN called with a mask and no row counts zeroes the rows
    the mask excludes with a ``torch.where`` and runs each slot to its last
    valid row: the slot buffers' gradient is the same bits when the
    grouped backward's padded rows hold NaN."""
    rng = np.random.default_rng(7)
    G, C, D, F = 3, 70, 8, 16
    xs = torch.from_numpy(rng.standard_normal((G, C, D)).astype(np.float32))
    valid = torch.from_numpy(rng.random((G, C)) < 0.5)
    valid[1] = False
    valid[2, 60:] = False
    w1, w3 = (torch.from_numpy(rng.standard_normal((G, D, F)).astype(
        np.float32)) for _ in range(2))
    w2 = torch.from_numpy(rng.standard_normal((G, F, D)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((G, C, D)).astype(np.float32))

    def grad():
        s = xs.clone().requires_grad_(True)
        (d,) = torch.autograd.grad(grouped_ffn(s, valid, w1, w3, w2), s, g)
        return d

    want = grad()
    _poison_backward(monkeypatch)
    got = grad()
    assert torch.isfinite(got).all() and torch.equal(got, want)


def test_swiglu_bwd_ignores_padded_dact_rows():
    """B1's plain version (the kernel's arithmetic on the CPU) reads the
    matmul's dgrad, dact: NaN past the counts changes no bit."""
    rng = np.random.default_rng(8)
    G, M, K, N = 3, 70, 16, 24
    x, w1, w3 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((G, M, K), (G, K, N), (G, K, N)))
    dact = torch.from_numpy(rng.standard_normal((G, M, N)).astype(np.float32))
    rows = torch.tensor([0, 33, 70])
    keep = torch.arange(M)[None, :] < rows[:, None]
    a = gg.grouped_swiglu_bwd(x, w1, w3, _poisoned(dact, keep, 0.0), rows)
    b = gg.grouped_swiglu_bwd(x, w1, w3, _poisoned(dact, keep, float("nan")),
                              rows)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _poison_backward(monkeypatch):
    for name, rows_at in (("grouped_matmul_nt", 2), ("grouped_swiglu_bwd", 4)):
        monkeypatch.setattr(gg, name, _unwritten(getattr(gg, name), rows_at))


E_L, K_L, D_L, F_L, T_L = 16, 8, 32, 48, 64
LAYER_GRADS = ("router", "w1", "w3", "w2")


def _unwritten(fn, rows_at):
    """``fn`` (a grouped backward wrapper, its ``rows`` argument at
    position ``rows_at``) whose ``zero_padded=False``
    calls come back with NaN in every row from the count rounded up to
    64, as the kernels leave them undefined on the card."""
    def poisoned(*args, zero_padded=True, **kw):
        out = fn(*args, zero_padded=zero_padded, **kw)
        if zero_padded:
            return out
        rows = args[rows_at]
        one = out if isinstance(out, torch.Tensor) else out[0]
        keep = torch.arange(one.shape[1])[None, :] < (
            (rows.clamp(min=0) + 63) // 64 * 64)[:, None]
        if isinstance(out, torch.Tensor):
            return _poisoned(out, keep, float("nan"))
        return tuple(_poisoned(t, keep, float("nan")) for t in out)
    return poisoned


def _layer_grads(cfg, params, x, screen):
    params.requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    y, _, _ = moe_layer_local(xg, params, cfg,
                              resilience=Resilience() if screen else None)
    (y ** 2).sum().backward()
    out = [xg.grad] + [getattr(params, n).grad.clone() for n in LAYER_GRADS]
    for t in params.parameters():
        t.grad = None
    params.requires_grad_(False)
    return out


@pytest.mark.parametrize("mode,impl,chunks,screen", [
    ("a2a", "fused", 1, False), ("replicated", "fused", 1, False),
    ("a2a", "reference", 1, False), ("replicated", "reference", 1, False),
    ("a2a", "fused", 2, False), ("a2a", "fused", 1, True)])
def test_layer_grads_ignore_unwritten_padded_rows(monkeypatch, mode, impl,
                                                  chunks, screen):
    """The MoE layer's gradients (tokens, router, experts) are the same
    bits when the grouped backward's padded rows (dact, dh, dg and the slot
    buffers' dx) hold NaN as when they hold zeros: no reader lets one into
    a valid result.  Top-8 of 16 experts, capacity 512 a slot, ~28 rows
    each, so most rows are padding; with the payload screen too (its
    ``torch.where`` passes the slot rows' gradient on to the gathers)."""
    cfg = MoEConfig(gating=GatingConfig(num_experts=E_L, top_k=K_L),
                    balancer=BalancerConfig(mode="ultraep", n_slot=2),
                    d_model=D_L, d_ff=F_L, ep_size=1, cap_pair=T_L * K_L,
                    cap_slot=T_L * K_L, dispatch_mode=mode,
                    dispatch_impl=impl, overlap_chunks=chunks)
    params = init_moe_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    x = torch.randn((T_L, D_L), generator=torch.Generator().manual_seed(1))
    want = _layer_grads(cfg, params, x, screen)
    _poison_backward(monkeypatch)
    got = _layer_grads(cfg, params, x, screen)
    for n, a, b in zip(("x",) + LAYER_GRADS, got, want):
        assert torch.isfinite(a).all(), n
        assert torch.equal(a, b), n

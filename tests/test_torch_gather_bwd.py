"""The fixed-order sums of the MoE layer's backward, on the CPU.

``gather_rows``'s backward (``ordered_row_sum``) adds each row's gradient
copies in position order, so a train step gives the same bits on every
run where an ``index_add_`` on a CUDA tensor would add them with atomics
in no fixed order (a token's top-k copies, k > 2).  Held here bitwise
against a Python loop that adds each destination row's contributions in
position order, and within 1e-6 of autograd through ``x[idx]``; the
replica stream's transpose against the same loop in (rank, slot) order;
and the tile orders of the grouped backward kernels (B1, B3) against a
brute-force enumeration.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.grouped_gemm import ops as gg
from repro_torch.moe import distribute
from repro_torch.moe.permute import gather_rows, ordered_row_sum


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

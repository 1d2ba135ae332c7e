"""The fp32 backward kernels' schedules and workspaces: B1f-B3f
(``kernels/grouped_gemm/csrc/grouped_gemm_bwd_f32.cu``) and B4f's dK/dV
pass (``kernels/flash_attention/csrc/flash_attention_bwd_mma.cu``).

On the CPU:
* ``wgrad_f32_chunk``: the chunks of each slot cover its valid rows
  exactly once and in order, never more than the G ceil(M / chunk) K N
  workspace holds, fill the SMs where the slots are full, and whole slots
  where the output tiles fill the SMs (the kernel's schedule over those
  chunks is checked on the card);
* ``bwd_partials_floats`` and the decomposition B4f's dK/dV pass relies
  on: a KV head's dk and dv are the sums, in head order, of its query
  heads' own.
On a card (marked ``cuda``): the grouped fp32 backward against its plain
version with NaN in every padded row, the chunked wgrad among the cases,
the train step's call leaving rows past the 128-row tiles unwritten.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.grouped_gemm import ops as gg


def _chunk_spans(cnt, chunk):
    """The wgrad's row chunks of a slot with ``cnt`` valid rows, as the
    kernel's schedule cuts them: [r, min(r + chunk, cnt)) for r in
    range(0, cnt, chunk)."""
    return [(r, min(r + chunk, cnt)) for r in range(0, cnt, chunk)]


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("G,M,K,N", [(16, 600, 64, 32), (18, 2017, 32, 64),
                                     (3, 100, 64, 32), (40, 96, 128, 128)])
def test_wgrad_chunks_cover_each_slots_rows_once_in_order(seed, sms, G, M,
                                                          K, N):
    """Each slot's chunks cover its valid rows once and in order, whole
    32-row stages a chunk, never more chunks than the wrapper's workspace
    holds (ceil(M / chunk) a slot) nor than ceil(2 sms / tiles)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, M + 40, G)
    rows[0] = 0
    chunk = gg.wgrad_f32_chunk(G, M, K, N, sms)
    assert chunk > 0 and chunk % 32 == 0
    tiles = G * -(-K // 128) * -(-N // 128)
    for g in range(G):
        cnt = min(int(rows[g]), M)
        spans = _chunk_spans(cnt, chunk)
        assert [r for r0, r1 in spans for r in range(r0, r1)] == \
            list(range(cnt))
        assert all(0 < r1 - r0 <= chunk for r0, r1 in spans)
        assert len(spans) <= -(-M // chunk)           # the workspace
        assert len(spans) <= -(-2 * sms // tiles)


@pytest.mark.parametrize("sms", [132, 114, 78])
@pytest.mark.parametrize("G,M,K,N", [(16, 600, 64, 32), (18, 911, 64, 32),
                                     (18, 2017, 32, 64), (16, 4096, 64, 32)])
def test_wgrad_chunks_fill_the_card_when_slots_are_full(sms, G, M, K, N):
    """With every slot full and at least 32 rows a chunk's share, the
    chunked wgrad has at least one item an SM."""
    chunk = gg.wgrad_f32_chunk(G, M, K, N, sms)
    tiles = G * -(-K // 128) * -(-N // 128)
    assert chunk > 0 and M >= 32 * -(-2 * sms // tiles)
    assert tiles * len(_chunk_spans(M, chunk)) >= sms


@pytest.mark.parametrize("G,M,K,N,want", [
    (130, 2017, 4096, 1408, 0), (2, 2017, 4096, 1408, 0),
    (1, 100, 128, 128, 32), (16, 600, 64, 32, 64), (3, 0, 64, 32, 0)])
def test_wgrad_chunk_only_where_tiles_do_not_fill_the_card(G, M, K, N, want):
    assert gg.wgrad_f32_chunk(G, M, K, N, 132) == want


@pytest.mark.parametrize("B,S,H,Hkv,hd,hv,want", [
    (1, 2048, 16, 4, 128, 128, 1 * 2048 * 16 * 256),
    (8, 128, 16, 8, 128, 128, 8 * 128 * 16 * 256),
    (1, 1024, 128, 128, 192, 128, 0), (2, 200, 4, 2, 192, 128, 2 * 200 * 4 * 320)])
def test_flash_bwd_partials_workspace(B, S, H, Hkv, hd, hv, want):
    assert flash.bwd_partials_floats(B, S, H, Hkv, hd, hv) == want


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (6, 2), (4, 1)])
def test_kv_head_grads_are_their_query_heads_summed_in_order(causal, H, Hkv):
    """What the dK/dV pass's head split and group sum compute: dk and dv
    of a KV head as the sum, in head order, of each query head's own
    (attention of that head alone), dq unchanged; within 1e-6 of each
    gradient's max|ref| against the grouped plain backward."""
    rng = np.random.default_rng(H * 10 + Hkv)
    B, S, hd = 2, 37, 16

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, v, do = t(B, S, H, hd), t(B, S, Hkv, hd), t(B, S, Hkv, hd), \
        t(B, S, H, hd)
    dq, dk, dv = flash.flash_attention_bwd_ref(q, k, v, do, causal=causal)
    G = H // Hkv
    per = [flash.flash_attention_bwd_ref(
        q[:, :, h:h + 1], k[:, :, h // G:h // G + 1],
        v[:, :, h // G:h // G + 1], do[:, :, h:h + 1], causal=causal)
        for h in range(H)]
    sk = torch.zeros_like(dk)
    sv = torch.zeros_like(dv)
    for h in range(H):
        sk[:, :, h // G] += per[h][1][:, :, 0]
        sv[:, :, h // G] += per[h][2][:, :, 0]
    sq = torch.cat([p[0] for p in per], dim=2)
    for got, want in ((sq, dq), (sk, dk), (sv, dv)):
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (G, M, K, N, rows): the reduced GLM-4.5-Air's widths (the wgrad in
# chunks), widths that are not multiples of a tile, counts past M.
F32_CARD_CASES = [
    (16, 300, 64, 32, "random"), (5, 200, 96, 136, "random"),
    (3, 257, 128, 64, [0, 257, 129]), (130, 40, 64, 32, "random"),
    (2, 600, 1024, 384, [600, 1000]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F32_CARD_CASES, ids=str)
def test_f32_backward_kernels_match_plain_on_card(cuda_device, case):
    """B1f, B2f (one and two products) and B3f against their plain
    versions within 1e-4 of each output's max|ref|, NaN in every padded
    row of every operand; the public call's padded rows zero, the train
    call's rows past the count up to the 128-row tile zero (the rest it
    may leave unwritten); two calls give the same bits."""
    G, M, K, N, rows = case
    rng = np.random.default_rng(G * M + K)
    if rows == "random":
        rows = rng.integers(0, M + 1, G)
    rows = torch.as_tensor(rows, dtype=torch.int64, device=cuda_device)
    pad = torch.arange(M, device=cuda_device)[None, :, None] >= \
        rows[:, None, None]

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(cuda_device)

    def nan(a):
        return torch.where(pad, float("nan"), a)

    x, dact = t(G, M, K), t(G, M, N)
    w1, w3 = t(G, K, N, scale=K ** -0.5), t(G, K, N, scale=K ** -0.5)
    x0, dact0 = torch.where(pad, 0.0, x), torch.where(pad, 0.0, dact)
    rh, rg = gg.grouped_swiglu_bwd_ref(x0, w1, w3, dact0, rows)
    tile_end = torch.arange(M, device=cuda_device)[None, :, None] >= \
        ((rows + 127) // 128 * 128)[:, None, None]

    def close(got, want):
        got = torch.where(pad, 0.0, got) if got.shape[1] == M else got
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err

    for zero in (True, False):
        calls = {
            "swiglu_bwd": lambda: gg.grouped_swiglu_bwd(
                nan(x), w1, w3, nan(dact), rows, zero_padded=zero),
            "dx": lambda: (gg.grouped_matmul_nt(nan(rh), w1, rows, nan(rg),
                                                w3, zero_padded=zero),),
            "dact": lambda: (gg.grouped_matmul_nt(nan(rh), w1, rows,
                                                  zero_padded=zero),),
        }
        wants = {"swiglu_bwd": (rh, rg),
                 "dx": (gg.grouped_matmul_nt_ref(rh, w1, rows, rg, w3),),
                 "dact": (gg.grouped_matmul_nt_ref(rh, w1, rows),)}
        for name, call in calls.items():
            first, again = call(), call()
            torch.cuda.synchronize()
            for a, b, want in zip(first, again, wants[name]):
                # The train call leaves the rows past the tiles unwritten:
                # the same bits are asked of the rows it writes.
                written = torch.zeros_like(pad) if zero else tile_end
                assert torch.equal(torch.where(written, 0.0, a),
                                   torch.where(written, 0.0, b)), name
                close(a, want)
                inside = pad & ~tile_end
                assert torch.all(torch.where(inside, a, 0.0) == 0), name
                if zero:
                    assert torch.all(torch.where(pad, a, 0.0) == 0), name
    first = gg.grouped_wgrad(nan(x), nan(rh), rows)
    again = gg.grouped_wgrad(nan(x), nan(rh), rows)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    close(first, gg.grouped_wgrad_ref(x0, rh, rows))

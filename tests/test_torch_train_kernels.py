"""The backward kernels of the train cells: the flash backward at
DeepSeek-V3's MLA head dims (q/k 192, v 128; B4m) and the SSD intra-chunk
backward (B5), their plain versions against the JAX package on the CPU and
the kernels against their plain versions on a card.

CPU tolerances: 1e-5 of each gradient's max|ref| (fp32 on both sides, the
frameworks sum in different orders), the reference's gradient tolerance.
Card tolerances: B4m within 2e-2 of each tensor's max|ref| (P and dS are
rounded to bf16 for their products, as B4); B5 within 1e-4 of max|ref| with
fp32 inputs (fp32 arithmetic, the scan and the sums in other orders) and
2e-2 with bf16 inputs (dx, dB, dC come back rounded to bf16).

The JAX side is imported inside the CPU tests, so the card tests also run
where JAX is not installed:
  PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
      tests/test_torch_train_kernels.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.kernels.ssd_scan import ops as ssd

GRAD_TOL = 1e-5
TRAIN_TOL = 2e-2


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _mla_qkv(B, S, H, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, 192)).astype(np.float32)
    k = rng.standard_normal((B, S, H, 192)).astype(np.float32)
    v = rng.standard_normal((B, S, H, 128)).astype(np.float32)
    do = rng.standard_normal((B, S, H, 128)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("S,causal", [(96, True), (130, True), (70, False)])
def test_plain_mla_backward_matches_jax_vjp(S, causal):
    """``flash_attention_bwd_ref`` at (192, 128) with MLA's scale
    (192 ** -0.5, as ``mla_attention`` passes it) against ``jax.vjp`` of
    JAX ``flash_ref``: dq, dk, dv each within GRAD_TOL of its max|ref|."""
    import jax
    import jax.numpy as jnp

    from repro.models.attention import flash_ref

    q, k, v, do = _mla_qkv(2, S, 3, seed=S)
    scale = 192 ** -0.5
    _, vjp = jax.vjp(lambda a, b, c: flash_ref(a, b, c, causal=causal,
                                               block_kv=64, scale=scale),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    got = flash.flash_attention_bwd_ref(
        *map(torch.from_numpy, (q, k, v, do)), causal=causal, scale=scale,
        block_kv=64)
    for name, g, w in zip("qkv", got, want):
        assert _rel_err(g.numpy(), w) <= GRAD_TOL, name


def test_backward_contract_takes_mla_dims_and_nothing_else():
    """``_bwd_contract`` (checked before any launch) takes fp32 and bf16
    at every pair a forward kernel takes, MLA's (192, 128) among them, and
    refuses every other pair and dtype: the ``tiny`` configurations' head
    dim 8, the reduced MLA widths (12, 8), fp16, mixed dtypes.  Each pair
    names its kernel: wgmma for bf16 at 64 and up, mma.sync for fp32 and
    for bf16 at 16."""
    def t(hd, dtype):
        return torch.zeros((1, 4, 2, hd), dtype=dtype)

    for (hd, hd_v), dtypes in flash.BWD_HEAD_DIMS.items():
        for dtype in (torch.float32, torch.bfloat16):
            assert dtype in dtypes
            flash._bwd_contract(t(hd, dtype), t(hd, dtype), t(hd_v, dtype))
            want = ("mma_f32" if dtype == torch.float32
                    else "mma_bf16" if hd == 16 else "wgmma")
            assert flash.bwd_kernel(dtype, hd) == want
    for dtype, hd, hd_v in [(torch.bfloat16, 8, 8), (torch.float32, 8, 8),
                            (torch.float32, 12, 8), (torch.bfloat16, 12, 8),
                            (torch.float16, 128, 128),
                            (torch.bfloat16, 192, 192),
                            (torch.float32, 128, 64)]:
        with pytest.raises(ValueError, match=f"not \\({hd}, {hd_v}\\)"):
            flash._bwd_contract(t(hd, dtype), t(hd, dtype), t(hd_v, dtype))
    with pytest.raises(ValueError, match="not \\(128, 128\\)"):
        flash._bwd_contract(t(128, torch.float32), t(128, torch.bfloat16),
                            t(128, torch.float32))


def test_ssd_backward_contract_takes_mamba2_dims_and_nothing_else():
    """B5's check (before any launch) takes (P, N) = (64, 16), (64, 128)
    (Mamba2-130M's) and (16, 16) in bf16 and fp32 at Q <= 128, and refuses
    other pairs, a longer chunk, fp16 and mixed dtypes."""
    def args(P, N, Q=128, dtype=torch.float32, bdtype=None):
        f = torch.float32
        B, nc, H = 1, 2, 3
        return (torch.zeros((B, nc, Q, H, P), dtype=dtype),
                torch.zeros((B, nc, Q, H, N), dtype=bdtype or dtype),
                torch.zeros((B, nc, Q, H, N), dtype=bdtype or dtype),
                torch.zeros((B, nc, Q, H), dtype=f),
                torch.zeros((B, nc, Q, H), dtype=f),
                torch.zeros((B, nc, Q, H, P), dtype=f),
                torch.zeros((B, nc, H, N, P), dtype=f),
                torch.zeros((B, nc, H), dtype=f))

    assert (64, 128) in ssd.BWD_DIMS
    for P, N in ssd.BWD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            ssd._bwd_contract(*args(P, N, dtype=dtype))
    for P, N, Q in [(64, 64, 128), (128, 128, 128), (32, 16, 16),
                    (64, 128, 256)]:
        with pytest.raises(ValueError, match="takes \\(P, N\\)"):
            ssd._bwd_contract(*args(P, N, Q))
    for dtype, bdtype in [(torch.float16, None),
                          (torch.float32, torch.bfloat16)]:
        with pytest.raises(TypeError):
            ssd._bwd_contract(*args(64, 128, dtype=dtype, bdtype=bdtype))


SSD_SHAPES = [(1, 2, 16, 2, 8, 16), (2, 3, 16, 4, 16, 16),
              (1, 2, 32, 2, 16, 8), (1, 2, 16, 2, 64, 128)]


def _ssd_inputs(B, nc, Q, H, P, N, seed=0):
    """The SSD tests' recipe (``tests/test_torch_ssd_scan.py``), with
    cotangents of y and the final state."""
    rng = np.random.default_rng(seed)
    xs = (rng.standard_normal((B, nc, Q, H, P)) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, nc, Q, H, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, nc, Q, H, N)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, nc, Q, H)))).astype(
        np.float32)
    da = (-dt * 0.4).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    dy = rng.standard_normal((B, nc, Q, H, P)).astype(np.float32)
    dfin = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return (xs, Bm, Cm, dt, da, s0), (dy, dfin)


@pytest.mark.parametrize("plain_backward", [False, True])
@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_backward_matches_jax_vjp(shape, plain_backward):
    """The whole chunk scan's gradient (the intra-chunk term's backward in
    closed form, ``ssd_intra_chunk_bwd_ref``, or with ``plain_backward``
    autograd through its plain forward; the recurrence and the inter-chunk
    term plain autograd) against ``jax.vjp`` of JAX
    ``_ssd_chunk_scan_ref``, from an initial state, with cotangents of y
    and of the final state: every input's gradient within GRAD_TOL of its
    max|ref|."""
    import jax
    import jax.numpy as jnp

    from repro.models.ssm import _ssd_chunk_scan_ref

    args, (dy, dfin) = _ssd_inputs(*shape, seed=sum(shape))
    _, vjp = jax.vjp(lambda *a: _ssd_chunk_scan_ref(*a),
                     *map(jnp.asarray, args))
    want = vjp((jnp.asarray(dy), jnp.asarray(dfin)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y, fin = ssd.ssd_chunk_scan(*leaves[:5], initial_state=leaves[5],
                                plain_backward=plain_backward)
    torch.autograd.backward((y, fin), (torch.from_numpy(dy),
                                       torch.from_numpy(dfin)))
    for name, leaf, w in zip(("xs", "Bm", "Cm", "dt", "da", "s0"), leaves,
                             want):
        assert _rel_err(leaf.grad.numpy(), w) <= GRAD_TOL, name


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=str)
def test_ssd_closed_form_matches_autograd(shape):
    """``ssd_intra_chunk_bwd_ref`` (the kernel's step-by-step model) against
    autograd through ``ssd_intra_chunk_ref`` with cotangents of all three
    outputs (y, S, the decay): each gradient within GRAD_TOL of its
    max|ref|, and no NaN from the masked triangle at a steep decay.  There
    da's gradient is a difference of terms far above its own size (most
    decays underflow), so only its finiteness is held."""
    (xs, Bm, Cm, dt, da, _), (dy, _) = _ssd_inputs(*shape, seed=3)
    B, nc, Q, H, P, N = shape
    rng = np.random.default_rng(4)
    dS = rng.standard_normal((B, nc, H, N, P)).astype(np.float32)
    ddec = rng.standard_normal((B, nc, H)).astype(np.float32)
    for steep in (1.0, 200.0):
        ins = [torch.from_numpy(a) for a in (xs, Bm, Cm, dt, da * steep)]
        cots = [torch.from_numpy(a) for a in (dy, dS, ddec)]
        got = ssd.ssd_intra_chunk_bwd_ref(*ins, *cots)
        want = ssd._plain_bwd(*ins, *cots)
        for name, g, w in zip(("xs", "Bm", "Cm", "dt", "da"), got, want):
            assert torch.isfinite(g).all(), name
            if steep == 1.0 or name != "da":
                assert _rel_err(g.numpy(), w.numpy()) <= GRAD_TOL, (name,
                                                                    steep)


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,causal", [(1, 256, 4, True),
                                          (2, 320, 2, True),
                                          (1, 1000, 8, True),
                                          (2, 200, 3, True),
                                          (1, 333, 4, False),
                                          (1, 2048, 16, True)])
def test_mla_backward_kernel_matches_plain_on_card(cuda_device, B, S, H,
                                                   causal):
    """B4m through the autograd Function (prefill_wgmma at (192, 128) with
    the logsumexp, then flash_attention_bwd) against autograd through the
    plain version, MLA's scale: dq, dk, dv each within TRAIN_TOL of its
    max|ref|; k and v strided views of one tensor as MLA builds them; two
    calls of the backward give the same bits."""
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                   for a in _mla_qkv(B, S, H, seed=S))
    kv = torch.cat([k, v], dim=-1)              # (B, S, H, 320)
    k, v = kv[..., :192], kv[..., 192:]
    scale = 192 ** -0.5
    leaves = [a.detach().clone().requires_grad_(True) for a in (q, k, v)]
    n0 = flash.flash_attention_bwd.launches_by_dims[(192, 128)]
    out = flash.flash_attention(*leaves, causal=causal, scale=scale)
    out.backward(do)
    torch.cuda.synchronize()
    assert flash.flash_attention_bwd.launches_by_dims[(192, 128)] == n0 + 1
    refs = flash.flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                         scale=scale)
    for name, leaf, ref in zip("qkv", leaves, refs):
        err = (leaf.grad.float() - ref.float()).abs().max().item()
        assert err <= TRAIN_TOL * ref.float().abs().max().item(), (name, err)
    lse = torch.empty((B, H, S), device=cuda_device)
    o = flash._launch(q, k, v, causal, 0, None, scale, sms=1, lse=lse)[0]
    first, again = (flash.flash_attention_bwd(q, k, v, o, do, lse,
                                              causal=causal, scale=scale)
                    for _ in range(2))
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", first, again):
        assert torch.equal(a, b), f"d{name} differs between two calls"


# (dtype, q/k head dim, v head dim, B, S, H, Hkv, causal): B4f at every
# pair, causal and not, GQA 4 and 1; B4 in bf16 at (64, 64) (wgmma) and
# (16, 16) (mma.sync).  S a multiple of 64, of 16 only, and of neither.
BWD_CARD_CASES = [
    (torch.float32, 16, 16, 2, 200, 8, 2, True),
    (torch.float32, 16, 16, 1, 100, 4, 4, False),
    (torch.float32, 64, 64, 1, 333, 8, 2, True),
    (torch.float32, 80, 80, 1, 300, 4, 4, False),
    (torch.float32, 80, 80, 2, 128, 8, 2, True),
    (torch.float32, 128, 128, 2, 256, 8, 2, True),
    (torch.float32, 128, 128, 1, 1000, 4, 1, False),
    (torch.float32, 192, 128, 1, 260, 4, 4, True),
    (torch.float32, 192, 128, 1, 130, 2, 2, False),
    (torch.bfloat16, 64, 64, 2, 320, 8, 2, True),
    (torch.bfloat16, 64, 64, 1, 333, 4, 4, False),
    (torch.bfloat16, 16, 16, 2, 200, 8, 2, True),
    (torch.bfloat16, 16, 16, 1, 100, 4, 4, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BWD_CARD_CASES, ids=str)
def test_backward_kernels_at_trainer_defaults_match_plain_on_card(
        cuda_device, case):
    """The autograd Function on the card at the pairs the trainer's
    defaults reach (fp32 everywhere, head dim 16) and bf16 (64, 64): the
    prefill kernel of the dtype with the logsumexp (within 1e-4 of the
    plain one's), then one launch of ``bwd_kernel``'s kernels; dq, dk, dv
    each within 1e-4 (fp32: 3xTF32 products) or TRAIN_TOL (bf16: P and dS
    rounded) of its max|ref| against autograd through the plain version;
    two calls of the backward give the same bits."""
    dtype, hd, hv, B, S, H, Hkv, causal = case
    tol = 1e-4 if dtype == torch.float32 else TRAIN_TOL
    rng = np.random.default_rng(hd + S)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, dtype)

    q, k, v = t((B, S, H, hd)), t((B, S, Hkv, hd)), t((B, S, Hkv, hv))
    do = t((B, S, H, hv))
    kernel = flash.bwd_kernel(dtype, hd)
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    n0 = dict(flash.flash_attention_bwd.launches_by_kernel)
    out = flash.flash_attention(*leaves, causal=causal)
    out.backward(do)
    torch.cuda.synchronize()
    moved = {n: c - n0[n] for n, c in
             flash.flash_attention_bwd.launches_by_kernel.items()}
    assert moved == {n: int(n == kernel) for n in flash.BWD_KERNELS}
    refs = flash.flash_attention_bwd_ref(q, k, v, do, causal=causal)
    for name, leaf, ref in zip("qkv", leaves, refs):
        assert leaf.grad.dtype == dtype
        err = (leaf.grad.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item(), (name, err)
    lse = torch.empty((B, H, S), device=cuda_device)
    o = flash._launch(q, k, v, causal, 0, None, None, sms=1, lse=lse)[0]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float().repeat_interleave(
        H // Hkv, dim=2)) * hd ** -0.5
    if causal:
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool,
                                     device=cuda_device).triu(1), -torch.inf)
    ref_lse = torch.logsumexp(s, dim=-1)
    assert (lse - ref_lse).abs().max().item() <= \
        1e-4 * ref_lse.abs().max().item()
    first, again = (flash.flash_attention_bwd(q, k, v, o, do, lse,
                                              causal=causal)
                    for _ in range(2))
    torch.cuda.synchronize()
    for name, a, b in zip("qkv", first, again):
        assert torch.equal(a, b), f"d{name} differs between two calls"


SSD_CARD_SHAPES = [(1, 4, 128, 8, 64, 16), (2, 3, 16, 4, 16, 16),
                   (1, 2, 100, 3, 64, 16), (1, 2, 128, 4, 64, 128),
                   (2, 2, 100, 3, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_CARD_SHAPES, ids=str)
def test_ssd_backward_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    """B5 against the closed form and against autograd through the plain
    forward, on the same inputs, with cotangents of y, S and the decay:
    Jamba's chunk (Q 128, P 64, N 16), the reduced one, a ragged Q, and
    Mamba2-130M's (P 64, N 128) whole and ragged;
    each gradient within 1e-4 (fp32 inputs) or TRAIN_TOL (bf16) of its
    max|ref|; a steep decay gives no NaN (and there, as on the CPU, da's
    gradient is held to finiteness only)."""
    tol = 1e-4 if dtype == torch.float32 else TRAIN_TOL
    B, nc, Q, H, P, N = shape
    (xs, Bm, Cm, dt, da, _), (dy, _) = _ssd_inputs(*shape, seed=5)
    rng = np.random.default_rng(6)
    dS = rng.standard_normal((B, nc, H, N, P)).astype(np.float32)
    ddec = rng.standard_normal((B, nc, H)).astype(np.float32)
    for steep in (1.0, 200.0):
        ins = [torch.from_numpy(a).to(cuda_device) for a in
               (xs, Bm, Cm, dt, da * steep)]
        ins[:3] = [a.to(dtype) for a in ins[:3]]
        cots = [torch.from_numpy(a).to(cuda_device) for a in (dy, dS, ddec)]
        n0 = ssd.ssd_intra_chunk_bwd.launches
        got = ssd.ssd_intra_chunk_bwd(*ins, *cots)
        torch.cuda.synchronize()
        assert ssd.ssd_intra_chunk_bwd.launches == n0 + 1
        for ref in (ssd.ssd_intra_chunk_bwd_ref(*ins, *cots),
                    ssd._plain_bwd(*ins, *cots)):
            for name, g, r in zip(("xs", "Bm", "Cm", "dt", "da"), got, ref):
                assert g.dtype == r.dtype, name
                assert torch.isfinite(g).all(), name
                if steep != 1.0 and name == "da":
                    continue
                err = (g.float() - r.float()).abs().max().item()
                assert err <= tol * r.float().abs().max().item(), (
                    name, steep, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SSD_CARD_SHAPES, ids=str)
def test_ssd_backward_kernel_is_bitwise_deterministic_on_card(cuda_device,
                                                              dtype, shape):
    """B5 gives the same bits on two calls with the same inputs (every sum
    in a fixed order, no atomics)."""
    B, nc, Q, H, P, N = shape
    (xs, Bm, Cm, dt, da, _), (dy, _) = _ssd_inputs(*shape, seed=7)
    rng = np.random.default_rng(8)
    dS = rng.standard_normal((B, nc, H, N, P)).astype(np.float32)
    ddec = rng.standard_normal((B, nc, H)).astype(np.float32)
    ins = [torch.from_numpy(a).to(cuda_device) for a in (xs, Bm, Cm, dt, da)]
    ins[:3] = [a.to(dtype) for a in ins[:3]]
    cots = [torch.from_numpy(a).to(cuda_device) for a in (dy, dS, ddec)]
    first, again = (ssd.ssd_intra_chunk_bwd(*ins, *cots) for _ in range(2))
    torch.cuda.synchronize()
    for name, a, b in zip(("xs", "Bm", "Cm", "dt", "da"), first, again):
        assert torch.equal(a, b), f"d{name} differs between two calls"


@pytest.mark.cuda
def test_ssd_backward_refuses_what_it_does_not_take_on_card(cuda_device):
    """fp16 inputs, fp32 xs with bf16 B, and a head dim outside BWD_DIMS
    raise before any launch."""
    def t(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=cuda_device)

    B, nc, Q, H = 1, 1, 16, 2
    dt = t((B, nc, Q, H))
    n0 = ssd.ssd_intra_chunk_bwd.launches
    for P, N, dx, db in [(64, 16, torch.float16, torch.float16),
                         (64, 16, torch.float32, torch.bfloat16),
                         (32, 16, torch.float32, torch.float32)]:
        with pytest.raises((TypeError, ValueError)):
            ssd.ssd_intra_chunk_bwd(
                t((B, nc, Q, H, P), dx), t((B, nc, Q, H, N), db),
                t((B, nc, Q, H, N), db), dt, dt, t((B, nc, Q, H, P)),
                t((B, nc, H, N, P)), t((B, nc, H)))
    assert ssd.ssd_intra_chunk_bwd.launches == n0


def test_plain_backwards_in_groups_equal_whole(monkeypatch):
    """The plain backwards that the card's kernels are checked against
    run over groups of slots (grouped GEMMs) and of KV heads (flash) to
    bound their fp32 temporaries: one slot / one head a group gives the
    gradients of one group of all, within 1e-6 of each max|ref| (a batched
    product may block a smaller batch differently)."""
    from repro_torch.kernels.grouped_gemm import ops as gg

    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x, w1, w3, dact = t(5, 6, 8), t(5, 8, 4), t(5, 8, 4), t(5, 6, 4)
    rows = torch.tensor([6, 3, 0, 1, 6])
    q, k, v, do = t(2, 33, 4, 16), t(2, 33, 2, 16), t(2, 33, 2, 8), \
        t(2, 33, 4, 8)
    whole = (gg._plain_grads(gg.grouped_swiglu_ref, (x, w1, w3),
                             (True, True, True), dact, rows),
             flash.flash_attention_bwd_ref(q, k, v, do, causal=True))
    monkeypatch.setattr(gg, "_PLAIN_BWD_BYTES", 1)
    monkeypatch.setattr(flash, "_REF_BWD_BYTES", 1)
    split = (gg._plain_grads(gg.grouped_swiglu_ref, (x, w1, w3),
                             (True, True, True), dact, rows),
             flash.flash_attention_bwd_ref(q, k, v, do, causal=True))
    for a, b in zip(whole[0] + list(whole[1]), split[0] + list(split[1])):
        assert _rel_err(b.numpy(), a.numpy()) <= 1e-6

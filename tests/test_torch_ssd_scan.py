"""SSD chunk scan: the port's plain versions vs the JAX oracle and the Pallas
kernel (interpret mode), and the CUDA kernel vs its plain version on a card.

CPU tolerance: rtol = atol = 3e-4, the JAX suite's own for this kernel
(``tests/test_kernels.py``): the frameworks sum and scan in different
orders.  Card tolerance: max|err| <= 3e-4 * max|ref| (the kernel's split
bf16 products keep each term to about 2^-17, other summation orders); bf16
inputs are cast to fp32 by both.  The kernel's products are also modelled
on the CPU, to show the split is within that tolerance and one rounding of
W is not, and so are the backward kernel's (within the card's 1e-4 of
``tests/test_torch_train_kernels.py``; one rounding of dY or W not).

The JAX side is imported inside the tests that use it, so the card tests
also run where JAX is not installed:
  PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
      tests/test_torch_ssd_scan.py
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ops

TOL = 3e-4
SHAPES = [(1, 2, 16, 2, 8, 16), (2, 4, 32, 4, 16, 8), (1, 2, 8, 2, 4, 8)]


def _inputs(B, nc, Q, H, P, N, seed=0):
    """xs, Bm, Cm ~ N(0, 0.25); dt = softplus(N(0, 1)); da = -0.4 dt;
    an initial state ~ N(0, 1) (the JAX suite's recipe, from numpy)."""
    rng = np.random.default_rng(seed)
    xs = (rng.standard_normal((B, nc, Q, H, P)) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((B, nc, Q, H, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, nc, Q, H, N)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, nc, Q, H)))).astype(
        np.float32)
    da = (-dt * 0.4).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return xs, Bm, Cm, dt, da, s0


def _close(t, j):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_intra_chunk_plain_matches_pallas_interpret(shape):
    import jax.numpy as jnp

    from repro.kernels.ssd_scan.kernel import ssd_intra_chunk_pallas

    arrs = _inputs(*shape)[:5]
    got = ops.ssd_intra_chunk(*map(torch.from_numpy, arrs))
    want = ssd_intra_chunk_pallas(*map(jnp.asarray, arrs), interpret=True)
    for t, j in zip(got, want):
        _close(t.numpy(), j)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_chunk_scan_matches_jax(shape, with_state):
    import jax.numpy as jnp

    from repro.kernels.ssd_scan.ops import ssd_chunk_scan as j_scan
    from repro.kernels.ssd_scan.ref import ssd_chunk_ref as j_ref

    *arrs, s0 = _inputs(*shape, seed=1)
    init = s0 if with_state else None
    jargs = [jnp.asarray(a) for a in arrs]
    jinit = None if init is None else jnp.asarray(init)
    targs = [torch.from_numpy(a) for a in arrs]
    tinit = None if init is None else torch.from_numpy(init)
    before = ops.ssd_intra_chunk.launches
    outs = [ops.ssd_chunk_scan(*targs, initial_state=tinit),
            ops.ssd_chunk_scan_ref(*targs, initial_state=tinit)]
    # A CPU tensor runs the plain version: no kernel launch is counted.
    assert ops.ssd_intra_chunk.launches == before
    for want in (j_scan(*jargs, initial_state=jinit),
                 j_ref(*jargs, initial_state=jinit)):
        for y, fin in outs:
            _close(y.numpy(), want[0])
            _close(fin.numpy(), want[1])


def test_wrapper_refuses_other_devices():
    x = torch.empty((1, 1, 4, 1, 4), device="meta")
    d = torch.empty((1, 1, 4, 1), device="meta")
    with pytest.raises(ValueError):
        ops.ssd_intra_chunk(x, x, x, d, d)


def _bf16(t):
    """Round to the nearest bf16 value, kept in fp32."""
    return t.to(torch.bfloat16).to(torch.float32)


def _tf32(t):
    """TF32 as the tensor core reads an fp32 operand: the 13 low mantissa
    bits cleared."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(t, rnd):
    hi = rnd(t)
    return hi, rnd(t - hi)


def _kernel_products(xs, Bm, Cm, dt, da, rnd, parts):
    """y and S as the kernel forms them, in fp32 on the CPU: C.B exact for
    bf16 inputs (split hi + lo for fp32 ones), W = C.B exp(cum_i - cum_j)
    dt_j masked before exp, the exp as the kernel's ex2.approx.ftz takes it
    (2^(d log2 e), results below 2^-126 flushed to 0), then W x with W
    rounded by ``rnd`` once (``parts`` 1) or split hi + lo (``parts`` 2:
    W_hi x + W_lo x, and for fp32 x also W_hi x_lo), and the chunk state
    the same way.  Not modelled: ex2.approx's own 2^-22 error and the
    tensor core's order of summation, both far below the split's 2^-17."""
    exact = Bm.dtype == torch.bfloat16
    x, b, c = (t.float() for t in (xs, Bm, Cm))
    Q = x.shape[2]

    def mm(eq, a, v):
        if parts == 1:
            return torch.einsum(eq, rnd(a), rnd(v))
        ah, al = _split(a, rnd)
        vh, vl = (v, torch.zeros_like(v)) if exact else _split(v, rnd)
        return (torch.einsum(eq, ah, vh) + torch.einsum(eq, al, vh)
                + torch.einsum(eq, ah, vl))

    cb = (torch.einsum("bcqhn,bckhn->bcqkh", c, b) if exact
          else mm("bcqhn,bckhn->bcqkh", c, b))
    cum = torch.cumsum(da.float(), dim=2)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = torch.ones((Q, Q), dtype=torch.bool).tril()[None, None, :, :, None]
    e = torch.exp2(diff.masked_fill(~mask, float("-inf")) * math.log2(math.e))
    e = torch.where(e < 2.0 ** -126, torch.zeros_like(e), e)
    w = cb * e * dt[:, :, None, :, :]
    y = mm("bcqkh,bckhp->bcqhp", w, x)
    wj = torch.exp(cum[:, :, -1:, :] - cum) * dt
    S = mm("bcqhn,bcqhp->bchnp", b * wj[..., None], x)
    return y, S


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_split_products_stay_within_tolerance(dtype):
    """At a Jamba-like chunk (Q 128, P 64, N 16) the kernel's split bf16
    products, and split TF32 ones, are within SSD_TOL of the fp32 plain
    version; one TF32 product (W and x each rounded once, as a tensor core
    reads fp32 operands) and one bf16 rounding of W are not, which is why
    the kernel splits."""
    arrs = _inputs(1, 2, 128, 4, 64, 16, seed=7)[:5]
    xs, Bm, Cm, dt, da = map(torch.from_numpy, arrs)
    xs, Bm, Cm = (t.to(dtype) for t in (xs, Bm, Cm))
    y_ref, S_ref, _ = ops.ssd_intra_chunk_ref(xs, Bm, Cm, dt, da)

    def rel(out, ref):
        return ((out - ref).abs().max() / ref.abs().max()).item()

    for rnd in (_bf16, _tf32):
        y, S = _kernel_products(xs, Bm, Cm, dt, da, rnd, parts=2)
        assert rel(y, y_ref) <= TOL / 3 and rel(S, S_ref) <= TOL / 3
    for rnd in (_bf16, _tf32):
        y, _ = _kernel_products(xs, Bm, Cm, dt, da, rnd, parts=1)
        assert rel(y, y_ref) > TOL


def _parts(t, how):
    """An operand as the backward kernel feeds it to the tensor cores:
    [(part, is_lo)], exact (a bf16 input), rounded to bf16 once, or split
    into bf16 hi + lo."""
    if how == "exact":
        return [(t, False)]
    if how == "once":
        return [(_bf16(t), False)]
    hi, lo = _split(t, _bf16)
    return [(hi, False), (lo, True)]


def _mm(eq, a, b):
    """A product of two operands' parts, accumulated in fp32, without the
    lo x lo term."""
    return sum(torch.einsum(eq, p, q) for p, lp in a for q, lq in b
               if not (lp and lq))


def _bwd_kernel_model(xs, Bm, Cm, dt, da, dy, dS, ddec, once=None):
    """(dx, dB, dC, ddt, dda) as the backward kernel forms them, in fp32 on
    the CPU: every product on bf16 operands (mma.sync m16n8k16) with fp32
    accumulation; bf16 x, B, C exact, fp32 ones and every fp32 operand
    (dY, dS, W, G and the chunk state's w_j B_j) split hi + lo; the decay
    as ex2.approx.ftz takes it; dcum's column term as dt_j times ddt's
    (the kernel sums dW C.B L once for both).  ``once``: "dy" or "w"
    rounds that operand to bf16 once instead of splitting it."""
    inp = "exact" if xs.dtype == torch.bfloat16 else "split"
    x, b, c = (t.float() for t in (xs, Bm, Cm))
    X, Bp, Cp = (_parts(t, inp) for t in (x, b, c))
    DY = _parts(dy, "once" if once == "dy" else "split")
    DS = _parts(dS, "split")
    Q = x.shape[2]
    cum = torch.cumsum(da, dim=2)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = torch.ones((Q, Q), dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.exp2(diff.masked_fill(~mask, float("-inf")) * math.log2(math.e))
    L = torch.where(L < 2.0 ** -126, torch.zeros_like(L), L)
    cb = _mm("bcqhn,bckhn->bcqkh", Cp, Bp)
    dW = _mm("bcqhp,bckhp->bcqkh", DY, X)
    Ld = L * dt[:, :, None, :, :]
    W, G = cb * Ld, dW * Ld
    Wp = _parts(W, "once" if once == "w" else "split")
    Gp = _parts(G, "split")
    last = cum[:, :, -1:, :]
    ej = torch.exp(last - cum)
    wj = ej * dt
    dx = (_mm("bcqkh,bcqhp->bckhp", Wp, DY)
          + _mm("bcqhn,bchnp->bcqhp", _parts(b * wj[..., None], "split"),
                DS))
    u = _mm("bcqhp,bchnp->bcqhn", X, DS)
    dC = _mm("bcqkh,bckhn->bcqhn", Gp, Bp)
    dB = _mm("bcqkh,bcqhn->bckhn", Gp, Cp) + wj[..., None] * u
    dwj = (b * u).sum(-1)
    col = (dW * cb * L).sum(dim=2)
    dcum = (dW * W).sum(dim=3) - dt * col - dwj * wj
    dcum[:, :, -1] += (dwj * wj).sum(dim=2) + ddec * torch.exp(last[:, :, 0])
    dda = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    return dx, dB, dC, col + dwj * ej, dda


@pytest.mark.parametrize("once", [None, "dy", "w"],
                         ids=["split", "dy_once", "w_once"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_backward_split_products_stay_within_tolerance(dtype, once):
    """At Jamba's chunk (Q 128, P 64, N 16) the backward kernel's split
    bf16 products keep every gradient within 1e-4 of max|ref| of the
    closed form (the card test's tolerance with fp32 inputs), for both
    input dtypes (compared in fp32, before dx, dB, dC are rounded to the
    inputs' dtype); one bf16 rounding of dY or of W does not, which is why
    the kernel splits both."""
    B, nc, Q, H, P, N = 1, 2, 128, 4, 64, 16
    xs, Bm, Cm, dt, da, _ = (torch.from_numpy(a) for a in
                             _inputs(B, nc, Q, H, P, N, seed=5))
    rng = np.random.default_rng(6)
    dy, dS, ddec = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((B, nc, Q, H, P), (B, nc, H, N, P),
                               (B, nc, H)))
    xs, Bm, Cm = (t.to(dtype) for t in (xs, Bm, Cm))
    want = ops.ssd_intra_chunk_bwd_ref(xs.float(), Bm.float(), Cm.float(),
                                       dt, da, dy, dS, ddec)
    got = _bwd_kernel_model(xs, Bm, Cm, dt, da, dy, dS, ddec, once=once)
    errs = [((g - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]
    if once is None:
        assert max(errs) <= 1e-4, errs
    else:
        assert max(errs) > 1e-4, errs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel builds with nvcc for "
                    "sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES + [(2, 1, 13, 3, 6, 5),
                                            (1, 3, 128, 4, 64, 16),
                                            (1, 2, 64, 3, 80, 32),
                                            (1, 1, 256, 2, 64, 16)], ids=str)
def test_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    *arrs, s0 = _inputs(*shape, seed=2)
    xs, Bm, Cm, dt, da = (torch.from_numpy(a).to(cuda_device) for a in arrs)
    xs, Bm, Cm = (t.to(dtype) for t in (xs, Bm, Cm))
    init = torch.from_numpy(s0).to(cuda_device)
    before = ops.ssd_intra_chunk.launches
    got = ops.ssd_intra_chunk(xs, Bm, Cm, dt, da)
    got += ops.ssd_chunk_scan(xs, Bm, Cm, dt, da, initial_state=init)
    torch.cuda.synchronize()
    assert ops.ssd_intra_chunk.launches == before + 2
    want = ops.ssd_intra_chunk_ref(xs, Bm, Cm, dt, da)
    want += ops.ssd_chunk_scan_ref(xs, Bm, Cm, dt, da, initial_state=init)
    for out, ref in zip(got, want):
        err = (out - ref).abs().max().item()
        assert err <= TOL * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", ["jamba_width", "deep_underflow",
                                  "strided_view", "unaligned_view"])
def test_kernel_edge_cases_on_card(cuda_device, dtype, case):
    """The kernel at (1, 2, 128, 8, 64, 16); with strongly negative da
    (cum reaches about -1e4: exp underflows to 0 in every unmasked entry
    past the diagonal's neighbours, and the masked entries, whose exponent
    would be +1e4, must stay finite); on views whose rows lie inside wider
    rows, as the Mamba mixer's x does (16-byte aligned: the cp.async path);
    and on views shifted by one element (the element-load path)."""
    shape = (1, 2, 128, 8, 64, 16)
    *arrs, _ = _inputs(*shape, seed=9)
    xs, Bm, Cm, dt, da = (torch.from_numpy(a).to(cuda_device) for a in arrs)
    if case == "deep_underflow":
        da = -80.0 * dt
    if case in ("strided_view", "unaligned_view"):
        off = 8 if case == "strided_view" else 1

        def widen(t):
            n = t.shape[-1]
            wide = torch.zeros(t.shape[:-1] + (n + 24,), dtype=dtype,
                               device=cuda_device)
            wide[..., off:off + n] = t.to(dtype)
            return wide[..., off:off + n]

        xs, Bm, Cm = (widen(t) for t in (xs, Bm, Cm))
    else:
        xs, Bm, Cm = (t.to(dtype) for t in (xs, Bm, Cm))
    before = ops.ssd_intra_chunk.launches
    got = ops.ssd_intra_chunk(xs, Bm, Cm, dt, da)
    torch.cuda.synchronize()
    assert ops.ssd_intra_chunk.launches == before + 1
    want = ops.ssd_intra_chunk_ref(xs, Bm, Cm, dt, da)
    for out, ref in zip(got, want):
        assert torch.isfinite(out).all()
        err = (out - ref).abs().max().item()
        assert err <= TOL * ref.abs().max().item()

"""Grouped GEMM: the port's plain versions vs the JAX oracle and the Pallas
kernels (interpret mode), and the CUDA kernels vs the plain versions on a
card.

CPU tolerance: rtol 1e-5 in fp32 (the frameworks sum in different orders).
Card tolerances (fp32 kernels' 3xTF32 products vs fp32 einsum, TF32 off):
max|err| <= 1e-4 * max|ref|; bf16: max|err| <= 1e-2 * max|ref| (one bf16
rounding of the output).  The fp32 kernels' arithmetic is also modelled on
the CPU, to show it is within that tolerance of the JAX oracle at GLM's
contraction depths and one TF32 product is not.  The w8a8 pair: the matmul is exact (int32 sums, the same
dequant products in the same order), so it must equal the Pallas kernel on
the CPU and its plain version on the card bitwise; the SwiGLU may differ
in the gate's exp: rtol 1e-6 against Pallas (the JAX suite's own bound),
max|err| <= 1e-5 * max|ref| on the card.

The JAX side is imported inside the tests that use it, so the card test
also runs where JAX is not installed:
  PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
      tests/test_torch_grouped_gemm.py
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.grouped_gemm import ops

RTOL = 1e-5


def _inputs(G, M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((G, M, K)).astype(np.float32)
    w1 = (rng.standard_normal((G, K, N)) * K ** -0.5).astype(np.float32)
    w3 = (rng.standard_normal((G, K, N)) * K ** -0.5).astype(np.float32)
    return x, w1, w3


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=RTOL * float(np.abs(np.asarray(b)).max()))


@pytest.mark.parametrize("G,M,K,N", [(2, 128, 128, 128), (3, 8, 256, 128)])
def test_plain_versions_match_pallas_interpret(G, M, K, N):
    import jax.numpy as jnp

    from repro.kernels.grouped_gemm.kernel import (
        grouped_matmul_pallas,
        grouped_swiglu_pallas,
    )

    x, w1, w3 = _inputs(G, M, K, N)
    tx, tw1, tw3 = map(torch.from_numpy, (x, w1, w3))
    _close(ops.grouped_swiglu_ref(tx, tw1, tw3).numpy(),
           grouped_swiglu_pallas(jnp.asarray(x), jnp.asarray(w1),
                                 jnp.asarray(w3), bm=min(128, M),
                                 interpret=True))
    _close(ops.grouped_matmul_ref(tx, tw1).numpy(),
           grouped_matmul_pallas(jnp.asarray(x), jnp.asarray(w1),
                                 bm=min(128, M), interpret=True))


@pytest.mark.parametrize("G,M,K,N", [(1, 1, 1, 1), (2, 37, 70, 45),
                                     (4, 100, 200, 300)])
def test_wrappers_on_cpu_match_jax_oracle(G, M, K, N):
    import jax.numpy as jnp

    from repro.kernels.grouped_gemm.ref import grouped_matmul_ref as j_matmul
    from repro.kernels.grouped_gemm.ref import grouped_swiglu_ref as j_swiglu

    x, w1, w3 = _inputs(G, M, K, N, seed=1)
    tx, tw1, tw3 = map(torch.from_numpy, (x, w1, w3))
    before = (ops.grouped_swiglu.launches, ops.grouped_matmul.launches)
    _close(ops.grouped_swiglu(tx, tw1, tw3).numpy(),
           j_swiglu(jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w3)))
    _close(ops.grouped_matmul(tx, tw1).numpy(),
           j_matmul(jnp.asarray(x), jnp.asarray(w1)))
    # A CPU tensor runs the plain version: no kernel launch is counted.
    assert (ops.grouped_swiglu.launches, ops.grouped_matmul.launches) == before


# Counts per slot: empty, a partial tile, full (and a count past M, which
# means M).
@pytest.mark.parametrize("G,M,K,N,rows", [(3, 128, 128, 128, [0, 37, 128]),
                                          (4, 8, 256, 128, [0, 3, 8, 9])])
def test_plain_versions_with_rows_match_pallas_interpret(G, M, K, N, rows):
    """The Pallas kernels compute every row; on slot buffers whose rows
    past each count are zero (as the buckets build them) they give zeros
    there, which the plain versions with ``rows`` give by masking."""
    import jax.numpy as jnp

    from repro.kernels.grouped_gemm.kernel import (
        grouped_matmul_pallas,
        grouped_swiglu_pallas,
    )

    x, w1, w3 = _inputs(G, M, K, N, seed=4)
    for g, r in enumerate(rows):
        x[g, r:] = 0.0
    tx, tw1, tw3 = map(torch.from_numpy, (x, w1, w3))
    tr = torch.tensor(rows)
    _close(ops.grouped_swiglu_ref(tx, tw1, tw3, tr).numpy(),
           grouped_swiglu_pallas(jnp.asarray(x), jnp.asarray(w1),
                                 jnp.asarray(w3), bm=min(128, M),
                                 interpret=True))
    _close(ops.grouped_matmul_ref(tx, tw1, tr).numpy(),
           grouped_matmul_pallas(jnp.asarray(x), jnp.asarray(w1),
                                 bm=min(128, M), interpret=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows_dtype", [torch.int32, torch.int64])
def test_wrappers_zero_rows_past_count(dtype, rows_dtype):
    """Rows at or past the count come out as exact zeros whatever x holds
    there (NaN and inf too); the rows before it are those of the unmasked
    call."""
    G, M, K, N = 4, 40, 24, 16
    x, w1, w3 = (torch.from_numpy(a).to(dtype)
                 for a in _inputs(G, M, K, N, seed=5))
    rows = torch.tensor([0, 17, 40, 1], dtype=rows_dtype)
    junk = x.clone()
    for g, r in enumerate(rows.tolist()):
        junk[g, r:] = torch.tensor([float("nan"), float("inf")] * (K // 2),
                                   dtype=dtype)
    for masked, plain in (
            (ops.grouped_swiglu(junk, w1, w3, rows),
             ops.grouped_swiglu(x, w1, w3)),
            (ops.grouped_matmul(junk, w1, rows), ops.grouped_matmul(x, w1))):
        assert masked.dtype == dtype and masked.shape == (G, M, N)
        for g, r in enumerate(rows.tolist()):
            assert torch.equal(masked[g, :r], plain[g, :r])
            assert torch.equal(masked[g, r:], torch.zeros_like(masked[g, r:]))


@pytest.mark.parametrize("dual", [False, True])
def test_matmul_nt_train_call_on_cpu_is_the_public_call(dual):
    """``grouped_matmul_nt(..., zero_padded=False)`` (the autograd
    backward's dgrad) on the CPU: the plain version, the public call's bits
    (rows past the count zero), whatever the operands' padded rows hold."""
    G, M, K, N = 3, 70, 24, 40
    rng = np.random.default_rng(9)
    x, x2 = (torch.from_numpy(rng.standard_normal((G, M, K)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    w, w2 = (torch.from_numpy(rng.standard_normal((G, N, K)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    rows = torch.tensor([0, 33, 70])
    pad = torch.arange(M)[None, :, None] >= rows[:, None, None]
    x = torch.where(pad, float("nan"), x.float()).to(torch.bfloat16)
    extra = (x2, w2) if dual else ()
    got = ops.grouped_matmul_nt(x, w, rows, *extra, zero_padded=False)
    want = ops.grouped_matmul_nt(x, w, rows, *extra)
    assert torch.equal(got, want)
    assert torch.equal(want, ops.grouped_matmul_nt_ref(x, w, rows, *extra))
    assert torch.all(torch.where(pad, want.float(), 0.0) == 0)


def test_tma_operand_helpers():
    """What the bf16 launch does before it touches a card: which operands
    TMA can read as they are, the zero-padded copy of one it cannot, and
    the strides handed to the tensor maps."""
    x = torch.randn(2, 65, 33).to(torch.bfloat16)     # rows 66 bytes apart
    assert not ops._tma_ready(x)
    xp = ops._padded_copy(x)
    assert xp.shape == x.shape and xp.stride() == (65 * 40, 40, 1)
    assert torch.equal(xp, x) and ops._tma_ready(xp)
    assert not xp._base[..., 33:].any()
    assert ops._tma_ready(torch.zeros(3, 1009, 136, dtype=torch.bfloat16))
    assert ops._tma_ready(torch.zeros(1, 1, 64, dtype=torch.bfloat16))
    assert not ops._tma_ready(torch.zeros(1, 1, 45, dtype=torch.bfloat16))
    assert not ops._tma_ready(torch.zeros(3, 16, 40, dtype=torch.bfloat16)
                              [:, :, 1:])                 # starts mid-row
    assert not ops._tma_ready(torch.zeros(1, 16, 8).expand(3, 16, 8))


def test_tma_operand_helpers_fp32():
    """The same rule for fp32 operands: rows 16 bytes (4 floats) apart and a
    16-byte base, or a padded copy; the output row rounded up to 16 bytes
    (4 fp32, 8 bf16)."""
    x = torch.randn(2, 33, 70)                         # rows 280 bytes apart
    assert not ops._tma_ready(x)
    xp = ops._padded_copy(x)
    assert xp.shape == x.shape and xp.stride() == (33 * 72, 72, 1)
    assert torch.equal(xp, x) and ops._tma_ready(xp)
    assert not xp._base[..., 70:].any()
    assert not ops._tma_ready(torch.zeros(2, 70, 45))  # rows 180 bytes
    assert ops._tma_ready(torch.zeros(130, 1009, 4096))
    assert ops._tma_ready(torch.zeros(130, 4096, 1408))
    assert not ops._tma_ready(torch.zeros(3, 16, 8)[:, :, 1:])
    assert ops._tma_ready(torch.zeros(3, 16, 12)[:, :, 4:])
    assert [ops._out_width(n, 4) for n in (1, 45, 1408)] == [4, 48, 1408]
    assert [ops._out_width(n, 2) for n in (1, 129, 4096)] == [8, 136, 4096]


def _tf32(t):
    """TF32 as the tensor core reads an fp32 operand: the 13 low mantissa
    bits cleared."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _kernel_products(x, w, split):
    """x (G, M, K) @ w (G, K, N) in the fp32 kernels' arithmetic on the CPU:
    the products of each 32-deep K tile summed apart, the tiles' sums added
    in fp32 in order; with ``split`` 3xTF32 (a = a_hi + a_lo, a_hi the TF32
    part: a_lo b_hi + a_hi b_lo + a_hi b_hi, a_lo b_lo dropped), else one
    TF32 product."""
    acc = torch.zeros(x.shape[0], x.shape[1], w.shape[2])
    for k0 in range(0, x.shape[2], 32):
        a, b = x[:, :, k0:k0 + 32], w[:, k0:k0 + 32]
        ah, bh = _tf32(a), _tf32(b)
        part = torch.einsum("gmk,gkn->gmn", ah, bh)
        if split:
            part = (torch.einsum("gmk,gkn->gmn", _tf32(a - ah), bh)
                    + torch.einsum("gmk,gkn->gmn", ah, _tf32(b - bh)) + part)
        acc += part
    return acc


# GLM-4.5-Air's depths: the SwiGLU contracts d_model 4096, the matmul d_ff
# 1408; narrow slots and columns keep the interpreted oracle quick.
F32_DEPTHS = [("swiglu", 4096), ("matmul", 1408)]


@functools.lru_cache(maxsize=None)
def _f32_case(op, K):
    """Inputs from a seed, the JAX oracle (the Pallas kernel in interpret
    mode, fp32) and the kernels' arithmetic with and without the split."""
    import jax.numpy as jnp

    from repro.kernels.grouped_gemm.kernel import (
        grouped_matmul_pallas,
        grouped_swiglu_pallas,
    )

    G, M, N = 2, 16, 128
    x, w1, w3 = _inputs(G, M, K, N, seed=14)
    tx, tw1, tw3 = map(torch.from_numpy, (x, w1, w3))
    if op == "swiglu":
        want = grouped_swiglu_pallas(jnp.asarray(x), jnp.asarray(w1),
                                     jnp.asarray(w3), bk=512, interpret=True)
        got = [F.silu(_kernel_products(tx, tw1, s)) * _kernel_products(
            tx, tw3, s) for s in (True, False)]
    else:
        want = grouped_matmul_pallas(jnp.asarray(x), jnp.asarray(w1), bk=128,
                                     interpret=True)
        got = [_kernel_products(tx, tw1, s) for s in (True, False)]
    want = np.asarray(want)
    return [float(np.abs(g.numpy() - want).max() / np.abs(want).max())
            for g in got]


@pytest.mark.parametrize("op,K", F32_DEPTHS)
def test_3xtf32_products_stay_within_tolerance(op, K):
    """The fp32 kernels' 3xTF32 products, summed per 32-deep K tile, are
    within the card tolerance (1e-4 of max|ref|) of the Pallas kernel, with
    a margin."""
    split, _ = _f32_case(op, K)
    assert split <= 1e-5


@pytest.mark.parametrize("op,K", F32_DEPTHS)
def test_one_tf32_product_misses_tolerance(op, K):
    """One TF32 product (each operand truncated to 10 mantissa bits, as the
    tensor core reads fp32) misses the 1e-4 tolerance: why the kernels
    split."""
    _, one = _f32_case(op, K)
    assert one > 1e-4


def test_wrappers_check_rows():
    """A (G,) int32/int64 tensor on x's device, checked before launch."""
    x, w = torch.zeros((2, 4, 8)), torch.zeros((2, 8, 4))
    for rows in (torch.zeros(3, dtype=torch.int64), torch.zeros(2),
                 torch.zeros((2, 1), dtype=torch.int32)):
        with pytest.raises(ValueError, match="rows"):
            ops._launch(x, w, None, rows, swiglu=False)


def test_wrappers_refuse_other_devices():
    x = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(ValueError):
        ops.grouped_matmul(x, x)
    with pytest.raises(ValueError):
        ops.grouped_swiglu(x, x, x)
    q = torch.empty((1, 4, 4), dtype=torch.int8, device="meta")
    s = torch.empty((1, 4), device="meta")
    with pytest.raises(ValueError):
        ops.grouped_matmul_q8(q, s, q, s)
    with pytest.raises(ValueError):
        ops.grouped_swiglu_q8(q, s, q, s, q, s)


def _q8_inputs(G, M, K, N, seed=0):
    """int8 codes in [-127, 127] (some rows all zero, scale 0) and positive
    fp32 scales: activations (G, M, K), three weights (G, K, N)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (G, M, K), dtype=np.int8)
    q[:, ::7] = 0
    rs = rng.uniform(0.001, 0.05, (G, M)).astype(np.float32)
    rs[:, ::7] = 0.0
    ws = [rng.integers(-127, 128, (G, K, N), dtype=np.int8) for _ in range(3)]
    ss = [rng.uniform(1e-4, 2e-3, (G, N)).astype(np.float32)
          for _ in range(3)]
    return q, rs, ws, ss


@pytest.mark.parametrize("G,M,K,N", [(2, 128, 128, 128), (3, 32, 256, 128)])
def test_q8_plain_versions_match_pallas_interpret(G, M, K, N):
    import jax.numpy as jnp

    from repro.kernels.grouped_gemm.kernel import (
        grouped_matmul_q8_pallas,
        grouped_swiglu_q8_pallas,
    )

    q, rs, (w1, w3, _), (s1, s3, _) = _q8_inputs(G, M, K, N)
    t = [torch.from_numpy(a) for a in (q, rs, w1, s1, w3, s3)]
    j = [jnp.asarray(a) for a in (q, rs, w1, s1, w3, s3)]
    before = (ops.grouped_swiglu_q8.launches, ops.grouped_matmul_q8.launches)
    got = ops.grouped_matmul_q8(*t[:4]).numpy()
    want = np.asarray(grouped_matmul_q8_pallas(*j[:4], bm=min(128, M),
                                               interpret=True))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_allclose(
        ops.grouped_swiglu_q8(*t).numpy(),
        np.asarray(grouped_swiglu_q8_pallas(*j, bm=min(128, M),
                                            interpret=True)),
        rtol=1e-6, atol=1e-6)
    # A CPU tensor runs the plain version: no kernel launch is counted.
    assert (ops.grouped_swiglu_q8.launches,
            ops.grouped_matmul_q8.launches) == before


# Counts per slot: empty, one that straddles a 128-row tile, M, above M.
@pytest.mark.parametrize("G,M,K,N,rows", [(4, 256, 128, 128, [0, 130, 256, 300]),
                                          (4, 32, 256, 128, [0, 17, 32, 40])])
def test_q8_plain_versions_with_rows_match_pallas_interpret(G, M, K, N, rows):
    """The Pallas kernels compute every row; with the codes and scales of
    each slot's padded rows zeroed and their output masked they give what
    the plain versions with ``rows`` give from junk there (random codes,
    NaN row scales): the matmul bitwise, the SwiGLU within 1e-5."""
    import jax.numpy as jnp

    from repro.kernels.grouped_gemm.kernel import (
        grouped_matmul_q8_pallas,
        grouped_swiglu_q8_pallas,
    )

    q, rs, (w1, w3, _), (s1, s3, _) = _q8_inputs(G, M, K, N, seed=9)
    valid = np.arange(M)[None, :] < np.asarray(rows)[:, None]
    junk_rs = np.where(valid, rs, np.float32("nan"))
    jq = jnp.asarray(np.where(valid[:, :, None], q, 0).astype(np.int8))
    jrs = jnp.asarray(np.where(valid, rs, 0).astype(np.float32))
    j = [jq, jrs] + [jnp.asarray(a) for a in (w1, s1, w3, s3)]
    t = [torch.from_numpy(a) for a in (q, junk_rs, w1, s1, w3, s3)]
    tr = torch.tensor(rows)
    mask = valid[:, :, None]
    got = ops.grouped_matmul_q8(*t[:4], rows=tr).numpy()
    want = np.where(mask, np.asarray(grouped_matmul_q8_pallas(
        *j[:4], bm=min(128, M), interpret=True)), np.float32(0))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    got = ops.grouped_swiglu_q8(*t, rows=tr).numpy()
    want = np.where(mask, np.asarray(grouped_swiglu_q8_pallas(
        *j, bm=min(128, M), interpret=True)), np.float32(0))
    assert not got[~valid].any()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("rows", [None, [0, 3, 8]])
def test_q8_matmul_bf16_output_is_the_fp32_result_cast(rows):
    """``out_dtype=torch.bfloat16`` is the fp32 result rounded to bf16,
    bitwise (the cast the expert FFN used to do after the kernel)."""
    q, rs, (w, _, _), (s, _, _) = _q8_inputs(3, 8, 64, 24, seed=10)
    t = [torch.from_numpy(a) for a in (q, rs, w, s)]
    tr = None if rows is None else torch.tensor(rows)
    got = ops.grouped_matmul_q8(*t, rows=tr, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16),
                       ops.grouped_matmul_q8(*t, rows=tr)
                       .to(torch.bfloat16).view(torch.int16))


def test_q8_wrappers_check_rows():
    """A (G,) int32/int64 tensor on q's device, and an fp32 (matmul: or
    bf16) output, checked before launch."""
    q = torch.zeros((2, 4, 16), dtype=torch.int8)
    s = torch.zeros((2, 4))
    w = torch.zeros((2, 8, 16), dtype=torch.int8).transpose(1, 2)
    ws = torch.zeros((2, 8))
    for rows in (torch.zeros(3, dtype=torch.int64), torch.zeros(2),
                 torch.zeros((2, 1), dtype=torch.int32)):
        with pytest.raises(ValueError, match="rows"):
            ops._launch_q8(q, s, w, ws, None, None, rows, swiglu=False)
        with pytest.raises(ValueError, match="rows"):
            ops._launch_q8(q, s, w, ws, w, ws, rows, swiglu=True)
    with pytest.raises(TypeError, match="output dtype"):
        ops._launch_q8(q, s, w, ws, None, None, None, torch.float16,
                       swiglu=False)
    with pytest.raises(TypeError, match="output dtype"):
        ops._launch_q8(q, s, w, ws, w, ws, None, torch.bfloat16, swiglu=True)


def test_q8_operand_helpers():
    """What the q8 launch does before it touches a card: which int8
    operands TMA reads as they are (contiguous codes, the bucket's wire rows
    padded to 16 bytes) and the padded copy of the rest (a view of unpadded
    int8 wire rows, D + 4 bytes apart, or a K that is not 16-byte)."""
    wire = torch.zeros(3, 1009, 4100, dtype=torch.int8)[..., :-4]
    assert not ops._tma_ready(wire)
    wp = ops._padded_copy(wire)
    assert wp.stride() == (1009 * 4096, 4096, 1) and ops._tma_ready(wp)
    assert torch.equal(wp, wire)
    bucket = torch.zeros(3, 1009, 4112, dtype=torch.int8)[..., :4096]
    assert ops._tma_ready(bucket)
    q = torch.zeros(3, 1009, 4096, dtype=torch.int8)
    assert ops._tma_ready(q)
    w = torch.zeros(2, 200, 136, dtype=torch.int8)     # K 136: not 16-byte
    assert not ops._tma_ready(w)
    wp = ops._padded_copy(w)
    assert wp.stride() == (200 * 144, 144, 1) and ops._tma_ready(wp)
    odd = torch.zeros(2, 65, 37, dtype=torch.int8)[..., :33]
    assert not ops._tma_ready(odd)
    assert torch.equal(ops._padded_copy(odd), odd)


def test_q8_wrapper_checks_layout():
    """The kernel takes K-contiguous weight codes and int8 codes only; the
    checks run before anything touches a card."""
    q = torch.zeros((1, 4, 8), dtype=torch.int8)
    s = torch.zeros((1, 4))
    w = torch.zeros((1, 8, 4), dtype=torch.int8)      # N-contiguous
    with pytest.raises(ValueError, match="K-contiguous"):
        ops._launch_q8(q, s, w, s, None, None, swiglu=False)
    with pytest.raises(TypeError):
        ops._launch_q8(q.float(), s, w, s, None, None, swiglu=False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,M,K,N", [(1, 1, 64, 64), (3, 1009, 136, 200),
                                     (2, 65, 33, 129)])
def test_kernels_match_plain_on_card(cuda_device, dtype, G, M, K, N):
    x, w1, w3 = (torch.from_numpy(a).to(cuda_device, dtype)
                 for a in _inputs(G, M, K, N, seed=2))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for out, ref in ((ops.grouped_swiglu(x, w1, w3),
                      ops.grouped_swiglu_ref(x, w1, w3)),
                     (ops.grouped_matmul(x, w1), ops.grouped_matmul_ref(x, w1))):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item()


def _serve_like_rows(G, M, seed):
    """Counts as a bucket returns them: empty slots, a partial tile, slots
    that straddle a 128-row tile, full ones."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, M + 1, G)
    rows[::4] = 0
    if G > 2:
        rows[1], rows[2] = M, min(M, 129)
    return rows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G,M,K,N", [(1, 1, 64, 64), (3, 1009, 136, 200),
                                     (2, 65, 33, 129), (6, 300, 512, 384),
                                     (5, 8, 256, 136)])
@pytest.mark.parametrize("counts", ["zero", "straddle", "full", "serve"])
def test_kernels_with_rows_match_plain_on_card(cuda_device, dtype, G, M, K,
                                               N, counts):
    """Valid rows within the dtype's tolerance of the plain version with
    the same counts; rows past the count exactly zero even where x holds
    NaN; the same counts as int32 give the same output."""
    x, w1, w3 = (torch.from_numpy(a).to(cuda_device, dtype)
                 for a in _inputs(G, M, K, N, seed=6))
    rows = {"zero": np.zeros(G, np.int64),
            "straddle": np.minimum(M, 1 + 127 * np.arange(1, G + 1)),
            "full": np.full(G, M),
            "serve": _serve_like_rows(G, M, seed=G)}[counts]
    rt = torch.from_numpy(np.asarray(rows, np.int64)).to(cuda_device)
    mask = ops._row_mask(rt, M)
    junk = torch.where(mask, x, torch.full_like(x, float("nan")))
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for out, out32, ref in (
            (ops.grouped_swiglu(junk, w1, w3, rt),
             ops.grouped_swiglu(junk, w1, w3, rt.to(torch.int32)),
             ops.grouped_swiglu_ref(x, w1, w3, rt)),
            (ops.grouped_matmul(junk, w1, rt),
             ops.grouped_matmul(junk, w1, rt.to(torch.int32)),
             ops.grouped_matmul_ref(x, w1, rt))):
        torch.cuda.synchronize()
        assert torch.equal(out, out32)
        assert not out.masked_select(~mask).any()
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol * max(ref.float().abs().max().item(), 1e-30)


@pytest.mark.cuda
def test_padded_copies_on_card(cuda_device):
    """An operand TMA cannot read is copied, counted, and gives the plain
    version's result; aligned operands and the views the kernel returns
    are not copied."""
    sw, mm = ops.grouped_swiglu, ops.grouped_matmul
    x, w1, w3 = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                 for a in _inputs(2, 65, 33, 129, seed=7))
    before = (sw.padded_copies, mm.padded_copies)
    act = sw(x, w1, w3)                     # x, w1 and w3 are copied
    assert (sw.padded_copies - before[0], mm.padded_copies) == (3, before[1])
    assert act.shape == (2, 65, 129) and act.stride(1) == 136
    w2 = torch.randn((2, 129, 45), device=cuda_device).to(torch.bfloat16)
    out = mm(act, w2)                       # only w2 (rows 90 bytes apart)
    assert mm.padded_copies - before[1] == 1
    torch.cuda.synchronize()
    ref = ops.grouped_matmul_ref(act, w2)
    assert (out.float() - ref.float()).abs().max() <= \
        1e-2 * ref.float().abs().max()
    xa, wa, _ = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                 for a in _inputs(2, 64, 64, 128, seed=8))
    n = (sw.padded_copies, mm.padded_copies)
    sw(xa, wa, wa)
    mm(xa, wa)
    assert (sw.padded_copies, mm.padded_copies) == n


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fragment_edges", "empty_slots", "nan_inf",
                                  "ragged"])
def test_f32_kernels_edge_cases_on_card(cuda_device, case):
    """The fp32 kernels against their plain versions within 1e-4 of max|ref|,
    rows past each count exactly zero: counts on the edges of a warp's
    16-row fragments, of its 32 rows and of a 128-row tile; slots with no
    rows; NaN, inf and -inf in the padded rows; and K 70 / N 45, whose
    operands TMA cannot read (copied, counted)."""
    G, M, K, N, rows = {
        "fragment_edges": (8, 300, 256, 192, [1, 15, 16, 17, 32, 33, 129,
                                              300]),
        "empty_slots": (4, 64, 512, 136, [0, 0, 5, 0]),
        "nan_inf": (4, 300, 128, 256, [0, 37, 128, 200]),
        "ragged": (3, 33, 70, 45, [0, 10, 33])}[case]
    x, w1, w3 = (torch.from_numpy(a).to(cuda_device)
                 for a in _inputs(G, M, K, N, seed=15))
    w2 = torch.randn((G, N, K), device=cuda_device) * N ** -0.5
    rt = torch.tensor(rows, device=cuda_device)
    mask = ops._row_mask(rt, M)
    junk = torch.tensor([float("nan"), float("inf"), -float("inf")],
                        device=cuda_device).repeat(K)[:K]
    sw, mm = ops.grouped_swiglu, ops.grouped_matmul
    before = (sw.launches, mm.launches, sw.padded_copies, mm.padded_copies)
    act = sw(torch.where(mask, x, junk), w1, w3, rt)
    torch.cuda.synchronize()
    checks = [(act.clone(), ops.grouped_swiglu_ref(x, w1, w3, rt))]
    out = mm(act.masked_fill_(~mask, float("nan")), w2, rt)   # in its view
    torch.cuda.synchronize()
    checks.append((out, ops.grouped_matmul_ref(act, w2, rt)))
    # ragged: x (rows 280 bytes), w1 and w3 (180), then w2 (280); the
    # SwiGLU's output is a view of rows 48 floats apart, which TMA reads.
    copies = (3, 1) if case == "ragged" else (0, 0)
    assert (sw.launches, mm.launches, sw.padded_copies, mm.padded_copies) == (
        before[0] + 1, before[1] + 1, before[2] + copies[0],
        before[3] + copies[1])
    for got, ref in checks:
        assert got.shape == ref.shape and got.dtype == torch.float32
        pad = got.masked_select(~mask)
        assert torch.equal(pad, torch.zeros_like(pad))
        err = (got - ref).abs().max().item()
        assert err <= 1e-4 * max(ref.abs().max().item(), 1e-30)


def _k_contiguous(w: torch.Tensor) -> torch.Tensor:
    """(G, K, N) codes as a view of (G, N, K) storage: the layout the q8
    kernels take (and ``MoEParams`` keeps)."""
    return w.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("G,M,K,N", [(1, 1, 64, 64), (3, 1009, 136, 200),
                                     (2, 65, 33, 129), (2, 300, 512, 384)])
@pytest.mark.parametrize("wire_view", [False, True])
def test_q8_kernels_match_plain_on_card(cuda_device, G, M, K, N, wire_view):
    """Contiguous codes, or rows cut from an int8 wire buffer (K + 4 bytes
    apart: TMA cannot read them, so the wrapper copies them first)."""
    q, rs, ws, ss = _q8_inputs(G, M, K, N, seed=3)
    qt = torch.from_numpy(q).to(cuda_device)
    if wire_view:
        buf = torch.zeros((G, M, K + 4), dtype=torch.int8, device=cuda_device)
        buf[..., :K] = qt
        qt = buf[..., :K]
    rst = torch.from_numpy(rs).to(cuda_device)
    w1, w3, w2 = (_k_contiguous(torch.from_numpy(w).to(cuda_device))
                  for w in ws)
    s1, s3, s2 = (torch.from_numpy(s).to(cuda_device) for s in ss)
    mm = ops.grouped_matmul_q8(qt, rst, w2, s2)
    sw = ops.grouped_swiglu_q8(qt, rst, w1, s1, w3, s3)
    torch.cuda.synchronize()
    assert torch.equal(mm, ops.grouped_matmul_q8_ref(qt, rst, w2, s2))
    ref = ops.grouped_swiglu_q8_ref(qt, rst, w1, s1, w3, s3)
    assert (sw - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("G,M,K,N", [(1, 1, 64, 64), (3, 1009, 136, 200),
                                     (2, 65, 33, 129), (6, 300, 512, 384),
                                     (5, 8, 256, 136)])
@pytest.mark.parametrize("layout", ["contiguous", "wire", "bucket"])
@pytest.mark.parametrize("counts", ["zero", "straddle", "full", "serve",
                                    "above"])
def test_q8_kernels_with_rows_match_plain_on_card(cuda_device, G, M, K, N,
                                                  layout, counts):
    """With ``rows``: the matmul equals its plain version bitwise in fp32
    and bf16 output, the SwiGLU within 1e-5 max|ref|; rows past the count
    exactly zero though their codes are random and their row scales NaN;
    the same counts as int32 give the same output.  Codes contiguous, cut
    from int8 wire rows (K + 4 bytes apart: copied for TMA first), or from
    those rows padded to 16 bytes as the bucket lays them out (TMA reads
    them as they are)."""
    q, rs, ws, ss = _q8_inputs(G, M, K, N, seed=11)
    rows = {"zero": np.zeros(G, np.int64),
            "straddle": np.minimum(M, 1 + 127 * np.arange(1, G + 1)),
            "full": np.full(G, M),
            "serve": _serve_like_rows(G, M, seed=G),
            "above": np.full(G, M + 5)}[counts]
    rt = torch.from_numpy(np.asarray(rows, np.int64)).to(cuda_device)
    mask = ops._row_mask(rt, M)
    qt = torch.from_numpy(q).to(cuda_device)
    if layout != "contiguous":
        pitch = K + 4 if layout == "wire" else -(-(K + 4) // 16) * 16
        buf = torch.zeros((G, M, pitch), dtype=torch.int8, device=cuda_device)
        buf[..., :K] = qt
        qt = buf[..., :K]
    rst = torch.from_numpy(rs).to(cuda_device)
    rst = torch.where(mask[..., 0], rst, torch.full_like(rst, float("nan")))
    w1, w3, w2 = (_k_contiguous(torch.from_numpy(w).to(cuda_device))
                  for w in ws)
    s1, s3, s2 = (torch.from_numpy(s).to(cuda_device) for s in ss)
    for dtype in (torch.float32, torch.bfloat16):
        mm = ops.grouped_matmul_q8(qt, rst, w2, s2, rt, out_dtype=dtype)
        mm32 = ops.grouped_matmul_q8(qt, rst, w2, s2, rt.to(torch.int32),
                                     out_dtype=dtype)
        torch.cuda.synchronize()
        ref = ops.grouped_matmul_q8_ref(qt, rst, w2, s2, rt, out_dtype=dtype)
        assert mm.dtype == dtype
        assert torch.equal(mm, ref) and torch.equal(mm, mm32)
    sw = ops.grouped_swiglu_q8(qt, rst, w1, s1, w3, s3, rt)
    torch.cuda.synchronize()
    assert not sw.masked_select(~mask).any()
    ref = ops.grouped_swiglu_q8_ref(qt, rst, w1, s1, w3, s3, rt)
    assert (sw - ref).abs().max().item() <= \
        1e-5 * max(ref.abs().max().item(), 1e-30)


@pytest.mark.cuda
def test_q8_padded_copies_on_card(cuda_device):
    """An operand TMA cannot read is copied, counted, and gives the plain
    version's result: codes whose rows are 33 bytes, weights whose K is 33,
    a view of int8 wire rows (D + 4 bytes apart); 16-byte aligned codes and
    wire rows padded to 16 bytes, as the bucket lays them out, are not."""
    sw, mm = ops.grouped_swiglu_q8, ops.grouped_matmul_q8
    q, rs, ws, ss = _q8_inputs(2, 65, 33, 129, seed=12)
    qt, rst = (torch.from_numpy(a).to(cuda_device) for a in (q, rs))
    w1, w3, w2 = (_k_contiguous(torch.from_numpy(w).to(cuda_device))
                  for w in ws)
    s1, s3, s2 = (torch.from_numpy(s).to(cuda_device) for s in ss)
    before = (sw.padded_copies, mm.padded_copies)
    out = sw(qt, rst, w1, s1, w3, s3)       # q (rows 33 bytes), w1 and w3
    assert sw.padded_copies - before[0] == 3
    assert mm.padded_copies == before[1]
    torch.cuda.synchronize()
    ref = ops.grouped_swiglu_q8_ref(qt, rst, w1, s1, w3, s3)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    q, rs, ws, ss = _q8_inputs(2, 65, 256, 128, seed=13)
    rst = torch.from_numpy(rs).to(cuda_device)
    buf = torch.zeros((2, 65, 260), dtype=torch.int8, device=cuda_device)
    buf[..., :256] = torch.from_numpy(q).to(cuda_device)
    w1, w3, _ = (_k_contiguous(torch.from_numpy(w).to(cuda_device))
                 for w in ws)
    s1, s3, _ = (torch.from_numpy(s).to(cuda_device) for s in ss)
    n = (sw.padded_copies, mm.padded_copies)
    out = sw(buf[..., :256], rst, w1, s1, w3, s3)
    mm(buf[..., :256], rst, w1, s1)
    assert (sw.padded_copies, mm.padded_copies) == (n[0] + 1, n[1] + 1)
    torch.cuda.synchronize()
    ref = ops.grouped_swiglu_q8_ref(buf[..., :256], rst, w1, s1, w3, s3)
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    n = (sw.padded_copies, mm.padded_copies)
    padded = torch.zeros((2, 65, 272), dtype=torch.int8, device=cuda_device)
    padded[..., :256] = buf[..., :256]
    sw(padded[..., :256], rst, w1, s1, w3, s3)
    mm(padded[..., :256], rst, w1, s1)
    sw(buf[..., :256].contiguous(), rst, w1, s1, w3, s3)
    assert (sw.padded_copies, mm.padded_copies) == n


def _bwd_rows(G, M, counts):
    if counts == "zero":
        return [0] * G
    if counts == "full":
        return [M] * G
    return [(g * 97 + 37) % (M + 1) for g in range(G)]    # straddling, one 0


@pytest.mark.cuda
@pytest.mark.parametrize("G,M,K,N", [(2, 256, 128, 256), (3, 200, 136, 200),
                                     (4, 130, 4096, 1408)])
@pytest.mark.parametrize("counts", ["zero", "straddle", "full"])
def test_backward_kernels_match_plain_on_card(cuda_device, G, M, K, N,
                                              counts):
    """B1 (swiglu_bwd), B2 (matmul_nt, one and two products) and B3 (wgrad)
    in bf16 against their plain versions: every output within 2e-2 of its
    own max|ref| (bf16 outputs of fp32 sums), padded rows exact zeros, and
    NaN in the padded rows of the wgrad's operands reaching nothing; B2's
    ``zero_padded=False`` the same bits on the rows up to the count
    rounded up to 64, NaN in its operands' padded rows."""
    rng = np.random.default_rng(1)

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(cuda_device, torch.bfloat16)

    x, w1, w3 = t((G, M, K)), t((G, K, N), K ** -0.5), t((G, K, N), K ** -0.5)
    dact, dy = t((G, M, N)), t((G, M, K))
    rows = torch.tensor(_bwd_rows(G, M, counts), device=cuda_device)
    pad = torch.arange(M, device=cuda_device)[None, :, None] >= rows[:, None, None]

    def check(name, out, ref):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        assert err <= 2e-2 * scale, (name, err, scale)
        if out.shape[1] == M:
            assert torch.all(torch.where(pad, out.float(), 0.0) == 0), name

    n0 = (ops.grouped_swiglu_bwd.launches, ops.grouped_matmul_nt.launches,
          ops.grouped_wgrad.launches)
    dh, dg = ops.grouped_swiglu_bwd(x, w1, w3, dact, rows)
    rh, rg = ops.grouped_swiglu_bwd_ref(x, w1, w3, dact, rows)
    check("dh", dh, rh)
    check("dg", dg, rg)
    w1t = w1.transpose(1, 2).contiguous()           # (G, N, K) storage
    nt = ops.grouped_matmul_nt(dy, w1t, rows)
    check("nt", nt, ops.grouped_matmul_nt_ref(dy, w1t, rows))
    nt2 = ops.grouped_matmul_nt(dh, w1, rows, dg, w3)
    check("nt2", nt2, ops.grouped_matmul_nt_ref(dh, w1, rows, dg, w3))
    # The train step's calls: the same bits on the valid rows, zeros up to
    # the count rounded up to 64 (NaN in the operands' padded rows).
    tile = torch.arange(M, device=cuda_device)[None, :, None] < (
        (rows[:, None, None] + 63) // 64 * 64)
    nan_dy = torch.where(pad, float("nan"), dy.float()).to(torch.bfloat16)
    nan_dh = torch.where(pad, float("nan"), dh.float()).to(torch.bfloat16)
    for name, got, want in (
            ("nt", ops.grouped_matmul_nt(nan_dy, w1t, rows,
                                         zero_padded=False), nt),
            ("nt2", ops.grouped_matmul_nt(nan_dh, w1, rows, dg, w3,
                                          zero_padded=False), nt2)):
        torch.cuda.synchronize()
        assert torch.equal(torch.where(tile, got, 0), torch.where(
            tile, want, 0)), name
    nan_x = torch.where(pad, float("nan"), x.float()).to(torch.bfloat16)
    nan_d = torch.where(pad, float("nan"), dact.float()).to(torch.bfloat16)
    check("wgrad", ops.grouped_wgrad(nan_x, nan_d, rows),
          ops.grouped_wgrad_ref(nan_x, nan_d, rows))
    check("wgrad_dy", ops.grouped_wgrad(dy, dact, rows),
          ops.grouped_wgrad_ref(dy, dact, rows))
    assert (ops.grouped_swiglu_bwd.launches - n0[0],
            ops.grouped_matmul_nt.launches - n0[1],
            ops.grouped_wgrad.launches - n0[2]) == (1, 4, 2)


@pytest.mark.cuda
def test_backward_kernels_refuse_fp32_on_card(cuda_device):
    """The backward kernels take bf16 or fp32 (the fp32 ones since the
    trainer's default dtype trains on the card) of one dtype: fp16 and a
    mix of fp32 and bf16 raise before any launch."""
    x = torch.zeros((1, 8, 16), device=cuda_device)
    w = torch.zeros((1, 16, 16), device=cuda_device)
    n0 = ops.grouped_wgrad.launches + ops.grouped_matmul_nt.launches
    with pytest.raises(ValueError, match="bf16 or fp32"):
        ops.grouped_wgrad(x.half(), x.half())
    with pytest.raises(ValueError, match="bf16 or fp32"):
        ops.grouped_matmul_nt(x, w.to(torch.bfloat16))
    assert ops.grouped_wgrad.launches + ops.grouped_matmul_nt.launches == n0


@pytest.mark.cuda
@pytest.mark.parametrize("G,M,K,N", [(2, 256, 128, 256), (3, 200, 136, 200),
                                     (4, 130, 64, 32)])
@pytest.mark.parametrize("counts", ["zero", "straddle", "full"])
def test_fp32_backward_kernels_match_plain_on_card(cuda_device, G, M, K, N,
                                                   counts):
    """B1-B3 in fp32 (``csrc/grouped_gemm_bwd_f32.cu``, 3xTF32) against
    their plain versions: every output within 1e-4 of its own max|ref|,
    padded rows exact zeros whatever the operands hold there (NaN), each
    launch counted under ``fp32``, and the same bits from two calls; the
    train step's call (``zero_padded=False``) is held to that on the rows
    it writes, up to the count rounded up to 128."""
    rng = np.random.default_rng(2)

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).to(cuda_device)

    x, w1, w3 = t((G, M, K)), t((G, K, N), K ** -0.5), t((G, K, N), K ** -0.5)
    dact, dy = t((G, M, N)), t((G, M, K))
    rows = torch.tensor(_bwd_rows(G, M, counts), device=cuda_device)
    pad = torch.arange(M, device=cuda_device)[None, :, None] >= \
        rows[:, None, None]
    nan_x, nan_dact, nan_dy = (torch.where(pad, float("nan"), a)
                               for a in (x, dact, dy))
    w1t = w1.transpose(1, 2).contiguous()           # (G, N, K) storage
    written = torch.arange(M, device=cuda_device)[None, :, None] < (
        (rows[:, None, None] + 127) // 128 * 128)
    n0 = {f: dict(f.launches_by_kernel) for f in (
        ops.grouped_swiglu_bwd, ops.grouped_matmul_nt, ops.grouped_wgrad)}
    calls = {
        "dh_dg": (lambda: ops.grouped_swiglu_bwd(nan_x, w1, w3, nan_dact,
                                                 rows),
                  lambda: ops.grouped_swiglu_bwd_ref(x, w1, w3, dact, rows)),
        "nt": (lambda: ops.grouped_matmul_nt(nan_dy, w1t, rows),
               lambda: ops.grouped_matmul_nt_ref(dy, w1t, rows)),
        "nt2": (lambda: ops.grouped_matmul_nt(nan_dact, w1, rows, nan_dact,
                                              w3, zero_padded=False),
                lambda: ops.grouped_matmul_nt_ref(dact, w1, rows, dact, w3)),
        "wgrad": (lambda: ops.grouped_wgrad(nan_x, nan_dact, rows),
                  lambda: ops.grouped_wgrad_ref(x, dact, rows)),
    }
    for name, (kernel, plain) in calls.items():
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        for a, b, r in zip(got, again, want):
            if name == "nt2":                 # the train step's call
                a, b = (torch.where(written, t, 0.0) for t in (a, b))
            assert torch.equal(a, b), name
            assert a.dtype == torch.float32
            err = (a - r).abs().max().item()
            assert err <= 1e-4 * max(r.abs().max().item(), 1e-30), (name, err)
            if a.shape[1] == M:
                assert torch.all(torch.where(pad, a, 0.0) == 0), name
    moved = {f.__name__: f.launches_by_kernel["fp32"] - n0[f]["fp32"]
             for f in n0}
    assert moved == {"grouped_swiglu_bwd": 2, "grouped_matmul_nt": 4,
                     "grouped_wgrad": 2}

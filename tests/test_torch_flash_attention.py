"""Flash attention: the port's plain version vs the Pallas kernel
(interpret mode) and JAX ``flash_ref`` with cache offsets, and the CUDA
kernel vs the plain version on a card.

CPU tolerances (fp32 throughout): 1e-4 against the Pallas kernel (the JAX
suite's bound for fp32 kernels; its masked scores are -1e30, not -inf, and
its blocks differ) and 1e-5 against ``flash_ref`` with the same blocks
(the frameworks' einsums sum in different orders).  Card: each output row
(batch row, query position, head) within a share of its own max|ref|:
1e-2 for bf16 q/k/v (the kernel rounds P to bf16 for the P v product and
the output once to bf16), 1e-4 for fp32 (fp32 arithmetic, another order).

The JAX side is imported inside the tests that use it, so the card test
also runs where JAX is not installed:
  PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
      tests/test_torch_flash_attention.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops


def _qkv(B, Sq, Sk, H, Hkv, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,d,bq,bk", [(256, 64, 128, 128), (512, 128, 256, 512)])
def test_plain_version_matches_pallas_interpret(causal, S, d, bq, bk):
    import jax.numpy as jnp

    from repro.kernels.flash_attention.kernel import flash_fwd_pallas

    B, H = 1, 2
    q, k, v = _qkv(B, S, S, H, H, d)
    flat = [jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, S, d))
            for a in (q, k, v)]
    want = np.asarray(flash_fwd_pallas(*flat, causal=causal, bq=bq, bk=bk,
                                       interpret=True))
    got = ops.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, block_kv=128)
    got = got.numpy().transpose(0, 2, 1, 3).reshape(B * H, S, d)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


CASES = [
    # B, Sq, Sk, H, Hkv, causal, q_offset, kv_valid_len
    (2, 24, 77, 8, 2, True, [0, 37], [24, 61]),        # GQA 4, ragged Sk
    (2, 24, 77, 32, 2, True, [5, 50], [20, 77]),       # GQA 16, padded rows
    (3, 1, 70, 16, 4, False, 0, [1, 33, 70]),          # decode, GQA 4
    (3, 1, 70, 16, 1, False, 0, [70, 2, 41]),          # decode, GQA 16
    (1, 40, 40, 4, 4, True, 0, None),                  # full sequence
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_version_matches_jax_flash_ref(case):
    import jax.numpy as jnp

    from repro.models.attention import flash_ref as jax_flash_ref

    B, Sq, Sk, H, Hkv, causal, q_off, kv_len = case
    q, k, v = _qkv(B, Sq, Sk, H, Hkv, 32, seed=1)
    j_off = q_off if isinstance(q_off, int) else jnp.asarray(q_off)
    j_len = None if kv_len is None else jnp.asarray(kv_len)
    want = np.asarray(jax_flash_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    block_kv=16, q_offset=j_off,
                                    kv_valid_len=j_len))
    t_off = q_off if isinstance(q_off, int) else torch.tensor(q_off)
    t_len = None if kv_len is None else torch.tensor(kv_len)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, block_kv=16, q_offset=t_off,
                              kv_valid_len=t_len)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_attention_module_re_exports_the_plain_version():
    from repro_torch.models import attention

    assert attention.flash_ref is ops.flash_attention_ref


def test_wrapper_on_cpu_is_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(2, 5, 19, 4, 2, 16, seed=2))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True, q_offset=torch.tensor(
        [3, 14]), kv_valid_len=torch.tensor([8, 19]), block_kv=8)
    want = ops.flash_attention_ref(q, k, v, causal=True, q_offset=torch.tensor(
        [3, 14]), kv_valid_len=torch.tensor([8, 19]), block_kv=8)
    assert ops.flash_attention.launches == before
    assert torch.equal(got, want)


def test_wrapper_refuses_other_devices():
    q = torch.empty((1, 2, 4, 128), device="meta")
    k = torch.empty((1, 2, 1, 128), device="meta")
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, k, causal=True)


@pytest.mark.parametrize("dtypes,hd,error", [
    ((torch.float16,) * 3, 128, TypeError),            # neither bf16 nor fp32
    ((torch.bfloat16, torch.float32, torch.float32), 128, TypeError),
    ((torch.float32,) * 3, 32, ValueError),            # head dim not served
    ((torch.bfloat16,) * 3, 256, ValueError),
])
def test_kernel_refuses_what_it_does_not_compute(dtypes, hd, error):
    """The launcher raises before it loads the kernel, so no plain path
    hides on a card."""
    q, k, v = (torch.zeros(shape, dtype=dt) for shape, dt in zip(
        ((1, 4, 4, hd), (1, 8, 2, hd), (1, 8, 2, hd)), dtypes))
    with pytest.raises(error):
        ops._launch(q, k, v, True, 0, None, None)


def test_kernel_takes_fp32_and_the_reduced_head_dims():
    """fp32 needs only a unit-stride head dim; bf16 also 16-byte alignment."""
    assert ops.HEAD_DIMS == (16, 64, 128)
    f = torch.zeros((2, 8, 4, 16))
    assert ops._aligned(f) and ops._aligned(f[:, 1:])
    b = torch.zeros((2, 8, 4, 16), dtype=torch.bfloat16)
    assert ops._aligned(b) and not ops._aligned(b[..., 1:9])


def test_offset_arguments_stay_on_the_device():
    """A tensor offset is passed by pointer (never read on the host); an
    int by value; a (B,) vector with stride 1, a scalar tensor with 0."""
    t = torch.tensor([3, 4], dtype=torch.int32)
    vec, stride, const = ops._offset_arg(t, 2, t.device, "q_offset")
    assert vec.dtype == torch.int64 and stride == 1 and const == 0
    one, stride, _ = ops._offset_arg(torch.tensor(7), 2, t.device, "x")
    assert one.shape == (1,) and stride == 0
    assert ops._offset_arg(5, 2, t.device, "x") == (None, 0, 5)
    with pytest.raises(ValueError):
        ops._offset_arg(torch.zeros(3), 2, t.device, "x")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel builds with nvcc for "
                    "sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = [
    # B, Sq, Sk, H, Hkv, hd, causal, q_offset, kv_valid_len
    (1, 256, 700, 32, 8, 128, True, [0], [256]),
    (1, 256, 700, 32, 8, 128, True, [300], [556]),
    (1, 256, 700, 32, 8, 128, True, [128], [300]),      # padded query rows
    (2, 100, 333, 64, 4, 128, True, [17, 200], [117, 290]),  # GQA 16, ragged
    (4, 1, 700, 32, 8, 128, False, 0, [300, 700, 81, 1]),    # decode
    (4, 1, 700, 64, 4, 128, False, 0, [300, 700, 81, 1]),    # decode, GQA 16
    (1, 192, 192, 8, 8, 128, True, 0, None),            # the Pallas case
    (1, 192, 192, 8, 8, 128, False, 0, None),
    (2, 100, 333, 16, 4, 64, True, [17, 200], [117, 290]),
    (2, 64, 272, 4, 2, 16, True, [0, 64], [50, 100]),   # reduced configs
    (4, 1, 272, 4, 2, 16, False, 0, [1, 80, 200, 272]),
    (2, 40, 90, 8, 2, 16, True, [0, 7], [40, 47]),
]


def _row_rel_err(out, ref):
    """The largest row's max|err| over that row's own max|ref|."""
    err = (out.float() - ref.float()).abs().amax(dim=-1)
    return (err / ref.float().abs().amax(dim=-1)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("case", CARD_CASES, ids=str)
def test_kernel_matches_plain_on_card(cuda_device, case, dtype, tol):
    B, Sq, Sk, H, Hkv, hd, causal, q_off, kv_len = case
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv(B, Sq, Sk, H, Hkv, hd, seed=3))
    kw = dict(causal=causal,
              q_offset=(q_off if isinstance(q_off, int)
                        else torch.tensor(q_off, device=cuda_device)),
              kv_valid_len=(None if kv_len is None
                            else torch.tensor(kv_len, device=cuda_device)))
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    ref = ops.flash_attention_ref(q, k, v, **kw)
    assert out.dtype == dtype
    assert _row_rel_err(out, ref) <= tol

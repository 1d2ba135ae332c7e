"""DeepSeek-V3's MLA attention: the port against the JAX package.

On ``reduced(deepseek-v3-671b)`` (4 heads, q_lora 16, kv_lora 16, nope 8,
rope 4, v 8), with inputs made from a seed with numpy and the JAX
parameters carried across by ``repro_torch.convert``: ``mla_attention``,
``mla_prefill`` (two chunks, then a ragged one, each batch row at its own
offset and valid length) and the absorbed ``mla_decode`` against their JAX
counterparts within 1e-4 (fp32), and the plain flash at unequal head dims
against JAX ``flash_ref`` with a scale.  On the CPU an fp32 MLA model
reaches the plain flash.  (The kernel takes (192, 128) in bf16 and fp32;
``tests/test_torch_flash_attention.py``, which a card machine without JAX
runs, holds both against the plain version and checks that other pairs
raise.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.reduce import reduced as j_reduced
from repro.models import attention as j_attn
from repro.models.transformer import attn_config as j_attn_config
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import attention
from repro_torch.models.transformer import attn_config

ARCH = "deepseek-v3-671b"
TOL = 1e-4
S_CACHE = 48


def _configs():
    return (j_attn_config(j_reduced(j_get_config(ARCH))),
            attn_config(reduced(get_config(ARCH))))


def _params(seed=0):
    jcfg, tcfg = _configs()
    jp = j_attn.init_mla(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, convert.mla_params(jax.tree.map(np.asarray, jp),
                                              device="cpu")


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=TOL,
                               atol=TOL)


def _same_fields(t, j):
    """Every field of the port's dataclass equals the JAX one's."""
    for f in dataclasses.fields(t):
        if dataclasses.is_dataclass(getattr(t, f.name)):
            _same_fields(getattr(t, f.name), getattr(j, f.name))
        else:
            assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("cut", [False, True], ids=["full", "reduced"])
def test_config_matches_jax(cut):
    """The port's own copy of the config, and its reduced form, describe
    the JAX model field for field."""
    t, j = get_config(ARCH), j_get_config(ARCH)
    if cut:
        t, j = reduced(t), j_reduced(j)
    _same_fields(t, j)


def test_init_mla_params_carry_across():
    """``convert.mla_params`` holds the JAX values in the port's
    ``MLAParams``; the port's ``init_mla`` draws the same shapes."""
    _, tcfg, jp, tp = _params()
    own = attention.init_mla(tcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    for name in j_attn.MLAParams._fields:
        got = getattr(tp, name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jp,
                                                                      name)))
        assert getattr(own, name).shape == got.shape, name


def test_mla_attention_matches_jax():
    jcfg, tcfg, jp, tp = _params(1)
    x = np.random.default_rng(0).standard_normal(
        (2, 24, tcfg.d_model)).astype(np.float32)
    want = j_attn.mla_attention(jnp.asarray(x), jp, jcfg, block_kv=8)
    got = attention.mla_attention(torch.from_numpy(x), tp, tcfg, block_kv=8)
    _close(got, want)


def _caches(jcfg, B):
    shapes = ((B, S_CACHE, jcfg.kv_lora_rank), (B, S_CACHE, jcfg.qk_rope_dim))
    j = j_attn.KVCache(jnp.zeros(shapes[0]), jnp.zeros(shapes[1]),
                       jnp.zeros((B,), jnp.int32))
    t = attention.KVCache(torch.zeros(shapes[0]), torch.zeros(shapes[1]),
                          torch.zeros(B, dtype=torch.int64))
    return j, t


def _prefill_both(jp, tp, jcfg, tcfg, x, jc, tc, valid):
    jy, jc = j_attn.mla_prefill(jnp.asarray(x), jc, jp, jcfg,
                                valid_len=jnp.asarray(valid), block_kv=16)
    ty, tc = attention.mla_prefill(torch.from_numpy(x), tc, tp, tcfg,
                                   valid_len=torch.tensor(valid),
                                   block_kv=16)
    return jy, jc, ty, tc


def _check_cache(tc, jc):
    _close(tc.k, jc.k)
    _close(tc.v, jc.v)
    np.testing.assert_array_equal(tc.length.numpy(), np.asarray(jc.length))


def test_mla_prefill_matches_jax_over_ragged_chunks():
    """Chunks of 12 on two batch rows: the rows' valid lengths differ in
    every chunk (so each row attends at its own q_offset and
    kv_valid_len), and the third chunk is ragged on both."""
    jcfg, tcfg, jp, tp = _params(2)
    rng = np.random.default_rng(1)
    jc, tc = _caches(jcfg, 2)
    for valid in ([12, 5], [12, 12], [7, 3]):
        x = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
        jy, jc, ty, tc = _prefill_both(jp, tp, jcfg, tcfg, x, jc, tc, valid)
        _close(ty, jy)
        _check_cache(tc, jc)
    assert tc.length.tolist() == [31, 20]


def test_mla_decode_matches_jax():
    """The absorbed decode (fp32 products on the latent cache) after a
    ragged prefill, three steps, each row at its own length."""
    jcfg, tcfg, jp, tp = _params(3)
    rng = np.random.default_rng(2)
    jc, tc = _caches(jcfg, 2)
    x = rng.standard_normal((2, 12, tcfg.d_model)).astype(np.float32)
    _, jc, _, tc = _prefill_both(jp, tp, jcfg, tcfg, x, jc, tc, [9, 4])
    for _ in range(3):
        x = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
        jy, jc = j_attn.mla_decode(jnp.asarray(x), jc, jp, jcfg)
        ty, tc = attention.mla_decode(torch.from_numpy(x), tc, tp, tcfg)
        _close(ty, jy)
        _check_cache(tc, jc)


def test_mla_decode_equals_a_one_token_prefill():
    """The absorbed algebra: decode at position t gives what a one-token
    prefill at offset t gives through the expanded K/V."""
    _, tcfg, _, tp = _params(4)
    rng = np.random.default_rng(3)
    _, tc = _caches(_configs()[0], 2)
    tc = attention.KVCache(
        torch.from_numpy(rng.standard_normal(tc.k.shape).astype(np.float32)),
        torch.from_numpy(rng.standard_normal(tc.v.shape).astype(np.float32)),
        torch.tensor([17, 40]))
    x = torch.from_numpy(rng.standard_normal((2, 1, tcfg.d_model)).astype(
        np.float32))
    yd, cd = attention.mla_decode(x, tc, tp, tcfg)
    yp, cp = attention.mla_prefill(x, tc, tp, tcfg)
    np.testing.assert_allclose(yd.numpy(), yp.numpy(), rtol=TOL, atol=TOL)
    assert all(torch.equal(a, b) for a, b in zip(cd, cp))


FLASH_CASES = [
    # B, Sq, Sk, H, Hkv, hd, hd_v, causal, q_offset, kv_valid_len
    (2, 12, 40, 4, 4, 12, 8, True, [0, 20], [12, 33]),    # reduced MLA
    (1, 9, 30, 2, 2, 192, 128, True, [21], [30]),         # full MLA dims
    (2, 1, 30, 4, 2, 48, 16, False, 0, [30, 7]),          # decode, GQA 2
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_plain_flash_at_unequal_head_dims_matches_jax(case):
    B, Sq, Sk, H, Hkv, hd, hd_v, causal, q_off, kv_len = case
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd_v)).astype(np.float32)
    scale = (hd + 7) ** -0.5
    j_off = q_off if isinstance(q_off, int) else jnp.asarray(q_off)
    want = j_attn.flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, block_kv=8, q_offset=j_off,
                            kv_valid_len=jnp.asarray(kv_len), scale=scale)
    t_off = q_off if isinstance(q_off, int) else torch.tensor(q_off)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, block_kv=8, q_offset=t_off,
                              kv_valid_len=torch.tensor(kv_len), scale=scale)
    assert got.shape == (B, Sq, H, hd_v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fp32_mla_model_on_the_cpu_takes_the_plain_flash():
    """The serve entry point on reduced DeepSeek-V3 in fp32 (its default)
    on the CPU: every request finishes, and no call launched a kernel."""
    from repro_torch.launch.serve import main

    before = ops.flash_attention.launches
    eng = main(["--arch", ARCH, "--reduce", "--requests", "2", "--chunk",
                "32", "--max-new", "3", "--device", "cpu"])
    assert len(eng.finished) == 2
    assert all(not r.failed and len(r.output) == 3 for r in eng.finished)
    assert ops.flash_attention.launches == before

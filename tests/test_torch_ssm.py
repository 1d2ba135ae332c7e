"""The port's Mamba-2 SSD mixer vs ``repro.models.ssm`` in fp32 at the
reduced Jamba widths (d_model 64, d_inner 128, headdim 16, d_state 16,
2 groups, chunk 16), with the JAX parameters carried across by
``repro_torch.convert.ssm_params``.  Tolerance rtol = atol = 1e-4 (fp32,
different summation orders); the mixer runs the port's plain chunk scan on
CPU tensors, and the JAX side once more through the Pallas kernel in
interpret mode (``use_kernel=True``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.models import ssm

TOL = 1e-4
KW = dict(d_model=64, d_inner=128, headdim=16, d_state=16, n_groups=2,
          chunk=16)


def _setup(B=2, L=64, seed=0):
    jcfg, tcfg = jssm.SSMConfig(**KW), ssm.SSMConfig(**KW)
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    tp = convert.ssm_params(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, L, KW["d_model"])) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, tcfg.n_heads, KW["d_state"],
                               KW["headdim"])) * 0.5).astype(np.float32)
    tail = (rng.standard_normal((B, 3, ssm.conv_channels(tcfg)))
            * 0.5).astype(np.float32)
    return jcfg, tcfg, jp, tp, x, s0, tail


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_forward_matches_jax(use_kernel, with_state):
    jcfg, tcfg, jp, tp, x, s0, _ = _setup()
    init = s0 if with_state else None
    jy, jfin = jssm.ssd_forward(
        jnp.asarray(x), jp, jcfg, use_kernel=use_kernel,
        initial_state=None if init is None else jnp.asarray(init))
    ty, tfin = ssm.ssd_forward(
        torch.from_numpy(x), tp, tcfg,
        initial_state=None if init is None else torch.from_numpy(init))
    _close(ty, jy)
    _close(tfin, jfin)


def test_ssd_prefill_chunk_after_chunk_matches_jax():
    jcfg, tcfg, jp, tp, x, s0, tail = _setup(L=96)
    B = x.shape[0]
    jst = jssm.SSMState(jnp.asarray(s0), jnp.asarray(tail),
                        jnp.zeros((B,), jnp.int32))
    tst = ssm.SSMState(torch.from_numpy(s0), torch.from_numpy(tail),
                       torch.zeros(B, dtype=torch.int64))
    for lo, hi in ((0, 32), (32, 48), (48, 96)):
        jy, jst = jssm.ssd_prefill(jnp.asarray(x[:, lo:hi]), jst, jp, jcfg)
        ty, tst = ssm.ssd_prefill(torch.from_numpy(x[:, lo:hi]), tst, tp,
                                  tcfg)
        _close(ty, jy)
        _close(tst.s, jst.s)
        _close(tst.conv, jst.conv)
        np.testing.assert_array_equal(tst.length.numpy(),
                                      np.asarray(jst.length))


def test_ssd_decode_matches_jax():
    jcfg, tcfg, jp, tp, x, s0, tail = _setup(L=6)
    B = x.shape[0]
    jst = jssm.SSMState(jnp.asarray(s0), jnp.asarray(tail),
                        jnp.full((B,), 5, jnp.int32))
    tst = ssm.SSMState(torch.from_numpy(s0), torch.from_numpy(tail),
                       torch.full((B,), 5, dtype=torch.int64))
    for t in range(x.shape[1]):
        jy, jst = jssm.ssd_decode(jnp.asarray(x[:, t:t + 1]), jst, jp, jcfg)
        ty, tst = ssm.ssd_decode(torch.from_numpy(x[:, t:t + 1]), tst, tp,
                                 tcfg)
        _close(ty, jy)
        _close(tst.s, jst.s)
        _close(tst.conv, jst.conv)
    np.testing.assert_array_equal(tst.length.numpy(), np.asarray(jst.length))


def test_ssd_forward_refuses_ragged_length():
    _, tcfg, _, tp, x, _, _ = _setup(L=40)
    with pytest.raises(ValueError):
        ssm.ssd_forward(torch.from_numpy(x), tp, tcfg)

"""SSD chunk scan: the port's plain versions vs the JAX oracle and the Pallas
kernel (interpret mode), and the CUDA kernel vs its plain version on a card.

CPU tolerance: rtol = atol = 3e-4, the JAX suite's own for this kernel
(``tests/test_kernels.py``): the frameworks sum and scan in different
orders.  Card tolerance: max|err| <= 3e-4 * max|ref| (fp32 arithmetic in
both, other summation orders); bf16 inputs are cast to fp32 by both.

The JAX side is imported inside the tests that use it, so the card tests
also run where JAX is not installed:
  PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
      tests/test_torch_ssd_scan.py
"""

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
                                            (1, 3, 128, 4, 64, 16)], ids=str)
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

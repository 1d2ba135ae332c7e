"""Grouped GEMM: the port's plain versions vs the JAX oracle and the Pallas
kernels (interpret mode), and the CUDA kernels vs the plain versions on a
card.

CPU tolerance: rtol 1e-5 in fp32 (the frameworks sum in different orders).
Card tolerances (fp32 SIMT tile vs fp32 einsum, TF32 off): max|err| <=
1e-4 * max|ref|; bf16: max|err| <= 1e-2 * max|ref| (one bf16 rounding of
the output).

The JAX side is imported inside the tests that use it, so the card test
also runs where JAX is not installed:
  PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
      tests/test_torch_grouped_gemm.py
"""

import numpy as np
import pytest
import torch

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


def test_wrappers_refuse_other_devices():
    x = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(ValueError):
        ops.grouped_matmul(x, x)
    with pytest.raises(ValueError):
        ops.grouped_swiglu(x, x, x)


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

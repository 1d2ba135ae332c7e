"""Port gate vs ``repro.moe.gating.gate``: ids and counts exact, weights and
aux loss within rtol 1e-5 (fp32 router; the two frameworks' matmuls and
softmaxes may differ in the last bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.moe.gating import GatingConfig as JGatingConfig
from repro.moe.gating import gate as jgate
from repro_torch.moe.gating import GatingConfig, gate

T, D, E, K = 128, 32, 16, 4


def _both(x, w, bias=None, **cfg_kw):
    jo = jgate(jnp.asarray(x), jnp.asarray(w),
               JGatingConfig(num_experts=E, top_k=K, **cfg_kw),
               bias=None if bias is None else jnp.asarray(bias))
    to = gate(torch.from_numpy(x), torch.from_numpy(w),
              GatingConfig(num_experts=E, top_k=K, **cfg_kw),
              bias=None if bias is None else torch.from_numpy(bias))
    return jo, to


def _check(jo, to):
    np.testing.assert_array_equal(np.asarray(jo.expert_ids),
                                  to.expert_ids.numpy())
    np.testing.assert_array_equal(np.asarray(jo.counts), to.counts.numpy())
    np.testing.assert_allclose(np.asarray(jo.weights), to.weights.numpy(),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(jo.aux_loss), float(to.aux_loss),
                               rtol=1e-5)


@pytest.mark.parametrize("cfg_kw", [
    {},
    {"score_fn": "sigmoid"},
    {"norm_topk_prob": False},
    {"routed_scaling": 2.5, "aux_loss_weight": 1e-2},
    {"score_fn": "sigmoid", "use_bias": True},
    {"ideal": True, "aux_loss_weight": 1e-2},
])
def test_gate_matches_jax(cfg_kw):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    bias = (rng.standard_normal(E) * 0.1).astype(np.float32)
    _check(*_both(x, w, bias=bias if cfg_kw.get("use_bias") else None,
                  **cfg_kw))


def test_gate_ties_take_lower_index_first():
    """Duplicated router columns give bitwise-equal scores; all-zero tokens
    tie every expert.  lax.top_k then picks the lower index first."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, D)).astype(np.float32)
    x[::7] = 0.0                                   # every expert ties
    w = (rng.standard_normal((D, E)) * D ** -0.5).astype(np.float32)
    w[:, 9] = w[:, 2]
    w[:, 5] = w[:, 11]
    jo, to = _both(x, w, aux_loss_weight=1e-2)
    _check(jo, to)
    assert to.expert_ids[0].tolist() == list(range(K))

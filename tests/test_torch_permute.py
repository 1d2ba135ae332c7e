"""Port fused permutation engine vs ``repro.moe.permute``, bitwise.

Plans are solved by the JAX planner at R = 1 and R = 4 on numpy routing
tables; the all_to_all between ranks is simulated by re-indexing the
destination-major buffers.  Integer outputs and gathered buffers must be
bitwise equal; the combines must agree exactly too (same gathers, same
strict left fold over k).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.layout import ExpertLayout, physical_slot_of
from repro.core.planner import solve_plan
from repro.moe import permute as jperm
from repro_torch.moe import permute as tperm

E, K, D, T = 16, 4, 8, 48


j_dispatch = jax.jit(jperm.fused_dispatch,
                     static_argnames=("num_slots", "cap_pair"))
j_bucket = jax.jit(jperm.fused_bucket, static_argnames=("num_slots", "cap_slot"))
j_rep_bucket = jax.jit(jperm.fused_replicated_bucket,
                       static_argnames=("num_slots", "cap_slot"))


def _eq(j, t, msg=""):
    np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=msg)


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(R, seed, replicated=False):
    rng = np.random.default_rng(seed)
    n_src = 1 if replicated else R
    # Skewed routing: a few hot experts.
    p = rng.pareto(1.0, E) + 0.1
    ids = np.stack([np.stack([rng.choice(E, K, replace=False, p=p / p.sum())
                              for _ in range(T)]) for _ in range(n_src)]
                   ).astype(np.int32)                         # (n_src, T, K)
    x = rng.standard_normal((n_src, T, D)).astype(np.float32)
    w = rng.random((n_src, T, K)).astype(np.float32)
    counts = np.stack([np.bincount(i.ravel(), minlength=E) for i in ids])
    layout = ExpertLayout(E, R, 2)
    home = np.asarray(layout.home())
    if replicated:
        lam = (np.eye(R, dtype=np.int32)[home] * counts[0][:, None]).T
    else:
        lam = counts
    plan = solve_plan(jnp.asarray(lam), jnp.asarray(home), n_slot=2)
    slot_of = physical_slot_of(layout, plan.x)
    return ids, x, w, plan, slot_of, layout.slots_per_rank


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("cap_pair,cap_slot", [(T * K, T * K), (20, 6)])
def test_fused_a2a_pipeline_bitwise(R, cap_pair, cap_slot):
    ids, x, w, plan, slot_of, S = _setup(R, seed=R)
    jd, td = [], []
    for r in range(R):
        j = j_dispatch(jnp.asarray(x[r]), jnp.asarray(ids[r]), plan.cum_q[r],
                       slot_of, num_slots=S, cap_pair=cap_pair)
        t = tperm.fused_dispatch(_t(x[r]), _t(ids[r]), _t(plan.cum_q[r]),
                                 _t(slot_of), num_slots=S, cap_pair=cap_pair)
        for f in tperm.FusedDispatch._fields:
            _eq(getattr(j, f), getattr(t, f), f"dispatch.{f} r={r}")
        jd.append(j)
        td.append(t)

    rng = np.random.default_rng(0)
    j_ret, t_ret = [None] * R, [None] * R
    for me in range(R):
        recv_x = np.stack([np.asarray(jd[s].send_x[me]) for s in range(R)])
        recv_c = np.stack([np.asarray(jd[s].send_counts[me]) for s in range(R)])
        jx, jv, jm, jdrops = j_bucket(
            jnp.asarray(recv_x), jnp.asarray(recv_c), num_slots=S,
            cap_slot=cap_slot)
        tx, tv, tm, tdrops, trows = tperm.fused_bucket(
            _t(recv_x), _t(recv_c), num_slots=S, cap_slot=cap_slot)
        _eq(jx, tx, "xs")
        _eq(jv, tv, "valid")
        _eq(np.asarray(jv).sum(1), trows, "rows")
        for f in tperm.BucketMeta._fields:
            _eq(getattr(jm, f), getattr(tm, f), f"meta.{f}")
        assert int(jdrops) == int(tdrops)
        out = rng.standard_normal(tuple(tx.shape)).astype(np.float32)
        ju = jperm.fused_unbucket(jnp.asarray(out), jm)
        tu = tperm.fused_unbucket(_t(out), tm)
        _eq(ju, tu, "unbucket")
        j_ret[me], t_ret[me] = np.asarray(ju), tu.numpy()

    for r in range(R):
        back = np.stack([j_ret[d][r] for d in range(R)])
        jy = jperm.fused_combine(jnp.asarray(back), jd[r], jnp.asarray(w[r]))
        ty = tperm.fused_combine(
            _t(np.stack([t_ret[d][r] for d in range(R)])), td[r], _t(w[r]))
        _eq(jy, ty, "combine")


@pytest.mark.parametrize("R", [1, 4])
@pytest.mark.parametrize("cap_slot", [T * K, 5])
def test_fused_replicated_bitwise(R, cap_slot):
    ids, x, w, plan, slot_of, S = _setup(R, seed=10 + R, replicated=True)
    rng = np.random.default_rng(1)
    for me in range(R):
        jb = j_rep_bucket(
            jnp.asarray(x[0]), jnp.asarray(ids[0]), plan.cum_u,
            jnp.asarray(me), slot_of[me], num_slots=S, cap_slot=cap_slot)
        tb = tperm.fused_replicated_bucket(
            _t(x[0]), _t(ids[0]), _t(plan.cum_u), me, _t(slot_of[me]),
            num_slots=S, cap_slot=cap_slot)
        for f in jperm.ReplicatedBucket._fields:
            _eq(getattr(jb, f), getattr(tb, f), f"bucket.{f} me={me}")
        _eq(np.asarray(jb.valid).sum(1), tb.rows, f"bucket.rows me={me}")
        out = rng.standard_normal(tuple(tb.xs.shape)).astype(np.float32)
        _eq(jperm.fused_replicated_combine(jnp.asarray(out), jb,
                                           jnp.asarray(w[0])),
            tperm.fused_replicated_combine(_t(out), tb, _t(w[0])), "combine")


def test_occurrence_by_histogram_matches_jax():
    ids = np.random.default_rng(3).integers(0, E, 200).astype(np.int32)
    _eq(jperm.occurrence_by_histogram(jnp.asarray(ids), E),
        tperm.occurrence_by_histogram(_t(ids).long(), E))


@pytest.mark.parametrize("width", [D + 4, 4100])
def test_bucket_pads_int8_wire_rows_to_16_bytes(width):
    """int8 wire rows (D + 4 bytes) are bucketed into slot buffers whose
    rows start 16 bytes apart, so that the w8a8 kernel reads the codes with
    TMA; the values are the JAX bucket's, bitwise, and fp rows are not
    padded."""
    rng = np.random.default_rng(3)
    R, cap_pair, S, cap_slot = 2, 24, 3, 10
    recv_x = rng.integers(-127, 128, (R, cap_pair, width), dtype=np.int8)
    recv_c = np.array([[5, 12, 4, 3], [9, 0, 7, 8]], dtype=np.int32)
    jx, jv, _, _ = j_bucket(jnp.asarray(recv_x), jnp.asarray(recv_c),
                            num_slots=S, cap_slot=cap_slot)
    tx, tv, _, _, _ = tperm.fused_bucket(_t(recv_x), _t(recv_c), num_slots=S,
                                         cap_slot=cap_slot)
    _eq(jx, tx, "xs")
    _eq(jv, tv, "valid")
    assert tx.stride(1) % 16 == 0 and tx.stride(1) >= width
    fx = tperm.fused_bucket(_t(recv_x.astype(np.float32)), _t(recv_c),
                            num_slots=S, cap_slot=cap_slot)[0]
    assert fx.is_contiguous()

"""Port ``repro_torch.core.quantize``, ``quantize_weight_cols``, the w8a8
``grouped_ffn`` and the wire-encoded replica stream vs the JAX package, on
the CPU with numpy inputs made from a seed.

Codes, scales and wire bytes must be bitwise equal (both frameworks divide
and round to nearest even in fp32).  The w8a8 FFN is held to 1e-5 *
max|ref|: its integer contractions are exact in both, and only the fp32
gate between them may differ by an ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.moe.distribute import materialize_replica_stack as j_materialize
from repro.moe.expert import grouped_ffn as j_grouped_ffn
from repro.moe.expert import quantize_weight_cols as j_quantize_weight_cols
from repro_torch.core import quantize as tq
from repro_torch.moe.distribute import materialize_replica_stack
from repro_torch.moe.expert import grouped_ffn, quantize_weight_cols


def _rows(shape, seed=0, zero_rows=True):
    """N(0, 1) rows with a spread of magnitudes; some rows all zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * np.exp(rng.standard_normal(shape[:-1]
                                                                + (1,)))
    if zero_rows:
        x.reshape(-1, shape[-1])[::5] = 0.0
    return x.astype(np.float32)


def _same(t: torch.Tensor, j) -> None:
    """Bitwise equality of a torch tensor and a JAX array."""
    j = np.asarray(j)
    if t.dtype == torch.bfloat16:
        t, j = t.view(torch.int16), j.view(np.int16)
    a = t.numpy()
    assert a.dtype == j.dtype and a.shape == j.shape
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  j.reshape(-1).view(np.uint8))


def _inputs(dtype):
    x = _rows((3, 17, 40))
    if dtype == "bf16":
        return torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(
            x, jnp.bfloat16)
    return torch.from_numpy(x), jnp.asarray(x)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_rows_and_encode_int8_bitwise(dtype):
    xt, xj = _inputs(dtype)
    qt, st = tq.quantize_rows(xt)
    qj, sj = jq.quantize_rows(xj)
    _same(qt, qj)
    _same(st, sj)
    assert (st.reshape(-1)[::5] == 0).all()           # zero rows: scale 0
    _same(tq.dequantize_rows(qt, st), jq.dequantize_rows(qj, sj))
    # A per-tensor scale, through encode_int8 / decode_int8 directly.
    _same(tq.tensor_scale(xt), jq.tensor_scale(xj))
    code_t = tq.encode_int8(xt, tq.tensor_scale(xt))
    code_j = jq.encode_int8(xj, jq.tensor_scale(xj))
    _same(code_t, code_j)
    _same(tq.decode_int8(code_t, tq.tensor_scale(xt)),
          jq.decode_int8(code_j, jq.tensor_scale(xj)))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
def test_wire_codec_bitwise(dtype, wire):
    xt, xj = _inputs(dtype)
    bt, bj = tq.encode_wire(xt, wire), jq.encode_wire(xj, wire)
    _same(bt, bj)
    out = torch.float32 if dtype == "fp32" else torch.bfloat16
    _same(tq.decode_wire(bt, wire, out),
          jq.decode_wire(bj, wire, jnp.float32 if dtype == "fp32"
                         else jnp.bfloat16))
    if wire == "int8":
        assert bt.shape[-1] == xt.shape[-1] + 4
        for t, j in zip(tq.split_wire_int8(bt), jq.split_wire_int8(bj)):
            _same(t, j)


def test_split_wire_int8_of_a_strided_slot_view():
    """Rows D + 4 = 44 bytes apart inside a larger buffer: the scale lanes
    are not 4-byte aligned, and split must still read them right."""
    x = _rows((2, 6, 40), seed=3)
    buf = tq.encode_wire(torch.from_numpy(x), "int8")
    big = torch.zeros((2, 7, 44), dtype=torch.int8)
    big[:, 1:] = buf
    q, s = tq.split_wire_int8(big[:, 1:])
    assert q.stride() == (7 * 44, 44, 1)
    qj, sj = jq.split_wire_int8(jq.encode_wire(jnp.asarray(x), "int8"))
    _same(q.contiguous(), qj)
    _same(s, sj)


def test_byte_helpers_match():
    for wire in ("none", "bf16", "int8"):
        assert tq.wire_dtype_bytes(wire) == jq.wire_dtype_bytes(wire)
        assert tq.payload_bytes_per_item(4096, wire, 2) == \
            jq.payload_bytes_per_item(4096, wire, 2)
        assert tq.expert_wire_bytes(4096, 1408, wire) == \
            jq.expert_wire_bytes(4096, 1408, wire)
    with pytest.raises(ValueError):
        tq.encode_wire(torch.zeros(2, 2), "fp8")


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_quantize_weight_cols_bitwise(dtype):
    w = _rows((3, 40, 24), seed=4)
    w[1, :, 5] = 0.0                                   # an all-zero column
    wt = torch.from_numpy(w)
    wj = jnp.asarray(w)
    if dtype == "bf16":
        wt, wj = wt.to(torch.bfloat16), wj.astype(jnp.bfloat16)
    for t, j in zip(quantize_weight_cols(wt), j_quantize_weight_cols(wj)):
        _same(t, j)


def _ffn_inputs(G=4, C=16, D=32, F=48, seed=5):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((G, C, D)).astype(np.float32)
    valid = rng.random((G, C)) < 0.8
    w1 = (rng.standard_normal((G, D, F)) * D ** -0.5).astype(np.float32)
    w3 = (rng.standard_normal((G, D, F)) * D ** -0.5).astype(np.float32)
    w2 = (rng.standard_normal((G, F, D)) * F ** -0.5).astype(np.float32)
    return xs, valid, w1, w3, w2


@pytest.mark.parametrize("encoded", [False, True])
@pytest.mark.parametrize("precomputed", [False, True])
def test_grouped_ffn_int8_matches_jax(encoded, precomputed):
    """fp activations, or int8 wire codes + scales (the end-to-end
    quantized path); weights quantized in the call or kept beforehand
    (the port's layer keeps them)."""
    xs, valid, w1, w3, w2 = _ffn_inputs()
    ws_t = [torch.from_numpy(w) for w in (w1, w3, w2)]
    ws_j = [jnp.asarray(w) for w in (w1, w3, w2)]
    kw_t, kw_j = {}, {}
    xs_t, xs_j = torch.from_numpy(xs), jnp.asarray(xs)
    if encoded:
        xs_t, kw_t["xs_scale"] = tq.split_wire_int8(tq.encode_wire(xs_t,
                                                                   "int8"))
        xs_j, kw_j["xs_scale"] = jq.split_wire_int8(jq.encode_wire(xs_j,
                                                                   "int8"))
    if precomputed:
        kw_t["wq"] = tuple(quantize_weight_cols(w) for w in ws_t)
    y_t = grouped_ffn(xs_t, torch.from_numpy(valid), *ws_t, ffn_dtype="int8",
                      **kw_t)
    y_j = np.asarray(j_grouped_ffn(xs_j, jnp.asarray(valid), *ws_j,
                                   ffn_dtype="int8", **kw_j))
    assert y_t.dtype == torch.float32
    assert not y_t.numpy()[~valid].any()               # padded rows zero
    scale = np.abs(y_j).max()
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("wire", ["none", "bf16", "int8"])
def test_replica_stream_matches_jax(wire):
    """A hand-made plan with one replica (slot 1 copies expert 2; slot 0
    holds none): the replica is the wire image of its main, bitwise."""
    rng = np.random.default_rng(6)
    ws = [rng.standard_normal(s).astype(np.float32)
          for s in ((4, 8, 12), (4, 8, 12), (4, 12, 8))]
    ws[0][2, 3] = 0.0                                  # a zero row
    x_slots = np.array([[-1, 2]], dtype=np.int32)
    out = tuple(torch.full((2,) + w.shape[1:], 7.0) for w in ws)
    got = materialize_replica_stack(
        tuple(torch.from_numpy(w) for w in ws), torch.from_numpy(x_slots),
        0, None, out=out, wire_dtype=wire)
    want = j_materialize(tuple(jnp.asarray(w) for w in ws),
                         jnp.asarray(x_slots), jnp.asarray(0, jnp.int32),
                         None, wire_dtype=wire)
    for t, o, j, w in zip(got, out, want, ws):
        assert t.data_ptr() == o.data_ptr()            # written in place
        _same(t, j)
        assert not t[0].any()
        if wire == "none":
            np.testing.assert_array_equal(t[1].numpy(), w[2])

"""Adafactor, the stochastic int8 codec and the int8 gradient all-reduce of
the port against the JAX package's, on the CPU.

Tolerances: Adafactor in fp32 within 1e-5 of each tensor's max|ref| over
three steps (the column means and the RMS sum in other orders); with bf16
parameters, every updated parameter within one bf16 step (ulp) of JAX's
(the fp32 update is rounded once to bf16 on both sides, so a last-bit
difference of the update can move the rounding by one step).  The chunked
update (blocks of rows) against the unchunked one within 1e-6 relative
(the column sum is taken block by block).  The int8 codes are bitwise
JAX's, given JAX's own uniform draws for stochastic rounding; the
decompressed values and the error-feedback residual within fp32 rounding.
``psum_compressed`` at R 4: four gloo processes against one JAX
``shard_map`` on four virtual devices, the mean within 1e-6 relative and
the residual within 1e-6 of max|g| (fp32 rounding of g).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.optim import grad_compress as jgc
from repro.optim import optimizer as jopt
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import quantize as tq
from repro_torch.optim import grad_compress as tgc
from repro_torch.optim import optimizer as topt

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(3, 8, 6), (8, 6), (6,), ()]


def _rel(t, j) -> float:
    t = t.detach().double().numpy() if isinstance(t, torch.Tensor) else t
    j = np.asarray(j, np.float64)
    return float(np.abs(t - j).max() / max(np.abs(j).max(), 1e-30))


def _adafactor_runs(dtype, steps=3, lr=1e-2, chunk=None, monkeypatch=None):
    """JAX's and the port's Adafactor over ``steps`` steps from the same
    parameters and gradients (numpy, seed 0); returns both sides."""
    rng = np.random.default_rng(0)
    init = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jp = [jnp.asarray(p, jdt) for p in init]
    jo = jopt.adafactor(lr)
    js = jo.init(jp)
    tp = [torch.from_numpy(p).to(dtype) for p in init]
    if chunk is not None:
        monkeypatch.setattr(topt, "CHUNK", chunk)
    to = topt.adafactor(lr)
    ts = to.init(tp)
    for i, gs in enumerate(grads):
        upd, js = jo.update([jnp.asarray(g, jdt) for g in gs], js, jp, i)
        jp = jopt.apply_updates(jp, upd)
        ts = to.update([torch.from_numpy(g).to(dtype) for g in gs], ts, tp,
                       i)
    return (jp, js), (tp, ts)


def test_adafactor_matches_jax_fp32():
    """Three steps on (E, D, F), (D, F), (D,) and (): parameters, v_row and
    v_col within 1e-5 of max|ref|; the state's shapes as the reference's
    (factored iff ndim >= 2, v_col () otherwise)."""
    (jp, js), (tp, ts) = _adafactor_runs(torch.float32)
    for i, s in enumerate(SHAPES):
        assert _rel(tp[i], jp[i]) <= 1e-5, ("param", s)
        assert tuple(ts.v_row[i].shape) == js.v_row[i].shape, s
        assert tuple(ts.v_col[i].shape) == js.v_col[i].shape, s
        assert _rel(ts.v_row[i], js.v_row[i]) <= 1e-5, ("v_row", s)
        if len(s) >= 2:
            assert _rel(ts.v_col[i], js.v_col[i]) <= 1e-5, ("v_col", s)


def test_adafactor_matches_jax_bf16_within_one_ulp():
    (jp, _), (tp, ts) = _adafactor_runs(torch.bfloat16)
    for i, s in enumerate(SHAPES):
        t = tp[i].float().numpy()
        j = np.asarray(jp[i].astype(jnp.float32))
        ulp = np.abs(j) * 2.0 ** -7 + 1e-30       # one bf16 step at |j|
        assert np.all(np.abs(t - j) <= ulp * 1.0001), s
        assert ts.v_row[i].dtype == torch.float32


@pytest.mark.parametrize("chunk", [1, 12, 50])
def test_adafactor_chunked_equals_unchunked(chunk, monkeypatch):
    """Blocks of one row, of two rows (12 elements at 6 columns) and of
    eight rows: the same parameters and state as one block, within 1e-6
    relative."""
    _, (tp, ts) = _adafactor_runs(torch.float32)
    _, (cp, cs) = _adafactor_runs(torch.float32, chunk=chunk,
                                  monkeypatch=monkeypatch)
    for a, b in zip(tp + ts.v_row + ts.v_col, cp + cs.v_row + cs.v_col):
        assert _rel(b, a.numpy()) <= 1e-6


def test_adafactor_converges():
    """``test_substrate.py::test_adafactor_converges`` ported: 400 steps
    of lr 0.3 on a quadratic bowl bring the loss below 1e-2."""
    w = torch.tensor([2.0, -1.5])
    target = torch.tensor([0.3, 0.7])
    opt = topt.adafactor(3e-1)
    state = opt.init([w])
    for i in range(400):
        state = opt.update([2 * (w - target)], state, [w], i)
    assert float(((w - target) ** 2).sum()) < 1e-2


def test_adafactor_checkpoint_round_trip(tmp_path):
    """An Adafactor train state (reduced Jamba, one step taken) saved at
    global shapes and restored into a fresh state gives the same
    parameters, v_row, v_col, router bias and step, bit for bit."""
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.models.model import init_lm
    from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
    from repro_torch.train import loop

    cfg = reduced(get_config("jamba-v0.1-52b"), layers=2)
    rcfg = RuntimeConfig()
    pctx = ParallelCtx()

    def fresh(seed):
        params = init_lm(cfg, rcfg, pctx, torch.Generator().manual_seed(seed),
                         device="cpu")
        return loop.init_train_state(params, topt.adafactor(1e-3), cfg)

    state = fresh(0)
    step = loop.make_train_step(cfg, rcfg, pctx, topt.adafactor(1e-3))
    tok = torch.randint(0, cfg.vocab_size, (2, 32),
                        generator=torch.Generator().manual_seed(1))
    state, _ = step(state, {"tokens": tok, "targets": tok})
    tree = loop.state_to_global(state, pctx)
    assert any(k.startswith("opt_state/v_row/") for k in tree)
    ck = Checkpointer(str(tmp_path))
    ck.save(state.step, tree, blocking=True)
    back, at = ck.restore(loop.global_shapes(state, pctx))
    other = loop.state_from_global(fresh(5), back, pctx)
    assert at == state.step == other.step == 1
    got = loop.state_to_global(other, pctx)
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k


# ------------------------------------------------------------ int8 codec


def test_stochastic_encode_matches_jax_given_its_draws():
    """``encode_int8`` and ``quantize_rows`` with JAX's own uniform draws
    (``jax.random.uniform`` of the key JAX is given) as ``noise``: the codes
    bitwise JAX's, per tensor and per row, zero rows and zero scales
    included; a ``torch.Generator`` gives codes within one step of round
    to nearest."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 40)).astype(np.float32)
    x[2] = 0.0
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, x.shape, jnp.float32))
    xs = jnp.asarray(x)
    scale = jq.tensor_scale(xs)
    jcode = np.asarray(jq.encode_int8(xs, scale, key=key))
    tcode = tq.encode_int8(torch.from_numpy(x),
                           torch.from_numpy(np.array(scale)),
                           noise=torch.from_numpy(u))
    np.testing.assert_array_equal(tcode.numpy(), jcode)
    jq_rows, js = jq.quantize_rows(xs, key=key)
    tq_rows, ts = tq.quantize_rows(torch.from_numpy(x),
                                   noise=torch.from_numpy(u))
    np.testing.assert_array_equal(tq_rows.numpy(), np.asarray(jq_rows))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert not tq_rows[2].any()
    zero = tq.encode_int8(torch.from_numpy(x), torch.zeros(()),
                          noise=torch.from_numpy(u))
    assert not zero.any()
    nearest = tq.encode_int8(torch.from_numpy(x),
                             torch.from_numpy(np.array(scale)))
    drawn = tq.encode_int8(torch.from_numpy(x),
                           torch.from_numpy(np.array(scale)),
                           generator=torch.Generator().manual_seed(0))
    assert (drawn.int() - nearest.int()).abs().max() <= 1


def test_compress_matches_jax():
    """``compress`` / ``decompress`` over three steps with error feedback:
    codes bitwise, scale and residual within fp32 rounding."""
    rng = np.random.default_rng(1)
    js = jgc.init_state({"g": jnp.zeros((5, 7))})["g"]
    ts = tgc.init_state([torch.zeros((5, 7))])[0]
    for _ in range(3):
        g = rng.standard_normal((5, 7)).astype(np.float32)
        jcode, jscale, js = jgc.compress(jnp.asarray(g), js)
        tcode, tscale, ts = tgc.compress(torch.from_numpy(g), ts)
        np.testing.assert_array_equal(tcode.numpy(), np.asarray(jcode))
        assert _rel(tscale, jscale) <= 1e-7
        assert _rel(ts.residual, js.residual) <= 1e-6
        assert _rel(tgc.decompress(tcode, tscale),
                    jgc.decompress(jcode, jscale)) <= 1e-7


def test_compress_error_feedback_unbiased():
    """``test_substrate.py::test_compress_error_feedback_unbiased``
    ported: the mean of 50 decompressed steps of one gradient is within
    2e-2 of it."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    state = tgc.CompressState(torch.zeros(64))
    acc = torch.zeros(64, dtype=torch.float64)
    for _ in range(50):
        q, scale, state = tgc.compress(g, state)
        acc += tgc.decompress(q, scale).double()
    np.testing.assert_allclose((acc / 50).numpy(), g.double().numpy(),
                               atol=2e-2)


R = 4
_GRADS = np.random.default_rng(7).standard_normal((3, R, 9, 5)).astype(
    np.float32)

_JAX_PSUM = r"""
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.models.transformer import shard_map_compat as shard_map
from repro.optim.grad_compress import CompressState, psum_compressed
grads = np.load({path!r})["grads"]
mesh = Mesh(np.array(jax.devices()[:{R}]), ("pod",))

def step(g, r):
    out, st = psum_compressed(g[0], CompressState(r[0]), "pod")
    return out[None], st.residual[None]

f = jax.jit(shard_map(step, mesh=mesh, in_specs=(P("pod"), P("pod")),
                      out_specs=(P("pod"), P("pod"))))
res = jnp.zeros(grads.shape[1:], jnp.float32)
outs, resids = [], []
for g in grads:
    o, res = f(jnp.asarray(g), res)
    outs.append(np.asarray(o)); resids.append(np.asarray(res))
np.savez({out!r}, outs=np.stack(outs), resids=np.stack(resids))
print("DONE")
"""


def _psum_worker(rank, world, port, path, out_dir):
    torch.set_num_threads(1)
    from repro_torch.optim import grad_compress
    from repro_torch.parallel import collectives

    group = collectives.init("gloo", world_size=world, rank=rank,
                             init_method=f"tcp://localhost:{port}",
                             timeout_s=120)
    grads = np.load(path)["grads"]
    state = grad_compress.init_state([torch.zeros(grads.shape[2:])])[0]
    outs, resids = [], []
    for g in grads:
        out, state = grad_compress.psum_compressed(
            torch.from_numpy(g[rank]), state, group)
        outs.append(out.numpy())
        resids.append(state.residual.numpy())
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), outs=np.stack(outs),
             resids=np.stack(resids))
    collectives.destroy()


def _psum_spawn(path, out_dir):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_psum_worker, args=(R, port, path, out_dir), nprocs=R,
             join=True)


def test_psum_compressed_matches_jax_shard_map(tmp_path):
    """Three steps of ``psum_compressed`` at R 4 (gloo, four processes)
    against JAX's under ``shard_map`` on four virtual devices, each rank's
    own gradient: the mean within fp32 rounding of JAX's (the codes' int32
    sum is exact on both sides), each rank's residual too, and every rank
    the same mean."""
    from tests.helpers import run_multidevice

    path = str(tmp_path / "grads.npz")
    np.savez(path, grads=_GRADS)
    jout = str(tmp_path / "jax.npz")
    assert "DONE" in run_multidevice(
        _JAX_PSUM.format(path=path, R=R, out=jout), R, 300)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", "from tests.test_torch_optim_compress import "
         f"_psum_spawn; _psum_spawn({path!r}, {str(tmp_path)!r})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = np.load(jout)
    for r in range(R):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert _rel(got["outs"], want["outs"][:, r]) <= 1e-6, r
        # The residual g - q scale is small beside g: it agrees to fp32
        # rounding of g (XLA fuses the product into the subtraction).
        err = np.abs(got["resids"] - want["resids"][:, r]).max()
        assert err <= 1e-6 * np.abs(_GRADS).max(), r
        np.testing.assert_array_equal(
            got["outs"], np.load(tmp_path / "rank0.npz")["outs"])

"""GPipe over a group of ranks (``repro_torch.parallel.pipeline``) against
the JAX package's ``pipeline_apply`` under ``shard_map``.

JAX's case of ``tests/test_multidevice.py::test_pipeline_pod_axis`` (4
stages, 6 microbatches of (2, 8), 8 tanh layers, two a stage) runs on four
virtual CPU devices and writes its inputs and outputs; four gloo
processes run the port's pipeline on the same inputs.  Every stage's
output within 1e-5 of JAX's and of the sequential layers.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
N, M, B, D, L = 4, 6, 2, 8, 8

_JAX = r"""
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.models.transformer import shard_map_compat as shard_map
from repro.parallel.pipeline import pipeline_apply
n, M, B, D, L = {n}, {m}, {b}, {d}, {l}
mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))
w = jax.random.normal(jax.random.PRNGKey(0), (L, D, D)) * 0.3
x = jax.random.normal(jax.random.PRNGKey(1), (M, B, D))
def stage_fn(x, ws):
    for i in range(ws.shape[0]):
        x = jnp.tanh(x @ ws[i])
    return x
f = shard_map(lambda x, w: pipeline_apply(x, w, stage_fn, axis_name="pod",
                                          num_stages=n),
              mesh=mesh, in_specs=(P(None, None, None), P("pod", None, None)),
              out_specs=P(None, None, None))
np.savez({out!r}, w=np.asarray(w), x=np.asarray(x),
         y=np.asarray(jax.jit(f)(x, w)))
print("DONE")
"""


def _stage_fn(x, ws):
    for w in ws:
        x = torch.tanh(x @ w)
    return x


def _worker(rank, world, port, inputs, out_dir):
    torch.set_num_threads(1)
    from repro_torch.parallel import collectives
    from repro_torch.parallel.pipeline import pipeline_apply

    g = collectives.init("gloo", world_size=world, rank=rank,
                         init_method=f"tcp://localhost:{port}", timeout_s=120)
    data = np.load(inputs)
    per = L // world
    ws = torch.from_numpy(data["w"][rank * per:(rank + 1) * per])
    y = pipeline_apply(torch.from_numpy(data["x"]), ws, _stage_fn, g, world)
    np.save(os.path.join(out_dir, f"rank{rank}.npy"), y.numpy())
    collectives.destroy()


def _spawn(inputs, out_dir):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(N, port, inputs, out_dir), nprocs=N, join=True)


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    from tests.helpers import run_multidevice

    tmp = tmp_path_factory.mktemp("pipeline")
    jax_out = str(tmp / "jax.npz")
    assert "DONE" in run_multidevice(
        _JAX.format(n=N, m=M, b=B, d=D, l=L, out=jax_out), N, 300)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", f"from tests.test_torch_pipeline import "
         f"_spawn; _spawn({jax_out!r}, {str(tmp)!r})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(jax_out)), [np.load(tmp / f"rank{r}.npy")
                                    for r in range(N)]


@pytest.mark.parametrize("stage", range(N))
def test_pipeline_matches_jax_and_sequential(pipeline_run, stage):
    jax_out, ys = pipeline_run
    y = ys[stage]
    assert y.shape == (M, B, D)
    np.testing.assert_allclose(y, jax_out["y"], rtol=1e-5, atol=1e-5)
    ref = torch.from_numpy(jax_out["x"])
    for w in torch.from_numpy(jax_out["w"]):
        ref = torch.tanh(ref @ w)
    np.testing.assert_allclose(y, ref.numpy(), rtol=1e-5, atol=1e-5)

"""The port's checkpointer (``repro_torch.checkpoint``) on the CPU.

* The round trip and the manifest's layout (``step_%08d/manifest.json``
  and one ``.npy`` a leaf, global shapes and dtypes, bf16 as its bits).
* The async save, ``wait()``, the ``keep`` gc and an atomic re-save of one
  step, as ``tests/test_substrate.py`` holds the reference's.
* A restore onto other group sizes: one run of four gloo processes trains
  ``tiny-moe`` one step on EP 4 (``make_test_mesh(1, 4)``), saves the
  global train state, restores it onto data 2 x EP 2 (the moments now
  sharded over other replicas), where ``state_to_global`` gives the same
  tensors bit for bit, saves again from there, and the test restores that
  onto one rank (data 1, EP 1): the same global tensors, and the next
  step's loss equal to the four-rank run's within 1e-5 (the aux loss off:
  it is summed per rank, so it depends on the mesh).
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer

ROOT = Path(__file__).resolve().parents[1]
WORLD, B, S = 4, 4, 16


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {"params/w": torch.randn(3, 5, generator=gen),
            "params/h": torch.randn(4, 2, generator=gen).to(torch.bfloat16),
            "opt_state/mu/w": np.arange(15, dtype=np.float32).reshape(3, 5),
            "step": 7}


def _equal(a, b):
    """Same dtype and values, bit for bit (a restored leaf is numpy, or a
    bfloat16 tensor)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def test_roundtrip_and_manifest_layout(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(7, tree, blocking=True)
    d = tmp_path / "step_00000007"
    man = json.loads((d / "manifest.json").read_text())
    assert man["step"] == 7
    assert man["leaves"]["params/w"]["shape"] == [3, 5]
    assert man["leaves"]["params/w"]["dtype"] == "float32"
    assert man["leaves"]["params/h"]["dtype"] == "bfloat16"
    assert man["leaves"]["step"]["shape"] == []
    files = sorted(p.name for p in d.iterdir())
    assert files == sorted(["manifest.json"] + [
        e["file"] for e in man["leaves"].values()])
    assert all(f.endswith(".npy") for f in files if f != "manifest.json")
    out, step = ck.restore()
    assert step == 7 and set(out) == set(tree)
    for k in tree:
        _equal(out[k], tree[k])
    with pytest.raises(ValueError):
        ck.restore({"params/w": [5, 3]})
    with pytest.raises(KeyError):
        ck.restore({"params/missing": [1]})


def test_async_save_and_wait(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = {"w": torch.ones(256, 256)}
    ck.save(1, tree)                         # async
    tree["w"].zero_()                        # the snapshot was taken
    ck.wait()
    assert ck.latest_step() == 1
    out, _ = ck.restore()
    assert (out["w"] == 1).all()


def test_keep_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    for s in (10, 20, 30, 40, 50):
        ck.save(s, {"a": torch.full((2,), float(s))})
    ck.wait()
    assert ck.all_steps() == [30, 40, 50]
    out, step = ck.restore()
    assert step == 50 and (out["a"] == 50).all()


def test_atomic_resave_of_one_step(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(2, {"a": torch.zeros(3)}, blocking=True)
    ck.save(2, {"a": torch.ones(3), "b": torch.ones(1)}, blocking=True)
    assert ck.all_steps() == [2]
    assert not any(p.name.endswith(".tmp") for p in tmp_path.iterdir())
    out, _ = ck.restore()
    assert (out["a"] == 1).all() and set(out) == {"a", "b"}


def _setup(pctx):
    from repro_torch.configs import get_config
    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.models.model import init_lm
    from repro_torch.models.transformer import RuntimeConfig
    from repro_torch.optim import adamw
    from repro_torch.train.loop import (TrainConfig, init_train_state,
                                        make_train_step)

    cfg = get_config("tiny-moe")
    # No aux loss: it is summed per rank, so it depends on the mesh.
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, aux_loss_weight=0.0))
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                         cf_pair=8.0, cf_slot=8.0)
    opt = adamw(1e-3)
    params = init_lm(cfg, rcfg, pctx, torch.Generator().manual_seed(0),
                     device="cpu")
    state = init_train_state(params, opt, cfg)
    return state, make_train_step(cfg, rcfg, pctx, opt, TrainConfig())


def _batch(step):
    rng = np.random.default_rng(step)
    return {k: torch.from_numpy(rng.integers(0, 128, (B, S)))
            for k in ("tokens", "targets")}


def _worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_test_mesh, pctx_for_mesh
    from repro_torch.parallel import collectives
    from repro_torch.train.loop import state_from_global, state_to_global

    collectives.init("gloo", world_size=world, rank=rank,
                     init_method=f"tcp://localhost:{port}", timeout_s=120)
    ep4 = pctx_for_mesh(make_test_mesh(1, 4))
    d2e2 = pctx_for_mesh(make_test_mesh(2, 2))
    state, step = _setup(ep4)
    state, _ = step(state, _batch(0))
    ck = Checkpointer(os.path.join(out_dir, "ep4"), group=ep4.world_group)
    saved = state_to_global(state, ep4)
    ck.save(1, saved, blocking=True)

    state2, step2 = _setup(d2e2)
    ck2 = Checkpointer(os.path.join(out_dir, "ep4"), group=d2e2.world_group)
    tree, at = ck2.restore(None, 1)
    state2 = state_from_global(state2, tree, d2e2)
    back = state_to_global(state2, d2e2)
    out = {"restored_step": at, "state_step": state2.step,
           "same": all(torch.equal(torch.as_tensor(back[k]),
                                   torch.as_tensor(saved[k]))
                       for k in saved)}
    ck3 = Checkpointer(os.path.join(out_dir, "d2e2"), group=d2e2.world_group)
    ck3.save(1, back, blocking=True)
    _, m = step2(state2, _batch(1))
    out["next_loss"] = float(m["loss"])
    _, m = step(state, _batch(1))
    out["next_loss_ep4"] = float(m["loss"])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    collectives.destroy()


def _spawn(out_dir):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(WORLD, port, out_dir), nprocs=WORLD, join=True)


@pytest.fixture(scope="module")
def elastic_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", f"from tests.test_torch_checkpoint import "
         f"_spawn; _spawn({str(tmp)!r})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return tmp, [dict(np.load(tmp / f"rank{r}.npz")) for r in range(WORLD)]


def test_restore_onto_data2_ep2_gives_the_same_tensors(elastic_run):
    _, ranks = elastic_run
    for r in ranks:
        assert bool(r["same"])
        assert int(r["restored_step"]) == 1 and int(r["state_step"]) == 1
        np.testing.assert_allclose(r["next_loss"], r["next_loss_ep4"],
                                   rtol=1e-5)


def test_restore_onto_one_rank_gives_the_same_tensors(elastic_run):
    from repro_torch.models.transformer import ParallelCtx
    from repro_torch.train.loop import (global_shapes, state_from_global,
                                        state_to_global)

    tmp, ranks = elastic_run
    first, _ = Checkpointer(str(tmp / "ep4")).restore()
    again, _ = Checkpointer(str(tmp / "d2e2")).restore()
    assert set(first) == set(again)
    for k in first:
        _equal(again[k], first[k])
    state, step = _setup(ParallelCtx())
    assert global_shapes(state, ParallelCtx()) == {
        k: list(np.shape(v)) for k, v in again.items()}
    state = state_from_global(state, again, ParallelCtx())
    for k, v in state_to_global(state, ParallelCtx()).items():
        _equal(v, again[k])
    _, m = step(state, _batch(1))
    np.testing.assert_allclose(float(m["loss"]),
                               float(ranks[0]["next_loss_ep4"]), rtol=1e-5)
    assert first["params/layers.0.moe.w1"].shape[0] == 8

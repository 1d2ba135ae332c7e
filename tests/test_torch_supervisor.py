"""The port's fault-tolerant Supervisor (``repro_torch.train.fault``) on the
CPU.

* The trainer (``launch.train.train``, ``tiny-moe``, a checkpoint every 2
  steps) with a ``RuntimeError`` injected after step 3 has run (its
  update already applied in place): the Supervisor restores step 2 and
  replays, and the replayed losses and the final checkpoint equal a clean
  run's bit for bit.  The same on a mesh of two gloo ranks (EP 2), the
  fault met on both ranks at the same step.
* More faults than ``max_restarts`` raise; a fault before any checkpoint
  re-raises; a flat mapping of tensors recovers as the reference's
  ``tests/test_substrate.py`` case does.
* The straggler flags and the ``RankHealth`` state equal the JAX
  ``Supervisor._track_time``'s fed the same step times (host numpy in both
  packages).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.train.fault import Supervisor, SupervisorConfig

ROOT = Path(__file__).resolve().parents[1]
RUN = dict(steps=6, batch=4, seq=16, reduce=False, device="cpu",
           ckpt_every=2, log_every=100, lr=1e-3)
FAULT_AT = 3


def _inject(at, times=1):
    """A step hook raising a RuntimeError after the step ``at`` ran (the
    parameters already updated in place), ``times`` times."""
    def hook(fn):
        left = [times]

        def step(state, batch):
            at_step = state.step
            out = fn(state, batch)
            if at_step == at and left[0] > 0:
                left[0] -= 1
                raise RuntimeError("injected device failure")
            return out
        return step
    return hook


def _train(ckpt_dir, hook=None, pctx=None, **kw):
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import ParallelCtx

    seen = []
    run = train("tiny-moe", ckpt_dir=str(ckpt_dir), step_hook=hook,
                pctx=pctx or ParallelCtx(),
                on_metrics=lambda s, m: seen.append((s, float(m["loss"]))),
                **{**RUN, **kw})
    return run, seen


def _final(ckpt_dir):
    tree, step = Checkpointer(str(ckpt_dir)).restore()
    return tree, step


def test_injected_fault_replays_bitwise(tmp_path):
    clean, seen_c = _train(tmp_path / "clean")
    faulty, seen_f = _train(tmp_path / "faulty", _inject(FAULT_AT))
    assert clean.restarts == 0 and faulty.restarts == 1
    assert [s for s, _ in seen_f] == [0, 1, 2, 2, 3, 4, 5]
    clean_loss = dict(seen_c)
    for s, loss in seen_f:
        assert loss == clean_loss[s], s
    a, sa = _final(tmp_path / "clean")
    b, sb = _final(tmp_path / "faulty")
    assert sa == sb == RUN["steps"] and set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def test_max_restarts_exceeded_raises(tmp_path):
    # max_restarts 3: the fourth fault gives up (the reference's count).
    with pytest.raises(RuntimeError, match="giving up after 4 restarts"):
        _train(tmp_path, _inject(FAULT_AT, times=10))


def test_fault_before_any_checkpoint_reraises(tmp_path):
    with pytest.raises(RuntimeError, match="injected"):
        _train(tmp_path, _inject(0))


def test_flat_mapping_state_recovers(tmp_path):
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 7:
            raise RuntimeError("injected device failure")
        return {"w": state["w"] + batch}, {"loss": state["w"].sum()}

    sup = Supervisor(SupervisorConfig(checkpoint_dir=str(tmp_path),
                                      checkpoint_every=2),
                     step_fn, lambda step: torch.tensor(1.0))
    state, final = sup.run({"w": torch.zeros(())}, 0, 10)
    assert final == 10 and sup.restarts == 1
    assert float(state["w"]) == 10.0


# Step times: steady, a few slow steps after the warm-up of 8 (flagged),
# and per-rank times where rank 2 runs at a quarter of the speed.
TIMES = [0.010, 0.011, 0.010, 0.012, 0.010, 0.011, 0.010, 0.010, 0.011,
         0.010, 0.250, 0.010, 0.011, 0.300, 0.010, 0.010]
RANK_TIMES = [[1.0, 1.0, 4.0, 1.0]] * 6 + [[1.0, 1.1, 1.0, 0.9]] * 12


def test_straggler_flags_and_health_match_jax(tmp_path):
    from repro.train.fault import Supervisor as JSupervisor
    from repro.train.fault import SupervisorConfig as JSupervisorConfig

    def make(cls, cfg_cls, d):
        return cls(cfg_cls(checkpoint_dir=str(tmp_path / d), num_ranks=4),
                   None, None)

    mine = make(Supervisor, SupervisorConfig, "torch")
    ref = make(JSupervisor, JSupervisorConfig, "jax")
    for i, dt in enumerate(TIMES):
        mine._track_time(i, dt)
        ref._track_time(i, dt)
    for i, rt in enumerate(RANK_TIMES):
        step = len(TIMES) + i
        mine._track_time(step, max(rt), rank_times=np.array(rt))
        ref._track_time(step, max(rt), rank_times=np.array(rt))
        np.testing.assert_array_equal(mine.health.weight, ref.health.weight)
        np.testing.assert_array_equal(mine.health.quarantined,
                                      ref.health.quarantined)
    assert mine.straggler_flags == ref.straggler_flags == [10, 16]
    assert mine._ewma == ref._ewma and mine._ewvar == ref._ewvar
    np.testing.assert_array_equal(mine.rank_health().planner_weights(),
                                  ref.rank_health().planner_weights())


def _worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_test_mesh, pctx_for_mesh
    from repro_torch.parallel import collectives

    collectives.init("gloo", world_size=world, rank=rank,
                     init_method=f"tcp://localhost:{port}", timeout_s=120)
    pctx = pctx_for_mesh(make_test_mesh(1, world))
    out = {}
    for tag, hook in (("clean", None), ("faulty", _inject(FAULT_AT))):
        run, seen = _train(os.path.join(out_dir, tag), hook, pctx)
        out[f"{tag}/steps"] = np.array([s for s, _ in seen])
        out[f"{tag}/losses"] = np.array([v for _, v in seen])
        out[f"{tag}/restarts"] = run.restarts
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    collectives.destroy()


def _spawn(out_dir):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(2, port, out_dir), nprocs=2, join=True)


def test_injected_fault_on_every_rank_replays_on_a_group(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", f"from tests.test_torch_supervisor import "
         f"_spawn; _spawn({str(tmp_path)!r})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for r in range(2):
        out = dict(np.load(tmp_path / f"rank{r}.npz"))
        assert int(out["clean/restarts"]) == 0
        assert int(out["faulty/restarts"]) == 1
        np.testing.assert_array_equal(out["faulty/steps"],
                                      [0, 1, 2, 2, 3, 4, 5])
        clean = dict(zip(out["clean/steps"], out["clean/losses"]))
        for s, v in zip(out["faulty/steps"], out["faulty/losses"]):
            assert v == clean[s], (r, s)
    a, _ = _final(tmp_path / "clean")
    b, _ = _final(tmp_path / "faulty")
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    assert a["params/layers.0.moe.w1"].shape[0] == 8

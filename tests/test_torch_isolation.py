"""The port stands alone: it imports neither ``jax`` nor the JAX package.

One test runs a reduced prefill of each ported arch that decodes (and of
GLM-4.5-Air under the int8 wire and w8a8 FFN) and a reduced forward of
HuBERT-XLarge's frames and InternVL2-26B's patches (the frontend stubs)
in a subprocess where ``import jax`` fails, through the gating and
flash-attention wrappers, then the plan
solve at R = 4 (``kernels/plan_solve``) and every balancer mode
(``kernels/eplb_place``, the metrics) with the plan check on (``analysis/``,
the schedule check too), a MoE layer (with a
``Resilience`` too) on a one-rank gloo
group through every collective of ``parallel/`` (and its backward through
their transposes), and one reduced train step through
``repro_torch.launch.train`` (``optim/``, ``train/``, ``data/``, the
Supervisor and ``checkpoint/``; ``parallel/pipeline`` is imported); the other
reads every source file of the port and ``chip_smoke.py``.  The first
also runs the int8 gradient all-reduce (``optim/grad_compress``) on the
group, stochastic rounding, a train cell of ``launch/specs`` on the meta
device, an Adafactor step of a reduced Jamba (remat, the SSD
backward), ``roofline.model_flops`` and ``examples.quickstart``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]

_CODE = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises ImportError
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.core.balancer import BalancerConfig
from repro_torch.launch import serve  # noqa: F401  (imports the whole path)
from repro_torch.models.model import init_caches, init_lm, prefill_step
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
for arch, q8 in (("glm45-106b-a12b", "none"), ("jamba-v0.1-52b", "none"),
                 ("glm45-106b-a12b", "int8"), ("qwen3-235b-a22b", "none"),
                 ("deepseek-v3-671b", "none"), ("dbrx-132b", "none"),
                 ("qwen2-72b", "none"), ("mistral-large-123b", "none"),
                 ("internlm2-1.8b", "none"), ("qwen3-0.6b", "none"),
                 ("mamba2-130m", "none"), ("internvl2-26b", "none")):
    cfg = reduced(get_config(arch))
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep"),
                         cf_pair=4.0, cf_slot=4.0, wire_dtype=q8,
                         ffn_dtype=q8)
    gen = torch.Generator(device="cpu").manual_seed(0)
    params = init_lm(cfg, rcfg, ParallelCtx(), gen, device="cpu")
    caches = init_caches(cfg, 1, 64, rcfg, device="cpu")
    toks = torch.from_numpy(np.arange(32, dtype=np.int64)[None]
                            % cfg.vocab_size)
    logits, _ = prefill_step(params, caches, toks, cfg, rcfg, ParallelCtx())
    assert logits.shape == (1, 32, cfg.vocab_size)
    assert torch.isfinite(logits).all()
from repro_torch.models.model import forward
for arch, key, rows in (("hubert-xlarge", "frames", 32),
                        ("internvl2-26b", "patches", 8)):
    cfg = reduced(get_config(arch))
    params = init_lm(cfg, rcfg, ParallelCtx(),
                     torch.Generator().manual_seed(0), device="cpu")
    batch = {"tokens": torch.zeros((1, 32), dtype=torch.int64),
             key: torch.randn((1, rows, cfg.d_model))}
    if key == "frames":
        del batch["tokens"]
    logits = forward(params, batch, cfg, rcfg, ParallelCtx())[0]
    assert logits.shape == (1, 32, cfg.vocab_size)
    assert torch.isfinite(logits).all()

import dataclasses
import socket
from repro_torch.core import planner
from repro_torch.kernels.plan_solve import ops as plan_ops
from repro_torch.moe.gating import GatingConfig
from repro_torch.moe.layer import MoEConfig, init_moe_params, moe_layer_local
from repro_torch.parallel import collectives
lam = torch.from_numpy(np.random.default_rng(0).integers(0, 50, (4, 16)))
plan = planner.solve_plan(lam, torch.arange(16) // 4, n_slot=2)
assert (plan.x >= 0).any() and int(plan.post_max) < int(plan.pre_max)
from repro_torch.analysis import errors, hosted_matrix, plan_verification
from repro_torch.analysis.sched_check import verify_schedule
from repro_torch.core import balancer, comm_plan, metrics
from repro_torch.moe.stages import Resilience
with plan_verification():
    for mode in balancer.MODES:
        pl = balancer.solve(lam, torch.arange(16) // 4,
                            BalancerConfig(mode=mode))
        assert metrics.report(lam, pl.u, torch.arange(16) // 4).max_fanout >= 1
sched = comm_plan.build_relay_schedule(hosted_matrix(pl),
                                       np.arange(16) // 4, 1 << 20)
assert not errors(verify_schedule(sched, home=np.arange(16) // 4,
                                  hosted=hosted_matrix(pl)))
with socket.socket() as s:
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
group = collectives.init("gloo", world_size=1, rank=0,
                         init_method=f"tcp://localhost:{port}")
cfg = MoEConfig(gating=GatingConfig(num_experts=16, top_k=2),
                balancer=BalancerConfig(mode="ultraep"), d_model=32, d_ff=16,
                ep_size=1, cap_pair=256, cap_slot=256)
p = init_moe_params(cfg, torch.Generator().manual_seed(0), device="cpu")
x = torch.randn(64, 32, generator=torch.Generator().manual_seed(1))
for mode in ("a2a", "replicated"):
    c = dataclasses.replace(cfg, dispatch_mode=mode)
    y_group = moe_layer_local(x, p, c, axis_name=group)[0]
    assert torch.equal(y_group, moe_layer_local(x, p, c)[0])
assert torch.equal(moe_layer_local(x, p, cfg, resilience=Resilience())[0],
                   moe_layer_local(x, p, cfg)[0])
p.requires_grad_(True)
(moe_layer_local(x, p, cfg, axis_name=group)[0] ** 2).sum().backward()
assert all(t.grad is not None for t in p.parameters())
from repro_torch.optim import grad_compress
st = grad_compress.init_state([x])[0]
mean, st = grad_compress.psum_compressed(x, st, group)
assert (mean - x).abs().max() <= x.abs().max() / 127
collectives.destroy()
from repro_torch.core import quantize
q = quantize.encode_int8(x, quantize.tensor_scale(x),
                         generator=torch.Generator().manual_seed(0))
assert q.dtype == torch.int8
from repro_torch.launch import specs
cell = specs.build_cell("deepseek-v3-671b", "train_4k", ParallelCtx(),
                        num_layers_override=2)
assert type(cell.arg_shapes[0].opt_state).__name__ == "AdafactorState"
from repro_torch.launch import train
from repro_torch.parallel import pipeline  # noqa: F401  (not on a path)
run = train.train("glm45-106b-a12b", steps=1, batch=2, seq=16, device="cpu")
assert len(run.losses) == 1 and np.isfinite(run.losses[0])
from repro_torch.optim import adafactor
from repro_torch.train.loop import init_train_state, make_train_step
cfg = reduced(get_config("jamba-v0.1-52b"), layers=2)
rcfg = RuntimeConfig()
params = init_lm(cfg, rcfg, ParallelCtx(), torch.Generator().manual_seed(0),
                 device="cpu")
state = init_train_state(params, adafactor(1e-3), cfg)
toks = torch.arange(32)[None] % cfg.vocab_size
state, m = make_train_step(cfg, rcfg, ParallelCtx(), adafactor(1e-3))(
    state, {"tokens": toks, "targets": toks})
assert np.isfinite(float(m["loss"]))
from repro_torch import roofline
from repro_torch.configs.base import SHAPES
assert roofline.model_flops(get_config("qwen3-0.6b"), SHAPES["train_4k"],
                            backward=True) > 0
from repro_torch.examples import quickstart
res = quickstart.main(["--device", "cpu"])
assert res["finite"] and res["layer_max_err"] <= 1e-4 * res["layer_max_ref"]
assert not any(m == "repro" or m.startswith(("repro.", "jax"))
               for m in sys.modules if sys.modules[m] is not None)
print("ok")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _CODE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path)
           if m == "jax" or m.startswith("jax.") or m == "repro"
           or m.startswith("repro.")]
    assert not bad, f"{path} imports {bad}"

"""Per-layer remat (``RuntimeConfig.remat``, on by default as in the
reference): the training step with remat on against remat off, on the
CPU, on reduced GLM-4.5-Air, DeepSeek-V3 (MLA, sigmoid router with the
aux-free bias) and Jamba-v0.1 (Mamba + MoE), in fp32, and on a 2-rank gloo
EP mesh.

Remat recomputes each layer in the backward from its kept input, with
the same kernels (here their plain versions) in the same order, so the
loss, aux, drops and counts are bitwise the same, and every gradient
within 1e-6 of its max|ref| (autograd sums the same terms; only the
grouping of the backward's graph differs).  The recompute routes every
token as the forward did: each layer's counts in the recompute equal the
forward's (``transformer.block_apply`` recorded, the checkpoint's early
stop off so the recompute runs each block to its end).  Serve paths never
remat.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.core.balancer import BalancerConfig
from repro_torch.models import transformer
from repro_torch.models.model import init_lm
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.train.loop import global_grads, loss_and_grads

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["glm45-106b-a12b", "deepseek-v3-671b", "jamba-v0.1-52b"]
MESH_ARCHS = ("glm45-106b-a12b",)


def _setup(arch, pctx=ParallelCtx()):
    cfg = reduced(get_config(arch))
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                         cf_pair=2.0, cf_slot=2.0)
    params = init_lm(cfg, rcfg, pctx, torch.Generator().manual_seed(0),
                     device="cpu")
    params.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    tgt = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    return cfg, rcfg, params, {"tokens": tok, "targets": tgt}


def _recorded(fn):
    """Run ``fn`` with every ``block_apply`` call's counts and aux
    recorded; returns (fn's result, calls)."""
    orig = transformer.block_apply
    calls = []

    def rec(*a, **k):
        out = orig(*a, **k)
        calls.append((out[3].detach().clone(), out[1].detach().clone()))
        return out

    transformer.block_apply = rec
    try:
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            return fn(), calls
    finally:
        transformer.block_apply = orig


def _step(params, batch, cfg, rcfg, remat, pctx=ParallelCtx(), fn=None):
    rc = dataclasses.replace(rcfg, remat=remat)
    fn = fn or loss_and_grads
    (loss, drops, counts, grads), calls = _recorded(
        lambda: fn(params, batch, cfg, rc, pctx))
    return loss, drops, counts, [g.clone() for g in grads], calls


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_matches_no_remat(arch):
    """Loss, drops and counts bitwise, every gradient within 1e-6 of its
    max|ref|; the recompute's counts and aux equal the forward's, layer by
    layer (remat on: 2 L block calls; off: L)."""
    cfg, rcfg, params, batch = _setup(arch)
    L = cfg.num_layers
    off = _step(params, batch, cfg, rcfg, False)
    on = _step(params, batch, cfg, rcfg, True)
    assert torch.equal(on[0], off[0])
    assert torch.equal(on[1], off[1]) and torch.equal(on[2], off[2])
    assert on[2].sum() > 0
    for name, a, b in zip([n for n, _ in params.named_parameters()], on[3],
                          off[3]):
        err = (a - b).abs().max().item()
        assert err <= 1e-6 * max(b.abs().max().item(), 1e-30), name
    assert len(off[4]) == L and len(on[4]) == 2 * L
    for i in range(L):
        fwd, rec = on[4][i], on[4][2 * L - 1 - i]
        assert torch.equal(fwd[0], rec[0]), f"layer {i} counts"
        assert torch.equal(fwd[1], rec[1]), f"layer {i} aux"
        assert torch.equal(fwd[0], off[4][i][0]), f"layer {i} vs no remat"


def test_remat_is_the_default_and_skips_serving():
    """``RuntimeConfig().remat`` is True (the reference's default); a
    forward without a gradient and a prefill chunk run each layer once."""
    from repro_torch.models.model import forward, init_caches, prefill_step

    assert RuntimeConfig().remat is True
    cfg, rcfg, params, batch = _setup("glm45-106b-a12b")
    with torch.no_grad():
        _, calls = _recorded(lambda: forward(params, batch, cfg, rcfg,
                                             ParallelCtx()))
        assert len(calls) == cfg.num_layers
        caches = init_caches(cfg, 2, 64, rcfg, device="cpu")
        _, calls = _recorded(lambda: prefill_step(
            params, caches, batch["tokens"], cfg, rcfg, ParallelCtx()))
        assert len(calls) == cfg.num_layers


def _mesh_worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_test_mesh, pctx_for_mesh
    from repro_torch.parallel import collectives

    collectives.init("gloo", world_size=world, rank=rank,
                     init_method=f"tcp://localhost:{port}", timeout_s=120)
    pctx = pctx_for_mesh(make_test_mesh(1, world))
    out = {}
    for arch in MESH_ARCHS:
        cfg, rcfg, params, batch = _setup(arch, pctx)
        off = _step(params, batch, cfg, rcfg, False, pctx, global_grads)
        on = _step(params, batch, cfg, rcfg, True, pctx, global_grads)
        L = cfg.num_layers
        out[f"{arch}/loss"] = np.array([float(on[0]), float(off[0])])
        out[f"{arch}/counts_equal"] = np.array(
            bool(torch.equal(on[2], off[2])) and bool(on[2].sum() > 0))
        out[f"{arch}/recompute_equal"] = np.array(all(
            torch.equal(on[4][i][0], on[4][2 * L - 1 - i][0])
            for i in range(L)) and len(on[4]) == 2 * L)
        out[f"{arch}/grad_rel"] = np.array(max(
            (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
            for a, b in zip(on[3], off[3])))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    collectives.destroy()


def _mesh_spawn(out_dir):
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_mesh_worker, args=(2, port, out_dir), nprocs=2, join=True)


def test_remat_on_a_two_rank_mesh(tmp_path):
    """EP 2 over gloo (the sequence split over the ranks, the EP
    collectives re-run in the recompute in the same order on both ranks):
    reduced GLM, remat on against off, the global loss
    bitwise, counts equal, the recompute's counts the forward's, every
    gradient within 1e-6 of its max|ref|, on each rank."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", "from tests.test_torch_remat import "
         f"_mesh_spawn; _mesh_spawn({str(tmp_path)!r})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for arch in MESH_ARCHS:
            loss = got[f"{arch}/loss"]
            assert loss[0] == loss[1], (r, arch)
            assert got[f"{arch}/counts_equal"], (r, arch)
            assert got[f"{arch}/recompute_equal"], (r, arch)
            assert got[f"{arch}/grad_rel"] <= 1e-6, (r, arch)

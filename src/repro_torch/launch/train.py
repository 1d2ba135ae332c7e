"""Training entry point: AdamW (or a train cell's optimizer) on the
synthetic domain-mixture stream.

Mirrors ``repro.launch.train``: trains a registered arch (``--reduce``d,
or at its published widths with ``--layers`` cutting the depth) with the
``ultraep`` balancer, capacity factors 4.0 and a cosine schedule, under
the fault-tolerant ``Supervisor`` (``repro_torch.train.fault``): a
checkpoint every ``--ckpt-every`` steps into ``--ckpt-dir`` (default: a
new directory under the temporary directory) and one at the end, crash
recovery with deterministic replay, straggler tracking;
``--ckpt-every 0`` turns checkpoints off.  Weights are random, drawn from
a ``torch.Generator`` seeded with ``seed`` on ``device``; batches come
from ``SyntheticLMStream`` with the same seed.  Each step is timed on the
host clock up to a device synchronisation.

On a mesh of ``--data`` x ``--ep`` ranks (``repro_torch.launch.mesh``)
under ``torchrun`` (env://): each rank trains its data row's rows of the
global batch on the reference's layout (tensor parallelism over the EP
axis, FSDP over the data axis, the sequence split over the EP axis
between blocks where it divides by ``--ep``, else whole on every rank);
gloo on ``--device cpu``, NCCL where each rank has a card, gloo where the
ranks share one card.

Example (the CPU, a reduced model; on a card drop ``--device``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm45-106b-a12b \
      --reduce --device cpu --steps 3
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
      --arch glm45-106b-a12b --reduce --device cpu --data 2 --ep 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm45-106b-a12b \
      --layers 1 --dtype bfloat16 --batch 2 --seq 4096 --steps 5 \
      --loss-chunks 8 --ckpt-every 0    # one full-width layer on an H100

A train cell (``--cell train_4k``: ``repro_torch.launch.specs.build_cell``
at the arch's published widths, ``--layers`` cutting the depth and
``--batch`` the global batch of 256) trains with the cell's runtime (bf16,
per-layer remat, capacity factors 2.0), sequence length and optimizer
(Adafactor for the big archs, AdamW otherwise), so it refuses the flags
those fix (``--seq``, ``--balancer``, ``--reduce``, ``--lr``, ``--dtype``,
``--d-model``); from Python, ``train_cell``:
  PYTHONPATH=src python -m repro_torch.launch.train --arch deepseek-v3-671b \
      --cell train_4k --layers 4 --batch 1 --steps 3 --loss-chunks 8 \
      --ckpt-every 0    # DeepSeek-V3, 3 dense + 1 MoE layer, on an H100

What trains on the card, at the trainer's defaults (fp32, ``--reduce``'s
head dim 16) and in bf16: GQA attention at head dims 16, 64, 80 and 128
(B4 in bf16, B4f in fp32; 80 is HuBERT-XLarge's, bidirectional) and
DeepSeek-V3's MLA at (192, 128) (B4m, B4f), the Mamba-2 mixer at Jamba's
(64, 16), Mamba2-130M's (64, 128) and the reduced (16, 16) (the SSD
intra-chunk backward, B5), the bf16 and fp32 expert FFN (B1-B3) and the
router's top-k; so every registered arch: GLM-4.5-Air, Qwen3-235B-A22B,
Jamba-v0.1, DeepSeek-V3, DBRX-132B, Qwen2-72B, Mistral-Large-123B,
InternLM2-1.8B, Qwen3-0.6B, Mamba2-130M, HuBERT-XLarge (frames through
its stub frontend), InternVL2-26B (patches spliced over the first
positions) and the rest.  The reduced DeepSeek-V3's MLA widths (q/k 12,
v 8), the ``tiny`` configurations' head dim 8, and the int8 wire and FFN
raise a ValueError there and train on the CPU.
Training remats each layer by default (``train(remat=False)`` keeps
every activation; a cell's runtime fixes it on).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.core.balancer import BalancerConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.launch.mesh import make_test_mesh, pctx_for_mesh
from repro_torch.launch.specs import Cell, build_cell
from repro_torch.models.model import init_lm, param_count
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.parallel import collectives
from repro_torch.train.fault import Supervisor, SupervisorConfig
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_train_step)

__all__ = ["main", "train", "train_cell", "build", "build_cell_trainer",
           "init_group", "TrainRun", "Trainer"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# The command-line arguments that a train cell fixes.
CELL_FIXED = ("seq", "balancer", "reduce", "lr", "dtype", "d_model")


@dataclasses.dataclass
class TrainRun:
    """What a run measured: the loss, gradient norm and host seconds of
    each step (the supervisor's, replays included), the tokens a step, the
    peak device memory (bytes, None off the card), the supervisor's
    restarts and the last step."""

    arch: str
    params: int
    losses: list
    grad_norms: list
    step_s: list
    tokens_per_step: int
    peak_mem: int | None
    restarts: int = 0
    final_step: int = 0

    @property
    def step_s_median(self) -> float:
        """Median step time without the first step (which builds kernels
        and warms the allocator)."""
        return statistics.median(self.step_s[1:] or self.step_s)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_per_step / self.step_s_median


@dataclasses.dataclass
class Trainer:
    """What :func:`build` makes: the configs, the train state, the step
    function and the data stream, and ``batch(step)``, a step's global
    batch on the device: the stream's tokens and targets as int64, and
    for a stub frontend (as the reference's ``batch_fn``) frames (B, S, D)
    in place of the tokens or patches (B, P, D) beside them, standard
    normal in the model's dtype from a ``torch.Generator`` on the device
    seeded with (seed, step)."""

    cfg: object
    rcfg: RuntimeConfig
    pctx: ParallelCtx
    state: object
    step_fn: object
    stream: SyntheticLMStream
    device: object

    def batch(self, step: int) -> dict:
        out = {k: torch.from_numpy(v).to(device=self.device,
                                         dtype=torch.int64)
               for k, v in self.stream.batch(step).items()}
        frontend = self.cfg.frontend
        if frontend == "none":
            return out
        gen = torch.Generator(device=self.device).manual_seed(
            (self.stream.cfg.seed << 32) + step)
        B, S = out["targets"].shape
        D = self.cfg.d_model
        rows = S if frontend == "audio_frames" else self.cfg.num_patches
        x = torch.randn((B, rows, D), generator=gen, dtype=self.rcfg.dtype,
                        device=self.device)
        if frontend == "audio_frames":
            del out["tokens"]
            out["frames"] = x
        else:
            out["patches"] = x
        return out


def build(arch, *, steps: int = 100, batch: int = 8, seq: int = 128,
          balancer: str = "ultraep", reduce: bool = True, lr: float = 3e-3,
          microbatches: int = 1, d_model: int = 64, layers: int | None = None,
          seed: int = 0, device="cuda", dtype=torch.float32,
          loss_chunks: int = 1, cf: float = 4.0, remat: bool = True,
          pctx: ParallelCtx = ParallelCtx()) -> Trainer:
    """The model (random weights from ``seed``; on a mesh ``pctx``, this
    rank's share), AdamW on a cosine schedule over ``steps``, the train
    step and the stream."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduce:
        cfg = reduced(cfg, layers=layers, d_model=d_model)
    elif layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    rcfg = RuntimeConfig(
        balancer=BalancerConfig(mode=balancer,
                                n_slot=cfg.moe.n_slot if cfg.moe else 2),
        cf_pair=cf, cf_slot=cf, dtype=dtype, loss_chunks=loss_chunks,
        remat=remat)
    params = init_lm(cfg, rcfg, pctx,
                     torch.Generator(device=device).manual_seed(seed),
                     device=device)
    opt = adamw(cosine_schedule(lr, warmup=max(steps // 20, 5), total=steps))
    return Trainer(cfg=cfg, rcfg=rcfg, pctx=pctx,
                   state=init_train_state(params, opt, cfg),
                   step_fn=make_train_step(
                       cfg, rcfg, pctx, opt,
                       TrainConfig(microbatches=microbatches)),
                   stream=SyntheticLMStream(DataConfig(
                       vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch, seed=seed)),
                   device=device)


def build_cell_trainer(cell: Cell, *, batch: int, seed: int = 0,
                       device="cuda",
                       pctx: ParallelCtx = ParallelCtx()) -> Trainer:
    """A train cell's :class:`Trainer`: its model with random weights from
    ``seed`` on ``device``, its optimizer's state, its step, and the
    stream at its sequence length with a global batch of ``batch``."""
    cfg, rcfg = cell.meta["cfg"], cell.meta["rcfg"]
    if cell.meta["shape"].kind != "train":
        raise ValueError(f"{cell.shape} is not a train cell")
    params = init_lm(cfg, rcfg, pctx,
                     torch.Generator(device=device).manual_seed(seed),
                     device=device)
    opt = cell.meta["optimizer"]
    # A mesh cell's step takes a rank's share of the cell's batch; the
    # trainer's steps take the stream's global batch of ``batch`` rows.
    step_fn = cell.step_fn if pctx.world_size == 1 else make_train_step(
        cfg, rcfg, pctx, opt,
        TrainConfig(microbatches=cell.meta["microbatches"]))
    return Trainer(cfg=cfg, rcfg=rcfg, pctx=pctx,
                   state=init_train_state(params, opt, cfg),
                   step_fn=step_fn,
                   stream=SyntheticLMStream(DataConfig(
                       vocab_size=cfg.vocab_size,
                       seq_len=cell.meta["shape"].seq_len,
                       global_batch=batch, seed=seed)),
                   device=device)


def train(arch, *, steps: int = 100, batch: int = 8, seq: int = 128,
          balancer: str = "ultraep", reduce: bool = True, lr: float = 3e-3,
          microbatches: int = 1, d_model: int = 64, layers: int | None = None,
          log_every: int = 10, seed: int = 0, on_metrics=None,
          device="cuda", dtype=torch.float32, loss_chunks: int = 1,
          cf: float = 4.0, ckpt_dir: str | None = None, ckpt_every: int = 50,
          pctx: ParallelCtx = ParallelCtx(), step_hook=None,
          remat: bool = True) -> TrainRun:
    """Train under the Supervisor; every rank of a mesh calls it with its
    ``pctx`` (rank 0 prints).  ``step_hook(step_fn) -> step_fn`` wraps the
    train step (fault injection in tests)."""
    _reset_peak(device)
    tr = build(arch, steps=steps, batch=batch, seq=seq, balancer=balancer,
               reduce=reduce, lr=lr, microbatches=microbatches,
               d_model=d_model, layers=layers, seed=seed, device=device,
               dtype=dtype, loss_chunks=loss_chunks, cf=cf, remat=remat,
               pctx=pctx)
    return _run(tr, steps=steps, batch=batch, log_every=log_every,
                on_metrics=on_metrics, device=device, ckpt_dir=ckpt_dir,
                ckpt_every=ckpt_every, pctx=pctx, step_hook=step_hook)


def train_cell(arch, cell: str, *, steps: int = 100, batch: int = 8,
               layers: int | None = None, microbatches: int = 1,
               loss_chunks: int = 1, log_every: int = 10, seed: int = 0,
               on_metrics=None, device="cuda",
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               pctx: ParallelCtx = ParallelCtx(),
               step_hook=None) -> TrainRun:
    """:func:`train` of the arch's cell of shape ``cell`` (``build_cell``
    at the published widths): the cell fixes the runtime (its dtype,
    remat, capacity factors and balancer), the sequence length and the
    optimizer; ``layers`` cuts the depth and ``batch`` the global batch."""
    _reset_peak(device)
    tr = build_cell_trainer(
        build_cell(arch, cell, pctx, num_layers_override=layers,
                   microbatches=microbatches,
                   rcfg_overrides={"loss_chunks": loss_chunks}),
        batch=batch, seed=seed, device=device, pctx=pctx)
    return _run(tr, steps=steps, batch=batch, log_every=log_every,
                on_metrics=on_metrics, device=device, ckpt_dir=ckpt_dir,
                ckpt_every=ckpt_every, pctx=pctx, step_hook=step_hook)


def _reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _run(tr: Trainer, *, steps, batch, log_every, on_metrics, device,
         ckpt_dir, ckpt_every, pctx, step_hook) -> TrainRun:
    """``steps`` steps of ``tr`` under the Supervisor."""
    on_cuda = torch.device(device).type == "cuda"
    loud = pctx.world_group is None or pctx.world_group.rank == 0
    run = TrainRun(arch=tr.cfg.name, params=param_count(tr.state.params),
                   losses=[], grad_norms=[], step_s=[],
                   tokens_per_step=batch * tr.stream.cfg.seq_len,
                   peak_mem=None)
    if loud:
        print(f"arch={tr.cfg.name} params={run.params:,} (a rank) "
              f"balancer={tr.rcfg.balancer.mode} device={device} "
              f"dtype={tr.rcfg.dtype} remat={tr.rcfg.remat} "
              f"data={pctx.data_size} ep={pctx.ep_size}", flush=True)

    def _metrics(step, m):
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        run.losses.append(loss)
        run.grad_norms.append(gnorm)
        if on_metrics:
            on_metrics(step - 1, m)
        if loud and (step - 1) % log_every == 0:
            print(f"step {step - 1:5d}  loss {loss:.4f}  gnorm {gnorm:.3f}  "
                  f"drops {int(m['drops'])}  {sup.step_times[-1]:.3f}s",
                  flush=True)

    if ckpt_dir is None and ckpt_every > 0:
        ckpt_dir = _shared_tmpdir(pctx)
    step_fn = tr.step_fn if step_hook is None else step_hook(tr.step_fn)
    sup = Supervisor(
        SupervisorConfig(checkpoint_dir=ckpt_dir, checkpoint_every=ckpt_every,
                         num_ranks=pctx.ep_size),
        step_fn, tr.batch, pctx=pctx)
    _, run.final_step = sup.run(tr.state, 0, steps, on_metrics=_metrics)
    run.step_s = list(sup.step_times)
    run.restarts = sup.restarts
    if on_cuda:
        run.peak_mem = torch.cuda.max_memory_allocated(device)
    if loud:
        print(f"done: {run.final_step} steps, median {run.step_s_median:.3f}s "
              f"a step ({run.tokens_per_s:.0f} tokens/s); final loss "
              f"{run.losses[-1]:.4f}; restarts {run.restarts}", flush=True)
    return run


def _shared_tmpdir(pctx: ParallelCtx) -> str:
    """A new directory under the temporary directory, the same on every
    rank of the mesh (rank 0 makes it and sends its name)."""
    g = pctx.world_group
    if g is None or g.size == 1:
        return tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    buf = torch.zeros(256, dtype=torch.uint8)
    if g.rank == 0:
        name = tempfile.mkdtemp(prefix="repro_torch_ckpt_").encode()
        buf[:len(name)] = torch.frombuffer(bytearray(name), dtype=torch.uint8)
    if g.backend == "nccl":
        buf = buf.cuda()
    collectives.broadcast(g, buf, 0)
    return bytes(buf.cpu().numpy()).rstrip(b"\0").decode()


def init_group(data: int, ep: int, device: str):
    """Start this torchrun process's group (env://) and return
    ``(pctx, device)`` for a ``data`` x ``ep`` mesh on the reference's
    layout: NCCL where each rank has a card of its own (``LOCAL_RANK``),
    gloo on the CPU or where the ranks share one card."""
    world = int(os.environ["WORLD_SIZE"])
    if world != data * ep:
        raise ValueError(f"--data {data} x --ep {ep} needs {data * ep} "
                         f"processes, torchrun started {world}")
    backend = "gloo"
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0))
        n = torch.cuda.device_count()
        if world <= n:
            backend = "nccl"
            device = f"cuda:{local}"
        else:
            device = "cuda:0"
        torch.cuda.set_device(device)
    collectives.init(backend, world_size=world,
                     rank=int(os.environ["RANK"]))
    return pctx_for_mesh(make_test_mesh(data, ep)), device


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--balancer", default="ultraep")
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--loss-chunks", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new one under "
                         "the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (0: none)")
    ap.add_argument("--cell", default=None,
                    help="train the arch's cell of this shape (train_4k)")
    ap.add_argument("--data", type=int, default=1,
                    help="data rows of the mesh (under torchrun)")
    ap.add_argument("--ep", type=int, default=1,
                    help="EP ranks of the mesh (under torchrun)")
    args = ap.parse_args(argv)
    if args.cell is not None:
        fixed = [f"--{k.replace('_', '-')}" for k in CELL_FIXED
                 if getattr(args, k) != ap.get_default(k)]
        if fixed:
            ap.error(f"--cell fixes {', '.join(fixed)}")
    device, pctx = args.device, ParallelCtx()
    grouped = args.data * args.ep > 1
    if grouped:
        pctx, device = init_group(args.data, args.ep, device)
    common = dict(steps=args.steps, batch=args.batch,
                  microbatches=args.microbatches, layers=args.layers,
                  log_every=args.log_every, seed=args.seed, device=device,
                  loss_chunks=args.loss_chunks, ckpt_dir=args.ckpt_dir,
                  ckpt_every=args.ckpt_every, pctx=pctx)
    try:
        if args.cell is not None:
            return train_cell(args.arch, args.cell, **common)
        return train(args.arch, seq=args.seq, balancer=args.balancer,
                     reduce=args.reduce, lr=args.lr, d_model=args.d_model,
                     dtype=DTYPES[args.dtype], **common)
    finally:
        if grouped:
            collectives.destroy()


if __name__ == "__main__":
    main()

"""Training entry point: AdamW on the synthetic domain-mixture stream.

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
global batch with its EP rank's experts; gloo on ``--device cpu``, NCCL
where each rank has a card, gloo where the ranks share one card.

Example (the CPU, a reduced model; on a card drop ``--device``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm45-106b-a12b \
      --reduce --device cpu --steps 3
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
      --arch glm45-106b-a12b --reduce --device cpu --data 2 --ep 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm45-106b-a12b \
      --layers 1 --dtype bfloat16 --batch 2 --seq 4096 --steps 5 \
      --loss-chunks 8 --ckpt-every 0    # one full-width layer on an H100

Backward kernels exist on the card for bf16 GQA at head dim 128 and the fp
expert FFN; other configurations (fp32 or MLA attention, Mamba mixers, the
int8 paths) raise a ValueError there and train on the CPU.
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
from repro_torch.models.model import init_lm, param_count
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.parallel import collectives
from repro_torch.train.fault import Supervisor, SupervisorConfig
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_train_step)

__all__ = ["main", "train", "build", "init_group", "TrainRun", "Trainer"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    batch as int64 tensors on the device."""

    cfg: object
    rcfg: RuntimeConfig
    pctx: ParallelCtx
    state: object
    step_fn: object
    stream: SyntheticLMStream
    device: object

    def batch(self, step: int) -> dict:
        return {k: torch.from_numpy(v).to(device=self.device,
                                          dtype=torch.int64)
                for k, v in self.stream.batch(step).items()}


def build(arch, *, steps: int = 100, batch: int = 8, seq: int = 128,
          balancer: str = "ultraep", reduce: bool = True, lr: float = 3e-3,
          microbatches: int = 1, d_model: int = 64, layers: int | None = None,
          seed: int = 0, device="cuda", dtype=torch.float32,
          loss_chunks: int = 1, cf: float = 4.0,
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
        cf_pair=cf, cf_slot=cf, dtype=dtype, loss_chunks=loss_chunks)
    params = init_lm(cfg, rcfg, pctx,
                     torch.Generator(device=device).manual_seed(seed),
                     device=device)
    opt = adamw(cosine_schedule(lr, warmup=max(steps // 20, 5), total=steps))
    return Trainer(cfg=cfg, rcfg=rcfg, pctx=pctx,
                   state=init_train_state(params, opt, cfg, pctx),
                   step_fn=make_train_step(
                       cfg, rcfg, pctx, opt,
                       TrainConfig(microbatches=microbatches)),
                   stream=SyntheticLMStream(DataConfig(
                       vocab_size=cfg.vocab_size, seq_len=seq,
                       global_batch=batch, seed=seed)),
                   device=device)


def train(arch, *, steps: int = 100, batch: int = 8, seq: int = 128,
          balancer: str = "ultraep", reduce: bool = True, lr: float = 3e-3,
          microbatches: int = 1, d_model: int = 64, layers: int | None = None,
          log_every: int = 10, seed: int = 0, on_metrics=None,
          device="cuda", dtype=torch.float32, loss_chunks: int = 1,
          cf: float = 4.0, ckpt_dir: str | None = None, ckpt_every: int = 50,
          pctx: ParallelCtx = ParallelCtx(), step_hook=None) -> TrainRun:
    """Train under the Supervisor; every rank of a mesh calls it with its
    ``pctx`` (rank 0 prints).  ``step_hook(step_fn) -> step_fn`` wraps the
    train step (fault injection in tests)."""
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tr = build(arch, steps=steps, batch=batch, seq=seq, balancer=balancer,
               reduce=reduce, lr=lr, microbatches=microbatches,
               d_model=d_model, layers=layers, seed=seed, device=device,
               dtype=dtype, loss_chunks=loss_chunks, cf=cf, pctx=pctx)
    loud = pctx.world_group is None or pctx.world_group.rank == 0
    run = TrainRun(arch=tr.cfg.name, params=param_count(tr.state.params),
                   losses=[], grad_norms=[], step_s=[],
                   tokens_per_step=batch * seq, peak_mem=None)
    if loud:
        print(f"arch={tr.cfg.name} params={run.params:,} (a rank) "
              f"balancer={balancer} device={device} dtype={dtype} "
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
    ``(pctx, device)`` for a ``data`` x ``ep`` mesh: NCCL where each rank
    has a card of its own (``LOCAL_RANK``), gloo on the CPU or where the
    ranks share one card."""
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
    ap.add_argument("--data", type=int, default=1,
                    help="data rows of the mesh (under torchrun)")
    ap.add_argument("--ep", type=int, default=1,
                    help="EP ranks of the mesh (under torchrun)")
    args = ap.parse_args(argv)
    device, pctx = args.device, ParallelCtx()
    grouped = args.data * args.ep > 1
    if grouped:
        pctx, device = init_group(args.data, args.ep, device)
    try:
        return train(args.arch, steps=args.steps, batch=args.batch,
                     seq=args.seq, balancer=args.balancer,
                     reduce=args.reduce, lr=args.lr,
                     microbatches=args.microbatches, d_model=args.d_model,
                     layers=args.layers, log_every=args.log_every,
                     seed=args.seed, device=device,
                     dtype=DTYPES[args.dtype], loss_chunks=args.loss_chunks,
                     ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                     pctx=pctx)
    finally:
        if grouped:
            collectives.destroy()


if __name__ == "__main__":
    main()

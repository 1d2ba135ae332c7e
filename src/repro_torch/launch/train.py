"""Training entry point: AdamW on the synthetic domain-mixture stream.

Mirrors ``repro.launch.train``: trains a registered arch (``--reduce``d,
or at its published widths with ``--layers`` cutting the depth) on one
device (one EP rank, as the reference's trainer runs) with the ``ultraep``
balancer, capacity factors 4.0 and a cosine schedule.  The steps run in a
plain loop: the reference's fault-tolerant ``Supervisor`` and its
checkpoints are not ported yet.  Weights are random, drawn from a
``torch.Generator`` seeded with ``seed`` on ``device``; batches come from
``SyntheticLMStream`` with the same seed.  Each step is timed on the host
clock up to a device synchronisation.

Example (the CPU, a reduced model; on a card drop ``--device``):
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm45-106b-a12b \
      --reduce --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm45-106b-a12b \
      --layers 1 --dtype bfloat16 --batch 2 --seq 4096 --steps 5 \
      --loss-chunks 8     # one full-width layer on an H100

Backward kernels exist on the card for bf16 GQA at head dim 128 and the fp
expert FFN; other configurations (fp32 or MLA attention, Mamba mixers, the
int8 paths) raise a ValueError there and train on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.reduce import reduced
from repro_torch.core.balancer import BalancerConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.models.model import init_lm, param_count
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train.loop import (TrainConfig, init_train_state,
                                    make_train_step)

__all__ = ["main", "train", "build", "TrainRun", "Trainer"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainRun:
    """What a run measured: the loss, gradient norm and host seconds of
    each step, the tokens a step, and the peak device memory (bytes, None
    off the card)."""

    arch: str
    params: int
    losses: list
    grad_norms: list
    step_s: list
    tokens_per_step: int
    peak_mem: int | None

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
    function and the data stream, and ``batch(step)``, a step's batch as
    int64 tensors on the device."""

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
          loss_chunks: int = 1, cf: float = 4.0) -> Trainer:
    """The model (random weights from ``seed``), AdamW on a cosine
    schedule over ``steps``, the train step and the stream."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduce:
        cfg = reduced(cfg, layers=layers, d_model=d_model)
    elif layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    rcfg = RuntimeConfig(
        balancer=BalancerConfig(mode=balancer,
                                n_slot=cfg.moe.n_slot if cfg.moe else 2),
        cf_pair=cf, cf_slot=cf, dtype=dtype, loss_chunks=loss_chunks)
    pctx = ParallelCtx()
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


def train(arch, *, steps: int = 100, batch: int = 8, seq: int = 128,
          balancer: str = "ultraep", reduce: bool = True, lr: float = 3e-3,
          microbatches: int = 1, d_model: int = 64, layers: int | None = None,
          log_every: int = 10, seed: int = 0, on_metrics=None,
          device="cuda", dtype=torch.float32, loss_chunks: int = 1,
          cf: float = 4.0) -> TrainRun:
    on_cuda = torch.device(device).type == "cuda"
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tr = build(arch, steps=steps, batch=batch, seq=seq, balancer=balancer,
               reduce=reduce, lr=lr, microbatches=microbatches,
               d_model=d_model, layers=layers, seed=seed, device=device,
               dtype=dtype, loss_chunks=loss_chunks, cf=cf)
    state = tr.state
    run = TrainRun(arch=tr.cfg.name, params=param_count(state.params),
                   losses=[], grad_norms=[], step_s=[],
                   tokens_per_step=batch * seq, peak_mem=None)
    print(f"arch={tr.cfg.name} params={run.params:,} balancer={balancer} "
          f"device={device} dtype={dtype}", flush=True)
    for step in range(steps):
        b = tr.batch(step)
        t0 = time.perf_counter()
        state, m = tr.step_fn(state, b)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])   # syncs
        run.step_s.append(time.perf_counter() - t0)
        run.losses.append(loss)
        run.grad_norms.append(gnorm)
        if on_metrics:
            on_metrics(step, m)
        if step % log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  gnorm {gnorm:.3f}  "
                  f"drops {int(m['drops'])}  {run.step_s[-1]:.3f}s",
                  flush=True)
    if on_cuda:
        run.peak_mem = torch.cuda.max_memory_allocated(device)
    print(f"done: {steps} steps, median {run.step_s_median:.3f}s a step "
          f"({run.tokens_per_s:.0f} tokens/s); final loss "
          f"{run.losses[-1]:.4f}", flush=True)
    return run


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
    args = ap.parse_args(argv)
    return train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                 balancer=args.balancer, reduce=args.reduce, lr=args.lr,
                 microbatches=args.microbatches, d_model=args.d_model,
                 layers=args.layers, log_every=args.log_every,
                 seed=args.seed, device=args.device,
                 dtype=DTYPES[args.dtype], loss_chunks=args.loss_chunks)


if __name__ == "__main__":
    main()

"""Where a training step's time goes: one traced step of the trainer.

Builds the model as ``repro_torch.launch.train`` does (``--arch``
GLM-4.5-Air by default at its published widths, ``--layers`` 1, bf16,
batch 2 x 4096, the loss in 8 chunks, AdamW), runs one step to warm up,
then traces the next with ``torch.profiler`` and prints one JSON line: the
host wall time up to a device synchronisation, the device-busy time, the
idle share, the time per kernel category (``profile_serve``'s, with the
backward kernels apart) and the top kernels.  A second line times, with
CUDA events on the same state, the step's parts: the forward and backward
(``loss_and_grads``), and the clipping and the optimizer's update.

With ``--cell train_4k`` it profiles the arch's train cell instead
(``launch.specs.build_cell``: bf16, per-layer remat, capacity factors
2.0, Adafactor for the big archs), ``--layers`` deep at ``--batch`` rows.

  PYTHONPATH=src python -m repro_torch.launch.profile_train --layers 1
  PYTHONPATH=src python -m repro_torch.launch.profile_train \
      --arch deepseek-v3-671b --cell train_4k --layers 4 --batch 1
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.launch.profile_serve import _trace
from repro_torch.launch.specs import build_cell
from repro_torch.launch.train import build, build_cell_trainer
from repro_torch.models.transformer import ParallelCtx
from repro_torch.optim.optimizer import adamw, clip_by_global_norm
from repro_torch.train.loop import loss_and_grads

__all__ = ["main"]


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="glm45-106b-a12b")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--loss-chunks", type=int, default=8)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--cell", default=None,
                    help="profile the arch's cell of this shape (train_4k)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.cell:
        cell = build_cell(args.arch, args.cell, ParallelCtx(),
                          num_layers_override=args.layers,
                          rcfg_overrides={"loss_chunks": args.loss_chunks})
        tr = build_cell_trainer(cell, batch=args.batch)
        opt = cell.meta["optimizer"]
    else:
        tr = build(args.arch, steps=10, batch=args.batch, seq=args.seq,
                   reduce=False, layers=args.layers, device="cuda",
                   dtype=torch.bfloat16, loss_chunks=args.loss_chunks)
        opt = adamw(1e-4)
    state, _ = tr.step_fn(tr.state, tr.batch(0))                # warm-up
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "arch": tr.cfg.name, "layers": args.layers,
                      "batch": args.batch, "seq": tr.stream.cfg.seq_len,
                      "cell": args.cell, "remat": tr.rcfg.remat,
                      "loss_chunks": args.loss_chunks}), flush=True)
    b = tr.batch(1)
    box = {}

    def step():
        box["state"], _ = tr.step_fn(state, b)

    rec = _trace(step, "train_step", args.top)
    print(json.dumps(rec), flush=True)
    params = list(box["state"].params.parameters())
    grads = []
    fwd_bwd = _event_ms(lambda: grads.extend(loss_and_grads(
        box["state"].params, tr.batch(2), tr.cfg, tr.rcfg, tr.pctx,
        router_bias=box["state"].router_bias)[3]))

    def update():
        with torch.no_grad():
            clip_by_global_norm(grads, 1.0)
            opt.update(grads, box["state"].opt_state, params,
                       box["state"].step)

    print(json.dumps({"step": "parts", "forward_backward_ms": fwd_bwd,
                      "clip_and_update_ms": _event_ms(update)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

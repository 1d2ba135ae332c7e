"""End-to-end driver: train a ~100M-parameter MoE for a few hundred steps
with the full substrate -- synthetic domain-mixture data, UltraEP
balancing every layer and microbatch, checkpoints, the fault-tolerant
supervisor; the port's counterpart of ``examples/train_moe_100m.py``.

Qwen3-235B-A22B reduced to 4 layers at d_model 512 (16 experts; GQA with
qk-norm and the fine-grained top-k MoE kept), in fp32, the trainer's
default dtype: on the card its attention trains through the fp32 flash
backward at head dim 16 and its experts through the fp32 grouped GEMMs.

    PYTHONPATH=src python -m repro_torch.examples.train_moe_100m \\
        [--steps 300] [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.launch.train import TrainRun, train

__all__ = ["main"]


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--balancer", default="ultraep")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new one under "
                         "the temporary directory)")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="steps between checkpoints (0: none)")
    args = ap.parse_args(argv)
    return train("qwen3-235b-a22b", steps=args.steps, batch=8, seq=256,
                 d_model=512, layers=4, balancer=args.balancer,
                 microbatches=2, device=args.device, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every)


if __name__ == "__main__":
    main()

"""Serving entry point: chunked-prefill engine over a Poisson request trace.

Mirrors ``repro.launch.serve.serve_trace``.  ``arch`` is a registered arch
name or a :class:`ModelConfig` (for instance a depth-cut config);
``layers`` (``--layers``) cuts the depth, of the published widths or of the
reduced config.  Weights
are random, drawn from a ``torch.Generator`` seeded with ``seed`` on
``device``; prompts come from numpy's generator with the same seed.  Every
engine call is timed on the host clock between device synchronisations, the
engine's clock advances by that measured time, and the calls are kept in
``engine.calls`` as ``(kind, tokens, seconds)``.

Example (on a card; ``--dtype`` is float32, the default, or bfloat16):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm45-106b-a12b \
      --reduce --requests 6 --chunk 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \
      --reduce --requests 6 --chunk 64 --dtype bfloat16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm45-106b-a12b \
      --reduce --wire-dtype int8 --ffn-dtype int8     # the w8a8 expert path
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \
      --layers 4 --dtype bfloat16 --chunk 256     # full width: 3 dense + 1 MoE
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \
      --layers 2 --requests 2                     # fp32: 2 dense layers

Every arch that decodes serves: the paper's two, Jamba-v0.1, DeepSeek-V3,
DBRX-132B, Qwen2-72B, Mistral-Large-123B, InternLM2-1.8B, Qwen3-0.6B,
Mamba2-130M and InternVL2-26B (text tokens, as the reference's engine);
HuBERT-XLarge is an encoder and raises.

Expert parallelism: under ``torchrun`` (``WORLD_SIZE`` and ``RANK`` set)
every process is one rank of a (data 1, model ``WORLD_SIZE``) mesh
(``launch.mesh.make_serve_mesh``), NCCL on ``--device cuda`` with one card
a rank (``LOCAL_RANK``), gloo on ``--device cpu``; the model takes the
reference's layout on it (``repro_torch.parallel.sharding``: attention
heads and FFN columns over the model axis, each rank its experts and its
block of the decode cache's positions, ``max_seq`` rounded up to a
multiple of the ranks), each rank serves the same trace and rank 0
prints.  Without ``WORLD_SIZE`` it runs on one device.
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.serve \
      --arch glm45-106b-a12b --reduce --dtype bfloat16
``--racks G`` factors the model axis into G racks of WORLD_SIZE / G ranks (the
two-level topology: the MoE layers run ``hier_a2a``, the rack-aware plan
and the tiered replica stream); ``--rack-limit M`` bounds each token's
experts to M racks at the gate (0: free routing);
``--overlap-chunks C`` splits each MoE call's tokens into C chunks whose
exchanges overlap the FFN; ``--dispatch-impl reference`` runs the
multi-sort reference dispatch engine (flat groups only).  On the CPU:
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch deepseek-v3-671b --reduce --device cpu --racks 2 \
      --rack-limit 1 --overlap-chunks 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.reduce import reduced
from repro_torch.core.balancer import BalancerConfig
from repro_torch.core.quantize import FFN_DTYPES, WIRE_DTYPES
from repro_torch.launch.mesh import make_serve_mesh, pctx_for_mesh
from repro_torch.models.model import init_lm
from repro_torch.models.transformer import ParallelCtx, RuntimeConfig
from repro_torch.parallel import collectives
from repro_torch.serving.adapter import make_engine_fns
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

__all__ = ["main", "serve_trace"]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _timed(fn, kind: str, calls: list, sync, n_tokens):
    def wrapped(tokens, *args):
        sync()
        t0 = time.perf_counter()
        out = fn(tokens, *args)
        sync()
        calls.append((kind, n_tokens(tokens, *args), time.perf_counter() - t0))
        return out
    return wrapped


def serve_trace(arch: str | ModelConfig, *, requests: int = 16,
                rps: float = 4.0, chunk: int = 64, max_new: int = 8,
                reduce: bool = True, layers: int | None = None,
                balancer: str = "ultraep", seed: int = 0,
                prompt_len: tuple[int, int] = (32, 200), decode_batch: int = 4,
                cf: float = 4.0, dtype=torch.float32, device="cuda",
                wire_dtype: str = "none", ffn_dtype: str = "none",
                rack_limit: int = 0, overlap_chunks: int = 1,
                dispatch_impl: str = "fused",
                pctx: ParallelCtx | None = None) -> ServingEngine:
    """Serve a seeded Poisson trace; ``pctx``: the context of the mesh
    this process is a rank of (``launch.mesh.pctx_for_mesh``; a factored
    model axis for a two-level topology), or None for one device.  Every
    rank of a mesh serves the same trace; rank 0 prints the summary."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduce:
        cfg = reduced(cfg, layers=layers)
    elif layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if not cfg.has_decode:
        raise ValueError(f"{cfg.name} is encoder-only; no serving path")
    if cfg.ssm is not None and chunk % cfg.ssm.chunk:
        raise ValueError(f"prefill chunk {chunk} is not a multiple of the "
                         f"SSD chunk {cfg.ssm.chunk} of {cfg.name}")
    device = torch.device(device)
    rcfg = RuntimeConfig(
        balancer=BalancerConfig(mode=balancer,
                                n_slot=cfg.moe.n_slot if cfg.moe else 2),
        cf_pair=cf, cf_slot=cf, dtype=dtype, wire_dtype=wire_dtype,
        ffn_dtype=ffn_dtype, rack_limit=rack_limit,
        overlap_chunks=overlap_chunks, dispatch_impl=dispatch_impl)
    pctx = ParallelCtx() if pctx is None else pctx
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_lm(cfg, rcfg, pctx, gen, device=device)
    max_seq = max(prompt_len[1] + max_new + chunk, 2 * chunk)
    max_seq = -(-max_seq // pctx.ep_size) * pctx.ep_size   # whole blocks

    prefill_fn, decode_fn, new_cache_fn, stack, unstack = make_engine_fns(
        params, cfg, rcfg, pctx, max_seq=max_seq)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    calls: list = []
    prefill_fn = _timed(prefill_fn, "prefill", calls, sync,
                        lambda toks, cache, start, valid_len: int(valid_len))
    decode_fn = _timed(decode_fn, "decode", calls, sync,
                       lambda toks, caches: toks.shape[0])
    eng = ServingEngine(EngineConfig(chunk_size=chunk,
                                     decode_batch=decode_batch,
                                     max_seq=max_seq),
                        prefill_fn=prefill_fn, decode_fn=decode_fn,
                        new_cache_fn=new_cache_fn, stack_caches=stack,
                        unstack_caches=unstack,
                        clock_fn=lambda: calls[-1][2])
    eng.calls = calls
    rng = np.random.default_rng(seed)
    t = 0.0
    for i in range(requests):
        t += rng.exponential(1.0 / rps)
        L = int(rng.integers(*prompt_len))
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=L).astype(np.int32),
            max_new_tokens=max_new, arrival=t))
    done = eng.run()
    ttft, tpot = eng.ttft(), eng.tpot()
    if len(ttft) and (pctx.world_group is None or pctx.world_group.rank == 0):
        print(f"served {len(done)} requests  mean TTFT {ttft.mean()*1e3:.1f}ms"
              f"  mean TPOT {tpot.mean()*1e3:.2f}ms")
    return eng


def main(argv=None) -> ServingEngine:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rps", type=float, default=4.0)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--balancer", default="ultraep")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--wire-dtype", default="none", choices=WIRE_DTYPES)
    ap.add_argument("--ffn-dtype", default="none", choices=FFN_DTYPES)
    ap.add_argument("--racks", type=int, default=1,
                    help="factor the EP group into this many racks")
    ap.add_argument("--rack-limit", type=int, default=0,
                    help="at most this many racks a token (0: free routing)")
    ap.add_argument("--overlap-chunks", type=int, default=1)
    ap.add_argument("--dispatch-impl", default="fused",
                    choices=("fused", "reference"))
    args = ap.parse_args(argv)
    device, pctx = args.device, None
    if "WORLD_SIZE" in os.environ:
        # One model rank per process (torchrun): NCCL with a card each, or
        # gloo on the CPU.
        on_cuda = torch.device(device).type == "cuda"
        if on_cuda:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(device)
        world = int(os.environ["WORLD_SIZE"])
        collectives.init("nccl" if on_cuda else "gloo", world_size=world,
                         rank=int(os.environ["RANK"]))
        pctx = pctx_for_mesh(make_serve_mesh(world, args.racks))
    elif args.racks > 1:
        raise ValueError("--racks needs an EP group (run under torchrun)")
    try:
        return serve_trace(args.arch, requests=args.requests, rps=args.rps,
                           chunk=args.chunk, max_new=args.max_new,
                           reduce=args.reduce, layers=args.layers,
                           balancer=args.balancer,
                           dtype=DTYPES[args.dtype], device=device,
                           wire_dtype=args.wire_dtype,
                           ffn_dtype=args.ffn_dtype,
                           rack_limit=args.rack_limit,
                           overlap_chunks=args.overlap_chunks,
                           dispatch_impl=args.dispatch_impl, pctx=pctx)
    finally:
        if pctx is not None:
            collectives.destroy()


if __name__ == "__main__":
    main()

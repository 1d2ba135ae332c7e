#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one output line each:
  1. card, torch/CUDA versions, kernel build (nvcc, sm_90a, one process per
     source, all at once) time;
  2. the grouped-GEMM kernels against their plain PyTorch versions at the
     GLM-4.5-Air and Jamba-v0.1 prefill and decode shapes with every row
     valid, at ragged shapes, and with each slot's valid-row count as the
     serve path makes it (the port's gate, ``ultraep`` plan and bucket on
     seeded tokens at GLM prefill, GLM decode, Jamba prefill, DeepSeek-V3
     prefill and decode, and DBRX-132B's 1024-token chunk and decode step
     (16 experts top-4, K 6144, N 10752): padded rows must come out
     exactly zero), in bf16
     (max|err| <= 1e-2 max|ref|: one bf16 rounding of the output) and fp32 (max|err| <= 1e-4 max|ref|: the
     kernels' 3xTF32 products; GLM dense at G 8, prefill and decode serve
     counts, and counts that straddle a tile with NaN in the padded rows),
     with the kernel's, the plain version's and a library call's
     (``torch.bmm`` over the padded buffers) time and the card's bound on
     the valid rows' work (fp32: three TF32 products at the TF32 rate, the
     fp32 CUDA-core bound beside it); then ``ssd_intra_chunk`` and
     ``ssd_chunk_scan`` (from an initial state) against their plain
     versions at the Jamba prefill chunk in bf16 and fp32 inputs, at
     Mamba2-130M's serve chunk (8 chunks of 128, 24 heads of 64, state 128),
     and at the
     reduced shape at nc 1 and at B 2, within 3e-4 max|ref| (the kernel's
     split bf16 products
     against fp32; its bound under that arithmetic, the fp32 CUDA-core bound
     beside it); then the
     w8a8 pair ``grouped_swiglu_q8`` / ``grouped_matmul_q8`` against their
     plain versions at the GLM-4.5-Air prefill and decode shapes with every
     row valid, with the serve path's per-slot row counts and activations
     (taken from the port's dispatch stage: GLM prefill, ``a2a`` with the
     int8 wire, and decode, ``replicated``), with counts that straddle a
     tile and with empty slots (padded rows hold NaN row scales and must
     come out exactly zero), and at ragged shapes, with weight codes
     K-contiguous as the layer keeps them and the SwiGLU's activations as
     a view of int8 wire rows padded to 16 bytes (as the bucket lays them
     out), contiguous, or a view of unpadded wire rows, K + 4 bytes apart,
     which TMA cannot read and the wrapper copies first (counted; the serve
     cases must make no copy): the matmul must match bitwise in fp32 and in
     bf16 output, the
     SwiGLU within 1e-5 max|ref| (the gate's exp); bounds on the valid
     rows' work; the library yardstick is G calls of ``torch._int_mm``
     (cuBLAS int8) over every row plus the dequant in PyTorch; then
     ``gating_topk`` against
     its plain version at the GLM/Qwen3 prefill (T 4096, E 128, k 8) and
     decode (T 4) shapes, Jamba's (E 16, k 2), DBRX's (E 16, k 4; T 1024
     and 4), sigmoid at E 256 (DeepSeek-V3's
     prefill and decode), a ragged
     shape and a tie case (duplicated router columns, all-zero rows): ids
     equal wherever the plain k-th and (k+1)-th scores differ by more than
     1e-6 relative (every row of the tie case), counts equal the histogram of
     the kernel's ids, weights and scores within 1e-6 max|ref|, and the same
     with a DeepSeek-style selection bias (the weights stay the unbiased
     scores); timed back to back (``ms``, the wrapper's host work included)
     and as device time from CUDA-graph replays with the logits warm in L2
     (``graph_ms``) and out of it (``graph_cold_ms``), beside the PyTorch
     composite (softmax + topk + gather + histogram) both ways; then
     ``plan_solve`` against its plain version (the whole ``Plan``
     integer-equal, and the count of probes and oracle steps) at E 128, k 8
     (GLM, Qwen3) at R 8, 16, 32, 64 and E 16, k 2 (Jamba) at R 2, 4, 8, 16,
     ``n_slot`` 2, over load drawn from three expert popularity laws
     (uniform, Zipf 1.0, four hot experts taking half), with no host sync
     under ``set_sync_debug_mode("error")``: graph device time of the
     kernel and of the whole solve, the plain loop's eager time on the
     card, the bound (serial oracle steps x one redux.sync round, timed
     here) and post_max / ceil(total / R); the rack modes of both kernels:
     ``gating_topk`` with DeepSeek-V3's node-limited routing (T 4096, E
     256, k 8, sigmoid + bias; G 8, M 4, group top-2; G 2, M 1; decode)
     and, at prefill and decode, Jamba-v0.1's 16 experts over 8 racks,
     DBRX's routing at 8 racks, DeepSeek-V2's device-limited routing (E
     160, 8 of 3, group top-1), E 60 over 6 racks, a group top-8 and one
     expert a rack, ids equal to the plain rack selection on the kernel's
     own keys on every row and through the port's ``verify_rack_limit``
     with no error, and ``plan_solve`` with rack size 8 (2 at R 4), with and
     without the demand tie-break, the whole Plan with its tier fields
     equal to the plain solve's, no host sync, timed beside the flat
     solve; ``plan_solve``'s k-ary round (row Pk: probe_parallelism 4 and
     8 beside 1 in the same call, E 128 and 256, R 64, flat and rack size
     8, Zipf 1.0) and health mode (row Ph: rank 1 at weight 0.5, rank 2 at
     0, whose load must be 0), the whole Plan equal to the plain solve's,
     (probes, steps, critical-path steps) equal, no host sync, graph time,
     the bound (critical-path steps x one redux.sync round) and the plain
     loop's time; ``eplb_place`` (row Pe, EPLB's greedy placement) at E
     128 and 256, R 64, n_slot 2, Zipf 1.0, and over a sweep (E 16-1024,
     R 2-256, n_slot 1-8, max_rep 2..R; Zipf, equal, zero and half-zero
     loads): hosted and (steps, placements) bitwise equal to the plain
     version, no host sync, graph time, the bound (steps x the longer of a
     step's two dependent chains, timed here) and the plain loop's time;
     and
     ``flash_attention`` against its plain version at the
     GLM-4.5-Air serve cache (C 4096, Sk 10248: offsets 0 and 4096, a ragged
     last chunk), at Qwen3's 64 over 4 heads, at decode (B 4, per-row
     lengths), at the Pallas kernel's own case (Sq = Sk = 2048, causal and
     not), in fp32 and at head dims 64 and 16 (the reduced configurations'),
     at the split edges (decode rows of length 1, of exactly one split,
     ending on a split edge, and of the full capacity), at G 16 with Sq not
     a multiple of 8, with a q tile straddling kv_valid_len, at hd 64 on
     the wgmma kernel and hd 16 on the mma.sync kernel, and at DeepSeek-V3's
     MLA dims (q/k 192, v 128 as a strided view, 128 heads): its serve chunk
     (4096 queries at offset 4096) on the wgmma kernel and 64 queries at B 1
     on the split-KV kernel, SDPA under the first backend that takes
     unequal head dims, named, and in fp32 on the fp32 prefill kernel (the
     serve entry point's chunk of 64 over 272 keys, and the 4096 chunk);
     at HuBERT-XLarge's head dim 80 (B 2, 4096 frames, 16 heads,
     bidirectional and causal, bf16 on the wgmma kernel and fp32, and a
     7-frame input, which takes the wgmma kernel too); each case asserts
     the kernel the wrapper picked (``launches_by_kernel``) and holds each
     output row (batch row, query position, head) within a share of its
     own max|ref|: 1e-2 in bf16 (P and the output rounded to bf16), 1e-4 in
     fp32.  Library yardsticks: ``scaled_dot_product_attention`` with the
     same boolean mask and, where every row shares one offset (B 1), without
     a mask (k/v sliced to the valid length, ``causal_lower_right``, flash
     or memory-efficient backend); the faster is ``library_ms``.  Kernel and
     SDPA times are device times from CUDA-graph replays (``ms_eager``:
     back to back); the fp32 prefill kernel is timed at hd 128, 64 and 16,
     its bound taken at the TF32 rate for its three products (the fp32
     CUDA-core bound beside it);
  3. the balanced MoE layer at GLM-4.5-Air width (T 4096, ep_size 1) in the
     a2a and replicated modes against the dense oracle ``moe_ref`` in fp32
     (bf16 layer: 2e-2 max|ref|, fp32 layer: 1e-4 max|ref|), zero drops,
     and the bf16 calls again under ``torch.cuda.set_sync_debug_mode
     ("error")``: no host sync;
     then in bf16 with (wire_dtype, ffn_dtype) (int8, int8) and (int8,
     none): 3e-2 max|ref| (the JAX suite's bound for the int8 FFN), the
     bf16 layer's counts, zero drops;
  4. ``serve_trace`` on GLM-4.5-Air at every published width with depth cut
     to 2 layers, bf16 weights from a seeded CUDA generator: 4 requests of
     2048-6144 tokens, chunk 4096, 8 new tokens each, decode batch 4,
     balancer ultraep, capacity factors 4.0; then (4b) the same with
     ``wire_dtype = ffn_dtype = "int8"``, which must launch the q8 kernels
     and not the bf16 grouped ones; then (4c) the same in fp32 (about 38 GB
     at peak), every prefill chunk on the fp32 prefill kernel;
  5. one Jamba-v0.1 Mamba mixer at full width over T 4096 from a non-zero
     state: bf16 and fp32 on the card (the SSD kernel) against the fp32
     plain path run on the host (bf16: 2e-2 max|ref|, fp32: 1e-4 max|ref|),
     and two chunks of 2048 against one of 4096 with the state carried;
  6. ``serve_trace`` on Jamba-v0.1 at every published width with depth cut
     to 8 layers (one period: mamba+dense, mamba+moe, attn+dense), with the
     settings of phase 4;
  7. ``serve_trace`` on Qwen3-235B-A22B at every published width with depth
     cut to 2 layers, with the settings of phase 4; then (7b) the serve
     entry point ``python -m repro_torch.launch.serve --reduce`` (its
     ``main``) on each of the three archs in fp32 (its default) and bf16 at
     chunk 64 (every flash call on the split-KV kernel), and on GLM-4.5-Air
     at chunk 4096 (prefill on the fp32 and the hd-16 mma.sync kernels);
     (DeepSeek-V3 at full width in fp32 runs in phase 18);
 10. one DeepSeek-V3 MLA layer at full width: bf16 ``mla_prefill`` of a
     4096-token chunk at offset 4096 through the flash kernel against the
     plain flash on the card (1e-2 max|ref|, caches equal), and in fp32 the
     absorbed ``mla_decode`` against a one-token ``mla_prefill`` at the same
     positions through the plain flash (1e-4 max|ref|);
 11. ``serve_trace`` on DeepSeek-V3 at every published width with depth cut
     to 4 layers (3 dense, 1 MoE: 256 experts top-8, sigmoid router, routed
     scaling 2.5, a shared expert), bf16, with the settings of phase 4;
  9. the EP layer at R = 2 on the one card: two processes (spawn), one
     gloo group that carries CUDA tensors (each collective's result
     checked first), GLM-4.5-Air at full width, one MoE layer, 4096 bf16
     tokens a rank (leaning toward rank 0's experts, so replicas stream to
     rank 1), ``ultraep``, in modes ``a2a``, ``replicated`` and
     ``a2a`` with the int8 wire: y against the R = 1 layer on the same 8192
     tokens and weights (2e-2 max|ref|, int8 wire 3e-2), the plan tables
     (solved on the card) equal to the plain solve's, zero drops, and each
     layer call through one launch of the plan-solve, gate and two grouped
     kernels (counts set to 0 before the call, read after); then, in
     ``a2a``, the balancers ``eplb`` (a stale estimate), ``eplb_plus``,
     ``lplb``, ``ultraep`` at probe_parallelism 4 and under a
     ``RankHealth`` with rank 1 at half speed, each y against the R = 1
     layer (2e-2 max|ref|), zero drops, one launch of ``eplb_place`` for
     the EPLB modes, of ``plan_solve`` for ``ultraep``, of neither for
     ``lplb``; and the resilience ladder: an injected ``solve_fail`` after a
     clean call (the cached plan reused, no solve launched, y bitwise the
     clean call's), ``transfer_flaky`` (retried twice, y bitwise the clean
     run's) and ``nan_payload`` (payload rows counted apart from the
     capacity drops, y finite); no time is stated for it;
 15. the balancer comparison: DeepSeek-V3's expert count (E 256) and
     GLM-4.5-Air's (E 128) at R 64, top-8, 4096 tokens a rank, under a
     Zipf 0.4 expert popularity (the home-rank imbalance lands inside the
     paper's 1.30-4.01); ``none``, ``eplb`` (placement from the EMA of
     three earlier batches whose popularity is rolled by E / 2),
     ``eplb_plus``, ``lplb``, ``ultraep`` at P 1 and 4 solve the same load
     on the card through ``balancer.solve``: ``metrics.report`` before and
     after (imbalance, instances, fan-out, slots, in-flight share) and the
     solve's time (graph device time; ``lplb``, host numpy by design, its
     host wall), then each plan through the port's static plan check
     (``analysis.plan_check``): no error, warnings counted by rule;
 14. the rack tier on the one card: four processes (spawn) in one gloo
     group and the same ranks factored as 2 racks x 2 lanes, DeepSeek-V3's
     MoE layer at full width (E 256, k 8, d_model 7168, d_ff 2048, bf16),
     2048 tokens a rank: (a) flat ``a2a``, (b) ``hier_a2a``, (c) a rack
     limit of 1 against its flat twin, (d) (b) in 2 overlap chunks, (e) (a)
     on the reference engine, bit for bit as stated, zero drops, the plan
     tables against the plain solve and through the static plan check (no
     error; the rack limit's check in (c)), launch counts; (f) the backward of (b)
     against (a) within 2e-2; no time is stated (gloo);
 16. the trainer on groups of two processes on the one card (spawn, gloo
     on CUDA tensors): GLM-4.5-Air, one layer at full width, bf16, the aux
     loss off and the router bias on, as (a) EP 2 x data 1 (batch 1 x
     4096) and (b) data 2 x EP 1 (2 x 4096): every gradient of the global
     loss against the one-rank step's within 2e-2 of max|ref|, counts
     equal, zero drops (capacity factors 16: at 4.0 the seed-0 stream
     drops items at init, differently at each R), then one train step at
     4.0 with each rank's launches as stated and the one-rank router bias;
     (d) the Supervisor on the reduced GLM at head dim 128 with a fault on
     both ranks after step 3, the replay within 1e-3 of the clean run
     (whether it is bitwise is recorded); each process's peak memory, no
     time;
 12. the backward kernels at the train step's shapes against their plain
     versions (TRAIN_TOL, 2e-2 of max|ref|), timed beside their bounds and
     a library call: B1-B3 at GLM-4.5-Air's train counts and at the
     DeepSeek-V3 and Jamba-v0.1 train cells' (each with NaN in the padded
     rows and every 13th slot empty; B2's and B3's outputs bitwise
     whatever B1's padded rows hold), B4 (B 2, S 4096,
     32 / 8 heads; and at (80, 80), HuBERT-XLarge's B 2, S 4096, 16
     heads, bidirectional, beside SDPA's flash backward), B4m at
     DeepSeek-V3's MLA cell (B 1, S 4096, 128 heads,
     q/k 192, v 128; SDPA's backward, memory-efficient) and B5 at
     Jamba-v0.1's train chunk in bf16 and fp32 inputs (against the closed
     form and autograd of the plain forward); B4, B4m and B5 bitwise
     over two calls, B4m's three kernels also timed one by one;
 13. GLM-4.5-Air one layer at full width trained 5 steps with
     ``remat=False`` (its launch counts are those of a step without the
     recompute), after a gradient check against ``plain_backward``;
 17. the train cells of ``launch/specs.py`` (Adafactor, per-layer remat,
     bf16, batch 1 x 4096): DeepSeek-V3 4 layers and Jamba-v0.1 8 layers,
     each parameter's gradient against ``plain_backward`` within 2e-2, a
     second kernel run bit for bit (loss, counts, every gradient), the remat
     recompute's counts equal to the forward's, then 3 steps through
     ``launch.train.train_cell(arch, "train_4k")`` with the launches a step as
     CELL_LAUNCHES, their times and peak memory; remat's saving on
     Jamba's first two layers;
 18. the model hosts, each through its normal entry point at its
     published widths: ``serve_trace`` (bf16, 3 requests of 256-1535
     tokens in chunks of 1024, 4 new tokens each) on DBRX-132B, Qwen2-72B,
     Mistral-Large-123B and InternVL2-26B cut to 2 layers and on
     Qwen3-0.6B, InternLM2-1.8B and Mamba2-130M whole, each request
     finished, no non-finite logits, each flash call by the kernel its
     shapes select, the gate and both grouped GEMMs once per MoE layer and
     engine call, the SSD kernel once per Mamba layer and prefill call, no
     TMA copy; ``python -m repro_torch.launch.serve --arch
     deepseek-v3-671b --layers 2 --requests 2`` (its ``main``; fp32, every
     prefill on the fp32 kernel at (192, 128)); HuBERT-XLarge, 4 layers,
     frames through the stub, AdamW, bf16, 2 x 4096, a gradient check
     against ``plain_backward`` (2e-2) then 3 steps through
     ``launch.train.train`` with each step's launches (flash and B4 at
     (80, 80) once a layer); InternVL2-26B's train cell at 2 layers, one
     Adafactor step with its 256 patches spliced in;
 19. training at the trainer's own defaults (fp32; ``train()``'s head dim
     16): B4f (the fp32 flash backward) at every head-dim pair, causal and
     bidirectional, B4 in bf16 at (64, 64) and (16, 16), B5 at
     Mamba2-130M's (64, 128) in bf16 and fp32 inputs and B1f-B3f (the
     fp32 grouped backward) at the reduced GLM-4.5-Air's counts and at
     GLM-4.5-Air's full width, each against its plain version (fp32
     within 1e-4 of max|ref|, bf16 within 2e-2), bitwise over two calls,
     timed beside its bound and SDPA or ``bmm``; then each DEFAULT_PATHS
     path: a step-0 gradient check against ``plain_backward`` (2e-2;
     Mamba2-130M in bf16 against the fp32 gradient, see GRAD_VS_FP32) and
     3 steps through ``launch.train.main`` (Qwen3-0.6B whole) or
     ``launch.train.train`` (the reduced GLM-4.5-Air in fp32 and bf16,
     Mamba2-130M whole in fp32 and bf16, HuBERT-XLarge at 2 layers,
     DeepSeek-V3 at 1 dense layer), each step's backward launches held to
     the model's attention, Mamba and MoE layers; then
     ``repro_torch.examples.quickstart`` on the card (its plan equal to the
     plain solve's, its layer within 1e-4 of the dense oracle);
  8. the kernels with their launch counts on the serve paths: every count
     is set to 0 just before each serve run and read just after it; on
     every path (phase 7b's too) ``flash_attention`` runs once per
     attention layer and engine call, by the kernel its shapes select (on
     the hd-128 paths of phases 4, 6, 7: prefill calls through the TMA +
     wgmma kernel, in phase 4c through the fp32 prefill kernel, decode
     calls through the split-KV kernel, never the hd-16 mma.sync kernel;
     on DeepSeek-V3's path, phase 11, prefill calls through the wgmma
     kernel at (192, 128) and no flash call at decode, which attends on
     the latent cache),
     and ``gating_topk`` and the path's two grouped
     GEMMs (bf16/fp32 or w8a8) once per MoE layer and engine call, and no
     operand of any of them was copied for TMA (``padded_copies`` 0);
     ``plan_solve`` never runs on a serve path (R = 1), and its row's
     launches are phase 9's.

Every phase prints its wall seconds on a line of its own
(``phase_seconds``; phase 1's includes the kernel build, also printed as
``kernel_build_s``).  TF32 is off for matmuls and cuDNN, so fp32
references are full fp32.  Any
failed check raises and the script exits non-zero; the last line is the
``{"ok": true, "device": ...}`` record.  Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

PREFILL = dict(G=130, M=1009, K=4096, N=1408)      # 128 mains + 2 replicas
DECODE = dict(G=130, M=8, K=4096, N=1408)
# Jamba-v0.1: 16 mains + 2 replicas; M is cap_slot at T 4096, top-2, cf 4.
JAMBA_PREFILL = dict(G=18, M=1821, K=4096, N=14336)
JAMBA_DECODE = dict(G=18, M=8, K=4096, N=14336)
JAMBA_SSD = dict(B=1, nc=32, Q=128, H=128, P=64, N=16)   # one 4096 chunk
REDUCED_SSD = dict(B=1, nc=1, Q=16, H=8, P=16, N=16)
# Mamba2-130M's serve chunk of 1024 tokens: 8 SSD chunks of 128, 24 heads
# of 64, state 128 (one group).
MAMBA2_SSD = dict(B=1, nc=8, Q=128, H=24, P=64, N=128)
Q8_SWIGLU_TOL = 1e-5                          # the gate's expf; matmul: exact
SSD_TOL = 3e-4
SERVE_SK = 6144 + 8 + 4096                   # the serve cache: prompt + new + chunk
GATING_TOL = 1e-6
FLASH_TOL = {"bf16": 1e-2, "fp32": 1e-4}
# A row's logsumexp against the plain version's, of max(|lse|, 1); the
# shards' combine against the one launch over the whole cache in fp32.
LSE_TOL = {"bf16": 1e-4, "fp32": 1e-5}
LSE_COMBINE_TOL = 1e-5
SERVE = dict(requests=4, chunk=4096, max_new=8, reduce=False,
             balancer="ultraep", seed=0, prompt_len=(2048, 6144),
             decode_batch=4, cf=4.0)
# The plan solve's cases: (R, E, top-k) of GLM-4.5-Air / Qwen3-235B-A22B and
# Jamba-v0.1, 4096 tokens a rank, three expert popularity laws.
PLAN_CASES = ([(R, 128, 8) for R in (8, 16, 32, 64)]
              + [(R, 16, 2) for R in (2, 4, 8, 16)])
PLAN_LAWS = ("uniform", "zipf", "hot4")
PLAN_TOKENS = 4096
EP_RANKS, EP_TOKENS = 2, 4096                # phase 9: ranks, tokens a rank
# Row 5r: (tag, T, E, k, score_fn, num_racks G, rack_limit M, group top-k,
# timing iterations): DeepSeek-V3's prefill shape and published
# node-limited routing (n_group 8, topk_group 4, group score of the top 2;
# arXiv:2412.19437 S2.1.2), two racks of which one, and decode; then, at
# prefill and decode, the geometries the kernel's first rack mode refused:
# Jamba-v0.1's 16 experts (top-2) over 8 racks, DBRX's routing (16
# experts, top-4) at 8 racks, DeepSeek-V2's device-limited routing (160
# experts, top-6, 8 devices of which 3, group top-1; arXiv:2405.04434
# S3.2.2), E not a multiple of 4, a group top-8, one expert a rack.
RACK_GATE_CASES = [("ds_g8_m4", 4096, 256, 8, "sigmoid", 8, 4, 2, 20),
                   ("ds_g2_m1", 4096, 256, 8, "sigmoid", 2, 1, 2, 20),
                   ("ds_g8_m4_decode", 4, 256, 8, "sigmoid", 8, 4, 2, 50)] + [
    (tag + sfx, T, E, k, fn, G, M, gk, 10)
    for tag, E, k, fn, G, M, gk in (
        ("jamba_g8_m2", 16, 2, "softmax", 8, 2, 2),
        ("dbrx_g8_m2", 16, 4, "softmax", 8, 2, 2),
        ("dsv2_g8_m3", 160, 6, "softmax", 8, 3, 1),
        ("e60_g6_m2", 60, 4, "softmax", 6, 2, 2),
        ("ds_g2_m1_gk8", 256, 8, "sigmoid", 2, 1, 8),
        ("e16_g16_m8", 16, 2, "softmax", 16, 8, 1))
    for sfx, T in (("", 4096), ("_decode", 4))]
# Row Pr: PLAN_CASES at rack size 8 (2 at R 4; R 2 has no rack tier).
RACK_PLAN_CASES = [(R, E, k, 8 if R % 8 == 0 else 2)
                   for R, E, k in PLAN_CASES if R >= 4]
RACKS, RACK_RANKS, RACK_TOKENS = 2, 4, 2048   # phase 14: 2 racks x 2 lanes
# Row Pe: (R, E, top-k) of GLM-4.5-Air (E 128) and DeepSeek-V3 (E 256) at
# R 64, n_slot 2, timed; and the sweep held bitwise to the plain version:
# (E, R, n_slot, max_rep, load) over E 16-256, R 2-64, n_slot 1-4, max_rep
# 2..R, with Zipf loads, equal loads (ties everywhere), zero loads (every
# expert retired, no placement), half the experts at zero, and max_rep 2
# (the hot experts retired after one replica); then R 128 and R 256 (8
# ranks a lane) and E 1024 (32 experts a lane, lists in shared memory).
EPLB_CASES = [(64, 128, 8), (64, 256, 8)]
EPLB_SWEEP = [(16, 2, 1, 2, "zipf"), (16, 4, 4, 4, "equal"),
              (16, 16, 2, 16, "zipf"), (16, 16, 3, 2, "half_zero"),
              (32, 8, 2, 8, "zero"), (32, 32, 4, 32, "equal"),
              (64, 2, 4, 2, "zipf"), (64, 4, 3, 4, "half_zero"),
              (64, 16, 1, 16, "equal"), (64, 32, 2, 2, "zipf"),
              (64, 64, 4, 64, "zipf"), (128, 8, 2, 8, "zipf"),
              (128, 16, 4, 2, "zipf"), (128, 32, 3, 32, "half_zero"),
              (128, 64, 1, 64, "equal"), (128, 64, 4, 2, "zipf"),
              (128, 64, 2, 64, "zero"), (256, 4, 2, 4, "zipf"),
              (256, 16, 3, 16, "equal"), (256, 32, 4, 32, "zipf"),
              (256, 64, 1, 2, "zipf"), (256, 64, 4, 64, "half_zero"),
              (256, 64, 3, 33, "equal"), (256, 128, 2, 128, "zipf"),
              (256, 256, 2, 256, "zipf"), (256, 256, 1, 256, "equal"),
              (1024, 32, 3, 32, "half_zero")]
# Rows Pk and Ph: (R, E, top-k, rack size or None); P 1 beside P 4 and 8.
KARY_CASES = [(64, 128, 8, None), (64, 128, 8, 8), (64, 256, 8, None),
              (64, 256, 8, 8)]
KARY_PS = (1, 4, 8)
HEALTH_CASES = [(64, 128, 8, None), (64, 128, 8, 8)]
# Phase 15: DeepSeek-V3's and GLM-4.5-Air's expert counts at R 64, top-8,
# PLAN_TOKENS a rank, Zipf exponent BAL_ZIPF over a shuffled expert order
# (0.4 puts the home-rank imbalance inside the paper's 1.30-4.01); the
# stale estimate is the EMA of BAL_HISTORY earlier batches whose
# popularity is the current one rolled by E / 2.
BAL_CASES = [("deepseek-v3-671b", 256), ("glm45-106b-a12b", 128)]
BAL_ZIPF, BAL_HISTORY, BAL_R, BAL_K = 0.4, 3, 64, 8
BAL_MODES = (("none", 1), ("eplb", 1), ("eplb_plus", 1), ("lplb", 1),
             ("ultraep", 1), ("ultraep", 4))


def _hw():
    """The card's data-sheet figures (``repro_torch.roofline.hw.H100``:
    HBM bytes a second, ``peak(kind)`` operations a second by dtype)."""
    from repro_torch.roofline.hw import H100

    return H100


def _line(tag: str, payload) -> None:
    print(f"{tag} {json.dumps(payload)}", flush=True)


def _cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float, kind: str) -> tuple[float, str]:
    t_ops = flops / _hw().peak(kind)
    t_mem = nbytes / _hw().hbm_bw
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


def _max_err(out, ref) -> tuple[float, float]:
    return ((out.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def phase_card():
    import torch

    from repro_torch.kernels.build import build_all

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    logs = build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in logs.items()}
    _line("phase1_card", {
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "python": sys.version.split()[0], "tf32": False,
        "kernel_build_s": round(build_s, 3), "ptxas": ptxas})


def _kernel_inputs(G, M, K, N, dtype, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(shape, scale):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)

    return (n((G, M, K), 1.0), n((G, K, N), K ** -0.5), n((G, K, N), K ** -0.5),
            n((G, N, K), N ** -0.5))


def _check_case(name, fn, ref, tol):
    import torch

    out = fn()
    torch.cuda.synchronize()
    expect = ref()
    err, scale = _max_err(out, expect)
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max|err| {err:.3e} > {tol} * "
                             f"max|ref| {scale:.3e}")
    return err, scale


def _time_pair(kernel, plain, library, flops, nbytes, kind, iters):
    """Kernel, plain and library (None: no one PyTorch call computes the
    same function) times in ms, and the card's bound for the work."""
    ms = _cuda_ms(kernel, iters)
    plain_ms = _cuda_ms(plain, max(1, iters // 2))
    library_ms = None if library is None else _cuda_ms(library, iters)
    bound_ms, bound_by = _bound(flops, nbytes, kind)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _serve_dispatch(cfg, T: int, mode: str, seed: int, cf=SERVE["cf"],
                    x_grad: bool = False, **runtime):
    """The dispatch stage's output and the slot capacity as the serve path
    makes them: the port's gate, ``ultraep`` plan and bucket on T seeded
    tokens at ``cfg``'s width, with capacity factors ``cf`` (the serve
    path's by default) and the ``RuntimeConfig`` fields in ``runtime`` (the
    wire and FFN dtypes).  ``x_grad``: the tokens require a gradient, so
    the slot buffers' backward runs to them; the tokens are returned
    third."""
    import torch

    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.models.transformer import (
        ParallelCtx,
        RuntimeConfig,
        moe_config,
    )
    from repro_torch.moe import stages

    rcfg = RuntimeConfig(balancer=BalancerConfig(mode=SERVE["balancer"],
                                                 n_slot=cfg.moe.n_slot),
                         cf_pair=cf, cf_slot=cf, dtype=torch.bfloat16,
                         **runtime)
    mcfg = moe_config(cfg, rcfg, ParallelCtx(), T, dispatch_mode=mode)
    g = torch.Generator(device="cuda").manual_seed(seed)
    D = cfg.d_model
    router = torch.randn((D, cfg.moe.num_experts), generator=g,
                         device="cuda") * D ** -0.5
    x = torch.randn((T, D), generator=g, device="cuda").to(torch.bfloat16)
    x.requires_grad_(x_grad)
    ctx = stages.make_stage_ctx(mcfg, None)
    with torch.set_grad_enabled(x_grad):
        gs = stages.gate_stage(ctx, x, router)
        ps = stages.plan_stage(ctx, gs)
        ds = stages.dispatch_stage(ctx, x, gs.gate_out.expert_ids, gs, ps)
    if not torch.equal(ds.rows, ds.valid.sum(dim=1)):
        raise AssertionError("bucket rows differ from its validity mask")
    return (ds, mcfg.cap_slot, x) if x_grad else (ds, mcfg.cap_slot)


def _serve_rows(cfg, T: int, mode: str, seed: int, cf=SERVE["cf"]):
    """Each slot's valid-row count and the slot capacity as the serve path
    makes them (see :func:`_serve_dispatch`)."""
    ds, cap = _serve_dispatch(cfg, T, mode, seed, cf)
    return ds.rows, cap


def phase_kernels(glm, jamba, deepseek, dbrx) -> dict:
    """Both grouped-GEMM kernels vs their plain versions, every row valid
    and at the serve path's row counts; returns the records by name."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.grouped_gemm import ops

    records = {"grouped_swiglu": {}, "grouped_matmul": {}}
    # tag, shape or (config, tokens, dispatch mode) for serve counts, dtype,
    # timing iterations
    cases = [("prefill", PREFILL, torch.bfloat16, 10),
             ("decode", DECODE, torch.bfloat16, 20),
             ("jamba_prefill", JAMBA_PREFILL, torch.bfloat16, 3),
             ("jamba_decode", JAMBA_DECODE, torch.bfloat16, 10),
             ("prefill_serve", (glm, 4096, "a2a"), torch.bfloat16, 10),
             ("decode_serve", (glm, 4, "replicated"), torch.bfloat16, 20),
             ("jamba_prefill_serve", (jamba, 4096, "a2a"), torch.bfloat16,
              5),
             # DeepSeek-V3: 256 mains + 2 replicas, d_model 7168, d_ff 2048.
             ("deepseek_prefill_serve", (deepseek, 4096, "a2a"),
              torch.bfloat16, 3),
             ("deepseek_decode_serve", (deepseek, 4, "replicated"),
              torch.bfloat16, 10),
             # DBRX-132B (the hosts phase's serve path): 16 coarse experts
             # top-4, 4 slots, d_model 6144, d_ff 10752; a 1024-token chunk
             # and a decode step of 4.
             ("dbrx_prefill_serve", (dbrx, 1024, "a2a"), torch.bfloat16, 5),
             ("dbrx_decode_serve", (dbrx, 4, "replicated"), torch.bfloat16,
              10),
             ("fp32_g8", dict(PREFILL, G=8), torch.float32, 3),
             ("prefill_serve_fp32", (glm, 4096, "a2a"), torch.float32, 3),
             ("decode_serve_fp32", (glm, 4, "replicated"), torch.float32, 20),
             # Counts that straddle a warp's fragments, a tile and M, an
             # empty slot; the padded rows of x (and of the matmul's input)
             # hold NaN, which must not reach the output.
             ("straddle_nan_fp32", dict(G=5, M=300, K=4096, N=1408,
                                        rows=[0, 37, 129, 300, 250]),
              torch.float32, 0),
             ("ragged_m1", dict(G=1, M=1, K=4096, N=1408), torch.bfloat16, 0),
             ("ragged_tiles", dict(G=3, M=1009, K=136, N=200), torch.bfloat16, 0),
             ("ragged_small", dict(G=2, M=65, K=33, N=129), torch.bfloat16, 0),
             ("ragged_m1_fp32", dict(G=1, M=1, K=70, N=45), torch.float32, 0),
             ("ragged_tiles_fp32", dict(G=3, M=1009, K=136, N=200),
              torch.float32, 0)]
    for tag, s, dtype, iters in cases:
        rows = mask = None
        junk = 0.0     # what the padded rows of x hold
        if isinstance(s, tuple):
            cfg, T, mode = s
            rows, cap = _serve_rows(cfg, T, mode, seed=len(tag))
            s = dict(G=rows.numel(), M=cap, K=cfg.d_model, N=cfg.moe.d_ff)
        elif "rows" in s:
            rows = torch.tensor(s["rows"], device="cuda")
            junk = float("nan")
        G, M, K, N = s["G"], s["M"], s["K"], s["N"]
        x, w1, w3, w2 = _kernel_inputs(G, M, K, N, dtype, seed=len(tag))
        if rows is None:
            V, S = G * M, G
        else:
            mask = ops._row_mask(rows, M)
            x = torch.where(mask, x, torch.full((), junk, dtype=dtype,
                                                device="cuda"))
            V, S = int(rows.sum()), int((rows > 0).sum())
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        tol = 1e-2 if kind == "bf16" else 1e-4
        elt = x.element_size()
        act = ops.grouped_swiglu(x, w1, w3, rows)
        sw = dict(zip(("max_abs_err", "max_abs_ref"), _check_case(
            f"grouped_swiglu {tag}", lambda: act,
            lambda: ops.grouped_swiglu_ref(x, w1, w3, rows), tol)))
        act_in = act if junk == 0.0 else torch.where(
            mask, act, torch.full((), junk, dtype=dtype, device="cuda"))
        out = ops.grouped_matmul(act_in, w2, rows)
        mm = dict(zip(("max_abs_err", "max_abs_ref"), _check_case(
            f"grouped_matmul {tag}", lambda: out,
            lambda: ops.grouped_matmul_ref(act_in, w2, rows), tol)))
        if mask is not None:
            for name, t in (("grouped_swiglu", act), ("grouped_matmul", out)):
                if t.masked_select(~mask).any():
                    raise AssertionError(f"{name} {tag}: a padded row is not "
                                         f"zero")
            sw["rows"] = mm["rows"] = {
                "cap_slot": M, "slots": G, "slots_with_rows": S,
                "min": int(rows.min()), "mean": V / G, "max": int(rows.max()),
                "sum": V}
        if iters:
            # Bound on the valid rows' work: their products, their x rows
            # and the weights of the slots that hold any, the whole output
            # (padded rows are written as zeros).  fp32: the kernels'
            # arithmetic, three TF32 products at the TF32 rate; the fp32
            # CUDA-core bound beside it.
            for rec, fns, flops, nbytes in (
                    (sw, (lambda: ops.grouped_swiglu(x, w1, w3, rows),
                          lambda: ops.grouped_swiglu_ref(x, w1, w3, rows),
                          lambda: F.silu(torch.bmm(x, w1))
                          * torch.bmm(x, w3)),
                     4.0 * V * K * N,
                     (V * K + 2 * S * K * N + G * M * N) * elt),
                    (mm, (lambda: ops.grouped_matmul(act_in, w2, rows),
                          lambda: ops.grouped_matmul_ref(act_in, w2, rows),
                          lambda: torch.bmm(act_in, w2)),
                     2.0 * V * N * K, (V * N + S * N * K + G * M * K) * elt)):
                if kind == "fp32":
                    rec["bound_fp32_ms"], _ = _bound(flops, nbytes, "fp32")
                    flops, kind_ops = 3 * flops, "tf32"
                else:
                    kind_ops = kind
                rec.update(_time_pair(*fns, flops, nbytes, kind_ops, iters))
                rec["bytes_bound_ms"] = nbytes / _hw().hbm_bw * 1e3
                rec["slower_than_library"] = rec["ms"] > rec["library_ms"]
        records["grouped_swiglu"][tag] = dict(shape=[G, M, K, N], dtype=kind, **sw)
        records["grouped_matmul"][tag] = dict(shape=[G, M, N, K], dtype=kind, **mm)
        del x, w1, w3, w2, act, act_in, out
        torch.cuda.empty_cache()
    _line("phase2_kernels", records)
    return records


def _q8_operands(G, M, K, N, seed, layout, rows=None):
    """The w8a8 FFN's operands as the main path builds them.  Activations
    x ~ N(0, 1) in bf16, (G, M, K), with the rows past ``rows[g]`` zero as
    the bucket leaves them, encoded for the int8 wire and split: ``layout``
    "padded", codes a view of wire rows padded to 16 bytes, as the bucket
    lays them out (TMA reads them), or "wire", a view of unpadded wire rows
    K + 4 bytes apart (TMA cannot: the wrapper copies them first); or
    "contiguous", quantized per row (as the decode path and the down
    projection get them).  Weights: see :func:`_q8_weights`."""
    import torch

    from repro_torch.core.quantize import (
        encode_wire,
        quantize_rows,
        split_wire_int8,
    )
    from repro_torch.kernels.grouped_gemm import ops

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((G, M, K), generator=g, device="cuda").to(torch.bfloat16)
    if rows is not None:
        x = torch.where(ops._row_mask(rows, M), x,
                        torch.zeros((), dtype=x.dtype, device="cuda"))
    if layout == "contiguous":
        q, rs = quantize_rows(x)
    else:
        wire = encode_wire(x, "int8")
        if layout == "padded":
            pitch = -(-(K + 4) // 16) * 16
            wire = torch.empty((G, M, pitch), dtype=torch.int8,
                               device="cuda")[..., :K + 4].copy_(wire)
        q, rs = split_wire_int8(wire)
    return q, rs, _q8_weights(G, K, N, seed + 1)


def _q8_weights(G, K, N, seed):
    """Weights w1, w3 (G, K, N) and w2 (G, N, K), bf16 ~ N(0, 1/fan_in),
    quantized per column with their codes stored K-contiguous, as
    ``MoEParams.q8_slot_buffers`` keeps them."""
    import torch

    from repro_torch.moe.expert import quantize_weight_cols

    g = torch.Generator(device="cuda").manual_seed(seed)
    ws = []
    for shape in ((G, K, N), (G, K, N), (G, N, K)):
        w = (torch.randn(shape, generator=g, device="cuda")
             * shape[1] ** -0.5).to(torch.bfloat16)
        codes, scales = quantize_weight_cols(w)
        ws.append((codes.transpose(1, 2).contiguous().transpose(1, 2), scales))
    return ws


def _q8_serve_operands(cfg, T, mode, seed, wire_view):
    """The w8a8 FFN's operands at the serve path's row counts, activations
    from the port's dispatch stage with ``wire_dtype = ffn_dtype = "int8"``:
    in ``a2a`` the bucket's view of the int8 wire (rows padded to 16
    bytes), in ``replicated`` the bf16 bucket quantized per row, as
    ``grouped_ffn`` does; ``wire_view`` copies the a2a codes into unpadded
    wire rows (K + 4 bytes apart).  Weights: see :func:`_q8_weights`."""
    import torch

    from repro_torch.core.quantize import quantize_rows

    ds, cap = _serve_dispatch(cfg, T, mode, seed, wire_dtype="int8",
                              ffn_dtype="int8")
    q, rs = (ds.xs, ds.xs_scale) if ds.xs.dtype == torch.int8 else \
        quantize_rows(ds.xs)
    if wire_view:
        G, M, K = q.shape
        q = torch.zeros((G, M, K + 4), dtype=torch.int8,
                        device="cuda")[..., :K].copy_(q)
    return ds.rows, q, rs, _q8_weights(q.shape[0], cfg.d_model,
                                       cfg.moe.d_ff, seed + 1)


def _int_mm_ffn(q, rs, w1, s1, w3, s3, aq, as_, w2, s2):
    """The library yardstick for the q8 pair: one ``torch._int_mm`` (cuBLAS
    int8 -> int32) per group in a Python loop over every row of the slot
    buffers, then the same dequant (and gate) in PyTorch.  None where
    ``_int_mm`` refuses the shape (it needs more than 16 rows, and K and N
    multiples of 8)."""
    import torch
    import torch.nn.functional as F

    G, M, K = q.shape
    N = w1.shape[2]
    if M <= 16 or K % 8 or N % 8:
        return None, None
    qc = q.contiguous()
    acc1, acc3 = (torch.empty((G, M, N), dtype=torch.int32, device=q.device)
                  for _ in range(2))
    acc2 = torch.empty((G, M, K), dtype=torch.int32, device=q.device)

    def swiglu():
        for i in range(G):
            torch._int_mm(qc[i], w1[i], out=acc1[i])
            torch._int_mm(qc[i], w3[i], out=acc3[i])
        return (F.silu(acc1.float() * rs[:, :, None] * s1[:, None, :])
                * (acc3.float() * rs[:, :, None] * s3[:, None, :]))

    def matmul():
        for i in range(G):
            torch._int_mm(aq[i], w2[i], out=acc2[i])
        return acc2.float() * as_[:, :, None] * s2[:, None, :]

    return swiglu, matmul


def phase_kernels_q8(glm) -> dict:
    """The w8a8 pair vs their plain versions, every row valid and with
    row counts (the serve path's, tiles straddled, empty slots); returns
    the records by name (``grouped_matmul_q8`` also by ``<tag>_bf16``, the
    bf16 output the FFN's down projection writes)."""
    import torch

    from repro_torch.core.quantize import quantize_rows
    from repro_torch.kernels.grouped_gemm import ops

    records = {"grouped_swiglu_q8": {}, "grouped_matmul_q8": {}}
    # tag, shape, or (config, tokens, dispatch mode) for the serve path's
    # counts and activations, or (shape, counts); activation layout (see
    # _q8_operands; "serve": the dispatch stage's, "wire": also copied into
    # unpadded wire rows); timing iterations
    cases = [("prefill", PREFILL, "padded", 10),
             ("decode", DECODE, "padded", 20),
             ("prefill_contiguous", PREFILL, "contiguous", 10),
             ("prefill_serve", (glm, 4096, "a2a"), "serve", 10),
             ("prefill_serve_wire", (glm, 4096, "a2a"), "wire", 10),
             ("decode_serve", (glm, 4, "replicated"), "serve", 20),
             ("rows_straddle", (dict(G=6, M=300, K=512, N=384),
                                [1, 127, 129, 255, 256, 300]), "wire", 0),
             ("rows_straddle_padded", (dict(G=6, M=300, K=512, N=384),
                                       [1, 127, 129, 255, 256, 300]),
              "padded", 0),
             ("rows_empty_slots", (dict(G=5, M=1009, K=4096, N=1408),
                                   [0, 700, 0, 1009, 0]), "padded", 0),
             ("rows_straddle_contiguous", (dict(G=4, M=65, K=136, N=200),
                                           [0, 64, 65, 3]), "contiguous", 0),
             ("ragged_m1", dict(G=1, M=1, K=4096, N=1408), "padded", 0),
             ("ragged_tiles", dict(G=3, M=1009, K=136, N=200), "padded", 0),
             ("ragged_small", dict(G=2, M=65, K=33, N=129), "wire", 0),
             ("ragged_small_padded", dict(G=2, M=65, K=33, N=129), "padded",
              0),
             ("ragged_small_contiguous", dict(G=2, M=65, K=33, N=129),
              "contiguous", 0)]
    for tag, s, layout, iters in cases:
        rows = None
        if isinstance(s, tuple) and len(s) == 3:
            rows, q, rs, ((w1, s1), (w3, s3), (w2, s2)) = _q8_serve_operands(
                *s, seed=len(tag), wire_view=layout == "wire")
            G, M, K = q.shape
            N = s[0].moe.d_ff
        else:
            if isinstance(s, tuple):
                s, counts = s
                rows = torch.tensor(counts, dtype=torch.int64, device="cuda")
            G, M, K, N = s["G"], s["M"], s["K"], s["N"]
            q, rs, ((w1, s1), (w3, s3), (w2, s2)) = _q8_operands(
                G, M, K, N, seed=len(tag), layout=layout, rows=rows)
        if rows is None:
            V, S = G * M, G
        else:
            # The kernels must ignore what padded rows hold: NaN row scales.
            mask = ops._row_mask(rows, M)
            rs = torch.where(mask[..., 0], rs,
                             torch.full_like(rs, float("nan")))
            V, S = int(rows.sum()), int((rows > 0).sum())
        copies = ops.grouped_swiglu_q8.padded_copies
        act = ops.grouped_swiglu_q8(q, rs, w1, s1, w3, s3, rows)
        copies = ops.grouped_swiglu_q8.padded_copies - copies
        # TMA reads every operand whose rows are 16-byte aligned; the
        # wrapper copies the others (unpadded wire rows, a K that is not a
        # multiple of 16), and counts them.  The serve path makes no copy.
        expect = int(not ops._tma_ready(q)) + 2 * (K % 16 != 0)
        if copies != expect or (layout == "serve" and copies):
            raise AssertionError(f"grouped_swiglu_q8 {tag}: {copies} padded "
                                 f"copies, expected {expect}")
        sw = dict(zip(("max_abs_err", "max_abs_ref"), _check_case(
            f"grouped_swiglu_q8 {tag}", lambda: act,
            lambda: ops.grouped_swiglu_q8_ref(q, rs, w1, s1, w3, s3, rows),
            Q8_SWIGLU_TOL)))
        aq, as_ = quantize_rows(act)
        mm = {}
        for dtype, key in ((torch.float32, tag), (torch.bfloat16,
                                                  tag + "_bf16")):
            out = ops.grouped_matmul_q8(aq, as_, w2, s2, rows, out_dtype=dtype)
            torch.cuda.synchronize()
            ref = ops.grouped_matmul_q8_ref(aq, as_, w2, s2, rows,
                                            out_dtype=dtype)
            err, scale = _max_err(out, ref)
            if out.dtype != dtype or not torch.equal(out, ref):
                raise AssertionError(f"grouped_matmul_q8 {key}: not bitwise "
                                     f"equal to its plain version (max|err| "
                                     f"{err:.3e})")
            mm[key] = {"max_abs_err": err, "max_abs_ref": scale,
                       "out_dtype": str(dtype).split(".")[1]}
        if rows is not None:
            for name, t in (("grouped_swiglu_q8", act),
                            ("grouped_matmul_q8", out)):
                if t.masked_select(~mask).any():
                    raise AssertionError(f"{name} {tag}: a padded row is not "
                                         f"zero")
            sw["rows"] = {"cap_slot": M, "slots": G, "slots_with_rows": S,
                          "min": int(rows.min()), "mean": V / G,
                          "max": int(rows.max()), "sum": V}
            for rec in mm.values():
                rec["rows"] = sw["rows"]
        sw["q_row_bytes"] = q.stride(1)
        sw["padded_copies"] = copies
        if iters and layout != "contiguous":   # a contiguous copy's cost
            sw["q_contiguous_copy_ms"] = _cuda_ms(lambda: q.contiguous(),
                                                  iters)
        if iters:
            lib_sw, lib_mm = _int_mm_ffn(q, rs, w1, s1, w3, s3, aq, as_, w2,
                                         s2)
            if lib_sw is not None:
                # The yardstick must compute the same function on the
                # valid rows (it computes every row: padded ones are NaN).
                keep = (torch.ones((G, M, 1), dtype=torch.bool, device="cuda")
                        if rows is None else mask)
                if not torch.equal(torch.where(keep, lib_mm(), 0.0),
                                   ops.grouped_matmul_q8_ref(aq, as_, w2, s2,
                                                             rows)):
                    raise AssertionError(f"_int_mm yardstick {tag} differs")
                lib_err, _ = _max_err(torch.where(keep, lib_sw(), 0.0), act)
                if not lib_err <= Q8_SWIGLU_TOL * sw["max_abs_ref"]:
                    raise AssertionError(f"_int_mm yardstick {tag} differs")
            # Bounds on the valid work: the valid rows' products, codes,
            # scales and output, the weights of the slots that hold rows
            # (``bound_ms``); ``bound_all_rows_ms`` also counts the zeros
            # written for the padded rows.
            sw.update(_time_pair(
                lambda: ops.grouped_swiglu_q8(q, rs, w1, s1, w3, s3, rows),
                lambda: ops.grouped_swiglu_q8_ref(q, rs, w1, s1, w3, s3, rows),
                lib_sw, 4.0 * V * K * N,
                V * K + 4 * V + 2 * S * K * N + 8 * S * N + 4 * V * N,
                "int8", iters))
            sw["bound_all_rows_ms"] = _bound(
                4.0 * V * K * N,
                V * K + 4 * V + 2 * S * K * N + 8 * S * N + 4 * G * M * N,
                "int8")[0]
            for dtype, key in ((torch.float32, tag), (torch.bfloat16,
                                                      tag + "_bf16")):
                elt = 4 if dtype == torch.float32 else 2
                lib = None if lib_mm is None else (
                    lib_mm if elt == 4 else lambda: lib_mm().to(dtype))
                mm[key].update(_time_pair(
                    lambda: ops.grouped_matmul_q8(aq, as_, w2, s2, rows,
                                                  out_dtype=dtype),
                    lambda: ops.grouped_matmul_q8_ref(aq, as_, w2, s2, rows,
                                                      out_dtype=dtype),
                    lib, 2.0 * V * N * K,
                    V * N + 4 * V + S * N * K + 4 * S * K + elt * V * K,
                    "int8", iters))
                mm[key]["bound_all_rows_ms"] = _bound(
                    2.0 * V * N * K,
                    V * N + 4 * V + S * N * K + 4 * S * K + elt * G * M * K,
                    "int8")[0]
            if lib_sw is None:
                sw["library_note"] = "none: torch._int_mm needs more than 16 rows"
                for rec in mm.values():
                    rec["library_note"] = sw["library_note"]
        records["grouped_swiglu_q8"][tag] = dict(shape=[G, M, K, N], **sw)
        for key, rec in mm.items():
            records["grouped_matmul_q8"][key] = dict(shape=[G, M, N, K], **rec)
        del q, rs, w1, w3, w2, s1, s3, s2, act, aq, as_, out, ref
        torch.cuda.empty_cache()
    _line("phase2_kernels_q8", records)
    return records


def phase_moe_layer(glm):
    """The balanced layer at full width vs the dense oracle in fp32."""
    import torch

    from repro_torch.moe.gating import gate
    from repro_torch.moe.layer import MoEParams, init_moe_params, moe_layer_local
    from repro_torch.moe.reference import moe_ref
    from repro_torch.models.transformer import (
        ParallelCtx,
        RuntimeConfig,
        moe_config,
    )

    T = 4096
    rcfg = RuntimeConfig(cf_pair=4.0, cf_slot=4.0, dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cfg_a2a = moe_config(glm, rcfg, ParallelCtx(), T)
    p16 = init_moe_params(cfg_a2a, gen, dtype=torch.bfloat16, device="cuda")
    x16 = torch.randn((T, glm.d_model), generator=gen, device="cuda"
                      ).to(torch.bfloat16)
    p32 = MoEParams(p16.router, *(w.float() for w in (
        p16.w1, p16.w3, p16.w2, p16.shared_w1, p16.shared_w3, p16.shared_w2)),
        n_slot=p16.n_slot)
    x32 = x16.float()
    result = {}
    with torch.inference_mode():
        go = gate(x32, p32.router, cfg_a2a.gating)
        ref = moe_ref(x32, go.expert_ids, go.weights, p32.w1, p32.w3, p32.w2,
                      shared=(p32.shared_w1, p32.shared_w3, p32.shared_w2))
        for mode, params, x, tol in (("a2a", p32, x32, 1e-4),
                                     ("a2a", p16, x16, 2e-2),
                                     ("replicated", p16, x16, 2e-2)):
            cfg = dataclasses.replace(cfg_a2a, dispatch_mode=mode)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, aux, st = moe_layer_local(x, params, cfg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            err, scale = _max_err(y, ref)
            key = f"{mode}_{'fp32' if x.dtype == torch.float32 else 'bf16'}"
            drops = int(st.drops_dispatch) + int(st.drops_slot)
            if drops or int(st.counts.sum()) != T * cfg.gating.top_k:
                raise AssertionError(f"moe layer {key}: drops {drops}, "
                                     f"counts {int(st.counts.sum())}")
            if not (torch.isfinite(y).all() and err <= tol * scale):
                raise AssertionError(f"moe layer {key}: max|err| {err:.3e} > "
                                     f"{tol} * max|ref| {scale:.3e}")
            result[key] = {"max_abs_err": err, "max_abs_ref": scale, "tol": tol,
                           "wall_ms": wall_ms, "pre_max": int(st.pre_max),
                           "post_max": int(st.post_max),
                           "max_slot_load": int(st.max_slot_load),
                           "cap_slot": cfg.cap_slot, "cap_pair": cfg.cap_pair}
            if x.dtype == torch.bfloat16:
                counts16 = st.counts
                # At R = 1 the plan is the home quota with no read: the
                # whole layer call makes no host sync.
                _sync_free(lambda: moe_layer_local(x, params, cfg))
                result[key]["sync_free"] = True
        # The quantized layer: int8 wire and w8a8 FFN, and the int8 wire
        # alone, each in both dispatch modes.  The first q8 call also
        # quantizes the mains' weights once (wall_first_ms).
        for wire, ffn in (("int8", "int8"), ("int8", "none")):
            for mode in ("a2a", "replicated"):
                cfg = dataclasses.replace(cfg_a2a, dispatch_mode=mode,
                                          wire_dtype=wire, ffn_dtype=ffn)
                walls = []
                for _ in range(2):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y, aux, st = moe_layer_local(x16, p16, cfg)
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
                key = f"{mode}_bf16_wire_{wire}_ffn_{ffn}"
                err, scale = _max_err(y, ref)
                drops = int(st.drops_dispatch) + int(st.drops_slot)
                if drops or not torch.equal(st.counts, counts16):
                    raise AssertionError(f"moe layer {key}: drops {drops}, "
                                         f"counts differ from the bf16 layer")
                if not (torch.isfinite(y).all() and err <= 3e-2 * scale):
                    raise AssertionError(f"moe layer {key}: max|err| {err:.3e}"
                                         f" > 3e-2 * max|ref| {scale:.3e}")
                result[key] = {"max_abs_err": err, "max_abs_ref": scale,
                               "tol": 3e-2, "wall_first_ms": walls[0],
                               "wall_ms": walls[1]}
    _line("phase3_moe_layer", result)
    del p16, p32, x16, x32, ref, go
    torch.cuda.empty_cache()


def _ssd_inputs(B, nc, Q, H, P, N, dtype, seed):
    """xs, Bm, Cm ~ N(0, 0.25) in ``dtype``; dt = softplus(N(0, 1)) and
    da = -0.4 dt in fp32; an initial state ~ N(0, 1) in fp32."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    xs, Bm, Cm = (n(shape, 0.5).to(dtype) for shape in (
        (B, nc, Q, H, P), (B, nc, Q, H, N), (B, nc, Q, H, N)))
    dt = F.softplus(n((B, nc, Q, H)))
    return xs, Bm, Cm, dt, -0.4 * dt, n((B, H, N, P))


def _ssd_cost(B, nc, Q, H, P, N, elt):
    """(fp32 operations, bytes) the intra-chunk function needs: the causal
    triangle's C.B products, weights and W @ x, the chunk states, the scan;
    each input read once and each fp32 output written once."""
    pairs = Q * (Q + 1) // 2
    flops = B * nc * H * (pairs * (2 * N + 3 + 2 * P) + 2 * Q * N * P + 4 * Q)
    rows = B * nc * Q * H
    nbytes = (rows * (P + 2 * N) * elt + 2 * rows * 4 + rows * P * 4
              + B * nc * H * N * P * 4 + B * nc * H * 4)
    return flops, nbytes


def _ssd_tensor_bound(B, nc, Q, H, P, N, elt, nbytes):
    """(ms, bound_by) under the kernel's own arithmetic, all of it on bf16
    tensor cores: C.B as one product (fp32 inputs: hi + lo splits, three
    products), W @ x and the chunk states as two (W_hi, W_lo; fp32 inputs:
    three), against the bytes each input and output needs once."""
    pairs = B * nc * H * Q * (Q + 1) // 2
    cb = 2.0 * N * pairs
    wx = 2.0 * P * pairs + 2.0 * B * nc * H * Q * N * P
    n_cb, n_wx = (1, 2) if elt == 2 else (3, 3)
    t_ops = (n_cb * cb + n_wx * wx) / _hw().peak("bf16")
    t_mem = nbytes / _hw().hbm_bw
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


def phase_ssd() -> dict:
    """``ssd_intra_chunk`` and ``ssd_chunk_scan`` vs their plain versions."""
    import torch

    from repro_torch.kernels.ssd_scan import ops

    cases = [("jamba_prefill", JAMBA_SSD, torch.bfloat16, 20),
             ("jamba_prefill_fp32", JAMBA_SSD, torch.float32, 10),
             ("mamba2_prefill", MAMBA2_SSD, torch.bfloat16, 20),
             ("mamba2_prefill_fp32", MAMBA2_SSD, torch.float32, 10),
             ("reduced_nc1", REDUCED_SSD, torch.bfloat16, 0),
             ("reduced_nc1_fp32", REDUCED_SSD, torch.float32, 0),
             ("reduced_b2", dict(REDUCED_SSD, B=2, nc=4), torch.bfloat16, 0),
             ("reduced_b2_fp32", dict(REDUCED_SSD, B=2, nc=4), torch.float32,
              0),
             ("ragged_fp32", dict(B=2, nc=3, Q=13, H=3, P=6, N=5),
              torch.float32, 0)]
    records = {}
    for tag, s, dtype, iters in cases:
        shape = [s[k] for k in ("B", "nc", "Q", "H", "P", "N")]
        xs, Bm, Cm, dt, da, s0 = _ssd_inputs(*shape, dtype, seed=len(tag))
        args = (xs, Bm, Cm, dt, da)
        got = ops.ssd_intra_chunk(*args)
        got += ops.ssd_chunk_scan(*args, initial_state=s0)
        torch.cuda.synchronize()
        want = ops.ssd_intra_chunk_ref(*args)
        want += ops.ssd_chunk_scan_ref(*args, initial_state=s0)
        errs, scales = {}, {}
        for name, out, ref in zip(("y_intra", "S", "decay", "y", "final"),
                                  got, want):
            err, scale = _max_err(out, ref)
            if not err <= SSD_TOL * scale:
                raise AssertionError(f"ssd {tag} {name}: max|err| {err:.3e} "
                                     f"> {SSD_TOL} * max|ref| {scale:.3e}")
            errs[name], scales[name] = err, scale
        rec = {"shape": shape, "dtype": str(dtype).split(".")[-1],
               "max_abs_err": max(errs[k] for k in ("y_intra", "S", "decay")),
               "max_abs_ref_y": scales["y_intra"],
               "scan_max_abs_err": max(errs["y"], errs["final"])}
        if iters:
            flops, nbytes = _ssd_cost(*shape, xs.element_size())
            rec.update(_time_pair(
                lambda: ops.ssd_intra_chunk(*args),
                lambda: ops.ssd_intra_chunk_ref(*args), None,
                flops, nbytes, "fp32", iters))
            # bound_ms under the tensor-core arithmetic the kernel does;
            # the fp32 CUDA-core bound of the function stays beside it.
            rec["bound_fp32_ms"], rec["bound_fp32_by"] = (rec["bound_ms"],
                                                          rec["bound_by"])
            rec["bound_ms"], rec["bound_by"] = _ssd_tensor_bound(
                *shape, xs.element_size(), nbytes)
            rec["scan_ms"] = _cuda_ms(
                lambda: ops.ssd_chunk_scan(*args, initial_state=s0), iters)
            rec["scan_plain_ms"] = _cuda_ms(
                lambda: ops.ssd_chunk_scan_ref(*args, initial_state=s0),
                max(1, iters // 2))
        records[tag] = rec
        del xs, Bm, Cm, dt, da, s0, args, got, want
        torch.cuda.empty_cache()
    _line("phase2_ssd", records)
    return records


def _gating_cost(T, E, k, want_scores) -> tuple[float, float]:
    """(fp32 operations, bytes): the score pass and k compare rounds per
    logit; logits read once, ids (int64), weights, counts and the scores
    (when asked) written once."""
    flops = T * E * (5.0 + k)
    nbytes = T * E * 4 + T * k * 12 + E * 8 + (T * E * 4 if want_scores else 0)
    return flops, nbytes


def _graph_cold_ms(call, x, iters: int) -> tuple[float, str]:
    """Device time per ``call(x)`` with ``x`` not in the 50 MB L2: the call
    captured on copies of ``x`` that together exceed 64 MiB, one after the
    other, where that takes at most 512 copies; else (inputs below 128 KiB)
    each call after a read of a 64 MiB buffer, less the reads' own time.
    Returns the time and how the input was kept out of L2."""
    import torch

    nbytes = x.numel() * x.element_size()
    copies = -(-(64 << 20) // nbytes)
    if copies <= 512:
        xs = x.expand(copies, *x.shape).clone()
        turn = [0]

        def rotated():
            turn[0] += 1
            return call(xs[turn[0] % copies])

        ms = _graph_ms(rotated, max(iters, copies))
        del xs
        return ms, f"rotated over {copies} copies"
    flush = torch.ones(((64 << 20) // 4,), device="cuda")

    def flushed():
        flush.sum()
        return call(x)

    ms = _graph_ms(flushed, iters) - _graph_ms(flush.sum, iters)
    del flush
    return ms, "after a 64 MiB read, its time subtracted"


def phase_gating() -> dict:
    """``gating_topk`` vs its plain version; returns the records by case.
    Timed cases: ``ms`` back to back (the wrapper's host work included),
    ``graph_ms`` device time with the logits warm in L2 (as the router
    matmul leaves them), ``graph_cold_ms`` with them in device memory, and
    the PyTorch composite (softmax + topk + gather + histogram) both ways."""
    import torch

    from repro_torch.kernels.gating_topk import ops

    cases = [("prefill", 4096, 128, 8, "softmax", 50),
             ("decode", 4, 128, 8, "softmax", 50),
             ("jamba_prefill", 4096, 16, 2, "softmax", 50),
             ("dbrx_prefill", 1024, 16, 4, "softmax", 50),
             ("dbrx_decode", 4, 16, 4, "softmax", 50),
             ("sigmoid_e256", 4096, 256, 8, "sigmoid", 20),
             ("sigmoid_e256_decode", 4, 256, 8, "sigmoid", 50),
             ("ragged", 1000, 60, 6, "softmax", 0),
             ("sigmoid_e256_bias", 4096, 256, 8, "sigmoid", 20),
             ("ties", 4096, 128, 8, "softmax", 0),
             ("ties_sigmoid", 4096, 128, 8, "sigmoid", 0)]
    records = {}
    for tag, T, E, k, score_fn, iters in cases:
        g = torch.Generator(device="cuda").manual_seed(len(tag))
        x = torch.randn((T, E), generator=g, device="cuda")
        if tag.startswith("ties"):
            x[::7] = 0.0                        # every expert ties
            x[:, 9] = x[:, 2]                   # duplicated router columns
            x[:, 5] = x[:, 11]
        # A selection bias of the size aux-free balancing learns.
        bias = (torch.randn((E,), generator=g, device="cuda") * 1e-2
                if tag.endswith("bias") else None)
        kw = dict(score_fn=score_fn, bias=bias, want_scores=True)
        ids, w, cnt, sc = ops.gating_topk(x, k, **kw)
        torch.cuda.synchronize()
        r_ids, r_w, _, r_sc = ops.gating_topk_ref(x, k, **kw)
        keys = r_sc if bias is None else r_sc + bias[None, :]
        top = torch.sort(keys, dim=-1, descending=True).values
        decided = (top[:, k - 1] - top[:, k]) > 1e-6 * top[:, k - 1].abs()
        if tag.startswith("ties"):
            decided[:] = True
        if not torch.equal(ids[decided], r_ids[decided]):
            raise AssertionError(f"gating_topk {tag}: ids differ from the "
                                 f"plain version on decided rows")
        if not torch.equal(cnt, torch.bincount(ids.reshape(-1), minlength=E)):
            raise AssertionError(f"gating_topk {tag}: counts are not the "
                                 f"histogram of the kernel's ids")
        rec = {"shape": [T, E, k], "score_fn": score_fn,
               "bias": bias is not None,
               "rows_excluded_near_tie": int((~decided).sum())}
        for name, out, ref in (("weights", w, r_w), ("scores", sc, r_sc)):
            err, scale = _max_err(out, ref)
            if not err <= GATING_TOL * scale:
                raise AssertionError(f"gating_topk {tag} {name}: max|err| "
                                     f"{err:.3e} > {GATING_TOL} * max|ref| "
                                     f"{scale:.3e}")
            rec[f"{name}_max_abs_err"] = err
        rec["max_abs_err"] = max(rec["weights_max_abs_err"],
                                 rec["scores_max_abs_err"])
        if iters:
            def torch_ops():
                s = torch.softmax(x, -1) if score_fn == "softmax" \
                    else torch.sigmoid(x)
                _, i = torch.topk(s if bias is None else s + bias, k)
                return (s.gather(1, i),
                        torch.bincount(i.reshape(-1), minlength=E))

            ones = torch.ones((T * k,), dtype=torch.int64, device="cuda")

            def torch_ops_graph():
                # bincount reads its input's max back to the host, so a
                # graph takes the histogram as a scatter-add instead.
                s = torch.softmax(x, -1) if score_fn == "softmax" \
                    else torch.sigmoid(x)
                _, i = torch.topk(s if bias is None else s + bias, k)
                return (s.gather(1, i),
                        torch.zeros((E,), dtype=torch.int64, device="cuda"
                                    ).scatter_add_(0, i.reshape(-1), ones))

            rec.update(_time_pair(
                lambda: ops.gating_topk(x, k, **kw),
                lambda: ops.gating_topk_ref(x, k, **kw),
                None, *_gating_cost(T, E, k, True), "fp32", iters))
            rec["torch_ops_ms"] = _cuda_ms(torch_ops, iters)
            rec["graph_ms"] = _graph_ms(lambda: ops.gating_topk(x, k, **kw),
                                        iters)
            rec["graph_cold_ms"], rec["cold"] = _graph_cold_ms(
                lambda xi: ops.gating_topk(xi, k, **kw), x, iters)
            rec["torch_ops_graph_ms"] = _graph_ms(torch_ops_graph, iters)
            rec["bound_share_warm"] = rec["bound_ms"] / rec["graph_ms"]
            rec["bound_share_cold"] = rec["bound_ms"] / rec["graph_cold_ms"]
        records[tag] = rec
    # The graph timings' stream keeps a scratch of its own: drop them all,
    # so the serve phases' peak memory counts the serve path alone.
    ops.release_scratch()
    _line("phase2_gating_topk", records)
    return records


def _plan_lam(R, E, k, law, seed):
    """(R, E) int64 load: each rank's PLAN_TOKENS x k items drawn from one
    expert popularity law (uniform; Zipf s = 1.0 over a shuffled order;
    four hot experts taking half the load)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if law == "uniform":
        p = np.ones(E)
    elif law == "zipf":
        p = 1.0 / np.arange(1, E + 1)
        p = p[rng.permutation(E)]
    else:
        p = np.full(E, 0.5 / (E - 4))
        p[rng.choice(E, 4, replace=False)] = 0.5 / 4
    return np.stack([rng.multinomial(PLAN_TOKENS * k, p / p.sum())
                     for _ in range(R)]).astype(np.int64)


def _plan_mismatch(plan, plain) -> str | None:
    """The first field of two Plans that differs (set on one and not the
    other, or unequal integers; ``plan`` may live on the card), or None."""
    import torch

    for field in plan._fields:
        a, b = getattr(plan, field), getattr(plain, field)
        if (a is None) != (b is None) or (
                a is not None and not torch.equal(a.cpu(), b)):
            return field
    return None


def _sync_free(fn) -> None:
    """Run ``fn`` with every host sync an error."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def phase_plan_solve() -> dict:
    """``plan_solve`` vs its plain version: the whole Plan integer-equal,
    (probes, steps) equal, no host sync; graph device time (warm) of the
    kernel and of the whole ``solve_plan``, the plain loop's eager time on
    the card, and the bound: serial oracle steps x one redux.sync round
    (measured here).  Returns the records by case."""
    import torch

    from repro_torch.core import planner
    from repro_torch.kernels.plan_solve import ops

    redux_ms = min(ops.redux_round_ms() for _ in range(3))
    records = {}
    for R, E, k in PLAN_CASES:
        for li, law in enumerate(PLAN_LAWS):
            name = f"e{E}_k{k}_r{R}_{law}"
            lam = torch.from_numpy(_plan_lam(R, E, k, law, seed=R * 10 + li))
            home = torch.arange(E) // (E // R)
            bound = R * PLAN_TOKENS * k
            plain = planner.solve_plan(lam, home, n_slot=2)
            lam_d, home_d = lam.cuda(), home.cuda()
            plan = planner.solve_plan(lam_d, home_d, n_slot=2,
                                      load_bound=bound)
            torch.cuda.synchronize()
            field = _plan_mismatch(plan, plain)
            if field is not None:
                raise AssertionError(f"plan_solve {name}: {field} "
                                     f"differs from the plain solve")
            lam_e = lam.sum(dim=0)
            ell = planner._rank_load(lam_e, home, R)
            rexp = planner._expert_order(lam_e, home, R)
            args = [t.cuda() for t in (lam_e, ell, home, rexp)]
            kw = dict(n_slot=2, u_min=1, max_replicas_per_expert=R)
            stats_ref = torch.zeros(2, dtype=torch.int32)
            ops.plan_solve_ref(lam_e, ell, home, rexp, stats=stats_ref, **kw)
            stats = torch.zeros(2, dtype=torch.int32, device="cuda")
            ops.plan_solve(*args, load_bound=bound, stats=stats, **kw)
            if not torch.equal(stats.cpu(), stats_ref):
                raise AssertionError(f"plan_solve {name}: (probes, steps) "
                                     f"{stats.tolist()} != "
                                     f"{stats_ref.tolist()}")
            _sync_free(lambda: planner.solve_plan(lam_d, home_d, n_slot=2,
                                                  load_bound=bound))
            ms = _graph_ms(lambda: ops.plan_solve(*args, load_bound=bound,
                                                  **kw), 5)
            plan_ms = _graph_ms(lambda: planner.solve_plan(
                lam_d, home_d, n_slot=2, load_bound=bound), 3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ops.plan_solve_ref(*args, **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            probes, steps = stats_ref.tolist()
            total = int(lam.sum())
            mean = -(-total // R)
            records[name] = {
                "shape": [R, E, k], "law": law, "probes": probes,
                "steps": steps, "ms": ms, "plan_graph_ms": plan_ms,
                "plain_ms": plain_ms, "bound_ms": steps * redux_ms,
                "bound_by": "operations", "library_ms": None,
                "max_abs_err": 0, "pre_over_mean": int(plain.pre_max) / mean,
                "post_over_mean": int(plain.post_max) / mean,
                "tau": int(plain.tau), "replicas": int((plain.x >= 0).sum()),
                "sync_free": True}
    _line("phase2_plan_solve", {"redux_round_ms": redux_ms, **records})
    return records


def _rack_gate_cost(T, E, k, G, M, gk, want_scores) -> tuple[float, float]:
    """(fp32 operations, bytes) of the rack mode: the free kernel's, plus
    per key the bias add, plus the rack stage of the kernel's path.  Lanes
    path (a rack of L lanes): each rack lane's log2 L merges of a list of
    P (the power of two >= gk, or the lane's experts) values (P maxes and
    the cleanup's P / 2 log2 P compare-exchanges of 2 operations), its gk
    adds and its count over the G rack words (2 compares each).  Shared
    path: each key's rank (E / G compares of 2), each rack's gk adds and
    its rank (2 G)."""
    from repro_torch.kernels.gating_topk import ops

    flops, nbytes = _gating_cost(T, E, k, want_scores)
    path, L = ops.rack_mode(E, k, G, M, gk)
    egk = min(gk, E // G)
    if path == 1:
        P = 2 if egk <= 2 else (4 if E <= 128 else 8)
        merge = P + P * (P.bit_length() - 1)
        row = G * L * ((L.bit_length() - 1) * merge + egk + 2 * G)
    else:
        row = E * (E // G) * 2 + G * (egk + 2 * G)
    return flops + T * (E + row), nbytes


def phase_gating_racks() -> dict:
    """Row 5r: ``gating_topk``'s rack mode at DeepSeek-V3's prefill shape
    (T 4096, E 256, k 8, sigmoid, a selection bias) with its node-limited
    routing (G 8, M 4, group top-2), with G 2, M 1, at decode (T 4), and at
    the other geometries of RACK_GATE_CASES (each with the bias too).
    Checks: the ids equal the plain rack selection on the kernel's own
    scores plus the bias on every row (so its rack scores, kept racks and
    rounds are the plain version's), and the fully plain version's on
    every row whose rack choice and k-th key are decided by a gap over
    1e-6 relative; counts the histogram of the ids; scores and weights
    within GATING_TOL of max|ref|; at most M racks a token, and no error
    from the port's ``verify_rack_limit`` (with the free kernel's ids).  Times: eager
    (``ms``, host work included), graph device time warm and cold, the free
    kernel at the same shape (graph, warm), the plain version eager and the
    PyTorch composite (group top-2 -> top-M -> mask -> topk -> gather ->
    scatter-add) in a graph."""
    import torch

    from repro_torch.analysis.plan_check import verify_rack_limit
    from repro_torch.kernels.gating_topk import ops

    records = {}
    for tag, T, E, k, score_fn, G, M, gk, iters in RACK_GATE_CASES:
        g = torch.Generator(device="cuda").manual_seed(len(tag) + G)
        x = torch.randn((T, E), generator=g, device="cuda")
        bias = torch.randn((E,), generator=g, device="cuda") * 1e-2
        kw = dict(score_fn=score_fn, bias=bias, want_scores=True,
                  num_racks=G, rack_limit=M, group_topk=gk)
        before = ops.gating_topk.launches_by_kernel["rack"]
        ids, w, cnt, sc = ops.gating_topk(x, k, **kw)
        torch.cuda.synchronize()
        if ops.gating_topk.launches_by_kernel["rack"] != before + 1:
            raise AssertionError(f"gating_topk rack {tag}: not launched in "
                                 f"rack mode")
        keys = sc + bias[None, :]
        if not torch.equal(ids, ops.rack_limited_ids(keys, k, G, M, gk)):
            raise AssertionError(f"gating_topk rack {tag}: ids differ from "
                                 f"the plain rack selection on the kernel's "
                                 f"keys")
        r_ids, r_w, _, r_sc = ops.gating_topk_ref(x, k, **kw)
        r_keys = r_sc + bias[None, :]
        grp = torch.sort(r_keys.reshape(T, G, E // G), dim=-1,
                         descending=True).values[..., :gk].sum(-1)
        top_g = torch.sort(grp, dim=-1, descending=True).values
        decided = (top_g[:, M - 1] - top_g[:, M]) > 1e-6 * top_g[:, M - 1].abs()
        live = torch.zeros((T, G), dtype=torch.bool, device="cuda")
        live.scatter_(1, torch.sort(grp, dim=-1, descending=True,
                                    stable=True).indices[:, :M], True)
        masked = torch.where(live.repeat_interleave(E // G, dim=1), r_keys,
                             torch.full_like(r_keys, float("-inf")))
        top = torch.sort(masked, dim=-1, descending=True).values
        decided &= (top[:, k - 1] - top[:, k]) > 1e-6 * top[:, k - 1].abs()
        if not torch.equal(ids[decided], r_ids[decided]):
            raise AssertionError(f"gating_topk rack {tag}: ids differ from "
                                 f"the plain version on decided rows")
        if not torch.equal(cnt, torch.bincount(ids.reshape(-1), minlength=E)):
            raise AssertionError(f"gating_topk rack {tag}: counts are not "
                                 f"the histogram of the kernel's ids")
        racks_a_token = max(torch.unique(r).numel()
                            for r in (ids // (E // G)).cpu())
        if racks_a_token > M:
            raise AssertionError(f"gating_topk rack {tag}: a token reaches "
                                 f"{racks_a_token} > {M} racks")
        free_ids = ops.gating_topk(x, k, score_fn=score_fn, bias=bias)[0]
        vio = verify_rack_limit(ids, rack_limit=M, num_racks=G,
                                num_experts=E, free_expert_ids=free_ids)
        if vio:
            raise AssertionError(f"gating_topk rack {tag}: "
                                 f"{[str(v) for v in vio]}")
        rec = {"shape": [T, E, k], "score_fn": score_fn, "bias": True,
               "num_racks": G, "rack_limit": M, "group_topk": gk,
               "path": ["lanes", "shared"][ops.rack_mode(E, k, G, M, gk)[0]
                                           - 1],
               "rows_excluded_near_tie": int((~decided).sum()),
               "racks_a_token_max": racks_a_token,
               "rack_limit_violations": 0}
        for name, out, ref in (("weights", w, r_w), ("scores", sc, r_sc)):
            err, scale = _max_err(out, ref)
            if not err <= GATING_TOL * scale:
                raise AssertionError(f"gating_topk rack {tag} {name}: max|err|"
                                     f" {err:.3e} > {GATING_TOL} * max|ref| "
                                     f"{scale:.3e}")
            rec[f"{name}_max_abs_err"] = err
        rec["max_abs_err"] = max(rec["weights_max_abs_err"],
                                 rec["scores_max_abs_err"])
        epg = E // G
        ones = torch.ones((T * k,), dtype=torch.int64, device="cuda")

        def torch_ops_graph():
            s = torch.sigmoid(x) if score_fn == "sigmoid" \
                else torch.softmax(x, -1)
            key = s + bias
            grp_s = torch.topk(key.reshape(T, G, epg),
                               min(gk, epg)).values.sum(-1)
            keep = torch.zeros((T, G), dtype=torch.bool, device="cuda")
            keep.scatter_(1, torch.topk(grp_s, M).indices, True)
            masked_k = key.masked_fill(
                ~keep.repeat_interleave(epg, dim=1), float("-inf"))
            i = torch.topk(masked_k, k).indices
            return (s.gather(1, i),
                    torch.zeros((E,), dtype=torch.int64, device="cuda"
                                ).scatter_add_(0, i.reshape(-1), ones))

        rec.update(_time_pair(lambda: ops.gating_topk(x, k, **kw),
                              lambda: ops.gating_topk_ref(x, k, **kw), None,
                              *_rack_gate_cost(T, E, k, G, M, gk, True),
                              "fp32", iters))
        rec["graph_ms"] = _graph_ms(lambda: ops.gating_topk(x, k, **kw),
                                    iters)
        rec["graph_cold_ms"], rec["cold"] = _graph_cold_ms(
            lambda xi: ops.gating_topk(xi, k, **kw), x, iters)
        rec["free_graph_ms"] = _graph_ms(lambda: ops.gating_topk(
            x, k, score_fn=score_fn, bias=bias, want_scores=True), iters)
        rec["torch_ops_graph_ms"] = _graph_ms(torch_ops_graph, iters)
        rec["bound_share_warm"] = rec["bound_ms"] / rec["graph_ms"]
        records[tag] = rec
    ops.release_scratch()
    _line("phase2_gating_topk_rack", records)
    return records


def _racked_lam(R, E, k, law, L, seed):
    """PLAN_TOKENS x k items a rank from one popularity law, with each rack
    keeping its tokens off its own third of the experts, so the racks'
    demand incidence differs (the rack-limited gate's pattern)."""
    import numpy as np

    lam = _plan_lam(R, E, k, law, seed)
    rng = np.random.default_rng(seed + 1)
    for g in range(R // L):
        lam[g * L:(g + 1) * L, rng.choice(E, E // 3, replace=False)] = 0
    return lam


def phase_plan_solve_racks() -> dict:
    """Row Pr: ``plan_solve``'s rack mode (rack size L; with and without
    the demand tie-break, whose (G, E) incidence the kernel computes from
    lam) at RACK_PLAN_CASES over the three laws: the whole Plan, tier fields
    included, integer-equal to the plain solve's; (probes, steps) equal; no
    host sync.  Timed (graph, warm; the zipf law) beside the flat solve of
    the same load; the plain loop's eager time on the card; the bound, as
    row P's, serial oracle steps x one redux.sync round."""
    import torch

    from repro_torch.core import planner
    from repro_torch.kernels.plan_solve import ops

    redux_ms = min(ops.redux_round_ms() for _ in range(3))
    records = {}
    for R, E, k, L in RACK_PLAN_CASES:
        for li, law in enumerate(PLAN_LAWS):
            lam = torch.from_numpy(_racked_lam(R, E, k, law, L,
                                               seed=R * 10 + li))
            home = torch.arange(E) // (E // R)
            bound = R * PLAN_TOKENS * k
            lam_d, home_d = lam.cuda(), home.cuda()
            lam_e = lam.sum(dim=0)
            ell = planner._rank_load(lam_e, home, R)
            rexp = planner._expert_order(lam_e, home, R)
            args = [t.cuda() for t in (lam_e, ell, home, rexp)]
            for demand in (False, True):
                name = f"e{E}_k{k}_r{R}_l{L}_{law}" + ("_demand" if demand
                                                        else "")
                pkw = dict(n_slot=2, rack_size=L, demand_tiebreak=demand)
                plain = planner.solve_plan(lam, home, **pkw)
                plan = planner.solve_plan(lam_d, home_d, load_bound=bound,
                                          **pkw)
                torch.cuda.synchronize()
                field = _plan_mismatch(plan, plain)
                if field is not None:
                    raise AssertionError(f"plan_solve rack {name}: {field} "
                                         f"differs from the plain solve")
                kw = dict(n_slot=2, u_min=1, max_replicas_per_expert=R,
                          rack_size=L)
                stats_ref = torch.zeros(2, dtype=torch.int32)
                ops.plan_solve_ref(lam_e, ell, home, rexp, stats=stats_ref,
                                   lam=lam if demand else None, **kw)
                stats = torch.zeros(2, dtype=torch.int32, device="cuda")
                ops.plan_solve(*args, load_bound=bound, stats=stats,
                               lam=lam_d if demand else None, **kw)
                if not torch.equal(stats.cpu(), stats_ref):
                    raise AssertionError(f"plan_solve rack {name}: (probes, "
                                         f"steps) {stats.tolist()} != "
                                         f"{stats_ref.tolist()}")
                _sync_free(lambda: planner.solve_plan(
                    lam_d, home_d, load_bound=bound, **pkw))
                probes, steps = stats_ref.tolist()
                rec = {"shape": [R, E, k], "rack_size": L, "law": law,
                       "demand": demand, "probes": probes, "steps": steps,
                       "tier_tokens": plain.tier_tokens.tolist(),
                       "tier_replicas": plain.tier_replicas.tolist(),
                       "post_max": int(plain.post_max), "tau": int(plain.tau),
                       "bound_ms": steps * redux_ms,
                       "bound_by": "operations", "library_ms": None,
                       "max_abs_err": 0, "sync_free": True}
                if law == "zipf":
                    dl = lam_d if demand else None
                    rec["ms"] = _graph_ms(lambda: ops.plan_solve(
                        *args, load_bound=bound, lam=dl, **kw), 5)
                    rec["flat_ms"] = _graph_ms(lambda: ops.plan_solve(
                        *args, load_bound=bound, n_slot=2, u_min=1,
                        max_replicas_per_expert=R), 5)
                    rec["plan_graph_ms"] = _graph_ms(
                        lambda: planner.solve_plan(lam_d, home_d,
                                                   load_bound=bound, **pkw), 3)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    ops.plan_solve_ref(*args, lam=dl, **kw)
                    torch.cuda.synchronize()
                    rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
                records[name] = rec
    _line("phase2_plan_solve_rack", {"redux_round_ms": redux_ms, **records})
    return records


def _eplb_load(E, R, law, seed):
    """(E,) float32 loads of one EPLB_SWEEP law."""
    import torch

    if law == "equal":
        return torch.full((E,), 1000.0)
    if law == "zero":
        return torch.zeros(E)
    lam = torch.from_numpy(_plan_lam(R, E, 8, "zipf", seed=seed)).sum(
        dim=0).to(torch.float32)
    if law == "half_zero":
        lam[::2] = 0.0
    return lam


def phase_eplb_place() -> dict:
    """Row Pe: EPLB's greedy placement (``eplb_place``) vs its plain
    version (on the host): hosted bitwise equal and (steps, placements)
    equal, at EPLB_CASES (Zipf 1.0 loads, n_slot 2, max_rep R; no host sync
    under ``set_sync_debug_mode("error")``, the plain loop's eager time on
    the card) and over EPLB_SWEEP.  Each case: graph device time and the
    bound, steps x the longer of one step's two dependent chains
    (``ops.step_chain_ms`` at the case's shape, timed here: the argmin and
    the re-sum of the chosen rank's list in the kernel's form, the vote
    and the argmax)."""
    import torch

    from repro_torch.kernels.eplb_place import ops

    units = {}

    def unit(E, R, n_slot):
        """The larger of a step's two chains at this shape, each the best
        of three timings."""
        key = f"e{E}_r{R}_s{n_slot}"
        if key not in units:
            runs = [ops.step_chain_ms(E, R, n_slot) for _ in range(3)]
            units[key] = {"argmin_resum_ms": min(r[0] for r in runs),
                          "vote_argmax_ms": min(r[1] for r in runs)}
        return max(units[key].values())

    def case(lam_e, E, R, n_slot, max_rep):
        home = torch.arange(E) // (E // R)
        kw = dict(n_slot=n_slot, max_rep=max_rep)
        stats_ref = torch.zeros(2, dtype=torch.int32)
        want = ops.eplb_place_ref(lam_e, home, R, stats=stats_ref, **kw)
        d_lam, d_home = lam_e.cuda(), home.cuda()
        stats = torch.zeros(2, dtype=torch.int32, device="cuda")
        got = ops.eplb_place(d_lam, d_home, R, stats=stats, **kw)
        torch.cuda.synchronize()
        name = f"e{E}_r{R}_s{n_slot}_m{max_rep}"
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"eplb_place {name}: hosted differs from "
                                 f"the plain version")
        if not torch.equal(stats.cpu(), stats_ref):
            raise AssertionError(f"eplb_place {name}: (steps, placements) "
                                 f"{stats.tolist()} != {stats_ref.tolist()}")
        steps, placed = stats_ref.tolist()
        ms = _graph_ms(lambda: ops.eplb_place(d_lam, d_home, R, **kw), 5)
        rec = {"shape": [R, E], "n_slot": n_slot, "max_rep": max_rep,
               "steps": steps, "placements": placed, "ms": ms,
               "bound_ms": steps * unit(E, R, n_slot),
               "bound_by": "operations", "library_ms": None,
               "max_abs_err": 0, "replicas": int(want.sum()) - E}
        return rec, d_lam, d_home, kw

    records = {}
    for R, E, k in EPLB_CASES:
        lam_e = torch.from_numpy(_plan_lam(R, E, k, "zipf", seed=E)).sum(
            dim=0).to(torch.float32)
        rec, d_lam, d_home, kw = case(lam_e, E, R, 2, R)
        _sync_free(lambda: ops.eplb_place(d_lam, d_home, R, **kw))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.eplb_place_ref(d_lam, d_home, R, **kw)
        torch.cuda.synchronize()
        records[f"e{E}_k{k}_r{R}_zipf"] = dict(
            rec, law="zipf", plain_ms=(time.perf_counter() - t0) * 1e3,
            sync_free=True)
    sweep = {}
    for E, R, n_slot, max_rep, law in EPLB_SWEEP:
        rec = case(_eplb_load(E, R, law, seed=E + R), E, R, n_slot,
                   max_rep)[0]
        sweep[f"e{E}_r{R}_s{n_slot}_m{max_rep}_{law}"] = dict(rec, law=law)
    _line("phase2_eplb_place", {"step_chain_ms": units, **records,
                                "sweep": sweep})
    return {**records, "sweep": sweep}


def _kary_record(lam, home, R, E, k, L, law, redux_ms, *, P=1,
                 health=None, time_plain=False) -> tuple:
    """One k-ary / health case of ``plan_solve`` (rows Pk, Ph): the whole
    Plan integer-equal to the plain solve's, (probes, steps, critical
    path) equal to the plain version's, no host sync; graph device time,
    the bound (critical-path oracle steps x one redux.sync round) and, with
    ``time_plain``, the plain loop's eager time on the card."""
    import torch

    from repro_torch.core import planner
    from repro_torch.kernels.plan_solve import ops

    bound = R * PLAN_TOKENS * k
    lam_d, home_d = lam.cuda(), home.cuda()
    hw_d = None if health is None else health.cuda()
    pkw = dict(n_slot=2, rack_size=L, probe_parallelism=P)
    plain = planner.solve_plan(lam, home, health_weight=health, **pkw)
    plan = planner.solve_plan(lam_d, home_d, load_bound=bound,
                              health_weight=hw_d, **pkw)
    torch.cuda.synchronize()
    tag = f"e{E} r{R} l{L} P{P} health {health is not None}"
    field = _plan_mismatch(plan, plain)
    if field is not None:
        raise AssertionError(f"plan_solve {tag}: {field} differs from the "
                             f"plain solve")
    lam_e = lam.sum(dim=0)
    ell = planner._rank_load(lam_e, home, R)
    rexp = planner._expert_order(lam_e, home, R)
    args = [t.cuda() for t in (lam_e, ell, home, rexp)]
    kw = dict(n_slot=2, u_min=1, max_replicas_per_expert=R, rack_size=L,
              probe_parallelism=P)
    stats_ref = torch.zeros(3, dtype=torch.int32)
    ops.plan_solve_ref(lam_e, ell, home, rexp, stats=stats_ref,
                       health_weight=health, **kw)
    stats = torch.zeros(3, dtype=torch.int32, device="cuda")
    ops.plan_solve(*args, load_bound=bound, stats=stats, health_weight=hw_d,
                   **kw)
    if not torch.equal(stats.cpu(), stats_ref):
        raise AssertionError(f"plan_solve {tag}: (probes, steps, critical) "
                             f"{stats.tolist()} != {stats_ref.tolist()}")
    _sync_free(lambda: planner.solve_plan(lam_d, home_d, load_bound=bound,
                                          health_weight=hw_d, **pkw))
    probes, steps, crit = stats_ref.tolist()
    rec = {"shape": [R, E, k], "rack_size": L, "law": law,
           "probe_parallelism": P, "health": health is not None,
           "probes": probes, "steps": steps, "critical_steps": crit,
           "ms": _graph_ms(lambda: ops.plan_solve(
               *args, load_bound=bound, health_weight=hw_d, **kw), 5),
           "bound_ms": crit * redux_ms, "bound_by": "operations",
           "library_ms": None, "max_abs_err": 0, "sync_free": True,
           "tau": int(plain.tau), "post_max": int(plain.post_max),
           "replicas": int((plain.x >= 0).sum()),
           "rank_loads_min": int(plain.u.sum(dim=0).min())}
    if time_plain:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ops.plan_solve_ref(*args, health_weight=hw_d, **kw)
        torch.cuda.synchronize()
        rec["plain_ms"] = (time.perf_counter() - t0) * 1e3
    return rec, plain


def phase_plan_solve_kary() -> dict:
    """Row Pk: ``plan_solve`` with probe_parallelism P in KARY_PS (P 1
    beside, in the same call) at KARY_CASES (E 128 and 256, R 64, flat and
    rack size 8), Zipf 1.0 loads; each case as :func:`_kary_record`, the
    plain loop timed on the card for E 128 flat."""
    import torch

    from repro_torch.kernels.plan_solve import ops

    redux_ms = min(ops.redux_round_ms() for _ in range(3))
    records = {}
    for R, E, k, L in KARY_CASES:
        lam = torch.from_numpy(_plan_lam(R, E, k, "zipf", seed=R * 10 + 1))
        home = torch.arange(E) // (E // R)
        for P in KARY_PS:
            name = f"e{E}_k{k}_r{R}_l{L or 0}_p{P}"
            records[name], _ = _kary_record(
                lam, home, R, E, k, L, "zipf", redux_ms, P=P,
                time_plain=(E == 128 and L is None))
    _line("phase2_plan_solve_kary", {"redux_round_ms": redux_ms, **records})
    return records


def phase_plan_solve_health() -> dict:
    """Row Ph: ``plan_solve``'s health mode with rank 1 at weight 0.5 and
    rank 2 at 0 (quarantined), E 128, R 64, flat and rack size 8, P 1 and
    4, Zipf 1.0 loads; each case as :func:`_kary_record`, and the
    quarantined rank's load 0 in the solved plan."""
    import torch

    from repro_torch.kernels.plan_solve import ops

    redux_ms = min(ops.redux_round_ms() for _ in range(3))
    records = {}
    for R, E, k, L in HEALTH_CASES:
        lam = torch.from_numpy(_plan_lam(R, E, k, "zipf", seed=R * 10 + 2))
        home = torch.arange(E) // (E // R)
        w = torch.ones(R, dtype=torch.float32)
        w[1], w[2] = 0.5, 0.0
        for P in (1, 4):
            name = f"e{E}_k{k}_r{R}_l{L or 0}_p{P}"
            rec, plain = _kary_record(lam, home, R, E, k, L, "zipf", redux_ms,
                                      P=P, health=w,
                                      time_plain=(P == 1 and L is None))
            load = plain.u.sum(dim=0)
            if int(load[2]) != 0:
                raise AssertionError(f"plan_solve health {name}: the "
                                     f"quarantined rank keeps {int(load[2])}")
            rec.update(rank1_load=int(load[1]), rank2_load=int(load[2]),
                       full_rank_load_max=int(load[3:].max()))
            records[name] = rec
    _line("phase2_plan_solve_health", {"redux_round_ms": redux_ms, **records})
    return records


def _zipf_batch(rng, R, E, k, p):
    """(R, E) load: each rank's PLAN_TOKENS x k items drawn from p."""
    import numpy as np

    return np.stack([rng.multinomial(PLAN_TOKENS * k, p)
                     for _ in range(R)]).astype(np.int64)


def phase_balancers() -> dict:
    """Phase 15, the balancer comparison: at BAL_CASES (E 256 and E 128, R
    64, top-8, Zipf BAL_ZIPF), each mode of BAL_MODES solves the same load
    on the card through ``balancer.solve``: ``metrics.report`` before and
    after the plan, the plan's marginals checked, and the solve's time:
    graph device time for the modes that read nothing back (checked under
    ``set_sync_debug_mode("error")``), the host wall with a device sync
    for ``lplb`` (host numpy by design).  ``eplb`` places from the EMA of
    BAL_HISTORY earlier batches under a popularity rolled by E / 2.  After
    the timing each plan goes through the port's static check
    (``analysis.plan_check.verify_plan``, flat topology, the EPLB modes'
    rack-local optimality a warning as in the reference): no error, the
    warnings counted by rule."""
    import collections

    import numpy as np
    import torch

    from repro_torch.analysis.plan_check import verify_plan
    from repro_torch.analysis.violation import errors
    from repro_torch.core import balancer, metrics
    from repro_torch.core.eplb import LoadEMA
    from repro_torch.core.topology import Topology

    records = {}
    for arch, E in BAL_CASES:
        R, k = BAL_R, BAL_K
        rng = np.random.default_rng(E)
        p = 1.0 / np.arange(1, E + 1) ** BAL_ZIPF
        p = p[rng.permutation(E)]
        p /= p.sum()
        ema = LoadEMA(E, decay=0.9)
        for _ in range(BAL_HISTORY):
            ema.update(_zipf_batch(rng, R, E, k, np.roll(p, E // 2)).sum(0))
        lam = torch.from_numpy(_zipf_batch(rng, R, E, k, p))
        home = torch.arange(E) // (E // R)
        lam_d, home_d = lam.cuda(), home.cuda()
        est_d = torch.from_numpy(ema.value).to("cuda", torch.float32)
        bound = R * PLAN_TOKENS * k
        rec = {"arch": arch, "shape": [R, E, k], "zipf": BAL_ZIPF,
               "modes": {}}
        for mode, P in BAL_MODES:
            cfg = balancer.BalancerConfig(mode=mode, n_slot=2,
                                          probe_parallelism=P)
            est = est_d if mode == "eplb" else None

            def solve():
                return balancer.solve(lam_d, home_d, cfg, lam_e_est=est,
                                      load_bound=bound)

            plan = solve()
            torch.cuda.synchronize()
            if not (torch.equal(plan.q.sum(dim=-1).cpu(), lam)
                    and torch.equal(plan.q.sum(dim=0), plan.u)):
                raise AssertionError(f"balancer {arch} {mode}: the plan's "
                                     f"marginals are not the load's")
            rep = metrics.report(lam, plan.u, home)
            if mode == "lplb":
                t0 = time.perf_counter()
                solve()
                torch.cuda.synchronize()
                ms, timing = (time.perf_counter() - t0) * 1e3, "host wall"
            else:
                _sync_free(solve)
                ms, timing = _graph_ms(solve, 3), "graph device time"
            tag = mode if mode != "ultraep" else f"ultraep_p{P}"
            vio = verify_plan(plan, Topology.flat(R), lam=lam, home=home,
                              rack_aware_mode=(None if mode in (
                                  "eplb", "eplb_plus") else True))
            if errors(vio):
                raise AssertionError(f"balancer {arch} {tag}: "
                                     f"{[str(v) for v in errors(vio)]}")
            rec["modes"][tag] = {
                "plan_check": {"errors": 0, "warns": dict(
                    collections.Counter(v.rule for v in vio))},
                "pre_imbalance": rep.pre_imbalance,
                "post_imbalance": rep.post_imbalance,
                "total_instances": rep.total_instances,
                "max_fanout": rep.max_fanout, "slots_used": rep.slots_used,
                "inflight_token_ratio": rep.inflight_token_ratio,
                "post_max": int(plan.post_max), "solve_ms": ms,
                "timing": timing}
        records[arch] = rec
    _line("phase15_balancers", records)
    return records


def _flash_pairs(Sq, causal, q_off, kv_len) -> tuple[int, int]:
    """(query-key pairs that are unmasked, keys that are needed) summed
    over the batch rows, from this case's offsets."""
    import numpy as np

    pairs = keys = 0
    for off, lim in zip(q_off, kv_len):
        pos = np.arange(Sq) + off
        row = np.minimum(lim, pos + 1) if causal else np.full(Sq, lim)
        row = np.maximum(row, 0)
        pairs += int(row.sum())
        keys += int(row.max())
    return pairs, keys


def _check_rows(name, out, ref, tol) -> tuple[float, float, float]:
    """Each output row (batch row, query position, head) within ``tol`` of
    its own max|ref|, so a short row's large values do not loosen the
    bound on a long row.  Returns max|err|, max|ref| and the largest
    row's err / max|ref|."""
    err = (out.float() - ref.float()).abs().amax(dim=-1)
    scale = ref.float().abs().amax(dim=-1)
    ratio = (err / scale.clamp(min=1e-30)).max().item()
    if not ratio <= tol:
        raise AssertionError(f"{name}: a row's max|err| is {ratio:.3e} of "
                             f"its max|ref|, above {tol}")
    return err.max().item(), scale.max().item(), ratio


_TIMING_STREAM = None     # one side stream for every graph capture


def _graph_ms(fn, iters: int) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph,
    replayed once to warm up, then timed over one replay, so the host's
    per-call work (Python, ctypes, allocation) does not hide a kernel of a
    few microseconds."""
    import torch

    global _TIMING_STREAM
    if _TIMING_STREAM is None:
        _TIMING_STREAM = torch.cuda.Stream()
    stream = _TIMING_STREAM
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                   # warm up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def _sdpa_free(q, k, v, causal, q_off, kv_len):
    """The mask-free library call where every row shares one offset and
    one valid length, and the chunk ends at it (q_offset + Sq =
    kv_valid_len, or not causal): k/v sliced to the valid length and,
    when causal, ``causal_lower_right``, under the flash or the memory-efficient
    backend, GQA native or (if refused) k/v expanded to H heads outside
    the timed call.  Returns (call, backend, gqa) or None where no such
    call computes the same function."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right

    B, Sq, H, _ = q.shape
    L = kv_len[0]
    if len(set(kv_len)) > 1 or len(set(q_off)) > 1 or L < 1 or \
            (causal and q_off[0] + Sq != L):
        return None
    qt = q.transpose(1, 2)
    kt = k[:, :L].transpose(1, 2)
    vt = v[:, :L].transpose(1, 2)
    mask = causal_lower_right(Sq, L) if causal else None
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        for gqa in (True, False):
            if gqa:
                kk, vv = kt, vt
            else:
                rep = H // kt.shape[1]
                kk = kt.repeat_interleave(rep, dim=1).contiguous()
                vv = vt.repeat_interleave(rep, dim=1).contiguous()

            def call(kk=kk, vv=vv, backend=backend, gqa=gqa):
                with sdpa_kernel([backend]):
                    return F.scaled_dot_product_attention(
                        qt, kk, vv, attn_mask=mask, enable_gqa=gqa)

            try:
                with warnings.catch_warnings():   # SDPA's reasons for no
                    warnings.simplefilter("ignore")   # kernel: expected here
                    call()
            except RuntimeError:
                continue
            torch.cuda.synchronize()
            return call, backend.name, gqa
    return None


def _sdpa_unequal(qt, kt, vt, mask):
    """Where q/k and v differ in head dim (MLA), the masked library call
    under the first backend that takes those dims (memory-efficient, then
    cuDNN; the flash backend takes one head dim, the math one would
    materialise every score): (call, backend) or None."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        def call(backend=backend):
            with sdpa_kernel([backend]):
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask)

        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                call()
        except RuntimeError:
            continue
        return call, backend.name
    return None


def phase_flash() -> dict:
    """``flash_attention`` vs its plain version; returns the records by
    case, each with the kernel that ran."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops

    bf16, fp32 = torch.bfloat16, torch.float32
    wg, split = "prefill_wgmma", "decode_split"
    edges = [1, 1024, 2048, SERVE_SK]      # GLM decode: 1024 keys a split
    # tag, B, Sq, Sk, H, Hkv, hd, dtype, causal, q_offset per row,
    # kv_valid_len per row, the kernel the wrapper must pick, timing
    # iterations
    cases = [("glm_prefill_at_4096", 1, 4096, SERVE_SK, 32, 8, 128, bf16,
              True, [4096], [8192], wg, 20),
             ("glm_prefill_at_0", 1, 4096, SERVE_SK, 32, 8, 128, bf16, True,
              [0], [4096], wg, 20),
             ("glm_prefill_ragged", 1, 4096, SERVE_SK, 32, 8, 128, bf16,
              True, [4096], [4096 + 1808], wg, 0),
             ("qwen3_prefill_at_4096", 1, 4096, SERVE_SK, 64, 4, 128, bf16,
              True, [4096], [8192], wg, 10),
             ("decode", 4, 1, SERVE_SK, 32, 8, 128, bf16, False, [0] * 4,
              [2048, 6144, 3000, 1], split, 50),
             ("qwen3_decode", 4, 1, SERVE_SK, 64, 4, 128, bf16, False,
              [0] * 4, [2048, 6144, 3000, 1], split, 50),
             ("pallas_causal", 1, 2048, 2048, 32, 8, 128, bf16, True, [0],
              [2048], wg, 20),
             ("pallas_full", 1, 2048, 2048, 32, 8, 128, bf16, False, [0],
              [2048], wg, 0),
             ("fp32_prefill", 1, 1024, 4096, 32, 8, 128, fp32, True, [1024],
              [2048], "prefill_f32", 3),
             ("glm_prefill_at_4096_fp32", 1, 4096, SERVE_SK, 32, 8, 128,
              fp32, True, [4096], [8192], "prefill_f32", 3),
             ("fp32_decode", 4, 1, SERVE_SK, 32, 8, 128, fp32, False, [0] * 4,
              [2048, 6144, 3000, 1], split, 10),
             ("hd64", 2, 300, 1000, 16, 4, 64, bf16, True, [0, 500],
              [300, 777], split, 0),
             ("hd64_fp32", 2, 300, 1000, 16, 4, 64, fp32, True, [0, 500],
              [300, 777], "prefill_f32", 5),
             ("reduced_prefill", 2, 64, 272, 4, 2, 16, bf16, True, [0, 64],
              [50, 100], split, 0),
             ("reduced_prefill_fp32", 2, 64, 272, 4, 2, 16, fp32, True,
              [0, 64], [50, 100], split, 0),
             ("reduced_decode", 4, 1, 272, 4, 2, 16, bf16, False, [0] * 4,
              [1, 80, 200, 272], split, 0),
             ("reduced_decode_fp32", 4, 1, 272, 4, 2, 16, fp32, False,
              [0] * 4, [1, 80, 200, 272], split, 0),
             # Split edges: rows of length 1, of exactly one split, ending
             # on a split edge, and of the full capacity.
             ("decode_split_edges", 4, 1, SERVE_SK, 32, 8, 128, bf16, False,
              [0] * 4, edges, split, 0),
             ("decode_split_edges_fp32", 4, 1, SERVE_SK, 32, 8, 128, fp32,
              False, [0] * 4, edges, split, 0),
             ("qwen3_decode_split_edges", 4, 1, SERVE_SK, 64, 4, 128, bf16,
              False, [0] * 4, [1, 512, 1024, SERVE_SK], split, 0),
             # G 16 with Sq not a multiple of 8; a q tile straddling
             # kv_valid_len; hd 64 on the wgmma kernel; hd 16 on mma.sync.
             ("qwen3_prefill_ragged_sq", 1, 1001, 1301, 64, 4, 128, bf16,
              True, [300], [1301], wg, 0),
             ("prefill_straddle", 2, 1000, 3000, 32, 8, 128, bf16, True,
              [0, 1500], [777, 2100], wg, 0),
             ("hd64_wgmma", 2, 1024, 2048, 16, 4, 64, bf16, True, [0, 512],
              [1024, 1536], wg, 0),
             ("hd16_mma", 8, 512, 1024, 8, 2, 16, bf16, True,
              [0, 1, 2, 3, 4, 5, 6, 500],
              [512, 600, 700, 800, 900, 1000, 1024, 1012],
              "prefill_mma_hd16", 0),
             ("hd16_fp32", 8, 512, 1024, 8, 2, 16, fp32, True,
              [0, 1, 2, 3, 4, 5, 6, 500],
              [512, 600, 700, 800, 900, 1000, 1024, 1012], "prefill_f32",
              5),
             # DeepSeek-V3's MLA prefill: q/k 192, v 128, 128 heads with
             # Hkv = H; its serve chunk at offset 4096, and chunks of 64
             # and 128 queries at B 1 (128 blocks: the wgmma kernel too).
             ("mla_prefill_at_4096", 1, 4096, SERVE_SK, 128, 128, (192, 128),
              bf16, True, [4096], [8192], wg, 10),
             ("mla_prefill_64", 1, 64, SERVE_SK, 128, 128, (192, 128), bf16,
              True, [4096], [4160], wg, 20),
             ("mla_prefill_128", 1, 128, SERVE_SK, 128, 128, (192, 128), bf16,
              True, [4096], [4224], wg, 20),
             # In fp32 (the serve entry point's default dtype): the prefill
             # chunk of ``python -m repro_torch.launch.serve --arch
             # deepseek-v3-671b`` (64 queries over its 272-key cache) and
             # the 4096-token serve chunk, on the fp32 prefill kernel.
             ("mla_prefill_64_fp32", 1, 64, 272, 128, 128, (192, 128), fp32,
              True, [64], [128], "prefill_f32", 20),
             ("mla_prefill_at_4096_fp32", 1, 4096, SERVE_SK, 128, 128,
              (192, 128), fp32, True, [4096], [8192], "prefill_f32", 3),
             # HuBERT-XLarge's attention: 16 heads of 80, bidirectional, its
             # train step's 2 x 4096 frames (the wgmma kernel on two
             # 64-column boxes a row, zero-filled past column 80), causal
             # too, and in fp32.
             ("hubert_train", 2, 4096, 4096, 16, 16, 80, bf16, False,
              [0, 0], [4096, 4096], wg, 20),
             ("hubert_train_causal", 2, 4096, 4096, 16, 16, 80, bf16, True,
              [0, 0], [4096, 4096], wg, 0),
             ("hubert_train_fp32", 2, 4096, 4096, 16, 16, 80, fp32, False,
              [0, 0], [4096, 4096], "prefill_f32", 3),
             ("hubert_train_fp32_causal", 2, 4096, 4096, 16, 16, 80, fp32,
              True, [0, 0], [4096, 4096], "prefill_f32", 0),
             ("hubert_short", 2, 7, 7, 16, 16, 80, bf16, False, [0, 0],
              [7, 7], wg, 0)]
    # Phase 18's serve hosts at their own head ratios and shapes: a
    # 1024-query prefill chunk at offset 0 and at 1024 (a 1535-token
    # prompt, the chunk's rows past it padding) over the hosts' cache, and
    # a decode step of three rows.  G 6: DBRX-132B, InternVL2-26B (48 / 8);
    # G 8: Qwen2-72B (64 / 8); G 12: Mistral-Large-123B (96 / 8); G 2:
    # Qwen3-0.6B, InternLM2-1.8B (16 / 8).
    host_sk = max(HOST_SERVE["prompt_len"][1] + HOST_SERVE["max_new"]
                  + HOST_SERVE["chunk"], 2 * HOST_SERVE["chunk"])
    chunk = HOST_SERVE["chunk"]
    for host, H in (("g6", 48), ("g8", 64), ("g12", 96), ("g2", 16)):
        cases += [(f"host_{host}_prefill_at_0", 1, chunk, host_sk, H, 8, 128,
                   bf16, True, [0], [chunk], wg, 0),
                  (f"host_{host}_prefill_at_{chunk}", 1, chunk, host_sk, H, 8,
                   128, bf16, True, [chunk], [HOST_SERVE["prompt_len"][1] - 1],
                   wg, 0),
                  (f"host_{host}_decode", 3, 1, host_sk, H, 8, 128, bf16,
                   False, [0] * 3, [257, 1290, 1539], split, 0)]
    records = {}
    for (tag, B, Sq, Sk, H, Hkv, hd, dtype, causal, q_off, kv_len, want,
         iters) in cases:
        hd, hd_v = hd if isinstance(hd, tuple) else (hd, hd)
        kind = "bf16" if dtype == bf16 else "fp32"
        g = torch.Generator(device="cuda").manual_seed(len(tag))
        # Where v is narrower than q/k (MLA), it is what MLA prefill passes:
        # the last hd_v columns of the expanded latent, a strided view.
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((B, Sq, H, hd), (B, Sk, Hkv, hd),
                                 (B, Sk, Hkv, hd if hd_v == hd else 2 * hd_v)))
        v = v[..., -hd_v:]
        off = torch.tensor(q_off, device="cuda")
        lim = torch.tensor(kv_len, device="cuda")
        kw = dict(causal=causal, q_offset=off, kv_valid_len=lim)
        rec = {"shape": [B, Sq, Sk, H, Hkv, hd] + ([hd_v] if hd_v != hd
                                                   else []),
               "dtype": kind, "causal": causal, "q_offset": q_off,
               "kv_valid_len": kv_len}
        before = dict(ops.flash_attention.launches_by_kernel)
        out = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ran = [n for n, c in ops.flash_attention.launches_by_kernel.items()
               if c != before[n]]
        if ran != [want]:
            raise AssertionError(f"flash_attention {tag} ran {ran}, not "
                                 f"[{want}]")
        rec["kernel"] = want
        plan = ops.plan_launch(B, Sq, Sk, H, Hkv, hd, dtype,
                               ops._sm_count(q.device))
        if want == split:
            rec["splits"], rec["keys_per_split"] = (plan.splits,
                                                    plan.keys_per_split)
        ref = ops.flash_attention_ref(q, k, v, **kw)
        (rec["max_abs_err"], rec["max_abs_ref"],
         rec["max_row_rel_err"]) = _check_rows(f"flash_attention {tag}", out,
                                               ref, FLASH_TOL[kind])
        # The library yardsticks must compute the same function.
        kpos = torch.arange(Sk, device="cuda")
        qpos = torch.arange(Sq, device="cuda")[None, :] + off[:, None]
        mask = kpos[None, None, :] < lim[:, None, None]
        if causal:
            mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
        mask = mask[:, None]                                 # (B, 1, Sq, Sk)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        if hd_v != hd:
            masked = _sdpa_unequal(qt, kt, vt, mask)
            sdpa, rec["sdpa_masked_backend"] = masked or (None, None)
        # Their own rounding may differ from the kernel's; a wrong mask
        # would differ by O(max|ref|).
        if sdpa is not None:
            rec["library_max_abs_err"], _ = _max_err(
                sdpa().transpose(1, 2), ref)
            if not rec["library_max_abs_err"] <= 5e-2 * rec["max_abs_ref"]:
                raise AssertionError(f"sdpa yardstick {tag} differs: "
                                     f"{rec['library_max_abs_err']}")
        free = _sdpa_free(q, k, v, causal, q_off, kv_len)
        if free is not None:
            free_call, rec["sdpa_free_backend"], rec["sdpa_free_gqa"] = free
            rec["sdpa_free_max_abs_err"], _ = _max_err(
                free_call().transpose(1, 2), ref)
            if not rec["sdpa_free_max_abs_err"] <= 5e-2 * rec["max_abs_ref"]:
                raise AssertionError(f"mask-free sdpa {tag} differs: "
                                     f"{rec['sdpa_free_max_abs_err']}")
        pairs, keys = _flash_pairs(Sq, causal, q_off, kv_len)
        rec["pairs"] = pairs
        if hd == 80 and want == wg:
            # Rows are two whole 64-column boxes: the products run at 128.
            rec["padded_product_share"] = 1 - hd / 128
        if iters:
            flops = 2.0 * (hd + hd_v) * H * pairs
            nbytes = q.element_size() * (hd + hd_v) * (B * Sq * H + keys * Hkv)
            rec.update(_time_pair(
                lambda: ops.flash_attention(q, k, v, **kw),
                lambda: ops.flash_attention_ref(q, k, v, **kw), None,
                flops, nbytes, kind, iters))
            if want == "prefill_f32":
                # The kernel's arithmetic: three TF32 products for each
                # fp32 product (3xTF32); the fp32 CUDA-core bound beside.
                rec["bound_fp32_ms"] = rec["bound_ms"]
                rec["bound_ms"], rec["bound_by"] = _bound(3 * flops, nbytes,
                                                          "tf32")
            # Device time without the host's per-call work (CUDA graphs);
            # the eager back-to-back time above stays as ms_eager.
            rec["ms_eager"] = rec["ms"]
            rec["ms"] = _graph_ms(lambda: ops.flash_attention(q, k, v, **kw),
                                  iters)
            rec["sdpa_masked_ms"] = (None if sdpa is None
                                     else _graph_ms(sdpa, iters))
            rec["sdpa_free_ms"] = (None if free is None
                                   else _graph_ms(free[0], iters))
            lib = [t for t in (rec["sdpa_masked_ms"], rec["sdpa_free_ms"])
                   if t is not None]
            rec["library_ms"] = min(lib) if lib else None
            rec["slower_than_library"] = (None if not lib
                                          else rec["ms"] / rec["library_ms"])
            if tag in ("mla_prefill_64", "mla_prefill_128"):
                # The same call on the split-KV kernel with the splits the
                # plan gives it on this card (PREFILL_FILL set above any
                # grid for the call): the plan's pick before it sent a grid
                # of at least three quarters of the SMs (here 128 blocks,
                # one q tile a head) to the wgmma kernel.
                fill, ops.PREFILL_FILL = ops.PREFILL_FILL, float("inf")
                try:
                    forced = ops._launch(q, k, v, causal, off, lim, None)
                    if forced[1] != split:
                        raise AssertionError(f"{tag}: {forced[1]} ran, not "
                                             f"{split}")
                    rec["split_max_row_rel_err"] = _check_rows(
                        f"flash_attention {tag} on split-KV", forced[0],
                        ref, FLASH_TOL[kind])[2]
                    rec["split_ms"] = _graph_ms(
                        lambda: ops._launch(q, k, v, causal, off, lim, None),
                        iters)
                finally:
                    ops.PREFILL_FILL = fill
        records[tag] = rec
        del q, k, v, out, ref, mask, qt, kt, vt, free
        torch.cuda.empty_cache()
    records.update(_flash_lse_records())
    # The graph timings ran cuBLAS on streams of their own, and each such
    # stream keeps a workspace: release them, so the serve phases' peak
    # memory counts the serve path alone.
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    _line("phase2_flash_attention", records)
    return records


def _flash_lse_records() -> dict:
    """The split-KV kernel's logsumexp (``flash_attention(...,
    return_lse=True)``) against the plain version's at GLM-4.5-Air's
    decode shape (hd 128, its 32 query and 8 KV heads), bf16 and fp32,
    with one split (a 128-key cache) and with several (the serve cache),
    rows of 0 valid keys among them (lse +inf, output exactly 0); then one
    decode cache cut into T = 2 and 4 position shards, each shard's
    partial from the same entry and ``attention.combine_partials`` held
    against the one launch over the whole cache (fp32 within
    ``LSE_COMBINE_TOL`` of max|ref|, bf16 within the phase's bound), and
    the split kernel's device time with and without the logsumexp."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models.attention import combine_partials

    B, H, Hkv, hd = 4, 32, 8, 128
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        kind = "bf16" if dtype == torch.bfloat16 else "fp32"
        for Sk, lens in ((128, [0, 1, 77, 128]),
                         (SERVE_SK, [0, 1, 3000, SERVE_SK])):
            tag = f"lse_decode_{kind}_{Sk}"
            g = torch.Generator(device="cuda").manual_seed(Sk)
            q, k, v = (torch.randn(sh, generator=g, device="cuda").to(dtype)
                       for sh in ((B, 1, H, hd), (B, Sk, Hkv, hd),
                                  (B, Sk, Hkv, hd)))
            lim = torch.tensor(lens, device="cuda")
            before = dict(ops.flash_attention.launches_by_kernel)
            o, lse = ops.flash_attention(q, k, v, causal=False,
                                         kv_valid_len=lim, return_lse=True)
            torch.cuda.synchronize()
            ran = [n for n, c in ops.flash_attention.launches_by_kernel.items()
                   if c != before[n]]
            if ran != ["decode_split"]:
                raise AssertionError(f"{tag} ran {ran}, not decode_split")
            ref, ref_lse = ops.flash_attention_ref(
                q, k, v, causal=False, kv_valid_len=lim, return_lse=True)
            empty = lim == 0
            if not (torch.isinf(lse[empty]).all() and (lse[empty] > 0).all()
                    and (o[empty] == 0).all()):
                raise AssertionError(f"{tag}: a row of no valid key is not "
                                     f"(lse +inf, output 0)")
            lerr = (lse[~empty] - ref_lse[~empty]).abs().max().item()
            lscale = ref_lse[~empty].abs().max().item()
            if not lerr <= LSE_TOL[kind] * max(lscale, 1.0):
                raise AssertionError(f"{tag}: lse off by {lerr:.3e}")
            rec = {"shape": [B, 1, Sk, H, Hkv, hd], "dtype": kind,
                   "kv_valid_len": lens, "kernel": "decode_split",
                   "splits": ops.plan_launch(B, 1, Sk, H, Hkv, hd, dtype,
                                             ops._sm_count(q.device)).splits,
                   "lse_max_abs_err": lerr, "lse_max_abs_ref": lscale,
                   "lse_tol": LSE_TOL[kind]}
            (rec["max_abs_err"], rec["max_abs_ref"],
             rec["max_row_rel_err"]) = _check_rows(
                 tag, o[~empty], ref[~empty], FLASH_TOL[kind])
            if Sk == SERVE_SK:
                # The shards of this cache, combined, against the one launch.
                for T in (2, 4):
                    n = Sk // T
                    parts = [ops.flash_attention(
                        q, k[:, r * n:(r + 1) * n].contiguous(),
                        v[:, r * n:(r + 1) * n].contiguous(), causal=False,
                        kv_valid_len=lim - r * n, return_lse=True)
                        for r in range(T)]
                    comb = combine_partials(torch.stack([p[0] for p in parts]),
                                            torch.stack([p[1] for p in parts]))
                    err = (comb - o.float()).abs().max().item()
                    scale = o.float().abs().max().item()
                    tol = LSE_COMBINE_TOL if kind == "fp32" \
                        else FLASH_TOL[kind]
                    if not err <= tol * scale or not (comb[empty] == 0).all():
                        raise AssertionError(f"{tag}: {T} shards combined "
                                             f"differ by {err:.3e} of "
                                             f"{scale:.3e}")
                    rec[f"combine_T{T}_max_abs_err"] = err
                    rec[f"combine_T{T}_tol"] = tol
                rec["combine_max_abs_ref"] = o.float().abs().max().item()
                lens2 = [2048, 6144, 3000, 1]      # phase 2's decode case
                lim2 = torch.tensor(lens2, device="cuda")
                rec["ms_without_lse"] = _graph_ms(
                    lambda: ops.flash_attention(q, k, v, causal=False,
                                                kv_valid_len=lim2), 50)
                rec["ms_with_lse"] = _graph_ms(
                    lambda: ops.flash_attention(q, k, v, causal=False,
                                                kv_valid_len=lim2,
                                                return_lse=True), 50)
                rec["timed_kv_valid_len"] = lens2
            out[tag] = rec
            del q, k, v, o, ref
    return out


def _wrappers() -> dict:
    """Every kernel wrapper of the port by kernel name."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.gating_topk import ops as gt
    from repro_torch.kernels.grouped_gemm import ops as gg
    from repro_torch.kernels.eplb_place import ops as ep
    from repro_torch.kernels.plan_solve import ops as ps
    from repro_torch.kernels.ssd_scan import ops as ssd

    return {"grouped_swiglu": gg.grouped_swiglu,
            "grouped_matmul": gg.grouped_matmul,
            "grouped_swiglu_bwd": gg.grouped_swiglu_bwd,
            "grouped_matmul_nt": gg.grouped_matmul_nt,
            "grouped_wgrad": gg.grouped_wgrad,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "ssd_intra_chunk_bwd": ssd.ssd_intra_chunk_bwd,
            "grouped_swiglu_q8": gg.grouped_swiglu_q8,
            "grouped_matmul_q8": gg.grouped_matmul_q8,
            "ssd_intra_chunk": ssd.ssd_intra_chunk,
            "gating_topk": gt.gating_topk,
            "flash_attention": fa.flash_attention,
            "plan_solve": ps.plan_solve,
            "eplb_place": ep.eplb_place}


def _reset_launches():
    from repro_torch.kernels.flash_attention import ops as fa

    fa.flash_attention.lse_launches = 0
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "padded_copies"):
            fn.padded_copies = 0
        for attr in ("launches_by_kernel", "launches_by_dims"):
            table = getattr(fn, attr, {})
            for key in table:
                table[key] = 0


def _launches() -> dict:
    """Launch counts by wrapper, flash_attention's by kernel (as
    ``flash_attention.<kernel>``; those with the logsumexp as
    ``flash_attention.lse``) and flash_attention_bwd's by head-dim pair
    (as ``flash_attention_bwd.<hd>x<hd_v>``)."""
    counts = {}
    for name, fn in _wrappers().items():
        counts[name] = fn.launches
        if hasattr(fn, "lse_launches"):
            counts[f"{name}.lse"] = fn.lse_launches
        for kernel, n in getattr(fn, "launches_by_kernel", {}).items():
            counts[f"{name}.{kernel}"] = n
        for (a, b), n in getattr(fn, "launches_by_dims", {}).items():
            counts[f"{name}.{a}x{b}"] = n
    return counts


def _padded_copies() -> dict:
    """Operands the grouped GEMMs (bf16, fp32 and w8a8) copied for TMA
    since the reset."""
    return {name: fn.padded_copies for name, fn in _wrappers().items()
            if hasattr(fn, "padded_copies")}


def phase_serve(cfg, tag: str, beside: dict | None = None,
                dtype: str = "bfloat16", settings: dict = SERVE,
                **runtime) -> dict:
    """``serve_trace`` on ``cfg`` with the SERVE settings (or
    ``settings``) in ``dtype`` (and ``runtime``, the wire and FFN dtypes);
    returns the run's record, whose ``launches`` are the kernel launch
    counts (set to 0 just before it, read just after).  ``beside``: another
    serve record of this run, printed alongside."""
    import gc

    import torch

    from repro_torch.configs import layer_kinds
    from repro_torch.launch.serve import serve_trace

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    eng = serve_trace(cfg, dtype=getattr(torch, dtype), device="cuda",
                      **settings, **runtime)
    launches = _launches()
    copies = _padded_copies()
    done = eng.finished
    failed = [r.rid for r in done if r.failed]
    if len(done) != settings["requests"] or failed or \
            eng.fault_counters["nonfinite_logits"]:
        raise AssertionError(f"{tag}: finished {len(done)}, failed {failed}, "
                             f"faults {eng.fault_counters}, last error "
                             f"{eng.last_error!r}")
    if any(len(r.output) != settings["max_new"] for r in done):
        raise AssertionError(f"{tag}: a request did not produce "
                             f"{settings['max_new']} tokens")
    pre = [(n, s) for kind, n, s in eng.calls if kind == "prefill"]
    dec = [(n, s) for kind, n, s in eng.calls if kind == "decode"]
    rec = {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "attn_layers": sum(k.startswith("attn+") for k in layer_kinds(cfg)),
        "moe_layers": sum(k.endswith("+moe") for k in layer_kinds(cfg)),
        "mamba_layers": sum(k.startswith("mamba+") for k in layer_kinds(cfg)),
        "dtype": dtype, "runtime": runtime,
        "experts": cfg.moe.num_experts if cfg.moe else 0,
        "top_k": cfg.moe.top_k if cfg.moe else 0,
        "chunk": settings["chunk"], "max_seq": eng.cfg.max_seq,
        "prompt_tokens": [len(r.prompt) for r in sorted(done, key=lambda r: r.rid)],
        "prefill_calls": len(pre), "decode_calls": len(dec),
        "prefill_tok_per_s": sum(n for n, _ in pre) / sum(s for _, s in pre),
        "decode_tok_per_s": sum(n for n, _ in dec) / sum(s for _, s in dec),
        "prefill_call_s": [s for _, s in pre], "decode_call_s": [s for _, s in dec],
        "mean_ttft_s": float(eng.ttft().mean()),
        "mean_tpot_s": float(eng.tpot().mean()),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "padded_copies": copies}
    keys = ("prefill_tok_per_s", "decode_tok_per_s", "mean_ttft_s",
            "mean_tpot_s", "peak_mem_gb")
    _line(tag, dict(rec, **({} if beside is None else {
        "beside": {"model": beside["model"], "dtype": beside["dtype"],
                   "runtime": beside["runtime"],
                   **{k: beside[k] for k in keys}}})))
    del eng, done
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rec, cfg=cfg)


def _check_kernel_calls(path: str, launches: dict, copies: dict, cfg,
                        calls: dict, ffn_dtype: str = "none",
                        engine_calls: int | None = None) -> None:
    """No attention, gate or expert FFN call went around its kernel: one
    gate and expert FFN launch per MoE layer and engine call
    (``engine_calls``, by default the sum of ``calls``), one flash launch
    per attention layer and engine call that attends through it, by the
    kernel ``calls`` names for them (``calls``: flash kernel -> engine
    calls, e.g. prefill calls through ``prefill_wgmma``; every other flash
    kernel must not have run; MLA decode attends without it); and no
    operand of the grouped GEMMs was copied for TMA."""
    from repro_torch.configs import layer_kinds
    from repro_torch.kernels.flash_attention.ops import KERNELS

    kinds = layer_kinds(cfg)
    moe = sum(k.endswith("+moe") for k in kinds)
    attn = sum(k.startswith("attn+") for k in kinds)
    flash = sum(calls.values())
    total = flash if engine_calls is None else engine_calls
    ffn = ("_q8" if ffn_dtype == "int8" else "")
    expect = [("flash_attention", attn * flash), ("gating_topk", moe * total),
              ("grouped_swiglu" + ffn, moe * total),
              ("grouped_matmul" + ffn, moe * total)]
    expect += [(f"flash_attention.{k}", attn * calls.get(k, 0))
               for k in KERNELS]
    for name, want in expect:
        if launches[name] != want:
            raise AssertionError(
                f"{name} was launched {launches[name]} times on the {path} "
                f"serve path, not {want} (layers x engine calls)")
    if any(copies.values()):
        raise AssertionError(f"the {path} serve path copied operands for "
                             f"TMA: {copies}")


def phase_serve_cli() -> dict:
    """The serve entry point as a user calls it (``python -m
    repro_torch.launch.serve --arch ... --reduce``, through its ``main``)
    on each arch in fp32, its default, and bf16 at chunk 64, and on
    GLM-4.5-Air at chunk 4096: every request finishes with its tokens, and
    every attention and gate call of the run went through its kernel.  At
    chunk 64 no prefill grid fills the card, so every flash call takes the
    split-KV kernel; at chunk 4096 the prefill calls take the fp32 and the
    hd-16 ``mma.sync`` kernels.  (DeepSeek-V3 at full width in fp32 runs
    in phase 18.)"""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced
    from repro_torch.launch.serve import main as serve_main

    runs = [(arch, dtype, 64) for arch in ("glm45-106b-a12b",
                                           "jamba-v0.1-52b",
                                           "qwen3-235b-a22b")
            for dtype in ("float32", "bfloat16")]
    runs += [("glm45-106b-a12b", dtype, 4096)
             for dtype in ("float32", "bfloat16")]
    prefill_kernel = {64: {"float32": "decode_split",
                           "bfloat16": "decode_split"},
                      4096: {"float32": "prefill_f32",
                             "bfloat16": "prefill_mma_hd16"}}
    records = {}
    for arch, dtype, chunk in runs:
        cfg = reduced(get_config(arch))
        tag = f"{arch}_{dtype}" + ("" if chunk == 64 else f"_chunk{chunk}")
        _reset_launches()
        eng = serve_main(["--arch", arch, "--reduce", "--requests", "4",
                          "--chunk", str(chunk), "--max-new", "8",
                          "--dtype", dtype])
        launches = _launches()
        copies = _padded_copies()
        done = eng.finished
        if len(done) != 4 or any(r.failed or len(r.output) != 8
                                 for r in done) or \
                eng.fault_counters["nonfinite_logits"]:
            raise AssertionError(f"serve cli {tag}: finished {len(done)},"
                                 f" faults {eng.fault_counters}, last "
                                 f"error {eng.last_error!r}")
        pre = sum(kind == "prefill" for kind, _, _ in eng.calls)
        calls = {prefill_kernel[chunk][dtype]: pre}
        calls["decode_split"] = (calls.get("decode_split", 0)
                                 + len(eng.calls) - pre)
        _check_kernel_calls(f"serve cli {tag}", launches, copies, cfg, calls)
        records[tag] = {"layers": cfg.num_layers,
                        "engine_calls": len(eng.calls),
                        "prefill_calls": pre,
                        "mean_ttft_s": float(eng.ttft().mean()),
                        "mean_tpot_s": float(eng.tpot().mean()),
                        "launches": launches}
    gc.collect()
    torch.cuda.empty_cache()
    _line("phase7b_serve_cli", records)
    return records


def phase_mla_layer(deepseek) -> dict:
    """One DeepSeek-V3 MLA layer at full width (128 heads, q_lora 1536,
    kv_lora 512, q/k 192, v 128) on the card: (a) bf16 ``mla_prefill`` of
    a 4096-token chunk at offset 4096 over the serve cache (SERVE_SK
    positions, seeded latents before it) through the flash kernel (one
    ``prefill_wgmma`` launch) against the same call through the plain
    flash: y within FLASH_TOL bf16 of max|ref|, the caches equal; (b) in
    fp32, the absorbed ``mla_decode`` at positions 4096 and 777 (B 2)
    against a one-token ``mla_prefill`` at the same offsets through the
    plain flash, which expands K and V: y within 1e-4 of max|ref| (the
    absorbed algebra; fp32 products in another order)."""
    import contextlib

    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.models import attention
    from repro_torch.models.transformer import attn_config

    acfg = attn_config(deepseek)
    g = torch.Generator(device="cuda").manual_seed(5)

    @contextlib.contextmanager
    def plain_flash():
        saved = attention.flash_attention
        attention.flash_attention = ops.flash_attention_ref
        try:
            yield
        finally:
            attention.flash_attention = saved

    def cache(lengths, dtype):
        B = len(lengths)
        return attention.KVCache(*(
            torch.randn((B, SERVE_SK, n), generator=g, device="cuda").to(dtype)
            for n in (deepseek.kv_lora_rank, deepseek.qk_rope_dim)),
            torch.tensor(lengths, device="cuda"))

    result = {}
    with torch.inference_mode():
        p16 = attention.init_mla(acfg, g, dtype=torch.bfloat16, device="cuda")
        c16 = cache([4096], torch.bfloat16)
        x = torch.randn((1, 4096, deepseek.d_model), generator=g,
                        device="cuda").to(torch.bfloat16)
        _reset_launches()
        y, new = attention.mla_prefill(x, c16, p16, acfg)
        torch.cuda.synchronize()
        launches = _launches()
        with plain_flash():
            y_ref, new_ref = attention.mla_prefill(x, c16, p16, acfg)
        torch.cuda.synchronize()
        if launches["flash_attention.prefill_wgmma"] != 1 or \
                _launches()["flash_attention"] != 1:
            raise AssertionError(f"mla layer bf16: flash launches "
                                 f"{launches}, then {_launches()}")
        err, scale = _max_err(y, y_ref)
        if not (torch.isfinite(y).all() and err <= FLASH_TOL["bf16"] * scale):
            raise AssertionError(f"mla layer bf16: max|err| {err:.3e} > "
                                 f"{FLASH_TOL['bf16']} * max|ref| {scale:.3e}")
        if not all(torch.equal(a, b) for a, b in zip(new, new_ref)):
            raise AssertionError("mla layer bf16: the caches differ")
        result["prefill_bf16"] = {"chunk": 4096, "q_offset": 4096,
                                  "cache": SERVE_SK, "max_abs_err": err,
                                  "max_abs_ref": scale,
                                  "tol": FLASH_TOL["bf16"]}
        del p16, c16, x, y, new, y_ref, new_ref
        torch.cuda.empty_cache()

        p32 = attention.init_mla(acfg, g, dtype=torch.float32, device="cuda")
        c32 = cache([4096, 777], torch.float32)
        x = torch.randn((2, 1, deepseek.d_model), generator=g, device="cuda")
        _reset_launches()
        y_dec, _ = attention.mla_decode(x, c32, p32, acfg)
        with plain_flash():
            y_pre, _ = attention.mla_prefill(x, c32, p32, acfg)
        torch.cuda.synchronize()
        err, scale = _max_err(y_dec, y_pre)
        if _launches()["flash_attention"] or not (
                torch.isfinite(y_dec).all() and err <= 1e-4 * scale):
            raise AssertionError(f"mla layer fp32: absorbed decode max|err| "
                                 f"{err:.3e} > 1e-4 * max|ref| {scale:.3e}, "
                                 f"or the flash kernel ran")
        result["decode_absorbed_fp32"] = {"positions": [4096, 777],
                                          "max_abs_err": err,
                                          "max_abs_ref": scale, "tol": 1e-4}
        del p32, c32, x, y_dec, y_pre
    torch.cuda.empty_cache()
    _line("phase10_mla_layer", {"heads": deepseek.num_heads,
                                "q_lora": deepseek.q_lora_rank,
                                "kv_lora": deepseek.kv_lora_rank,
                                "qk_head_dim": deepseek.qk_nope_dim
                                + deepseek.qk_rope_dim,
                                "v_head_dim": deepseek.v_head_dim, **result})
    return result


def _ep_worker(rank, world, port, out_dir):
    """One rank of phase 9 (a spawned process on the one card): the gloo
    transport's checks, the plan tables against the plain solve, the EP
    layer in each mode with the kernel counts set to 0 before and read
    after, and, on rank 0, the R = 1 layer on all the ranks' tokens."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import planner
    from repro_torch.models.transformer import (
        ParallelCtx,
        RuntimeConfig,
        moe_config,
    )
    from repro_torch.moe import stages
    from repro_torch.moe.layer import init_moe_params, moe_layer_local
    from repro_torch.parallel import collectives

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    group = collectives.init("gloo", world_size=world, rank=rank,
                             init_method=f"tcp://localhost:{port}",
                             timeout_s=600)
    dev = torch.device("cuda")
    # Every collective of the layer, on CUDA tensors through gloo.
    ar = torch.arange(world, device=dev)
    transport = {
        "all_gather": torch.equal(collectives.all_gather(
            group, torch.full((3,), rank, device=dev)).cpu(),
            torch.arange(world)[:, None].expand(world, 3)),
        "all_to_all": torch.equal(collectives.all_to_all(
            group, (ar * 10 + rank)[:, None].to(torch.bfloat16)).cpu()[:, 0],
            (rank * 10 + torch.arange(world)).to(torch.bfloat16)),
        # Row q is nonzero on one rank only, as a replica slot's weights.
        "reduce_scatter_int8": torch.equal(collectives.reduce_scatter(
            group, torch.where((ar + 1) % world == rank, -100 - ar, 0)
            .to(torch.int8)[:, None].expand(world, 4).contiguous()).cpu(),
            torch.full((4,), -100 - rank, dtype=torch.int8)),
        "all_reduce_bf16": torch.equal(collectives.all_reduce(
            group, torch.ones(4, dtype=torch.bfloat16, device=dev)).cpu(),
            torch.full((4,), world, dtype=torch.bfloat16))}
    if not all(transport.values()):
        raise AssertionError(f"gloo on CUDA tensors: {transport}")
    glm = get_config("glm45-106b-a12b")
    bf16 = torch.bfloat16
    rcfg = RuntimeConfig(cf_pair=4.0, cf_slot=4.0, dtype=bf16)
    pctx = ParallelCtx(group=group)
    T = EP_TOKENS
    cfgs = {"a2a": moe_config(glm, rcfg, pctx, T),
            "replicated": moe_config(glm, rcfg, pctx, world * T,
                                     dispatch_mode="replicated")}
    cfgs["a2a_wire_int8"] = dataclasses.replace(cfgs["a2a"],
                                                wire_dtype="int8")
    params = init_moe_params(cfgs["a2a"], torch.Generator(
        device=dev).manual_seed(0), dtype=bf16, device=dev, ep_rank=rank)
    # The tokens lean toward experts 0-7 (homed on rank 0), so the plan
    # moves load off rank 0 and streams replicas to rank 1.
    lean = params.router[:, :8].sum(dim=1)
    x_all = (torch.randn((world * T, glm.d_model), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
        + 2.0 * lean / lean.norm()).to(bf16)
    mine = x_all[rank * T:(rank + 1) * T]
    inputs = {m: x_all if c.dispatch_mode == "replicated" else mine
              for m, c in cfgs.items()}
    out = {"transport": transport, "modes": {}}
    with torch.inference_mode():
        for mode in ("a2a", "replicated"):
            ctx = stages.make_stage_ctx(cfgs[mode], group)
            gs = stages.gate_stage(ctx, inputs[mode], params.router)
            plan = stages.plan_stage(ctx, gs).plan
            plain = planner.solve_plan(gs.lam.cpu(), torch.arange(
                glm.moe.num_experts) // (glm.moe.num_experts // world),
                n_slot=cfgs[mode].balancer.n_slot)
            field = _plan_mismatch(plan, plain)
            if field is not None:
                raise AssertionError(f"ep layer {mode}: plan {field} "
                                     f"differs from the plain solve")
            out["modes"][mode] = {
                "plan_tables_equal": True, "lam_total": int(gs.lam.sum()),
                "pre_max": int(plain.pre_max), "post_max": int(plain.post_max),
                "replicas": int((plain.x >= 0).sum())}
        ys = {}
        for mode, cfg in cfgs.items():
            torch.cuda.synchronize()
            _reset_launches()
            y, _, st = moe_layer_local(inputs[mode], params, cfg,
                                       axis_name=group)
            torch.cuda.synchronize()
            launches = _launches()
            if cfg.dispatch_mode == "a2a":
                y = collectives.all_gather(group, y).reshape(world * T, -1)
            ys[mode] = y
            rec = out["modes"].setdefault(mode, {})
            rec.update(drops=int(st.drops_dispatch + st.drops_slot),
                       post_max=int(st.post_max),
                       max_slot_load=int(st.max_slot_load),
                       cap_pair=cfg.cap_pair, cap_slot=cfg.cap_slot,
                       launches={k: launches[k] for k in (
                           "plan_solve", "gating_topk", "grouped_swiglu",
                           "grouped_matmul", "flash_attention")})
        if rank == 0:
            # The R = 1 layer on the same tokens and weights.
            cfg1 = moe_config(glm, rcfg, ParallelCtx(), world * T)
            p1 = init_moe_params(cfg1, torch.Generator(
                device=dev).manual_seed(0), dtype=bf16, device=dev)
            refs = {"a2a": moe_layer_local(x_all, p1, cfg1)[0],
                    "replicated": moe_layer_local(x_all, p1, dataclasses.replace(
                        cfg1, dispatch_mode="replicated"))[0]}
            refs["a2a_wire_int8"] = refs["a2a"]
            for mode, y in ys.items():
                err, scale = _max_err(y, refs[mode])
                tol = 3e-2 if "int8" in mode else 2e-2
                out["modes"][mode].update(max_abs_err=err, max_abs_ref=scale,
                                          tol=tol,
                                          finite=bool(torch.isfinite(y).all()))
            ref_a2a = refs["a2a"]
            del p1, refs
        out["runs"] = _ep_balancer_runs(rank, world, group, cfgs["a2a"],
                                        params, mine, ys["a2a"],
                                        ref_a2a if rank == 0 else None)
        if rank == 0:
            del ref_a2a
    out["backward"] = _ep_backward(rank, world, group, glm, rcfg,
                                   cfgs["a2a"], params, x_all, mine)
    del params
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    collectives.destroy()


def _ep_balancer_runs(rank, world, group, cfg, params, mine, y_clean, ref):
    """Phase 9's balancer and resilience runs on one rank (``a2a``, the
    phase's tokens and weights), each with the kernel counts set to 0
    before the layer call and read after: the baselines ``eplb`` (a stale
    estimate: the load's per-expert sums rolled by E / 2), ``eplb_plus``,
    ``lplb``, ``ultraep`` at P 4 and under a ``RankHealth`` with rank 1 at
    half speed; an injected ``solve_fail`` after a clean call (the plan
    reused, y bitwise equal), ``transfer_flaky`` (retried, y bitwise the
    clean run's) and ``nan_payload`` (rows counted, y finite).  On rank 0,
    y of every run that computes the layer's function against the R = 1
    layer (``ref``) at the phase's bf16 tolerance."""
    import numpy as np
    import torch

    from repro_torch.core.health import RankHealth
    from repro_torch.fault.injector import FaultInjector, FaultSpec
    from repro_torch.moe import stages
    from repro_torch.moe.layer import moe_layer_local
    from repro_torch.parallel import collectives

    T = mine.shape[0]
    E = cfg.gating.num_experts
    ctx = stages.make_stage_ctx(cfg, group)
    lam = stages.gate_stage(ctx, mine, params.router).lam
    stale = torch.roll(lam.sum(dim=0), E // 2).to(torch.float32)

    def bal(**kw):
        return dataclasses.replace(
            cfg, balancer=dataclasses.replace(cfg.balancer, **kw))

    def call(c, res=None, est=None):
        torch.cuda.synchronize()
        _reset_launches()
        y, _, st = moe_layer_local(mine, params, c, axis_name=group,
                                   lam_e_est=est, resilience=res)
        torch.cuda.synchronize()
        n = _launches()
        y = collectives.all_gather(group, y).reshape(world * T, -1)
        rec = {"drops": int(st.drops_dispatch + st.drops_slot),
               "post_max": int(st.post_max),
               "finite": bool(torch.isfinite(y).all()),
               "launches": {k: n[k] for k in (
                   "plan_solve", "eplb_place", "gating_topk",
                   "grouped_swiglu", "grouped_matmul")}}
        if res is not None:
            rec.update(fallback_plans=int(st.fallback_plans),
                       dropped_payload_tokens=int(st.dropped_payload_tokens),
                       quarantined_ranks=int(st.quarantined_ranks),
                       counters=dict(res.counters))
        return y, rec

    runs, ys = {}, {}
    ys["eplb"], runs["eplb"] = call(bal(mode="eplb"), est=stale)
    ys["eplb_plus"], runs["eplb_plus"] = call(bal(mode="eplb_plus"))
    ys["lplb"], runs["lplb"] = call(bal(mode="lplb"))
    ys["ultraep_p4"], runs["ultraep_p4"] = call(bal(probe_parallelism=4))
    health = RankHealth(world)
    health.observe(np.array([1.0, 2.0]))          # rank 1 at half speed
    ys["ultraep_health"], runs["ultraep_health"] = call(
        cfg, stages.Resilience(health=health))
    runs["ultraep_health"]["weights"] = health.planner_weights().tolist()
    # solve_fail: step 0 solves and caches, step 1's solve fails.
    inj = FaultInjector([FaultSpec("solve_fail", start_step=1)])
    res = stages.Resilience(injector=inj)
    inj.advance(0)
    y0, runs["solve_fail_step0"] = call(cfg, res)
    inj.advance(1)
    y1, runs["solve_fail"] = call(cfg, res)
    runs["solve_fail"]["y_equal_step0"] = bool(torch.equal(y0, y1))
    ys["solve_fail_step0"] = y0
    inj = FaultInjector([FaultSpec("transfer_flaky", count=2)])
    inj.advance(0)
    y, runs["transfer_flaky"] = call(cfg, stages.Resilience(
        stages.ResilienceConfig(max_transfer_retries=2), injector=inj))
    runs["transfer_flaky"]["y_equal_clean"] = bool(torch.equal(y, y_clean))
    inj = FaultInjector([FaultSpec("nan_payload", severity=0.05)], seed=3)
    inj.advance(0)
    _, runs["nan_payload"] = call(cfg, stages.Resilience(injector=inj))
    if ref is not None:
        for name, y in ys.items():
            err, scale = _max_err(y, ref)
            runs[name].update(max_abs_err=err, max_abs_ref=scale, tol=2e-2)
    return runs


def _ep_backward(rank, world, group, glm, rcfg, cfg, params, x_all, mine):
    """Phase 9's backward on one rank: d(sum y^2) through the R = 2 ``a2a``
    layer against the R = 1 layer's on the same tokens and weights (each
    rank holds the R = 1 layer and compares its own share: its tokens'
    gradient, its experts', and the router's summed over the group), each
    within TRAIN_TOL of the reference tensor's max|ref|."""
    import torch

    from repro_torch.models.transformer import ParallelCtx, moe_config
    from repro_torch.moe import stages
    from repro_torch.moe.layer import init_moe_params, moe_layer_local
    from repro_torch.parallel import collectives

    T = mine.shape[0]
    with torch.no_grad():
        ctx = stages.make_stage_ctx(cfg, group)
        plan = stages.plan_stage(ctx, stages.gate_stage(
            ctx, mine, params.router)).plan
    torch.cuda.synchronize()
    _reset_launches()
    with torch.enable_grad():
        params.requires_grad_(True)
        xg = mine.clone().requires_grad_(True)
        y, _, st = moe_layer_local(xg, params, cfg, axis_name=group)
        (y.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    launches = _launches()
    router = collectives.all_reduce(group, params.router.grad)
    # Held on the host while the R = 1 layer runs (two ranks share the card).
    got = {"x": xg.grad.cpu(), "router": router.cpu(),
           "w1": params.w1.grad.cpu(), "w3": params.w3.grad.cpu(),
           "w2": params.w2.grad.cpu()}
    params.requires_grad_(False)
    for t in params.parameters():
        t.grad = None
    del xg, y, router
    torch.cuda.empty_cache()
    cfg1 = moe_config(glm, rcfg, ParallelCtx(), world * T)
    p1 = init_moe_params(cfg1, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
    with torch.enable_grad():
        p1.requires_grad_(True)
        x1 = x_all.clone().requires_grad_(True)
        (moe_layer_local(x1, p1, cfg1)[0].float() ** 2).sum().backward()
    epr = glm.moe.num_experts // world
    mine_e = slice(rank * epr, (rank + 1) * epr)
    ref = {"x": x1.grad[rank * T:(rank + 1) * T], "router": p1.router.grad,
           "w1": p1.w1.grad[mine_e], "w3": p1.w3.grad[mine_e],
           "w2": p1.w2.grad[mine_e]}
    errs = {n: _rel_check(f"ep backward rank {rank} d{n}", got[n],
                          ref[n].cpu(), TRAIN_TOL) for n in got}
    del p1, x1, ref
    torch.cuda.empty_cache()
    return {"max_abs_err": {n: e[0] for n, e in errs.items()},
            "max_abs_ref": {n: e[1] for n, e in errs.items()},
            "replicas": int((plan.x >= 0).sum()),
            "drops": int(st.drops_dispatch + st.drops_slot),
            "launches": {k: launches[k] for k in (
                "plan_solve", "gating_topk", "grouped_swiglu",
                "grouped_matmul", "grouped_swiglu_bwd", "grouped_matmul_nt",
                "grouped_wgrad")}}


def phase_ep_layer() -> dict:
    """The EP layer at R = 2 on the one card: two processes (spawn), one
    gloo group over CUDA tensors, GLM-4.5-Air at full width, one MoE layer,
    EP_TOKENS bf16 tokens a rank that lean toward rank 0's experts,
    ``ultraep``, in modes ``a2a``,
    ``replicated`` and ``a2a`` with the int8 wire.  y against the R = 1
    layer on the same tokens and weights (2e-2 max|ref| in bf16, 3e-2 with
    the int8 wire), plan tables equal to the plain solve's, zero drops, and
    each call through the plan-solve, gate and grouped-GEMM kernels.  No
    time is stated: gloo stages CUDA tensors through the host."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
        mp.spawn(_ep_worker, args=(EP_RANKS, port, out_dir), nprocs=EP_RANKS,
                 join=True)
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(EP_RANKS)]
    for rank, rec in enumerate(ranks):
        for mode, m in rec["modes"].items():
            n = m["launches"]
            if m["drops"] or n["plan_solve"] != 1 or n["gating_topk"] != 1 \
                    or n["grouped_swiglu"] != 1 or n["grouped_matmul"] != 1:
                raise AssertionError(f"ep layer rank {rank} {mode}: drops "
                                     f"{m['drops']}, launches {n}")
    for rank, rec in enumerate(ranks):
        for name, m in rec["runs"].items():
            n = m["launches"]
            want = {"plan_solve": 1, "eplb_place": 0}
            if name in ("eplb", "eplb_plus"):
                want = {"plan_solve": 0, "eplb_place": 1}
            elif name in ("lplb", "solve_fail"):
                want = {"plan_solve": 0, "eplb_place": 0}
            want.update(gating_topk=1, grouped_swiglu=1, grouped_matmul=1)
            if m["drops"] or not m["finite"] or any(
                    n[k] != v for k, v in want.items()):
                raise AssertionError(f"ep layer rank {rank} {name}: drops "
                                     f"{m['drops']}, finite {m['finite']}, "
                                     f"launches {n}, expected {want}")
            if "tol" in m and not (m["max_abs_err"]
                                   <= m["tol"] * m["max_abs_ref"]):
                raise AssertionError(f"ep layer {name}: max|err| "
                                     f"{m['max_abs_err']:.3e} > {m['tol']} * "
                                     f"max|ref| {m['max_abs_ref']:.3e}")
        runs = rec["runs"]
        if not (runs["solve_fail"]["y_equal_step0"]
                and runs["solve_fail"]["fallback_plans"] == 1
                and runs["solve_fail"]["counters"]["last_good_reuses"] == 1):
            raise AssertionError(f"ep layer rank {rank} solve_fail: "
                                 f"{runs['solve_fail']}")
        if not (runs["transfer_flaky"]["y_equal_clean"]
                and runs["transfer_flaky"]["counters"]["transfer_retries"]
                == 2):
            raise AssertionError(f"ep layer rank {rank} transfer_flaky: "
                                 f"{runs['transfer_flaky']}")
        if runs["nan_payload"]["dropped_payload_tokens"] <= 0:
            raise AssertionError(f"ep layer rank {rank} nan_payload: no row "
                                 f"counted: {runs['nan_payload']}")
    for rank, rec in enumerate(ranks):
        bw = rec["backward"]
        n = bw["launches"]
        if bw["replicas"] < 1 or bw["drops"] or n["grouped_swiglu_bwd"] != 1 \
                or n["grouped_matmul_nt"] != 2 or n["grouped_wgrad"] != 3:
            raise AssertionError(f"ep layer backward rank {rank}: {bw}")
    for mode, m in ranks[0]["modes"].items():
        if not (m["finite"] and m["max_abs_err"] <= m["tol"] * m["max_abs_ref"]):
            raise AssertionError(f"ep layer {mode}: max|err| "
                                 f"{m['max_abs_err']:.3e} > {m['tol']} * "
                                 f"max|ref| {m['max_abs_ref']:.3e}")
    result = {"ranks": EP_RANKS, "tokens_per_rank": EP_TOKENS,
              "backend": "gloo", "ranks_by_mode": ranks}
    _line("phase9_ep_layer", result)
    return result


def phase_mamba_mixer(jamba):
    """One Mamba mixer at full width over T 4096 from a non-zero state: the
    card (SSD kernel) in bf16 and fp32 vs the fp32 plain path on the host,
    and two chunks of 2048 vs one of 4096 with the state carried."""
    import torch

    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.models import ssm
    from repro_torch.models.transformer import ssm_config

    scfg = ssm_config(jamba)
    T, D = 4096, jamba.d_model
    gen = torch.Generator(device="cuda").manual_seed(1)
    p32 = ssm.init_ssm(scfg, gen, dtype=torch.float32, device="cuda")
    x32 = torch.randn((1, T, D), generator=gen, device="cuda")
    st32 = ssm.SSMState(
        torch.randn((1, scfg.n_heads, scfg.d_state, scfg.headdim),
                    generator=gen, device="cuda") * 0.5,
        torch.randn((1, scfg.d_conv - 1, ssm.conv_channels(scfg)),
                    generator=gen, device="cuda"),
        torch.zeros(1, dtype=torch.int64, device="cuda"))

    def cast(params, device, dtype):
        """Copy of ``params`` on ``device``; a_log, d_skip, dt_bias stay
        fp32 as in the model."""
        t = {k: v.detach().to(device) for k, v in params.named_parameters()}
        for k in ("in_proj", "conv_w", "conv_b", "norm", "out_proj"):
            t[k] = t[k].to(dtype)
        return ssm.SSMParams(**t)

    def state(dtype, device):
        return ssm.SSMState(st32.s.to(device), st32.conv.to(device, dtype),
                            st32.length.to(device))

    with torch.inference_mode():
        y_ref, s_ref = ssm.ssd_prefill(x32.cpu(), state(torch.float32, "cpu"),
                                       cast(p32, "cpu", torch.float32), scfg)
        result = {}
        p16 = cast(p32, "cuda", torch.bfloat16)
        for key, params, x, tol in (
                ("fp32", p32, x32, 1e-4),
                ("bf16", p16, x32.to(torch.bfloat16), 2e-2)):
            ops.ssd_intra_chunk.launches = 0
            st = state(x.dtype, "cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, new = ssm.ssd_prefill(x, st, params, scfg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            if ops.ssd_intra_chunk.launches != 1:
                raise AssertionError(f"mixer {key}: "
                                     f"{ops.ssd_intra_chunk.launches} SSD "
                                     f"kernel launches, expected 1")
            rec = {"wall_ms": wall_ms, "tol": tol}
            for name, out, ref in (("y", y, y_ref), ("state", new.s, s_ref.s)):
                err, scale = _max_err(out.cpu(), ref)
                if not (torch.isfinite(out).all() and err <= tol * scale):
                    raise AssertionError(f"mixer {key} {name}: max|err| "
                                         f"{err:.3e} > {tol} * max|ref| "
                                         f"{scale:.3e}")
                rec[f"{name}_max_abs_err"] = err
                rec[f"{name}_max_abs_ref"] = scale
            result[key] = rec
        y_one, st_one = ssm.ssd_prefill(x32, state(torch.float32, "cuda"), p32,
                                        scfg)
        y_a, st_a = ssm.ssd_prefill(x32[:, :T // 2], state(torch.float32,
                                                           "cuda"), p32, scfg)
        y_b, st_b = ssm.ssd_prefill(x32[:, T // 2:], st_a, p32, scfg)
        split = {}
        for name, out, ref in (("y", torch.cat([y_a, y_b], 1), y_one),
                               ("state", st_b.s, st_one.s),
                               ("conv", st_b.conv, st_one.conv)):
            err, scale = _max_err(out, ref)
            if not err <= 1e-4 * scale:
                raise AssertionError(f"mixer 2x2048 vs 4096 {name}: max|err| "
                                     f"{err:.3e} > 1e-4 * max|ref| "
                                     f"{scale:.3e}")
            split[f"{name}_max_abs_err"] = err
        if int(st_b.length) != T:
            raise AssertionError(f"mixer: length {int(st_b.length)} != {T}")
        result["two_chunks_vs_one_fp32"] = split
    _line("phase5_mamba_mixer", {
        "T": T, "d_model": D, "d_inner": scfg.d_inner, "heads": scfg.n_heads,
        "d_state": scfg.d_state, "groups": scfg.n_groups, **result})
    del p32, p16, x32, y_ref, s_ref
    torch.cuda.empty_cache()


TRAIN = dict(layers=1, batch=2, seq=4096, steps=5, loss_chunks=8, seed=0)
TRAIN_TOL = 2e-2              # every gradient within 2e-2 of its max|ref|
# Launches of each wrapper in one train step of the one-layer GLM-4.5-Air
# (attention + MoE): the forward kernels once, B1 once, B2 twice (dact =
# dy w2^T, dx = dh w1^T + dg w3^T), B3 three times (dw1, dw3, dw2), the
# flash backward once; no plan solve (R = 1) and no operand copied.
TRAIN_LAUNCHES = {"gating_topk": 1, "grouped_swiglu": 1, "grouped_matmul": 1,
                  "grouped_swiglu_bwd": 1, "grouped_matmul_nt": 2,
                  "grouped_wgrad": 3, "flash_attention": 1,
                  "flash_attention.prefill_wgmma": 1,
                  "flash_attention_bwd": 1, "plan_solve": 0}


def _rel_check(name, out, ref, tol):
    """max|err| <= tol * max|ref| over the whole tensor; (err, scale)."""
    err, scale = _max_err(out, ref)
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max|err| {err:.3e} > {tol} * "
                             f"max|ref| {scale:.3e}")
    return err, scale


# The grouped backward's shapes in phase 12: (tag, config name, tokens,
# capacity factors).  GLM-4.5-Air's train step (phase 13's counts: 8192
# tokens at 4.0) and the two train cells of phase 17 (launch/specs.py's
# train_4k: 4096 tokens at the runtime's 2.0): DeepSeek-V3's short slots
# (~128 rows, K 7168, N 2048) and Jamba-v0.1's 16 experts (~512 rows, K
# 4096, N 14336).
GROUPED_BWD_SHAPES = (("glm_train", "glm", 8192, SERVE["cf"]),
                      ("deepseek_cell", "deepseek", 4096, 2.0),
                      ("jamba_cell", "jamba", 4096, 2.0))


def _slot_check(name, outs, ref, tol, step: int = 32):
    """:func:`_rel_check` of each of ``outs`` ((G, ...) tensors) against
    the same entry of ``ref(sl)``, the plain version on the slots ``sl``,
    a group of ``step`` slots at a time (at DeepSeek-V3's width a plain
    version's fp32 temporaries over all 258 slots would not fit beside the
    operands); (max err, max|ref|) over all of them."""
    err = scale = 0.0
    for g0 in range(0, outs[0].shape[0], step):
        sl = slice(g0, g0 + step)
        for out, r in zip(outs, ref(sl)):
            e, sc = _max_err(out[sl], r)
            err, scale = max(err, e), max(scale, sc)
    if not err <= tol * scale:
        raise AssertionError(f"{name}: max|err| {err:.3e} > {tol} * "
                             f"max|ref| {scale:.3e}")
    return err, scale


def _grouped_bwd_records(cfg, tokens: int, cf: float, iters: int) -> dict:
    """B1 (swiglu_bwd), B2 (matmul_nt) and B3 (wgrad) at one shape of
    GROUPED_BWD_SHAPES: each slot's valid-row count from the port's gate,
    ``ultraep`` plan and bucket on ``tokens`` seeded tokens at capacity
    factors ``cf``, then the same with every 13th slot empty and NaN in
    the padded rows of x and dact; every output within TRAIN_TOL of its
    max|ref|, padded rows and empty slots exactly zero.  B1's ``ms`` is the
    train step's call (``zero_padded=False``: rows from the count rounded
    up to 64 on unwritten), checked equal to the public call's on the
    valid rows, whose time (zeros written) stands beside; and B2's and B3's
    outputs must be the same bits whether those rows hold zeros, NaN or
    what the train step's call left there."""
    import torch

    from repro_torch.kernels.grouped_gemm import ops as gg

    bf16 = torch.bfloat16
    rows, cap = _serve_rows(cfg, tokens, "a2a", 7, cf=cf)
    G, M, K, N = rows.shape[0], cap, cfg.d_model, cfg.moe.d_ff
    R = int(rows.sum())
    nz = int((rows > 0).sum())
    x, w1, w3, w2 = _kernel_inputs(G, M, K, N, bf16, 11)
    g = torch.Generator(device="cuda").manual_seed(12)
    dact = torch.randn((G, M, N), generator=g, device="cuda").to(bf16)
    dy = torch.randn((G, M, K), generator=g, device="cuda").to(bf16)
    pad = (torch.arange(M, device="cuda")[None, :, None]
           >= rows[:, None, None])
    x = torch.where(pad, 0.0, x.float()).to(bf16)     # as the bucket leaves it
    shape = dict(G=G, M=M, K=K, N=N, tokens=tokens, cf=cf)
    recs = {}

    def zeros_past(name, out, r):
        keep = torch.arange(out.shape[1], device="cuda")[None, :, None] < \
            r[:, None, None]
        if not torch.all(torch.where(keep, 0.0, out.float()) == 0):
            raise AssertionError(f"{name}: a padded row is not zero")

    def record(name, kernel, plain, library, flops, nbytes, checks,
               **extra):
        t = _time_pair(kernel, plain, library, flops, nbytes, "bf16", iters)
        recs[name] = dict(t, shape=shape, rows=R, slots_with_rows=nz,
                          **checks, **extra)

    def nan_past(t, r):
        keep = torch.arange(t.shape[1], device="cuda")[None, :, None] < \
            r[:, None, None]
        return torch.where(keep, t.float(), float("nan")).to(t.dtype)

    # B1: the public call, then the train step's.
    dh, dg = gg.grouped_swiglu_bwd(x, w1, w3, dact, rows)
    torch.cuda.synchronize()
    e1 = _slot_check("swiglu_bwd", (dh, dg),
                     lambda sl: gg.grouped_swiglu_bwd_ref(
                         x[sl], w1[sl], w3[sl], dact[sl], rows[sl]),
                     TRAIN_TOL)
    zeros_past("swiglu_bwd dh", dh, rows)
    zeros_past("swiglu_bwd dg", dg, rows)
    dh5, dg5 = gg.grouped_swiglu_bwd(x, w1, w3, dact, rows,
                                     zero_padded=False)
    torch.cuda.synchronize()
    for n, a, b in (("dh", dh5, dh), ("dg", dg5, dg)):
        if not torch.equal(torch.where(pad, 0.0, a.float()), b.float()):
            raise AssertionError(f"swiglu_bwd {n}: the train step's call "
                                 f"differs on the valid rows")
    tile_rows = torch.clamp((rows + 63) // 64 * 64, max=M)
    record("grouped_swiglu_bwd",
           lambda: gg.grouped_swiglu_bwd(x, w1, w3, dact, rows,
                                         zero_padded=False),
           lambda: gg.grouped_swiglu_bwd_ref(x, w1, w3, dact, rows),
           None, 4.0 * R * K * N,
           2 * (R * K + 2 * nz * K * N + 3 * R * N),
           dict(max_abs_err=e1[0], max_abs_ref=e1[1]),
           zero_padded_ms=_cuda_ms(
               lambda: gg.grouped_swiglu_bwd(x, w1, w3, dact, rows), iters),
           zero_bytes=int(4 * (G * M - int(tile_rows.sum())) * N),
           work_items=int(gg.swiglu_bwd_tiles(rows, M, N).shape[0]),
           bmm_pair_ms=_cuda_ms(lambda: (torch.bmm(x, w1), torch.bmm(x, w3)),
                                iters),
           library_note="none: no one call computes dh and dg; bmm_pair_ms "
                        "is torch.bmm of x by w1 and by w3 over the padded "
                        "buffers; ms is the train step's call "
                        "(zero_padded=False), zero_padded_ms the public "
                        "call's (rows past the count written as zeros)")
    # B2's and B3's outputs whatever B1's padded rows hold.
    unread = {}
    for tag, (a, b) in (("nan", (nan_past(dh, rows), nan_past(dg, rows))),
                        ("unwritten", (dh5, dg5))):
        for name, call in (
                ("matmul_nt_dual", lambda a, b: gg.grouped_matmul_nt(
                    a, w1, rows, b, w3)),
                ("wgrad_dw1", lambda a, b: gg.grouped_wgrad(x, a, rows)),
                ("wgrad_dw3", lambda a, b: gg.grouped_wgrad(x, b, rows))):
            same = torch.equal(call(a, b), call(dh, dg))
            unread[f"{name}_{tag}"] = same
            if not same:
                raise AssertionError(f"{name}: B1's padded rows ({tag}) "
                                     f"reach a valid output")
        torch.cuda.empty_cache()
    recs["grouped_swiglu_bwd"]["padded_rows_unread_bitwise"] = unread
    del dh5, dg5
    # B2: dact = dy w2^T (w2 stored (G, F, D)) and dx = dh w1^T + dg w3^T;
    # each the public call (rows past the count zeros) and the train
    # step's call (zero_padded=False, NaN in its operands' padded rows),
    # which must agree on the rows up to the count rounded up to 64.
    tile = torch.arange(M, device="cuda")[None, :, None] < \
        torch.clamp((rows + 63) // 64 * 64, max=M)[:, None, None]
    sparse = rows.clone()
    sparse[::13] = 0

    def b2_case(name, args, nan_args, flops, nbytes, bmm):
        call = lambda a, r, **kw: gg.grouped_matmul_nt(a[0], a[1], r, *a[2:],
                                                       **kw)
        ref = lambda a, r, sl: (gg.grouped_matmul_nt_ref(
            *(t[sl] for t in a[:2]), r[sl], *(t[sl] for t in a[2:])),)
        pub = call(args, rows)
        torch.cuda.synchronize()
        e = _slot_check(f"matmul_nt {name}", (pub,),
                        lambda sl: ref(args, rows, sl), TRAIN_TOL)
        zeros_past(f"matmul_nt {name}", pub, rows)
        train = call(nan_args, rows, zero_padded=False)
        torch.cuda.synchronize()
        if not torch.equal(torch.where(tile, train, 0), torch.where(
                tile, pub, 0)):
            raise AssertionError(f"matmul_nt {name}: the train step's call "
                                 f"differs from the public call's")
        # Every 13th slot empty, NaN past the counts: both calls.
        nan_sparse = [nan_past(t, sparse) if t.shape[1] == M else t
                      for t in args]
        sp_pub = call(nan_sparse, sparse)
        sp_train = call(nan_sparse, sparse, zero_padded=False)
        torch.cuda.synchronize()
        zeros_past(f"matmul_nt {name} sparse", sp_pub, sparse)
        keep = torch.arange(M, device="cuda")[None, :, None] < \
            sparse[:, None, None]
        e_sp = _slot_check(f"matmul_nt {name} sparse",
                           (torch.where(keep, sp_train, 0),),
                           lambda sl: ref(args, sparse, sl), TRAIN_TOL)
        if not torch.equal(torch.where(keep, sp_train, 0), sp_pub):
            raise AssertionError(f"matmul_nt {name} sparse: the train "
                                 f"step's call differs")
        del sp_pub, sp_train, nan_sparse
        rec = dict(
            _time_pair(lambda: call(args, rows, zero_padded=False),
                       lambda: gg.grouped_matmul_nt_ref(args[0], args[1],
                                                        rows, *args[2:]),
                       bmm, flops, nbytes, "bf16", iters),
            max_abs_err=e[0], max_abs_ref=e[1],
            sparse_nan=dict(max_abs_err=e_sp[0], max_abs_ref=e_sp[1]),
            zero_padded_ms=_cuda_ms(lambda: call(args, rows), iters),
            zero_bytes=int(2 * (G * M - int(torch.clamp(
                (rows + 63) // 64 * 64, max=M).sum())) * pub.shape[2]),
            work_items=int(gg.matmul_nt_tiles(rows, M, pub.shape[2])
                           .shape[0]))
        torch.cuda.empty_cache()
        return rec, pub, train

    b2 = {}
    b2["dact"], dact_pub, dact_train = b2_case(
        "dact", (dy, w2), (nan_past(dy, rows), w2), 2.0 * R * K * N,
        2 * (R * K + nz * K * N + R * N),
        lambda: torch.bmm(dy, w2.transpose(1, 2)))
    del w2, dy
    torch.cuda.empty_cache()
    b2["dx"], dx_pub, dx_train = b2_case(
        "dx", (dh, w1, dg, w3), (nan_past(dh, rows), w1, nan_past(dg, rows),
                                 w3),
        4.0 * R * K * N, 2 * (2 * R * N + 2 * nz * K * N + R * K),
        lambda: torch.bmm(dh, w1.transpose(1, 2))
        + torch.bmm(dg, w3.transpose(1, 2)))
    # Their readers: B1 (dact) and the dispatch gathers' backward (dx, into
    # the tokens) give the same bits whether those rows hold zeros, NaN or
    # what the train step's call left there.
    unread = {}
    base = gg.grouped_swiglu_bwd(x, w1, w3, dact_pub, rows)
    for tag, d in (("nan", nan_past(dact_pub, rows)),
                   ("unwritten", dact_train)):
        got = gg.grouped_swiglu_bwd(x, w1, w3, d, rows)
        unread[f"swiglu_bwd_dact_{tag}"] = all(
            torch.equal(a, b) for a, b in zip(got, base))
        del got
    del base, dact_pub, dact_train
    ds, _, tokens_x = _serve_dispatch(cfg, tokens, "a2a", 7, cf=cf,
                                      x_grad=True)
    if not torch.equal(ds.rows, rows):
        raise AssertionError("the dispatch's rows differ from phase 12's")
    grad = lambda d: torch.autograd.grad(ds.xs, tokens_x, d,
                                         retain_graph=True)[0]
    base = grad(torch.where(pad, 0.0, dx_pub.float()).to(bf16))
    for tag, d in (("nan", nan_past(dx_pub, rows)), ("unwritten", dx_train)):
        unread[f"gather_bwd_dx_{tag}"] = torch.equal(grad(d), base)
    del ds, tokens_x, base, dx_pub, dx_train
    for k, same in unread.items():
        if not same:
            raise AssertionError(f"{k}: B2's padded rows reach a valid "
                                 f"result")
    recs["grouped_matmul_nt"] = dict(
        b2["dact"], shape=shape, rows=R, slots_with_rows=nz,
        dual=b2["dx"], padded_rows_unread_bitwise=unread,
        library_note="torch.bmm over the padded buffers (dx: two bmm and "
                     "an add); ms is the train step's call "
                     "(zero_padded=False), zero_padded_ms the public "
                     "call's (rows past the count written as zeros)")
    del b2
    torch.cuda.empty_cache()
    # B3: dw1 = x^T dh; then NaN in the padded rows and every 13th slot
    # empty (``sparse``), for B3 and B1.
    out = gg.grouped_wgrad(x, dh, rows)
    torch.cuda.synchronize()
    e = _slot_check("wgrad", (out,), lambda sl: (
        gg.grouped_wgrad_ref(x[sl], dh[sl], rows[sl]),), TRAIN_TOL)
    del out
    record("grouped_wgrad", lambda: gg.grouped_wgrad(x, dh, rows),
           lambda: gg.grouped_wgrad_ref(x, dh, rows),
           lambda: torch.bmm(x.transpose(1, 2), dh), 2.0 * R * K * N,
           2 * (R * K + R * N + G * K * N),
           dict(max_abs_err=e[0], max_abs_ref=e[1]),
           tiles=int(gg.wgrad_tiles(G, K, N).shape[0]))
    torch.cuda.empty_cache()
    nan_x = nan_past(x, rows)
    out = gg.grouped_wgrad(nan_x, dh, sparse)
    torch.cuda.synchronize()
    e = _slot_check("wgrad sparse", (out,), lambda sl: (
        gg.grouped_wgrad_ref(nan_x[sl], dh[sl], sparse[sl]),), TRAIN_TOL)
    if not torch.all(out[::13] == 0):
        raise AssertionError("wgrad: an empty slot's gradient is not zero")
    recs["grouped_wgrad"]["sparse_nan"] = dict(max_abs_err=e[0],
                                               max_abs_ref=e[1])
    del out
    dh2, dg2 = gg.grouped_swiglu_bwd(nan_x, w1, w3, nan_past(dact, rows),
                                     sparse)
    torch.cuda.synchronize()
    e = _slot_check("swiglu_bwd sparse", (dh2, dg2), lambda sl: (
        gg.grouped_swiglu_bwd_ref(x[sl], w1[sl], w3[sl], dact[sl],
                                  sparse[sl])), TRAIN_TOL)
    zeros_past("swiglu_bwd sparse dh", dh2, sparse)
    zeros_past("swiglu_bwd sparse dg", dg2, sparse)
    recs["grouped_swiglu_bwd"]["sparse_nan"] = dict(max_abs_err=e[0],
                                                    max_abs_ref=e[1])
    del x, w1, w3, dact, dh, dg, nan_x, dh2, dg2, pad
    torch.cuda.empty_cache()
    return recs


def phase_train_kernels(glm, deepseek, jamba) -> dict:
    """Phase 12: the backward kernels at the train steps' shapes against
    their plain versions, timed beside their bounds and a library call.

    Grouped (B1 swiglu_bwd, B2 matmul_nt, B3 wgrad): at each shape of
    GROUPED_BWD_SHAPES (:func:`_grouped_bwd_records`); the GLM train
    step's records are the kernels line's, the cells' stand beside them.
    Flash (B4): B 2, S 4096, 32 / 8 heads, hd 128, causal; dq, dk, dv
    within TRAIN_TOL of their max|ref| against autograd through the plain
    version.  B4 at (80, 80) too: HuBERT-XLarge's B 2, S 4096, 16 heads,
    bidirectional, bitwise over two calls, beside SDPA's backward (flash
    backend).  Bounds on the valid rows' (causal pairs') bf16 work or the
    bytes, whichever is larger; library: ``torch.bmm`` over the padded
    buffers, and SDPA's backward through autograd (flash backend, k/v
    expanded to 32 heads outside the timed call)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops as fa

    bf16 = torch.bfloat16
    cfgs = {"glm": glm, "deepseek": deepseek, "jamba": jamba}
    recs = {}
    for tag, name, tokens, cf in GROUPED_BWD_SHAPES:
        shape_recs = _grouped_bwd_records(cfgs[name], tokens, cf,
                                          10 if tag == "glm_train" else 4)
        for kernel, rec in shape_recs.items():
            if tag == "glm_train":
                recs[kernel] = rec
            else:
                recs[kernel][tag] = rec
    g = torch.Generator(device="cuda").manual_seed(12)

    # B4
    B, S, H, Hkv, hd = 2, 4096, 32, 8, 128
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(bf16)
    k = torch.randn((B, S, Hkv, hd), generator=g, device="cuda").to(bf16)
    v = torch.randn((B, S, Hkv, hd), generator=g, device="cuda").to(bf16)
    dout = torch.randn((B, S, H, hd), generator=g, device="cuda").to(bf16)
    lse = torch.empty((B, H, S), device="cuda")
    o, _ = fa._launch(q, k, v, True, 0, None, None, sms=1, lse=lse)
    grads = fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=True)
    again = fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=True)
    torch.cuda.synchronize()
    for n, a, r in zip("qkv", grads, again):
        if not torch.equal(a, r):
            raise AssertionError(f"flash_bwd d{n}: two calls differ")
    del again
    refs = fa.flash_attention_bwd_ref(q, k, v, dout, causal=True)
    errs = {n: _rel_check(f"flash_bwd d{n}", a, r, TRAIN_TOL)
            for n, a, r in zip("qkv", grads, refs)}
    del refs
    pairs = B * H * S * (S + 1) // 2
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt = k.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).detach() \
        .requires_grad_(True)
    vt = v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2).detach() \
        .requires_grad_(True)
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = dout.transpose(1, 2)
    t = _time_pair(
        lambda: fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=True),
        lambda: fa.flash_attention_bwd_ref(q, k, v, dout, causal=True),
        lambda: torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True),
        pairs * 5 * 2.0 * hd,
        2 * (4 * B * S * H * hd + 2 * B * S * Hkv * hd) + 4 * B * H * S
        + 2 * (B * S * H * hd + 2 * B * S * Hkv * hd), "bf16", 5)
    recs["flash_attention_bwd"] = dict(
        t, shape=dict(B=B, S=S, H=H, Hkv=Hkv, hd=hd, causal=True),
        max_abs_err=max(e[0] for e in errs.values()),
        errs={n: {"max_abs_err": e[0], "max_abs_ref": e[1]}
              for n, e in errs.items()},
        library_note="SDPA's backward through autograd (flash backend, "
                     "k/v expanded to 32 heads outside the timed call)",
        dq="second pass over the key tiles (TMA + wgmma, S and dP "
           "recomputed, no atomics): bitwise equal over two calls")
    del q, k, v, dout, o, lse, grads, qt, kt, vt, ot
    torch.cuda.empty_cache()
    recs["flash_attention_bwd.mla"] = _mla_bwd_record(g)
    recs["flash_attention_bwd.hd80"] = _hd80_bwd_record(g)
    recs["ssd_intra_chunk_bwd"] = _ssd_bwd_record()
    _line("phase12_train_kernels", recs)
    return recs


def _hd80_bwd_record(g) -> dict:
    """B4 at (80, 80), HuBERT-XLarge's train step: B 2, S 4096, 16 heads
    (G 1), bidirectional, the (128, 128) tiles with rows zero-filled past
    column 80 (``_flash_bwd_case``: against the plain version, bitwise over
    two calls, beside SDPA's backward on the flash backend, which takes
    head dim 80).  Bound on the true work: five products of 80 a pair."""
    import torch

    return dict(_flash_bwd_case(g, torch.bfloat16, 80, 80, False, 2, 4096,
                                16, 16, iters=5),
                padded_product_share=1 - 80 / 128)


def _mla_bwd_record(g) -> dict:
    """B4m at DeepSeek-V3's train cell: B 1, S 4096, 128 heads (G 1), q/k
    192, v 128, causal, MLA's scale, k and v strided views of one tensor as
    the model makes them; dq, dk, dv within TRAIN_TOL of autograd through
    the plain version, bitwise equal over two calls; timed beside SDPA's
    backward (memory-efficient backend: the flash backend takes one head
    dim), and each of its three kernels alone (``stage_ms``: prep, dK/dV,
    dQ, CUDA events around launches of one); ``ds_round_trip_ms``: the
    dS tiles' write and read at the HBM rate, bytes the design adds."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops as fa

    bf16 = torch.bfloat16
    B, S, H, hd, hv = 1, 4096, 128, 192, 128
    scale = hd ** -0.5
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(bf16)
    kv = torch.randn((B, S, H, hd + hv), generator=g, device="cuda").to(bf16)
    k, v = kv[..., :hd], kv[..., hd:]
    dout = torch.randn((B, S, H, hv), generator=g, device="cuda").to(bf16)
    lse = torch.empty((B, H, S), device="cuda")
    o, _ = fa._launch(q, k, v, True, 0, None, scale, sms=1, lse=lse)
    grads = fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=True,
                                   scale=scale)
    again = fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=True,
                                   scale=scale)
    torch.cuda.synchronize()
    for n, a, r in zip("qkv", grads, again):
        if not torch.equal(a, r):
            raise AssertionError(f"flash_bwd mla d{n}: two calls differ")
    del again
    refs = fa.flash_attention_bwd_ref(q, k, v, dout, causal=True,
                                      scale=scale)
    errs = {n: _rel_check(f"flash_bwd mla d{n}", a, r, TRAIN_TOL)
            for n, a, r in zip("qkv", grads, refs)}
    del refs, grads
    stage_ms = fa.bwd_stage_ms(q, k, v, o, dout, lse, causal=True,
                               scale=scale)
    pairs = B * H * S * (S + 1) // 2
    n_tri = -(-S // 64) * (-(-S // 64) + 1) // 2     # dS tiles a head
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt = k.transpose(1, 2).detach().requires_grad_(True)
    vt = v.transpose(1, 2).detach().requires_grad_(True)
    dot = dout.transpose(1, 2)
    library, library_error = None, None
    try:
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                scale=scale)
        torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

        def library():
            return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                       retain_graph=True)
    except RuntimeError as e:        # no SDPA backward at these head dims
        ot, library_error = None, str(e)[:300]
    t = _time_pair(
        lambda: fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=True,
                                       scale=scale),
        lambda: fa.flash_attention_bwd_ref(q, k, v, dout, causal=True,
                                           scale=scale),
        library,
        pairs * 2.0 * (hd + hv + hv + hd + hd),
        2 * (2 * B * S * H * hd + B * S * H * hv * 3) + 4 * B * H * S
        + 2 * (2 * B * S * H * hd + B * S * H * hv), "bf16", 5)
    rec = dict(t, shape=dict(B=B, S=S, H=H, Hkv=H, hd=hd, hd_v=hv,
                             causal=True),
               max_abs_err=max(e[0] for e in errs.values()),
               errs={n: {"max_abs_err": e[0], "max_abs_ref": e[1]}
                     for n, e in errs.items()},
               ds_round_trip_ms=2 * B * H * n_tri * 64 * 64 * 2
               / _hw().hbm_bw * 1e3,
               stage_ms=stage_ms,
               library_note="SDPA's backward through autograd "
                            "(memory-efficient backend; the flash backend "
                            "takes one head dim)",
               library_error=library_error)
    del q, kv, k, v, dout, o, lse, qt, kt, vt, ot
    torch.cuda.empty_cache()
    return rec


def _ssd_bwd_record(s=JAMBA_SSD, fp32_tol=TRAIN_TOL) -> dict:
    """B5 at Jamba-v0.1's train cell (B 1, T 4096: nc 32, Q 128, H 128, P 64,
    N 16; or the shape ``s``) in the model's bf16 inputs, and in fp32
    inputs beside: dxs, dB, dC, ddt, dda against the closed form and
    against autograd through the plain forward, within TRAIN_TOL of each
    max|ref| (``fp32_tol`` with fp32 inputs), bitwise equal over two
    calls; bound: the bytes of the dtypes the kernel sees, or the products
    at the TF32 rate (as the fp32 product rows are bounded), whichever is
    larger; the products at the fp32 CUDA-core rate beside, as
    ``cuda_core_fp32_ms`` (the rate of the first, CUDA-core version); no
    library call computes it."""
    import torch

    from repro_torch.kernels.ssd_scan import ops

    B, nc, Q, H, P, N = (s[k] for k in ("B", "nc", "Q", "H", "P", "N"))
    out = {}
    for tag, dtype, iters in (("bf16", torch.bfloat16, 10),
                              ("fp32", torch.float32, 5)):
        xs, Bm, Cm, dt, da, _ = _ssd_inputs(B, nc, Q, H, P, N, dtype, 21)
        g = torch.Generator(device="cuda").manual_seed(22)
        dy = torch.randn((B, nc, Q, H, P), generator=g, device="cuda")
        dS = torch.randn((B, nc, H, N, P), generator=g, device="cuda")
        ddec = torch.randn((B, nc, H), generator=g, device="cuda")
        args = (xs, Bm, Cm, dt, da, dy, dS, ddec)
        got = ops.ssd_intra_chunk_bwd(*args)
        again = ops.ssd_intra_chunk_bwd(*args)
        torch.cuda.synchronize()
        for n, a, r in zip(("xs", "Bm", "Cm", "dt", "da"), got, again):
            if not torch.equal(a, r):
                raise AssertionError(f"ssd_bwd {tag} d{n}: two calls differ")
        del again
        errs = {}
        for ref_name, ref in (("closed_form", ops.ssd_intra_chunk_bwd_ref),
                              ("autograd", ops._plain_bwd)):
            want = ref(*args)
            for n, a, r in zip(("xs", "Bm", "Cm", "dt", "da"), got, want):
                e = _rel_check(f"ssd_bwd {tag} d{n} vs {ref_name}", a, r,
                               fp32_tol if tag == "fp32" else TRAIN_TOL)
                errs[f"d{n}_vs_{ref_name}"] = {"max_abs_err": e[0],
                                               "max_abs_ref": e[1]}
            del want
        elt = xs.element_size()
        rows = B * nc * Q * H
        nbytes = (rows * (P + 2 * N) * elt * 2 + rows * 4 * 4 + rows * P * 4
                  + B * nc * H * (N * P + 1) * 4)
        pairs = B * nc * H * Q * (Q + 1) // 2
        flops = pairs * (4.0 * P + 6.0 * N + 10) + rows * 4.0 * N * P
        rec = _time_pair(lambda: ops.ssd_intra_chunk_bwd(*args),
                         lambda: ops.ssd_intra_chunk_bwd_ref(*args), None,
                         flops, nbytes, "tf32", iters)
        rec.update(shape=[B, nc, Q, H, P, N], dtype=tag,
                   cuda_core_fp32_ms=flops / _hw().peak("fp32") * 1e3,
                   max_abs_err=max(e["max_abs_err"] for e in errs.values()),
                   errs=errs, bytes_bound_ms=nbytes / _hw().hbm_bw * 1e3,
                   library_note="none: no PyTorch call computes it")
        out[tag] = rec
        del xs, Bm, Cm, dt, da, dy, dS, ddec, args, got
        torch.cuda.empty_cache()
    return dict(out["bf16"], fp32_inputs=out["fp32"])


def phase_train(glm) -> dict:
    """Phase 13: GLM-4.5-Air at every published width, depth cut to one
    layer (attention + MoE), trained on the card through
    ``repro_torch.launch.train.train``: bf16 weights, fp32 AdamW moments,
    ``ultraep`` at one EP rank, capacity factors 4.0, the synthetic stream
    from seed 0, batch 2 x 4096, TRAIN["steps"] steps, blocked loss in 8
    chunks.  First the step's gradient of every parameter against the same
    step with the plain versions' backward (``plain_backward``: autograd
    through the plain forwards, the forward kernels shared, so both runs
    route every token alike), within TRAIN_TOL of each tensor's max|ref|;
    then the run: every loss finite and each step's launches as
    TRAIN_LAUNCHES with no operand copied for TMA."""
    import gc

    import torch

    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.launch.train import train
    from repro_torch.models.model import init_lm
    from repro_torch.models.transformer import ParallelCtx, RuntimeConfig

    torch.cuda.empty_cache()
    cfg = dataclasses.replace(glm, name=f"{glm.name}-{TRAIN['layers']}l",
                              num_layers=TRAIN["layers"])
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                         cf_pair=4.0, cf_slot=4.0, dtype=torch.bfloat16,
                         loss_chunks=TRAIN["loss_chunks"], remat=False)
    pctx = ParallelCtx()
    params = init_lm(cfg, rcfg, pctx, torch.Generator(device="cuda")
                     .manual_seed(TRAIN["seed"]), device="cuda")
    params.requires_grad_(True)
    batch = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
        global_batch=TRAIN["batch"], seed=TRAIN["seed"])).batch(0)
    batch = {k: torch.from_numpy(v).to("cuda", torch.int64)
             for k, v in batch.items()}
    check = _grad_check(params, batch, cfg, rcfg, pctx)
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()

    per_step = []

    def on_metrics(step, m):
        torch.cuda.synchronize()
        per_step.append({"launches": _launches(), "copies": _padded_copies()})
        _reset_launches()

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    # No checkpoints: a full-width one is over 40 GB (phase 16 (d) holds
    # the Supervisor's checkpoints on the reduced GLM).
    run = train(cfg, steps=TRAIN["steps"], batch=TRAIN["batch"],
                seq=TRAIN["seq"], reduce=False, device="cuda",
                dtype=torch.bfloat16, loss_chunks=TRAIN["loss_chunks"],
                seed=TRAIN["seed"], log_every=TRAIN["steps"],
                on_metrics=on_metrics, ckpt_every=0, remat=False)
    import math
    if not all(math.isfinite(v) for v in run.losses):
        raise AssertionError(f"train: a loss is not finite: {run.losses}")
    for i, rec in enumerate(per_step):
        bad = {k: (rec["launches"][k], n) for k, n in TRAIN_LAUNCHES.items()
               if rec["launches"][k] != n}
        if bad or any(rec["copies"].values()):
            raise AssertionError(f"train step {i}: launches (seen, want) "
                                 f"{bad}, copies {rec['copies']}")
    result = {
        "model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": run.params, "dtype": "bfloat16", "optimizer": "adamw fp32",
        "batch": TRAIN["batch"], "seq": TRAIN["seq"],
        "loss_chunks": TRAIN["loss_chunks"], "losses": run.losses,
        "grad_norms": run.grad_norms, "step_s": run.step_s,
        "step_s_median_2_5": run.step_s_median,
        "tokens_per_s": run.tokens_per_s,
        "peak_mem_gb": run.peak_mem / 1e9,
        "launches_per_step": per_step[-1]["launches"],
        "grad_check": check}
    _line("phase13_train", result)
    gc.collect()
    torch.cuda.empty_cache()
    return result


# Phase 17: the train cells of ``launch/specs.py`` (``build_cell(arch,
# "train_4k", ParallelCtx(), num_layers_override=layers)``) at every
# published width, depth cut, global batch 1 x 4096, bf16, ``ultraep``,
# per-layer remat, Adafactor, the loss in 8 chunks.  DeepSeek-V3: 3 dense
# + 1 MoE layer (15.1 B parameters, 56.3 GiB of bf16 weights and
# gradients); Jamba-v0.1: its first 8-layer period (7 Mamba layers, the
# attention layer 4, MoE every other layer: 14.6 B).  Remat's saving is
# measured on Jamba's first two layers (mamba+dense, mamba+moe), where
# both fit.
TRAIN_CELLS = {"deepseek-v3-671b": 4, "jamba-v0.1-52b": 8}
REMAT_PEAK_CELL = ("jamba-v0.1-52b", 2)
CELL_RUN = dict(batch=1, loss_chunks=8, steps=3, seed=0)
# Launches of each wrapper in one step of each cell: every forward kernel
# twice (the forward, and the recompute of the backward's remat), each
# backward kernel once (B1 once, B2 twice, B3 three times a MoE layer; the
# flash backward once an attention layer, at (192, 128) for DeepSeek-V3's
# MLA and (128, 128) for Jamba's GQA; the SSD backward once a Mamba
# layer); no plan solve (R = 1).
def _cell_launches(moe, attn, mamba, dims):
    return {"gating_topk": 2 * moe, "grouped_swiglu": 2 * moe,
            "grouped_matmul": 2 * moe, "grouped_swiglu_bwd": moe,
            "grouped_matmul_nt": 2 * moe, "grouped_wgrad": 3 * moe,
            "flash_attention": 2 * attn,
            "flash_attention.prefill_wgmma": 2 * attn,
            "flash_attention_bwd": attn, f"flash_attention_bwd.{dims}": attn,
            "ssd_intra_chunk": 2 * mamba, "ssd_intra_chunk_bwd": mamba,
            "plan_solve": 0}


CELL_LAUNCHES = {"deepseek-v3-671b": _cell_launches(1, 4, 0, "192x128"),
                 "jamba-v0.1-52b": _cell_launches(4, 1, 7, "128x128")}


def _recording_blocks():
    """Patch ``transformer.block_apply`` to record each call's per-expert
    counts; returns (calls, restore).  Under remat a step calls it once a
    layer in the forward, then once a layer in the backward's recompute,
    in reverse layer order (with the checkpoint's early stop off)."""
    from repro_torch.models import transformer

    orig = transformer.block_apply
    calls = []

    def rec(*args, **kw):
        out = orig(*args, **kw)
        calls.append(out[3].detach().clone())
        return out

    transformer.block_apply = rec
    return calls, lambda: setattr(transformer, "block_apply", orig)


def _cell_check(tr, batch) -> dict:
    """The cell's gradient of every parameter with the backward kernels
    against the same step with ``plain_backward`` (the forward kernels
    shared, so both route alike), within TRAIN_TOL of each max|ref|; the
    kernel gradients wait on the host.  A second kernel run first: its
    loss, counts and every parameter's gradient must equal the first's bit
    for bit (the step sums in a fixed order: no atomics); and the remat
    recompute's counts against the forward's, layer by layer."""
    import torch

    from repro_torch.train.loop import loss_and_grads

    cfg, rcfg, pctx = tr.cfg, tr.rcfg, tr.pctx
    params, bias = tr.state.params, tr.state.router_bias
    named = [n for n, _ in params.named_parameters()]
    calls, restore = _recording_blocks()
    _reset_launches()
    try:
        # The recompute runs each block to its end (no early stop), so the
        # recorder sees its counts.
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            loss_k, drops_k, counts_k, grads = loss_and_grads(
                params, batch, cfg, rcfg, pctx, router_bias=bias)
        torch.cuda.synchronize()
    finally:
        restore()
    launches = _launches()
    L = cfg.num_layers
    if len(calls) != 2 * L:
        raise AssertionError(f"remat: {len(calls)} block calls, want {2 * L}")
    remat_mismatch = {i: int((calls[i] != calls[2 * L - 1 - i]).sum())
                      for i in range(L)}
    host = [g.to("cpu", non_blocking=True) for g in grads]
    torch.cuda.synchronize()
    del grads
    for p in params.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    loss_2, _, counts_2, grads_2 = loss_and_grads(params, batch, cfg, rcfg,
                                                  pctx, router_bias=bias)
    torch.cuda.synchronize()
    differ = [n for n, a, b in zip(named, host, grads_2)
              if _max_err_pieces(n, a, b)[0] != 0.0]
    again = {"loss_equal": bool(torch.equal(loss_k, loss_2)),
             "counts_equal": bool(torch.equal(counts_k, counts_2)),
             "params_differing": differ}
    if differ or not again["loss_equal"] or not again["counts_equal"]:
        raise AssertionError(f"cell rerun not bitwise: {again}")
    del grads_2
    for p in params.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    loss_p, _, counts_p, grads_p = loss_and_grads(
        params, batch, cfg, dataclasses.replace(rcfg, plain_backward=True),
        pctx,
        router_bias=bias)
    torch.cuda.synchronize()
    if not torch.equal(counts_p, counts_k):
        raise AssertionError("cell check: the two runs routed differently")
    errs = {}
    for name, gk, gp in zip(named, host, grads_p):
        err, scale = _max_err_pieces(name, gk, gp)
        errs[name] = err / max(scale, 1e-30)
    del grads_p, host
    for p in params.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    bad = {n: e for n, e in errs.items() if not e <= TRAIN_TOL}
    if bad or any(remat_mismatch.values()):
        raise AssertionError(f"cell grads beyond {TRAIN_TOL} of max|ref|: "
                             f"{bad}; remat count mismatches "
                             f"{remat_mismatch}")
    return {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
            "drops": int(drops_k), "worst": max(errs, key=errs.get),
            "worst_rel_err": max(errs.values()),
            "max_rel_err_by_param": errs, "launches": launches,
            "remat_count_mismatches": sum(remat_mismatch.values()),
            "remat_mismatch_by_layer": remat_mismatch,
            "rerun": again}


def _max_err_pieces(name, host, ref) -> tuple[float, float]:
    """``_max_err`` of a host tensor against a device one, a slice of at
    most 2^26 elements at a time (beside two sets of DeepSeek-V3's
    gradients there is no room for an expert weight's fp32 copies); raises
    if the host tensor holds a non-finite value."""
    import torch

    err = scale = 0.0
    h, r = host.reshape(-1), ref.reshape(-1)
    for lo in range(0, h.numel(), 1 << 26):
        a = h[lo:lo + (1 << 26)].to(r.device)
        if not torch.isfinite(a).all():
            raise AssertionError(f"cell grad {name} is not finite")
        e, sc = _max_err(a, r[lo:lo + (1 << 26)])
        err, scale = max(err, e), max(scale, sc)
    return err, scale


def _cell_peak(tr, batch, remat: bool) -> float:
    """Peak device memory (GB) of one loss_and_grads of the cell, with the
    state already resident."""
    import torch

    from repro_torch.train.loop import loss_and_grads

    for p in tr.state.params.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    loss_and_grads(tr.state.params, batch, tr.cfg,
                   dataclasses.replace(tr.rcfg, remat=remat), tr.pctx,
                   router_bias=tr.state.router_bias)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    for p in tr.state.params.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    return peak


def phase_train_cells() -> dict:
    """Phase 17: each train cell of TRAIN_CELLS on the card, from
    ``build_cell`` (its runtime: bf16, remat, capacity factors 2.0; its
    optimizer: Adafactor): (a) DeepSeek-V3 and (b) Jamba-v0.1 each get the
    gradient check of :func:`_cell_check` (a model from
    ``launch.train.build_cell_trainer``), then CELL_RUN["steps"] steps
    through ``launch.train.train_cell(arch, "train_4k")`` (the Supervisor,
    no checkpoints) with every loss finite and each step's launches as
    CELL_LAUNCHES, the steps' host seconds and peak memory; (c) the remat
    recompute's counts against the forward's (0 mismatches) in both, and
    the peak memory of one forward and backward of REMAT_PEAK_CELL with
    remat on and off."""
    import gc
    import math

    import torch

    from repro_torch.configs.base import layer_kinds
    from repro_torch.launch.specs import build_cell
    from repro_torch.launch.train import build_cell_trainer, train_cell
    from repro_torch.models.transformer import ParallelCtx

    def cell_trainer(arch, layers):
        return build_cell_trainer(build_cell(
            arch, "train_4k", ParallelCtx(), num_layers_override=layers,
            rcfg_overrides={"loss_chunks": CELL_RUN["loss_chunks"]}),
            batch=CELL_RUN["batch"], seed=CELL_RUN["seed"])

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {}
    for arch, layers in TRAIN_CELLS.items():
        free()
        t0 = time.perf_counter()
        tr = cell_trainer(arch, layers)
        kinds, opt = layer_kinds(tr.cfg), type(tr.state.opt_state).__name__
        check = _cell_check(tr, tr.batch(0))
        check_s = time.perf_counter() - t0
        del tr
        free()
        per_step = []

        def on_metrics(step, m):
            torch.cuda.synchronize()
            per_step.append(_launches())
            _reset_launches()

        _reset_launches()
        run = train_cell(arch, "train_4k", layers=layers,
                         batch=CELL_RUN["batch"], steps=CELL_RUN["steps"],
                         loss_chunks=CELL_RUN["loss_chunks"],
                         seed=CELL_RUN["seed"], device="cuda",
                         ckpt_every=0, log_every=CELL_RUN["steps"],
                         on_metrics=on_metrics)
        if not all(math.isfinite(v) for v in run.losses):
            raise AssertionError(f"{arch} cell: a loss is not finite: "
                                 f"{run.losses}")
        want = CELL_LAUNCHES[arch]
        for i, rec in enumerate(per_step):
            bad = {k: (rec[k], n) for k, n in want.items() if rec[k] != n}
            if bad:
                raise AssertionError(f"{arch} cell step {i}: launches "
                                     f"(seen, want) {bad}")
        out[arch] = {
            "layers": layers, "kinds": kinds, "params": run.params,
            "optimizer": opt, "batch": CELL_RUN["batch"],
            "seq": run.tokens_per_step // CELL_RUN["batch"],
            "losses": run.losses, "step_s": run.step_s,
            "step_s_median": run.step_s_median,
            "tokens_per_s": run.tokens_per_s,
            "peak_mem_gb": run.peak_mem / 1e9, "check_s": check_s,
            "launches_per_step": per_step[-1], "grad_check": check}
        _line(f"phase17_train_cell {arch}", {
            k: v for k, v in out[arch].items() if k != "grad_check"}
            | {"grad_check": {k: v for k, v in check.items()
                              if k != "max_rel_err_by_param"}})
        free()
    arch, layers = REMAT_PEAK_CELL
    tr = cell_trainer(arch, layers)
    batch = tr.batch(0)
    out["remat_peak_gb"] = {"arch": arch, "layers": layers,
                            "on": _cell_peak(tr, batch, True),
                            "off": _cell_peak(tr, batch, False)}
    _line("phase17_remat_peak", out["remat_peak_gb"])
    del tr, batch
    free()
    return out


# Phase 16: the trainer on groups of two processes on the one card.  Cases:
# name -> (data rows, EP ranks, global batch rows of TRAIN_GROUP["seq"]).
# At init the stream's hottest expert takes 3,799 of a row's 4,096 tokens,
# so at capacity factors 4.0 the layer drops 42% of its items, and which
# ones depends on R (capacities and plan): the gradient checks run at
# GROUP_CHECK_CF, where nothing drops at R = 1 or 2; the train step runs at
# TRAIN_GROUP["cf"], phase 13's.
TRAIN_GROUP = dict(layers=1, seq=4096, loss_chunks=8, seed=0, ranks=2,
                   cf=4.0)
GROUP_CHECK_CF = 16.0
GROUP_CASES = {"a": (1, 2, 1), "b": (2, 1, 2)}
# Each rank's launches in one train step: phase 13's forward and backward
# kernels, and the plan solve once a MoE layer at EP 2 (none at EP 1).
GROUP_LAUNCHES = {"a": {**TRAIN_LAUNCHES, "plan_solve": 1},
                  "b": dict(TRAIN_LAUNCHES)}
# (d): the Supervisor on the reduced GLM (head dim 128, the backward
# kernel's), bf16, EP 2: steps, checkpoint interval, the step whose run
# raises on every rank, batch, sequence (2 x 2048: enough q tiles for the
# wgmma prefill kernel, whose logsumexp the backward reads).
SUPERVISED = dict(steps=4, every=2, fault_at=3, batch=2, seq=2048)


def _group_cfgs(glm, cf):
    """Phase 16's model: GLM-4.5-Air at every published width, one layer,
    bf16, capacity factors ``cf``, blocked loss; the aux loss off (the
    reference sums each rank's aux, so with it a group's loss differs from
    one rank's by construction) and the aux-free router bias on."""
    import torch

    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.models.transformer import RuntimeConfig

    cfg = dataclasses.replace(
        glm, name=f"{glm.name}-{TRAIN_GROUP['layers']}l",
        num_layers=TRAIN_GROUP["layers"],
        moe=dataclasses.replace(glm.moe, aux_loss_weight=0.0, use_bias=True))
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                         cf_pair=cf, cf_slot=cf, dtype=torch.bfloat16,
                         loss_chunks=TRAIN_GROUP["loss_chunks"], remat=False)
    return cfg, rcfg


def _group_batch(cfg, rows):
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream

    b = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_GROUP["seq"],
        global_batch=2, seed=TRAIN_GROUP["seed"])).batch(0)
    return {k: torch.from_numpy(v[:rows]).to("cuda", torch.int64)
            for k, v in b.items()}


def _bias_after(cfg, counts):
    """The router bias after one step from zeros (``make_train_step``'s
    update)."""
    import torch

    from repro_torch.models.model import init_router_bias
    from repro_torch.moe.gating import update_router_bias

    bias = init_router_bias(cfg, device="cuda")
    upd = update_router_bias(bias, counts, cfg.moe.bias_update_speed)
    return torch.where((counts.sum(dim=1) > 0)[:, None], upd, bias)


# On the sharded layout a model axis of T > 1 splits wo's and w2's
# products over ranks, and their bf16 partial sums (reduced in bf16, as the
# reference reduces them) round otherwise than one rank's product, so a
# token whose k-th and (k + 1)-th router scores nearly tie may route apart
# from the R = 1 run.  Each token apart must be a near tie of the R = 1
# gate: its relative top-k gap (``_topk_gap``) among the lowest
# NEAR_TIE_SHARE of the R = 1 gaps of the same tokens.  The same test must
# fail a planted fault: PLANTED_TOKENS tokens that route alike, each given
# one other expert.  The share is set from two readings (PERF.md §6):
# the shares of the tokens a sound run routes apart on an H100, and a
# planted token's, which falls anywhere among the R = 1 gaps, so a fault
# of PLANTED_TOKENS tokens passes with probability 0.25^8 (1.5e-5).
# Where the counts differ, the router bias after the step is held to the
# update of the run's own counts.
NEAR_TIE_SHARE = 0.25
PLANTED_TOKENS = 8


class _GateInputs:
    """Records each MoE call's router input (this rank's tokens), its
    gating config, router and bias while installed."""

    def __enter__(self):
        from repro_torch.moe.layer import MoEParams

        self.calls, self.drops, self._orig = [], [], MoEParams.forward
        orig = self._orig

        def forward(mp, x, cfg, **kw):
            y, aux, st = orig(mp, x, cfg, **kw)
            self.calls.append((x.detach(), cfg.gating, mp.router.detach(),
                               kw.get("router_bias")))
            self.drops.append(int(st.drops_dispatch + st.drops_slot))
            return y, aux, st

        MoEParams.forward = forward
        return self

    def __exit__(self, *exc):
        from repro_torch.moe.layer import MoEParams

        MoEParams.forward = self._orig


def _gate_all(call, pctx, rows: int):
    """The R = 1 gate on every rank's router inputs of one recorded call
    (``rows`` rows of the sequence on this rank), gathered over the model
    axis (the sequence) and the data axis (the rows) in the global batch's
    row-major token order."""
    from repro_torch.moe.gating import gate
    from repro_torch.parallel import collectives

    x, gcfg, router, bias = call
    x = x.reshape(rows, -1, x.shape[-1])
    if pctx.group is not None:
        x = collectives.all_gather(pctx.group, x.contiguous()) \
            .transpose(0, 1).flatten(1, 2)
    if pctx.data is not None:
        x = collectives.all_gather(pctx.data, x.contiguous()).flatten(0, 1)
    return gate(x.flatten(0, 1), router, gcfg, bias=bias)


def _topk_gap(scores, call):
    """Each token's gap between its k-th and (k + 1)-th selection score
    (the scores plus the router bias), relative to the k-th: how near its
    routing is to a tie."""
    import torch

    _x, gcfg, _router, bias = call
    sel = scores.float() + (bias.float() if gcfg.use_bias and bias
                            is not None else 0.0)
    top = torch.topk(sel, gcfg.top_k + 1, dim=-1).values
    kth = top[:, -2]
    return ((kth - top[:, -1]) / kth.abs().clamp(min=1e-30)).cpu()


def _sorted_ids(gates) -> "torch.Tensor":
    """Each token's experts, sorted, of the gates of every MoE layer
    (layer-major, then the global token order), on the host."""
    import torch

    return torch.cat([g.expert_ids.sort(-1)[0].cpu() for g in gates])


def _r1_routing(calls, layers: int) -> dict:
    """The R = 1 run's routing, token by token, from its recorded calls
    (one a layer a microbatch of one row, in row order): each call gated
    again, its sorted ids and top-k gaps, layer-major, then the global
    token order."""
    import torch

    from repro_torch.models.transformer import ParallelCtx

    if not layers:
        return {"ids": None, "gap": None}
    by_layer = [calls[i::layers] for i in range(layers)]
    gates = [[(_gate_all(c, ParallelCtx(), 1), c) for c in cs]
             for cs in by_layer]
    return {"ids": _sorted_ids([g for gs in gates for g, _ in gs]),
            "gap": torch.cat([_topk_gap(g.scores, c) for gs in gates
                              for g, c in gs])}


def _routing_check(ids, ref_ids, ref_gap, num_experts: int) -> dict:
    """Each token's sorted experts (one row a token) against the R = 1
    run's: the tokens routed apart, each one's R = 1 top-k gap as the share
    of R = 1 gaps below it, and whether every one is a near tie (share at
    most NEAR_TIE_SHARE); then the same test on a planted fault, which
    must fail (``ok`` needs both)."""
    import torch

    order = ref_gap.sort().values

    def shares(t):
        return torch.searchsorted(order, ref_gap[t]).double() / len(order)

    apart = (ids != ref_ids).any(-1)
    sh = shares(apart).sort().values
    out = {"tokens": len(ids), "tokens_apart": int(apart.sum()),
           "near_tie_share": NEAR_TIE_SHARE,
           "near_tie_gap": float(order[int(NEAR_TIE_SHARE
                                           * (len(order) - 1))]),
           "apart_gap_shares": [round(float(x), 5) for x in sh],
           "apart_gap_max": float(ref_gap[apart].max()) if apart.any()
           else 0.0,
           "near_ties": bool((sh <= NEAR_TIE_SHARE).all())}
    alike = (~apart).nonzero().flatten()
    pick = alike[torch.randperm(len(alike), generator=torch.Generator()
                                .manual_seed(0))[:PLANTED_TOKENS]]
    planted = ids.clone()
    for t in pick.tolist():
        row = set(planted[t].tolist())
        planted[t, 0] = next(e for e in range(num_experts) if e not in row)
    planted = planted.sort(-1).values
    psh = shares((planted != ref_ids).any(-1))
    out["planted"] = {
        "tokens": len(pick),
        "gap_shares": sorted(round(float(x), 5) for x in shares(pick)),
        "caught": not bool((psh <= NEAR_TIE_SHARE).all())}
    out["ok"] = out["near_ties"] and out["planted"]["caught"]
    return out


def _counts_check(counts, ref, calls, pctx, rows: int) -> dict:
    """Counts against the R = 1 step's (``ref``): equal where the model
    axis is 1.  Else two checks: the run's counts
    are the R = 1 gate's on the run's own router inputs (every rank's,
    gathered; this checks how the counts are summed over ranks, not the
    routing), and each token those inputs route apart from the R = 1
    step is a near tie of the R = 1 gate (``_routing_check``)."""
    import torch

    diff = int((counts.cpu() - ref["counts"]).abs().sum())
    out = {"counts_diff": diff, "counts_equal": diff == 0}
    if pctx.ep_size == 1 or not calls:
        out["counts_ok"] = diff == 0
        return out
    moe = counts.sum(dim=1) > 0
    gates = [_gate_all(c, pctx, rows) for c in calls]
    out["counts_summed_as_gated"] = bool(torch.equal(
        counts[moe].cpu(), torch.stack([g.counts for g in gates]).cpu()))
    out["routing"] = _routing_check(_sorted_ids(gates), ref["ids"],
                                    ref["gap"], calls[0][1].num_experts)
    out["counts_ok"] = out["counts_summed_as_gated"] \
        and out["routing"]["ok"]
    return out


def _bias_check(bias, ref_bias, cfg, counts, counts_equal: bool) -> dict:
    """The router bias after one step: the R = 1 step's where the counts
    equal R = 1's; else (tokens routed apart at near ties,
    ``_counts_check``) the update of the run's own counts, with the
    entries apart from R = 1's counted."""
    import torch

    out = {"equal_r1": torch.equal(bias.cpu(), ref_bias),
           "entries_apart_r1": int((bias.cpu() != ref_bias).sum()),
           "equal_own_update": torch.equal(bias, _bias_after(cfg, counts))}
    out["ok"] = out["equal_r1"] if counts_equal \
        else out["equal_own_update"]
    return out


def _group_case(rank, name, mesh, glm, ref_path):
    """One case of phase 16 on one rank: the global gradient against the
    R = 1 step's (``ref_path``), then one train step with the kernel counts
    set to 0 before it and read after."""
    import gc

    import torch

    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.model import init_lm
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.train.loop import (global_grads, init_train_state,
                                        make_train_step)

    cfg, rcfg = _group_cfgs(glm, GROUP_CHECK_CF)
    pctx = pctx_for_mesh(mesh)
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(cfg, rcfg, pctx, torch.Generator(device="cuda")
                     .manual_seed(TRAIN_GROUP["seed"]), device="cuda")
    params.requires_grad_(True)
    batch = _group_batch(cfg, GROUP_CASES[name][2])
    with _GateInputs() as rec:
        loss, drops, counts, grads = global_grads(params, batch, cfg, rcfg,
                                                  pctx)
    ref = torch.load(ref_path, mmap=True)
    rows = GROUP_CASES[name][2] // pctx.data_size
    errs = {}
    specs = sharding.lm_param_specs(params, pctx)
    for (pname, _), g, sp in zip(params.named_parameters(), grads, specs):
        r = sharding.cut(ref["grads"][pname], sp.dims).to("cuda")
        if not torch.isfinite(g).all():
            raise AssertionError(f"group {name} rank {rank}: grad {pname} "
                                 f"is not finite")
        err, scale = _max_err(g, r)
        errs[pname] = err / max(scale, 1e-30)
        del r
    check = {"loss": float(loss), "loss_r1": float(ref["loss"]),
             "loss_rel_err": abs(float(loss) - float(ref["loss"]))
             / abs(float(ref["loss"])),
             **_counts_check(counts, ref, rec.calls, pctx, rows),
             "drops": int(drops), "drops_r1": int(ref["drops"]),
             "max_rel_err_by_param": errs, "worst": max(errs, key=errs.get)}
    del rec
    fails = []
    if any(not e <= TRAIN_TOL for e in errs.values()) or check["drops"] \
            or not check["counts_ok"] \
            or not check["loss_rel_err"] <= TRAIN_TOL:
        fails.append(f"against the R = 1 step (tolerance {TRAIN_TOL}): "
                     f"{check}")
    for p in params.parameters():
        p.grad = None
    del grads, ref
    gc.collect()
    peak_check = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    _, rcfg = _group_cfgs(glm, TRAIN_GROUP["cf"])
    opt = adamw(1e-3)
    state = init_train_state(params, opt, cfg)
    step = make_train_step(cfg, rcfg, pctx, opt)
    torch.cuda.synchronize()
    _reset_launches()
    state, m = step(state, batch)
    torch.cuda.synchronize()
    launches, copies = _launches(), _padded_copies()
    ref = torch.load(ref_path, mmap=True)
    bias = _bias_check(state.router_bias, ref["bias"], cfg, counts,
                       check["counts_equal"])
    bad = {k: (launches[k], n) for k, n in GROUP_LAUNCHES[name].items()
           if launches[k] != n}
    if bad or any(copies.values()) or not bias["ok"]:
        fails.append(f"launches (seen, want) {bad}, copies {copies}, "
                     f"router bias {bias}")
    if fails:
        raise AssertionError(f"group {name} rank {rank}: "
                             + "; ".join(fails))
    moments = sum(t.numel() for t in state.opt_state.mu)
    out = {"data": pctx.data_size, "ep": pctx.ep_size,
           "global_batch": [GROUP_CASES[name][2], TRAIN_GROUP["seq"]],
           "params_a_rank": sum(p.numel() for p in params.parameters()),
           "moment_elems_a_rank": moments, "grad_check": check,
           "check_cf": GROUP_CHECK_CF, "step_cf": TRAIN_GROUP["cf"],
           "step_loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "step_drops": int(m["drops"]), "router_bias": bias,
           "launches": {k: launches[k] for k in GROUP_LAUNCHES[name]},
           "peak_mem_gb_check": peak_check,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del state, params, m, ref, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _supervised(rank, mesh, glm, out_dir):
    """Phase 16 (d) on one rank: the Supervisor on the reduced GLM (head
    dim 128, bf16) at EP 2, clean and with a RuntimeError raised on every
    rank after step SUPERVISED["fault_at"] has run."""
    import torch

    from repro_torch.configs.reduce import reduced
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.launch.train import train

    cfg = dataclasses.replace(reduced(glm), head_dim=128)
    pctx = pctx_for_mesh(mesh)
    sv = SUPERVISED

    def inject(fn):
        left = [1]

        def step(state, batch):
            at = state.step
            out = fn(state, batch)
            if at == sv["fault_at"] and left[0]:
                left[0] = 0
                raise RuntimeError("injected fault")
            return out
        return step

    runs = {}
    for tag, hook in (("clean", None), ("faulty", inject)):
        seen = []
        run = train(cfg, steps=sv["steps"], batch=sv["batch"], seq=sv["seq"],
                    reduce=False, device="cuda", dtype=torch.bfloat16,
                    ckpt_dir=str(Path(out_dir) / f"ckpt_{tag}"),
                    ckpt_every=sv["every"], log_every=100, pctx=pctx,
                    step_hook=hook, lr=1e-3, remat=False,
                    on_metrics=lambda s, m: seen.append((s, float(m["loss"]))))
        runs[tag] = {"steps": [s for s, _ in seen],
                     "losses": [v for _, v in seen],
                     "restarts": run.restarts, "final_step": run.final_step}
    clean = dict(zip(runs["clean"]["steps"], runs["clean"]["losses"]))
    rel = [abs(v - clean[s]) / abs(clean[s])
           for s, v in zip(runs["faulty"]["steps"], runs["faulty"]["losses"])]
    want = [0, 1, 2, 2, 3]
    if runs["faulty"]["steps"] != want or runs["faulty"]["restarts"] != 1 \
            or not max(rel) <= 1e-3:
        raise AssertionError(f"supervised rank {rank}: {runs}, replay "
                             f"rel err {rel}")
    return {"model": cfg.name, "head_dim": 128, "runs": runs,
            "max_replay_rel_err": max(rel),
            "replay_bitwise": max(rel) == 0.0}


def _group_worker(rank, world, port, out_dir):
    """One rank of phase 16 (a spawned process on the one card)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    collectives.init("gloo", world_size=world, rank=rank,
                     init_method=f"tcp://localhost:{port}", timeout_s=600)
    glm = get_config("glm45-106b-a12b")
    meshes = {n: make_test_mesh(d, e) for n, (d, e, _) in GROUP_CASES.items()}
    out = {n: _group_case(rank, n, meshes[n], glm,
                          str(Path(out_dir) / f"ref_{n}.pt"))
           for n in GROUP_CASES}
    out["d"] = _supervised(rank, meshes["a"], glm, out_dir)
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    collectives.destroy()


def phase_train_group(glm) -> dict:
    """Phase 16: the trainer on groups of two processes on the one card
    (spawn; one gloo group carrying CUDA tensors, as phase 9), on the
    reference's layout (tensor parallelism over the model axis, FSDP over
    the data axis).  GLM-4.5-Air
    at every published width, depth cut to one layer (attention + MoE),
    bf16 weights, fp32 AdamW moments of each parameter's shard,
    ``ultraep``, blocked loss in 8 chunks, the synthetic stream from seed 0; the aux loss off
    and the router bias on (``_group_cfgs``).  First the parent runs the
    R = 1 step on each global batch, a microbatch a row (so each row runs
    at a data rank's shapes), at GROUP_CHECK_CF, and keeps its loss,
    counts, gradients and bias update (``torch.save``, read back with
    ``mmap``).  Then, on each rank, (a) EP 2 x data 1, global batch 1 x
    4096, and (b) data 2 x EP 1, global batch 2 x 4096: at GROUP_CHECK_CF
    every gradient of the global loss within TRAIN_TOL of the R = 1
    gradient's max|ref| (a parameter's shard against the same slice of
    the reference), the loss within
    TRAIN_TOL relative, zero drops, the counts equal (where the model axis
    is 2, ``_counts_check``: summed over ranks as the run's own router
    inputs route, and each token routed apart from the R = 1 step a near
    tie of its gate); then one train step
    at capacity factors TRAIN_GROUP["cf"] whose launches are
    GROUP_LAUNCHES with no operand copied for TMA, and whose router bias
    equals the R = 1 step's.  (d) the Supervisor
    (``launch.train.train``) on the reduced GLM at head dim 128 (the
    backward kernel's) at EP 2: 4 steps, a checkpoint every 2, a
    RuntimeError on every rank after step 3; the run restores step 2 and
    replays, each replayed loss within 1e-3 relative of the clean run's.
    (d) runs reduced because a full-width checkpoint is over 40 GB of disk
    writes a save, and the checkpointer is host code.  Each process's peak
    memory is printed; no time is stated: gloo stages CUDA tensors through
    the host."""
    import gc
    import os
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.models.model import init_lm
    from repro_torch.models.transformer import ParallelCtx
    from repro_torch.train.loop import TrainConfig, loss_and_grads

    cfg, rcfg = _group_cfgs(glm, GROUP_CHECK_CF)
    world = TRAIN_GROUP["ranks"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
        params = init_lm(cfg, rcfg, ParallelCtx(), torch.Generator(
            device="cuda").manual_seed(TRAIN_GROUP["seed"]), device="cuda")
        params.requires_grad_(True)
        for name, (_, _, rows) in GROUP_CASES.items():
            # A microbatch a row: each row runs at a data rank's shapes.
            with _GateInputs() as rec:
                loss, drops, counts, grads = loss_and_grads(
                    params, _group_batch(cfg, rows), cfg, rcfg,
                    ParallelCtx(), TrainConfig(microbatches=rows))
            torch.save({"loss": float(loss), "drops": int(drops),
                        "counts": counts.cpu(),
                        **_r1_routing(rec.calls,
                                      int((counts.sum(dim=1) > 0).sum())),
                        "bias": _bias_after(cfg, counts).cpu(),
                        "grads": {n: g.cpu() for (n, _), g in
                                  zip(params.named_parameters(), grads)}},
                       Path(out_dir) / f"ref_{name}.pt")
            del rec
            for p in params.parameters():
                p.grad = None
            del grads
        del params
        gc.collect()
        torch.cuda.empty_cache()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        # Two ranks near 38 GB each share the card: segments that grow in
        # place keep the allocator's fragments from tipping it over.
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            mp.spawn(_group_worker, args=(world, port, out_dir),
                     nprocs=world, join=True)
        finally:
            if alloc is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(world)]
    result = {"ranks": world, "backend": "gloo", "model": cfg.name,
              "time": "not stated (gloo stages CUDA tensors through the "
                      "host)",
              "peak_mem_gb_by_rank": {n: [r[n]["peak_mem_gb"] for r in ranks]
                                      for n in GROUP_CASES},
              "peak_mem_gb_check_by_rank": {
                  n: [r[n]["peak_mem_gb_check"] for r in ranks]
                  for n in GROUP_CASES},
              "supervisor_replay_bitwise": [r["d"]["replay_bitwise"]
                                            for r in ranks],
              "ranks_by_case": ranks}
    _line("phase16_train_group", result)
    return result


# Phase 20: the reference's layout on a mesh (one layout for every step):
# four processes on the one card, as phase 16's two.  (a) GLM-4.5-Air,
# phase 16's model, on a (data 2, model 2) mesh at a global batch of 2 x
# 4096; (b) DeepSeek-V3's first layer (MLA + the dense FFN of d_ff 18432),
# bf16, on a (data 1, model 2) mesh of ranks 0-1 at 1 x 4096.  A prefill
# chunk of TP_GROUP["chunk"] tokens a row into the sequence-sharded cache
# of chunk + decode positions, then TP_GROUP["decode"] decode steps (the
# next tokens of the batch), are checked beside each.
TP_GROUP = dict(glm_mesh=(2, 2), glm_rows=2, ds_mesh=(1, 2), ds_rows=1,
                ranks=4, chunk=512, decode=8)
# Each rank's launches in (a)'s train step (phase 16's EP 2 case: per
# rank one attention layer on its 16 query and 4 KV heads, one MoE layer
# on its sequence shard), in (b)'s gradient pass (one MLA layer on 64 of
# the 128 heads, forward and backward; no MoE), and in each prefill chunk
# (the flash kernel by the chunk's grid, recorded by kernel).
TP_LAUNCHES = {
    "glm_step": GROUP_LAUNCHES["a"],
    "ds_grad": {"flash_attention": 1, "flash_attention.prefill_wgmma": 1,
                "flash_attention_bwd": 1, "flash_attention_bwd.192x128": 1,
                "gating_topk": 0, "grouped_swiglu": 0, "plan_solve": 0},
    "glm_prefill": {"flash_attention": 1, "gating_topk": 1,
                    "grouped_swiglu": 1, "grouped_matmul": 1,
                    "plan_solve": 1},
    "ds_prefill": {"flash_attention": 1, "gating_topk": 0, "plan_solve": 0},
    # Each decode step: GLM's flash-decode partial of all 32 heads over
    # the rank's positions on the split-KV kernel with its logsumexp, the
    # replicated MoE island; DeepSeek's absorbed MLA decode (no flash).
    "glm_decode": {"flash_attention": 1, "flash_attention.decode_split": 1,
                   "flash_attention.lse": 1, "gating_topk": 1,
                   "grouped_swiglu": 1, "grouped_matmul": 1,
                   "plan_solve": 1},
    "ds_decode": {"flash_attention": 0, "gating_topk": 0, "plan_solve": 0},
}


def _tp_cfgs(which, glm, deepseek, cf):
    """Phase 20's models: (a) phase 16's GLM-4.5-Air layer; (b)
    DeepSeek-V3 cut to its first layer (attention + the dense FFN), bf16,
    blocked loss, remat off."""
    if which == "glm":
        return _group_cfgs(glm, cf)
    import torch

    from repro_torch.core.balancer import BalancerConfig
    from repro_torch.models.transformer import RuntimeConfig

    cfg = dataclasses.replace(deepseek, name=f"{deepseek.name}-1l",
                              num_layers=1)
    rcfg = RuntimeConfig(balancer=BalancerConfig(mode="ultraep", n_slot=2),
                         cf_pair=cf, cf_slot=cf, dtype=torch.bfloat16,
                         loss_chunks=TRAIN_GROUP["loss_chunks"], remat=False)
    return cfg, rcfg


def _tp_batch(cfg, rows):
    """``rows`` rows of the synthetic stream at 4096 tokens (seed 0)."""
    return _group_batch(cfg, rows)


def _resident_bytes(params, state, cfg, rcfg, pctx) -> dict:
    """This rank's parameter and AdamW bytes against what its placements
    give, each computed apart: a parameter's shard is ``shard_shape`` of
    its global shape (a meta init of the one-rank model), and its two fp32
    moments take the shard's shape (the reference's ``opt_state_specs``)."""
    import math

    from repro_torch.models.model import init_lm
    from repro_torch.models.transformer import ParallelCtx
    from repro_torch.parallel import sharding

    glob = {n: tuple(p.shape) for n, p in init_lm(
        cfg, rcfg, ParallelCtx(), None, device="meta").named_parameters()}
    ax = sharding.from_ctx(pctx)
    want_p = want_m = 0
    for name, p in params.named_parameters():
        n = math.prod(sharding.shard_shape(params.layout[name], glob[name],
                                           ax.sizes))
        want_p += n * p.element_size()
        want_m += 2 * 4 * n
    got_p = sum(p.numel() * p.element_size() for p in params.parameters())
    got_m = sum(t.numel() * t.element_size()
                for t in state.opt_state.mu + state.opt_state.nu)
    return {"param_bytes": got_p, "param_bytes_placed": want_p,
            "adamw_bytes": got_m, "adamw_bytes_placed": want_m,
            "equal": got_p == want_p and got_m == want_m}


class _RankPlan:
    """While installed, the flash kernel plans each launch as a rank of a
    model axis of ``model`` plans its share (``ops.plan_launch`` on the
    heads cut by the axis): an R = 1 run at a rank's batch shape then
    takes the rank's kernel, splits and row tiles, so each head's
    attention is computed as the rank computes it."""

    def __init__(self, model: int):
        self.model = model

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops

        orig = self._orig = ops.plan_launch
        t = self.model

        def plan(B, Sq, Sk, H, Hkv, hd, dtype, sms=ops.H100_SMS):
            return orig(B, Sq, Sk, H // t, max(1, Hkv // t), hd, dtype, sms)

        ops.plan_launch = plan
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attention import ops

        ops.plan_launch = self._orig


def _tp_gathered(logits, pctx, vocab_size):
    """A call's logits gathered over both axes of the mesh."""
    from repro_torch.models.model import gather_logits
    from repro_torch.parallel import collectives

    whole = gather_logits(logits, pctx, vocab_size)
    if pctx.data is not None:
        whole = collectives.all_gather(pctx.data, whole).flatten(0, 1)
    return whole


def _tp_prefill(params, cfg, rcfg, pctx, tokens):
    """One prefill chunk on the mesh: this rank's rows and sequence shard
    of ``tokens`` (rows x chunk) into the rank's shard of a cache of chunk
    + TP_GROUP["decode"] positions; the logits gathered over both axes,
    and the caches."""
    import torch

    from repro_torch.models.model import init_caches, prefill_step

    rows = tokens.shape[0] // pctx.data_size
    C, T, t = tokens.shape[1], pctx.ep_size, pctx.ep_rank
    mine = tokens[pctx.data_rank * rows:(pctx.data_rank + 1) * rows,
                  t * (C // T):(t + 1) * (C // T)]
    caches = init_caches(cfg, tokens.shape[0], C + TP_GROUP["decode"], rcfg,
                         device="cuda", pctx=pctx)
    with torch.no_grad():
        logits, caches = prefill_step(params, caches, mine, cfg, rcfg, pctx)
        return _tp_gathered(logits, pctx, cfg.vocab_size), caches


def _tp_decode(params, cfg, rcfg, pctx, caches, tokens):
    """TP_GROUP["decode"] decode steps on the mesh after the prefill
    chunk (``tokens`` rows x steps: each step's input, this rank's rows
    taken), each with the kernel counts set to 0 before and read after:
    (logits of every step gathered over both axes (rows, steps, V), the
    launches of each step, the caches)."""
    import dataclasses as dc

    import torch

    from repro_torch.models.model import decode_step

    rows = tokens.shape[0] // pctx.data_size
    mine = tokens[pctx.data_rank * rows:(pctx.data_rank + 1) * rows]
    whole = dc.replace(pctx, seq_whole=True)
    logits, launches = [], []
    with torch.no_grad():
        for i in range(tokens.shape[1]):
            torch.cuda.synchronize()
            _reset_launches()
            out, caches = decode_step(params, caches, mine[:, i:i + 1], cfg,
                                      rcfg, pctx)
            torch.cuda.synchronize()
            launches.append(_launches())
            logits.append(_tp_gathered(out, whole, cfg.vocab_size))
    return torch.cat(logits, dim=1), launches, caches


def _cache_bytes(caches, cfg, rcfg, pctx, rows: int) -> dict:
    """This rank's decode cache bytes against ``shard_shape`` of
    ``sharding.cache_specs`` (each entry's global shape from a meta init
    of the one-rank caches)."""
    import math

    from repro_torch.models.model import init_caches
    from repro_torch.parallel import sharding

    glob = init_caches(cfg, rows, TP_GROUP["chunk"] + TP_GROUP["decode"],
                       rcfg, device="meta")
    specs = sharding.cache_specs(cfg, sharding.from_ctx(pctx), rows)
    got = want = 0
    for entry, g, sp in zip(caches, glob, specs):
        for a, ga, spa in zip(entry, g, sp):
            got += a.numel() * a.element_size()
            want += math.prod(sharding.shard_shape(spa, ga.shape, dict(
                pctx.mesh_axes))) * ga.element_size()
    return {"cache_bytes": got, "cache_bytes_placed": want,
            "equal": got == want}


def _decode_check(logits, calls, ref, pctx, rows: int) -> dict:
    """The decode steps' gathered logits (rows, steps, V) against the R =
    1 steps' (``ref["decode"]``) under ``_prefill_check``'s rule: the
    tokens routed alike with the R = 1 steps within TRAIN_TOL of the
    steps' max|ref|, each token apart a near tie of the R = 1 gate.  The
    stream is whole at decode: each recorded call's inputs are the data
    rank's rows on every model rank, gathered over the data axis only."""
    import torch

    from repro_torch.moe.gating import gate
    from repro_torch.parallel import collectives

    ref_l = ref["decode"].to(logits.device)
    err, scale = _max_err(logits, ref_l)
    out = {"shape": list(logits.shape), "max_rel_err_whole": err / scale}
    apart = torch.zeros(logits.shape[:2], dtype=torch.bool)
    if calls:
        gates = []
        for x, gcfg, router, bias in calls:
            x = x.reshape(rows, -1)
            if pctx.data is not None:
                x = collectives.all_gather(pctx.data, x.contiguous()) \
                    .flatten(0, 1)
            gates.append(gate(x, router, gcfg, bias=bias))
        ids = _sorted_ids(gates)                   # step-major, then rows
        out["routing"] = _routing_check(ids, ref["decode_ids"],
                                        ref["decode_gap"],
                                        calls[0][1].num_experts)
        steps = logits.shape[1]
        apart = (ids != ref["decode_ids"]).any(-1).reshape(
            steps, -1, logits.shape[0]).any(1).T
    apart = apart.to(logits.device)
    for tag, m in (("alike", ~apart), ("apart", apart)):
        out[f"max_rel_err_{tag}"] = (_max_err(logits[m], ref_l[m])[0]
                                     / scale if m.any() else 0.0)
    out["ok"] = out["max_rel_err_alike"] <= TRAIN_TOL \
        and out.get("routing", {"ok": True})["ok"]
    return out


def _prefill_check(logits, calls, ref, pctx, rows: int) -> dict:
    """One prefill chunk's gathered logits against the R = 1 chunk's
    (``ref["prefill"]``) and against the witness (the R = 1 chunk on the
    rank's flash plan, ``_RankPlan``).  Without a MoE layer every token
    is held within TRAIN_TOL; with one, the tokens routed alike with the
    R = 1 chunk are, and each token routed apart must be a near tie of the
    R = 1 gate (``_routing_check``); the logits of the tokens apart and of
    the whole chunk are measured beside (relative to the whole chunk's
    max|ref|), and so is each token's routing against the witness."""
    import torch

    ref_l = ref["prefill"].to(logits.device)
    err, scale = _max_err(logits, ref_l)
    out = {"shape": list(logits.shape), "max_rel_err_whole": err / scale,
           "max_rel_err_whole_witness": _max_err(
               logits, ref["witness"].to(logits.device))[0] / scale}
    apart = torch.zeros(logits.shape[:2], dtype=torch.bool,
                        device=logits.device)
    if calls:
        ids = _sorted_ids([_gate_all(c, pctx, rows) for c in calls])
        out["routing"] = _routing_check(ids, ref["prefill_ids"],
                                        ref["prefill_gap"],
                                        calls[0][1].num_experts)
        out["tokens_apart_from_witness"] = int(
            (ids != ref["witness_ids"]).any(-1).sum())
        out["witness_tokens_apart_r1"] = ref["witness_tokens_apart_r1"]
        apart = (ids != ref["prefill_ids"]).any(-1).reshape(
            len(calls), -1).any(0).reshape(apart.shape).to(apart.device)
    for tag, m in (("alike", ~apart), ("apart", apart)):
        out[f"max_rel_err_{tag}"] = (_max_err(logits[m], ref_l[m])[0]
                                     / scale if m.any() else 0.0)
    out["ok"] = out["max_rel_err_alike"] <= TRAIN_TOL \
        and out.get("routing", {"ok": True})["ok"]
    return out


def _tp_case(rank, which, mesh, glm, deepseek, ref_path):
    """Phase 20 (a) or (b) on one rank: the global gradient against the
    R = 1 step's, one prefill chunk's logits against the R = 1 chunk's,
    the resident bytes against the placements, and for (a) one AdamW step
    at TRAIN_GROUP["cf"]; the kernel counts set to 0 before each run and
    read after.  Every check runs; the case fails at its end if any
    failed."""
    import gc

    import torch

    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.model import init_lm, init_router_bias
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding
    from repro_torch.train.loop import (global_grads, init_train_state,
                                        make_train_step)

    cfg, rcfg = _tp_cfgs(which, glm, deepseek, GROUP_CHECK_CF)
    pctx = pctx_for_mesh(mesh)
    rows = TP_GROUP[f"{which}_rows"]
    local_rows = rows // pctx.data_size
    torch.cuda.reset_peak_memory_stats()
    params = init_lm(cfg, rcfg, pctx, torch.Generator(device="cuda")
                     .manual_seed(TRAIN_GROUP["seed"]), device="cuda")
    params.requires_grad_(True)
    batch = _tp_batch(cfg, rows)
    bias = init_router_bias(cfg, device="cuda")
    torch.cuda.synchronize()
    _reset_launches()
    with _GateInputs() as rec:
        loss, drops, counts, grads = global_grads(params, batch, cfg, rcfg,
                                                  pctx, router_bias=bias)
    torch.cuda.synchronize()
    grad_launches = _launches()
    ref = torch.load(ref_path, mmap=True)
    errs = {}
    specs = sharding.lm_param_specs(params, pctx)
    for (pname, _), g, sp in zip(params.named_parameters(), grads, specs):
        r = sharding.cut(ref["grads"][pname], sp.dims)
        if not torch.isfinite(g).all():
            raise AssertionError(f"tp {which} rank {rank}: grad {pname} is "
                                 f"not finite")
        err, scale = _max_err_rows(g, r)
        errs[pname] = err / max(scale, 1e-30)
    check = {"loss": float(loss), "loss_r1": float(ref["loss"]),
             "loss_rel_err": abs(float(loss) - float(ref["loss"]))
             / abs(float(ref["loss"])),
             **_counts_check(counts, ref, rec.calls, pctx, local_rows),
             "drops": int(drops), "drops_r1": int(ref["drops"]),
             "max_rel_err_by_param": errs, "worst": max(errs, key=errs.get)}
    del rec
    fails = []
    if any(not e <= TRAIN_TOL for e in errs.values()) or check["drops"] \
            or not check["counts_ok"] \
            or not check["loss_rel_err"] <= TRAIN_TOL:
        fails.append(f"against the R = 1 step (tolerance {TRAIN_TOL}): "
                     f"{check}")
    for p in params.parameters():
        p.grad = None
    del grads
    gc.collect()
    peak_check = torch.cuda.max_memory_allocated() / 1e9
    C, steps = TP_GROUP["chunk"], TP_GROUP["decode"]
    tokens = batch["tokens"][:, :C]
    _reset_launches()
    with _GateInputs() as rec:
        logits, caches = _tp_prefill(params, cfg, rcfg, pctx, tokens)
    torch.cuda.synchronize()
    prefill_launches = _launches()
    prefill = {**_prefill_check(logits, rec.calls, ref, pctx, local_rows),
               "drops": sum(rec.drops),
               "drops_r1": int(ref["prefill_drops"])}
    del rec, logits
    if not prefill["ok"] or prefill["drops"]:
        fails.append(f"prefill logits (tolerance {TRAIN_TOL}): {prefill}")
    with _GateInputs() as rec:
        logits, decode_launches, caches = _tp_decode(
            params, cfg, rcfg, pctx, caches, batch["tokens"][:, C:C + steps])
    decode = {**_decode_check(logits, rec.calls, ref, pctx, local_rows),
              "drops": sum(rec.drops), "steps": steps,
              **_cache_bytes(caches, cfg, rcfg, pctx, rows)}
    del rec, logits, caches
    if not decode["ok"] or decode["drops"] or not decode["equal"]:
        fails.append(f"decode (tolerance {TRAIN_TOL}): {decode}")
    opt = adamw(1e-3)
    state = init_train_state(params, opt, cfg)
    resident = _resident_bytes(params, state, cfg, rcfg, pctx)
    if not resident["equal"]:
        fails.append(f"resident bytes {resident}")
    want = {"grad": TP_LAUNCHES["ds_grad"] if which == "ds" else None,
            "prefill": TP_LAUNCHES[f"{which}_prefill"]}
    want_dec = TP_LAUNCHES[f"{which}_decode"]
    bad = [{k: (seen[k], n) for k, n in want_dec.items() if seen[k] != n}
           for seen in decode_launches]
    if any(bad):
        fails.append(f"decode launches a step (seen, want) {bad}")
    out = {"mesh": dict(pctx.mesh_axes), "rank": rank,
           "global_batch": [rows, TRAIN_GROUP["seq"]],
           "prefill_chunk": list(tokens.shape), "grad_check": check,
           "check_cf": GROUP_CHECK_CF, "prefill_check": prefill,
           "decode_check": decode,
           "launches_decode_step": {k: decode_launches[0][k]
                                    for k in want_dec},
           "resident": resident, "peak_mem_gb_check": peak_check,
           "launches_grad": {k: grad_launches[k] for k in
                             (want["grad"] or TP_LAUNCHES["glm_step"])},
           "launches_prefill": {k: n for k, n in prefill_launches.items()
                                if k in want["prefill"]
                                or k.startswith("flash_attention.")}}
    if which == "glm":
        torch.cuda.reset_peak_memory_stats()
        _, rcfg = _tp_cfgs(which, glm, deepseek, TRAIN_GROUP["cf"])
        step = make_train_step(cfg, rcfg, pctx, opt)
        torch.cuda.synchronize()
        _reset_launches()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        want["step"] = TP_LAUNCHES["glm_step"]
        launches = _launches()
        out["launches_step"] = {k: launches[k] for k in want["step"]}
        out["padded_copies"] = _padded_copies()
        bias = _bias_check(state.router_bias, ref["bias"], cfg, counts,
                           check["counts_equal"])
        out.update(step_loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]),
                   step_drops=int(m["drops"]), step_cf=TRAIN_GROUP["cf"],
                   router_bias=bias,
                   peak_mem_gb_step=torch.cuda.max_memory_allocated() / 1e9)
        if not bias["ok"] or any(out["padded_copies"].values()):
            fails.append(f"router bias {bias}, copies "
                         f"{out['padded_copies']}")
    for kind, seen in (("grad", out["launches_grad"]),
                       ("prefill", out["launches_prefill"]),
                       ("step", out.get("launches_step"))):
        if want.get(kind) is None:
            continue
        bad = {k: (seen[k], n) for k, n in want[kind].items()
               if seen[k] != n}
        if bad:
            fails.append(f"{kind} launches (seen, want) {bad}")
    if fails:
        raise AssertionError(f"tp {which} rank {rank}: " + "; ".join(fails))
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, params, ref, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_worker(rank, world, port, out_dir):
    """One rank of phase 20 (a spawned process on the one card)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import collectives

    torch.backends.cuda.matmul.allow_tf32 = False
    collectives.init("gloo", world_size=world, rank=rank,
                     init_method=f"tcp://localhost:{port}", timeout_s=600)
    glm = get_config("glm45-106b-a12b")
    deepseek = get_config("deepseek-v3-671b")
    meshes = {"glm": make_test_mesh(*TP_GROUP["glm_mesh"]),
              "ds": make_test_mesh(*TP_GROUP["ds_mesh"])}
    out = {}
    for which, mesh in meshes.items():
        if mesh is not None:
            out[which] = _tp_case(rank, which, mesh, glm, deepseek,
                                  str(Path(out_dir) / f"tp_ref_{which}.pt"))
        collectives.barrier(collectives.EPGroup())
    with open(Path(out_dir) / f"tp_rank{rank}.json", "w") as f:
        json.dump(out, f)
    collectives.destroy()


def _r1_prefill(params, cfg, rcfg, tokens, steps: int = 0):
    """The R = 1 prefill chunk a row at a time (each row at a data rank's
    batch shape, as the R = 1 training step runs a microbatch a row) into
    a cache of chunk + TP_GROUP["decode"] positions: the logits (on the
    host), the routing (``_r1_routing``) and the drops; with ``steps``,
    then that many decode steps on the next tokens of ``tokens`` (rows x
    (chunk + steps)): their logits (rows, steps, V) and routing
    (step-major, then rows, as ``_decode_check`` gathers it)."""
    import torch

    from repro_torch.models.model import (decode_step, init_caches,
                                          prefill_step)
    from repro_torch.models.transformer import ParallelCtx

    C = tokens.shape[1] - steps
    logits, dec, dec_calls = [], [], []
    with torch.no_grad(), _GateInputs() as rec:
        for r in range(tokens.shape[0]):
            caches = init_caches(cfg, 1, C + TP_GROUP["decode"], rcfg,
                                 device="cuda")
            lg, caches = prefill_step(params, caches, tokens[r:r + 1, :C],
                                      cfg, rcfg, ParallelCtx())
            logits.append(lg.cpu())
            n = len(rec.calls)
            row = []
            for i in range(steps):
                lg, caches = decode_step(params, caches,
                                         tokens[r:r + 1, C + i:C + i + 1],
                                         cfg, rcfg, ParallelCtx())
                row.append(lg.cpu())
            if steps:
                dec.append(torch.cat(row, dim=1))
                dec_calls.append(rec.calls[n:])
                del rec.calls[n:]
            del caches
        layers = len(rec.calls) // tokens.shape[0]
        routing = _r1_routing(rec.calls, layers)
    out = {"prefill": torch.cat(logits), "routing": routing,
           "drops": sum(rec.drops)}
    if steps:
        out["decode"] = torch.cat(dec)
        per = len(dec_calls[0]) // steps            # MoE layers a step
        order = [cs[i] for i in range(steps * per) for cs in dec_calls]
        r1 = _r1_routing(order, 1) if per else {"ids": None, "gap": None}
        out["decode_ids"], out["decode_gap"] = r1["ids"], r1["gap"]
    return out


def phase_tp_group(glm, deepseek) -> dict:
    """Phase 20: the reference's production layout on a mesh
    (``repro_torch.parallel.sharding``, one layout for every step):
    tensor parallelism over the model axis (attention heads, the FFN's
    hidden dimension, the vocabulary), FSDP over the data axis, the
    sequence-parallel residual stream and the sequence-sharded decode
    cache (flash-decode over the model axis), in four spawned processes on the
    one card (one gloo group carrying CUDA tensors, as phases 9 and 16).
    First the parent runs the R = 1 references on each model (a
    microbatch a row, so each row runs at a data rank's shapes, as phase
    16), at GROUP_CHECK_CF: the loss, counts, every gradient, the router
    bias after one update, each token's routing, and one prefill chunk's
    logits and routing (the first TP_GROUP["chunk"] tokens of each row, a
    row at a time), plain and on the rank's flash plan (the witness),
    kept on disk, and its peak memory.  Then (a) GLM-4.5-Air's layer on (data 2, model 2), global
    batch 2 x 4096, and (b) DeepSeek-V3's first layer on (data 1, model 2)
    (ranks 0-1), 1 x 4096: every gradient of the global loss within
    TRAIN_TOL of the R = 1 gradient's max|ref| (each rank's shard against
    the same slice), the loss within TRAIN_TOL relative, zero drops, the
    counts as ``_counts_check`` holds them (each token routed apart a near
    tie of the R = 1 gate); the chunk's logits, gathered over both axes,
    as ``_prefill_check`` holds them (the tokens routed alike within
    TRAIN_TOL of the R = 1 chunk's max|ref|, each token apart a near tie;
    the whole chunk's error and the witness's routing measured beside);
    then TP_GROUP["decode"] decode steps on the next tokens, their
    logits against the R = 1 steps' by the same rule (``_decode_check``)
    and each rank's decode cache bytes equal to its ``cache_specs``
    shard's; each rank's parameter and AdamW bytes equal to what its
    placements give; for (a) one AdamW train step at TRAIN_GROUP["cf"],
    its router bias the R = 1 update's.
    The launches of each run are counted on every rank (TP_LAUNCHES).
    Each rank's peak memory is printed beside the R = 1 run's; no time is
    stated: gloo stages CUDA tensors through the host."""
    import gc
    import os
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    from repro_torch.models.model import init_lm, init_router_bias
    from repro_torch.models.transformer import ParallelCtx
    from repro_torch.train.loop import TrainConfig, loss_and_grads

    world = TP_GROUP["ranks"]
    torch.cuda.empty_cache()
    peak_r1 = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
        for which in ("glm", "ds"):
            cfg, rcfg = _tp_cfgs(which, glm, deepseek, GROUP_CHECK_CF)
            rows = TP_GROUP[f"{which}_rows"]
            torch.cuda.reset_peak_memory_stats()
            params = init_lm(cfg, rcfg, ParallelCtx(), torch.Generator(
                device="cuda").manual_seed(TRAIN_GROUP["seed"]),
                device="cuda")
            params.requires_grad_(True)
            batch = _tp_batch(cfg, rows)
            bias = init_router_bias(cfg, device="cuda")
            with _GateInputs() as rec:
                loss, drops, counts, grads = loss_and_grads(
                    params, batch, cfg, rcfg, ParallelCtx(),
                    TrainConfig(microbatches=rows), router_bias=bias)
            ref = {"loss": float(loss), "drops": int(drops),
                   "counts": counts.cpu(),
                   **_r1_routing(rec.calls,
                                 int((counts.sum(dim=1) > 0).sum())),
                   "bias": (_bias_after(cfg, counts).cpu()
                            if bias is not None else None),
                   "grads": {n: g.cpu() for (n, _), g in
                             zip(params.named_parameters(), grads)}}
            for p in params.parameters():
                p.grad = None
            del grads, rec
            gc.collect()
            C, steps = TP_GROUP["chunk"], TP_GROUP["decode"]
            tokens = batch["tokens"][:, :C + steps]
            # The R = 1 chunk and decode steps, then the chunk's witness
            # on the rank's flash plan.
            T = TP_GROUP[f"{which}_mesh"][1]
            for tag, plan, n in (("prefill", contextlib.nullcontext(), steps),
                                 ("witness", _RankPlan(T), 0)):
                with plan:
                    run = _r1_prefill(params, cfg, rcfg, tokens[:, :C + n],
                                      n)
                ref[tag], r1 = run["prefill"], run["routing"]
                ref[f"{tag}_drops"], ref[f"{tag}_ids"] = run["drops"], r1["ids"]
                if tag == "prefill":
                    ref["prefill_gap"] = r1["gap"]
                    ref.update({k: run[k] for k in ("decode", "decode_ids",
                                                    "decode_gap")})
            ref["witness_tokens_apart_r1"] = None if r1["ids"] is None \
                else int((ref["witness_ids"] != ref["prefill_ids"])
                         .any(-1).sum())
            torch.save(ref, Path(out_dir) / f"tp_ref_{which}.pt")
            peak_r1[which] = torch.cuda.max_memory_allocated() / 1e9
            del params, ref, batch
            gc.collect()
            torch.cuda.empty_cache()
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
        try:
            mp.spawn(_tp_worker, args=(world, port, out_dir), nprocs=world,
                     join=True)
        finally:
            if alloc is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
        ranks = [json.loads((Path(out_dir) / f"tp_rank{r}.json").read_text())
                 for r in range(world)]
    result = {"ranks": world, "backend": "gloo",
              "time": "not stated (gloo stages CUDA tensors through the "
                      "host)",
              "nvidia_smi": subprocess.run(
                  ["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"], capture_output=True, text=True,
                  timeout=60).stdout.strip(),
              "peak_mem_gb_r1": peak_r1,
              "peak_mem_gb_by_rank": {
                  w: [r[w]["peak_mem_gb"] for r in ranks if w in r]
                  for w in ("glm", "ds")},
              "resident_by_rank": {
                  w: [r[w]["resident"] for r in ranks if w in r]
                  for w in ("glm", "ds")},
              "launches_by_rank": {
                  w: [{k: r[w][k] for k in ("launches_grad",
                                            "launches_prefill",
                                            "launches_decode_step",
                                            "launches_step") if k in r[w]}
                      for r in ranks if w in r] for w in ("glm", "ds")},
              "ranks_by_case": ranks}
    _line("phase20_tp_group", result)
    return result


def _rack_params(rank, world, cfg, dev):
    """This rank's share of a DeepSeek-V3 MoE layer in bf16: the router,
    the shared expert and the routing bias from one seed on every rank,
    each rank's experts from a seed of its own (every group in phase 14
    runs on these same shares, so the calls compare with no R = 1 copy of
    all 256 experts)."""
    import torch

    from repro_torch.moe.layer import MoEParams

    bf16 = torch.bfloat16
    D, F, Fs = cfg.d_model, cfg.d_ff, cfg.shared_d_ff
    g = torch.Generator(device=dev).manual_seed(0)
    router = torch.randn((D, cfg.gating.num_experts), generator=g,
                         device=dev) * D ** -0.5
    bias = torch.randn((cfg.gating.num_experts,), generator=g,
                       device=dev) * 1e-2
    shared = [(torch.randn(shape, generator=g, device=dev, dtype=bf16)
               * fan ** -0.5) for shape, fan in (((D, Fs), D), ((D, Fs), D),
                                                  ((Fs, D), Fs))]
    ge = torch.Generator(device=dev).manual_seed(1000 + rank)
    epr = cfg.gating.num_experts // world
    experts = [(torch.randn((epr,) + shape, generator=ge, device=dev,
                            dtype=bf16) * fan ** -0.5)
               for shape, fan in (((D, F), D), ((D, F), D), ((F, D), F))]
    params = MoEParams(router, *experts, *shared, n_slot=cfg.balancer.n_slot)
    del experts
    return params, bias


def _rack_worker(rank, world, port, out_dir):
    """One rank of phase 14 (a spawned process on the one card): a flat
    gloo group of 4 and the same ranks factored as 2 racks x 2 lanes; calls
    (a)-(e) with the kernel counts set to 0 before each and read after, the
    plan tables against the plain solve and through the port's static
    check (and the rack limit's, in (c)), then the backward of (b) and
    (a)."""
    import collections
    import os

    # Four ranks share the card: segments that grow in place leave less of
    # it reserved and unused than the default allocator's (read when this
    # process first allocates on the card).
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch

    from repro_torch.analysis.plan_check import verify_plan, verify_rack_limit
    from repro_torch.analysis.violation import errors
    from repro_torch.configs import get_config
    from repro_torch.core import planner
    from repro_torch.core.topology import Topology
    from repro_torch.models.transformer import (
        ParallelCtx,
        RuntimeConfig,
        moe_config,
    )
    from repro_torch.moe import stages
    from repro_torch.moe.layer import moe_layer_local
    from repro_torch.parallel import collectives

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    flat = collectives.init("gloo", world_size=world, rank=rank,
                            init_method=f"tcp://localhost:{port}",
                            timeout_s=300)
    hier = collectives.factor(RACKS)
    dev = torch.device("cuda")
    ds = get_config("deepseek-v3-671b")
    T = RACK_TOKENS
    rcfg = RuntimeConfig(cf_pair=4.0, cf_slot=4.0, dtype=torch.bfloat16)
    limited = dataclasses.replace(rcfg, rack_limit=1)
    cfgs = {"a": moe_config(ds, rcfg, ParallelCtx(group=flat), T),
            "b": moe_config(ds, rcfg, ParallelCtx(group=hier), T),
            "c": moe_config(ds, limited, ParallelCtx(group=hier), T)}
    cfgs["c_flat"] = dataclasses.replace(cfgs["a"], gating=cfgs["c"].gating)
    cfgs["d"] = dataclasses.replace(cfgs["b"], overlap_chunks=2)
    cfgs["e"] = dataclasses.replace(cfgs["a"], dispatch_impl="reference")
    assert cfgs["b"].dispatch_mode == "hier_a2a" and cfgs["c"].gating.rack_binding
    groups = {n: hier if c.dispatch_mode == "hier_a2a" else flat
              for n, c in cfgs.items()}
    # One rank at a time builds its share (the transient copies of four
    # ranks at once would not fit the card beside each other).
    for r in range(world):
        if r == rank:
            params, bias = _rack_params(rank, world, cfgs["a"], dev)
            torch.cuda.empty_cache()
        collectives.all_reduce(flat, torch.zeros(1, device=dev))
    # The tokens lean toward experts 0-7 (homed on rank 0), half as hard as
    # phase 9's: at 2.0 the hottest expert's load (≈ 1160 items) passes a
    # slot's capacity (993 at cf 4) and no plan of 2 slots a rank keeps it
    # (a CPU simulation of this router); at 1.0 the largest quota is ≈ 670
    # and the plan still places 4-5 replicas.
    lean = params.router[:, :8].sum(dim=1)
    x_all = (torch.randn((world * T, ds.d_model), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
        + 1.0 * lean / lean.norm()).to(torch.bfloat16)
    x = x_all[rank * T:(rank + 1) * T]
    del x_all
    E = ds.moe.num_experts
    home = torch.arange(E) // (E // world)
    out = {"calls": {}}
    ys, gates = {}, {}
    with torch.inference_mode():
        for name, cfg in cfgs.items():
            g = groups[name]
            ctx = stages.make_stage_ctx(cfg, g)
            gs = stages.gate_stage(ctx, x, params.router, bias)
            plan = stages.plan_stage(ctx, gs).plan
            plain = planner.solve_plan(
                gs.lam.cpu(), home, n_slot=cfg.balancer.n_slot,
                rack_size=cfg.rack_size,
                demand_tiebreak=cfg.gating.rack_binding,
                gate_tier_tokens=(None if gs.gate_tier_tokens is None
                                  else gs.gate_tier_tokens.cpu()))
            # Failures are recorded and raised by the parent: a rank that
            # raised here would leave the others waiting in a collective.
            mismatch = _plan_mismatch(plan, plain)
            vio = verify_plan(plan, Topology(
                racks=RACKS, ranks_per_rack=world // RACKS)
                if cfg.rack_size else Topology.flat(world), lam=gs.lam,
                home=home, rack_aware_mode=True)
            ids = gs.gate_out.expert_ids
            if cfg.gating.rack_binding:
                vio += verify_rack_limit(
                    ids, rack_limit=cfg.gating.rack_limit,
                    num_racks=cfg.gating.num_racks, num_experts=E)
            check = {"errors": [str(v) for v in errors(vio)],
                     "warns": dict(collections.Counter(
                         v.rule for v in vio if v.severity == "warn"))}
            gates[name] = (ids, gs.gate_out.weights)
            del gs, plan
            torch.cuda.synchronize()
            _reset_launches()
            y, _, st = moe_layer_local(x, params, cfg, axis_name=g,
                                       router_bias=bias)
            torch.cuda.synchronize()
            launches = _launches()
            ys[name] = y
            racks_a_token = int((ids // (E // RACKS)).sort(dim=1).values
                                .diff(dim=1).ne(0).sum(dim=1).max()) + 1
            rec = {"mode": cfg.dispatch_mode, "impl": cfg.dispatch_impl,
                   "overlap_chunks": cfg.overlap_chunks,
                   "racks": cfg.racks, "rack_limit": cfg.gating.rack_limit,
                   "cap_pair": cfg.cap_pair, "cap_slot": cfg.cap_slot,
                   "drops": int(st.drops_dispatch + st.drops_slot),
                   "post_max": int(st.post_max),
                   "max_slot_load": int(st.max_slot_load),
                   "racks_a_token_max": racks_a_token,
                   "items": world * T * cfg.gating.top_k,
                   "finite": bool(torch.isfinite(y).all()),
                   "plan_mismatch": mismatch, "plan_check": check,
                   "launches": {k: launches[k] for k in (
                       "plan_solve", "gating_topk", "gating_topk.rack",
                       "gating_topk.free", "grouped_swiglu",
                       "grouped_matmul")}}
            for f in ("tier_tokens", "tier_replicas", "tier_bytes",
                      "gate_tier_tokens", "gate_tier_bytes"):
                v = getattr(st, f)
                rec[f] = None if v is None else v.tolist()
            out["calls"][name] = rec
            del st
            torch.cuda.empty_cache()
            _host_release()
    pairs = (("b", "a"), ("c", "c_flat"), ("d", "b"), ("e", "a"))
    out["equal"] = {f"{u}={v}": bool(torch.equal(ys[u], ys[v]))
                    for u, v in pairs}
    # Where outputs differ: the gate's and the rows' differences on this
    # rank, and, where they differ on any rank (every rank must make the
    # same collective calls), each item's FFN row of (b) against (a).
    out["differences"] = {
        f"{u}={v}": {"gate_equal": bool(
                         torch.equal(gates[u][0], gates[v][0])
                         and torch.equal(gates[u][1], gates[v][1])),
                     "rows_differing": int((ys[u] != ys[v]).any(dim=1).sum()),
                     "max_abs_diff": float((ys[u].float() - ys[v].float())
                                           .abs().max())}
        for u, v in pairs if not torch.equal(ys[u], ys[v])}
    bad = collectives.all_reduce(flat, torch.tensor(
        [float(bool(out["differences"]))], device=dev))
    if bad.item() > 0:
        out["first_difference"] = _rack_first_difference(
            cfgs, groups, params, x, bias)
    del ys, gates
    torch.cuda.empty_cache()
    out["peak_forward_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    out["backward"] = _rack_backward(cfgs, groups, params, x, bias)
    out["peak_backward_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["host_peak_gb"] = _host_peak_gb()
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    collectives.destroy()


def _rack_first_difference(cfgs, groups, params, x, bias) -> dict:
    """Stage by stage, (b) against (a): whether the gate, each item's FFN
    output row as it returns to its source, and the combined output agree
    bit for bit."""
    import torch

    from repro_torch.moe import stages
    from repro_torch.moe.permute import fused_unbucket

    res = {}
    with torch.inference_mode():
        st = {}
        for name in ("a", "b"):
            ctx = stages.make_stage_ctx(cfgs[name], groups[name])
            gs = stages.gate_stage(ctx, x, params.router, bias)
            ps = stages.plan_stage(ctx, gs)
            dist = stages.distribute_stage(ctx, params, gs, ps)
            d = stages.dispatch_stage(ctx, x, gs.gate_out.expert_ids, gs, ps)
            o = stages.compute_stage(ctx, d, dist)
            disp, meta = d.inverse
            ret = stages._exchange(ctx, fused_unbucket(o, meta), reverse=True)
            cap = ret.shape[1]
            rows = ret.reshape(-1, ret.shape[-1])[
                disp.item_dst.clamp(min=0) * cap + disp.item_pos.clamp(
                    max=cap - 1)]
            st[name] = (gs.gate_out, rows, stages.combine_stage(
                ctx, d, o, gs.gate_out.weights))
        ga, gb = st["a"][0], st["b"][0]
        res["gate"] = bool(torch.equal(ga.expert_ids, gb.expert_ids)
                           and torch.equal(ga.weights, gb.weights))
        res["ffn_rows"] = bool(torch.equal(st["a"][1], st["b"][1]))
        res["combined"] = bool(torch.equal(st["a"][2], st["b"][2]))
    return res


# Phase 14's backward in passes, each with the gradients of one part: x
# (the parameters held fixed), then the router with w1, then w3, then w2
# (x held fixed); and the launches each pass makes (B1 the SwiGLU backward,
# B2 the dgrad products: dact, and dx where x takes a gradient; B3 the
# three wgrads, made in every parameter pass: the slot buffers of all three
# weights take a gradient when one main does).
_PARAM_PASS = {"grouped_swiglu_bwd": 1, "grouped_matmul_nt": 1,
               "grouped_wgrad": 3}
RACK_BWD_PASSES = {
    "x": (("x",), {"grouped_swiglu_bwd": 1, "grouped_matmul_nt": 2,
                   "grouped_wgrad": 0}),
    "w1": (("router", "w1"), _PARAM_PASS),
    "w3": (("w3",), _PARAM_PASS),
    "w2": (("w2",), _PARAM_PASS)}


def _max_err_rows(out, ref, rows: int = 8) -> tuple[float, float]:
    """``_max_err`` of ``out`` (on the card) against ``ref`` (on the host),
    ``rows`` leading rows at a time: an fp32 copy of a whole expert
    gradient (3.5 GB) does not fit beside four ranks."""
    err = scale = 0.0
    for i in range(0, out.shape[0], rows):
        e, m = _max_err(out[i:i + rows], ref[i:i + rows].to(out.device))
        err, scale = max(err, e), max(scale, m)
    return err, scale


def _host_peak_gb() -> float:
    """This process's peak resident host memory, GB (``ru_maxrss``, KB on
    Linux)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def _host_release() -> bool:
    """Return the cached pinned host blocks (gloo stages CUDA tensors
    through them) to the system, where this PyTorch can; four ranks' caches
    and the reference gradients share the host's memory.  True if done."""
    import torch

    release = getattr(torch._C, "_host_emptyCache", None)
    if release is not None:
        release()
    return release is not None


def _rack_backward(cfgs, groups, params, x, bias) -> dict:
    """(f): d(sum y^2) through (b) against (a), in x, the router and this
    rank's experts (the router's summed over the group), each within
    TRAIN_TOL of (a)'s max|g|.

    The gradients come in passes (RACK_BWD_PASSES), each run on (a), then
    on (b).  Four ranks share one card and one host: a pass of one part
    holds the experts, the slot gradients and the exchanges' buffers but
    not every gradient at once, (a)'s gradients of the pass wait on the
    host (at most one weight, 1.9 GB a rank) and (b)'s are compared on the
    card.  Each pass also has one chain of collectives, where a pass of
    both kinds would leave the replica gradients' gather and the dispatch
    exchange's transpose ready together, a choice the autograd engine need
    not make alike on every rank."""
    import sys

    import torch

    from repro_torch.moe.layer import moe_layer_local
    from repro_torch.parallel import collectives

    errs = {}
    launches = {}
    for tag, (wrt, _) in RACK_BWD_PASSES.items():
        ref = {}                              # (a)'s gradients, on the host
        for name in ("a", "b"):
            print(f"rack tier backward: rank {groups['a'].rank} pass {tag} "
                  f"call ({name})", file=sys.stderr, flush=True)
            torch.cuda.synchronize()
            _reset_launches()
            with torch.enable_grad():
                for n in ("router", "w1", "w3", "w2"):
                    getattr(params, n).requires_grad_(n in wrt)
                xg = x.clone().requires_grad_("x" in wrt)
                y, _, st = moe_layer_local(xg, params, cfgs[name],
                                           axis_name=groups[name],
                                           router_bias=bias)
                (y.float() ** 2).sum().backward()
            torch.cuda.synchronize()
            n = _launches()
            launches[f"{name}/{tag}"] = {k: n[k] for k in (
                "plan_solve", "gating_topk", "grouped_swiglu",
                "grouped_matmul", "grouped_swiglu_bwd", "grouped_matmul_nt",
                "grouped_wgrad")}
            launches[f"{name}/{tag}"]["drops"] = int(st.drops_dispatch
                                                     + st.drops_slot)
            grads = {g: (xg.grad if g == "x" else getattr(params, g).grad)
                     for g in wrt}
            if "router" in grads:
                grads["router"] = collectives.all_reduce(groups["a"],
                                                         grads["router"])
            for g, t in grads.items():
                if name == "a":
                    ref[g] = t.cpu()
                else:
                    errs[g] = _max_err_rows(t, ref.pop(g))
            for t in params.parameters():
                t.requires_grad_(False)
                t.grad = None
            del xg, y, st, grads
            torch.cuda.empty_cache()
            _host_release()
    return {"max_abs_err": {n: e[0] for n, e in errs.items()},
            "max_abs_ref": {n: e[1] for n, e in errs.items()},
            "tol": TRAIN_TOL, "launches": launches,
            "host_cache_released": _host_release()}


def phase_rack_tier() -> dict:
    """Phase 14: the rack tier on the one card.  Four processes (spawn),
    one gloo group over CUDA tensors and the same ranks factored as 2
    racks x 2 lanes; DeepSeek-V3's MoE layer at full width (E 256, k 8,
    sigmoid router with a selection bias, routed scaling 2.5, d_model 7168,
    d_ff 2048, one shared expert, n_slot 2), bf16, RACK_TOKENS tokens a
    rank leaning toward rank 0's experts, ``ultraep``, capacity factors
    4.0.  Calls: (a) flat ``a2a``; (b) ``hier_a2a``; (c) ``hier_a2a`` with
    a rack limit of 1 and flat ``a2a`` with the same gate; (d) (b) in 2
    overlap chunks; (e) (a) on the reference engine; (f) the backward of
    (b) against (a)'s.  Checks on every rank: y(b) == y(a), y(c) == its
    flat twin, y(d) == y(b), y(e) == y(a) bit for bit; (b)'s tier_tokens
    sum to R T k; under (c) every token's experts in one rack and at most
    one at-gate inter-rack copy a token; zero drops; the plan tables equal
    the plain solve's, and no error from the port's static plan check
    (the rack limit's too, in (c)); each call through one launch of the
    plan solve,
    the gate (rack mode in (c) and its twin) and the two grouped GEMMs (two each in
    (d)); (f) within TRAIN_TOL of max|g|, in two passes (RACK_BWD_PASSES)
    with their launches of B1, B2 and B3.
    No time is stated: gloo stages CUDA tensors through the host."""
    import gc
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()
    parent_gb = torch.cuda.memory_reserved() / 2 ** 30
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as out_dir:
        mp.spawn(_rack_worker, args=(RACK_RANKS, port, out_dir),
                 nprocs=RACK_RANKS, join=True)
        ranks = [json.loads((Path(out_dir) / f"rank{r}.json").read_text())
                 for r in range(RACK_RANKS)]
    result = {"ranks": RACK_RANKS, "racks": RACKS,
              "tokens_per_rank": RACK_TOKENS, "backend": "gloo",
              "parent_reserved_gb": parent_gb,
              "parent_host_peak_gb": _host_peak_gb(), "ranks_by_call": ranks}
    # The record first, so that a failed check leaves every rank's data.
    _line("phase14_rack_tier", result)
    for rank, rec in enumerate(ranks):
        if not all(rec["equal"].values()):
            raise AssertionError(f"rack tier rank {rank}: outputs not equal "
                                 f"bit for bit: {rec['differences']}; (b) "
                                 f"against (a) by stage, every rank: "
                                 f"{[r.get('first_difference') for r in ranks]}")
        bw = rec["backward"]
        for n, err in bw["max_abs_err"].items():
            if not err <= TRAIN_TOL * bw["max_abs_ref"][n]:
                raise AssertionError(f"rack tier backward rank {rank} d{n}: "
                                     f"max|err| {err:.3e} > {TRAIN_TOL} * "
                                     f"max|ref| {bw['max_abs_ref'][n]:.3e}")
        for name, c in rec["calls"].items():
            n = c["launches"]
            chunks = c["overlap_chunks"]
            want_rack = 1 if c["rack_limit"] else 0     # (c), its flat twin
            if (c["drops"] or not c["finite"] or c["plan_mismatch"]
                    or c["plan_check"]["errors"]
                    or n["plan_solve"] != 1
                    or n["gating_topk"] != 1
                    or n["gating_topk.rack"] != want_rack
                    or n["grouped_swiglu"] != chunks
                    or n["grouped_matmul"] != chunks):
                raise AssertionError(f"rack tier rank {rank} ({name}): {c}")
        b, c = rec["calls"]["b"], rec["calls"]["c"]
        items = b["items"]
        if sum(b["tier_tokens"]) != items or sum(c["tier_tokens"]) != items:
            raise AssertionError(f"rack tier rank {rank}: tier_tokens "
                                 f"{b['tier_tokens']}, {c['tier_tokens']} "
                                 f"do not sum to {items}")
        if c["racks_a_token_max"] != 1 or \
                c["gate_tier_tokens"][2] > RACK_RANKS * RACK_TOKENS:
            raise AssertionError(f"rack tier rank {rank} (c): a token in "
                                 f"{c['racks_a_token_max']} racks, at-gate "
                                 f"tiers {c['gate_tier_tokens']}")
        for name, n in rec["backward"]["launches"].items():
            want = RACK_BWD_PASSES[name.split("/")[1]][1]
            if n["drops"] or any(n[k] != v for k, v in want.items()):
                raise AssertionError(f"rack tier backward rank {rank} "
                                     f"({name}): {n}, expected {want}")
    return result


# Phase 18, the model hosts beside the paper's two, Jamba-v0.1 and
# DeepSeek-V3, each through its normal entry point at its published widths.
# Serve: ``serve_trace`` on a short seeded Poisson trace in bf16, prompts of
# 256-1535 tokens in chunks of 1024, 4 new tokens each; the depth cut to
# the layers listed (None: every layer).
HOST_SERVE = dict(requests=3, chunk=1024, max_new=4, reduce=False,
                  balancer="ultraep", seed=0, prompt_len=(256, 1536),
                  decode_batch=4, cf=4.0)
HOST_SERVES = (("dbrx-132b", 2), ("qwen2-72b", 2), ("mistral-large-123b", 2),
               ("internvl2-26b", 2), ("qwen3-0.6b", None),
               ("internlm2-1.8b", None), ("mamba2-130m", None))
# DeepSeek-V3 through the serve entry point as a user types it: fp32, its
# default dtype (MLA prefill at (192, 128) on the fp32 prefill kernel), its
# default trace and chunk (64), 2 dense layers at full width.
DEEPSEEK_CLI = ["--arch", "deepseek-v3-671b", "--layers", "2",
                "--requests", "2"]
# Train: HuBERT-XLarge's first 4 layers from the frames stub, AdamW, bf16,
# 2 x 4096 frames, 3 steps without remat; InternVL2-26B's train cell
# (Adafactor, per-layer remat, bf16) at 2 layers, 1 x 4096 tokens with
# its 256 patches spliced in, one step.
HUBERT_TRAIN = dict(layers=4, batch=2, seq=4096, steps=3, seed=0)
INTERNVL_TRAIN = dict(layers=2, batch=1, steps=1, loss_chunks=8, seed=0)


def _host_flash_calls(rec) -> dict:
    """Flash kernel -> the engine calls that go through it on a serve path,
    from the shapes alone (``plan_launch``): the prefill chunks (B 1,
    ``chunk`` queries over the cache) and the decode steps (one query a
    row: the split-KV kernel)."""
    import torch

    from repro_torch.kernels.flash_attention.ops import plan_launch

    cfg = rec["cfg"]
    if not rec["attn_layers"]:
        return {}
    prefill = plan_launch(1, rec["chunk"], rec["max_seq"], cfg.num_heads,
                          cfg.num_kv_heads, cfg.head_dim,
                          getattr(torch, rec["dtype"])).kernel
    calls = {prefill: rec["prefill_calls"]}
    calls["decode_split"] = calls.get("decode_split", 0) + rec["decode_calls"]
    return calls


def _grad_check(params, batch, cfg, rcfg, pctx, router_bias=None) -> dict:
    """One step's gradient of every parameter with the backward kernels
    against the same step with ``plain_backward`` (the forward kernels
    shared, so both runs route alike: their counts must be equal), within
    TRAIN_TOL of each max|ref|, every gradient and the loss finite; the
    kernel run's launches (counts set to 0 just before it)."""
    import torch

    from repro_torch.train.loop import loss_and_grads

    loss_p, _, counts_p, grads_p = loss_and_grads(
        params, batch, cfg, dataclasses.replace(rcfg, plain_backward=True),
        pctx, router_bias=router_bias)
    grads_p = [t.clone() for t in grads_p]
    torch.cuda.synchronize()
    _reset_launches()
    loss_k, drops_k, counts_k, grads_k = loss_and_grads(
        params, batch, cfg, rcfg, pctx, router_bias=router_bias)
    torch.cuda.synchronize()
    launches = _launches()
    if not torch.equal(counts_p, counts_k):
        raise AssertionError("grad check: the two runs routed differently")
    errs = {}
    for (name, _), gk, gp in zip(params.named_parameters(), grads_k,
                                 grads_p):
        if not torch.isfinite(gk).all():
            raise AssertionError(f"grad check: {name} is not finite")
        err, scale = _max_err(gk, gp)
        errs[name] = err / max(scale, 1e-30)
    bad = {n: e for n, e in errs.items() if not e <= TRAIN_TOL}
    if bad or not torch.isfinite(loss_k):
        raise AssertionError(f"grads beyond {TRAIN_TOL} of max|ref|: {bad}; "
                             f"loss {float(loss_k)}; all: {errs}")
    for p in params.parameters():
        p.grad = None
    return {"loss_kernels": float(loss_k), "loss_plain": float(loss_p),
            "drops": int(drops_k), "max_rel_err_by_param": errs,
            "worst": max(errs, key=errs.get),
            "worst_rel_err": max(errs.values()), "launches": launches}


def _per_step_launches(want: dict, tag: str):
    """(on_metrics, steps): each step's launches checked against ``want``
    (counts set to 0 after each step)."""
    import torch

    steps = []

    def on_metrics(step, m):
        torch.cuda.synchronize()
        seen = _launches()
        bad = {k: (seen[k], n) for k, n in want.items() if seen[k] != n}
        if bad or any(_padded_copies().values()):
            raise AssertionError(f"{tag} step {step}: launches (seen, want) "
                                 f"{bad}, copies {_padded_copies()}")
        steps.append(seen)
        _reset_launches()

    return on_metrics, steps


def phase_hosts() -> dict:
    """Phase 18: (a) ``serve_trace`` on each of HOST_SERVES (DBRX-132B:
    the grouped GEMMs at K 6144 / N 10752 and the gate at E 16, k 4;
    Mamba2-130M: the SSD kernel at state 128; InternVL2-26B serves text
    tokens), every request finished with its tokens, no non-finite logits,
    each flash call by the kernel its shapes select, the gate and both
    grouped GEMMs once per MoE layer and engine call, the SSD kernel once
    per Mamba layer and prefill call, no operand copied for TMA; (b) the
    serve entry point on DeepSeek-V3 in fp32 (DEEPSEEK_CLI): every prefill
    through the fp32 prefill kernel at (192, 128); (c) HuBERT-XLarge
    trained HUBERT_TRAIN["steps"] steps through ``launch.train.train``
    after a gradient check against ``plain_backward`` (flash forward and
    B4 at (80, 80), bidirectional); (d) one step of InternVL2-26B's train
    cell through ``launch.train.train_cell``."""
    import gc
    import math

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.specs import build_cell
    from repro_torch.launch.train import build, train, train_cell
    from repro_torch.models.transformer import ParallelCtx

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    out = {"serve": {}}
    for arch, layers in HOST_SERVES:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, name=f"{arch}-{layers}l",
                                      num_layers=layers)
        tag = f"phase18_hosts_serve {cfg.name}"
        rec = phase_serve(cfg, tag, settings=HOST_SERVE)
        _check_kernel_calls(tag, rec["launches"], rec["padded_copies"], cfg,
                            _host_flash_calls(rec),
                            engine_calls=rec["prefill_calls"]
                            + rec["decode_calls"])
        ssd = rec["mamba_layers"] * rec["prefill_calls"]
        if rec["launches"]["ssd_intra_chunk"] != ssd:
            raise AssertionError(f"{tag}: ssd_intra_chunk launched "
                                 f"{rec['launches']['ssd_intra_chunk']} "
                                 f"times, not {ssd}")
        needs = [n for n, c in (("flash_attention", rec["attn_layers"]),
                                ("gating_topk", rec["moe_layers"]),
                                ("grouped_swiglu", rec["moe_layers"]),
                                ("grouped_matmul", rec["moe_layers"]),
                                ("ssd_intra_chunk", rec["mamba_layers"]))
                 if c and rec["launches"][n] <= 0]
        if needs:
            raise AssertionError(f"{tag}: {needs} not launched")
        out["serve"][arch] = rec
        free()

    _reset_launches()
    eng = serve_main(DEEPSEEK_CLI)
    launches, copies = _launches(), _padded_copies()
    done = eng.finished
    if len(done) != 2 or any(r.failed or len(r.output) != 8 for r in done) \
            or eng.fault_counters["nonfinite_logits"]:
        raise AssertionError(f"hosts serve cli deepseek-v3-671b fp32: "
                             f"finished {len(done)}, faults "
                             f"{eng.fault_counters}, last error "
                             f"{eng.last_error!r}")
    pre = sum(kind == "prefill" for kind, _, _ in eng.calls)
    ds_cfg = dataclasses.replace(get_config("deepseek-v3-671b"), num_layers=2)
    _check_kernel_calls("hosts serve cli deepseek-v3-671b fp32", launches,
                        copies, ds_cfg, {"prefill_f32": pre},
                        engine_calls=len(eng.calls))
    out["deepseek_cli_fp32"] = {
        "argv": DEEPSEEK_CLI, "engine_calls": len(eng.calls),
        "prefill_calls": pre, "mean_ttft_s": float(eng.ttft().mean()),
        "mean_tpot_s": float(eng.tpot().mean()), "launches": launches}
    _line("phase18_hosts_serve_cli deepseek-v3-671b",
          out["deepseek_cli_fp32"])
    del eng, done
    free()

    # HuBERT-XLarge: frames through the stub, 16 heads of 80, no causal mask.
    h = HUBERT_TRAIN
    kw = dict(reduce=False, layers=h["layers"], batch=h["batch"],
              seq=h["seq"], steps=h["steps"], seed=h["seed"],
              dtype=torch.bfloat16, remat=False, device="cuda")
    tr = build("hubert-xlarge", **kw)
    batch = tr.batch(0)
    frames = batch.get("frames")
    if "tokens" in batch or frames is None or frames.dtype != torch.bfloat16 \
            or frames.shape != (h["batch"], h["seq"], tr.cfg.d_model):
        shapes = {k: (tuple(t.shape), str(t.dtype)) for k, t in batch.items()}
        raise AssertionError(f"hubert batch: {shapes}")
    check = _grad_check(tr.state.params, batch, tr.cfg, tr.rcfg, tr.pctx)
    L = h["layers"]
    want = {"flash_attention": L, "flash_attention.prefill_wgmma": L,
            "flash_attention_bwd": L, "flash_attention_bwd.80x80": L,
            "gating_topk": 0, "grouped_swiglu": 0, "plan_solve": 0}
    bad = {k: (check["launches"][k], n) for k, n in want.items()
           if check["launches"][k] != n}
    if bad:
        raise AssertionError(f"hubert grad check launches (seen, want) {bad}")
    del tr, batch, frames
    free()
    on_metrics, steps = _per_step_launches(want, "hubert train")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    run = train("hubert-xlarge", ckpt_every=0, log_every=h["steps"],
                on_metrics=on_metrics, **kw)
    if not all(math.isfinite(v) for v in run.losses):
        raise AssertionError(f"hubert train: a loss is not finite: "
                             f"{run.losses}")
    out["hubert_train"] = {
        "arch": "hubert-xlarge", **h, "params": run.params,
        "optimizer": "adamw fp32", "dtype": "bfloat16",
        "losses": run.losses, "grad_norms": run.grad_norms,
        "step_s": run.step_s, "step_s_median": run.step_s_median,
        "frames_per_s": run.tokens_per_s, "peak_mem_gb": run.peak_mem / 1e9,
        "launches_per_step": steps[-1], "grad_check": check}
    _line("phase18_hosts_train hubert-xlarge", out["hubert_train"])
    free()

    # InternVL2-26B's train cell: 256 projected patches over the first
    # positions of each row's token embeddings.
    v = INTERNVL_TRAIN
    cell = build_cell("internvl2-26b", "train_4k", ParallelCtx(),
                      num_layers_override=v["layers"])
    patches = cell.arg_shapes[1]["patches"]
    if tuple(patches.shape[1:]) != (256, 6144):
        raise AssertionError(f"internvl2 cell patches {tuple(patches.shape)}")
    L = v["layers"]
    want = {"flash_attention": 2 * L, "flash_attention.prefill_wgmma": 2 * L,
            "flash_attention_bwd": L, "flash_attention_bwd.128x128": L,
            "gating_topk": 0, "plan_solve": 0}
    on_metrics, steps = _per_step_launches(want, "internvl2 train cell")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    run = train_cell("internvl2-26b", "train_4k", layers=L, batch=v["batch"],
                     steps=v["steps"], loss_chunks=v["loss_chunks"],
                     seed=v["seed"], device="cuda", ckpt_every=0,
                     log_every=v["steps"], on_metrics=on_metrics)
    if not all(math.isfinite(x) for x in run.losses) or \
            not all(math.isfinite(x) for x in run.grad_norms):
        raise AssertionError(f"internvl2 train: not finite: {run.losses}, "
                             f"{run.grad_norms}")
    out["internvl2_train"] = {
        "arch": "internvl2-26b", **v, "cell": "train_4k",
        "optimizer_state": type(cell.meta["optimizer"].init([])).__name__,
        "patches": list(patches.shape[1:]), "params": run.params,
        "losses": run.losses, "grad_norms": run.grad_norms,
        "step_s": run.step_s, "tokens_per_s": run.tokens_per_s,
        "peak_mem_gb": run.peak_mem / 1e9, "launches_per_step": steps[-1]}
    _line("phase18_hosts_train internvl2-26b", out["internvl2_train"])
    del cell
    free()
    return out



# Phase 19: training at the trainer's own defaults on the card: fp32 (the
# JAX trainer's dtype, ``RuntimeConfig.dtype``) and, through ``train()``'s
# ``reduce=True``, head dim 16.  Kernels: B4f (the fp32 flash backward,
# mma.sync in 3xTF32) at every (q/k, v) pair the forward takes, causal and
# bidirectional, at GQA 4 (B4F_SHAPE); B4 in bf16 at (64, 64) (wgmma) and
# (16, 16) (mma.sync), causal; B4f at the Qwen3-0.6B path's own shape;
# B5 at Mamba2-130M's (64, 128) on one
# 4096-token row (nc 32, Q 128, 24 heads), bf16 and fp32 inputs.  Paths
# (DEFAULT_PATHS): each trains DEFAULT_STEPS steps through the trainer's
# entry points with no dtype given (Mamba2-130M and the reduced GLM-4.5-Air
# also in bf16, for B5's and B4 (16, 16)'s bf16 launches), its step-0
# gradients first held against ``plain_backward``, checkpoints off (0).
B4F_SHAPE = dict(B=1, S=2048, H=16, Hkv=4)
# The attention of the Qwen3-0.6B path ("qwen3-0.6b main"): the trainer's
# batch of 8 x 128 tokens, 16 query and 8 KV heads of 128.
QWEN3_MAIN_SHAPE = dict(B=8, S=128, H=16, Hkv=8)
B4F_PAIRS = ((16, 16), (64, 64), (80, 80), (128, 128), (192, 128))
MAMBA2_SSD_TRAIN = dict(B=1, nc=32, Q=128, H=24, P=64, N=128)
DEFAULT_STEPS = 3
# tag -> (arch, build/train keywords beyond the defaults); "main" runs the
# command line, ``launch.train.main``, on the same settings.
DEFAULT_PATHS = {
    "qwen3-0.6b main": ("qwen3-0.6b", dict(reduce=False)),
    "glm45 train() defaults": ("glm45-106b-a12b", {}),
    "glm45 train() bf16": ("glm45-106b-a12b", dict(dtype="bfloat16")),
    "mamba2-130m fp32": ("mamba2-130m", dict(reduce=False)),
    "mamba2-130m bf16": ("mamba2-130m", dict(reduce=False,
                                             dtype="bfloat16")),
    "hubert-xlarge 2l fp32": ("hubert-xlarge", dict(reduce=False, layers=2)),
    "deepseek-v3 1l fp32": ("deepseek-v3-671b", dict(reduce=False, layers=1,
                                                     batch=1, seq=1024)),
}
# Paths whose gradient check is against the same weights' fp32 gradient,
# not plain_backward's bf16 one within TRAIN_TOL: Mamba2-130M's 24 bf16
# layers carry each layer's one-ulp rounding of dx, dB and dC (the kernel's
# own error, 0.25% of max|ref|) through the whole depth, so the two bf16
# runs differ by 2.45e-2 at layer 0 (a development run) while each is as
# far from the fp32 gradient as the other (_bf16_grad_check_vs_fp32).
GRAD_VS_FP32 = ("mamba2-130m bf16",)


def _flash_bwd_case(g, dtype, hd, hv, causal, B, S, H, Hkv, iters=3) -> dict:
    """One backward launch of ``bwd_kernel(dtype, hd)`` at (hd, hv) on the
    prefill kernel's output and logsumexp: dq, dk, dv within 1e-4 (fp32)
    or TRAIN_TOL (bf16) of each max|ref| against autograd through the
    plain version, bitwise equal over two calls; timed beside the plain
    version and SDPA's backward (fp32: the memory-efficient backend; bf16:
    flash; k and v repeated to the query heads), and each of its three
    kernels alone (``stage_ms``).  Bound: the five products a (query, key)
    pair, 2 (3 hd + 2 hv) flops, at the TF32 x 3 rate (fp32; the fp32
    CUDA-core rate beside) or the bf16 rate, against q, k, v, o, do and
    the logsumexp read and dq, dk, dv written once."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops as fa

    tol = 1e-4 if dtype == torch.float32 else TRAIN_TOL
    tag = f"flash_bwd {str(dtype)[6:]} ({hd}, {hv}) causal={causal}"
    q = torch.randn((B, S, H, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((B, S, Hkv, hv), generator=g, device="cuda").to(dtype)
    dout = torch.randn((B, S, H, hv), generator=g, device="cuda").to(dtype)
    lse = torch.empty((B, H, S), device="cuda")
    o, fwd_kernel = fa._launch(q, k, v, causal, 0, None, None, sms=1,
                               lse=lse)
    grads = fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal)
    torch.cuda.synchronize()
    for n, a, r in zip("qkv", grads, again):
        if not torch.equal(a, r):
            raise AssertionError(f"{tag} d{n}: two calls differ")
    del again
    refs = fa.flash_attention_bwd_ref(q, k, v, dout, causal=causal)
    errs = {n: _rel_check(f"{tag} d{n}", a, r, tol)
            for n, a, r in zip("qkv", grads, refs)}
    del refs, grads
    G = H // Hkv
    qt = q.transpose(1, 2).detach().requires_grad_(True)
    kt, vt = (t.repeat_interleave(G, dim=2).transpose(1, 2).detach()
              .requires_grad_(True) for t in (k, v))
    dot = dout.transpose(1, 2)
    backend = (SDPBackend.EFFICIENT_ATTENTION if dtype == torch.float32
               else SDPBackend.FLASH_ATTENTION)
    library, library_error, ot = None, None, None
    try:
        with sdpa_kernel([backend]):
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

        def library():
            return torch.autograd.grad(ot, (qt, kt, vt), dot,
                                       retain_graph=True)
    except RuntimeError as e:        # no SDPA backward at these dims
        library_error = str(e)[:300]
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    flops = pairs * 2.0 * (3 * hd + 2 * hv)
    elt = q.element_size()
    nbytes = (2 * elt * (B * S * H * hd + B * S * Hkv * (hd + hv))
              + 2 * elt * B * S * H * hv + 4 * B * H * S)
    kind = "tf32x3" if dtype == torch.float32 else "bf16"
    t = _time_pair(
        lambda: fa.flash_attention_bwd(q, k, v, o, dout, lse, causal=causal),
        lambda: fa.flash_attention_bwd_ref(q, k, v, dout, causal=causal),
        library, flops, nbytes, kind, iters)
    rec = dict(t, shape=dict(B=B, S=S, H=H, Hkv=Hkv, hd=hd, hd_v=hv,
                             causal=causal, dtype=str(dtype)[6:]),
               kernel=fa.bwd_kernel(dtype, hd), forward_kernel=fwd_kernel,
               stage_ms=fa.bwd_stage_ms(q, k, v, o, dout, lse,
                                        causal=causal),
               max_abs_err=max(e[0] for e in errs.values()),
               errs={n: {"max_abs_err": e[0], "max_abs_ref": e[1],
                         "rel": e[0] / max(e[1], 1e-30)}
                     for n, e in errs.items()},
               tol=tol, library_error=library_error,
               library_note=f"SDPA's backward through autograd "
                            f"({backend.name}; k, v repeated to {H} heads)")
    if dtype == torch.float32:
        rec["bound_fp32_ms"] = flops / _hw().peak("fp32") * 1e3
        rec["bound_kind"] = "five products at the TF32 x 3 rate"
    del q, k, v, dout, o, lse, qt, kt, vt, ot
    torch.cuda.empty_cache()
    return rec


def _grouped_bwd_f32_records(cfg, tokens: int, cf: float,
                             iters: int) -> dict:
    """B1f (swiglu_bwd), B2f (matmul_nt, dx = dh w1^T + dg w3^T) and B3f
    (wgrad) in fp32 at ``cfg``'s width with each slot's valid-row count
    from the port's gate, ``ultraep`` plan and bucket on ``tokens`` seeded
    tokens at capacity factors ``cf``, NaN in the padded rows of every
    operand: each output within 1e-4 of its max|ref| (slots checked a group
    at a time), padded rows zero, bitwise equal over two calls; timed
    beside the plain version and ``torch.bmm`` in fp32 over the padded
    buffers.  Bound: the valid rows' products at the TF32 x 3 rate (the
    fp32 CUDA-core rate beside) against each needed byte once."""
    import torch

    from repro_torch.kernels.grouped_gemm import ops as gg

    f32 = torch.float32
    rows, cap = _serve_rows(cfg, tokens, "a2a", 7, cf=cf)
    G, M, K, N = rows.shape[0], cap, cfg.d_model, cfg.moe.d_ff
    R, nz = int(rows.sum()), int((rows > 0).sum())
    x, w1, w3, _ = _kernel_inputs(G, M, K, N, f32, 11)
    g = torch.Generator(device="cuda").manual_seed(12)
    dact = torch.randn((G, M, N), generator=g, device="cuda")
    pad = torch.arange(M, device="cuda")[None, :, None] >= rows[:, None, None]
    nan = lambda t: torch.where(pad, float("nan"), t)
    x0, dact0 = torch.where(pad, 0.0, x), torch.where(pad, 0.0, dact)
    x, dact = nan(x), nan(dact)
    dh, dg = gg.grouped_swiglu_bwd(x, w1, w3, dact, rows)
    # The NaN-padded operands are made once, outside the timed calls.
    dhn, dgn = nan(dh), nan(dg)
    shape = dict(G=G, M=M, K=K, N=N, tokens=tokens, cf=cf, dtype="float32")
    cases = {
        "grouped_swiglu_bwd": (
            lambda: gg.grouped_swiglu_bwd(x, w1, w3, dact, rows),
            lambda sl: gg.grouped_swiglu_bwd_ref(x0[sl], w1[sl], w3[sl],
                                                 dact0[sl], rows[sl]),
            lambda: (torch.bmm(x0, w1), torch.bmm(x0, w3)),
            4.0 * R * K * N, 4 * (R * K + 2 * nz * K * N + 3 * R * N)),
        "grouped_matmul_nt": (
            lambda: gg.grouped_matmul_nt(dhn, w1, rows, dgn, w3),
            lambda sl: (gg.grouped_matmul_nt_ref(dh[sl], w1[sl], rows[sl],
                                                 dg[sl], w3[sl]),),
            lambda: torch.bmm(dh, w1.transpose(1, 2))
            + torch.bmm(dg, w3.transpose(1, 2)),
            4.0 * R * K * N, 4 * (2 * R * N + 2 * nz * K * N + R * K)),
        "grouped_wgrad": (
            lambda: gg.grouped_wgrad(x, dhn, rows),
            lambda sl: (gg.grouped_wgrad_ref(x0[sl], dh[sl], rows[sl]),),
            lambda: torch.bmm(x0.transpose(1, 2), dh),
            2.0 * R * K * N, 4 * (R * K + R * N + G * K * N)),
    }
    recs = {}
    for name, (kernel, ref, library, flops, nbytes) in cases.items():
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{name} fp32: two calls differ")
        e = _slot_check(f"{name} fp32", got, ref, 1e-4)
        if got[0].shape[1] == M and not all(
                torch.all(torch.where(pad, t, 0.0) == 0) for t in got):
            raise AssertionError(f"{name} fp32: a padded row is not zero")
        del got, again
        t = _time_pair(kernel, lambda: ref(slice(None)), library, flops,
                       nbytes, "tf32x3", iters)
        recs[name] = dict(t, shape=shape, rows=R, slots_with_rows=nz,
                          max_abs_err=e[0], max_abs_ref=e[1],
                          bound_fp32_ms=flops / _hw().peak("fp32") * 1e3,
                          library_note="torch.bmm in fp32 over the padded "
                                       "buffers (TF32 off)")
        torch.cuda.empty_cache()
    del x, w1, w3, dact, x0, dact0, dh, dg, dhn, dgn, pad
    torch.cuda.empty_cache()
    return recs


def _bf16_grad_check_vs_fp32(params, batch, cfg, rcfg, pctx) -> dict:
    """The bf16 gradients with the backward kernels and with
    ``plain_backward`` (the forward kernels shared), each against the same
    weights' gradient in fp32 arithmetic (the parameters cast to fp32,
    the fp32 kernels, which phase 19's fp32 path holds to ``plain_backward``
    within TRAIN_TOL): the kernels' worst error over the parameters must be
    within 1.5x the plain backward's own (bf16 rounding through the whole
    depth), every gradient finite; the direct kernels-vs-plain error beside,
    and the kernel run's launches."""
    import copy

    import torch

    from repro_torch.train.loop import loss_and_grads

    def grads(ps, rc):
        loss, _, counts, gs = loss_and_grads(ps, batch, cfg, rc, pctx)
        out = [g.float().clone() for g in gs]
        for q in ps.parameters():
            q.grad = None
        return float(loss), counts, out

    loss_p, counts_p, g_p = grads(params, dataclasses.replace(
        rcfg, plain_backward=True))
    torch.cuda.synchronize()
    _reset_launches()
    loss_k, counts_k, g_k = grads(params, rcfg)
    torch.cuda.synchronize()
    launches = _launches()
    if not torch.equal(counts_p, counts_k):
        raise AssertionError("grad check: the two runs routed differently")
    p32 = copy.deepcopy(params).float()
    _, _, g_t = grads(p32, dataclasses.replace(rcfg, dtype=torch.float32))
    del p32
    names = [n for n, _ in params.named_parameters()]
    e_k, e_p, e_kp = {}, {}, {}
    for n, gk, gp, gt in zip(names, g_k, g_p, g_t):
        if not (torch.isfinite(gk).all() and torch.isfinite(gt).all()):
            raise AssertionError(f"grad check: {n} is not finite")
        scale = max(gt.abs().max().item(), 1e-30)
        e_k[n] = (gk - gt).abs().max().item() / scale
        e_p[n] = (gp - gt).abs().max().item() / scale
        err, sc = _max_err(gk, gp)
        e_kp[n] = err / max(sc, 1e-30)
    worst_k, worst_p = max(e_k.values()), max(e_p.values())
    if not worst_k <= 1.5 * worst_p:
        raise AssertionError(f"bf16 grad check: the kernels' worst error "
                             f"against fp32 {worst_k:.3e} is beyond 1.5x the "
                             f"plain backward's {worst_p:.3e}")
    return {"loss_kernels": loss_k, "loss_plain": loss_p,
            "worst_vs_fp32_kernels": worst_k,
            "worst_vs_fp32_plain": worst_p,
            "worst_vs_fp32_param": max(e_k, key=e_k.get),
            "worst": max(e_kp, key=e_kp.get),
            "worst_rel_err": max(e_kp.values()), "launches": launches}


def _attn_mamba_layers(cfg) -> tuple[int, int]:
    from repro_torch.configs import layer_kinds

    kinds = [k.split("+")[0] for k in layer_kinds(cfg)]
    return kinds.count("attn"), kinds.count("mamba")


def _default_path(tag, arch, kw) -> dict:
    """One path of DEFAULT_PATHS: the step-0 gradients of a trainer built
    as the path builds it against ``plain_backward`` (``_grad_check``),
    then DEFAULT_STEPS steps through ``train`` (or ``main``), each step's
    backward launches held to the model's attention and Mamba layers (the
    counts set to 0 just before the run, read just after)."""
    import gc
    import math

    import torch

    from repro_torch.configs import layer_kinds
    from repro_torch.launch.train import DTYPES, build, main, train

    kw = dict(kw)
    if "dtype" in kw:
        kw["dtype"] = DTYPES[kw["dtype"]]
    tr = build(arch, **kw)
    dtype = tr.rcfg.dtype
    attn, mamba = _attn_mamba_layers(tr.cfg)
    hd, hv = ((tr.cfg.qk_nope_dim + tr.cfg.qk_rope_dim, tr.cfg.v_head_dim)
              if tr.cfg.is_mla else (tr.cfg.head_dim, tr.cfg.head_dim))
    if tag in GRAD_VS_FP32:
        check = _bf16_grad_check_vs_fp32(tr.state.params, tr.batch(0),
                                         tr.cfg, tr.rcfg, tr.pctx)
    else:
        check = _grad_check(tr.state.params, tr.batch(0), tr.cfg, tr.rcfg,
                            tr.pctx, router_bias=tr.state.router_bias)
    cfg = tr.cfg
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    want = {"flash_attention_bwd": attn, "ssd_intra_chunk_bwd": mamba}
    if cfg.moe is not None:
        moe = sum(k.endswith("+moe") for k in layer_kinds(cfg))
        # B1 once, B2 twice (dact, dx), B3 three times a MoE layer.
        kind = "fp32" if dtype == torch.float32 else "bf16"
        want.update({f"grouped_swiglu_bwd.{kind}": moe,
                     f"grouped_matmul_nt.{kind}": 2 * moe,
                     f"grouped_wgrad.{kind}": 3 * moe})
    if attn:
        from repro_torch.kernels.flash_attention.ops import bwd_kernel

        want[f"flash_attention_bwd.{bwd_kernel(dtype, hd)}"] = attn
        want[f"flash_attention_bwd.{hd}x{hv}"] = attn
    bad = {k: (check["launches"][k], n) for k, n in want.items()
           if check["launches"][k] != n}
    if bad:
        raise AssertionError(f"{tag} grad check launches (seen, want) {bad}")
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    if tag.endswith(" main"):
        run = main(["--arch", arch, "--steps", str(DEFAULT_STEPS),
                    "--ckpt-every", "0", "--log-every", "1"])
        launches = _launches()
        bad = {k: (launches[k], DEFAULT_STEPS * n) for k, n in want.items()
               if launches[k] != DEFAULT_STEPS * n}
        if bad:
            raise AssertionError(f"{tag} launches (seen, want) {bad}")
        per_step = {k: launches[k] // DEFAULT_STEPS for k in want}
    else:
        on_metrics, steps = _per_step_launches(want, tag)
        run = train(arch, steps=DEFAULT_STEPS, ckpt_every=0, log_every=1,
                    on_metrics=on_metrics, **kw)
        per_step = {k: steps[-1][k] for k in want}
    wall = time.perf_counter() - t0
    if not all(math.isfinite(x) for x in run.losses + run.grad_norms):
        raise AssertionError(f"{tag}: not finite: {run.losses}, "
                             f"{run.grad_norms}")
    out = {"arch": cfg.name, "dtype": str(dtype)[6:], "kw": {
        k: str(v) for k, v in kw.items()}, "head_dims": [hd, hv],
        "attn_layers": attn, "mamba_layers": mamba, "params": run.params,
        "losses": run.losses, "grad_norms": run.grad_norms,
        "step_s": run.step_s, "run_s": wall,
        "peak_mem_gb": run.peak_mem / 1e9, "launches_per_step": per_step,
        "grad_check": {k: v for k, v in check.items() if k != "launches"}}
    _line(f"phase19_train_defaults path {tag}", out)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train_defaults() -> dict:
    """Phase 19 (see B4F_SHAPE): the new backward kernels held against
    their plain versions and timed, then every path of DEFAULT_PATHS, then
    ``repro_torch.examples.quickstart`` on the card: its plan equal to the
    plain solve's on the CPU (quota table and Table-4 metrics), its layer
    within 1e-4 of the dense oracle, the plan solve, gate and grouped
    GEMMs launched."""
    import torch

    from repro_torch.examples import quickstart

    g = torch.Generator(device="cuda").manual_seed(34)
    kernels = {}
    sh = B4F_SHAPE
    for hd, hv in B4F_PAIRS:
        for causal in (True, False):
            tag = f"f32_{hd}x{hv}_{'causal' if causal else 'bidir'}"
            kernels[tag] = _flash_bwd_case(g, torch.float32, hd, hv, causal,
                                           **sh)
            _line(f"phase19_train_defaults kernel {tag}", kernels[tag])
    for hd in (64, 16):
        tag = f"bf16_{hd}x{hd}_causal"
        kernels[tag] = _flash_bwd_case(g, torch.bfloat16, hd, hd, True, **sh)
        _line(f"phase19_train_defaults kernel {tag}", kernels[tag])
    # B4f at the Qwen3-0.6B command line's own shape (QWEN3_MAIN_SHAPE).
    kernels["f32_qwen3_main"] = _flash_bwd_case(g, torch.float32, 128, 128,
                                                True, **QWEN3_MAIN_SHAPE)
    _line("phase19_train_defaults kernel f32_qwen3_main",
          kernels["f32_qwen3_main"])
    kernels["ssd_bwd_mamba2"] = _ssd_bwd_record(MAMBA2_SSD_TRAIN,
                                                fp32_tol=1e-4)
    _line("phase19_train_defaults kernel ssd_bwd_mamba2",
          kernels["ssd_bwd_mamba2"])
    # B1f-B3f at the reduced GLM-4.5-Air's path (8 x 128 tokens, the
    # trainer's capacity factors) and at GLM-4.5-Air's full width (phase
    # 13's 8192 tokens).
    from repro_torch.configs import get_config
    from repro_torch.configs.reduce import reduced

    glm = get_config("glm45-106b-a12b")
    kernels["grouped_bwd_f32"] = _grouped_bwd_f32_records(
        reduced(glm), 8 * 128, 4.0, 10)
    kernels["grouped_bwd_f32_glm"] = _grouped_bwd_f32_records(
        glm, 8192, SERVE["cf"], 3)
    for tag in ("grouped_bwd_f32", "grouped_bwd_f32_glm"):
        _line(f"phase19_train_defaults kernel {tag}", kernels[tag])
    paths = {tag: _default_path(tag, arch, kw)
             for tag, (arch, kw) in DEFAULT_PATHS.items()}

    _reset_launches()
    res = quickstart.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = _launches()
    plain_plan, plain_rep = quickstart.plan_and_report("cpu")
    if not (res["u"] == plain_plan.u.numpy()).all() or \
            res["report"] != plain_rep:
        raise AssertionError(f"quickstart: the card's plan differs from the "
                             f"plain solve's: {res['report']} vs {plain_rep}")
    if not res["finite"] or \
            not res["layer_max_err"] <= 1e-4 * res["layer_max_ref"]:
        raise AssertionError(f"quickstart layer: {res}")
    needs = [n for n in ("plan_solve", "gating_topk", "grouped_swiglu",
                         "grouped_matmul") if launches[n] <= 0]
    if needs:
        raise AssertionError(f"quickstart: {needs} not launched")
    quick = {"report": dataclasses.asdict(res["report"]),
             "layer_max_err": res["layer_max_err"],
             "layer_max_ref": res["layer_max_ref"], "drops": res["drops"],
             "launches": {k: n for k, n in launches.items() if n}}
    _line("phase19_train_defaults quickstart", quick)
    return {"kernels": kernels, "paths": paths, "quickstart": quick}


def _kernel_row(name, source, replaces, rec, launches, extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"], **extra}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    glm = get_config("glm45-106b-a12b")
    jamba = get_config("jamba-v0.1-52b")
    qwen3 = get_config("qwen3-235b-a22b")
    deepseek = get_config("deepseek-v3-671b")

    def timed(tag, fn, *args, **kw):
        """Run one phase and print its wall seconds on a line of its own."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _line("phase_seconds", {"phase": tag,
                                "wall_s": round(time.perf_counter() - t0, 3)})
        return out

    timed("phase1_card", phase_card)     # its line holds kernel_build_s
    dbrx = get_config("dbrx-132b")
    records = timed("phase2_kernels", phase_kernels, glm, jamba, deepseek,
                    dbrx)
    ssd_records = timed("phase2_ssd", phase_ssd)
    q8_records = timed("phase2_kernels_q8", phase_kernels_q8, glm)
    gating_records = timed("phase2_gating_topk", phase_gating)
    gating_rack_records = timed("phase2_gating_topk_rack", phase_gating_racks)
    plan_records = timed("phase2_plan_solve", phase_plan_solve)
    plan_rack_records = timed("phase2_plan_solve_rack",
                              phase_plan_solve_racks)
    kary_records = timed("phase2_plan_solve_kary", phase_plan_solve_kary)
    health_records = timed("phase2_plan_solve_health",
                           phase_plan_solve_health)
    eplb_records = timed("phase2_eplb_place", phase_eplb_place)
    flash_records = timed("phase2_flash_attention", phase_flash)
    train_kernel_records = timed("phase12_train_kernels", phase_train_kernels,
                                 glm, deepseek, jamba)
    timed("phase3_moe_layer", phase_moe_layer, glm)
    glm_2l = dataclasses.replace(glm, name=glm.name + "-2l", num_layers=2)
    glm_serve = timed("phase4_serve_glm", phase_serve, glm_2l,
                      "phase4_serve_glm")
    glm_q8_serve = timed("phase4b_serve_glm_q8", phase_serve, glm_2l,
                         "phase4b_serve_glm_q8", beside=glm_serve,
                         wire_dtype="int8", ffn_dtype="int8")
    glm_fp32_serve = timed("phase4c_serve_glm_fp32", phase_serve, glm_2l,
                           "phase4c_serve_glm_fp32", beside=glm_serve,
                           dtype="float32")
    timed("phase5_mamba_mixer", phase_mamba_mixer, jamba)
    jamba_serve = timed(
        "phase6_serve_jamba", phase_serve,
        dataclasses.replace(jamba, name=jamba.name + "-8l", num_layers=8),
        "phase6_serve_jamba")
    qwen3_serve = timed(
        "phase7_serve_qwen3", phase_serve,
        dataclasses.replace(qwen3, name=qwen3.name + "-2l", num_layers=2),
        "phase7_serve_qwen3", beside=glm_serve)
    timed("phase10_mla_layer", phase_mla_layer, deepseek)
    # 3 dense layers (first_dense_layers) and 1 MoE layer.
    deepseek_serve = timed(
        "phase11_serve_deepseek", phase_serve,
        dataclasses.replace(deepseek, name=deepseek.name + "-4l",
                            num_layers=4),
        "phase11_serve_deepseek", beside=glm_serve)
    train_record = timed("phase13_train", phase_train, glm)
    cli_records = timed("phase7b_serve_cli", phase_serve_cli)
    ep = timed("phase9_ep_layer", phase_ep_layer)
    timed("phase15_balancers", phase_balancers)
    rack = timed("phase14_rack_tier", phase_rack_tier)
    timed("phase16_train_group", phase_train_group, glm)
    timed("phase20_tp_group", phase_tp_group, glm, deepseek)
    cell_records = timed("phase17_train_cells", phase_train_cells)
    hosts = timed("phase18_hosts", phase_hosts)
    defaults = timed("phase19_train_defaults", phase_train_defaults)
    serves = {"glm45-106b-a12b": glm_serve,
              "glm45-106b-a12b-q8": glm_q8_serve,
              "glm45-106b-a12b-fp32": glm_fp32_serve,
              "jamba-v0.1-52b": jamba_serve,
              "qwen3-235b-a22b": qwen3_serve,
              "deepseek-v3-671b": deepseek_serve,
              **hosts["serve"]}
    paths = {path: rec["launches"] for path, rec in serves.items()}
    glm_launches = paths["glm45-106b-a12b"]
    glm_q8_launches = paths["glm45-106b-a12b-q8"]
    glm_fp32_launches = paths["glm45-106b-a12b-fp32"]
    jamba_launches = paths["jamba-v0.1-52b"]
    for path, name in (("glm45-106b-a12b", "grouped_swiglu"),
                       ("glm45-106b-a12b", "grouped_matmul"),
                       ("glm45-106b-a12b-q8", "grouped_swiglu_q8"),
                       ("glm45-106b-a12b-q8", "grouped_matmul_q8"),
                       ("glm45-106b-a12b-fp32", "grouped_swiglu"),
                       ("glm45-106b-a12b-fp32", "grouped_matmul"),
                       ("jamba-v0.1-52b", "grouped_swiglu"),
                       ("jamba-v0.1-52b", "grouped_matmul"),
                       ("jamba-v0.1-52b", "ssd_intra_chunk"),
                       ("qwen3-235b-a22b", "grouped_swiglu"),
                       ("qwen3-235b-a22b", "grouped_matmul"),
                       ("deepseek-v3-671b", "grouped_swiglu"),
                       ("deepseek-v3-671b", "grouped_matmul"),
                       ("deepseek-v3-671b", "gating_topk"),
                       ("deepseek-v3-671b", "flash_attention")):
        if paths[path][name] <= 0:
            raise AssertionError(f"{name} was not launched on the {path} "
                                 f"serve path")
    # ffn_dtype reached the layer: the q8 path runs no bf16 grouped GEMM,
    # and the bf16 paths no q8 one.
    for path, name in (("glm45-106b-a12b-q8", "grouped_swiglu"),
                       ("glm45-106b-a12b-q8", "grouped_matmul"),
                       ("glm45-106b-a12b", "grouped_swiglu_q8"),
                       ("glm45-106b-a12b", "grouped_matmul_q8"),
                       ("glm45-106b-a12b-fp32", "grouped_swiglu_q8"),
                       ("glm45-106b-a12b-fp32", "grouped_matmul_q8"),
                       ("jamba-v0.1-52b", "grouped_swiglu_q8"),
                       ("jamba-v0.1-52b", "grouped_matmul_q8"),
                       ("qwen3-235b-a22b", "grouped_swiglu_q8"),
                       ("qwen3-235b-a22b", "grouped_matmul_q8"),
                       ("deepseek-v3-671b", "grouped_swiglu_q8"),
                       ("deepseek-v3-671b", "grouped_matmul_q8")):
        if paths[path][name] != 0:
            raise AssertionError(f"{name} was launched {paths[path][name]} "
                                 f"times on the {path} serve path")
    # At R = 1 the plan is the home quota: no serve path solves on the card.
    for path, launches in list(paths.items()) + [
            (f"serve cli {t}", r["launches"]) for t, r in cli_records.items()]:
        if launches["plan_solve"] != 0:
            raise AssertionError(f"plan_solve was launched "
                                 f"{launches['plan_solve']} times on the "
                                 f"{path} serve path (R = 1)")
    # Every serve path is at head dim 128 or, for DeepSeek-V3's MLA, at
    # (192, 128): prefill chunks through the TMA + wgmma kernel (bf16) or
    # the fp32 kernel (phase 4c), GQA decode steps through the split-KV
    # kernel, and never the hd-16 mma.sync kernel.  MLA decode attends on
    # the latent cache with no flash call.
    for path, rec in serves.items():
        prefill = ("prefill_f32" if rec["dtype"] == "float32"
                   else "prefill_wgmma")
        calls = {prefill: rec["prefill_calls"]}
        if not rec["cfg"].is_mla:
            calls["decode_split"] = rec["decode_calls"]
        _check_kernel_calls(path, paths[path], rec["padded_copies"],
                            rec["cfg"], calls,
                            rec["runtime"].get("ffn_dtype", "none"),
                            rec["prefill_calls"] + rec["decode_calls"])
    gg_src = "src/repro_torch/kernels/grouped_gemm/csrc/grouped_gemm.cu"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    kernels = []
    for name, line in (("grouped_swiglu", 154), ("grouped_matmul", 184)):
        rec = records[name]
        kernels.append(_kernel_row(
            name, gg_src, f"src/repro/kernels/grouped_gemm/kernel.py:{line}",
            rec["prefill_serve"], glm_launches[name], {
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "rows": rec["prefill_serve"]["rows"],
                **{tag: {k: rec[tag][k] for k in ("shape",) + keys}
                   for tag in ("prefill", "decode", "decode_serve",
                               "jamba_prefill", "jamba_decode",
                               "jamba_prefill_serve",
                               "deepseek_prefill_serve",
                               "deepseek_decode_serve")},
                "checks": sorted(rec)}))
    # The fp32 kernels (3xTF32 on mma.sync), at the counts phase 4c runs.
    f32_keys = keys + ("bound_fp32_ms", "bytes_bound_ms", "slower_than_library")
    for name, line in (("grouped_swiglu", 154), ("grouped_matmul", 184)):
        rec = records[name]
        kernels.append(_kernel_row(
            f"{name}.f32", gg_src,
            f"src/repro/kernels/grouped_gemm/kernel.py:{line}",
            rec["prefill_serve_fp32"], glm_fp32_launches[name], {
                "arithmetic": "3xTF32 mma.sync",
                "bound_fp32_ms": rec["prefill_serve_fp32"]["bound_fp32_ms"],
                "slower_than_library": rec["prefill_serve_fp32"][
                    "slower_than_library"],
                "rows": rec["prefill_serve_fp32"]["rows"],
                **{tag: {k: rec[tag][k] for k in ("shape",) + f32_keys}
                   for tag in ("fp32_g8", "decode_serve_fp32")},
                "checks": sorted(t for t in rec if "fp32" in t)}))
    q8_src = "src/repro_torch/kernels/grouped_gemm/csrc/grouped_gemm_q8.cu"
    # The serve path's counts first; its down projection writes bf16.
    for name, line, main, subs in (
            ("grouped_swiglu_q8", 246, "prefill_serve",
             ("prefill_serve_wire", "prefill", "decode", "decode_serve",
              "prefill_contiguous")),
            ("grouped_matmul_q8", 214, "prefill_serve_bf16",
             ("prefill_serve", "prefill", "prefill_bf16", "decode",
              "decode_serve_bf16", "prefill_contiguous"))):
        rec = q8_records[name]
        kernels.append(_kernel_row(
            name, q8_src, f"src/repro/kernels/grouped_gemm/kernel.py:{line}",
            rec[main], glm_q8_launches[name], {
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "rows": rec[main]["rows"],
                "bound_all_rows_ms": rec[main]["bound_all_rows_ms"],
                **{tag: {k: rec[tag][k]
                         for k in ("shape",) + keys + ("bound_all_rows_ms",)}
                   for tag in subs},
                "checks": sorted(rec)}))
    ssd = ssd_records["jamba_prefill"]
    kernels.append(_kernel_row(
        "ssd_intra_chunk", "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/kernel.py:66", ssd,
        jamba_launches["ssd_intra_chunk"], {
            "launches_by_path": {p: c["ssd_intra_chunk"]
                                 for p, c in paths.items()},
            "dtype": ssd["dtype"], "scan_ms": ssd["scan_ms"],
            "scan_plain_ms": ssd["scan_plain_ms"],
            "bound_fp32_ms": ssd["bound_fp32_ms"],
            "fp32_inputs": {k: ssd_records["jamba_prefill_fp32"][k]
                            for k in keys + ("bound_fp32_ms", "scan_ms")},
            "checks": sorted(ssd_records)}))
    # Row 5's ms stays the eager time (host work included), as in earlier
    # runs; its device time from graph replays stands beside it, with the
    # logits warm in L2 as the router matmul leaves them (graph_ms) and out
    # of it (graph_cold_ms).
    gating_keys = ("graph_ms", "graph_cold_ms", "bound_share_warm",
                   "bound_share_cold", "torch_ops_ms", "torch_ops_graph_ms")
    gating = gating_records["prefill"]
    kernels.append(_kernel_row(
        "gating_topk", "src/repro_torch/kernels/gating_topk/csrc/gating_topk.cu",
        "src/repro/kernels/gating_topk/kernel.py:59", gating,
        glm_launches["gating_topk"], {
            "launches_by_path": {p: c["gating_topk"] for p, c in paths.items()},
            **{k: gating[k] for k in gating_keys}, "cold": gating["cold"],
            "library_note": "none: no one PyTorch call computes the fused "
                            "function; torch_ops_ms is softmax + topk + "
                            "gather + bincount (graph: scatter_add_)",
            **{tag: {k: gating_records[tag][k]
                     for k in ("shape",) + keys + gating_keys}
               for tag in ("decode", "jamba_prefill", "sigmoid_e256",
                           "sigmoid_e256_decode", "sigmoid_e256_bias")},
            "rows_excluded_near_tie": {
                t: r["rows_excluded_near_tie"]
                for t, r in gating_records.items()},
            "checks": sorted(gating_records)}))
    flash_keys = ("shape", "kernel") + keys + (
        "ms_eager", "sdpa_masked_ms", "sdpa_free_ms", "slower_than_library")
    kernels.append(_kernel_row(
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84",
        flash_records["glm_prefill_at_4096"], glm_launches["flash_attention"],
        {"kernel": flash_records["glm_prefill_at_4096"]["kernel"],
         "launches_by_path": {p: c["flash_attention"]
                              for p, c in paths.items()},
         "launches_by_kernel": {
             p: {k.split(".", 1)[1]: n for k, n in c.items()
                 if k.startswith("flash_attention.")}
             for p, c in paths.items()},
         "library_note": "the faster of scaled_dot_product_attention with "
                         "the same boolean mask (enable_gqa) and, where "
                         "every row shares one offset, without a mask (k/v "
                         "sliced to the valid length, causal_lower_right, "
                         "flash or efficient backend); timed only",
         "sdpa_masked_ms": flash_records["glm_prefill_at_4096"][
             "sdpa_masked_ms"],
         "sdpa_free_ms": flash_records["glm_prefill_at_4096"]["sdpa_free_ms"],
         "ms_eager": flash_records["glm_prefill_at_4096"]["ms_eager"],
         "max_row_rel_err": max(r["max_row_rel_err"]
                                for r in flash_records.values()),
         **{tag: {k: flash_records[tag][k] for k in flash_keys}
            for tag in ("decode", "glm_prefill_at_0",
                        "qwen3_prefill_at_4096", "qwen3_decode",
                        "pallas_causal", "fp32_prefill", "fp32_decode")},
         "checks": sorted(flash_records)}))
    # The fp32 serve path's shape (phase 4c's chunks at offset 4096) first.
    f32 = flash_records["glm_prefill_at_4096_fp32"]
    kernels.append(_kernel_row(
        "flash_attention.prefill_f32",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84", f32,
        glm_fp32_launches["flash_attention.prefill_f32"],
        {"kernel": "prefill_f32", "arithmetic": "3xTF32 mma.sync",
         "bound_fp32_ms": f32["bound_fp32_ms"],
         "sdpa_masked_ms": f32["sdpa_masked_ms"],
         "sdpa_free_ms": f32["sdpa_free_ms"],
         "slower_than_library": f32["slower_than_library"],
         "launches_by_path": {p: c["flash_attention.prefill_f32"]
                              for p, c in paths.items()},
         "launches_serve_cli": {
             tag: r["launches"]["flash_attention.prefill_f32"]
             for tag, r in cli_records.items()},
         "max_row_rel_err": max(r["max_row_rel_err"]
                                for r in flash_records.values()
                                if r["kernel"] == "prefill_f32"),
         **{tag: {k: flash_records[tag][k]
                  for k in flash_keys + ("bound_fp32_ms", "max_row_rel_err")}
            for tag in ("fp32_prefill", "hd64_fp32", "hd16_fp32")}}))
    # Row 6 at DeepSeek-V3's MLA dims (q/k 192, v 128, bf16): its serve
    # chunk (4096 queries at offset 4096 over 8192 keys, 128 heads) on the
    # wgmma kernel; 64- and 128-query chunks at B 1 beside, on the wgmma
    # kernel the plan picks, with the split-KV kernel's time forced.
    mla = flash_records["mla_prefill_at_4096"]
    kernels.append(_kernel_row(
        "flash_attention.mla",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84", mla,
        paths["deepseek-v3-671b"]["flash_attention.prefill_wgmma"],
        {"kernel": mla["kernel"], "head_dims": [192, 128],
         "sdpa_masked_ms": mla["sdpa_masked_ms"],
         "sdpa_masked_backend": mla["sdpa_masked_backend"],
         "sdpa_free_ms": mla["sdpa_free_ms"],
         "sdpa_free_backend": mla.get("sdpa_free_backend"),
         "slower_than_library": mla["slower_than_library"],
         "ms_eager": mla["ms_eager"],
         "max_row_rel_err": mla["max_row_rel_err"],
         "launches_by_kernel": {
             k.split(".", 1)[1]: n
             for k, n in paths["deepseek-v3-671b"].items()
             if k.startswith("flash_attention.")},
         **{tag: {k: flash_records[tag][k]
                  for k in flash_keys + ("max_row_rel_err", "split_ms",
                                         "split_max_row_rel_err")}
            for tag in ("mla_prefill_64", "mla_prefill_128")}}))
    # Row P: the plan solve (no pallas_call: the JAX solve's two
    # lax.while_loop).  Its serve paths run at R = 1, where the plan is the
    # home quota and the kernel never launches; phase 9 (R = 2) is its path.
    plan_rec = dict(plan_records["e128_k8_r64_zipf"], shape="E 128, k 8, R 64,"
                    " Zipf 1.0, 4096 tokens a rank")
    ep_launches = {mode: m["launches"]["plan_solve"]
                   for mode, m in ep["ranks_by_mode"][0]["modes"].items()}
    kernels.append(_kernel_row(
        "plan_solve", "src/repro_torch/kernels/plan_solve/csrc/plan_solve.cu",
        "src/repro/core/planner.py:349 (the bisection's lax.while_loop around"
        " _greedy_oracle's, :198; no pallas_call)", plan_rec,
        sum(ep_launches.values()), {
            "launches_note": "phase 9 (R = 2), rank 0, one per layer call; "
                             "0 on every R = 1 serve path: the plan there "
                             "is the home quota, solved without a launch",
            "launches_by_path": {**{p: c["plan_solve"]
                                    for p, c in paths.items()},
                                 **{f"ep_layer_r2_{m}": n
                                    for m, n in ep_launches.items()}},
            "bound_note": "latency: serial oracle steps x one measured "
                          "redux.sync round",
            "steps": plan_rec["steps"], "probes": plan_rec["probes"],
            "plan_graph_ms": plan_rec["plan_graph_ms"],
            "library_note": "none: no PyTorch call computes the solve",
            **{tag: {k: plan_records[tag][k] for k in (
                "shape", "law", "probes", "steps", "ms", "plan_graph_ms",
                "plain_ms", "bound_ms", "post_over_mean")}
               for tag in plan_records if tag != "e128_k8_r64_zipf"}}))
    # Row 5r: the gate kernel's rack mode (DeepSeek-V3's node-limited
    # routing, G 8 / M 4 / group top-2), launched on phase 14's path by
    # call (c), rank 0; its ms is the eager time, as row 5's.
    rack0 = rack["ranks_by_call"][0]["calls"]
    gr = gating_rack_records["ds_g8_m4"]
    rack_gate_keys = ("graph_ms", "graph_cold_ms", "free_graph_ms",
                      "torch_ops_graph_ms", "bound_share_warm")
    kernels.append(_kernel_row(
        "gating_topk.rack",
        "src/repro_torch/kernels/gating_topk/csrc/gating_topk.cu",
        "src/repro/kernels/gating_topk/kernel.py:59 (with "
        "src/repro/moe/gating.py:112-139, _rack_limited_top_k)", gr,
        rack0["c"]["launches"]["gating_topk.rack"], {
            "launches_note": "phase 14, call (c) (hier_a2a, rack limit 1), "
                             "rank 0",
            "launches_by_call": {n: c["launches"]["gating_topk.rack"]
                                 for n, c in rack0.items()},
            "routing": {"num_racks": 8, "rack_limit": 4, "group_topk": 2},
            **{k: gr[k] for k in rack_gate_keys}, "cold": gr["cold"],
            "library_note": "none: no one PyTorch call computes the fused "
                            "function; torch_ops_graph_ms is the composite "
                            "group top-2 -> top-M -> mask -> topk -> gather "
                            "-> scatter_add in a graph",
            **{tag: {k: r[k] for k in ("shape", "num_racks", "rack_limit",
                                       "group_topk", "path") + keys
                     + rack_gate_keys}
               for tag, r in gating_rack_records.items()
               if tag != "ds_g8_m4"},
            "rows_excluded_near_tie": {
                t: r["rows_excluded_near_tie"]
                for t, r in gating_rack_records.items()}}))
    # Row Pr: the plan solve's rack mode (rack score and, with the demand
    # tie-break, the on-card incidence), launched by phase 14's rack-aware
    # calls (b), (c), (d), rank 0.
    pr = dict(plan_rack_records["e128_k8_r64_l8_zipf_demand"],
              shape="E 128, k 8, R 64, L 8, Zipf 1.0 with racks off a third "
                    "of the experts, 4096 tokens a rank, demand tie-break")
    kernels.append(_kernel_row(
        "plan_solve.rack",
        "src/repro_torch/kernels/plan_solve/csrc/plan_solve.cu",
        "src/repro/core/planner.py:349 and :198 in rack mode (the score of "
        ":156-162, the incidence of :291-294; no pallas_call)", pr,
        sum(rack0[n]["launches"]["plan_solve"] for n in ("b", "c", "d")), {
            "launches_note": "phase 14, rank 0: calls (b), (c), (d) "
                             "(rack size 2); (a), (e) solve flat",
            "launches_by_call": {n: c["launches"]["plan_solve"]
                                 for n, c in rack0.items()},
            "bound_note": "latency: serial oracle steps x one measured "
                          "redux.sync round",
            "steps": pr["steps"], "probes": pr["probes"],
            "flat_ms": pr["flat_ms"], "plan_graph_ms": pr["plan_graph_ms"],
            "library_note": "none: no PyTorch call computes the solve",
            **{tag: {k: r[k] for k in ("shape", "rack_size", "law", "demand",
                                       "probes", "steps", "ms", "flat_ms",
                                       "plain_ms", "bound_ms")}
               for tag, r in plan_rack_records.items()
               if "ms" in r and tag != "e128_k8_r64_l8_zipf_demand"}}))
    # Rows Pk and Ph: the plan solve's k-ary round and health mode, launched
    # by phase 9's ``ultraep`` runs at P 4 and under a RankHealth, rank 0.
    runs0 = ep["ranks_by_mode"][0]["runs"]
    plan_src = "src/repro_torch/kernels/plan_solve/csrc/plan_solve.cu"
    sub_keys = ("shape", "rack_size", "probe_parallelism", "probes", "steps",
                "critical_steps", "ms", "bound_ms", "tau", "post_max")
    for name, recs, main_tag, run, replaces in (
            ("plan_solve.kary", kary_records, "e128_k8_r64_l0_p8",
             "ultraep_p4", "src/repro/core/planner.py:316-343 (the k-ary "
             "round of solve_replication's lax.while_loop, :349; no "
             "pallas_call)"),
            ("plan_solve.health", health_records, "e128_k8_r64_l0_p1",
             "ultraep_health", "src/repro/core/planner.py:274-287 and "
             ":125-128 (health-weighted capacities; no pallas_call)")):
        rec = dict(recs[main_tag])
        kernels.append(_kernel_row(name, plan_src, replaces, rec,
                                   runs0[run]["launches"]["plan_solve"], {
            "launches_note": f"phase 9 (R = 2), run {run}, rank 0",
            "bound_note": "latency: critical-path oracle steps (the longest "
                          "probe of each batch of warps) x one measured "
                          "redux.sync round",
            "probes": rec["probes"], "steps": rec["steps"],
            "critical_steps": rec["critical_steps"],
            "library_note": "none: no PyTorch call computes the solve",
            **{tag: {k: r.get(k) for k in sub_keys + ("plain_ms",)}
               for tag, r in recs.items() if tag != main_tag}}))
    # Row Pe: EPLB's placement, launched by phase 9's eplb and eplb_plus
    # runs, rank 0.
    pe = eplb_records["e256_k8_r64_zipf"]
    kernels.append(_kernel_row(
        "eplb_place", "src/repro_torch/kernels/eplb_place/csrc/eplb_place.cu",
        "src/repro/core/eplb.py:154-174 (_eplb_replication_jax's "
        "lax.while_loop, body :158-171; no pallas_call)", pe,
        sum(runs0[r]["launches"]["eplb_place"] for r in ("eplb",
                                                         "eplb_plus")), {
            "launches_note": "phase 9 (R = 2), runs eplb and eplb_plus, "
                             "rank 0",
            "bound_note": "latency: steps x the longer of a step's two "
                          "measured chains, which run side by side: the "
                          "argmin's two redux.sync rounds and the re-sum of "
                          "the chosen rank's list; the vote and the "
                          "argmax's two rounds",
            "steps": pe["steps"], "placements": pe["placements"],
            "library_note": "none: no PyTorch call computes the placement",
            "sweep_bitwise": len(eplb_records["sweep"]),
            **{tag: {k: r[k] for k in ("shape", "steps", "placements", "ms",
                                       "plain_ms", "bound_ms")}
               for tag, r in eplb_records.items()
               if tag not in ("e256_k8_r64_zipf", "sweep")}}))
    # The backward kernels (no pallas_call: XLA differentiates the JAX
    # package's einsums and flash_ref), with their launches in the last
    # train step of phase 13 and in phase 9's R = 2 backward.
    train_launches = train_record["launches_per_step"]
    cell_launches = {a: cell_records[a]["launches_per_step"]
                     for a in TRAIN_CELLS}
    cells = tuple(tag for tag, *_ in GROUPED_BWD_SHAPES[1:])
    bwd_rows = (
        ("grouped_swiglu_bwd", gg_src, "src/repro/kernels/grouped_gemm/"
         "kernel.py:154 (its backward; no pallas_call: XLA differentiates "
         "src/repro/moe/expert.py:102-105)",
         ("sparse_nan", "zero_padded_ms", "zero_bytes", "work_items",
          "padded_rows_unread_bitwise") + cells),
        ("grouped_matmul_nt", gg_src, "src/repro/kernels/grouped_gemm/"
         "kernel.py:184 and :154 (their dgrad; no pallas_call)",
         ("dual", "sparse_nan", "zero_padded_ms", "zero_bytes", "work_items",
          "padded_rows_unread_bitwise") + cells),
        ("grouped_wgrad", gg_src, "src/repro/kernels/grouped_gemm/"
         "kernel.py:154 and :184 (their wgrad; no pallas_call)",
         ("sparse_nan", "tiles") + cells),
        ("flash_attention_bwd", "src/repro_torch/kernels/flash_attention/"
         "csrc/flash_attention_bwd.cu", "src/repro/kernels/flash_attention/"
         "kernel.py:84 (its backward; no pallas_call: XLA differentiates "
         "src/repro/models/attention.py:252 through flash_ref)", ("errs",)))
    for name, src, replaces, subs in bwd_rows:
        rec = train_kernel_records[name]
        kernels.append(_kernel_row(name, src, replaces, rec,
                                   train_launches[name], {
            "launches_by_path": {
                "train_step_glm45_1l": train_launches[name],
                "ep_layer_r2_backward_rank0": ep["ranks_by_mode"][0][
                    "backward"]["launches"].get(name),
                **{f"train_cell_{a}": n.get(name)
                   for a, n in cell_launches.items()}},
            **{k: rec[k] for k in subs if k in rec},
            **{k: rec[k] for k in ("bmm_pair_ms", "library_note", "rows",
                                   "slots_with_rows", "dq") if k in rec}}))
    # B4m and B5, with their launches in the last step of phase 17's
    # DeepSeek-V3 and Jamba-v0.1 train cells.
    rec = train_kernel_records["flash_attention_bwd.mla"]
    kernels.append(_kernel_row(
        "flash_attention_bwd.mla", "src/repro_torch/kernels/flash_attention/"
        "csrc/flash_attention_bwd.cu", "src/repro/kernels/flash_attention/"
        "kernel.py:84 (its backward at MLA's (192, 128); no pallas_call: XLA "
        "differentiates src/repro/models/attention.py:252 through "
        "flash_ref)", rec,
        cell_launches["deepseek-v3-671b"]["flash_attention_bwd.192x128"], {
            "head_dims": [192, 128],
            "launches_by_path": {f"train_cell_{a}": n[
                "flash_attention_bwd.192x128"]
                for a, n in cell_launches.items()},
            "errs": rec["errs"], "library_note": rec["library_note"],
            "library_error": rec["library_error"],
            "ds_round_trip_ms": rec["ds_round_trip_ms"],
            "stage_ms": rec["stage_ms"]}))
    rec = train_kernel_records["ssd_intra_chunk_bwd"]
    kernels.append(_kernel_row(
        "ssd_intra_chunk_bwd",
        "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
        "src/repro/kernels/ssd_scan/kernel.py:66 (its backward; no "
        "pallas_call: XLA differentiates the plain SSD path)", rec,
        cell_launches["jamba-v0.1-52b"]["ssd_intra_chunk_bwd"], {
            "dtype": rec["dtype"],
            "arithmetic": "split bf16 (hi + lo) on mma.sync m16n8k16",
            "bytes_bound_ms": rec["bytes_bound_ms"],
            "launches_by_path": {f"train_cell_{a}": n["ssd_intra_chunk_bwd"]
                                 for a, n in cell_launches.items()},
            "errs": rec["errs"], "library_note": rec["library_note"],
            "fp32_inputs": {k: rec["fp32_inputs"][k] for k in
                            keys + ("bytes_bound_ms",)}}))
    # The hosts phase's new shapes of rows 1, 2, 5, 6, 6b, 7 and B4, each
    # with its launches on its own path of phase 18.
    dbrx_launches = paths["dbrx-132b"]
    for name, line in (("grouped_swiglu", 154), ("grouped_matmul", 184)):
        rec = records[name]
        kernels.append(_kernel_row(
            f"{name}.dbrx", gg_src,
            f"src/repro/kernels/grouped_gemm/kernel.py:{line}",
            rec["dbrx_prefill_serve"], dbrx_launches[name], {
                "path": "phase 18 serve dbrx-132b-2l",
                "rows": rec["dbrx_prefill_serve"]["rows"],
                "dbrx_decode_serve": {k: rec["dbrx_decode_serve"][k]
                                      for k in ("shape",) + keys}}))
    gd = gating_records["dbrx_prefill"]
    kernels.append(_kernel_row(
        "gating_topk.dbrx",
        "src/repro_torch/kernels/gating_topk/csrc/gating_topk.cu",
        "src/repro/kernels/gating_topk/kernel.py:59", gd,
        dbrx_launches["gating_topk"], {
            "path": "phase 18 serve dbrx-132b-2l",
            **{k: gd[k] for k in gating_keys},
            "dbrx_decode": {k: gating_records["dbrx_decode"][k]
                            for k in ("shape",) + keys + gating_keys}}))
    hub = hosts["hubert_train"]["launches_per_step"]
    h80 = flash_records["hubert_train"]
    kernels.append(_kernel_row(
        "flash_attention.hd80",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84", h80,
        hub["flash_attention.prefill_wgmma"], {
            "kernel": h80["kernel"], "head_dims": [80, 80],
            "causal": False, "path": "phase 18 train hubert-xlarge, a step",
            "padded_product_share": h80["padded_product_share"],
            "sdpa_free_ms": h80["sdpa_free_ms"],
            "sdpa_free_backend": h80.get("sdpa_free_backend"),
            "sdpa_masked_ms": h80["sdpa_masked_ms"],
            "max_row_rel_err": max(
                flash_records[t]["max_row_rel_err"]
                for t in ("hubert_train", "hubert_train_causal",
                          "hubert_train_fp32", "hubert_train_fp32_causal",
                          "hubert_short")),
            "hubert_train_fp32": {
                k: flash_records["hubert_train_fp32"][k]
                for k in flash_keys + ("bound_fp32_ms", "max_row_rel_err")},
            "checks": ["hubert_train", "hubert_train_causal",
                       "hubert_train_fp32", "hubert_train_fp32_causal",
                       "hubert_short"]}))
    mf = flash_records["mla_prefill_64_fp32"]
    kernels.append(_kernel_row(
        "flash_attention.mla_f32",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84", mf,
        hosts["deepseek_cli_fp32"]["launches"]["flash_attention.prefill_f32"],
        {"kernel": mf["kernel"], "head_dims": [192, 128],
         "arithmetic": "3xTF32 mma.sync",
         "path": "phase 18 serve cli deepseek-v3-671b --layers 2 (fp32)",
         "bound_fp32_ms": mf["bound_fp32_ms"],
         "max_row_rel_err": mf["max_row_rel_err"],
         "mla_prefill_at_4096_fp32": {
             k: flash_records["mla_prefill_at_4096_fp32"][k]
             for k in flash_keys + ("bound_fp32_ms", "max_row_rel_err")}}))
    m2 = ssd_records["mamba2_prefill"]
    kernels.append(_kernel_row(
        "ssd_intra_chunk.mamba2",
        "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/kernel.py:66", m2,
        paths["mamba2-130m"]["ssd_intra_chunk"], {
            "path": "phase 18 serve mamba2-130m", "dtype": m2["dtype"],
            "bound_fp32_ms": m2["bound_fp32_ms"], "scan_ms": m2["scan_ms"],
            "fp32_inputs": {k: ssd_records["mamba2_prefill_fp32"][k]
                            for k in keys + ("bound_fp32_ms", "scan_ms")}}))
    rec = train_kernel_records["flash_attention_bwd.hd80"]
    kernels.append(_kernel_row(
        "flash_attention_bwd.hd80", "src/repro_torch/kernels/flash_attention/"
        "csrc/flash_attention_bwd.cu", "src/repro/kernels/flash_attention/"
        "kernel.py:84 (its backward at (80, 80); no pallas_call: XLA "
        "differentiates src/repro/models/attention.py:252 through "
        "flash_ref)", rec, hub["flash_attention_bwd.80x80"], {
            "head_dims": [80, 80], "causal": False,
            "path": "phase 18 train hubert-xlarge, a step",
            "padded_product_share": rec["padded_product_share"],
            "errs": rec["errs"], "stage_ms": rec["stage_ms"],
            "library_note": rec["library_note"]}))
    # Phase 19's kernels: B4f at every pair (its row at Qwen3-0.6B's
    # (128, 128), causal), B4 in bf16 at (16, 16) and (64, 64), B5 at
    # Mamba2-130M's (64, 128); launches on each phase-19 path a step.
    d_paths = defaults["paths"]
    d_kern = defaults["kernels"]
    bwd_src = ("src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_bwd_mma.cu")
    bwd_replaces = ("src/repro/kernels/flash_attention/kernel.py:84 (its "
                    "backward; no pallas_call: XLA differentiates "
                    "src/repro/models/attention.py:252 through flash_ref)")
    sub_keys = ("shape", "kernel") + keys + ("library_error", "errs")

    def path_launches(key):
        return {t: r["launches_per_step"].get(key, 0) * DEFAULT_STEPS
                for t, r in d_paths.items()}

    kernels.append(_kernel_row(
        "flash_attention_bwd.f32", bwd_src, bwd_replaces,
        d_kern["f32_128x128_causal"],
        d_paths["qwen3-0.6b main"]["launches_per_step"][
            "flash_attention_bwd.mma_f32"] * DEFAULT_STEPS, {
            "arithmetic": "3xTF32 mma.sync; one query head a dK/dV block, "
                          "the heads' partials summed in head order",
            "bound_fp32_ms": d_kern["f32_128x128_causal"]["bound_fp32_ms"],
            "launches_note": f"phase 19, {DEFAULT_STEPS} steps of each path",
            "launches_by_path": path_launches("flash_attention_bwd.mma_f32"),
            "errs": d_kern["f32_128x128_causal"]["errs"],
            **{tag: {k: r.get(k) for k in sub_keys + ("bound_fp32_ms",)}
               for tag, r in d_kern.items() if tag.startswith("f32_")}}))
    kernels.append(_kernel_row(
        "flash_attention_bwd.hd16", bwd_src, bwd_replaces,
        d_kern["bf16_16x16_causal"],
        d_paths["glm45 train() bf16"]["launches_per_step"][
            "flash_attention_bwd.mma_bf16"] * DEFAULT_STEPS, {
            "arithmetic": "bf16 mma.sync",
            "launches_note": f"phase 19, {DEFAULT_STEPS} steps of each path",
            "launches_by_path": path_launches("flash_attention_bwd.mma_bf16"),
            "errs": d_kern["bf16_16x16_causal"]["errs"]}))
    kernels.append(_kernel_row(
        "flash_attention_bwd.hd64", "src/repro_torch/kernels/flash_attention/"
        "csrc/flash_attention_bwd.cu", bwd_replaces,
        d_kern["bf16_64x64_causal"], 0, {
            "arithmetic": "bf16 wgmma (B4's kernels at (64, 64))",
            "launches_note": "no registered arch has head dim 64: phase 19's "
                             "kernel check is its only launch",
            "errs": d_kern["bf16_64x64_causal"]["errs"]}))
    m2 = d_kern["ssd_bwd_mamba2"]
    kernels.append(_kernel_row(
        "ssd_intra_chunk_bwd.mamba2",
        "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cu",
        "src/repro/kernels/ssd_scan/kernel.py:66 (its backward; no "
        "pallas_call: XLA differentiates the plain SSD path)", m2,
        d_paths["mamba2-130m bf16"]["launches_per_step"][
            "ssd_intra_chunk_bwd"] * DEFAULT_STEPS, {
            "dtype": m2["dtype"], "head_dim_state": [64, 128],
            "arithmetic": "split bf16 (hi + lo) on mma.sync m16n8k16",
            "bytes_bound_ms": m2["bytes_bound_ms"],
            "launches_note": f"phase 19, {DEFAULT_STEPS} steps of each path",
            "launches_by_path": path_launches("ssd_intra_chunk_bwd"),
            "errs": m2["errs"],
            "fp32_inputs": {k: m2["fp32_inputs"][k] for k in
                            keys + ("bytes_bound_ms", "errs")}}))
    for name, what in (("grouped_swiglu_bwd", "kernel.py:154 (its "
                        "backward in fp32; no pallas_call: XLA differentiates "
                        "src/repro/moe/expert.py:102-105)"),
                       ("grouped_matmul_nt", "kernel.py:184 and :154 (their "
                        "dgrad in fp32; no pallas_call)"),
                       ("grouped_wgrad", "kernel.py:154 and :184 (their "
                        "wgrad in fp32; no pallas_call)")):
        rec = d_kern["grouped_bwd_f32"][name]
        kernels.append(_kernel_row(
            f"{name}.f32",
            "src/repro_torch/kernels/grouped_gemm/csrc/grouped_gemm_bwd_f32.cu",
            f"src/repro/kernels/grouped_gemm/{what}", rec,
            d_paths["glm45 train() defaults"]["launches_per_step"][
                f"{name}.fp32"] * DEFAULT_STEPS, {
                "arithmetic": "3xTF32 on TF32 wgmma: A split in "
                              "registers, B split once into TF32 planes",
                "bound_fp32_ms": rec["bound_fp32_ms"],
                "launches_note": f"phase 19, {DEFAULT_STEPS} steps of each "
                                 f"path",
                "launches_by_path": path_launches(f"{name}.fp32"),
                "glm_full_width": {
                    k: d_kern["grouped_bwd_f32_glm"][name].get(k)
                    for k in ("shape",) + keys + ("bound_fp32_ms",)}}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"total_s {time.perf_counter() - t_start:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
